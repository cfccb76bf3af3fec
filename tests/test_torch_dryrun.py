"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's committed records and against a real round:

* the two committed reference records (``experiments/dryrun/``,
  ``train_4k / single / sharded_fused / shardmodel / q2`` of
  tinyllama-1.1b and dbrx-132b): the CLI, one subprocess each, writes a
  record whose hardware-independent fields equal the reference's --
  ``n_chips``, ``n_nodes``, the parameter counts, the two-axis layout and
  wire bytes, one wire-stage launch a tile, ``collective_axes`` -- and
  whose argument and output bytes differ from XLA's by the itemized
  buffers the port holds on the host;
* the dry run of a smoke TinyLlama on ``make_test_mesh((2, 2, 2))`` (8
  ranks: pod 2 x data 2 nodes, 2 model shards) counts, per kind, exactly
  the collectives and bytes rank 0 issues in the same round run on 8 gloo
  ranks on the CPU, and its sends and shard gathers equal that engine's
  counters;
* the record's file name follows the reference's suffix rules (the
  reference's own ``main`` with its ``run_pair`` stubbed);
* the refusals, the documented skip, and a serving pair's per-rank call:
  its shards, its share of the batch, its kv heads, its collectives;
* ``--fl-engine tree`` on the (16 data x 16 model) layout for
  tinyllama-1.1b (whole q heads, a quarter kv head a rank) and
  smollm-360m (cut heads), train_4k, Q = 2: the per-rank params,
  tracker and previous gradient are ``rank_bytes`` of the node-stacked
  Megatron specs; the model group's all-reduces and all-gathers are
  counted from the layers, the loss chunks and remat; the flash kernel
  launches twice a layer, step and node; every gossip message is on the
  rank's node group; the model group's collectives cross a host;
* the committed ``tree`` records of dbrx-132b, llama4-scout-17b-a16e and
  internvl2-26b (expert-parallel MoE, one expert a rank; the VLM's 1,024
  prefix positions): the per-rank state bytes are the placed shards',
  the flash kernel launches 2 x layers x Q, the model group's
  collectives ``expected_collectives`` a node-step; llama4-scout's
  record is the dry run's own, run here;
* the committed ``tree`` records of rwkv6-7b, recurrentgemma-2b and
  whisper-medium (RWKV6's heads, the RG-LRU's channels and whisper's
  encoder-decoder on the rank's share): the per-rank state bytes are the
  placed shards' (the paired ``in_proj`` cut), the WKV-6, RG-LRU and
  flash launches the code implies, the model group's collectives
  ``expected_collectives`` a node-step;
* the committed ``flat`` / ``fused`` records of tinyllama-1.1b (a node's
  16 model ranks replicas of its whole flat buffer): argument bytes a
  node's whole state, no collective but the node ranks', ``fused`` the
  dry run's own;
* every serving record (rank 0's own call on its tensor-parallel shards):
  the model group's collectives ``expected_collectives``, the kernels'
  launches ``expected_launches``, the argument bytes its parameters,
  batch share and states; the train records committed before are
  unchanged.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
dist = torch.distributed

from repro_torch.benchmarks.run_dryruns import OUT_DIR, record_path  # noqa: E402
from repro_torch.benchmarks.tensor_parallel import (  # noqa: E402
    expected_collectives,
    expected_launches,
)
from repro_torch.configs import SHAPES, get_config, train_input_specs  # noqa: E402
from repro_torch.core.packing import tree_bytes  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    batch_specs,
    model_param_specs,
    node_stack_specs,
    rank_bytes,
    shard_params,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_DIR = os.path.join(ROOT, "experiments", "dryrun")
ORACLE = "train_4k_single_sharded_fused_shardmodel_q2.json"
CLI = ["--shape", "train_4k", "--mesh", "single", "--fl-engine", "sharded_fused",
       "--fl-shard-model", "--q", "2"]

# How the port's per-rank bytes differ from XLA's memory analysis, buffer
# by buffer: the round counter is an int32 device scalar in the reference
# and a host int in the port; the metrics alpha, comm_rounds and
# wire_bytes are fp32 device scalars there and host floats here; XLA's
# output is a tuple with an 8-byte table entry a leaf (step, params,
# tracker, prev_grad, six comm buffers, eight metrics).
STEP_BYTES = 4
HOST_METRIC_BYTES = 3 * 4
XLA_TUPLE_BYTES = 18 * 8
# the port's own buffers: params, tracker, prev_grad and the six fp32
# comm buffers (recon, residual, mix_recon and their tracker twins) of
# the rank's (1 node, shard) tile; the metrics loss, local_loss,
# grad_norm_sq, consensus_err and ef_residual_rms as fp32 scalars
STATE_BUFFERS, METRIC_TENSORS = 9, 5


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "dbrx-132b"])
def test_the_committed_records(arch, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, *CLI,
         "--out", str(tmp_path)], env=_env(), cwd=ROOT, capture_output=True, text=True,
        timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads((tmp_path / f"{arch}_{ORACLE}").read_text())
    with open(os.path.join(REF_DIR, f"{arch}_{ORACLE}")) as f:
        want = json.load(f)
    assert got == json.loads(proc.stdout)
    for key in ("arch", "shape", "mesh", "kind", "status", "q", "algorithm", "impl",
                "fl_engine", "fl_schedule", "fl_topology_program", "fl_node_program",
                "fl_privacy", "topk", "wire_dtype", "pod_gossip_every", "n_chips",
                "n_nodes", "model_params", "active_params"):
        assert got[key] == want[key], key
    assert got["two_axis"] == want["two_axis"]
    assert got["two_axis"]["pallas_calls"] == 1 and got["kernel_calls"]["wire_stage_gt"] == 1
    # the reference's keys, but XLA's own
    xla_only = {"raw_cost_analysis", "lower_s", "compile_s"}
    assert set(want) - xla_only <= set(got)
    assert set(got["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes"}
    # argument and output bytes, itemized
    width = got["two_axis"]["shard_width"]
    cfg = get_config(arch)
    batch = 2 * 1 * (256 // 16) * (4096 + 1) * 4  # (Q, 1 node, 16, 4097) int32 tokens
    assert got["memory"]["argument_bytes"] == STATE_BUFFERS * 4 * width + batch
    assert got["memory"]["output_bytes"] == STATE_BUFFERS * 4 * width + METRIC_TENSORS * 4
    assert want["memory"]["argument_bytes"] - got["memory"]["argument_bytes"] == STEP_BYTES
    assert want["memory"]["output_bytes"] - got["memory"]["output_bytes"] == (
        STEP_BYTES + HOST_METRIC_BYTES + XLA_TUPLE_BYTES)
    # the wire: 2 wires x 2 ring directions x (payload, scales), one edge a
    # direction; the local steps' two gathers of the node's tiles
    edge = got["two_axis"]["wire_bytes_per_shard_one_edge"]
    kinds = got["collectives"]["per_kind"]
    assert kinds["send"] == {"count": 8, "bytes": 4 * edge, "cross_bytes": 4 * edge}
    assert kinds["send"]["bytes"] == want["collectives"]["per_kind"]["collective-permute"][
        "cross_bytes"]
    assert kinds["all-gather"]["count"] == got["shard_gathers"] == 2
    layers = cfg.n_layers
    assert got["kernel_calls"]["flash_attention"] == 2 * 2 * layers  # Q x remat x layers
    assert got["flops"] > 0 and got["memory"]["temp_bytes"] > 0


_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs import get_config
    from repro_torch.core.engine import ShardedFusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.schedules import inv_sqrt
    from repro_torch.data.tokens import make_fl_token_batches
    from repro_torch.launch.mesh import start_group, stop_group
    from repro_torch.launch.op_analysis import op_analysis
    from repro_torch.models import build_model
    from repro_torch.training.trainer import stack_for_nodes

    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    g = start_group(rank, 8, store, device="cpu", node_axes={"pod": 2, "data": 2},
                    model_shards=2)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    bundle = build_model(cfg)
    stacked = stack_for_nodes(bundle.init_fn(torch.Generator().manual_seed(0),
                                             device="cpu"), 4)
    eng, rows = ShardedFusedEngine.from_group(g, stacked, model_axis="model")
    fl = FLConfig(algorithm="dsgt", q=2, n_nodes=4)
    state = init_fl_state(fl, rows, eng)
    rf = make_fl_round(bundle.loss_fn, inv_sqrt(0.02), fl, eng)
    batch = next(make_fl_token_batches(cfg.vocab_size, 4, 1, 16, q=2, seed=0))
    with op_analysis(pod_ranks=4) as oa:
        rf(state, batch)
    if rank == 0:
        c = oa.costs()
        with open(out, "w") as f:
            json.dump({"per_kind": c.collectives, "total": c.collective_bytes,
                       "cross_pod": c.cross_pod_bytes, "engine": [
                           eng.collectives, eng.collective_bytes, eng.shard_gathers]}, f)
    stop_group(g)
    sys.stdout.flush()
    os._exit(0)
    """
)


def test_test_mesh_record_equals_the_gloo_round(tmp_path):
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(rank), str(tmp_path / "store"),
         str(tmp_path / "rank0.json")], env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(8)]
    rec = dryrun.run_pair("tinyllama-1.1b", "train_4k", "test", q=2, fl_engine="sharded_fused",
                          fl_shard_model=True, mesh_layout=make_test_mesh((2, 2, 2)),
                          smoke=True, seq_len=16, global_batch=4)
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-4000:]
    real = json.loads((tmp_path / "rank0.json").read_text())
    assert not dist.is_initialized()
    assert rec["n_chips"] == 8 and rec["n_nodes"] == 4
    assert rec["collectives"]["per_kind"] == real["per_kind"]
    assert rec["collectives"]["total_bytes"] == real["total"]
    assert rec["collectives"]["cross_pod_bytes"] == real["cross_pod"] > 0
    sends = rec["collectives"]["per_kind"]["send"]
    assert [sends["count"], sends["bytes"], rec["shard_gathers"]] == real["engine"]
    # the torus {pod 2, data 2}: a message along each axis, both directions
    assert rec["two_axis"]["collective_axes"] == ["data", "pod"]
    assert rec["two_axis"]["pallas_calls"] == 1


def test_file_names_follow_the_references_rules(tmp_path):
    """Each command line's file name from the reference's ``main`` (its
    ``run_pair`` stubbed: nothing is lowered) equals the port's."""
    argvs = [
        ["--arch", "a", "--shape", "train_4k"],
        ["--arch", "a", "--shape", "train_4k", "--q", "2", "--fl-engine", "sharded_fused",
         "--fl-shard-model"],
        ["--arch", "a", "--shape", "decode_32k", "--mesh", "multi", "--q", "2"],
        ["--arch", "a", "--shape", "train_4k", "--fl-engine", "sharded_fused", "--topk",
         "64", "--fl-schedule", "bounded_staleness:k=3", "--fl-topology-program",
         "node_churn:p_down=0.2", "--fl-node-program", "stragglers:frac=0.25",
         "--fl-privacy", "secure_agg+dp:sigma=0.5,clip=1.0", "--fl-scope",
         "backbone:private=head", "--pad-heads", "16", "--wire-dtype", "bfloat16",
         "--pod-gossip-every", "4", "--algorithm", "dsgd", "--impl", "blocked"],
    ]
    script = textwrap.dedent(
        """
        import json, os, sys
        import repro.launch.dryrun as d
        d.run_pair = lambda *a, **k: {}
        argvs, root, names = json.loads(sys.argv[1]), sys.argv[2], []
        for i, argv in enumerate(argvs):
            out = os.path.join(root, str(i))
            sys.argv = ["dryrun", *argv, "--out", out]
            d.main()
            names.append(os.listdir(out)[0])
        print(json.dumps(names))
        """)
    env = dict(_env(), JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script, json.dumps(argvs), str(tmp_path)],
                          env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    got = [dryrun.record_name(dryrun._parser().parse_args(a)) for a in argvs]
    assert got == want


def test_refusals_and_the_skip():
    with pytest.raises(ValueError, match="needs the sharded_fused engine"):
        dryrun.run_pair("tinyllama-1.1b", "train_4k", "single", fl_engine="fused",
                        fl_shard_model=True)
    with pytest.raises(ValueError, match="unknown engine 'nope'"):
        dryrun.run_pair("tinyllama-1.1b", "train_4k", "single", fl_engine="nope")
    with pytest.raises(ValueError, match="wire is always int8"):
        dryrun.run_pair("tinyllama-1.1b", "train_4k", "single", fl_engine="sharded_fused",
                        wire_dtype="bfloat16", smoke=True)
    assert not dist.is_initialized()  # the fake world went down with the refusal
    with pytest.raises(ValueError, match="no blocked implementation"):
        dryrun.run_pair("tinyllama-1.1b", "train_4k", "single", impl="blocked")
    skip = dryrun.run_pair("whisper-medium", "long_500k", "single")
    assert skip["status"] == "skipped" and "whisper x long_500k" in skip["reason"]


def test_a_serving_pair_splits_over_the_ranks():
    """SmolLM-360M's decode_32k on the single-pod mesh, rank 0's own call:
    its shards of the 16 model ranks' layers, its 8 of the 128 tokens, its
    cache of the one kv head its q head reads (15 q / 5 kv heads of 64
    over 16 ranks: 60 q columns a rank, so every rank gathers), no
    division. The model group issues ``expected_collectives`` of a decode
    step: the embedding's all-reduce, ``wo``'s and ``down``'s a layer, the
    cut heads' all-gather a layer and the logits' one; one decode kernel
    a layer on the rank's heads. The reference's placement -- the whole
    caches split by batch, replicated over the model axis -- is recorded
    beside the rank's."""
    rec = dryrun.run_pair("smollm-360m", "decode_32k", "single")
    cfg = get_config("smollm-360m")
    bundle = build_model(cfg, remat=False)
    params = bundle.param_shapes()
    placed = tree_bytes(shard_params(params, 0, 16))
    assert placed == rank_bytes(params, model_param_specs(params), make_production_mesh())
    tp = rec["tensor_parallel"]
    assert tp["param_bytes"] == placed and tp["batch_share"] == 8 and tp["batch"] == 128
    seq, hd, layers = SHAPES["decode_32k"].seq_len, cfg.head_dim, cfg.n_layers
    assert tp["heads"]["kv_hi"] - tp["heads"]["kv_lo"] == 1 and tp["heads"]["gather_q"]
    assert tp["state_bytes"] == layers * 2 * 8 * seq * 1 * hd * 2 + layers * 4
    assert rec["memory"]["argument_bytes"] == placed + tp["state_bytes"] + 8 * 4
    # the reference's placement: the whole caches split by their batch dim
    caches = bundle.init_decode_state_fn(128, seq, device="meta")
    assert tp["reference_state_bytes"] == sum(
        t.numel() * t.element_size() // (16 if 128 in t.shape[:2] else 1)
        for t in dryrun._leaves(caches)) > 4 * tp["state_bytes"]
    assert rec["kernel_calls"] == {"decode_attention": layers}
    assert "no division" in rec["flops_split"] and "divided" not in rec["flops_split"]
    want = expected_collectives(cfg, 16, kind="decode")
    assert want == {"all-reduce": 1 + 2 * layers, "all-gather": layers + 1}
    kinds = rec["collectives"]["per_kind"]
    assert {k: v["count"] for k, v in kinds.items()} == want
    assert {k: v["count"] for k, v in tp["model_group"].items()} == want
    assert tp["node_group"] == {} and rec["n_chips"] == 256


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "smollm-360m"])
def test_tree_on_the_model_layout(arch):
    """A round of Q = 2 local steps (the last the comm step), one node a
    node rank: a step's model-group all-reduces are the embedding's, 5 a
    layer (wo and down forward, wo again in the recompute, the two
    column-parallel inputs backward) plus one where the rank's columns cut
    a head, the loss's hidden state's and 4 a 512-token chunk (max and
    sums forward and in the recompute); one more for the metrics' split
    leaves; an all-gather forward and in the recompute where heads are
    cut. The node group carries the gossip (params and tracker packed,
    each one message a direction of the 16-node ring) and the metrics'
    three all-reduces."""
    rec = dryrun.run_pair(arch, "train_4k", "single", q=2, fl_engine="tree")
    assert not dist.is_initialized()
    cfg = get_config(arch)
    mesh = make_production_mesh()
    tp = rec["tensor_parallel"]
    assert tp["model_shards"] == 16 and rec["n_chips"] == 256 and rec["n_nodes"] == 16
    params = build_model(cfg).param_shapes()
    stacked = {k: v for k, v in _stack16(params).items()}
    want = rank_bytes(stacked, node_stack_specs(model_param_specs(params), ("data",)), mesh)
    assert tp["param_bytes"] == tp["tracker_bytes"] == tp["prev_grad_bytes"] == want
    batch = 2 * 1 * (256 // 16) * (4096 + 1) * 4
    assert rec["memory"]["argument_bytes"] == 3 * want + batch
    layers, chunks, q = cfg.n_layers, 4096 // 512, 2
    cut = int(tp["heads"]["gather_q"] or tp["heads"]["gather_kv"])
    assert cut == 1 and tp["heads"]["gather_q"] == (arch == "smollm-360m")
    step = 1 + layers * (5 + cut) + 1 + 4 * chunks
    model = tp["model_group"]
    assert model["all-reduce"]["count"] == q * step + 1
    assert model["all-gather"]["count"] == q * 2 * layers * cut
    # a 16-rank model group spans two 8-GPU hosts: every byte crosses
    for kind in model.values():
        assert kind["cross_bytes"] == kind["bytes"] > 0
    node = tp["node_group"]
    assert node["send"]["count"] == node["recv"]["count"] == 4
    assert node["all-reduce"]["count"] == 3
    assert set(node) == {"send", "recv", "all-reduce"}
    assert rec["kernel_calls"] == {"flash_attention": 2 * layers * q * 1}
    per_kind = rec["collectives"]["per_kind"]
    assert per_kind["all-reduce"]["count"] == model["all-reduce"]["count"] + 3
    plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 0, 16)
    assert tp["heads"] == plan._asdict()
    args = dryrun._parser().parse_args(["--arch", arch, "--shape", "train_4k", "--q", "2",
                                        "--fl-engine", "tree"])
    assert dryrun.record_name(args) == f"{arch}_train_4k_single_q2.json"


def _stack16(params):
    from repro_torch.training.trainer import stack_for_nodes

    return stack_for_nodes(params, 16)


# ---------------------------------------------------------------------------
# the MoE and VLM archs' tree records, and the records that came before them
# ---------------------------------------------------------------------------

TREE_MOE_VLM = ["dbrx-132b", "llama4-scout-17b-a16e", "internvl2-26b"]


def _tree_record(arch):
    with open(record_path(arch, "train_4k", "single", engine="tree")) as f:
        return json.load(f)


@pytest.mark.parametrize("arch", TREE_MOE_VLM)
def test_the_moe_and_vlm_tree_records(arch):
    """train_4k, Q = 2, 16 data x 16 model: a rank's params, tracker and
    previous gradient are its placed shards (one expert of 16 a rank, the
    router whole); the arguments add the rank's batch (a VLM's prefix
    embeddings too); the flash kernel launches twice a layer and step
    (one node a node rank); the model group issues
    ``expected_collectives`` (the prefix positions counted) a step, and
    one all-reduce more for the metrics' split leaves; the node group the
    gossip and the metrics."""
    rec = _tree_record(arch)
    cfg = get_config(arch)
    q, mesh = 2, make_production_mesh()
    assert rec["status"] == "ok" and rec["fl_engine"] == "tree" and rec["q"] == q
    tp = rec["tensor_parallel"]
    assert tp["model_shards"] == 16 and rec["n_chips"] == 256 and rec["n_nodes"] == 16
    params = build_model(cfg).param_shapes()
    placed = tree_bytes(shard_params(params, 0, 16))
    want = rank_bytes(_stack16(params), node_stack_specs(model_param_specs(params),
                                                         ("data",)), mesh)
    assert want == placed
    assert tp["param_bytes"] == tp["tracker_bytes"] == tp["prev_grad_bytes"] == want
    batch = train_input_specs(cfg, SHAPES["train_4k"], 16, q)
    batch_bytes = rank_bytes(batch, batch_specs(batch, ("data",)), {"data": 16})
    assert rec["memory"]["argument_bytes"] == 3 * want + batch_bytes
    assert rec["kernel_calls"] == {"flash_attention": 2 * cfg.n_layers * q}
    assert rec["kernel_calls"]["flash_attention"] == {"dbrx-132b": 160}.get(arch, 192)
    positions = 4096  # a VLM's text tokens follow its prefix inside the 4,096
    step = expected_collectives(cfg, 16, positions)
    model = tp["model_group"]
    assert model["all-reduce"]["count"] == q * step["all-reduce"] + 1
    assert model["all-gather"]["count"] == q * step["all-gather"] > 0
    for kind in model.values():
        assert kind["cross_bytes"] == kind["bytes"] > 0
    node = tp["node_group"]
    assert {k: v["count"] for k, v in node.items()} == {"send": 4, "recv": 4, "all-reduce": 3}
    plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 0, 16)
    assert tp["heads"] == plan._asdict() and plan.gather_kv  # half a kv head a rank


def test_the_moe_tree_record_is_the_dry_runs_own():
    """llama4-scout-17b-a16e's committed tree record equals the dry run's
    (MoE with the shared expert, 2.5 q heads a rank), but for the host's
    seconds."""
    got = dryrun.run_pair("llama4-scout-17b-a16e", "train_4k", "single", q=2, fl_engine="tree")
    want = _tree_record("llama4-scout-17b-a16e")
    for key in ("trace_s", "wall_s"):
        got.pop(key, None)
        want.pop(key)
    assert json.loads(json.dumps(got)) == want
    assert want["tensor_parallel"]["heads"]["gather_q"]


TREE_RECURRENT_AUDIO = ["rwkv6-7b", "recurrentgemma-2b", "whisper-medium"]
#: each hand kernel's launches in the round (the code implies them: 2 x
#: layers a step under remat for a decoder's kernels, whisper's encoder
#: once a layer, Q = 2): WKV-6 2 x 32 x 2, the RG-LRU scan 2 x 18 x 2 and
#: flash 2 x 8 x 2, whisper's flash (24 + 2 x 2 x 24) x 2
TREE_KERNELS = {"rwkv6-7b": {"wkv6": 128},
                "recurrentgemma-2b": {"rglru_scan": 72, "flash_attention": 32},
                "whisper-medium": {"flash_attention": 240}}


@pytest.mark.parametrize("arch", TREE_RECURRENT_AUDIO)
def test_the_recurrent_and_audio_tree_records(arch):
    """train_4k, Q = 2, 16 data x 16 model: a rank's params, tracker and
    previous gradient are its placed shards (RWKV6's 4 heads a rank,
    RG-LRU's 160 channels of each ``in_proj`` half, whisper's one head and
    3,248 vocab rows); the arguments add the rank's batch (whisper's
    frames too); the kernels launch as ``TREE_KERNELS`` says; the model
    group issues ``expected_collectives`` a step and one all-reduce more
    for the metrics' split leaves; the node group the gossip and the
    metrics; the head plan is the decoder's (none for RWKV6)."""
    rec = _tree_record(arch)
    cfg = get_config(arch)
    q, mesh = 2, make_production_mesh()
    assert rec["status"] == "ok" and rec["fl_engine"] == "tree" and rec["q"] == q
    tp = rec["tensor_parallel"]
    assert tp["model_shards"] == 16 and rec["n_chips"] == 256 and rec["n_nodes"] == 16
    params = build_model(cfg).param_shapes()
    placed = tree_bytes(shard_params(params, 0, 16))
    want = rank_bytes(_stack16(params), node_stack_specs(model_param_specs(params),
                                                         ("data",)), mesh)
    assert want == placed
    assert tp["param_bytes"] == tp["tracker_bytes"] == tp["prev_grad_bytes"] == want
    batch = train_input_specs(cfg, SHAPES["train_4k"], 16, q)
    batch_bytes = rank_bytes(batch, batch_specs(batch, ("data",)), {"data": 16})
    assert rec["memory"]["argument_bytes"] == 3 * want + batch_bytes
    assert rec["kernel_calls"] == TREE_KERNELS[arch]
    step = expected_collectives(cfg, 16, 4096)
    model = tp["model_group"]
    assert model["all-reduce"]["count"] == q * step["all-reduce"] + 1
    assert model.get("all-gather", {"count": 0})["count"] == q * step["all-gather"]
    assert (step["all-gather"] > 0) == (arch != "whisper-medium")
    for kind in model.values():
        assert kind["cross_bytes"] == kind["bytes"] > 0
    node = tp["node_group"]
    assert {k: v["count"] for k, v in node.items()} == {"send": 4, "recv": 4, "all-reduce": 3}
    if cfg.n_heads:
        plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 0,
                                 16)
        assert tp["heads"] == plan._asdict()
    else:
        assert tp["heads"] is None


#: sha256 (first 16 hex digits) of the records committed before the
#: recurrent and audio archs' tree pairs (the serving records as their
#: per-rank calls rewrote them)
EARLIER_RECORDS = {
    "dbrx-132b_decode_32k_single.json": "f4d48ced5ff007aa",
    "dbrx-132b_long_500k_single.json": "4a788f7f85c256b5",
    "dbrx-132b_prefill_32k_single.json": "a0bcef8601a8ca91",
    "dbrx-132b_train_4k_single_q2.json": "01d98b810940f647",
    "dbrx-132b_train_4k_single_sharded_fused_shardmodel_q2.json": "e823cde016ac4947",
    "internvl2-26b_decode_32k_single.json": "eff30ed21c7b1331",
    "internvl2-26b_long_500k_single.json": "1b7ad3e25e8dc834",
    "internvl2-26b_prefill_32k_single.json": "f3e2fc709cd728f3",
    "internvl2-26b_train_4k_single_q2.json": "243e262d6886c72d",
    "internvl2-26b_train_4k_single_sharded_fused_shardmodel_q2.json": "ac0c9efe39cc535b",
    "llama4-scout-17b-a16e_decode_32k_single.json": "b8d5f4cc54d4224a",
    "llama4-scout-17b-a16e_long_500k_single.json": "77942f0987c7b295",
    "llama4-scout-17b-a16e_prefill_32k_single.json": "5d4bf57fdf46905e",
    "llama4-scout-17b-a16e_train_4k_single_q2.json": "a236174d5f00a3d5",
    "llama4-scout-17b-a16e_train_4k_single_sharded_fused_shardmodel_q2.json": "ea9ae27091bb3c1f",
    "phi3-medium-14b_decode_32k_single.json": "e87a4fbd10d7e67b",
    "phi3-medium-14b_long_500k_single.json": "48d546839e3eee81",
    "phi3-medium-14b_prefill_32k_single.json": "8bf7cd2f410c5a50",
    "phi3-medium-14b_train_4k_single_q2.json": "cb9dc16ff9cc6208",
    "phi3-medium-14b_train_4k_single_sharded_fused_shardmodel_q2.json": "e0e44bd991919625",
    "qwen2.5-32b_decode_32k_single.json": "6c90541377760504",
    "qwen2.5-32b_long_500k_single.json": "d21f579954d6e345",
    "qwen2.5-32b_prefill_32k_single.json": "a1c7291469ecdf09",
    "qwen2.5-32b_train_4k_single_q2.json": "905707965af67ebe",
    "qwen2.5-32b_train_4k_single_sharded_fused_shardmodel_q2.json": "d4f3f90d0020c727",
    "recurrentgemma-2b_decode_32k_single.json": "54ea751f769273d6",
    "recurrentgemma-2b_long_500k_single.json": "eba7d72871106740",
    "recurrentgemma-2b_prefill_32k_single.json": "c58f966ca15229b0",
    "recurrentgemma-2b_train_4k_single_sharded_fused_shardmodel_q2.json": "e60bd9ddc49ec117",
    "rwkv6-7b_decode_32k_single.json": "cd2d554489b255b8",
    "rwkv6-7b_long_500k_single.json": "fa367b3ac64d2054",
    "rwkv6-7b_prefill_32k_single.json": "dca326b6fbb201d8",
    "rwkv6-7b_train_4k_single_sharded_fused_shardmodel_q2.json": "1512dc57ac249f25",
    "smollm-360m_decode_32k_single.json": "58caf2d1fa973e88",
    "smollm-360m_long_500k_single.json": "c3ecb27fcb2c7db4",
    "smollm-360m_prefill_32k_single.json": "a77166d802484bd7",
    "smollm-360m_train_4k_single_q2.json": "6e52bdbd80d6178f",
    "smollm-360m_train_4k_single_sharded_fused_shardmodel_q2.json": "383fcd0b08285864",
    "tinyllama-1.1b_decode_32k_single.json": "4cdf8797e17f8ce8",
    "tinyllama-1.1b_long_500k_single.json": "663a9ea954b579e9",
    "tinyllama-1.1b_prefill_32k_single.json": "412a6942bbabd040",
    "tinyllama-1.1b_train_4k_single_q2.json": "55c30ab442580165",
    "tinyllama-1.1b_train_4k_single_sharded_fused_shardmodel_q2.json": "bfa255dea204fd0f",
    "whisper-medium_decode_32k_single.json": "183a25886dd385fa",
    "whisper-medium_long_500k_single.json": "6045bb7a6ef480e3",
    "whisper-medium_prefill_32k_single.json": "c3a6b3fdfe8d73ee",
    "whisper-medium_train_4k_single_sharded_fused_shardmodel_q2.json": "01c01161a5fc83e3",
}


def test_the_earlier_records_are_unchanged():
    import hashlib

    names = sorted(n for n in os.listdir(OUT_DIR) if n.endswith(".json"))
    new = {f"{arch}_train_4k_single_q2.json" for arch in TREE_RECURRENT_AUDIO}
    new |= {f"tinyllama-1.1b_train_4k_single_{engine}_q2.json" for engine in REPLICA}
    assert set(names) == set(EARLIER_RECORDS) | new
    for name, digest in EARLIER_RECORDS.items():
        with open(os.path.join(OUT_DIR, name), "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest()[:16] == digest, name


# ---------------------------------------------------------------------------
# flat / fused with a node's model ranks as replicas
# ---------------------------------------------------------------------------

REPLICA = ("flat", "fused")


def _replica_record(engine):
    with open(record_path("tinyllama-1.1b", "train_4k", "single", engine=engine)) as f:
        return json.load(f)


@pytest.mark.parametrize("engine", REPLICA)
def test_the_flat_and_fused_records(engine):
    """tinyllama-1.1b, train_4k, Q = 2, 16 data x 16 model: the fake world
    is the 16 node ranks (one node each); rank 0 holds its node's whole
    flat buffer (params, tracker, previous gradient, and for ``fused`` the
    wire state: recon, residual and the neighbor accumulator, each wire)
    and runs the whole model, twice a layer and step for flash; every
    collective is on the node ranks -- ``flat`` the ring's sends and the
    metrics, ``fused`` one all-gather a wire buffer (int8 payload, scales)
    a wire and the metrics --
    and the 16 model ranks are named replicas."""
    rec = _replica_record(engine)
    cfg = get_config("tinyllama-1.1b")
    assert rec["status"] == "ok" and rec["fl_engine"] == engine
    assert rec["model_replicas"] == 16 and rec["n_chips"] == 256 and rec["n_nodes"] == 16
    assert "replicas" in rec["flops_split"] and "tensor_parallel" not in rec
    from repro_torch.core.packing import pack_layout

    total = pack_layout(_stack16(build_model(cfg).param_shapes()), pad_to=512).total
    batch = 2 * 1 * (256 // 16) * (4096 + 1) * 4
    buffers = 3 if engine == "flat" else 9
    assert rec["memory"]["argument_bytes"] == buffers * 4 * total + batch
    kinds = {k: v["count"] for k, v in rec["collectives"]["per_kind"].items()}
    # fused: the sharded engine's four metric all-reduces and the local
    # loss's mean
    assert kinds == ({"send": 4, "recv": 4, "all-reduce": 3} if engine == "flat"
                     else {"all-gather": 4, "all-reduce": 5})
    assert rec["kernel_calls"]["flash_attention"] == 2 * cfg.n_layers * 2
    assert rec["kernel_calls"].get("wire_stage_gt", 0) == (engine == "fused")
    # the 16 node ranks of the single-pod mesh sit on two 8-GPU hosts
    assert rec["collectives"]["cross_node_bytes"] > 0


def test_the_fused_record_is_the_dry_runs_own():
    """The committed ``fused`` record equals the dry run's, but for the
    host's seconds (the acceptance command, in this process)."""
    got = dryrun.run_pair("tinyllama-1.1b", "train_4k", "single", q=2, fl_engine="fused")
    want = _replica_record("fused")
    for key in ("trace_s", "wall_s"):
        got.pop(key, None)
        want.pop(key)
    assert json.loads(json.dumps(got)) == want


# ---------------------------------------------------------------------------
# the serving records: rank 0's own call on its tensor-parallel shards
# ---------------------------------------------------------------------------

SERVING = sorted(n for n in EARLIER_RECORDS if "train_4k" not in n
                 and n != "whisper-medium_long_500k_single.json")


@pytest.mark.parametrize("name", SERVING)
def test_the_serving_records(name):
    """Every regenerated serving record: FLOPs and bytes of rank 0's own
    call (no division); its argument bytes its shards, its batch share and
    its states; the collectives all the model group's, exactly
    ``expected_collectives`` of a prefill or a decode step (the node group
    silent); each kernel's launches ``expected_launches`` of rank 0, whose
    heads are real ones."""
    with open(os.path.join(OUT_DIR, name)) as f:
        rec = json.load(f)
    cfg = get_config(rec["arch"])
    kind = SHAPES[rec["shape"]].kind
    assert rec["status"] == "ok" and rec["kind"] == kind and rec["n_chips"] == 256
    assert "no division" in rec["flops_split"]
    assert 0 < rec["kernel_flops"] <= rec["flops"]
    tp = rec["tensor_parallel"]
    assert tp["model_shards"] == 16
    b = SHAPES[rec["shape"]].global_batch
    assert tp["batch"] == b and tp["batch_share"] == (b // 16 if b % 16 == 0 else b)
    params = build_model(cfg).param_shapes()
    placed = tree_bytes(shard_params(params, 0, 16))
    assert tp["param_bytes"] == placed
    assert rec["memory"]["argument_bytes"] == placed + tp["batch_bytes"] + tp.get(
        "state_bytes", 0)
    assert ("state_bytes" in tp) == (kind == "decode")
    want = expected_collectives(cfg, 16, kind=kind)
    assert {k: v["count"] for k, v in rec["collectives"]["per_kind"].items()} == want
    assert {k: v["count"] for k, v in tp["model_group"].items()} == want
    assert tp["node_group"] == {}
    launches = {k: v for k, v in expected_launches(cfg, kind).items() if v}
    assert rec["kernel_calls"] == launches
    if cfg.n_heads:
        plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                 attn.layout_heads(cfg.n_heads, cfg.tp_head_pad), 0, 16)
        assert tp["heads"] == plan._asdict() and plan.a_hi > plan.h_lo
