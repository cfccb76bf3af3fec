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
* the refusals, the documented skip, and a serving pair's per-rank bytes.
"""

import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
dist = torch.distributed

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.sharding import model_param_specs, rank_bytes  # noqa: E402

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
    for engine in ("tree", "flat", "fused"):
        with pytest.raises(ValueError, match="item 18b"):
            dryrun.run_pair("tinyllama-1.1b", "train_4k", "single", fl_engine=engine)
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
    """SmolLM-360M's decode_32k on the single-pod mesh: the parameters by
    the tensor-parallel rules, the caches and tokens split over the 16
    node ranks, the call's FLOPs divided over the 256 ranks; one decode
    kernel a layer."""
    rec = dryrun.run_pair("smollm-360m", "decode_32k", "single")
    cfg = get_config("smollm-360m")
    bundle = build_model(cfg, remat=False)
    params = bundle.param_shapes()
    mesh = make_production_mesh()
    caches = bundle.init_decode_state_fn(128, SHAPES["decode_32k"].seq_len, device="meta")
    # the layer-stacked K and V caches (L, B, C, K, hd) split by their batch
    # dim; the per-layer positions (L,) stay whole on every rank
    cache_bytes = sum(t.numel() * t.element_size() // (16 if 128 in t.shape[:2] else 1)
                      for t in dryrun._leaves(caches))
    want = rank_bytes(params, model_param_specs(params), mesh) + cache_bytes + 128 * 4 // 16
    assert rec["memory"]["argument_bytes"] == want
    assert rec["kernel_calls"] == {"decode_attention": cfg.n_layers}
    assert "divided over the 256 ranks" in rec["flops_split"]
    assert rec["collectives"]["per_kind"] == {} and rec["n_chips"] == 256
