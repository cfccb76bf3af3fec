"""``fused`` and ``flat`` built on a process group's node ranks
(``FusedEngine.from_group``, ``FlatEngine.from_group``): the engines the
dry run places on the (node, model) layout with a node's model ranks as
replicas of its whole flat buffer.

* Gloo groups of 2 and 4 node ranks in subprocesses, started together,
  on the paper's configuration (the 20-hospital EHR cohort, the 42-32-2
  MLP from the reference's init through ``repro_torch.convert``, chunk
  512, Q = 10): the ring of 20 on two ranks, the torus {pod 4, data 5} on
  four. One FD-DSGD and one FD-DSGT round of ``fused`` on the group
  (every rank's rows gathered) equal ``FusedEngine.from_node_axes`` on
  the same axes and the reference's ``FusedEngine.simulated`` on the
  same dense W within ``tests/test_torch_sharded_engine.py``'s 1e-5, with
  the same wire bytes and one all-gather a wire buffer; ``flat`` equals
  the reference's ``FlatEngine.simulated`` within 1e-5.
* The reference's ``flat`` round lowered on a 2 data x 4 model test mesh
  (8 host devices, a subprocess): no collective of its compiled HLO
  spans the model axis -- the model ranks are replicas -- and the port's
  ``flat`` record on ``--layout 2/2/4`` has no model group at all.
* The refusals ``FusedEngine.from_group`` keeps or adds, and ``flat``'s
  refusal of a group of model shards.
"""

import json
import os
import re
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import FlatEngine, FusedEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.mixing import mesh_gossip_dense_equivalent  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import NodeGroup, start_group, stop_group  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, Q, CHUNK = 20, 10, 512
#: the node axes of each world
AXES = {2: {"nodes": 20}, 4: {"pod": 4, "data": 5}}
ALGORITHMS = ["dsgd", "dsgt"]
TOL = 1e-5  # tests/test_torch_sharded_engine.py's, params after a round
METRICS = ("loss", "local_loss", "grad_norm_sq", "consensus_err", "ef_residual_rms")


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _env():
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")


_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.configs.ehr_mlp import class_weights
    from repro_torch.convert import params_from_numpy
    from repro_torch.core.engine import FlatEngine, FusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.schedules import inv_sqrt
    from repro_torch.launch.mesh import start_group, stop_group
    from repro_torch.models.mlp import make_mlp_loss
    import torch.distributed as dist

    rank, world, store, inputs, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                       sys.argv[4], sys.argv[5])
    axes = json.loads(sys.argv[6])
    g = start_group(rank, world, store, device="cpu", node_axes=axes)
    data = np.load(inputs)
    stacked = params_from_numpy({"fc1": {"w": data["fc1.w"], "b": data["fc1.b"]},
                                 "fc2": {"w": data["fc2.w"], "b": data["fc2.b"]}}, "cpu")
    batch = {"x": torch.as_tensor(data["x"]), "y": torch.as_tensor(data["y"])}
    loss = make_mlp_loss(class_weights())
    res = {}
    for engine in ("fused", "flat"):
        for alg in ("dsgd", "dsgt"):
            cfg = FLConfig(algorithm=alg, q=int(data["q"]), n_nodes=20)
            if engine == "fused":
                eng, rows = FusedEngine.from_group(g, stacked, scale_chunk=512)
            else:
                eng, rows = FlatEngine.from_group(g, stacked)
            st = init_fl_state(cfg, rows, eng)
            st, m = make_fl_round(loss, inv_sqrt(0.02), cfg, eng)(st, batch)
            full = torch.empty((20,) + tuple(st.params.shape[1:]))
            dist.all_gather_into_tensor(full, st.params.contiguous())
            key = f"{engine}-{alg}"
            res[key + "/params"] = full.numpy()
            for k, v in m.items():
                res[f"{key}/{k}"] = np.float64(float(v))
            if engine == "fused":
                res[key + "/all_gathers"] = np.int64(eng.collectives)
                res[key + "/rows"] = np.int64(len(eng.rows))
    if rank == 0:
        np.savez(out, **res)
    stop_group(g)
    sys.stdout.flush()
    os._exit(0)
    """
)


def _inputs():
    """The reference's MLP init (numpy) stacked on 20 nodes, and one
    round's EHR batches (the port's batcher: the reference's, bitwise)."""
    jax = pytest.importorskip("jax")
    from repro.models.mlp import mlp_init as j_mlp_init
    from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher
    from repro_torch.training.trainer import stack_batches

    init = jax.tree_util.tree_map(np.asarray, j_mlp_init(jax.random.key(0)))
    stacked = {layer: {leaf: np.stack([v] * N) for leaf, v in leaves.items()}
               for layer, leaves in init.items()}
    batch = stack_batches(make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1), Q)
    return stacked, batch


def _port_round(engine, flat, alg, batch):
    from repro_torch.configs.ehr_mlp import class_weights
    from repro_torch.models.mlp import make_mlp_loss

    cfg = FLConfig(algorithm=alg, q=Q, n_nodes=N)
    st = init_fl_state(cfg, flat, engine)
    st, m = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02), cfg, engine)(
        st, {k: torch.as_tensor(v) for k, v in batch.items()})
    return st.params.numpy(), {k: float(v) for k, v in m.items()}


def _reference_round(engine, alg, stacked, batch):
    """One round of the reference's ``FusedEngine.simulated`` (``impl="jnp"``)
    or ``FlatEngine.simulated`` on the same W and numpy inputs."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.configs.ehr_mlp import class_weights as j_class_weights
    from repro.core import engine as j_engine
    from repro.core import fl as j_fl
    from repro.core.schedules import inv_sqrt as j_inv_sqrt
    from repro.models.mlp import make_mlp_loss as j_make_mlp_loss

    axes, out = engine
    w = mesh_gossip_dense_equivalent(axes)
    j_stacked = jax.tree_util.tree_map(jnp.asarray, stacked)
    if out == "fused":
        eng, flat = j_engine.FusedEngine.simulated(w, j_stacked, scale_chunk=CHUNK, impl="jnp")
    else:
        eng, flat = j_engine.FlatEngine.simulated(w, j_stacked)
    cfg = j_fl.FLConfig(algorithm=alg, q=Q, n_nodes=N)
    rf = jax.jit(j_fl.make_fl_round(j_make_mlp_loss(j_class_weights()), None,
                                    j_inv_sqrt(0.02), cfg, engine=eng))
    st, m = rf(j_fl.init_fl_state(cfg, flat, engine=eng),
               jax.tree_util.tree_map(jnp.asarray, batch))
    return np.asarray(st.params), {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The groups of 2 and 4 node ranks (started together), and meanwhile
    the port's single-process rounds and the reference's, here."""
    from repro_torch.convert import params_from_numpy

    tmp = tmp_path_factory.mktemp("fused_group")
    stacked, batch = _inputs()
    inputs = tmp / "inputs.npz"
    np.savez(inputs, q=Q, x=batch["x"], y=batch["y"],
             **{f"{layer}.{leaf}": v for layer, leaves in stacked.items()
                for leaf, v in leaves.items()})
    procs = []
    for world, axes in AXES.items():
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(rank), str(world),
                 str(tmp / f"store{world}"), str(inputs), str(tmp / f"world{world}.npz"),
                 json.dumps(axes)],
                env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    single, reference = {}, {}
    for world, axes in AXES.items():
        for alg in ALGORITHMS:
            eng, flat = FusedEngine.from_node_axes(axes, params_from_numpy(stacked, "cpu"),
                                                   scale_chunk=CHUNK)
            single[(world, alg)] = _port_round(eng, flat, alg, batch)
            for engine in ("fused", "flat"):
                reference[(world, engine, alg)] = _reference_round((axes, engine), alg,
                                                                   stacked, batch)
    for p in procs:
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    got = {world: dict(np.load(tmp / f"world{world}.npz")) for world in AXES}
    return got, single, reference


def _close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol,
                               err_msg=what)


@pytest.mark.parametrize("alg", ALGORITHMS)
@pytest.mark.parametrize("world", sorted(AXES))
def test_fused_on_a_group_equals_from_node_axes(runs, world, alg):
    """The group's round (every rank's rows gathered) against the port's
    single-process round on the same node axes: params within 1e-5, the
    metrics within rtol 1e-4, the same wire bytes; one all-gather a wire
    buffer (int8 payload, scales) a round, the rank's rows."""
    got, single, _ = runs
    params, metrics = single[(world, alg)]
    key = f"fused-{alg}"
    _close(got[world][key + "/params"], params, what=key)
    for k in METRICS:
        np.testing.assert_allclose(got[world][f"{key}/{k}"], metrics[k], rtol=1e-4, err_msg=k)
    assert got[world][key + "/wire_bytes"] == metrics["wire_bytes"]
    assert int(got[world][key + "/all_gathers"]) == 2 * (2 if alg == "dsgt" else 1)
    assert int(got[world][key + "/rows"]) == N // world


@pytest.mark.parametrize("alg", ALGORITHMS)
@pytest.mark.parametrize("world", sorted(AXES))
def test_fused_on_a_group_equals_the_reference(runs, world, alg):
    """Across packages: the reference's ``FusedEngine.simulated`` on the
    torus's dense W and the same numpy init and batches."""
    got, _, reference = runs
    params, metrics = reference[(world, "fused", alg)]
    key = f"fused-{alg}"
    _close(got[world][key + "/params"], params, what=key)
    np.testing.assert_allclose(got[world][key + "/loss"], metrics["loss"], rtol=1e-4)
    assert got[world][key + "/wire_bytes"] == metrics["wire_bytes"]


@pytest.mark.parametrize("alg", ALGORITHMS)
@pytest.mark.parametrize("world", sorted(AXES))
def test_flat_on_a_group_equals_the_reference(runs, world, alg):
    """``flat`` on the group (the mesh flat mix over its node axes, the
    exact wire) against the reference's ``FlatEngine.simulated`` on the
    dense W: params within 1e-5 (the flat buffer unpadded: chunk 1), the
    loss within rtol 1e-4."""
    got, _, reference = runs
    params, metrics = reference[(world, "flat", alg)]
    key = f"flat-{alg}"
    _close(got[world][key + "/params"], params, what=key)
    np.testing.assert_allclose(got[world][key + "/loss"], metrics["loss"], rtol=1e-4)


# ---------------------------------------------------------------------------
# the model ranks are replicas: the reference's lowering and the port's record
# ---------------------------------------------------------------------------

_LOWER = textwrap.dedent(
    """
    import json, sys
    from repro.configs import get_config
    import repro.launch.dryrun as d
    from repro.launch.mesh import make_test_mesh

    d.get_config = lambda arch, smoke=True: get_config(arch, smoke=True)
    mesh = make_test_mesh((2, 4))
    jitted, args, cfg, aux = d.build_train_lowering("smollm-360m", "train_4k", mesh, q=2,
                                                    fl_engine="flat")
    print(json.dumps(jitted.lower(*args).compile().as_text()))
    """
)

_COLLECTIVE = re.compile(
    r"= \S+ (all-reduce|all-gather|collective-permute|all-to-all|reduce-scatter)"
    r"(?:-start)?\((.*)$")


def _groups(line: str):
    """The device groups of one collective's HLO line: its replica groups
    (listed, or in the iota form ``[g,s]<=[dims]T(perm)``), or a
    collective-permute's source-target pairs."""
    m = re.search(r"source_target_pairs=\{(.*?)\}\}", line)
    if m:
        return [[int(x) for x in p.split(",")] for p in re.findall(r"\{([\d,]+)", m.group(1)
                                                                      + "}")]
    m = re.search(r"replica_groups=\[([\d,]+)\]<=\[([\d,]+)\](?:T\(([\d,]+)\))?", line)
    if m:
        shape, dims = ([int(x) for x in g.split(",")] for g in m.groups()[:2])
        ids = np.arange(int(np.prod(dims))).reshape(dims)
        if m.group(3):
            ids = ids.transpose([int(x) for x in m.group(3).split(",")])
        return ids.reshape(shape).tolist()
    m = re.search(r"replica_groups=\{(.*?)\}\}", line)
    if m:
        return [[int(x) for x in g.split(",")] for g in re.findall(r"\{([\d,]+)",
                                                                   m.group(1) + "}")]
    return [list(range(8))]  # no groups: every device


def test_the_references_flat_round_crosses_no_model_axis():
    """The reference's ``flat`` round on a 2 data x 4 model mesh (device
    ``4 d + m``), smollm-360m's smoke config, train_4k, Q = 2, compiled:
    every collective's groups keep one model coordinate -- the node-axis
    all-reduces and the ring's collective-permutes -- so the 4 model ranks
    of a node are replicas of its whole round, as the port's dry run
    builds them."""
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    proc = subprocess.run([sys.executable, "-c", _LOWER], env=env, cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    hlo = json.loads(proc.stdout.strip().splitlines()[-1])
    seen = {}
    for line in hlo.splitlines():
        m = _COLLECTIVE.search(line)
        if not m:
            continue
        groups = _groups(line)
        seen[m.group(1)] = seen.get(m.group(1), 0) + 1
        assert all(len({i % 4 for i in g}) == 1 for g in groups), (m.group(1), groups)
    assert seen.get("all-reduce", 0) >= 1 and seen.get("collective-permute", 0) >= 1, seen


def test_the_ports_flat_record_has_no_model_group():
    """``--layout 2/2/4``: 2 nodes on 2 node ranks of 4 model ranks each.
    The fake world is the 2 node ranks alone; every message of the round
    is between them, and the record names the 4 model replicas."""
    rec = dryrun.run_pair("smollm-360m", "train_4k", "single", q=2, fl_engine="flat",
                          mesh_layout=dryrun._custom_mesh(2, 2, 4), nodes=2, smoke=True,
                          seq_len=16, global_batch=4)
    assert rec["n_chips"] == 8 and rec["model_replicas"] == 4 and rec["n_nodes"] == 2
    assert "tensor_parallel" not in rec and "replicas" in rec["flops_split"]
    assert set(rec["collectives"]["per_kind"]) == {"send", "recv", "all-reduce"}


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu")
    yield g
    stop_group(g)


def _params():
    rng = np.random.default_rng(0)
    return {k: torch.as_tensor(rng.normal(size=(4, 8, 16)).astype(np.float32))
            for k in ("head", "w")}


@pytest.mark.parametrize("kw, match", [
    (dict(wire_dtype="bfloat16"), "wire is always int8"),
    (dict(privacy="secure_agg"), "secure_agg needs the circulant ppermute wire"),
    (dict(scope="layerwise:freq=2,head=head"), "layerwise round-gated mix needs"),
])
def test_fused_from_group_refusals(group, kw, match):
    """What the sharded engine's dense-W path cannot run, refused by it
    with its own message behind one that names ``fused`` on a group."""
    with pytest.raises(ValueError, match=f"^'fused' on a group runs .*{match}"):
        FusedEngine.from_group(group, _params(), scale_chunk=16, **kw)


def test_a_group_of_model_shards_is_refused(group):
    """A node's model ranks are replicas of the flat buffer: both engines
    want the group of the node ranks alone."""
    two = NodeGroup(group.pg, 0, 2, group.device, (), 2)
    with pytest.raises(ValueError, match="replicas"):
        FusedEngine.from_group(two, _params(), scale_chunk=16)
    with pytest.raises(ValueError, match="replicas"):
        FlatEngine.from_group(two, _params())


def test_fused_from_group_takes_the_knobs(group):
    """One rank: the dense W of the ring of 4 on the all-gather wire, the
    masked top-k dense wire by default (the fused engine's tie rule), the
    schedules, the programs, dp and bf16 storage as the sharded dense path
    takes them."""
    stacked = _params()
    for kw in (dict(topk=4), dict(round_schedule="pipelined"),
               dict(round_schedule="bounded_staleness:k=2"),
               dict(topology_program="node_churn:p_down=0.1"),
               dict(node_program="stragglers:frac=0.25,rate=0.5"),
               dict(privacy="dp:sigma=0.5,clip=1.0"), dict(storage_dtype="bfloat16")):
        eng, rows = FusedEngine.from_group(group, stacked, scale_chunk=16, **kw)
        assert eng.torus is None and eng.wire_encoding == "dense"
        np.testing.assert_array_equal(eng.dense_equivalent(),
                                      mesh_gossip_dense_equivalent({"nodes": 4}))
        assert tuple(rows.shape) == (4, eng.layout.total)
    eng, _ = FusedEngine.from_group(group, stacked, scale_chunk=16, topk=4, compact=True)
    assert eng.wire_encoding != "dense"
