"""The port's ``ShardedFusedEngine`` (``sharded_fused``): node rows over
the ranks of a ``torch.distributed`` group, the compact top-k or dense
int8 wire moved by one all-gather per buffer.

* World 1, in this process (gloo on a ``FileStore`` under a temporary
  directory), on the reference suite's own contract
  (tests/test_sharded_engine.py): the exact-gradient quadratic problem,
  an Erdos-Renyi W, chunk 16, k in {None, 4}, DSGD and DSGT, sequential,
  pipelined and ``bounded_staleness:k=2``, 4 rounds -- the engine equals
  the port's ``FusedEngine`` on ``dense_equivalent()`` within 1e-5 with
  equal ``wire_bytes``, and the reference's ``FusedEngine(impl="jnp")``
  on the same W within 1e-5.
* The counters: one wire-stage call per round and no round-kernel call;
  3 (compact) or 2 (dense) all-gathers per wire and round, each rank
  handing them ``R x flat_wire_bytes(layout, 1, chunk, k)`` bytes per
  wire; positions at k = 16 and the bitmap at k = 64 for chunk 512.
* Worlds 2 and 4: gloo ranks in subprocesses, 20 nodes at 10 or 5 rows a
  rank: the gathered params and the metrics equal world 1's within 1e-6.
* The paper's configuration on the EHR cohort (the reference's init
  through ``repro_torch.convert``), 5 rounds at Q = 10, top-64 and
  top-16: within the multi-round tolerance of the port's ``FusedEngine``
  (rtol 1e-3 on the loss; ROADMAP.md queue 3), and within 1e-5 on the
  masked wire.
* The refusals, each naming its ROADMAP.md item.

Why 1e-5 and not bitwise: the sharded mix accumulates
``mix_recon + W_off @ dq`` round by round, the fused engine contracts
``W_off @ recon'``: the same sum in another order. The compact wire keeps
exactly k columns where the fused engine's mask keeps every tie at the
threshold; the two agree unless a non-zero |payload| ties there, which
the quadratic problem's random data does not produce.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import engine as engine_mod  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FusedEngine,
    ShardedFusedEngine,
    get_engine,
)
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.packing import flat_wire_bytes  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.launch.mesh import node_rows, start_group, stop_group  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCHEDULES = ["sequential", "pipelined", "bounded_staleness:k=2"]
N, Q, CHUNK = 8, 2, 16


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group for this module's in-process tests."""
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu")
    yield g
    stop_group(g)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _quadratic(n, q, seed):
    """The reference suite's exact-gradient problem: per node
    ``sum((w - t)^2) + sum(b^2)``, whose gradients both packages compute
    bit for bit. Returns (loss, node-stacked numpy params, numpy batches)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(n, 4, 5)).astype(np.float32),
              "b": rng.normal(size=(n, 3)).astype(np.float32)}
    batches = {"t": rng.normal(size=(q, n, 4, 5)).astype(np.float32)}

    def loss(p, batch):
        return ((p["w"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    return loss, params, batches


def _tensors(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _er():
    return mixing_matrix("erdos_renyi", N, p=0.7, seed=1)


def _sharded_vs_fused(group, algorithm, topk, schedule, rounds=4):
    """The same rounds on the sharded engine and on ``FusedEngine`` over
    its dense equivalent. Returns (sharded state, fused state, sharded
    metrics, fused metrics, sharded engine)."""
    loss, params, batches = _quadratic(N, Q, seed=0)
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    kw = dict(scale_chunk=CHUNK, topk=topk, round_schedule=schedule)
    sh, rows = ShardedFusedEngine.from_group(group, _tensors(params), w=_er(), **kw)
    fe, flat = FusedEngine.simulated(sh.dense_equivalent(), _tensors(params), **kw)
    r_sh = make_fl_round(loss, inv_sqrt(0.05), cfg, sh)
    r_fe = make_fl_round(loss, inv_sqrt(0.05), cfg, fe)
    s_sh, s_fe = init_fl_state(cfg, rows, sh), init_fl_state(cfg, flat, fe)
    for _ in range(rounds):
        s_sh, m_sh = r_sh(s_sh, batches)
        s_fe, m_fe = r_fe(s_fe, batches)
    return s_sh, s_fe, m_sh, m_fe, sh


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("topk", [None, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_matches_fused_on_dense_equivalent(group, algorithm, topk, schedule):
    """World 1: params (and tracker) within 1e-5 of ``FusedEngine`` on
    ``dense_equivalent()`` after 4 rounds, equal ``wire_bytes``, and the
    metrics within rtol 1e-4 (sums in another order)."""
    s_sh, s_fe, m_sh, m_fe, sh = _sharded_vs_fused(group, algorithm, topk, schedule)
    np.testing.assert_allclose(_np(s_sh.params), _np(s_fe.params), rtol=0, atol=1e-5)
    if algorithm == "dsgt":
        np.testing.assert_allclose(_np(s_sh.tracker), _np(s_fe.tracker), rtol=0, atol=1e-5)
    assert m_sh["wire_bytes"] == m_fe["wire_bytes"]
    for k in ("loss", "local_loss", "grad_norm_sq", "consensus_err", "ef_residual_rms"):
        np.testing.assert_allclose(float(m_sh[k]), float(m_fe[k]), rtol=1e-4, err_msg=k)
    assert sh.wire_encoding == ("dense" if topk is None else "bitmap")


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("topk", [None, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_matches_reference_fused(group, algorithm, topk, schedule):
    """Across packages: the same inputs through the reference's
    ``FusedEngine(impl="jnp")`` on the same W, within 1e-5 after 4
    rounds, the same wire bytes; top-k ships fewer bytes than dense."""
    jax = pytest.importorskip("jax")
    from repro.core import engine as j_engine
    from repro.core import fl as j_fl
    from repro.core import schedules as j_schedules
    from repro.core.packing import pack as j_pack

    import jax.numpy as jnp

    _, params, batches = _quadratic(N, Q, seed=0)
    s_sh, _, m_sh, _, sh = _sharded_vs_fused(group, algorithm, topk, schedule)

    def j_loss(p, batch):
        return jnp.sum((p["w"] - batch["t"]) ** 2) + jnp.sum(p["b"] ** 2)

    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    j_flat, j_layout = j_pack(params, pad_to=CHUNK)
    fe = j_engine.FusedEngine(_er(), j_layout, scale_chunk=CHUNK, topk=topk, impl="jnp",
                              round_schedule=schedule)
    rf = jax.jit(j_fl.make_fl_round(j_loss, None, j_schedules.inv_sqrt(0.05), j_cfg,
                                    engine=fe))
    st = j_fl.init_fl_state(j_cfg, j_flat, engine=fe)
    for _ in range(4):
        st, jm = rf(st, batches)
    np.testing.assert_allclose(_np(s_sh.params), np.asarray(st.params), rtol=0, atol=1e-5)
    if algorithm == "dsgt":
        np.testing.assert_allclose(_np(s_sh.tracker), np.asarray(st.tracker), rtol=0,
                                   atol=1e-5)
    assert m_sh["wire_bytes"] == float(jm["wire_bytes"])
    if topk is not None:
        dense = ShardedFusedEngine(group, sh.layout, w=_er(), scale_chunk=CHUNK)
        cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
        assert sh.wire_bytes(cfg) < dense.wire_bytes(cfg)


class _Spy:
    """Counts calls to a wrapper and passes them through."""

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **kw):
        self.calls += 1
        return self.fn(*a, **kw)


KERNELS = ("fused_round", "fused_round_gt", "wire_stage", "wire_stage_gt",
           "wire_stage_compact", "wire_stage_gt_compact")


def _paper(group, algorithm, topk, schedule, rounds, monkeypatch=None):
    """The paper's configuration on the sharded engine (the example's
    ``run_sharded_engine``) with every kernel wrapper the engine can reach
    spied on. Returns (run, spies)."""
    from repro_torch.examples.ehr_federated import run_sharded_engine

    spies = {}
    if monkeypatch is not None:
        for name in KERNELS:
            spies[name] = _Spy(getattr(engine_mod, name))
            monkeypatch.setattr(engine_mod, name, spies[name])
    run = run_sharded_engine(group, rounds=rounds, q=2, algorithm=algorithm, topk=topk,
                             fl_schedule=schedule, log=False)
    return run, {k: s.calls for k, s in spies.items()}


# (topk, encoding, buffers per wire)
WIRES = [(16, "positions", 3), (64, "bitmap", 3), (None, "dense", 2)]


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("wire", WIRES, ids=lambda w: w[1])
@pytest.mark.parametrize("schedule", ["sequential", "pipelined"])
def test_one_wire_stage_and_one_gather_per_buffer(group, monkeypatch, algorithm, wire,
                                                  schedule):
    """On the paper's (20, 1536) buffer at chunk 512: ONE wire-stage call
    per round (the compact one on the compact wire) and no round-kernel
    call; one all-gather per wire buffer and wire per round, handed
    exactly ``R x flat_wire_bytes(layout, 1, chunk, k)`` bytes per wire;
    the encoding is positions at k = 16 and the bitmap at k = 64; the
    wire bytes are the port's accounting (ISSUE table)."""
    topk, encoding, buffers = wire
    rounds, wires = 3, 2 if algorithm == "dsgt" else 1
    run, calls = _paper(group, algorithm, topk, schedule, rounds, monkeypatch)
    eng = run["engine"]
    stage = {("wire_stage", 1): "wire_stage", ("wire_stage", 2): "wire_stage_gt",
             ("compact", 1): "wire_stage_compact",
             ("compact", 2): "wire_stage_gt_compact"}[
        ("wire_stage" if topk is None else "compact", wires)]
    assert calls == {k: rounds if k == stage else 0 for k in KERNELS}
    assert eng.wire_encoding == encoding
    assert eng.collectives == rounds * wires * buffers
    per_wire = len(eng.rows) * flat_wire_bytes(eng.layout, 1, 512, topk)
    assert eng.collective_bytes == rounds * wires * per_wire
    table = {(64, 2): 42_768, (64, 1): 21_384, (16, 2): 16_848, (16, 1): 8_424,
             (None, 2): 167_184, (None, 1): 83_592}
    assert run["wire_bytes"] == table[(topk, wires)]


_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core.engine import ShardedFusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.schedules import inv_sqrt
    from repro_torch.core.topology import mixing_matrix
    from repro_torch.launch.mesh import start_group, stop_group
    import torch.distributed as dist

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    g = start_group(rank, world, store, device="cpu")
    n, q, chunk = 20, 2, 16
    rng = np.random.default_rng(7)
    params = {"w": torch.tensor(rng.normal(size=(n, 4, 5)), dtype=torch.float32),
              "b": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)}
    batches = {"t": torch.tensor(rng.normal(size=(q, n, 4, 5)), dtype=torch.float32)}

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    res = {}
    for alg, topk, sched in (("dsgt", 4, "sequential"), ("dsgd", None, "pipelined"),
                             ("dsgt", 2, "bounded_staleness:k=2")):
        cfg = FLConfig(algorithm=alg, q=q, n_nodes=n)
        eng, rows = ShardedFusedEngine.from_group(
            g, params, w=mixing_matrix("hospital20", n), scale_chunk=chunk, topk=topk,
            round_schedule=sched)
        rf = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
        st = init_fl_state(cfg, rows, eng)
        for _ in range(4):
            st, m = rf(st, batches)
        full = torch.empty(n, rows.shape[1])
        dist.all_gather_into_tensor(full, st.params)
        key = f"{alg}-{topk}-{sched}"
        res[key + "/params"] = full.numpy()
        for k in ("loss", "local_loss", "grad_norm_sq", "consensus_err",
                  "ef_residual_rms", "wire_bytes"):
            res[f"{key}/{k}"] = np.float64(float(m[k]))
    if rank == 0:
        np.savez(out, **res)
    stop_group(g)
    sys.stdout.flush()
    # leave without interpreter teardown: gloo's threads have been seen
    # to abort a process at exit after the group was destroyed
    os._exit(0)
    """
)


def test_worlds_2_and_4_equal_world_1(tmp_path):
    """20 nodes on 1, 2 and 4 gloo ranks (20, 10 and 5 rows a rank), all
    started together: after 4 rounds of three configurations the
    gathered params and every metric equal world 1's within 1e-6."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for world in (1, 2, 4):
        store = str(tmp_path / f"store{world}")
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(rank), str(world), store,
                 str(tmp_path / f"world{world}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=180)
        assert p.returncode == 0, out[-4000:]
    one = np.load(tmp_path / "world1.npz")
    for world in (2, 4):
        got = np.load(tmp_path / f"world{world}.npz")
        assert sorted(got.files) == sorted(one.files)
        for key in one.files:
            np.testing.assert_allclose(got[key], one[key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"world {world}: {key}")


@pytest.mark.parametrize("topk", [64, 16])
def test_paper_configuration_tracks_fused_engine(group, monkeypatch, topk):
    """The paper's FD-DSGT on the EHR cohort from the reference's init
    (``repro_torch.convert``), 5 rounds at Q = 10, top-64 (bitmap) and
    top-16 (positions): the loss within rtol 1e-3 of the port's
    ``FusedEngine`` every round, the same wire bytes. The parameters are
    not held to 1e-5 here: the MLP's two output columns get equal and
    opposite gradients, so their |payload| ties EXACTLY in some chunks,
    where the fused engine's mask keeps both and the compact wire one
    (ROADMAP.md queue 3) -- a node's weight then moves by ~0.1. The same
    engine on the masked wire (``compact=False``: the dense wire stage
    with the top-k mask, the fused engine's tie rule) meets 1e-5."""
    jax = pytest.importorskip("jax")
    from repro.models.mlp import mlp_init as j_mlp_init
    from repro_torch.convert import params_from_numpy
    from repro_torch.examples import ehr_federated

    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_mlp_init(jax.random.key(0))),
                             device="cpu")
    fe = ehr_federated.run_fused_engine(rounds=5, q=10, topk=topk, init_params=init,
                                        device="cpu")
    sh = ehr_federated.run_sharded_engine(group, rounds=5, q=10, topk=topk,
                                          init_params=init, log=False)
    assert sh["engine"].wire_encoding == ("bitmap" if topk == 64 else "positions")
    np.testing.assert_allclose(sh["losses"], fe["losses"], rtol=1e-3)
    assert sh["wire_bytes"] == fe["wire_bytes"]
    build = ShardedFusedEngine.from_group.__func__
    monkeypatch.setattr(ShardedFusedEngine, "from_group", classmethod(
        lambda cls, *a, **kw: build(cls, *a, compact=False, **kw)))
    masked = ehr_federated.run_sharded_engine(group, rounds=5, q=10, topk=topk,
                                              init_params=init, log=False)
    assert masked["engine"].wire_encoding == "dense"
    mine = masked["engine"].params_view(masked["state"].params)
    for layer in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(_np(mine[layer][leaf]), _np(fe["params"][layer][leaf]),
                                       rtol=0, atol=1e-5, err_msg=f"{layer}.{leaf}")


def test_compact_wire_contracts_only_at_large_k(group):
    """ROADMAP.md queue 3's divergence on the compact sharded wire: pure
    gossip (a zero gradient) of (8, 64) normal data on the ring at chunk
    32, 60 rounds. k = 16 (half the chunk) contracts the spread
    ||x - mean x|| by more than 1e3; k = 4 does not contract at all (it
    ends above its start), as the compressed gossip of both packages does
    at k = 4 of 16."""
    n, t, chunk = 8, 64, 32
    x0 = np.random.default_rng(0).normal(size=(n, t)).astype(np.float32)
    cfg = FLConfig(algorithm="dsgd", q=1, n_nodes=n)

    def spread(x):
        x = np.asarray(x, np.float64)
        return float(np.linalg.norm(x - x.mean(axis=0)))

    ratio = {}
    for topk in (4, 16):
        eng, rows = ShardedFusedEngine.from_group(
            group, {"x": torch.as_tensor(x0)}, w=mixing_matrix("ring", n),
            scale_chunk=chunk, topk=topk)
        assert eng.compact_wire
        round_fn = make_fl_round(lambda p, b: (p["x"] * 0).sum(dim=1), lambda r: 0.0,
                                 cfg, eng)
        state = init_fl_state(cfg, rows, eng)
        for _ in range(60):
            state, _ = round_fn(state, {"unused": np.zeros((1, n), np.float32)})
        ratio[topk] = spread(_np(state.params)) / spread(x0)
    assert ratio[16] < 1e-3 and ratio[4] > 1.0, ratio


def test_comm_state_has_the_references_keys(group):
    """``comm_keys`` and each buffer's width and dtype == the reference's
    ``ShardedFusedEngine.comm_state_sds`` (built on a one-device mesh: a
    rank's buffers differ from a device's only in their rows), for the
    dense, positions and bitmap wires at depths 0, 1 and 3; and
    ``init_fl_state`` builds this rank's zeroed buffers."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import engine as j_engine
    from repro.core import fl as j_fl

    mesh = jax.make_mesh((1,), ("data",))
    params = {"p": torch.zeros(N, 40)}
    for topk, sched in ((None, "pipelined"), (1, "pipelined"),
                        (4, "bounded_staleness:k=3"), (4, "sequential")):
        kw = dict(scale_chunk=CHUNK, topk=topk, round_schedule=sched)
        eng, rows = ShardedFusedEngine.from_group(group, params, w=_er(), **kw)
        ref = j_engine.ShardedFusedEngine.from_mesh(
            mesh, ("data",), {"p": jnp.zeros((1, 40))}, w=np.eye(1), impl="jnp", **kw)
        assert eng.wire_encoding == ref.wire_encoding
        for alg in ("dsgd", "dsgt"):
            cfg = FLConfig(algorithm=alg, q=1, n_nodes=N)
            sds = ref.comm_state_sds(j_fl.FLConfig(algorithm=alg, q=1, n_nodes=1))
            spec = eng.comm_state_spec(cfg)
            assert list(spec) == list(sds) == list(eng.comm_keys(cfg))
            state = init_fl_state(cfg, rows, eng)
            for key, (shape, dtype) in spec.items():
                assert shape == (N,) + sds[key].shape[1:], key
                assert str(dtype).removeprefix("torch.") == sds[key].dtype.name, key
                buf = state.comm[key]
                assert tuple(buf.shape) == shape and buf.dtype == dtype and not buf.any()


@pytest.mark.parametrize("kw, item", [
    (dict(w=None), "item 15"),
    (dict(w=None, topology_program="edge_failure:p=0.1"), "item 15"),
    (dict(model_axis="model"), "item 15"),
    (dict(privacy="secure_agg"), "secure_agg needs the circulant ppermute wire"),
    (dict(scope="layerwise:freq=4,head=q"), "the layerwise round-gated mix"),
    (dict(storage_dtype="float16"), r"in \('float32', 'bfloat16'\) only"),
    (dict(difference_coding=False), "item 9"),
    (dict(error_feedback=False), "item 9"),
])
def test_refusals_name_their_item(group, kw, item):
    """What is still not ported raises ``NotImplementedError`` naming its
    item; ``secure_agg`` on the all-gather wire raises the reference's
    ``ValueError``: its pads need the circulant wire; so does the
    layerwise scope, whose gated mix needs the dense in-kernel W. The
    three ``item 15`` cases -- the circulant wire (``w=None``, also under
    a topology program) and ``model_axis`` -- are ported now and BUILD:
    the ring over the group's one node axis (``dense_equivalent`` the
    reference's ``mesh_gossip_dense_equivalent``, one direction table
    each way) and the two-axis layout at this one-rank group's one
    shard. The topology and node programs, ``slow_uplink``, dp and the
    sub-range scopes build (``tests/test_torch_sharded_dynamic.py``,
    ``tests/test_torch_privacy.py``, ``tests/test_torch_scope.py``), and
    the torus and two-axis rounds run in ``tests/test_torch_torus_wire.py``
    and ``tests/test_torch_two_axis.py``. The two ``item 9`` knobs are
    ported now and BUILD too (their rounds run in
    ``tests/test_torch_wire_knobs.py``)."""
    params = {"p": torch.zeros(N, 30), "q": torch.zeros(N, 10)}
    args = dict(w=_er(), scale_chunk=CHUNK)
    args.update(kw)
    if item == "item 9":
        eng, _ = ShardedFusedEngine.from_group(group, params, **args)
        assert (eng.error_feedback, eng.difference_coding) == (
            kw.get("error_feedback", True), kw.get("difference_coding", True))
        return
    if item == "item 15":
        from repro_torch.core.mixing import mesh_gossip_dense_equivalent

        eng, rows = ShardedFusedEngine.from_group(group, params, **args)
        assert tuple(rows.shape) == (N, eng.layout.shard_width)
        if "model_axis" in kw:
            assert eng.model_axis == "model" and eng.model_shards == 1
            assert eng.torus is None and eng.layout.shards == 1
        else:
            assert eng.node_axes == ("nodes",) and len(eng.dirs) == 2
            np.testing.assert_array_equal(eng.dense_equivalent(),
                                          mesh_gossip_dense_equivalent({"nodes": N}))
            assert eng.dynamic_topology == ("topology_program" in kw)
        return
    exc = (ValueError if {"privacy", "scope", "storage_dtype"} & set(kw)
           else NotImplementedError)
    with pytest.raises(exc, match=item):
        ShardedFusedEngine.from_group(group, params, **args)


def test_wire_rules_and_group_checks(group):
    """The reference's compact rules (an uneconomic or unsparsified
    compact wire is refused), no ``simulated`` build, and the row split."""
    params = {"p": torch.zeros(N, 40)}
    with pytest.raises(ValueError, match="costs more than the dense"):
        ShardedFusedEngine.from_group(group, params, w=_er(), scale_chunk=CHUNK, topk=15,
                                      compact=True)
    with pytest.raises(ValueError, match="needs a sparsified payload"):
        ShardedFusedEngine.from_group(group, params, w=_er(), scale_chunk=CHUNK, compact=True)
    eng, _ = ShardedFusedEngine.from_group(group, params, w=_er(), scale_chunk=CHUNK, topk=15)
    assert not eng.compact_wire and eng.wire_encoding == "dense"
    with pytest.raises(ValueError, match="from_group"):
        get_engine("sharded_fused").simulated(_er(), params)
    assert list(node_rows(20, 1, 4)) == [5, 6, 7, 8, 9]
    with pytest.raises(ValueError, match="split evenly"):
        node_rows(20, 0, 3)
    with pytest.raises(ValueError, match="rows of the packed"):
        init_fl_state(FLConfig(algorithm="dsgd", q=1, n_nodes=N), torch.zeros(N, 16), eng)
