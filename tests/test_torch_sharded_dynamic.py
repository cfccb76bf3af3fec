"""The sharded half of the dynamic round: ``sharded_fused`` under the
topology and node programs (``core.dynamics``, ``core.heterogeneity``),
``slow_uplink``'s per-node wire k included.

The reference's sharded dynamic paths fail on this machine's jax
(ROADMAP.md queue 3), so the oracle is the port's own ``FusedEngine``
under the same programs, whose dynamic rounds match the reference's
within 1e-5 after one round (``tests/test_torch_dynamic_round.py``); the
per-node-k arithmetic (``_hetero_truncate``, ``_wire_k_vec``,
``_wire_k_bytes``) is held to the reference's own methods bit for bit.

* World 1 (gloo, in this process) on the reference suite's quadratic
  problem (8 nodes, an Erdos-Renyi W, chunk 16, Q = 2), the dense int8
  wire: DSGD and DSGT x sequential, pipelined and ``bounded_staleness:k=2``
  x six programs -- params and tracker within 1e-5 of ``FusedEngine``
  after each of three rounds, each round's realized W_r and fractions
  bitwise, and the all-gathers exactly the static run's. On the compact
  wire the loss within the multi-round tolerance (rtol 1e-3).
* ``slow_uplink:frac=0`` bitwise the homogeneous-k round
  (``payload_drop:p=0``: the same dynamic round with every payload
  landing).
* Worlds 2 and 4 equal world 1 within 1e-6 under ``node_churn`` and
  ``slow_uplink`` (one subprocess test).
* ``comm_state_spec`` keys and buffer shapes equal to the reference's
  ``comm_state_specs`` / ``comm_state_sds``.

Why 1e-5 and not bitwise: the sharded mix contracts W_r's rows against
``nbr_recon_all`` with ``bmm``, the fused engine contracts ``W_off_r @
recon'`` in the round kernel's twin: the same sums in another order.
"""

import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import FusedEngine, ShardedFusedEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.heterogeneity import resolve_node_program  # noqa: E402
from repro_torch.core.packing import pack_layout  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, Q, CHUNK = 8, 2, 16
SCHEDULES = ["sequential", "pipelined", "bounded_staleness:k=2"]
PROGRAMS = {
    "edge_failure": dict(topology_program="edge_failure:p=0.3,seed=2"),
    "node_churn": dict(topology_program="node_churn:p_down=0.3,mean_downtime=2,seed=1"),
    "rgg_rewire": dict(topology_program="rgg_rewire:radius=0.6,jitter=0.2,seed=3"),
    "round_robin": dict(topology_program="round_robin_subgraphs:n_groups=2"),
    "stragglers": dict(node_program="stragglers:frac=0.5,rate=0.5,drop=1,seed=1"),
    "payload_drop": dict(node_program="payload_drop:p=0.3,seed=4"),
}
FRACTIONS = ("edge_fraction", "payload_fraction", "compute_fraction")


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


def _quadratic(seed=0):
    rng = np.random.default_rng(seed)
    params = {"w": torch.tensor(rng.normal(size=(N, 4, 5)), dtype=torch.float32),
              "b": torch.tensor(rng.normal(size=(N, 3)), dtype=torch.float32)}
    batches = {"t": rng.normal(size=(Q, N, 4, 5)).astype(np.float32)}

    def loss(p, batch):
        return ((p["w"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    return loss, params, batches


def _er():
    return mixing_matrix("erdos_renyi", N, p=0.7, seed=1)


def _run(engine, start, algorithm, rounds, loss, batches):
    """``rounds`` rounds; each round's realized W_off (of the comm state
    the round enters), params, tracker and metrics."""
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    round_fn = make_fl_round(loss, inv_sqrt(0.05), cfg, engine)
    state = init_fl_state(cfg, start, engine)
    out = []
    for _ in range(rounds):
        w_off = engine._round_gates(state.comm)[0]
        state, m = round_fn(state, batches)
        out.append((w_off, state, m))
    return out


def _pair(group, algorithm, schedule, rounds=3, topk=None, **programs):
    loss, params, batches = _quadratic()
    kw = dict(scale_chunk=CHUNK, topk=topk, round_schedule=schedule, **programs)
    sh, rows = ShardedFusedEngine.from_group(group, params, w=_er(), **kw)
    fe, flat = FusedEngine.simulated(sh.dense_equivalent(), params, **kw)
    return (sh, _run(sh, rows, algorithm, rounds, loss, batches),
            _run(fe, flat, algorithm, rounds, loss, batches))


@pytest.mark.parametrize("program", PROGRAMS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_dense_wire_matches_fused_engine(group, algorithm, schedule, program):
    """The dense int8 wire: params (and tracker) within 1e-5 of the fused
    engine after each of three rounds; each round's W_r and realized
    fractions bitwise; ONE all-gather per wire buffer and round, exactly
    the static engine's."""
    sh, mine, want = _pair(group, algorithm, schedule, **PROGRAMS[program])
    assert sh.dynamic_round and sh.wire_encoding == "dense"
    for rnd, ((w_sh, s_sh, m_sh), (w_fe, s_fe, m_fe)) in enumerate(zip(mine, want)):
        assert torch.equal(w_sh.view(torch.int32), w_fe.view(torch.int32)), rnd
        np.testing.assert_allclose(_np(s_sh.params), _np(s_fe.params), rtol=0, atol=1e-5,
                                   err_msg=f"round {rnd}")
        if algorithm == "dsgt":
            np.testing.assert_allclose(_np(s_sh.tracker), _np(s_fe.tracker), rtol=0,
                                       atol=1e-5, err_msg=f"round {rnd}")
        assert {k for k in FRACTIONS if k in m_sh} == {k for k in FRACTIONS if k in m_fe}
        for k in FRACTIONS:
            if k in m_sh:
                assert float(m_sh[k]) == float(m_fe[k]), (rnd, k)
        assert m_sh["wire_bytes"] == m_fe["wire_bytes"]
        for k in ("topo_round", "topo_key", "topo_up", "node_key"):
            if k in s_fe.comm:
                assert torch.equal(s_sh.comm[k], s_fe.comm[k]), (rnd, k)
    wires = 2 if algorithm == "dsgt" else 1
    assert sh.collectives == 3 * wires * 2
    assert sh.collective_bytes == 3 * wires * N * (sh.layout.total + 4 * sh.layout.total
                                                   // CHUNK)


@pytest.mark.parametrize("topk, encoding", [(4, "bitmap"), (1, "positions")])
@pytest.mark.parametrize("schedule", ["sequential", "pipelined"])
def test_compact_wire_tracks_fused_engine(group, schedule, topk, encoding):
    """The compact exact-k wire under churn and stragglers: the loss of
    three rounds within rtol 1e-3 of the fused engine (the compact wire
    breaks |payload| ties toward the lower index where the fused mask
    keeps them all), W_r bitwise, three all-gathers per wire and round."""
    programs = dict(topology_program="node_churn:p_down=0.3,mean_downtime=2,seed=1",
                    node_program="stragglers:frac=0.5,rate=0.5,drop=1,seed=1")
    sh, mine, want = _pair(group, "dsgt", schedule, topk=topk, **programs)
    assert sh.compact_wire and sh.wire_encoding == encoding
    for (w_sh, _, m_sh), (w_fe, _, m_fe) in zip(mine, want):
        assert torch.equal(w_sh, w_fe)
        np.testing.assert_allclose(float(m_sh["loss"]), float(m_fe["loss"]), rtol=1e-3)
    assert sh.collectives == 3 * 2 * 3


def test_slow_uplink_frac_0_is_the_homogeneous_round(group):
    """``slow_uplink:frac=0`` truncates nothing: three rounds bitwise the
    same dynamic round with a node program that changes nothing
    (``payload_drop:p=0``), on the compact and the dense wire; on the
    compact wire the effective bytes are the wire's own."""
    loss, params, batches = _quadratic()
    for topk, compact in ((4, None), (4, False)):
        runs = []
        for prog in ("slow_uplink:frac=0.0,k_scale=0.5", "payload_drop:p=0.0"):
            eng, rows = ShardedFusedEngine.from_group(
                group, params, w=_er(), scale_chunk=CHUNK, topk=topk, compact=compact,
                round_schedule="pipelined", node_program=prog)
            runs.append(_run(eng, rows, "dsgt", 3, loss, batches))
        for (_, a, ma), (_, b, mb) in zip(*runs):
            assert torch.equal(a.params, b.params) and torch.equal(a.tracker, b.tracker)
            assert all(torch.equal(a.comm[k], b.comm[k]) for k in b.comm)
        if eng.compact_wire:  # the effective bytes price the compact wire
            assert float(ma["wire_bytes_effective"]) == ma["wire_bytes"]


def test_slow_uplink_ships_fewer_effective_bytes(group):
    """``slow_uplink`` on the bitmap wire, pipelined: the slow nodes'
    payloads keep k_i = round(k_scale * topk) entries a chunk (the rest
    stays in their residual), the effective bytes are the numpy oracle's
    (the reference suite's, tests/test_two_axis.py), the losses finite."""
    loss, params, batches = _quadratic()
    prog = "slow_uplink:frac=0.5,k_scale=0.25,seed=3"
    eng, rows = ShardedFusedEngine.from_group(group, params, w=_er(), scale_chunk=CHUNK,
                                              topk=8, node_program=prog,
                                              round_schedule="pipelined")
    assert eng.supports_wire_k and eng.wire_encoding == "bitmap"
    out = _run(eng, rows, "dsgd", 3, loss, batches)
    m = out[-1][2]
    slow = eng.node_program._slow_mask.numpy() > 0.5
    kvec = np.clip(np.where(slow, round(0.25 * 8), 8), 1, 8).astype(np.float64)
    n_chunks = eng.layout.total // CHUNK
    per_chunk = np.minimum(kvec + np.minimum(kvec * 2, CHUNK // 8) + 4, CHUNK + 4)
    deg = (np.abs(eng.dense_equivalent()) > 0).sum(1) - 1
    assert float(m["wire_bytes_effective"]) == float((deg * n_chunks * per_chunk).sum())
    assert float(m["wire_bytes_effective"]) < m["wire_bytes"]
    assert np.isfinite(float(m["loss"]))
    # the payload in flight: a slow node's carries at most k_i non-zero
    # values a chunk, still in a topk-wide buffer
    vals = _np(out[-1][1].comm["wire_q"]).reshape(N, n_chunks, 8)
    assert ((vals != 0).sum(-1) <= kvec[:, None]).all()
    assert ((vals[~slow] != 0).sum(-1) > 2).any()


def _reference_engine():
    """The reference's engine module (its ``ShardedFusedEngine``'s
    per-node-k methods are the oracle)."""
    pytest.importorskip("jax")
    from repro.core import engine as j_engine

    return j_engine


@pytest.mark.parametrize("compact", [True, False])
def test_hetero_truncate_is_the_references(compact):
    """``_hetero_truncate`` bitwise the reference's method, called
    unbound on the same inputs: tie-heavy int8 values (|q| drawn from
    four magnitudes), k_i from 1 to topk, on explicit positions (the
    compact wire) and on the dense payload."""
    import jax.numpy as jnp

    j_engine = _reference_engine()
    rng = np.random.default_rng(5)
    rows, chunk, topk, c = 6, 32, 8, 3
    width = topk if compact else chunk
    q = (rng.choice([0, 3, -3, 7, -7, 127, -127], size=(rows, c * width))).astype(np.int8)
    scales = rng.uniform(0.01, 0.1, size=(rows, c)).astype(np.float32)
    kvec = np.array([1, 2, 3, 5, 8, 8], np.int32).reshape(rows, 1)
    pos = None
    if compact:
        pos = np.stack([np.concatenate([rng.permutation(chunk)[:topk] for _ in range(c)])
                        for _ in range(rows)]).astype(np.int16)
    ns = types.SimpleNamespace(topk=topk, scale_chunk=chunk)
    kept, ddq = ShardedFusedEngine._hetero_truncate(
        ns, torch.as_tensor(q), torch.as_tensor(scales), torch.as_tensor(kvec),
        pos=None if pos is None else torch.as_tensor(pos))
    j_kept, j_ddq = j_engine.ShardedFusedEngine._hetero_truncate(
        ns, jnp.asarray(q), jnp.asarray(scales), jnp.asarray(kvec),
        pos=None if pos is None else jnp.asarray(pos))
    assert kept.dtype == torch.int8 and np.array_equal(_np(kept), np.asarray(j_kept))
    assert np.array_equal(_np(ddq).view(np.int32), np.asarray(j_ddq).view(np.int32))
    assert ((_np(kept).reshape(rows, c, width) != 0).sum(-1) <= kvec).all()


@pytest.mark.parametrize("chunk, topk", [(16, 4), (16, 1), (512, 64), (512, 16)])
def test_wire_k_vec_and_bytes_are_the_references(chunk, topk):
    """``_wire_k_vec`` (fraction x topk in fp32, rounded half to even,
    clipped) and ``_wire_k_bytes`` bitwise the reference's methods on the
    same program, called unbound."""
    import jax.numpy as jnp

    j_engine = _reference_engine()
    from repro.core.heterogeneity import SlowUplinkProgram as JSlowUplink

    spec = "slow_uplink:frac=0.5,k_scale=0.375,seed=2"
    n = 20
    w = mixing_matrix("hospital20", n)
    layout = pack_layout({"p": torch.zeros(n, 1442)}, pad_to=chunk)
    mine = types.SimpleNamespace(
        topk=topk, scale_chunk=chunk, n_nodes=n, layout=layout, wire_layout=layout,
        node_program=resolve_node_program(spec).bind(n, device="cpu"),
        dense_equivalent=lambda: w)
    theirs = types.SimpleNamespace(
        topk=topk, scale_chunk=chunk, n_nodes=n, wire_layout=layout,
        node_program=JSlowUplink(frac=0.5, k_scale=0.375, seed=2).bind(n),
        dense_equivalent=lambda: w)
    key = mine.node_program.init_key()
    comm = {"topo_round": torch.tensor(4, dtype=torch.int32),
            "node_key": torch.as_tensor(key.astype(np.int64))}
    j_comm = {"topo_round": jnp.int32(4), "node_key": jnp.asarray(key)}
    kvec = ShardedFusedEngine._wire_k_vec(mine, comm)
    j_kvec = j_engine.ShardedFusedEngine._wire_k_vec(theirs, j_comm)
    assert kvec.dtype == torch.int32 and np.array_equal(_np(kvec), np.asarray(j_kvec))
    # at topk 4, 0.375 * 4 = 1.5 rounds to 2 (half to even); at topk 1
    # every k clips to 1
    assert len(set(_np(kvec).ravel().tolist())) == (1 if topk == 1 else 2)
    for wires in (1, 2):
        got = ShardedFusedEngine._wire_k_bytes(mine, kvec, wires)
        want = j_engine.ShardedFusedEngine._wire_k_bytes(theirs, j_kvec, wires)
        assert got.dtype == torch.float32 and float(got) == float(want)


def test_comm_state_has_the_references_keys(group):
    """Under a program (and with dp) ``comm_keys`` and every buffer's
    shape and dtype equal the reference's ``comm_state_specs`` /
    ``comm_state_sds`` (built on a one-device mesh with the reference's
    ``n_nodes`` = 8), the counters excepted: the port holds a uint32 key
    as the (2,) int64 words, and the topology state has the program's own
    spec. ``init_fl_state`` builds this rank's buffers with the counters
    whole."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    j_engine = _reference_engine()
    from repro.core import fl as j_fl

    mesh = jax.make_mesh((1,), ("data",))
    params = {"p": torch.zeros(N, 40)}
    counters = ("topo_round", "topo_key", "node_key", "priv_key", "topo_up")
    cases = [(None, "sequential", dict(topology_program="edge_failure:p=0.1")),
             (4, "pipelined", dict(topology_program="node_churn:p_down=0.2")),
             (1, "bounded_staleness:k=3", dict(node_program="stragglers:frac=0.25")),
             (4, "bounded_staleness:k=2", dict(node_program="slow_uplink")),
             (None, "pipelined", dict(privacy="dp:sigma=0.5,clip=1.0")),
             (4, "sequential", dict(node_program="payload_drop:p=0.1",
                                    privacy="dp:sigma=1.0,clip=2.0"))]
    for topk, sched, programs in cases:
        kw = dict(scale_chunk=CHUNK, topk=topk, round_schedule=sched, **programs)
        eng, rows = ShardedFusedEngine.from_group(group, params, w=_er(), **kw)
        ref = j_engine.ShardedFusedEngine.from_mesh(
            mesh, ("data",), {"p": jnp.zeros((1, 40))}, w=np.eye(1), impl="jnp", **kw)
        for alg in ("dsgd", "dsgt"):
            cfg = FLConfig(algorithm=alg, q=1, n_nodes=N)
            j_cfg = j_fl.FLConfig(algorithm=alg, q=1, n_nodes=N)
            sds, specs = ref.comm_state_sds(j_cfg), ref.comm_state_specs(j_cfg)
            spec = eng.comm_state_spec(cfg)
            assert list(spec) == list(sds) == list(specs) == list(eng.comm_keys(cfg)), kw
            state = init_fl_state(cfg, rows, eng)
            for key, (shape, dtype) in spec.items():
                buf = state.comm[key]
                assert tuple(buf.shape) == shape and buf.dtype == dtype, key
                if key in counters:
                    continue
                assert shape == sds[key].shape, (key, kw)
                assert str(dtype).removeprefix("torch.") == sds[key].dtype.name, key
            for key in ("topo_key", "node_key", "priv_key"):
                if key in spec:
                    assert spec[key] == ((2,), torch.int64)
            if "topo_up" in spec:
                assert spec["topo_up"][0] == (N,)


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
    n, q, chunk = 20, 3, 16
    rng = np.random.default_rng(7)
    params = {"w": torch.tensor(rng.normal(size=(n, 4, 5)), dtype=torch.float32),
              "b": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)}
    batches = {"t": torch.tensor(rng.normal(size=(q, n, 4, 5)), dtype=torch.float32)}

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    res = {}
    for alg, topk, sched, programs in (
            ("dsgt", None, "sequential",
             dict(topology_program="node_churn:p_down=0.3,mean_downtime=2,seed=1",
                  node_program="stragglers:frac=0.5,rate=0.5,drop=1")),
            ("dsgd", 4, "pipelined",
             dict(topology_program="node_churn:p_down=0.3,mean_downtime=2,seed=1")),
            ("dsgt", 8, "bounded_staleness:k=2",
             dict(node_program="slow_uplink:frac=0.5,k_scale=0.25,seed=3")),
            ("dsgt", None, "pipelined", dict(privacy="dp:sigma=0.5,clip=1.0"))):
        cfg = FLConfig(algorithm=alg, q=q, n_nodes=n)
        eng, rows = ShardedFusedEngine.from_group(
            g, params, w=mixing_matrix("hospital20", n), scale_chunk=chunk, topk=topk,
            round_schedule=sched, **programs)
        rf = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
        st = init_fl_state(cfg, rows, eng)
        for _ in range(4):
            st, m = rf(st, batches)
        full = torch.empty(n, rows.shape[1])
        dist.all_gather_into_tensor(full, st.params)
        key = f"{alg}-{topk}-{sched}-{sorted(programs.values())}"
        res[key + "/params"] = full.numpy()
        for k, v in m.items():
            res[f"{key}/{k}"] = np.float64(float(v))
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
    """20 nodes on 1, 2 and 4 gloo ranks, all started together, four
    configurations (node churn with stragglers on the dense wire; churn on
    the top-4 bitmap wire, pipelined; ``slow_uplink`` at top-8 under
    bounded staleness; dp, pipelined): after 4 rounds the gathered params
    and every metric equal world 1's within 1e-6."""
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
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-4000:]
    one = np.load(tmp_path / "world1.npz")
    assert any(k.endswith("/wire_bytes_effective") for k in one.files)
    assert any(k.endswith("/dp_epsilon") for k in one.files)
    for world in (2, 4):
        got = np.load(tmp_path / f"world{world}.npz")
        assert sorted(got.files) == sorted(one.files)
        for key in one.files:
            np.testing.assert_allclose(got[key], one[key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"world {world}: {key}")
