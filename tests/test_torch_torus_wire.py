"""The sharded engine's circulant torus wire (``ShardedFusedEngine`` with
``w=None``): one point-to-point exchange per torus direction and wire
buffer over the group's node axes, against the port's ``FusedEngine`` on
the torus's dense equivalent and the reference's ``FusedEngine(impl=
"jnp")`` on the reference's ``mesh_gossip_dense_equivalent``.

* World 1, in this process (a gloo group whose node axes are the (2, 4)
  torus: 3 directions, w_self 1/4), on the reference suite's quadratic
  problem (``tests/test_torch_sharded_engine.py``), chunk 16: DSGD and
  DSGT, k in {None, 4}, sequential, pipelined and ``bounded_staleness:
  k=2``, 4 rounds -- params and tracker within 1e-5 of both oracles,
  equal ``wire_bytes``.
* The round axes on the torus: ``node_churn`` and ``edge_failure``
  (per-direction ``nbr_recon_{d}``, no ``nbr_recon_all``), ``dp``,
  ``backbone`` and ``slow_uplink`` within 1e-5 of their oracles;
  ``secure_agg`` bitwise the plaintext run, with the payload handed to
  the transport masked; ``layerwise`` refused, as ``secure_agg`` is on
  the all-gather wire.
* ``restore_comm`` from a circulant, an all-gather-wire and a fused
  checkpoint.
* ``TreeEngine`` / ``FlatEngine.from_group``: the exact wire through the
  mesh backends, within 1e-6 of their ``simulated`` builds on the dense
  equivalent, with the reference's refusals.
* Worlds 2, 4 and 8 (8 = one node a rank) as gloo subprocesses, all
  cases in one spawn each: the gathered params and the metrics equal
  world 1's within 1e-6; each rank's messages and bytes equal a plan
  counted here in numpy from the torus edges whose endpoints lie on
  different ranks; at world 8 the ranks' bytes sum to ``wire_bytes``
  and a rank sends exactly one message per buffer and direction.

Why 1e-5 and not bitwise: the torus mix accumulates ``mix_recon + sum_d
weight_d dq_d`` round by round, the fused engine contracts ``W_off @
recon'`` -- the same sum in another order.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.engine import FusedEngine, ShardedFusedEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.mixing import mesh_gossip_dense_equivalent  # noqa: E402
from repro_torch.core.packing import flat_wire_bytes  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402
from repro_torch.training.checkpoint import load_fl_state, save_fl_state  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AXES = {"pod": 2, "data": 4}
N, Q, CHUNK = 8, 2, 16
SCHEDULES = ["sequential", "pipelined", "bounded_staleness:k=2"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group over the (2, 4) node torus."""
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu",
                    node_axes=AXES)
    yield g
    stop_group(g)


def _np(x):
    return x.detach().cpu().float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _quadratic(n, q, seed):
    """The reference suite's exact-gradient problem (see
    ``tests/test_torch_sharded_engine.py``)."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(n, 4, 5)).astype(np.float32),
              "b": rng.normal(size=(n, 3)).astype(np.float32)}
    batches = {"t": rng.normal(size=(q, n, 4, 5)).astype(np.float32)}

    def loss(p, batch):
        return ((p["w"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    return loss, params, batches


def _tensors(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()}


def _rounds(engine, state, algorithm, rounds=4, seed=0):
    loss, _, batches = _quadratic(N, Q, seed)
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    round_fn = make_fl_round(loss, inv_sqrt(0.05), cfg, engine)
    for _ in range(rounds):
        state, m = round_fn(state, batches)
    return state, m


def _run(engine, flat, algorithm, rounds=4):
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    return _rounds(engine, init_fl_state(cfg, flat, engine), algorithm, rounds)


def _pair(group, algorithm, rounds=4, fused_kw=None, **kw):
    """The same rounds on the torus wire and on ``FusedEngine`` over its
    dense equivalent (``fused_kw`` replaces the fused engine's knobs)."""
    _, params, _ = _quadratic(N, Q, 0)
    sh, rows = ShardedFusedEngine.from_group(group, _tensors(params), scale_chunk=CHUNK,
                                             **kw)
    fkw = dict(kw) if fused_kw is None else fused_kw
    fe, flat = FusedEngine.from_node_axes(AXES, _tensors(params), scale_chunk=CHUNK, **fkw)
    assert np.array_equal(fe.dense_equivalent(), sh.dense_equivalent())
    s_sh, m_sh = _run(sh, rows, algorithm, rounds)
    s_fe, m_fe = _run(fe, flat, algorithm, rounds)
    return sh, s_sh, m_sh, s_fe, m_fe


def _close(s_sh, s_fe, algorithm, atol=1e-5):
    np.testing.assert_allclose(_np(s_sh.params), _np(s_fe.params), rtol=0, atol=atol)
    if algorithm == "dsgt":
        np.testing.assert_allclose(_np(s_sh.tracker), _np(s_fe.tracker), rtol=0, atol=atol)


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("topk", [None, 4])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_circulant_wire_matches_both_fused_oracles(group, algorithm, topk, schedule):
    """World 1: within 1e-5 of the port's ``FusedEngine`` and of the
    reference's ``FusedEngine(impl="jnp")`` on the reference's dense
    equivalent after 4 rounds, the same wire bytes; every exchange is a
    local copy at world 1, so nothing is sent."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.core import engine as j_engine
    from repro.core import fl as j_fl
    from repro.core import schedules as j_schedules
    from repro.core.mixing import mesh_gossip_dense_equivalent as j_dense
    from repro.core.packing import pack as j_pack

    sh, s_sh, m_sh, s_fe, m_fe = _pair(group, algorithm, topk=topk, round_schedule=schedule)
    _close(s_sh, s_fe, algorithm)
    assert m_sh["wire_bytes"] == m_fe["wire_bytes"]
    assert sh.torus is not None and len(sh.dirs) == 3 and sh.torus.w_self == 0.25
    assert sh.collectives == 0 and sh.collective_bytes == 0

    _, params, batches = _quadratic(N, Q, 0)

    def j_loss(p, batch):
        return jnp.sum((p["w"] - batch["t"]) ** 2) + jnp.sum(p["b"] ** 2)

    w = j_dense(AXES)
    assert np.array_equal(w, sh.dense_equivalent())
    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    j_flat, j_layout = j_pack(params, pad_to=CHUNK)
    fe = j_engine.FusedEngine(w, j_layout, scale_chunk=CHUNK, topk=topk, impl="jnp",
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


@pytest.mark.parametrize("program", ["node_churn:p_down=0.3,mean_downtime=2",
                                     "edge_failure:p=0.3"])
@pytest.mark.parametrize("schedule", ["sequential", "pipelined"])
def test_dynamic_round_on_the_torus(group, program, schedule):
    """Under a topology program the torus round keeps one unweighted
    accumulator per direction (``nbr_recon_{d}[_t]``, (R, t) a rank) and
    weights it by the round's ``W_r[i, src_d(i)]``: within 1e-5 of the
    fused engine under the same program, the same realized edge
    fraction, and no transfer beyond the static round's."""
    sh, s_sh, m_sh, s_fe, m_fe = _pair(group, "dsgt", topk=4, round_schedule=schedule,
                                       topology_program=program)
    _close(s_sh, s_fe, "dsgt")
    nbr = sorted(k for k in s_sh.comm if k.startswith("nbr_recon"))
    assert nbr == sorted(f"nbr_recon_{d}{t}" for d in range(3) for t in ("", "_t"))
    assert "mix_recon" not in s_sh.comm
    for k in nbr:
        assert tuple(s_sh.comm[k].shape) == (N, sh.layout.total)
    assert float(m_sh["edge_fraction"]) == float(m_fe["edge_fraction"])
    assert m_sh["wire_bytes"] == m_fe["wire_bytes"]


@pytest.mark.parametrize("schedule", ["sequential", "pipelined"])
def test_secure_agg_pads_cancel_and_mask_the_payload(group, monkeypatch, schedule):
    """``secure_agg``: every payload is masked with its edge's pad before
    the transport and unmasked after it (at world 1 each exchange is a
    local copy, masked all the same), so the params equal the plaintext
    run's bitwise while what the transport is handed differs from the
    plaintext payload."""
    from repro_torch.core import mixing

    seen = []
    real = mixing.TorusPlan.exchange

    def spy(self, bufs, d):
        seen.append([b.clone() for b in bufs])
        return real(self, bufs, d)

    _, params, _ = _quadratic(N, Q, 0)
    runs = {}
    for privacy in (None, "secure_agg"):
        monkeypatch.setattr(mixing.TorusPlan, "exchange", spy)
        seen.clear()
        eng, rows = ShardedFusedEngine.from_group(group, _tensors(params), scale_chunk=CHUNK,
                                                  topk=4, round_schedule=schedule,
                                                  privacy=privacy)
        state, m = _run(eng, rows, "dsgt", rounds=3)
        runs[privacy] = (state, [list(x) for x in seen], eng)
    plain, masked = runs[None], runs["secure_agg"]
    assert torch.equal(plain[0].params, masked[0].params)
    assert torch.equal(plain[0].tracker, masked[0].tracker)
    assert len(plain[1]) == len(masked[1]) > 0
    differs = [not torch.equal(a[0], b[0]) for a, b in zip(plain[1], masked[1])
               if a[0].any()]
    assert differs and all(differs)
    assert {"priv_key", "topo_round"} <= set(masked[0].comm)
    assert masked[2]._sa_wire and masked[2].wire_bytes(
        FLConfig(algorithm="dsgt", q=Q, n_nodes=N)) == plain[2].wire_bytes(
        FLConfig(algorithm="dsgt", q=Q, n_nodes=N))


def test_dp_backbone_and_slow_uplink_on_the_torus(group):
    """``dp`` within 1e-5 of the fused engine's dp round (each rank draws
    its rows of the same noise), the ``backbone`` scope within 1e-5 of
    the scoped fused engine (the private columns bitwise the plain local
    trajectory's arithmetic), ``slow_uplink``'s per-node k within 1e-5 of
    the all-gather wire on the same W (the fused engine has no per-node
    k)."""
    sh, s_sh, m_sh, s_fe, m_fe = _pair(group, "dsgt", privacy="dp:sigma=0.5,clip=1.0")
    _close(s_sh, s_fe, "dsgt")
    assert float(m_sh["dp_epsilon"]) == float(m_fe["dp_epsilon"])
    sh, s_sh, m_sh, s_fe, m_fe = _pair(group, "dsgd", scope="ranges:0-16",
                                       round_schedule="pipelined")
    _close(s_sh, s_fe, "dsgd")
    assert sh.wire_layout.total == 16 and m_sh["wire_bytes"] == m_fe["wire_bytes"]
    _, params, _ = _quadratic(N, Q, 0)
    prog = "slow_uplink:frac=0.5,k_scale=0.5"
    runs = []
    for w in (None, mesh_gossip_dense_equivalent(AXES)):
        eng, rows = ShardedFusedEngine.from_group(group, _tensors(params), scale_chunk=CHUNK,
                                                  topk=4, w=w, node_program=prog)
        runs.append(_run(eng, rows, "dsgt"))
    (s_t, m_t), (s_a, m_a) = runs
    _close(s_t, s_a, "dsgt")
    assert float(m_t["wire_bytes_effective"]) == float(m_a["wire_bytes_effective"])
    assert float(m_t["wire_bytes_effective"]) < m_t["wire_bytes"]


def test_refusals_on_the_torus(group):
    """``layerwise`` stays refused on the torus (the reference's message),
    ``secure_agg`` on the all-gather wire, an unknown ``axes_subset`` and
    a node-axis ``model_axis``."""
    params = {"p": torch.zeros(N, 30), "q": torch.zeros(N, 10)}
    with pytest.raises(ValueError, match="the layerwise round-gated mix"):
        ShardedFusedEngine.from_group(group, params, scale_chunk=CHUNK,
                                      scope="layerwise:freq=4,head=q")
    with pytest.raises(ValueError, match="secure_agg needs the circulant"):
        ShardedFusedEngine.from_group(group, params, scale_chunk=CHUNK,
                                      w=mesh_gossip_dense_equivalent(AXES),
                                      privacy="secure_agg")
    with pytest.raises(ValueError, match="not within node_axes"):
        ShardedFusedEngine.from_group(group, params, scale_chunk=CHUNK, axes_subset=("x",))
    with pytest.raises(ValueError, match="also a gossip node"):
        ShardedFusedEngine.from_group(group, params, scale_chunk=CHUNK, model_axis="data")
    eng, _ = ShardedFusedEngine.from_group(group, params, scale_chunk=CHUNK,
                                           axes_subset=("data",), self_weight=0.5)
    np.testing.assert_array_equal(eng.dense_equivalent(), mesh_gossip_dense_equivalent(
        AXES, 0.5, ("data",)))
    assert len(eng.dirs) == 2


@pytest.mark.parametrize("source", ["torus", "allgather", "fused"])
def test_restore_comm_rebuilds_the_torus_accumulators(group, tmp_path, source):
    """Two rounds on ``source`` (the circulant wire, the all-gather wire on
    the same W, or the fused engine), saved, restored onto the circulant
    pipelined engine and run two more rounds: within 1e-5 of four
    uninterrupted circulant rounds (the restore rebuilds ``mix_recon``
    from recon less the in-flight payload; the all-gather and fused
    checkpoints carry the same recon)."""
    _, params, _ = _quadratic(N, Q, 0)
    cfg = FLConfig(algorithm="dsgt", q=Q, n_nodes=N)
    kw = dict(scale_chunk=CHUNK, topk=4, round_schedule="pipelined")
    eng, rows = ShardedFusedEngine.from_group(group, _tensors(params), **kw)
    whole, _ = _run(eng, rows, "dsgt", rounds=4)
    if source == "fused":
        src, flat = FusedEngine.from_node_axes(AXES, _tensors(params), **kw)
    else:
        w = mesh_gossip_dense_equivalent(AXES) if source == "allgather" else None
        src, flat = ShardedFusedEngine.from_group(group, _tensors(params), w=w, **kw)
    half, _ = _run(src, flat, "dsgt", rounds=2)
    save_fl_state(str(tmp_path / "ck"), half, engine=src)
    fresh, rows = ShardedFusedEngine.from_group(group, _tensors(params), **kw)
    restored = load_fl_state(str(tmp_path / "ck"), init_fl_state(cfg, rows, fresh),
                             engine=fresh)
    assert restored.step == half.step
    done, _ = _rounds(fresh, restored, "dsgt", rounds=2)
    _close(done, whole, "dsgt")


def _plan_counts(world, topk, algorithm, rounds, schedule):
    """Each rank's messages and bytes over ``rounds`` rounds, counted in
    numpy from the torus edges whose endpoints lie on different ranks:
    per direction, one message per (buffer, peer rank) pair of the
    rank's sends, and the payload bytes of every row it sends."""
    dirs = [("pod", 1), ("data", 1), ("data", -1)]
    idx = np.arange(N).reshape(2, 4)
    per = N // world
    bufs = 2 if topk is None else 3
    wires = 2 if algorithm == "dsgt" else 1
    row_bytes = flat_wire_bytes(_layout(), 1, CHUNK, topk)
    # every schedule moves one payload a round (the pipelined round's
    # first ingest moves the zero in-flight one)
    moves = rounds
    out = []
    for r in range(world):
        msgs = nbytes = 0
        for axis, shift in dirs:
            dst = np.roll(idx, -shift, axis=("pod", "data").index(axis)).reshape(-1)
            mine = range(r * per, (r + 1) * per)
            peers = {int(dst[j]) // per for j in mine if int(dst[j]) // per != r}
            sent = sum(1 for j in mine if int(dst[j]) // per != r)
            msgs += len(peers) * bufs
            nbytes += sent * row_bytes
        out.append((msgs * wires * moves, nbytes * wires * moves))
    return out


def _layout():
    from repro_torch.core.packing import pack_layout

    return pack_layout({"w": torch.zeros(N, 4, 5), "b": torch.zeros(N, 3)}, pad_to=CHUNK)


CASES = [("dsgt", 4, "sequential", None), ("dsgd", None, "pipelined", "secure_agg"),
         ("dsgt", None, "bounded_staleness:k=2", "node_churn:p_down=0.3,mean_downtime=2"),
         ("dsgt", 4, "pipelined", "backbone")]

_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core.engine import ShardedFusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.schedules import inv_sqrt
    from repro_torch.launch.mesh import start_group, stop_group
    import torch.distributed as dist

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    g = start_group(rank, world, store, device="cpu", node_axes={"pod": 2, "data": 4})
    n, q, chunk = 8, 2, 16
    rng = np.random.default_rng(0)
    params = {"w": torch.tensor(rng.normal(size=(n, 4, 5)), dtype=torch.float32),
              "b": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32)}
    batches = {"t": torch.tensor(rng.normal(size=(q, n, 4, 5)), dtype=torch.float32)}

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    res = {}
    for alg, topk, sched, extra in CASES:
        kw = dict(scale_chunk=chunk, topk=topk, round_schedule=sched)
        if extra == "secure_agg":
            kw["privacy"] = extra
        elif extra == "backbone":
            kw["scope"] = "ranges:0-16"
        elif extra:
            kw["topology_program"] = extra
        cfg = FLConfig(algorithm=alg, q=q, n_nodes=n)
        eng, rows = ShardedFusedEngine.from_group(g, params, **kw)
        rf = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
        st = init_fl_state(cfg, rows, eng)
        for _ in range(3):
            st, m = rf(st, batches)
        key = f"{alg}-{topk}-{sched}-{extra}"
        full = eng.gather_rows(st.params)
        counts = torch.tensor([eng.collectives, eng.collective_bytes], dtype=torch.int64)
        every = torch.empty(world * 2, dtype=torch.int64)
        dist.all_gather_into_tensor(every, counts)
        res[key + "/params"] = full.numpy()
        res[key + "/counts"] = every.numpy()
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
).replace("CASES", repr(CASES))


def test_worlds_2_4_and_8_equal_world_1(tmp_path):
    """The (2, 4) torus on 1, 2, 4 and 8 gloo ranks (8, 4, 2 and 1 node
    rows a rank), all started together, four cases each (DSGT top-4,
    DSGD dense pipelined under secure_agg, DSGT dense k=2 under churn,
    DSGT top-4 pipelined under a sub-range scope), 3 rounds: the gathered
    params and every metric equal world 1's within 1e-6; each rank's
    messages and bytes equal the numpy plan; at world 8 (one node a rank)
    every rank sends one message per buffer and direction and the ranks'
    bytes sum to ``wire_bytes`` each round."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for world in (1, 2, 4, 8):
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
    for world in (2, 4, 8):
        got = np.load(tmp_path / f"world{world}.npz")
        assert sorted(got.files) == sorted(one.files)
        for key in one.files:
            if key.endswith("/counts"):
                continue
            np.testing.assert_allclose(got[key], one[key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"world {world}: {key}")
        for alg, topk, sched, extra in CASES:
            key = f"{alg}-{topk}-{sched}-{extra}"
            counts = got[key + "/counts"].reshape(world, 2)
            if extra == "backbone":
                continue  # a scoped wire: counted below at its own width
            want = _plan_counts(world, topk, alg, 3, sched)
            assert [tuple(map(int, c)) for c in counts] == want, (world, key)
            if world == 8:
                wires = 2 if alg == "dsgt" else 1
                bufs = 2 if topk is None else 3
                assert all(int(c[0]) == 3 * wires * 3 * bufs for c in counts)
                assert int(counts[:, 1].sum()) == 3 * float(got[key + "/wire_bytes"])
        scoped = got["dsgt-4-pipelined-backbone/counts"].reshape(world, 2)
        if world == 8:
            assert int(scoped[:, 1].sum()) == 3 * float(got["dsgt-4-pipelined-backbone/wire_bytes"])


@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_exact_wire_engines_on_the_torus(group, engine):
    """``TreeEngine.from_group`` / ``FlatEngine.from_group`` (the
    reference's ``from_mesh``): the exact wire through the mesh backends
    over the group's node torus, 4 DSGT rounds within 1e-6 of the same
    engine's ``simulated`` build on the dense equivalent, the same
    metrics; the reference's refusals (top-k, a split schedule, a scope,
    privacy, a dynamic program)."""
    from repro_torch.core.engine import get_engine

    loss, params, batches = _quadratic(N, Q, 0)
    cls = get_engine(engine)
    cfg = FLConfig(algorithm="dsgt", q=Q, n_nodes=N)
    states = []
    for build in (lambda: cls.from_group(group, _tensors(params)),
                  lambda: cls.simulated(mesh_gossip_dense_equivalent(AXES), _tensors(params))):
        eng, state0 = build()
        round_fn = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
        state = init_fl_state(cfg, state0, eng)
        for _ in range(4):
            state, m = round_fn(state, batches)
        states.append((eng.params_view(state.params), m))
    (got, m_got), (want, m_want) = states
    for k in want:
        np.testing.assert_allclose(_np(got[k]), _np(want[k]), rtol=0, atol=1e-6, err_msg=k)
    for k in ("loss", "grad_norm_sq", "consensus_err"):
        np.testing.assert_allclose(float(m_got[k]), float(m_want[k]), rtol=1e-5, err_msg=k)
    for bad, match in ((dict(topk=4), "topk"), (dict(round_schedule="pipelined"), "sequential"),
                       (dict(scope="ranges:0-16"), "federation scope"),
                       (dict(privacy="dp:sigma=0.5,clip=1.0"), "privacy spec"),
                       (dict(topology_program="edge_failure:p=0.3"), "per-round mixing weights")):
        with pytest.raises(ValueError, match=match):
            cls.from_group(group, _tensors(params), **bad)
