"""The reference's ``error_feedback`` and ``difference_coding`` knobs on the
port's ``fused`` and ``sharded_fused`` engines, the ``cosine`` and
``warmup_linear`` schedules, and ``stack_for_nodes(perturb=)``.

* ``FusedEngine`` with each knob off against the reference's
  ``FusedEngine(impl="jnp")`` on a quadratic problem (8 nodes on an
  Erdos-Renyi graph, chunk 16, Q = 2): sequential, pipelined and bounded
  staleness at k = 2 and 3, under a topology program and under the
  backbone scope. Without difference coding the depth-k ring holds k
  payloads, not k - 1, so the comm state's keys and shapes are the
  reference's.
* The refusals: ``dp`` and a per-node wire k without error feedback.
* ``sharded_fused`` on a one-rank gloo group with both wires (the dense
  all-gather and the circulant torus) against the port's ``fused`` on its
  dense equivalent; worlds 2 and 4 in subprocesses; checkpoint round trips
  of each layout.

Tolerances: three rounds of the quadratic problem agree within 1e-5 (the
same fp32 arithmetic; the mixes sum in other orders), and the ring's int8
payloads exactly.
"""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core import schedules as j_schedules  # noqa: E402
from repro.training.trainer import stack_for_nodes as j_stack_for_nodes  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import schedules  # noqa: E402
from repro_torch.core.engine import FusedEngine, ShardedFusedEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.packing import pack  # noqa: E402
from repro_torch.core.schedules import constant  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402
from repro_torch.training.checkpoint import load_fl_state, save_fl_state  # noqa: E402
from repro_torch.training.trainer import stack_for_nodes  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CHUNK, Q, ROUNDS = 8, 16, 2, 3
# (error_feedback, difference_coding) with a knob off
KNOBS = [(False, True), (True, False), (False, False)]
SCHEDULES = ["sequential", "pipelined", "bounded_staleness:k=2", "bounded_staleness:k=3"]
CHURN = "node_churn:p_down=0.3,mean_downtime=2,seed=1"
BACKBONE = "backbone:private=head"


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arrays(seed=0):
    """Distinct per-node params: head (N, 3) at columns [0, 3), trunk
    (N, 6, 5) at [3, 33); chunk 16 pads to 48."""
    rng = np.random.default_rng(seed)
    return {"head": rng.normal(size=(N, 3)).astype(np.float32),
            "trunk": rng.normal(size=(N, 6, 5)).astype(np.float32)}


def _params(seed=0):
    return {k: torch.tensor(v) for k, v in _arrays(seed).items()}


def _loss(p, batch):
    return ((p["trunk"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["head"] ** 2).sum(dim=1)


def _j_loss(p, batch):
    return jnp.sum((p["trunk"] - batch["t"]) ** 2) + jnp.sum(p["head"] ** 2)


def _batches(seed=1):
    return {"t": np.random.default_rng(seed).normal(size=(Q, N, 6, 5)).astype(np.float32)}


def _w():
    return mixing_matrix("erdos_renyi", N, p=0.5, seed=2)


def _knob_id(k):
    return f"ef{int(k[0])}-dc{int(k[1])}"


# ---------------------------------------------------------------------------
# fused against the reference
# ---------------------------------------------------------------------------


def _run_pair(algorithm, ef, dc, **kw):
    """Three rounds of the same run in both packages; returns (port
    engine, port state, reference engine, reference state, cfg)."""
    w = _w()
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    kw = dict(scale_chunk=CHUNK, error_feedback=ef, difference_coding=dc, **kw)
    j_eng, j_flat = j_engine.FusedEngine.simulated(
        w, {k: jnp.asarray(v) for k, v in _arrays().items()}, impl="jnp", **kw)
    j_round = jax.jit(j_fl.make_fl_round(_j_loss, None, j_schedules.constant(0.05), j_cfg,
                                         engine=j_eng))
    j_state = j_fl.init_fl_state(j_cfg, j_flat, engine=j_eng)
    eng, flat = FusedEngine.simulated(w, _params(), **kw)
    rf = make_fl_round(_loss, constant(0.05), cfg, eng)
    state = init_fl_state(cfg, flat, eng)
    batches = _batches()
    for _ in range(ROUNDS):
        state, m = rf(state, batches)
        j_state, jm = j_round(j_state, batches)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(m["ef_residual_rms"]), float(jm["ef_residual_rms"]),
                                   rtol=1e-5, atol=1e-7)
    return eng, state, j_eng, j_state, cfg


def _assert_states_match(eng, state, j_eng, j_state, cfg):
    np.testing.assert_allclose(_np(state.params), _np(j_state.params), rtol=0, atol=1e-5)
    if cfg.algorithm == "dsgt":
        np.testing.assert_allclose(_np(state.tracker), _np(j_state.tracker), rtol=0,
                                   atol=1e-5)
    assert list(eng.comm_keys(cfg)) == list(j_eng.comm_keys(cfg))
    assert set(state.comm) == set(j_state.comm)
    for key in state.comm:
        a, b = _np(state.comm[key]), _np(j_state.comm[key])
        assert a.shape == b.shape, key
        if a.dtype == np.int8:  # the ring's payloads: one int8 step may move
            assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 1, key
        elif key.startswith(("recon", "residual", "wire_scales")):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-5, err_msg=key)
        else:
            np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64), err_msg=key)


@pytest.mark.parametrize("knobs", KNOBS, ids=_knob_id)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_fused_knobs_match_reference(algorithm, schedule, knobs):
    ef, dc = knobs
    eng, state, j_eng, j_state, cfg = _run_pair(algorithm, ef, dc, round_schedule=schedule)
    _assert_states_match(eng, state, j_eng, j_state, cfg)
    k = eng.staleness_depth
    assert eng._ring_depth() == (0 if k <= 1 else (k - 1 if dc else k))
    if not ef:  # without error feedback the residual never moves
        assert not state.comm["residual"].any()


@pytest.mark.parametrize("knobs", KNOBS, ids=_knob_id)
@pytest.mark.parametrize("case", [
    dict(round_schedule="sequential", topology_program=CHURN),
    dict(round_schedule="bounded_staleness:k=2", topology_program=CHURN),
    dict(round_schedule="sequential", scope=BACKBONE),
    dict(round_schedule="bounded_staleness:k=2", scope=BACKBONE),
], ids=["churn", "churn-k2", "backbone", "backbone-k2"])
def test_fused_knobs_under_a_program_and_a_scope_match_reference(case, knobs):
    ef, dc = knobs
    eng, state, j_eng, j_state, cfg = _run_pair("dsgt", ef, dc, **case)
    _assert_states_match(eng, state, j_eng, j_state, cfg)


def _message(fn) -> str:
    with pytest.raises(ValueError) as info:
        fn()
    return str(info.value)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu")
    yield g
    stop_group(g)


def test_refusals_without_error_feedback(group):
    """``dp`` needs error feedback on both engines (the reference's
    message); so does a per-node wire k on the sharded one; a program
    that changes wire k stays refused on ``fused``."""
    dp = "dp:sigma=0.5,clip=1.0"
    want = _message(lambda: j_engine.FusedEngine.simulated(
        _w(), {k: jnp.asarray(v) for k, v in _arrays().items()}, impl="jnp",
        scale_chunk=CHUNK, privacy=dp, error_feedback=False))
    assert "error_feedback=True" in want
    assert _message(lambda: FusedEngine.simulated(
        _w(), _params(), scale_chunk=CHUNK, privacy=dp, error_feedback=False)) == want
    for w in (_w(), None):
        assert _message(lambda: ShardedFusedEngine.from_group(
            group, _params(), w=w, scale_chunk=CHUNK, privacy=dp,
            error_feedback=False)) == want
        msg = _message(lambda: ShardedFusedEngine.from_group(
            group, _params(), w=w, scale_chunk=CHUNK, topk=4, error_feedback=False,
            node_program="slow_uplink:frac=0.5,k_scale=0.25"))
        assert msg.startswith("per-node wire k rides the EF residual")
    # with error feedback both build; difference coding alone is free
    FusedEngine.simulated(_w(), _params(), scale_chunk=CHUNK, privacy=dp,
                          difference_coding=False)
    ShardedFusedEngine.from_group(group, _params(), w=None, scale_chunk=CHUNK, topk=4,
                                  difference_coding=False,
                                  node_program="slow_uplink:frac=0.5,k_scale=0.25")


# ---------------------------------------------------------------------------
# sharded_fused against fused
# ---------------------------------------------------------------------------


def _rounds(eng, start, algorithm, rounds=ROUNDS):
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    rf = make_fl_round(_loss, constant(0.05), cfg, eng)
    st = init_fl_state(cfg, start, eng)
    batches = _batches()
    for _ in range(rounds):
        st, m = rf(st, batches)
    return st, m, cfg


SHARDED_CASES = [
    ("dsgt", "sequential", None), ("dsgd", "pipelined", None),
    ("dsgt", "bounded_staleness:k=2", None), ("dsgt", "sequential", CHURN),
    ("dsgd", "bounded_staleness:k=2", CHURN),
]


@pytest.mark.parametrize("knobs", KNOBS, ids=_knob_id)
@pytest.mark.parametrize("wire", ["all_gather", "torus"])
@pytest.mark.parametrize("case", SHARDED_CASES, ids=lambda c: "-".join(
    x.split(":")[0] for x in c if x))
def test_sharded_knobs_match_fused(group, case, wire, knobs):
    """World 1, both wires: three rounds within 1e-5 of the port's fused
    engine on the dense equivalent; without difference coding the
    dynamic round carries no ``nbr_recon_*`` accumulators and the static
    one's ``mix_recon`` is the last round's neighbour term."""
    algorithm, schedule, program = case
    ef, dc = knobs
    kw = dict(scale_chunk=CHUNK, round_schedule=schedule, error_feedback=ef,
              difference_coding=dc, topology_program=program)
    sh, rows = ShardedFusedEngine.from_group(group, _params(), w=_w() if wire == "all_gather"
                                             else None, **kw)
    fe, flat = FusedEngine.simulated(sh.dense_equivalent(), _params(), **kw)
    s_sh, m_sh, cfg = _rounds(sh, rows, algorithm)
    s_fe, m_fe, _ = _rounds(fe, flat, algorithm)
    np.testing.assert_allclose(_np(s_sh.params), _np(s_fe.params), rtol=0, atol=1e-5)
    if algorithm == "dsgt":
        np.testing.assert_allclose(_np(s_sh.tracker), _np(s_fe.tracker), rtol=0, atol=1e-5)
    for key in ("recon", "residual"):
        np.testing.assert_allclose(_np(s_sh.comm[key]), _np(s_fe.comm[key]), rtol=0,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(float(m_sh["loss"]), float(m_fe["loss"]), rtol=1e-5)
    nbr = [k for k in s_sh.comm if k.startswith("nbr_recon")]
    assert bool(nbr) == (program is not None and dc)
    assert set(s_sh.comm) == set(sh.comm_keys(cfg))


_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core.engine import ShardedFusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.schedules import constant
    from repro_torch.core.topology import mixing_matrix
    from repro_torch.launch.mesh import start_group, stop_group

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    g = start_group(rank, world, store, device="cpu")
    n, q, chunk = 8, 2, 16
    rng = np.random.default_rng(0)
    params = {"head": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32),
              "trunk": torch.tensor(rng.normal(size=(n, 6, 5)), dtype=torch.float32)}
    batches = {"t": torch.tensor(np.random.default_rng(1).normal(size=(q, n, 6, 5)),
                                 dtype=torch.float32)}

    def loss(p, b):
        return ((p["trunk"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["head"] ** 2).sum(dim=1)

    res = {}
    w = mixing_matrix("erdos_renyi", n, p=0.5, seed=2)
    for wire in ("all_gather", "torus"):
        for alg, sched, prog, ef, dc in (
                ("dsgt", "sequential", None, False, True),
                ("dsgd", "pipelined", None, True, False),
                ("dsgt", "bounded_staleness:k=2", None, False, False),
                ("dsgt", "pipelined", "node_churn:p_down=0.3,mean_downtime=2,seed=1",
                 True, False)):
            cfg = FLConfig(algorithm=alg, q=q, n_nodes=n)
            eng, rows = ShardedFusedEngine.from_group(
                g, params, w=w if wire == "all_gather" else None, scale_chunk=chunk,
                round_schedule=sched, topology_program=prog, error_feedback=ef,
                difference_coding=dc)
            rf = make_fl_round(loss, constant(0.05), cfg, eng)
            st = init_fl_state(cfg, rows, eng)
            for _ in range(3):
                st, m = rf(st, batches)
            key = f"{wire}|{alg}|{sched}|{prog}|{int(ef)}|{int(dc)}"
            res[key + "/params"] = eng.gather_rows(st.params).numpy()
            if st.tracker is not None:
                res[key + "/tracker"] = eng.gather_rows(st.tracker).numpy()
            res[key + "/loss"] = np.float64(float(m["loss"]))
    if rank == 0:
        np.savez(out, **res)
    stop_group(g)
    sys.stdout.flush()
    # leave without interpreter teardown: gloo's threads have been seen
    # to abort a process at exit after the group was destroyed
    os._exit(0)
    """
)


def _fused_twin(key):
    """The port's fused engine on the worker's configuration (its W the
    wire's dense equivalent)."""
    from repro_torch.core.mixing import mesh_gossip_dense_equivalent

    wire, alg, sched, prog, ef, dc = key.split("|")
    rng = np.random.default_rng(0)
    params = {"head": torch.tensor(rng.normal(size=(N, 3)), dtype=torch.float32),
              "trunk": torch.tensor(rng.normal(size=(N, 6, 5)), dtype=torch.float32)}
    w = _w() if wire == "all_gather" else mesh_gossip_dense_equivalent({"nodes": N})
    fe, flat = FusedEngine.simulated(
        w, params, scale_chunk=CHUNK, round_schedule=sched,
        topology_program=None if prog == "None" else prog, error_feedback=ef == "1",
        difference_coding=dc == "1")
    st, _, _ = _rounds(fe, flat, alg)
    return st


def test_sharded_knobs_on_two_and_four_gloo_ranks(tmp_path):
    """8 nodes on 1, 2 and 4 gloo ranks, started together, both wires,
    each knob off on a static and a dynamic round: worlds 2 and 4's
    gathered params and tracker equal world 1's within 1e-6 and the port's
    fused engine's within 1e-5."""
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
        out, _ = p.communicate(timeout=300)
        assert p.returncode == 0, out[-4000:]
    one = np.load(tmp_path / "world1.npz")
    for world in (2, 4):
        got = np.load(tmp_path / f"world{world}.npz")
        assert sorted(got.files) == sorted(one.files)
        for key in one.files:
            np.testing.assert_allclose(got[key], one[key], rtol=1e-6, atol=1e-6,
                                       err_msg=f"world {world} {key}")
    for key in {k.rsplit("/", 1)[0] for k in one.files}:
        st = _fused_twin(key)
        np.testing.assert_allclose(one[key + "/params"], _np(st.params), rtol=0, atol=1e-5,
                                   err_msg=key)
        if st.tracker is not None:
            np.testing.assert_allclose(one[key + "/tracker"], _np(st.tracker), rtol=0,
                                       atol=1e-5, err_msg=key)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", [
    ("fused", None, "bounded_staleness:k=2", None),
    ("sharded", "all_gather", "pipelined", CHURN),
    ("sharded", "torus", "bounded_staleness:k=2", None),
    ("sharded", "torus", "sequential", CHURN),
])
@pytest.mark.parametrize("knobs", KNOBS, ids=_knob_id)
def test_checkpoint_round_trip_with_the_knobs(tmp_path, group, layout, knobs):
    """Two rounds, a save, a restore onto a fresh template, one more round,
    on each layout: the saved comm keys are the engine's (no
    ``nbr_recon_*`` without difference coding; a ring of k without it),
    the independent buffers come back bitwise and the derived
    accumulators (``restore_comm`` rebuilds them from recon) within 1e-5
    where they are read (with difference coding); the next round is
    within 1e-5 of the run that never stopped, and bitwise without
    difference coding (no accumulator is read)."""
    kind, wire, schedule, program = layout
    ef, dc = knobs
    kw = dict(scale_chunk=CHUNK, round_schedule=schedule, error_feedback=ef,
              difference_coding=dc, topology_program=program)

    def build():
        if kind == "fused":
            return FusedEngine.simulated(_w(), _params(), **kw)
        return ShardedFusedEngine.from_group(
            group, _params(), w=_w() if wire == "all_gather" else None, **kw)

    eng, start = build()
    cfg = FLConfig(algorithm="dsgt", q=Q, n_nodes=N)
    rf = make_fl_round(_loss, constant(0.05), cfg, eng)
    st = init_fl_state(cfg, start, eng)
    batches = _batches()
    for _ in range(2):
        st, _ = rf(st, batches)
    save_fl_state(str(tmp_path), st, engine=eng)
    eng2, start2 = build()
    back = load_fl_state(str(tmp_path), init_fl_state(cfg, start2, eng2), engine=eng2)
    assert set(back.comm) == set(st.comm) == set(eng.comm_keys(cfg))
    for key in st.comm:
        if not eng.is_derived_comm_key(key):
            assert torch.equal(back.comm[key], st.comm[key]), key
        elif dc:
            np.testing.assert_allclose(_np(back.comm[key]), _np(st.comm[key]), rtol=0,
                                       atol=1e-5, err_msg=key)
    st3, _ = rf(st, batches)
    back3, _ = make_fl_round(_loss, constant(0.05), cfg, eng2)(back, batches)
    for a, b in ((back3.params, st3.params), (back3.tracker, st3.tracker)):
        if dc:
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=1e-5)
        else:
            assert torch.equal(a, b)
    if "wire_q" in st.comm and kind == "fused":
        depth = eng.staleness_depth
        assert st.comm["wire_q"].shape[1] == (depth - 1 if dc else depth)


# ---------------------------------------------------------------------------
# item 2's schedules and the perturbed init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("args", [(0.02, 100, 10), (0.1, 0, 50), (0.3, 50, 50),
                                  (1.0, 3, 1000)])
def test_warmup_linear_is_the_references(args):
    """Bitwise the reference's fp32 expression, over and past the horizon."""
    mine, theirs = schedules.warmup_linear(*args), j_schedules.warmup_linear(*args)
    for r in range(0, 1100, 3):
        got = mine(r)
        assert isinstance(got, np.float32)
        assert got == np.float32(theirs(jnp.asarray(r, jnp.int32))), r


@pytest.mark.parametrize("args", [(0.02, 100, 0.0), (0.1, 1000, 1e-3), (0.5, 7, 0.05)])
def test_cosine_is_the_references(args):
    """The reference's fp32 expression: within 1e-6 of alpha0 (its cosine
    is XLA's, the port's numpy's: they differ in the last bits), alpha0
    at r = 0, alpha_min from the horizon on, never rising."""
    alpha0, total, alpha_min = args
    mine, theirs = schedules.cosine(*args), j_schedules.cosine(*args)
    vals = [mine(r) for r in range(0, total + 20)]
    for r, got in enumerate(vals):
        assert isinstance(got, np.float32)
        want = np.float32(theirs(jnp.asarray(r, jnp.int32)))
        assert abs(float(got) - float(want)) <= 1e-6 * alpha0, r
    assert vals[0] == np.float32(alpha0)
    assert all(v == np.float32(alpha_min) or abs(v - alpha_min) < 1e-6 * alpha0
               for v in vals[total:])
    assert all(a >= b for a, b in zip(vals, vals[1:]))
    assert {"cosine", "warmup_linear"} <= set(schedules.__all__)


def _stacked(perturb, seed, n=64, dtype=torch.float32):
    single = {"w": torch.linspace(-1, 1, 60, dtype=dtype).reshape(6, 10),
              "b": torch.ones(3, dtype=dtype)}
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    return single, stack_for_nodes(single, n, perturb=perturb, generator=gen)


def test_stack_for_nodes_perturb_is_seeded_and_spread():
    """The same generator seed gives the same stack, another seed another;
    no perturbation gives exact replicas; the deviations have mean about
    0 and standard deviation about ``perturb``; every node differs; leaves
    keep their dtype."""
    single, a = _stacked(0.05, 7)
    _, b = _stacked(0.05, 7)
    _, c = _stacked(0.05, 8)
    _, d = _stacked(0.05, None)
    _, e = _stacked(0.05, 0)
    _, plain = _stacked(0.0, 7)
    for k in single:
        assert torch.equal(a[k], b[k]) and not torch.equal(a[k], c[k])
        assert torch.equal(d[k], e[k])  # no generator: a fresh one seeded 0
        assert torch.equal(plain[k], single[k].expand_as(plain[k]))
    dev = torch.cat([(a[k] - single[k]).flatten() for k in single])
    assert abs(float(dev.mean())) < 0.05 * 0.1
    assert abs(float(dev.std()) - 0.05) < 0.05 * 0.05
    rows = a["w"].reshape(64, -1)
    assert len({tuple(r.tolist()) for r in rows}) == 64
    _, half = _stacked(0.05, 7, dtype=torch.bfloat16)
    assert all(v.dtype == torch.bfloat16 for v in half.values())


def test_a_reference_perturbed_init_carries_across():
    """The reference's ``jax.random`` draws cannot be reproduced by a
    torch generator, so a perturbed init crosses as its numbers:
    ``repro_torch.convert`` of the reference's stack packs to the
    reference's fused engine's flat buffer bitwise."""
    single = {k: jnp.asarray(v[0]) for k, v in _arrays().items()}
    j_stacked = j_stack_for_nodes(single, N, perturb=0.1, key=jax.random.key(3))
    assert float(jnp.abs(j_stacked["trunk"][0] - j_stacked["trunk"][1]).max()) > 0
    mine = params_from_numpy(jax.tree_util.tree_map(np.asarray, j_stacked), device="cpu")
    flat, _ = pack(mine, pad_to=CHUNK)
    _, j_flat = j_engine.FusedEngine.simulated(_w(), j_stacked, scale_chunk=CHUNK,
                                               impl="jnp")
    np.testing.assert_array_equal(_np(flat), np.asarray(j_flat))
