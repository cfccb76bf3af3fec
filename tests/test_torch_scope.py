"""The PyTorch port's FederationScope axis (``repro_torch.core.scope``,
``packing.scoped_layout``, the engines' scope hooks) against the JAX
package's, on the reference suite's problem (``tests/test_scope.py``: 4
nodes on a ring, a 3-column private ``head`` and a (6, 5) ``trunk``,
packed at chunk 16 into 48 columns).

* The spec grammar, the registry and the refusals: every spec and error
  of the reference's suite, the canonical strings equal.
* The layout mapping: leaf ranges, shared and private ranges and
  ``scoped_layout`` equal to the reference's.
* The private-column property, on ``fused`` x {sequential, pipelined,
  bounded_staleness:k=2} x {dsgd, dsgt} x {None, secure_agg, dp}: with a
  zero-gradient loss every node's private columns stay bitwise its init
  (the tracker's at zero) while the shared columns mix.
* ``full`` (string or instance) bitwise the scope-less build,
  ``layerwise:freq=1`` bitwise ``full``, a never-firing layerwise gate
  leaves the head at its init, the fire counts, and the wire bytes: the
  linearity identity to the byte and equal to the reference's.
* With a real gradient, the private columns bitwise the port's own
  never-gossiped trajectory (its local step's arithmetic, two roundings
  a step) on every schedule.
* Against the reference's ``FusedEngine(impl="jnp")`` for 3 rounds on the
  quadratic problem under ``backbone``, ``ranges:`` and ``layerwise``:
  the private columns within one ulp a local step of the reference's
  (XLA contracts the reference's ``x - alpha * g`` into one fused
  multiply-add on the CPU; the port rounds the product and the
  difference apart, as its local step and the kernels do), the first
  round within 1e-5, every round's loss within rtol 1e-3 (the port's
  multi-round policy); the DP noise drawn at the scoped width as the
  reference draws it.
* ``sharded_fused``: in process on one gloo rank, and on 2 gloo ranks in
  subprocesses, under ``ranges:`` and ``backbone``, within 1e-5 of the
  port's fused engine; ``layerwise`` refused.
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
from repro.core import scope as j_scope  # noqa: E402
from repro.core.packing import pack as j_pack  # noqa: E402
from repro.core.packing import scoped_layout as j_scoped_layout  # noqa: E402
from repro.core.schedules import constant as j_constant  # noqa: E402
from repro_torch.core import scope as ts  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FlatEngine,
    FusedEngine,
    ShardedFusedEngine,
    TreeEngine,
)
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.packing import pack, scoped_layout  # noqa: E402
from repro_torch.core.schedules import constant  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CHUNK, Q = 4, 16, 2
BACKBONE = "backbone:private=head"
SCHEDULES = ["sequential", "pipelined", "bounded_staleness:k=2"]
PRIVACY = [None, "secure_agg", "dp:sigma=0.5,clip=1.0"]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arrays(seed=0):
    """The reference suite's distinct per-node params: head (N, 3) at
    columns [0, 3), trunk (N, 6, 5) at [3, 33); chunk 16 pads to 48."""
    rng = np.random.default_rng(seed)
    return {"head": rng.normal(size=(N, 3)).astype(np.float32),
            "trunk": rng.normal(size=(N, 6, 5)).astype(np.float32)}


def _params(seed=0):
    return {k: torch.tensor(v) for k, v in _arrays(seed).items()}


def _zero_loss(p, batch):
    return 0.0 * (p["head"].sum(dim=1) + p["trunk"].sum(dim=(1, 2)))


def _sq_loss(p, batch):
    return ((p["trunk"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["head"] ** 2).sum(dim=1)


def _j_sq_loss(p, batch):
    return jnp.sum((p["trunk"] - batch["t"]) ** 2) + jnp.sum(p["head"] ** 2)


def _batches(seed=1):
    return {"t": np.random.default_rng(seed).normal(size=(Q, N, 6, 5)).astype(np.float32)}


def _run(scope, algorithm="dsgd", schedule=None, privacy=None, loss=_zero_loss,
         rounds=3, topk=None):
    engine, flat0 = FusedEngine.simulated(
        mixing_matrix("ring", N), _params(), scale_chunk=CHUNK, topk=topk,
        round_schedule=schedule, privacy=privacy, scope=scope)
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    rf = make_fl_round(loss, constant(0.05), cfg, engine)
    state = init_fl_state(cfg, flat0, engine)
    batches = _batches() if loss is _sq_loss else {"t": np.zeros((Q, N, 6, 5), np.float32)}
    m = {}
    for _ in range(rounds):
        state, m = rf(state, batches)
    return engine, flat0.clone(), state, m


# ---------------------------------------------------------------- grammar

SPECS = ["full", "backbone", "backbone:private=head", "ranges:0-3,16-32",
         "layerwise:freq=4", "layerwise:freq=2,head=fc1"]
BAD = ["nope", "ranges:", "ranges:5-3", "ranges:1-2-3", "layerwise:freq=0",
       "layerwise:freq=x", "backbone:unknown=1", "layerwise:head=x", "full:x=1",
       "backbone:private", "ranges:0-3,2-5"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_roundtrip_matches_the_reference(spec):
    s, js = ts.parse_scope(spec), j_scope.parse_scope(spec)
    assert ts.parse_scope(s.spec()).spec() == s.spec() == js.spec()
    assert (s.is_full, s.needs_round, s.name) == (js.is_full, js.needs_round, js.name)


@pytest.mark.parametrize("spec", BAD)
def test_spec_errors_match_the_reference(spec):
    with pytest.raises(ValueError) as mine:
        ts.parse_scope(spec)
    with pytest.raises(ValueError) as theirs:
        j_scope.parse_scope(spec)
    assert str(mine.value) == str(theirs.value)


def test_registry_and_resolve():
    assert ts.scope_names() == j_scope.scope_names()
    assert set(ts.scope_names()) >= {"full", "backbone", "ranges", "layerwise"}
    assert ts.resolve_scope(None) is ts.FULL and ts.resolve_scope("full").is_full
    bb = ts.parse_scope("backbone")
    assert ts.resolve_scope(bb) is bb and not bb.is_full
    with pytest.raises(TypeError):
        ts.resolve_scope(3)


def test_layout_ranges_match_the_reference():
    _, layout = pack(_params(), pad_to=CHUNK)
    _, j_layout = j_pack({k: jnp.asarray(v) for k, v in _arrays().items()}, pad_to=CHUNK)
    assert (layout.total, layout.used) == (48, 33)
    assert ts.leaf_column_ranges(layout) == j_scope.leaf_column_ranges(j_layout)
    for spec in ("backbone:private=head", "ranges:0-16,32-48", "layerwise:freq=3,head=head"):
        s, js = ts.parse_scope(spec), j_scope.parse_scope(spec)
        assert s.shared_ranges(layout) == js.shared_ranges(j_layout), spec
        assert s.private_ranges(layout) == js.private_ranges(j_layout), spec
    assert ts.parse_scope(BACKBONE).private_ranges(layout) == ((0, 3), (33, 48))
    assert ts.parse_scope("layerwise:freq=3,head=head").gate_ranges(layout) == ((0, 3),)
    for spec in ("backbone:private=nothing", "ranges:0-64", "ranges:0-48"):
        with pytest.raises(ValueError) as mine:
            ts.parse_scope(spec).shared_ranges(layout)
        with pytest.raises(ValueError) as theirs:
            j_scope.parse_scope(spec).shared_ranges(j_layout)
        assert str(mine.value) == str(theirs.value)
    _, lay1 = pack({"only": torch.zeros(N, 5)}, pad_to=CHUNK)
    with pytest.raises(ValueError, match="EVERY leaf"):
        ts.parse_scope("backbone:private=only").shared_ranges(lay1)
    assert ts.merge_ranges([(5, 9), (0, 3), (2, 4), (7, 7)]) == j_scope.merge_ranges(
        [(5, 9), (0, 3), (2, 4), (7, 7)]) == ((0, 4), (5, 9))
    assert ts.complement_ranges(((3, 5),), 8) == ((0, 3), (5, 8))


def test_scoped_layout_matches_the_reference():
    _, layout = pack(_params(), pad_to=CHUNK)
    _, j_layout = j_pack({k: jnp.asarray(v) for k, v in _arrays().items()}, pad_to=CHUNK)
    for ranges, chunk in ((((3, 33),), 16), (((0, 8), (16, 24)), 8), (((0, 48),), 5)):
        wire, local = scoped_layout(layout, ranges, chunk)
        j_wire, j_local = j_scoped_layout(j_layout, ranges, chunk)
        assert local == j_local
        assert (wire.total, wire.used, wire.n_nodes) == (j_wire.total, j_wire.used,
                                                         j_wire.n_nodes)
    assert scoped_layout(layout, ((3, 33),), CHUNK)[0].total == 32
    for bad in ((), ((5, 3),), ((0, 8), (4, 12)), ((0, 64),)):
        with pytest.raises(ValueError):
            scoped_layout(layout, bad, CHUNK)
        with pytest.raises(ValueError):
            j_scoped_layout(j_layout, bad, CHUNK)


# ------------------------------------------- the private-column property


@pytest.mark.parametrize("privacy", PRIVACY)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_private_columns_bit_identical(algorithm, schedule, privacy):
    engine, flat0, state, _ = _run(BACKBONE, algorithm, schedule, privacy)
    got = state.params
    private = engine.scope.private_ranges(engine.layout)
    shared = engine.scope.shared_ranges(engine.layout)
    assert private == ((0, 3), (33, 48)) and shared == ((3, 33),)
    for a, b in private:
        assert torch.equal(got[:, a:b], flat0[:, a:b]), (a, b)
    assert any(not torch.equal(got[:, a:b], flat0[:, a:b]) for a, b in shared)
    if algorithm == "dsgt":
        for a, b in private:  # t + g - g_prev with g = 0: zero, untouched
            assert torch.equal(state.tracker[:, a:b], torch.zeros_like(state.tracker[:, a:b]))
    # every wire buffer at the scoped width
    assert engine.wire_layout.total == 32
    for key in ("recon", "residual"):
        assert state.comm[key].shape == (N, 32)


def test_full_scope_bitwise_matches_default():
    _, _, st_none, m_none = _run(None, loss=_sq_loss)
    for full in ("full", ts.FullScope()):
        engine, _, st_full, m_full = _run(full, loss=_sq_loss)
        assert torch.equal(st_none.params, st_full.params)
        assert m_none["wire_bytes"] == m_full["wire_bytes"]
        assert engine.wire_layout is engine.layout and set(st_full.comm) == set(st_none.comm)


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_layerwise_freq1_is_full(algorithm):
    _, _, st_f1, _ = _run("layerwise:freq=1,head=head", algorithm, loss=_sq_loss)
    _, _, st_full, _ = _run(None, algorithm, loss=_sq_loss)
    assert torch.equal(st_f1.params, st_full.params)
    assert int(st_f1.comm["topo_round"]) == 3  # the static round advances it


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_layerwise_gate_between_firings(schedule):
    """The head never fires in 3 rounds at freq 1000: its columns stay
    bitwise the init, the trunk mixes, the wire is the full wire."""
    engine, flat0, state, m = _run("layerwise:freq=1000,head=head", "dsgt", schedule)
    for a, b in engine.scope.gate_ranges(engine.layout):
        assert torch.equal(state.params[:, a:b], flat0[:, a:b])
        assert torch.equal(state.tracker[:, a:b], torch.zeros_like(state.tracker[:, a:b]))
    assert not torch.equal(state.params[:, 3:33], flat0[:, 3:33])
    _, _, _, m_full = _run(None, "dsgt", schedule)
    assert m["wire_bytes"] == m_full["wire_bytes"]


def test_layerwise_fire_counts_completed_rounds():
    s = ts.LayerwiseScope(freq=3)
    assert [bool(s.fire(r)) for r in range(6)] == [False, False, True, False, False, True]
    fires = s.fire(torch.arange(6, dtype=torch.int32))
    assert fires.dtype == torch.bool and fires.tolist() == [False, False, True, False,
                                                            False, True]
    js = j_scope.LayerwiseScope(freq=3)
    assert [bool(js.fire(jnp.int32(r))) for r in range(6)] == fires.tolist()


@pytest.mark.parametrize("topk", [None, 4])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_scoped_wire_bytes_linearity(algorithm, topk):
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    eng_f, _, _, m_f = _run(None, algorithm, rounds=1, topk=topk)
    eng_b, _, _, m_b = _run(BACKBONE, algorithm, rounds=1, topk=topk)
    assert eng_b.wire_layout.total == 32 < eng_f.layout.total == 48
    assert (eng_b.wire_bytes(cfg) * eng_f.layout.total
            == eng_f.wire_bytes(cfg) * eng_b.wire_layout.total)
    assert m_b["wire_bytes"] < m_f["wire_bytes"] and m_b["wire_bytes"] == eng_b.wire_bytes(cfg)
    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    j_eng, _ = j_engine.FusedEngine.simulated(
        mixing_matrix("ring", N), {k: jnp.asarray(v) for k, v in _arrays().items()},
        scale_chunk=CHUNK, topk=topk, impl="jnp", scope=BACKBONE)
    assert eng_b.wire_bytes(cfg) == j_eng.wire_bytes(j_cfg)
    assert eng_b.wire_layout.total == j_eng.wire_layout.total


# ------------------------------------------------------ refusals


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


@pytest.mark.parametrize("cls", ["TreeEngine", "FlatEngine"])
def test_tree_flat_refuse_partial_scopes_with_the_references_message(cls):
    """A partial scope is refused as the reference refuses it, as a spec
    string and as an instance; ``full`` passes in both forms (resolved
    before the check)."""
    mine, theirs = {"TreeEngine": TreeEngine, "FlatEngine": FlatEngine}[cls], getattr(
        j_engine, cls)
    w = mixing_matrix("ring", N)
    jparams = {k: jnp.asarray(v) for k, v in _arrays().items()}
    for scope in (BACKBONE, "layerwise:freq=2,head=head"):
        for form in (scope, ts.parse_scope(scope)):
            j_form = form if isinstance(form, str) else j_scope.parse_scope(scope)
            assert _message(lambda: mine.simulated(w, _params(), scope=form)) == _message(
                lambda: theirs.simulated(w, jparams, scope=j_form))
    for full in ("full", ts.FULL, ts.FullScope(), None):
        eng, _ = mine.simulated(w, _params(), scope=full)
        assert eng.scope.is_full


def test_fused_accepts_every_scope_and_refuses_a_bad_one():
    for spec in (BACKBONE, "ranges:0-3,16-32", "layerwise:freq=2,head=head"):
        eng, _ = FusedEngine.simulated(mixing_matrix("ring", N), _params(), scale_chunk=CHUNK,
                                       scope=spec)
        assert eng.scope.spec() == spec
    with pytest.raises(ValueError, match="matches no leaf"):
        FusedEngine.simulated(mixing_matrix("ring", N), _params(), scale_chunk=CHUNK,
                              scope="backbone")


# ------------------------------------- against the reference's fused engine


class _Pair:
    """The same scoped run in both packages on the quadratic problem."""

    def __init__(self, scope, algorithm, schedule, privacy=None, loss=_sq_loss):
        w = mixing_matrix("ring", N)
        self.cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
        j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
        kw = dict(scale_chunk=CHUNK, round_schedule=schedule, privacy=privacy, scope=scope)
        self.j_engine, j_flat = j_engine.FusedEngine.simulated(
            w, {k: jnp.asarray(v) for k, v in _arrays().items()}, impl="jnp", **kw)
        j_loss = _j_sq_loss if loss is _sq_loss else (
            lambda p, b: 0.0 * (jnp.sum(p["head"]) + jnp.sum(p["trunk"])))
        self.j_round = jax.jit(j_fl.make_fl_round(j_loss, None, j_constant(0.05), j_cfg,
                                                  engine=self.j_engine))
        self.j_state = j_fl.init_fl_state(j_cfg, j_flat, engine=self.j_engine)
        self.engine, flat = FusedEngine.simulated(w, _params(), **kw)
        self.round = make_fl_round(loss, constant(0.05), self.cfg, self.engine)
        self.state = init_fl_state(self.cfg, flat, self.engine)
        self.batches = _batches()

    def step(self):
        self.state, m = self.round(self.state, self.batches)
        self.j_state, jm = self.j_round(self.j_state, self.batches)
        return m, jm


def _ulps(a, b) -> int:
    """The largest distance in fp32 ulps of two arrays of one sign pattern."""
    return int(np.abs(_np(a).view(np.int32).astype(np.int64)
                      - _np(b).view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("scope", [BACKBONE, "layerwise:freq=1000,head=head"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_private_columns_follow_the_local_trajectory(algorithm, schedule, scope):
    """On the quadratic problem the head's gradient is ``2 * head``: its
    never-gossiped trajectory is the local step's ``x - a * g`` at every
    step (DSGT's comm step with the tracker ``t + g - g_prev``). The
    private columns equal it bitwise after 3 rounds on every schedule."""
    engine, flat0, state, _ = _run(scope, algorithm, schedule, loss=_sq_loss)
    a = torch.tensor(0.05, dtype=torch.float32)
    x = flat0[:, 0:3].clone()
    t = gp = torch.zeros_like(x)
    for _ in range(3):
        for _ in range(Q - 1):
            x = x - a * (2 * x)
        g = 2 * x
        if algorithm == "dsgd":
            x = x - a * g
        else:
            t = t + g - gp
            x, gp = x - a * t, g
    assert torch.equal(state.params[:, 0:3], x)
    if algorithm == "dsgt":
        assert torch.equal(state.tracker[:, 0:3], t)


@pytest.mark.parametrize("scope", [BACKBONE, "ranges:0-8,16-40",
                                   "layerwise:freq=2,head=head"])
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_scoped_round_matches_the_reference(algorithm, schedule, scope):
    pair = _Pair(scope, algorithm, schedule)
    assert set(pair.engine.comm_keys(pair.cfg)) == set(pair.j_engine.comm_keys(pair.cfg))
    layout = pair.engine.layout
    private = pair.engine.scope.private_ranges(layout)
    if isinstance(pair.engine.scope, ts.LayerwiseScope):
        private = pair.engine.scope.gate_ranges(layout)
    for rnd in range(3):
        m, jm = pair.step()
        st, jst = pair.state, pair.j_state
        mine, theirs = _np(st.params), _np(jst.params)
        # the layerwise head takes the mix on round 2 (fire at freq 2)
        if not (isinstance(pair.engine.scope, ts.LayerwiseScope) and rnd >= 1):
            for a, b in private:  # one ulp a local step: the reference's FMA
                assert _ulps(mine[:, a:b], theirs[:, a:b]) <= Q * (rnd + 1), (rnd, a, b)
                if algorithm == "dsgt":
                    assert _ulps(_np(st.tracker)[:, a:b],
                                 _np(jst.tracker)[:, a:b]) <= Q * (rnd + 1)
        if rnd == 0:
            np.testing.assert_allclose(mine, theirs, rtol=0, atol=1e-5)
            for k in jst.comm:
                np.testing.assert_allclose(_np(st.comm[k]).astype(np.float64),
                                           _np(jst.comm[k]).astype(np.float64), rtol=0,
                                           atol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
        assert m["wire_bytes"] == float(jm["wire_bytes"])
        for k in ("topo_round",):
            if k in jst.comm:
                assert int(st.comm[k]) == int(jst.comm[k])


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_scoped_dp_noise_is_drawn_at_the_wire_width(algorithm):
    """Under dp and a sub-range scope both packages draw (n, 32) noise:
    one round's params within 1e-5 of the reference, the private columns
    bitwise, the noise rows bitwise the reference's draw."""
    pair = _Pair(BACKBONE, algorithm, "sequential", privacy="dp:sigma=0.5,clip=1.0")
    noise = pair.engine._dp_noise(pair.state.comm, range(N))
    j_noise = pair.j_engine._dp_noise_full(pair.j_state.comm, N)
    assert noise.shape == (N, 32) and j_noise.shape == (N, 32)
    np.testing.assert_allclose(_np(noise), np.asarray(j_noise), rtol=0, atol=1e-5)
    m, jm = pair.step()
    np.testing.assert_allclose(_np(pair.state.params), _np(pair.j_state.params), rtol=0,
                               atol=1e-5)
    for a, b in ((0, 3), (33, 48)):
        assert _ulps(pair.state.params[:, a:b], pair.j_state.params[:, a:b]) <= Q
    assert float(m["dp_epsilon"]) == pytest.approx(float(jm["dp_epsilon"]), rel=1e-6)


# ------------------------------------------------ the sharded engine


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group for this module's in-process tests."""
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu")
    yield g
    stop_group(g)


def _er():
    return mixing_matrix("erdos_renyi", N, p=0.7, seed=1)


@pytest.mark.parametrize("scope", [BACKBONE, "ranges:0-8,16-40"])
@pytest.mark.parametrize("topk", [None, 4])
@pytest.mark.parametrize("schedule", ["sequential", "bounded_staleness:k=2"])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_sharded_scope_matches_fused(group, algorithm, schedule, topk, scope):
    """World 1: the private columns bitwise the zero-gradient inits on
    the sharded wire, and on the quadratic problem the dense wire within
    1e-5 of the port's fused engine over 3 rounds (the compact wire:
    loss within rtol 1e-3, ties at k kept by one and not the other);
    the collectives move the scoped wire's bytes."""
    kw = dict(scale_chunk=CHUNK, topk=topk, round_schedule=schedule, scope=scope)
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    for loss in (_zero_loss, _sq_loss):
        batches = _batches() if loss is _sq_loss else {"t": np.zeros((Q, N, 6, 5), np.float32)}
        sh, rows = ShardedFusedEngine.from_group(group, _params(), w=_er(), **kw)
        fe, flat = FusedEngine.simulated(sh.dense_equivalent(), _params(), **kw)
        states = []
        for eng, start in ((sh, rows), (fe, flat)):
            rf = make_fl_round(loss, constant(0.05), cfg, eng)
            st = init_fl_state(cfg, start, eng)
            ms = []
            for _ in range(3):
                st, m = rf(st, batches)
                ms.append(float(m["loss"]))
            states.append((st, ms, m))
        (s_sh, l_sh, m_sh), (s_fe, l_fe, m_fe) = states
        private = sh.scope.private_ranges(sh.layout)
        if loss is _zero_loss:
            for a, b in private:
                assert torch.equal(s_sh.params[:, a:b], flat[:, a:b])
        elif topk is None:
            np.testing.assert_allclose(_np(s_sh.params), _np(s_fe.params), rtol=0, atol=1e-5)
            if algorithm == "dsgt":
                np.testing.assert_allclose(_np(s_sh.tracker), _np(s_fe.tracker), rtol=0,
                                           atol=1e-5)
        else:
            np.testing.assert_allclose(l_sh, l_fe, rtol=1e-3)
        for a, b in private:  # a private column never leaves its node
            assert torch.equal(s_sh.params[:, a:b], s_fe.params[:, a:b])
        assert m_sh["wire_bytes"] == sh.wire_bytes(cfg) < FusedEngine.simulated(
            sh.dense_equivalent(), _params(), scale_chunk=CHUNK, topk=topk)[0].wire_bytes(cfg)
        assert s_sh.comm["recon"].shape == (N, sh.wire_layout.total)


def test_sharded_refuses_layerwise_with_the_references_message(group):
    msg = _message(lambda: ShardedFusedEngine.from_group(
        group, _params(), w=_er(), scale_chunk=CHUNK, scope="layerwise:freq=4,head=head"))
    assert "layerwise" in msg and msg.startswith(
        "federation scope 'layerwise:freq=4,head=head': the layerwise round-gated mix")


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
    import torch.distributed as dist

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    g = start_group(rank, world, store, device="cpu")
    n, q, chunk = 8, 2, 16
    rng = np.random.default_rng(3)
    params = {"head": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32),
              "trunk": torch.tensor(rng.normal(size=(n, 6, 5)), dtype=torch.float32)}
    batches = {"t": torch.tensor(rng.normal(size=(q, n, 6, 5)), dtype=torch.float32)}

    def loss(p, b):
        return ((p["trunk"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["head"] ** 2).sum(dim=1)

    res = {}
    w = mixing_matrix("erdos_renyi", n, p=0.5, seed=2)
    for alg, sched, scope, topk, prog in (
            ("dsgt", "sequential", "backbone:private=head", None, None),
            ("dsgd", "pipelined", "ranges:0-8,16-40", None, None),
            ("dsgt", "bounded_staleness:k=2", "backbone:private=head", 4, None),
            ("dsgt", "sequential", "ranges:0-8,16-40", None,
             "node_churn:p_down=0.3,mean_downtime=2,seed=1")):
        cfg = FLConfig(algorithm=alg, q=q, n_nodes=n)
        eng, rows = ShardedFusedEngine.from_group(
            g, params, w=w, scale_chunk=chunk, topk=topk, round_schedule=sched,
            scope=scope, topology_program=prog)
        rf = make_fl_round(loss, constant(0.05), cfg, eng)
        st = init_fl_state(cfg, rows, eng)
        for _ in range(3):
            st, m = rf(st, batches)
        key = f"{alg}|{sched}|{scope}|{topk}|{prog}"
        res[key + "/params"] = eng.gather_rows(st.params).numpy()
        if st.tracker is not None:
            res[key + "/tracker"] = eng.gather_rows(st.tracker).numpy()
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


def _fused_twin(key):
    """The port's fused engine on the worker's configuration."""
    alg, sched, scope, topk, prog = key.split("|")
    n, chunk = 8, 16
    rng = np.random.default_rng(3)
    params = {"head": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32),
              "trunk": torch.tensor(rng.normal(size=(n, 6, 5)), dtype=torch.float32)}
    batches = {"t": torch.tensor(rng.normal(size=(Q, n, 6, 5)), dtype=torch.float32)}
    cfg = FLConfig(algorithm=alg, q=Q, n_nodes=n)
    fe, flat = FusedEngine.simulated(
        mixing_matrix("erdos_renyi", n, p=0.5, seed=2), params, scale_chunk=chunk,
        topk=None if topk == "None" else int(topk), round_schedule=sched, scope=scope,
        topology_program=None if prog == "None" else prog)
    rf = make_fl_round(_sq_loss, constant(0.05), cfg, fe)
    st = init_fl_state(cfg, flat, fe)
    for _ in range(3):
        st, m = rf(st, batches)
    return st, m


def test_sharded_scope_on_two_gloo_ranks(tmp_path):
    """8 nodes on 1 and 2 gloo ranks, started together, under
    ``backbone`` (sequential DSGT; top-4 at k = 2) and ``ranges:``
    (pipelined DSGD; DSGT under node churn): after 3 rounds world 2's
    gathered params, tracker and metrics equal world 1's within 1e-6, and
    the dense-wire runs are within 1e-5 of the port's fused engine."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for world in (1, 2):
        store = str(tmp_path / f"store{world}")
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(rank), str(world), store,
                 str(tmp_path / f"world{world}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-4000:]
    one, two = np.load(tmp_path / "world1.npz"), np.load(tmp_path / "world2.npz")
    assert sorted(one.files) == sorted(two.files)
    for key in one.files:
        np.testing.assert_allclose(two[key], one[key], rtol=1e-6, atol=1e-6, err_msg=key)
    for key in {k.rsplit("/", 1)[0] for k in one.files}:
        if key.split("|")[3] != "None":
            continue  # the compact wire is held by the world-1 test
        st, m = _fused_twin(key)
        np.testing.assert_allclose(two[key + "/params"], _np(st.params), rtol=0, atol=1e-5,
                                   err_msg=key)
        if st.tracker is not None:
            np.testing.assert_allclose(two[key + "/tracker"], _np(st.tracker), rtol=0,
                                       atol=1e-5, err_msg=key)
        assert float(two[key + "/wire_bytes"]) == m["wire_bytes"]
