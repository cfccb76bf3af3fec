"""The PyTorch port's topology programs (``repro_torch.core.dynamics``)
against the JAX package's (``repro.core.dynamics``): the registry and the
spec strings, the validators' messages, the counter hash bit for bit,
and every program's gate and realized W_r over rounds 0-50 on the ring,
the torus and the hospital graph.

Tolerances: the hash, the gates and ``w_off_r`` are bitwise (products of
fp32 weights with {0, 1} gates are exact). ``w_diag_r = 1 - sum_j
w_off_r`` sums a row in another order than XLA's, so it is held within
2 ulp. The reference is evaluated eagerly; its compiled gate is the same
bits (``tests/test_dynamics.py::test_gate_is_identical_eager_and_jit``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import dynamics as jd  # noqa: E402
from repro.core import heterogeneity as jh  # noqa: E402
from repro_torch.core import dynamics as td  # noqa: E402
from repro_torch.core import heterogeneity as th  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402

DYNAMIC_SPECS = (
    "edge_failure:p=0.3,seed=3",
    "edge_failure:p=0.4375,seed=0",
    "node_churn:mean_downtime=3,p_down=0.25,seed=1",
    "node_churn:mean_downtime=5,p_down=0.25,seed=0,switch_groups=4",
    "round_robin_subgraphs:n_groups=3",
    "rgg_rewire:jitter=0.15,radius=0,seed=5",
    "rgg_rewire",
)
GRAPHS = {"ring": ("ring", 8), "torus": ("torus", 16), "hospital20": ("hospital20", 20)}
ROUNDS = 51  # rounds 0-50


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _bits(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float32).view(np.uint32)


def _ulps(a, b) -> int:
    """The largest distance between two fp32 arrays in units in the last
    place (monotone integer map of the float order)."""
    def key(x):
        i = _bits(x).astype(np.int64)
        return np.where(i & 0x80000000, 0x80000000 - i, i)
    return int(np.abs(key(a) - key(b)).max())


def _pair(spec: str, graph: str):
    w = mixing_matrix(*GRAPHS[graph])
    return w, jd.parse_program(spec).bind(w), td.parse_program(spec).bind(w, device="cpu")


def test_registry_and_spec_round_trip():
    assert td.program_names() == jd.program_names()
    assert th.node_program_names() == jh.node_program_names()
    assert td.resolve_program(None).is_static and td.resolve_program("static").is_static
    prog = td.parse_program("edge_failure:p=0.35,seed=9")
    assert td.resolve_program(prog) is prog and prog.p == 0.35 and prog.seed == 9
    for spec in ("static",) + DYNAMIC_SPECS + ("edge_failure:p=0.1234567891,seed=0",):
        mine, ref = td.parse_program(spec), jd.parse_program(spec)
        assert mine.spec() == ref.spec(), spec
        assert td.parse_program(mine.spec()).spec() == mine.spec()
        assert mine.expected_uptime() == ref.expected_uptime(), spec
        assert (mine.init_key() == ref.init_key()).all()
    assert td.parse_program("edge_failure:p=0.1234567891").p == 0.1234567891
    assert [type(p).__name__ for p in map(td.get_program, td.program_names())] == [
        type(p).__name__ for p in map(jd.get_program, jd.program_names())]


def _message(fn, exc=ValueError) -> str:
    with pytest.raises(exc) as info:
        fn()
    return str(info.value)


@pytest.mark.parametrize("call", [
    lambda m: m.parse_program("does_not_exist:p=1"),
    lambda m: m.parse_program("edge_failure:p"),
    lambda m: m.parse_program("edge_failure:nope=3"),
    lambda m: m.parse_program("edge_failure:p=1.5"),
    lambda m: m.parse_program("node_churn:p_down=1.0"),
    lambda m: m.parse_program("node_churn:p_down=0.9,mean_downtime=2"),
    lambda m: m.parse_program("node_churn:mean_downtime=0"),
    lambda m: m.parse_program("node_churn:switch_groups=-1"),
    lambda m: m.parse_program("round_robin_subgraphs:n_groups=0"),
    lambda m: m.parse_program("rgg_rewire:jitter=-1"),
    lambda m: m.parse_program("edge_failure:p=0.2").weights_np(0),
], ids=["unknown", "bare-knob", "bad-knob", "p", "p_down", "hazard", "downtime",
        "switches", "groups", "jitter", "unbound"])
def test_validators_say_what_the_reference_says(call):
    mine = _message(lambda: call(td))
    ref = _message(lambda: call(jd))
    assert mine.replace("program.bind(w, device)", "program.bind(w)") == ref


def test_binding_rules():
    w = mixing_matrix("ring", 8)
    prog = td.parse_program("edge_failure:p=0.2,seed=0").bind(w, device="cpu")
    assert prog.bind(w, device="cpu") is prog and prog.n_nodes == 8
    assert prog.base_edges == jd.parse_program("edge_failure:p=0.2").bind(w).base_edges
    msg = _message(lambda: prog.bind(mixing_matrix("ring", 4), device="cpu"))
    assert msg == _message(lambda: jd.parse_program("edge_failure:p=0.2").bind(w).bind(
        mixing_matrix("ring", 4)))
    assert "round_robin_subgraphs: n_groups=40 exceeds" in _message(
        lambda: td.parse_program("round_robin_subgraphs:n_groups=40").bind(w, device="cpu"))
    # the shared static sentinel binds to any graph
    td.STATIC.bind(w, device="cpu").bind(mixing_matrix("ring", 4), device="cpu")


@pytest.mark.parametrize("r", [0, 1, 2, 7, 50, 12345, 2**24 + 1, 2**31 - 1])
def test_u01_is_the_references_bit_for_bit(r):
    rng = np.random.default_rng(r % 1000)
    keys = [np.array([0, 0], np.uint32), np.array([0xFFFFFFFF, 0xFFFFFFFF], np.uint32)]
    keys += [rng.integers(0, 2**32, size=2, dtype=np.uint64).astype(np.uint32)
             for _ in range(4)]
    idx = np.concatenate([np.arange(600), rng.integers(0, 2**32, size=400,
                                                       dtype=np.uint64)]).astype(np.uint32)
    for key in keys:
        for stream in (1, 2, 3, 4, 5, 11, 13):
            want = np.asarray(jd._u01(jnp.asarray(key), jnp.int32(r), jnp.asarray(idx),
                                      stream))
            got = td._u01(td._as_key(key), torch.tensor(r, dtype=torch.int32),
                          torch.as_tensor(idx.astype(np.int64)), stream)
            assert got.dtype == torch.float32
            assert (_bits(got) == _bits(want)).all(), (key, stream)
            assert (_bits(td._u01_np(key, r, idx, stream)) == _bits(want)).all()


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("spec", DYNAMIC_SPECS + ("static",))
def test_gates_and_round_weights_are_bitwise(spec, graph):
    """The gate and ``w_off_r`` bit for bit, ``w_diag_r`` within 2 ulp,
    round by round on the stateful path the engines drive (the Markov
    state carried in both packages)."""
    w, ref, mine = _pair(spec, graph)
    jkey = jnp.asarray(ref.init_key())
    key = td._as_key(mine.init_key())
    jstate = {k: jnp.asarray(v) for k, v in ref.init_state().items()}
    state = {k: torch.as_tensor(v) for k, v in mine.init_state().items()}
    assert set(state) == set(mine.state_keys()) == set(ref.state_keys())
    for r in range(ROUNDS):
        rr = torch.tensor(r, dtype=torch.int32)
        if not mine.stateful:
            assert (_bits(mine.gate(rr, key)) == _bits(ref.gate(jnp.int32(r), jkey))).all()
        w_off, w_diag, state = mine.round_weights_state(rr, key, state)
        j_off, j_diag, jstate = ref.round_weights_state(jnp.int32(r), jkey, jstate)
        assert (_bits(w_off) == _bits(j_off)).all(), r
        assert _ulps(w_diag, j_diag) <= 2, r
        for k in state:
            assert (_bits(state[k]) == _bits(jstate[k])).all(), (r, k)
        assert float(mine.edge_fraction(w_off)) == pytest.approx(
            float(ref.edge_fraction(j_off)), rel=1.2e-7, abs=0)


@pytest.mark.parametrize("spec", ["rgg_rewire", "rgg_rewire:jitter=0.3,radius=0.25,seed=9"])
def test_rgg_gate_has_no_boundary_flip_over_200_rounds(spec):
    """``d2 <= radius**2`` on jittered fp32 positions flips at the
    boundary if any side contracts ``diff * diff`` into an FMA: the
    port's gate equals the reference's eager and compiled gates in every
    one of 200 rounds."""
    import jax

    w, ref, mine = _pair(spec, "hospital20")
    jkey = jnp.asarray(ref.init_key())
    compiled = jax.jit(lambda r: ref.gate(r, jkey))
    key = td._as_key(mine.init_key())
    for r in range(200):
        got = _bits(mine.gate(r, key))
        assert (got == _bits(ref.gate(jnp.int32(r), jkey))).all(), r
        assert (got == _bits(compiled(jnp.int32(r)))).all(), r


@pytest.mark.parametrize("spec", DYNAMIC_SPECS)
def test_weights_np_is_the_references(spec):
    w, ref, mine = _pair(spec, "hospital20")
    for r in (0, 3, 17):
        np.testing.assert_allclose(mine.weights_np(r), ref.weights_np(r), rtol=0,
                                   atol=3e-7)
        off = mine.weights_np(r) - np.diag(np.diag(mine.weights_np(r)))
        ref_off = ref.weights_np(r) - np.diag(np.diag(ref.weights_np(r)))
        assert (off == ref_off).all()


@pytest.mark.parametrize("switch_groups", [0, 4])
def test_churn_chain_equals_its_replay(switch_groups):
    """The O(1) stateful path (``topo_up`` carried) and the stateless
    replay from round 0 give the same gate every round."""
    w = mixing_matrix("hospital20", 20)
    prog = td.parse_program(f"node_churn:p_down=0.3,mean_downtime=4,seed=2,"
                            f"switch_groups={switch_groups}").bind(w, device="cpu")
    key = td._as_key(prog.init_key())
    state = {k: torch.as_tensor(v) for k, v in prog.init_state().items()}
    for r in range(30):
        g_state, state = prog.gate_state(r, key, state)
        assert torch.equal(g_state, prog.gate(r, key)), r


def test_switch_groups_recover_together():
    """With racks, the down nodes of a rack share one recovery coin: in
    any round, either all of a rack's down nodes come back or none."""
    n, groups = 20, 4
    w = mixing_matrix("hospital20", n)
    prog = td.parse_program("node_churn:p_down=0.4,mean_downtime=3,seed=7,"
                            f"switch_groups={groups}").bind(w, device="cpu")
    key = td._as_key(prog.init_key())
    up = torch.as_tensor(prog.init_state()["topo_up"])
    rack = np.arange(n) * groups // n
    recoveries = 0
    for r in range(200):
        new = prog._step_up(up, r, key)
        for g in range(groups):
            down = (rack == g) & (up.numpy() < 0.5)
            if down.any():
                back = new.numpy()[down]
                assert (back == back[0]).all(), (r, g)
                recoveries += int(back[0] > 0.5)
        up = new
    assert recoveries > 0


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("spec", DYNAMIC_SPECS)
def test_realized_w_is_symmetric_doubly_stochastic_in_support(spec, graph):
    """Every realized W_r -- the topology program's, then with a node
    program's payload gate folded in -- is symmetric, doubly stochastic
    and inside the base support, the invariant the reference meets."""
    w, _, prog = _pair(spec, graph)
    drop = th.parse_node_program("payload_drop:p=0.3,seed=4").bind(w.shape[0], device="cpu")
    base = np.abs(w - np.diag(np.diag(w))) > 0
    key, nkey = td._as_key(prog.init_key()), td._as_key(drop.init_key())
    state = {k: torch.as_tensor(v) for k, v in prog.init_state().items()}
    for r in range(20):
        w_off, w_diag, state = prog.round_weights_state(r, key, state)
        for off, diag in ((w_off, w_diag),
                          th.compose_node_gate(w_off, w_diag, drop.wire_gate(r, nkey))):
            w_r = off.double().numpy() + np.diag(diag.double().numpy())
            assert np.abs(w_r - w_r.T).max() == 0.0
            assert np.abs(w_r.sum(axis=1) - 1.0).max() < 1e-6
            assert np.abs(w_r.sum(axis=0) - 1.0).max() < 1e-6
            assert not ((np.abs(off.numpy()) > 0) & ~base).any()
            assert (w_r >= 0).all()
