"""The PyTorch port's node programs (``repro_torch.core.heterogeneity``)
against the JAX package's (``repro.core.heterogeneity``): the step, wire
and wire-k gates bit for bit over rounds 0-50, ``compose_node_gate``
(also on arbitrary drop masks), the expected uptimes, and the engines'
refusals of what they cannot run.

Tolerances: the gates and the composed ``w_off`` are bitwise; the
composed diagonal, a row sum in another order than XLA's, within 2 ulp.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as j_engine  # noqa: E402
from repro.core import heterogeneity as jh  # noqa: E402
from repro_torch.core import heterogeneity as th  # noqa: E402
from repro_torch.core.dynamics import _as_key  # noqa: E402
from repro_torch.core.engine import FlatEngine, FusedEngine, TreeEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, make_fl_round  # noqa: E402
from repro_torch.core.schedules import constant  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402

NODE_SPECS = (
    "homogeneous",
    "stragglers:drop=1,frac=0.25,rate=0.5,seed=0",
    "stragglers:drop=1,frac=0.5,rate=0.5,seed=0",
    "stragglers:drop=0,frac=0.4,rate=0.3,seed=3",
    "slow_nodes:frac=0.3,rate=0.5,seed=2",
    "slow_uplink:frac=0.25,k_scale=0.25,seed=1",
    "payload_drop:p=0.1,seed=0",
    "payload_drop:p=0.35,seed=6",
)


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _bits(x) -> np.ndarray:
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.astype(np.float32).view(np.uint32)


def _ulps(a, b) -> int:
    def key(x):
        i = _bits(x).astype(np.int64)
        return np.where(i & 0x80000000, 0x80000000 - i, i)
    return int(np.abs(key(a) - key(b)).max())


@pytest.mark.parametrize("n", [8, 20])
@pytest.mark.parametrize("spec", NODE_SPECS)
def test_gates_are_the_references_bit_for_bit(spec, n):
    mine = th.parse_node_program(spec).bind(n, device="cpu")
    ref = jh.parse_node_program(spec).bind(n)
    assert mine.spec() == ref.spec() and (mine.init_key() == ref.init_key()).all()
    for flag in ("is_static", "heterogeneous_compute", "heterogeneous_wire_k"):
        assert getattr(mine, flag) == getattr(ref, flag), flag
    key, jkey = _as_key(mine.init_key()), jnp.asarray(ref.init_key())
    for r in range(51):
        rr = torch.tensor(r, dtype=torch.int32)
        for q in (1, 2, 10):
            got = mine.step_gate(rr, key, q)
            want = ref.step_gate(jnp.int32(r), jkey, q)
            assert tuple(got.shape) == want.shape and (_bits(got) == _bits(want)).all()
        assert (_bits(mine.wire_gate(rr, key)) == _bits(ref.wire_gate(jnp.int32(r), jkey))).all()
        assert (_bits(mine.wire_k_gate(rr, key))
                == _bits(ref.wire_k_gate(jnp.int32(r), jkey))).all()


@pytest.mark.parametrize("spec", NODE_SPECS)
def test_registry_spec_and_uptime(spec):
    mine, ref = th.parse_node_program(spec), jh.parse_node_program(spec)
    assert th.parse_node_program(mine.spec()).spec() == mine.spec() == ref.spec()
    assert mine.expected_uptime() == ref.expected_uptime()
    assert th.resolve_node_program(mine) is mine
    assert th.resolve_node_program(None).is_static


@pytest.mark.parametrize("spec", [
    "nope", "stragglers:frac", "stragglers:nope=1", "stragglers:frac=2",
    "stragglers:rate=-1", "slow_nodes:frac=1.5", "slow_uplink:k_scale=0",
    "payload_drop:p=1.0",
])
def test_validators_say_what_the_reference_says(spec):
    with pytest.raises(ValueError) as mine:
        th.parse_node_program(spec)
    with pytest.raises(ValueError) as ref:
        jh.parse_node_program(spec)
    assert str(mine.value) == str(ref.value)


def test_binding_rules():
    prog = th.parse_node_program("payload_drop:p=0.2").bind(8, device="cpu")
    with pytest.raises(ValueError, match="already bound to 8 nodes"):
        prog.bind(4, device="cpu")
    with pytest.raises(ValueError, match="n_nodes=0 must be >= 1"):
        th.parse_node_program("payload_drop").bind(0, device="cpu")
    with pytest.raises(ValueError, match="unbound"):
        th.parse_node_program("payload_drop").wire_gate(0, np.zeros(2, np.uint32))
    th.HOMOGENEOUS.bind(8, device="cpu").bind(4, device="cpu")


@pytest.mark.parametrize("seed", range(6))
def test_compose_node_gate_is_the_references(seed):
    """On the hospital graph's W and on a random symmetric doubly
    stochastic one, with an arbitrary drop mask (all up and all down
    included)."""
    rng = np.random.default_rng(seed)
    n = 20
    w = mixing_matrix("hospital20", n)
    if seed % 2:
        a = rng.uniform(size=(n, n)) * (rng.uniform(size=(n, n)) < 0.3)
        a = (a + a.T) / 2
        np.fill_diagonal(a, 0.0)
        a /= a.sum(axis=1).max() * 1.5
        w = a + np.diag(1.0 - a.sum(axis=1))
    w_off = (w - np.diag(np.diag(w))).astype(np.float32)
    w_diag = np.diag(w).astype(np.float32)
    up = (rng.uniform(size=n) < [0.5, 0.9, 0.0, 1.0, 0.3, 0.7][seed]).astype(np.float32)
    off, diag = th.compose_node_gate(torch.as_tensor(w_off), torch.as_tensor(w_diag),
                                     torch.as_tensor(up))
    j_off, j_diag = jh.compose_node_gate(jnp.asarray(w_off), jnp.asarray(w_diag),
                                         jnp.asarray(up))
    assert (_bits(off) == _bits(j_off)).all()
    assert _ulps(diag, j_diag) <= 2
    w_r = off.double().numpy() + np.diag(diag.double().numpy())
    assert np.abs(w_r - w_r.T).max() == 0 and np.abs(w_r.sum(axis=1) - 1).max() < 1e-6
    dropped = up < 0.5
    assert (off.numpy()[dropped] == 0).all() and (off.numpy()[:, dropped] == 0).all()


def _buffer(n=20, t=1442):
    return {"p": torch.zeros(n, t)}


def test_slow_uplink_needs_a_per_node_k():
    """The fused engine has no per-node wire k: building its round under
    ``slow_uplink`` raises the reference's ValueError."""
    w = mixing_matrix("hospital20", 20)
    cfg = FLConfig(algorithm="dsgt", q=3, n_nodes=20)
    eng, _ = FusedEngine.simulated(w, _buffer(), node_program="slow_uplink")
    with pytest.raises(ValueError) as mine:
        make_fl_round(lambda p, b: p["p"].sum(dim=1), constant(0.1), cfg, eng)
    from repro.core.packing import pack
    j_flat, j_layout = pack({"p": jnp.zeros((20, 1442))}, pad_to=512)
    j_eng = j_engine.FusedEngine(w, j_layout, impl="jnp", node_program="slow_uplink")
    with pytest.raises(ValueError) as ref:
        j_eng.make_step_mask(cfg)
    assert str(mine.value) == str(ref.value)
    assert "modulates per-node wire k" in str(mine.value)


@pytest.mark.parametrize("kw", [dict(topology_program="node_churn:p_down=0.1"),
                                dict(node_program="stragglers:frac=0.25")])
def test_the_tree_engine_refuses_programs_as_the_reference_does(kw):
    w = mixing_matrix("ring", 4)
    with pytest.raises(ValueError) as mine:
        TreeEngine.simulated(w, {"p": torch.zeros(4, 6)}, **kw)
    with pytest.raises(ValueError) as ref:
        j_engine.TreeEngine.simulated(w, {"p": jnp.zeros((4, 6))}, **kw)
    assert str(mine.value) == str(ref.value)


def test_flat_and_fused_take_programs():
    w = mixing_matrix("ring", 4)
    for build in (FlatEngine.simulated, lambda *a, **k: FusedEngine.simulated(
            *a, scale_chunk=2, **k)):
        eng, _ = build(w, {"p": torch.zeros(4, 6)},
                       topology_program="edge_failure:p=0.2",
                       node_program="stragglers:frac=0.25")
        assert eng.dynamic_topology and eng.dynamic_nodes and eng.dynamic_round
        assert eng.topology_program.bound and eng.node_program.bound
        cfg = FLConfig(algorithm="dsgd", q=2, n_nodes=4)
        assert set(eng.comm_keys(cfg)) >= {"topo_round", "topo_key", "node_key"}
