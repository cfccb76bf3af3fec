"""The exact-wire gossip of the PyTorch port (``repro_torch.core.mixing``)
against the JAX package's ``repro.core.mixing`` from identical numpy
inputs: the flat mix, the tree gossip and the per-leaf gossip, on the
fp32 wire and the bf16 wire, and the mean consensus.

The circulant backends (``make_mesh_*``, on a one-rank gloo group whose
node axes are the torus): the ring / torus coefficients, the directions
and the dense equivalent are numpy copies, equal to the reference's
exactly (ring, (2, 4), (4, 5), (2, 16) with ``axes_subset=("data",)``,
and ``self_weight``); the backends equal the reference's
``make_dense_gossip`` / ``make_dense_flat_mix`` on the dense equivalent
within ``ATOL`` at fp32 (the reference's own mesh backends need
``shard_map``, which fails on the installed jax). Under the bf16 wire the
circulant path multiplies ``recv * weight`` in bf16 (the reference's
mesh semantics) where the dense one contracts in fp32, so they agree
within one bf16 ulp at the scale a node's mix sums (``w_self |x_i| +
sum_j W_ij |x_j|``). The all-gather backends equal the dense one on an
arbitrary W.

Tolerances: both sides compute ``W_off @ sent + w_self * x`` in fp32; the
bf16 wire rounds ``sent`` the same way on both (round to nearest even),
so only the summation order of the n x n product differs: fp32 outputs
agree within ``ATOL`` = 1e-6 (a few ulps at the inputs' magnitudes). A
bf16 leaf is cast back to bf16 after the fp32 mix, so one ulp of fp32
difference at a bf16 rounding boundary moves it by one bf16 ulp: bf16
leaves agree within one bf16 ulp (relative 2^-7).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import mixing as j_mixing  # noqa: E402
from repro.core import topology as j_topology  # noqa: E402
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core import topology  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402

ATOL = 1e-6
BF16_RTOL = 2.0 ** -7
TOPOS = ["ring", "complete", "torus:4x4", "hospital20"]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _n(topo):
    return 20 if topo == "hospital20" else 16


def _tree_np(n, seed, bf16=False):
    rng = np.random.default_rng(seed)
    t = {
        "a": np.asarray(rng.normal(size=(n, 5)), np.float32),
        "b": {"c": np.asarray(rng.normal(size=(n, 3, 4)), np.float32)},
        "d": np.asarray(rng.normal(size=(n,)), np.float32),
    }
    if bf16:
        t["e"] = np.asarray(rng.normal(size=(n, 6)), np.float32)
    return t


def _to_torch(tree, bf16_keys=("e",)):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_torch(v, bf16_keys)
        else:
            t = torch.tensor(v)
            out[k] = t.to(torch.bfloat16) if k in bf16_keys else t
    return out


def _to_jax(tree, bf16_keys=("e",)):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _to_jax(v, bf16_keys)
        else:
            out[k] = jnp.asarray(v, jnp.bfloat16 if k in bf16_keys else jnp.float32)
    return out


def _leaves(tree, prefix=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _compare_trees(mine, ref):
    got, want = list(_leaves(mine)), list(_leaves(ref))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, a), (_, b) in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape), path
        if a.dtype == torch.bfloat16:
            assert str(b.dtype) == "bfloat16", path
            np.testing.assert_allclose(_np(a), _np(b), rtol=BF16_RTOL, atol=0,
                                       err_msg=str(path))
        else:
            np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=ATOL,
                                       err_msg=str(path))


@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("topo", TOPOS)
def test_dense_flat_mix_matches_reference(topo, wire):
    n = _n(topo)
    w = mixing_matrix(topo, n)
    x = np.asarray(np.random.default_rng(n).normal(size=(n, 96)), np.float32)
    got = mixing.make_dense_flat_mix(w, wire)(torch.tensor(x))
    want = j_mixing.make_dense_flat_mix(w, None if wire is None else jnp.bfloat16)(
        jnp.asarray(x))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=ATOL)


@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("topo", TOPOS)
def test_dense_gossip_and_per_leaf_match_reference(topo, wire):
    """The packed tree gossip and the leaf-by-leaf one, with an fp32 and a
    bf16 leaf, against the reference's."""
    n = _n(topo)
    w = mixing_matrix(topo, n)
    tree = _tree_np(n, seed=3 * n, bf16=True)
    j_wire = None if wire is None else jnp.bfloat16
    for mine, ref in ((mixing.make_dense_gossip, j_mixing.make_dense_gossip),
                      (mixing.make_dense_gossip_per_leaf,
                       j_mixing.make_dense_gossip_per_leaf)):
        _compare_trees(mine(w, wire)(_to_torch(tree)), ref(w, j_wire)(_to_jax(tree)))


@pytest.mark.parametrize("wire", [None, torch.bfloat16])
def test_flat_equals_per_leaf_on_fp32_trees(wire):
    n = 16
    w = mixing_matrix("torus:4x4", n)
    tree = _to_torch(_tree_np(n, seed=7))
    flat = mixing.make_dense_gossip(w, wire)(tree)
    per_leaf = mixing.make_dense_gossip_per_leaf(w, wire)(tree)
    for (p, a), (_, b) in zip(_leaves(flat), _leaves(per_leaf)):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=ATOL, err_msg=str(p))


def test_bf16_wire_rounds_only_the_neighbour_terms():
    """The wire dtype's name and the dtype are the same wire; with W = I
    nothing crosses the wire, so the self term passes exactly."""
    n = 8
    w = mixing_matrix("ring", n)
    x = torch.tensor(np.random.default_rng(0).normal(size=(n, 40)), dtype=torch.float32)
    by_name = mixing.make_dense_flat_mix(w, "bfloat16")(x)
    by_dtype = mixing.make_dense_flat_mix(w, torch.bfloat16)(x)
    assert torch.equal(by_name, by_dtype)
    assert not torch.equal(by_name, mixing.make_dense_flat_mix(w)(x))
    assert torch.equal(mixing.make_dense_flat_mix(np.eye(n), "bfloat16")(x), x)
    with pytest.raises(ValueError, match="unknown dtype"):
        mixing.make_dense_flat_mix(w, "float77")(x)
    with pytest.raises(ValueError, match="flat buffer"):
        mixing.make_dense_flat_mix(w)(x[:4])


def test_mean_consensus_is_exact_average():
    n = 10
    tree = _to_torch(_tree_np(n, seed=1))
    out = mixing.make_mean_consensus(n)(tree)
    ref = j_mixing.make_mean_consensus(n)(_to_jax(_tree_np(n, seed=1)))
    _compare_trees(out, ref)
    for (p, a), (_, x) in zip(_leaves(out), _leaves(tree)):
        np.testing.assert_allclose(_np(a), np.broadcast_to(_np(x).mean(0), a.shape),
                                   rtol=0, atol=ATOL, err_msg=str(p))


# ---------------------------------------------------------------------------
# The circulant (ring / torus) and all-gather backends across ranks
# ---------------------------------------------------------------------------

#: node tori: (axis sizes, axes_subset, self_weight)
TORI = [({"data": 8}, None, None), ({"pod": 2, "data": 4}, None, None),
        ({"pod": 4, "data": 5}, None, None), ({"pod": 2, "data": 16}, ("data",), None),
        ({"pod": 4, "data": 5}, None, 0.5)]
TORUS_IDS = ["ring8", "2x4", "4x5", "2x16-data", "4x5-sw0.5"]


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group; each test gives it its own node axes."""
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu")
    yield g
    stop_group(g)


def _on(group, axes):
    import dataclasses

    return dataclasses.replace(group, node_axes=tuple(axes.items()))


@pytest.mark.parametrize("n", [1, 2, 3, 8])
@pytest.mark.parametrize("sw", [None, 0.5])
def test_ring_and_torus_coeffs_equal_reference(n, sw):
    assert topology.ring_mixing_coeffs(n, sw) == j_topology.ring_mixing_coeffs(n, sw)
    for rows, cols in ((1, 1), (2, 2), (2, n), (4, 5), (n, 3)):
        assert (topology.torus_mixing_coeffs(rows, cols, sw)
                == j_topology.torus_mixing_coeffs(rows, cols, sw))
    if n >= 2:
        w_self, prev, nxt = topology.ring_mixing_coeffs(n, sw)
        assert prev == nxt and abs(w_self + prev + nxt - 1.0) < 1e-15


@pytest.mark.parametrize("axes, subset, sw", TORI, ids=TORUS_IDS)
def test_mesh_directions_and_dense_equivalent_equal_reference(axes, subset, sw):
    active = axes if subset is None else {a: axes[a] for a in subset}
    assert (mixing.mesh_gossip_directions(active, sw)
            == j_mixing.mesh_gossip_directions(active, sw))
    got = mixing.mesh_gossip_dense_equivalent(axes, sw, subset)
    want = j_mixing.mesh_gossip_dense_equivalent(axes, sw, subset)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    if subset is None:  # the intra-pod W of a subset is not connected
        topology.check_assumption1(got)
    assert np.allclose(got.sum(1), 1.0) and np.array_equal(got, got.T)
    with pytest.raises(ValueError, match="not in"):
        mixing.mesh_gossip_dense_equivalent(axes, axes_subset=("model",))


def _scale(w, x):
    """A node mix's magnitude: ``sum_j |W_ij| |x_j|`` (the self term too)."""
    return np.abs(w) @ np.abs(np.asarray(x, np.float64).reshape(x.shape[0], -1))


@pytest.mark.parametrize("wire", [None, "bfloat16"])
@pytest.mark.parametrize("axes, subset, sw", TORI, ids=TORUS_IDS)
def test_mesh_backends_match_reference_dense(group, axes, subset, sw, wire):
    """The flat, packed-tree and per-leaf circulant backends on the rank's
    rows (all of them at world 1: every exchange is a local copy) against
    the reference's dense backends on the dense equivalent."""
    g = _on(group, axes)
    n = int(np.prod(list(axes.values())))
    w = j_mixing.mesh_gossip_dense_equivalent(axes, sw, subset)
    x = np.asarray(np.random.default_rng(n).normal(size=(n, 96)), np.float32)
    j_wire = None if wire is None else jnp.bfloat16
    got = mixing.make_mesh_flat_mix(g, sw, wire, subset)(torch.tensor(x))
    want = np.asarray(j_mixing.make_dense_flat_mix(w, j_wire)(jnp.asarray(x)))
    assert got.dtype == torch.float32
    tol = ATOL if wire is None else BF16_RTOL * _scale(w, x)
    assert (np.abs(_np(got) - want) <= tol).all()
    tree = _tree_np(n, seed=5 * n)
    for mine, ref in ((mixing.make_mesh_gossip, j_mixing.make_dense_gossip),
                      (mixing.make_mesh_gossip_per_leaf, j_mixing.make_dense_gossip_per_leaf)):
        out = mine(g, sw, wire, subset)(_to_torch(tree))
        want_tree = ref(w, j_wire)(_to_jax(tree))
        for (path, a), (_, b) in zip(_leaves(out), _leaves(want_tree)):
            assert tuple(a.shape) == tuple(b.shape), path
            leaf = dict(_leaves(tree))[path]
            tol = ATOL if wire is None else BF16_RTOL * _scale(w, leaf).reshape(a.shape)
            assert (np.abs(_np(a) - _np(b)) <= tol).all(), path


def test_mesh_backend_exchanges_one_buffer_a_direction(group, monkeypatch):
    """The packed backend moves ONE buffer per torus direction whatever the
    leaf count; the per-leaf reference one per leaf and direction."""
    g = _on(group, {"pod": 4, "data": 5})
    calls = []
    real = mixing.TorusPlan.exchange

    def spy(self, bufs, d):
        calls.append((d, len(bufs)))
        return real(self, bufs, d)

    monkeypatch.setattr(mixing.TorusPlan, "exchange", spy)
    tree = _to_torch(_tree_np(20, seed=1))
    mixing.make_mesh_gossip(g)(tree)
    assert calls == [(d, 1) for d in range(4)]
    calls.clear()
    mixing.make_mesh_gossip_per_leaf(g)(tree)
    assert len(calls) == 4 * len(list(_leaves(tree)))


@pytest.mark.parametrize("wire", [None, "bfloat16"])
def test_allgather_backends_match_reference_dense(group, wire):
    """An arbitrary W (the hospital graph) through one all-gather: equal to
    the reference's dense tree backends at fp32. The bf16 all-gather
    ships the whole payload in bf16 (the self term too, as the
    reference's all-gather does), the dense backend only the neighbor
    terms: within one bf16 ulp at the mix's scale (and one more of the
    value on a bf16 leaf, rounded back after the mix)."""
    n = 20
    w = mixing_matrix("hospital20", n)
    tree = _tree_np(n, seed=11, bf16=True)
    j_wire = None if wire is None else jnp.bfloat16
    for mine, ref in ((mixing.make_allgather_gossip, j_mixing.make_dense_gossip),
                      (mixing.make_allgather_gossip_per_leaf,
                       j_mixing.make_dense_gossip_per_leaf)):
        got, want = mine(group, w, wire)(_to_torch(tree)), ref(w, j_wire)(_to_jax(tree))
        if wire is None:
            _compare_trees(got, want)
            continue
        for (path, a), (_, b) in zip(_leaves(got), _leaves(want)):
            leaf = dict(_leaves(tree))[path]
            tol = BF16_RTOL * _scale(w, leaf).reshape(a.shape)
            if a.dtype == torch.bfloat16:
                tol = tol + BF16_RTOL * np.abs(_np(b))
            assert (np.abs(_np(a) - _np(b)) <= tol).all(), path
