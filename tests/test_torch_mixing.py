"""The exact-wire gossip of the PyTorch port (``repro_torch.core.mixing``)
against the JAX package's ``repro.core.mixing`` from identical numpy
inputs: the flat mix, the tree gossip and the per-leaf gossip, on the
fp32 wire and the bf16 wire, and the mean consensus.

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
from repro_torch.core import mixing  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402

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
