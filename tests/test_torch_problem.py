"""The PyTorch port's problem set-up against the JAX package: the EHR
cohort and batch stream, the hospital graph, the flat layout and its wire
accounting, the learning-rate schedule, and the MLP's loss, per-node
gradients and accuracies at the reference's own init."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ehr_mlp import class_weights as j_class_weights  # noqa: E402
from repro.core import packing as j_packing  # noqa: E402
from repro.core import schedules as j_schedules  # noqa: E402
from repro.core import topology as j_topology  # noqa: E402
from repro.data import ehr as j_ehr  # noqa: E402
from repro.models import mlp as j_mlp  # noqa: E402
from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.convert import flat_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import packing, schedules, topology  # noqa: E402
from repro_torch.data import ehr  # noqa: E402
from repro_torch.models import mlp  # noqa: E402

CPU = "cpu"


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _jax_init(seed=0):
    return jax.tree_util.tree_map(np.asarray, j_mlp.mlp_init(jax.random.key(seed)))


def _stack(tree, n, rng):
    """Node-stacked copy of one node's numpy tree with per-node noise, so
    every node holds different weights."""
    return jax.tree_util.tree_map(
        lambda a: (a[None] + 0.1 * rng.normal(size=(n,) + a.shape)).astype(np.float32),
        tree,
    )


@pytest.mark.parametrize("seed", [0, 3])
def test_cohort_and_batches_are_bitwise_equal(seed):
    a, b = ehr.generate_ehr_cohort(seed=seed), j_ehr.generate_ehr_cohort(seed=seed)
    assert a.n_nodes == b.n_nodes == 20
    for fa, fb, la, lb in zip(a.features, b.features, a.labels, b.labels):
        assert fa.dtype == fb.dtype and la.dtype == lb.dtype
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)
    ba = ehr.make_node_batcher(a, m=20, seed=seed + 1)
    bb = j_ehr.make_node_batcher(b, m=20, seed=seed + 1)
    for _ in range(50):
        xa, xb = next(ba), next(bb)
        np.testing.assert_array_equal(xa["x"], xb["x"])
        np.testing.assert_array_equal(xa["y"], xb["y"])


@pytest.mark.parametrize("topo,n", [("hospital20", 20), ("ring", 8),
                                    ("torus:4x4", 16), ("complete", 7)])
def test_mixing_matrix_is_bitwise_equal(topo, n):
    w = topology.mixing_matrix(topo, n)
    np.testing.assert_array_equal(w, j_topology.mixing_matrix(topo, n))
    topology.check_assumption1(w)
    assert topology.spectral_gap(w) == j_topology.spectral_gap(w)


def test_flat_layout_matches_reference():
    rng = np.random.default_rng(0)
    tree = _stack(_jax_init(), 20, rng)
    j_flat, j_layout = j_packing.pack(jax.tree_util.tree_map(jnp.asarray, tree),
                                      pad_to=512)
    flat, layout = packing.pack(params_from_numpy(tree, device=CPU), pad_to=512)
    assert [s.offset for s in layout.leaves] == [0, 32, 1376, 1378]
    assert layout.paths == (("fc1", "b"), ("fc1", "w"), ("fc2", "b"), ("fc2", "w"))
    assert (layout.n_nodes, layout.total, layout.used) == (20, 1536, 1442)
    assert (layout.n_nodes, layout.total, layout.used) == (
        j_layout.n_nodes, j_layout.total, j_layout.used)
    for mine, ref in zip(layout.leaves, j_layout.leaves):
        assert (mine.offset, mine.shape, mine.dtype, mine.size) == (
            ref.offset, ref.shape, ref.dtype, ref.size)
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flat))
    np.testing.assert_array_equal(
        flat_from_numpy(np.asarray(j_flat), layout, device=CPU).numpy(), flat.numpy())
    back = packing.unpack(flat, layout)
    for (path, leaf), (_, ref) in zip(packing.tree_leaves(back),
                                      packing.tree_leaves(tree)):
        np.testing.assert_array_equal(leaf.numpy(), ref, err_msg=str(path))
    np.testing.assert_array_equal(packing.pack_like(back, layout).numpy(), flat.numpy())


def test_flat_layout_of_a_tree_with_lists_matches_reference():
    """List-valued trees (a patterned model's ``pblocks`` / ``tail``) flatten
    in ``jax.tree_util``'s order -- dict keys sorted, list items by index --
    so the port's buffer is the reference's column for column, and unpack
    gives the lists back; a dict tree's layout is the one it always had."""
    rng = np.random.default_rng(1)
    one = _jax_init()
    tree = _stack({"pblocks": [one, {"z": one["fc2"]}], "a": one["fc1"]}, 4, rng)
    j_flat, j_layout = j_packing.pack(jax.tree_util.tree_map(jnp.asarray, tree))
    flat, layout = packing.pack(params_from_numpy(tree, device=CPU))
    assert layout.paths[:2] == (("a", "b"), ("a", "w"))
    assert layout.paths[2] == ("pblocks", 0, "fc1", "b")
    assert layout.paths[-1] == ("pblocks", 1, "z", "w")
    assert [s.offset for s in layout.leaves] == [s.offset for s in j_layout.leaves]
    np.testing.assert_array_equal(flat.numpy(), np.asarray(j_flat))
    back = packing.unpack(flat, layout)
    assert isinstance(back["pblocks"], list) and len(back["pblocks"]) == 2
    assert set(back["pblocks"][1]) == {"z"}
    np.testing.assert_array_equal(back["pblocks"][1]["z"]["w"].numpy(),
                                  tree["pblocks"][1]["z"]["w"])
    dict_tree = params_from_numpy(_stack(one, 3, rng), device=CPU)
    items = packing.tree_leaves(dict_tree)
    rebuilt = packing.tree_unflatten(tuple(p for p, _ in items), [v for _, v in items])
    assert rebuilt.keys() == dict_tree.keys() and rebuilt["fc1"].keys() == {"b", "w"}
    assert all(rebuilt[a][b] is dict_tree[a][b] for a in rebuilt for b in rebuilt[a])


@pytest.mark.parametrize("used,pad,chunk", [(1442, 512, 512), (1442, 512, 128),
                                            (1442, 1, 0), (100, 32, 32),
                                            (4096, 256, 64)])
def test_flat_wire_bytes_matches_reference(used, pad, chunk):
    tree = {"p": np.zeros((3, used), np.float32)}
    _, j_layout = j_packing.pack({"p": jnp.zeros((3, used))}, pad_to=pad)
    layout = packing.pack_layout(params_from_numpy(tree, device=CPU), pad_to=pad)
    assert layout.total == j_layout.total
    for degree in (1, 3, 7):
        assert packing.flat_wire_bytes(layout, degree, chunk) == \
            j_packing.flat_wire_bytes(j_layout, degree, chunk)


def test_inv_sqrt_is_float32_division():
    """alpha = float32(0.02) / sqrt(float32(r)) with IEEE rounding, as the
    reference writes it (evaluated eagerly, so no rsqrt rewrite)."""
    f, jf = schedules.inv_sqrt(0.02), j_schedules.inv_sqrt(0.02)
    for r in (0, 1, 2, 3, 10, 99, 1000, 12345):
        a = f(r)
        assert a.dtype == np.float32
        assert a == np.float32(0.02) / np.sqrt(np.float32(max(r, 1)))
        assert a == np.float32(jf(jnp.int32(r)))
    assert schedules.constant(0.05)(7) == np.float32(0.05)


@pytest.mark.parametrize("class_weight", ["balanced", None])
def test_mlp_loss_grads_and_accuracy_match_reference(class_weight):
    """Loss and per-node gradients of the node-batched port against the
    reference's vmap(value_and_grad) at the reference's init (carried
    across by ``convert``), within 1e-6; the accuracies exactly."""
    rng = np.random.default_rng(1)
    n = 20
    tree = _stack(_jax_init(), n, rng)
    data = ehr.generate_ehr_cohort(seed=0)
    batch = next(ehr.make_node_batcher(data, m=20, seed=1))

    cw = class_weights(class_weight)
    np.testing.assert_array_equal(
        np.asarray(cw) if cw is not None else 0,
        np.asarray(j_class_weights(class_weight)) if cw is not None else 0)
    j_loss = jax.vmap(jax.value_and_grad(j_mlp.make_mlp_loss(j_class_weights(class_weight))))
    j_vals, j_grads = j_loss(jax.tree_util.tree_map(jnp.asarray, tree),
                             {k: jnp.asarray(v) for k, v in batch.items()})

    params = params_from_numpy(tree, device=CPU)
    for _, leaf in packing.tree_leaves(params):
        leaf.requires_grad_(True)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    losses = mlp.make_mlp_loss(cw)(params, tb)
    assert losses.shape == (n,)
    grads = torch.autograd.grad(losses.sum(), [l for _, l in packing.tree_leaves(params)])
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(j_vals), atol=1e-6)
    for g, (path, jg) in zip(grads, packing.tree_leaves(
            jax.tree_util.tree_map(np.asarray, j_grads))):
        np.testing.assert_allclose(g.numpy(), jg, atol=1e-6, err_msg=str(path))

    single = _jax_init()
    xall = np.concatenate(data.features)
    yall = np.concatenate(data.labels)
    jp = jax.tree_util.tree_map(jnp.asarray, single)
    tp = params_from_numpy(single, device=CPU)
    tx, ty = torch.as_tensor(xall), torch.as_tensor(yall)
    assert float(mlp.mlp_balanced_accuracy(tp, tx, ty)) == float(
        j_mlp.mlp_balanced_accuracy(jp, jnp.asarray(xall), jnp.asarray(yall)))
    assert float(mlp.mlp_accuracy(tp, tx, ty)) == float(
        j_mlp.mlp_accuracy(jp, jnp.asarray(xall), jnp.asarray(yall)))


def test_port_init_is_seeded_and_shaped_like_reference():
    a, b = mlp.mlp_init(0, device=CPU), mlp.mlp_init(0, device=CPU)
    ref = _jax_init()
    for (pa, la), (_, lb), (pr, lr) in zip(packing.tree_leaves(a),
                                           packing.tree_leaves(b),
                                           packing.tree_leaves(ref)):
        assert pa == pr and tuple(la.shape) == lr.shape and la.dtype == torch.float32
        assert torch.equal(la, lb)
