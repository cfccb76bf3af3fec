"""The port's tensor-parallel rules (``repro_torch.models.sharding``)
against the reference's ``repro.models.sharding``: every leaf's spec of
every registry architecture equals ``tuple(P)`` of the reference's --
smoke configs initialized by the reference and carried into the port by
``repro_torch.convert``, full configs through ``jax.eval_shape`` against
the port's meta init -- and ``node_stack_specs``, ``batch_specs`` and
``rank_bytes`` by hand."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro import configs as j_configs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import sharding as j_sharding  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.packing import tree_leaves  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import sharding  # noqa: E402

ARCHS = list(t_configs.ASSIGNED_ARCHS)


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _key(k):
    return k.key if isinstance(k, jax.tree_util.DictKey) else k.idx


def _ref_specs(specs) -> dict:
    leaves = jax.tree_util.tree_leaves_with_path(
        specs, is_leaf=lambda x: isinstance(x, j_sharding.P))
    return {tuple(_key(k) for k in path): tuple(p) for path, p in leaves}


def _canon(spec) -> tuple:
    """``PartitionSpec`` writes a one-axis tuple as the axis name alone."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e for e in spec)


def _port_specs(specs) -> dict:
    return {path: _canon(s) for path, s in sharding._spec_leaves(specs)}


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_specs_are_the_references(arch):
    jcfg = j_configs.get_config(arch, smoke=True)
    j_params = j_build_model(jcfg).init_fn(jax.random.key(0))
    params = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, j_params),
                                     t_configs.get_config(arch, smoke=True), device="cpu")
    want = _ref_specs(j_sharding.model_param_specs(j_params))
    got = _port_specs(sharding.model_param_specs(params))
    assert got == want
    assert set(got) == {p for p, _ in tree_leaves(params)}


@pytest.mark.parametrize("arch", ARCHS)
def test_full_specs_are_the_references(arch):
    """Full configs: the reference's ``jax.eval_shape`` tree against the
    port's meta init (nothing allocated), every leaf."""
    want = _ref_specs(j_sharding.model_param_specs(
        j_build_model(j_configs.get_config(arch)).param_shapes()))
    got = _port_specs(sharding.model_param_specs(
        build_model(t_configs.get_config(arch)).param_shapes()))
    assert got == want
    # the node-stacked layout prepends the node axes, leaf by leaf
    j_nodes = _ref_specs(j_sharding.node_stack_specs(
        j_sharding.model_param_specs(
            j_build_model(j_configs.get_config(arch)).param_shapes()), ("pod", "data")))
    t_nodes = _port_specs(sharding.node_stack_specs(
        sharding.model_param_specs(build_model(t_configs.get_config(arch)).param_shapes()),
        ("pod", "data")))
    assert t_nodes == j_nodes


def test_batch_specs_are_the_references():
    cfg = t_configs.get_config("internvl2-26b")
    specs = t_configs.train_input_specs(cfg, t_configs.SHAPES["train_4k"], 16, 2)
    j_specs = j_configs.train_input_specs(j_configs.get_config("internvl2-26b"),
                                          j_configs.SHAPES["train_4k"], 16, 2)
    for scan in (True, False):
        want = {k: tuple(v) for k, v in
                j_sharding.batch_specs(j_specs, ("data",), leading_scan=scan).items()}
        got = sharding.batch_specs(specs, ("data",), leading_scan=scan)
        assert {k: _canon(v) for k, v in got.items()} == want
    assert sharding.batch_specs(specs, ("data",))["tokens"] == (None, ("data",), None, None)


def test_rank_bytes_by_hand():
    """A vocab-sharded table, a column-parallel stacked kernel with its
    bias, a replicated norm; fp32 and bf16; a dimension the axis does not
    divide rounds up as a padded shard."""
    params = {
        "embed": {"table": torch.empty(1000, 64, device="meta")},
        "blocks": {"attn": {"wq": {"w": torch.empty(4, 64, 128, device="meta",
                                                      dtype=torch.bfloat16),
                                   "b": torch.empty(4, 128, device="meta")}},
                   "ln1": {"scale": torch.empty(4, 64, device="meta")}},
    }
    specs = sharding.model_param_specs(params)
    assert specs["embed"]["table"] == ("model", None)
    assert specs["blocks"]["attn"]["wq"]["w"] == (None, None, "model")
    assert specs["blocks"]["attn"]["wq"]["b"] == (None, "model")
    assert specs["blocks"]["ln1"]["scale"] == (None, None)
    mesh = {"data": 16, "model": 16}
    want = (4 * (-(-1000 // 16)) * 64 + 2 * 4 * 64 * 8 + 4 * 4 * 8 + 4 * 4 * 64)
    assert sharding.rank_bytes(params, specs, mesh) == want
    # the node-stacked state splits the node axis too: 16 nodes over 16 ranks
    stacked = {"embed": {"table": torch.empty(16, 1000, 64, device="meta")}}
    s_specs = sharding.node_stack_specs(sharding.model_param_specs(
        {"embed": {"table": torch.empty(1000, 64, device="meta")}}), ("data",))
    assert sharding.rank_bytes(stacked, s_specs, mesh) == 4 * 63 * 64
    # a MeshLayout works as the mesh; the multi-pod mesh halves nothing here
    assert (sharding.rank_bytes(params, specs, make_production_mesh(multi_pod=True))
            == sharding.rank_bytes(params, specs, make_test_mesh((2, 16, 16))) == want)


def test_rank_bytes_of_tinyllama_at_sixteen_shards():
    """TinyLlama-1.1B's parameters on the single-pod mesh: the vocab,
    column and row splits leave the norms whole."""
    params = build_model(t_configs.get_config("tinyllama-1.1b")).param_shapes()
    specs = sharding.model_param_specs(params)
    got = sharding.rank_bytes(params, specs, make_production_mesh())
    whole = sum(leaf.numel() * leaf.element_size() for _, leaf in tree_leaves(params))
    norms = sum(leaf.numel() * leaf.element_size() for p, leaf in tree_leaves(params)
                if p[-1] == "scale")
    assert got == (whole - norms) // 16 + norms
