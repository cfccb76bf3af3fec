"""Expert-parallel MoE and the VLM stack on gloo model groups (the ``tp``
path of ``repro_torch.models.moe``, ``models.transformer`` for the
``moe`` and ``vlm`` families, and the ``tree`` engine on the ``(node,
model)`` layout), through ``launch.mesh.run_group`` and the checks of
``repro_torch.benchmarks.tensor_parallel``:

* three groups, started together: S = 2 (one node rank, two model
  ranks), S = 4, and 2 node ranks x 2 shards;
* on the smoke configs of dbrx-132b (4 experts top-2: 2 experts a rank
  at S = 2, 1 at S = 4), llama4-scout-17b-a16e (4 experts top-1 and the
  shared expert) and internvl2-26b (16 prefix embeddings; the first
  16-position loss chunk is all prefix), fp32 compute: every
  tensor-parallel layer (the MoE layer with its aux loss; a loss chunk
  of prefix positions only) and the whole stack's ``lm_loss``, loss and
  gradients reassembled from the shards, equal the whole layer within
  1e-5 of their scale; the replicated leaves' gradients (``router/w``,
  the norms) are bitwise equal on every rank; the routing is the same on
  every rank and choice for choice the whole model's; the model group
  issues exactly ``expected_collectives``;
* the tensor-parallel ``lm_loss`` and gradients against the reference's
  (``jax.value_and_grad`` of its bundle's ``loss_fn``) on the same numpy
  init: ``tests/test_torch_lm_loss.py``'s tolerances (loss rtol 1e-5,
  gradients 1e-4 of each leaf's scale);
* one FD-DSGT ``tree`` round at Q = 2 on 2 node ranks x 2 shards for
  llama4-scout and internvl2 (a perturbed node-stacked init) against
  the reference's single-device ``TreeEngine`` round on the group's
  mixing matrix and the same batches: the reassembled params within
  1e-5 of their scale, ``loss`` / ``grad_norm_sq`` / ``consensus_err``
  within rtol 1e-5; and against the port's whole-model round;
* ``shard_params`` and ``rank_bytes`` leaf for leaf at the production
  widths (meta) at 16 model ranks, one expert a rank; the experts a rank
  must be the config's over the group.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import tensor_parallel as tpc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.mixing import mesh_gossip_dense_equivalent  # noqa: E402
from repro_torch.core.packing import tree_leaves  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as moe_mod  # noqa: E402
from repro_torch.models import tensor_parallel as tp_mod  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    model_param_specs,
    rank_bytes,
    shard_params,
    spec_dict,
    unshard_params,
)

ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e", "internvl2-26b"]
ROUND_ARCHS = ["llama4-scout-17b-a16e", "internvl2-26b"]
SHARDS = [2, 4]
B, S, CHUNK = 2, 24, 16  # internvl2: 16 prefix + 24 text positions, the first chunk all prefix
TP_TOL = 1e-5  # the tensor-parallel layer against the whole layer
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4  # tests/test_torch_lm_loss.py's, fp32
ROUND_Q, ROUND_NODES, ROUND_SEQ = 2, 2, 16


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _reference_init(arch):
    """The reference's smoke init (numpy) at fp32 compute."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as jt

    jc = dataclasses.replace(j_get_config(arch, smoke=True), compute_dtype="float32")
    return jc, jax.tree_util.tree_map(np.asarray, jt.init_params(jc, jax.random.key(0)))


def _batch(cfg, lead, seed):
    """Tokens ``lead + (S + 1,)`` and, for a VLM, prefix embeddings."""
    rng = np.random.default_rng(seed)
    seq = ROUND_SEQ if len(lead) > 1 else S
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (seq + 1,)).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(
            size=lead + (cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs():
    """The three groups' results (started together in threads), and the
    reference's losses, gradients and tree rounds computed here
    meanwhile."""
    inits = {arch: _reference_init(arch) for arch in ARCHS}
    batches = {arch: _batch(inits[arch][0], (B,), 1) for arch in ARCHS}
    rng = np.random.default_rng(7)
    import jax

    stacked, round_batches = {}, {}
    for arch in ROUND_ARCHS:
        stacked[arch] = jax.tree_util.tree_map(
            lambda x: np.stack([x + 1e-2 * rng.normal(size=x.shape).astype(x.dtype)
                                for _ in range(ROUND_NODES)]), inits[arch][1])
        round_batches[arch] = _batch(inits[arch][0], (ROUND_Q, ROUND_NODES, 1), 3)

    def lm(arch):
        b = batches[arch]
        return ("lm", dict(arch=arch, params_np=inits[arch][1], tokens=b["tokens"],
                           prefix=b.get("prefix_embeds"), loss_chunk=CHUNK,
                           return_grads=True))

    todo = [("layers", dict(arch=a)) for a in ARCHS] + [lm(a) for a in ARCHS]
    jobs = {s: (s, s, todo) for s in SHARDS}
    jobs["round"] = (4, 2, [("round", dict(
        arch=arch, stacked_np=stacked[arch], batches=round_batches[arch], q=ROUND_Q,
        return_params=True)) for arch in ROUND_ARCHS])
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(mesh.run_group, tpc.cases, world, device="cpu",
                                  model_shards=shards, args=(todo_,))
                   for k, (world, shards, todo_) in jobs.items()}
        reference = _reference_results(inits, batches, stacked, round_batches)
        got = {k: f.result() for k, f in futures.items()}
    names = [f"layers/{a}" for a in ARCHS] + [f"lm/{a}" for a in ARCHS]
    out = {s: dict(zip(names, got[s])) for s in SHARDS}
    out["round"] = dict(zip(ROUND_ARCHS, got["round"]))
    return out, reference


def _reference_results(inits, batches, stacked, round_batches):
    import jax
    import jax.numpy as jnp
    from repro.core import engine as j_engine
    from repro.core import fl as j_fl
    from repro.core.schedules import inv_sqrt as j_inv_sqrt
    from repro.models import build_model as j_build_model

    def j(tree):
        return jax.tree_util.tree_map(jnp.asarray, tree)

    out = {}
    for arch, (jc, tree) in inits.items():
        loss, grads = jax.jit(jax.value_and_grad(j_build_model(jc).loss_fn))(
            j(tree), j(batches[arch]))
        out[arch] = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    for arch in ROUND_ARCHS:
        jc = inits[arch][0]
        cfg = j_fl.FLConfig(algorithm="dsgt", q=ROUND_Q, n_nodes=ROUND_NODES)
        w = mesh_gossip_dense_equivalent({"nodes": ROUND_NODES})
        eng, params = j_engine.TreeEngine.simulated(w, j(stacked[arch]))
        round_fn = jax.jit(j_fl.make_fl_round(j_build_model(jc).loss_fn, None,
                                              j_inv_sqrt(tpc.ALPHA0), cfg, engine=eng))
        state, metrics = round_fn(j_fl.init_fl_state(cfg, params, engine=eng),
                                  j(round_batches[arch]))
        out[("round", arch)] = (jax.tree_util.tree_map(np.asarray, state.params),
                                {k: float(v) for k, v in metrics.items()})
    return out


def _tc(arch):
    return dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")


def _close_to_scale(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(got).max()) > 0, what
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, i) for v in tree]
    return tree[i]


# ---------------------------------------------------------------------------
# the layers and the stack against the whole port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_equals_the_whole_layer(runs, arch, shards):
    errs = runs[0][shards][f"layers/{arch}"]
    names = {k.split("/")[0] for k in errs}
    want = {"column_linear", "row_linear", "all_gather", "embedding", "attention",
            "attention_padded", "swiglu", "chunked_loss"}
    if arch == "internvl2-26b":
        want.add("chunked_loss_prefix")
    else:
        want.add("moe")
        # x, router/w, gate, up, down (+ the shared expert's gate, up, down)
        assert len([k for k in errs if k.startswith("moe/grad")]) == (
            8 if arch == "llama4-scout-17b-a16e" else 5)
    assert names == want
    bad = {k: v for k, v in errs.items() if not v <= TP_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_equal_the_whole_model(runs, arch, shards):
    """The loss and every leaf's reassembled gradient; the replicated
    leaves -- the router's ``router/w`` among them -- bitwise equal on
    every rank; every routing call the same on every rank and, at fp32,
    choice for choice the whole model's."""
    res = runs[0][shards][f"lm/{arch}"]
    assert abs(res["loss"] - res["whole_loss"]) <= TP_TOL * abs(res["whole_loss"])
    paths = [p for p, _ in tree_leaves(build_model(_tc(arch)).param_shapes())]
    assert len(res["grad_errs"]) == len(paths)
    bad = {k: v for k, v in res["grad_errs"].items() if not v <= TP_TOL}
    assert not bad, bad
    assert res["replicated_equal"]
    routing = res["routing"]
    if arch == "internvl2-26b":
        assert routing is None
        return
    cfg = _tc(arch)
    specs = spec_dict(model_param_specs(build_model(cfg).param_shapes()))
    assert specs[("blocks", "moe", "router", "w")] == (None, None, None)
    # the forward and the remat recompute, a layer each
    assert routing["calls"] == 2 * cfg.n_layers and routing["ranks_equal"]
    assert routing["matching"] == routing["choices"] == (
        2 * cfg.n_layers * B * S * cfg.experts_per_token)
    assert routing["flip_margins"] == []


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_group_issues_the_counted_collectives(runs, arch, shards):
    """One forward and backward, remat on, L layers and C loss chunks: an
    all-reduce for the embedding; a dense (VLM) layer 5, an MoE layer 6
    (wo forward and in the recompute, attention's column-parallel input
    backward; the MoE's partial outputs forward, the expert inputs' and
    the combine weights' gradients backward), one more with an all-gather
    forward and one in the recompute where the rank's columns cut a head;
    the loss's hidden state's and 4 a chunk."""
    res = runs[0][shards][f"lm/{arch}"]
    cfg = _tc(arch)
    plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 0,
                             shards)
    cut = int(plan.gather_q or plan.gather_kv)
    per_layer = (6 if cfg.family == "moe" else 5) + cut
    positions = S + (cfg.frontend_seq if cfg.family == "vlm" else 0)
    want = {"all-reduce": 1 + cfg.n_layers * per_layer + 1 + 4 * -(-positions // CHUNK)}
    if cut:
        want["all-gather"] = 2 * cfg.n_layers
    assert res["counts"] == want
    assert res["expected"] == {"all-reduce": want["all-reduce"],
                               "all-gather": want.get("all-gather", 0)}
    assert cut == (shards == 4)  # 4 q / 2 kv heads: half a kv head a rank at S = 4


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_the_reference(runs, arch, shards):
    res = runs[0][shards][f"lm/{arch}"]
    want_loss, want_grads = runs[1][arch]
    assert abs(res["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss)
    want = model_params_from_numpy(want_grads, _tc(arch), "cpu")
    got = dict(tree_leaves(params_from_numpy(res["grads"], "cpu")))
    for path, w in tree_leaves(want):
        _close_to_scale(got[path].numpy(), w.numpy(), GRAD_TOL, path)


@pytest.mark.parametrize("arch", ROUND_ARCHS)
def test_tree_round_on_two_by_two_matches_the_reference(runs, arch):
    res = runs[0]["round"][arch]
    want_params, want_m = runs[1][("round", arch)]
    cfg = _tc(arch)
    got = dict(tree_leaves(params_from_numpy(res["params"], "cpu")))
    for i in range(ROUND_NODES):
        node = model_params_from_numpy(_index(want_params, i), cfg, "cpu")
        for path, w in tree_leaves(node):
            _close_to_scale(got[path][i].numpy(), w.numpy(), 1e-5, (i, path))
    m = res["metrics"]
    for key in ("loss", "grad_norm_sq", "consensus_err", "local_loss", "alpha"):
        np.testing.assert_allclose(m[key], want_m[key], rtol=1e-5, err_msg=key)
    assert res["replicated_equal"] and res["rows"] == [0]


@pytest.mark.parametrize("arch", ROUND_ARCHS)
def test_tree_round_on_two_by_two_matches_the_whole_port(runs, arch):
    res = runs[0]["round"][arch]
    m, w = res["metrics"], res["whole_metrics"]
    for key in ("loss", "grad_norm_sq", "consensus_err", "local_loss"):
        np.testing.assert_allclose(m[key], w[key], rtol=1e-5, err_msg=key)
    bad = {k: v for k, v in res["param_errs"].items() if not v <= 1e-5}
    assert not bad, bad


# ---------------------------------------------------------------------------
# placement at the production widths, and the experts a rank
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_and_rank_bytes_leaf_for_leaf_at_sixteen_ranks(arch):
    """At the production widths on meta, 16 shards: each placed leaf's
    bytes are ``rank_bytes`` of that leaf, the experts one a rank (E =
    16), the router whole; on a smoke init the shards put back together
    are the whole tree bitwise."""
    cfg = get_config(arch)
    params = build_model(cfg).param_shapes()
    specs = spec_dict(model_param_specs(params))
    for shard in (0, 15):
        placed = dict(tree_leaves(shard_params(params, shard, 16)))
        for path, whole in tree_leaves(params):
            leaf = placed[path]
            assert leaf.numel() * leaf.element_size() == rank_bytes(
                {"x": whole}, {"x": specs[path]}, {"model": 16}), path
        if cfg.family == "moe":
            for name in ("gate", "up", "down"):
                assert placed[("blocks", "moe", name)].shape[1] == cfg.n_experts // 16 == 1
            assert placed[("blocks", "moe", "router", "w")].shape == (
                cfg.n_layers, cfg.d_model, cfg.n_experts)
    assert rank_bytes(params, model_param_specs(params), {"model": 16}) == sum(
        t.numel() * t.element_size() for _, t in tree_leaves(shard_params(params, 0, 16)))
    small = build_model(get_config(arch, smoke=True)).init_fn(
        torch.Generator().manual_seed(0), device="cpu")
    back = unshard_params([shard_params(small, s, 4) for s in range(4)],
                          model_param_specs(small))
    for (path, a), (_, b) in zip(tree_leaves(back), tree_leaves(small)):
        assert torch.equal(a, b), path


def test_a_rank_must_hold_its_share_of_the_experts():
    cfg = get_config("dbrx-132b", smoke=True)
    p = moe_mod.moe_init(torch.Generator().manual_seed(0), cfg.d_model, cfg.d_ff,
                         cfg.n_experts)
    x = torch.randn(1, 8, cfg.d_model)
    whole = tp_mod.TPGroup(None, 0, 2)  # the whole expert stack on a rank of 2
    with pytest.raises(ValueError, match="4 experts a rank over 2 ranks"):
        moe_mod.moe_apply(p, x, n_experts=cfg.n_experts, k=cfg.experts_per_token,
                          compute_dtype=torch.float32, tp=whole)
