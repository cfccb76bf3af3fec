"""The recurrent and audio families on gloo model groups (the ``tp``
paths of ``repro_torch.models.rwkv6``, ``models.rglru``,
``models.encdec``, ``layers.gelu_mlp`` and cross-attention, the paired
``in_proj`` cut of ``models.sharding``, and the ``tree`` engine on the
``(node, model)`` layout), through ``launch.mesh.run_group`` and the
checks of ``repro_torch.benchmarks.tensor_parallel``:

* three groups, started together: S = 2 (one node rank, two model
  ranks), S = 4, and 2 node ranks x 2 shards;
* on the smoke configs of rwkv6-7b (4 heads: 2 a rank at S = 2, 1 at
  S = 4), recurrentgemma-2b (an RG-LRU block of 256 channels and a local
  attention block of 4 q / 1 kv heads, window 64, run at 72 positions so
  that the window bites) and whisper-medium (2 encoder + 2 decoder
  layers over 32 frames), fp32 compute: every tensor-parallel layer --
  RWKV6's time and channel mix, the RG-LRU block, the GELU MLP,
  cross-attention (on 4 heads, and on 3 that every rank's columns cut),
  whisper's encoder attention -- equals the whole layer within 1e-5 of
  its scale, output and every gradient reassembled (a key projection's
  bias without RoPE, whose exact gradient is zero, at its block's value
  bias's scale), each replicated leaf's gradient bitwise equal on every
  rank; the whole stack's ``lm_loss`` / ``encdec_loss`` within 1e-5 and
  its gradients within 1e-5 (RWKV6's within ``RWKV_TP_GRAD_TOL``, the
  2e-3 it is held to against the reference: its fp32 gradients move up
  to 1e-3 of their scale when one input moves by one ulp,
  :func:`test_rwkv6_fp32_gradients_move_under_one_ulp`, and the group's
  row-parallel sums round in another order); the model group issues
  exactly ``expected_collectives``, as ``launch.op_analysis`` counts
  them;
* the tensor-parallel loss and gradients against the reference's
  (``jax.value_and_grad`` of its bundle's ``loss_fn``) on the same numpy
  init: ``tests/test_torch_lm_loss.py``'s tolerances (loss rtol 1e-5,
  gradients 1e-4 of each leaf's scale, RWKV6's ``RWKV_FP32_GRAD_TOL``
  2e-3);
* one FD-DSGT ``tree`` round at Q = 2 on 2 node ranks x 2 shards for
  each arch (a perturbed node-stacked init) against the reference's
  single-device ``TreeEngine`` round on the group's mixing matrix and
  the same batches, and against the port's whole-model round;
* the paired cut of RG-LRU's ``in_proj`` (each half's columns, on
  layer- and node-stacked leaves too) and ``shard_params`` /
  ``rank_bytes`` leaf for leaf at the production widths (meta) at 16
  model ranks.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import tensor_parallel as tpc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.fl import tree_map  # noqa: E402
from repro_torch.core.mixing import mesh_gossip_dense_equivalent  # noqa: E402
from repro_torch.core.packing import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    model_param_specs,
    rank_bytes,
    shard_params,
    spec_dict,
    stacked_param_specs,
    unshard_params,
)
from repro_torch.training.trainer import stack_for_nodes  # noqa: E402

ARCHS = ["rwkv6-7b", "recurrentgemma-2b", "whisper-medium"]
SHARDS = [2, 4]
B, CHUNK = 2, 16
#: the positions of the loss (recurrentgemma past its window of 64)
SEQ = {"rwkv6-7b": 24, "recurrentgemma-2b": 72, "whisper-medium": 24}
TP_TOL = 1e-5  # the tensor-parallel layer and stack against the whole
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4  # tests/test_torch_lm_loss.py's, fp32
RWKV_FP32_GRAD_TOL = 2e-3  # tests/test_torch_lm_loss.py's
#: RWKV6's stack gradients against the whole model's (see the docstring)
RWKV_TP_GRAD_TOL = RWKV_FP32_GRAD_TOL
ROUND_Q, ROUND_NODES = 2, 2


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _reference_init(arch):
    """The reference's smoke init (numpy) at fp32 compute."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model

    jc = dataclasses.replace(j_get_config(arch, smoke=True), compute_dtype="float32")
    return jc, jax.tree_util.tree_map(np.asarray, j_build_model(jc).init_fn(
        jax.random.key(0)))


def _batch(cfg, arch, lead, seed):
    """Tokens ``lead + (SEQ + 1,)`` and, for whisper, frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, lead + (SEQ[arch] + 1,)).astype(np.int32)}
    if cfg.family == "audio":
        e = cfg.encoder
        out["frames"] = rng.normal(size=lead + (e.seq_len, e.d_model)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def runs():
    """The three groups' results (started together in threads), and the
    reference's losses, gradients and tree rounds computed here
    meanwhile."""
    inits = {arch: _reference_init(arch) for arch in ARCHS}
    batches = {arch: _batch(inits[arch][0], arch, (B,), 1) for arch in ARCHS}
    rng = np.random.default_rng(7)
    import jax

    stacked, round_batches = {}, {}
    for arch in ARCHS:
        stacked[arch] = jax.tree_util.tree_map(
            lambda x: np.stack([x + 1e-2 * rng.normal(size=x.shape).astype(x.dtype)
                                for _ in range(ROUND_NODES)]), inits[arch][1])
        round_batches[arch] = _batch(inits[arch][0], arch, (ROUND_Q, ROUND_NODES, 1), 3)

    def lm(arch):
        b = batches[arch]
        return ("lm", dict(arch=arch, params_np=inits[arch][1], tokens=b["tokens"],
                           frames=b.get("frames"), loss_chunk=CHUNK, return_grads=True))

    todo = [("layers", dict(arch=a)) for a in ARCHS] + [lm(a) for a in ARCHS]
    jobs = {s: (s, s, todo) for s in SHARDS}
    jobs["round"] = (4, 2, [("round", dict(
        arch=arch, stacked_np=stacked[arch], batches=round_batches[arch], q=ROUND_Q,
        return_params=True)) for arch in ARCHS])
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(mesh.run_group, tpc.cases, world, device="cpu",
                                  model_shards=shards, args=(todo_,))
                   for k, (world, shards, todo_) in jobs.items()}
        reference = _reference_results(inits, batches, stacked, round_batches)
        got = {k: f.result() for k, f in futures.items()}
    names = [f"layers/{a}" for a in ARCHS] + [f"lm/{a}" for a in ARCHS]
    out = {s: dict(zip(names, got[s])) for s in SHARDS}
    out["round"] = dict(zip(ARCHS, got["round"]))
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


def _close_to_scale(got, want, tol, what, scale_of=None):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want if scale_of is None else np.asarray(scale_of)).max())
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

LAYERS = {
    "rwkv6-7b": {"rwkv_time_mix", "rwkv_channel_mix"},
    "recurrentgemma-2b": {"rglru", "attention", "attention_padded", "swiglu"},
    "whisper-medium": {"encoder_attention", "attention", "cross_attention",
                       "cross_attention_cut", "gelu_mlp"},
}
#: every leaf of each layer's tree, and its inputs (x; cross-attention's
#: encoder output too)
GRADS = {"rwkv_time_mix": 1 + 15, "rwkv_channel_mix": 1 + 3, "rglru": 1 + 11,
         "cross_attention": 2 + 7, "cross_attention_cut": 2 + 7, "gelu_mlp": 1 + 4}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_equals_the_whole_layer(runs, arch, shards):
    """Each layer's output and every gradient (the inputs', every leaf's)
    within 1e-5; each replicated leaf's gradient bitwise the same on every
    rank (``<layer>/replicated_differs`` 0)."""
    errs = runs[0][shards][f"layers/{arch}"]
    names = {k.split("/")[0] for k in errs}
    assert names == {"column_linear", "row_linear", "all_gather", "embedding",
                     "chunked_loss"} | LAYERS[arch]
    for name, n in GRADS.items():
        if name in LAYERS[arch]:
            assert len([k for k in errs if k.startswith(f"{name}/grad")]) == n, name
            assert errs[f"{name}/replicated_differs"] == 0.0, name
    bad = {k: v for k, v in errs.items() if not v <= TP_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_equal_the_whole_model(runs, arch, shards):
    """The loss and every leaf's reassembled gradient; the replicated
    leaves -- RWKV6's ``u``, ``ln_scale``, lerps and decay LoRA,
    RG-LRU's ``lam`` and ``conv_b``, the norms and position tables --
    bitwise equal on every rank."""
    res = runs[0][shards][f"lm/{arch}"]
    assert abs(res["loss"] - res["whole_loss"]) <= TP_TOL * abs(res["whole_loss"])
    paths = [p for p, _ in tree_leaves(build_model(_tc(arch)).param_shapes())]
    assert len(res["grad_errs"]) == len(paths)
    tol = RWKV_TP_GRAD_TOL if arch == "rwkv6-7b" else TP_TOL
    bad = {k: v for k, v in res["grad_errs"].items() if not v <= tol}
    assert not bad, bad
    assert res["replicated_equal"]


def test_rwkv6_fp32_gradients_move_under_one_ulp():
    """Why RWKV6's stack gradients are held at ``RWKV_TP_GRAD_TOL`` and not
    1e-5: the whole model's own fp32 gradients (no group) move by a
    quarter of it and more when the embedding table moves by one ulp --
    the rounding of a row-parallel sum, which the group adds in every
    layer, is of that size. (Its layers alone hold 1e-5 on the group.)"""
    cfg = _tc("rwkv6-7b")
    params = build_model(cfg).init_fn(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, SEQ["rwkv6-7b"] + 1),
                           generator=torch.Generator().manual_seed(1))

    def grads(p):
        items = tree_leaves(p)
        leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
        loss = tfm.lm_loss(tree_unflatten(tuple(q for q, _ in items), leaves), cfg,
                           {"tokens": tokens}, loss_chunk=CHUNK)
        return dict(zip([q for q, _ in items], torch.autograd.grad(loss, leaves)))

    a = grads(params)
    b = grads({**params, "embed": {"table": params["embed"]["table"] * (1 + 2 ** -23)}})
    moved = max(float((a[k] - b[k]).abs().max() / a[k].abs().max()) for k in a)
    assert moved > RWKV_TP_GRAD_TOL / 4


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_group_issues_the_counted_collectives(runs, arch, shards):
    """One forward and backward, remat on, L layers and C loss chunks: the
    embedding's all-reduce, the loss's hidden state's and 4 a chunk; an
    RWKV6 layer 5 all-reduces (the time mix's ``wo`` forward and in the
    recompute and its stacked lerps' gradient, the channel mix's ``wv``
    and its input's gradient) and 3 all-gathers (the decay's, ``u``'s and
    ``ln_scale``'s gradients); an RG-LRU block 6 (its gather's gradient,
    ``out_proj`` twice, its input's gradient, the SwiGLU's two) and 4 (the
    gather of u twice, ``lam``'s and ``conv_b``'s gradients); a local
    attention block 5, and one more with 2 all-gathers where its 1 kv head
    is cut (at S = 2 and 4); whisper (no cut heads: 4 over 2 and 4 ranks)
    an encoder layer 4, a decoder layer 8, the encoder output's copy 1."""
    res = runs[0][shards][f"lm/{arch}"]
    cfg = _tc(arch)
    chunks = -(-SEQ[arch] // CHUNK)
    tail = 1 + 1 + 4 * chunks
    if arch == "rwkv6-7b":
        ar, ag = tail + 5 * cfg.n_layers, 3 * cfg.n_layers
    elif arch == "recurrentgemma-2b":
        ar, ag = tail + 6 + 5 + 1, 4 + 2
    else:
        ar, ag = tail + 4 * cfg.encoder.n_layers + 8 * cfg.n_layers + 1, 0
    assert res["counts"] == {k: v for k, v in (("all-reduce", ar), ("all-gather", ag)) if v}
    assert res["expected"] == {"all-reduce": ar, "all-gather": ag}
    assert res["expected_launches"] == tpc.expected_launches(cfg)
    # the CPU runs the kernels' twins: no launch
    assert all(v == [0] * shards for v in res["launches"].values())


def test_the_kernels_launch_on_the_ranks_share():
    """The launches a rank under remat: the WKV-6 kernel twice an RWKV6
    layer, the RG-LRU scan twice a recurrent block, flash twice a
    decoder attention block -- and, in whisper, once an encoder layer and
    four times a decoder layer (self- and cross-attention)."""
    want = {"rwkv6-7b": (0, 64, 0), "recurrentgemma-2b": (16, 0, 36),
            "whisper-medium": (24 + 4 * 24, 0, 0)}
    for arch, (flash, wkv, rglru) in want.items():
        got = tpc.expected_launches(get_config(arch))
        assert got == {"flash_attention": flash, "wkv6": wkv, "rglru_scan": rglru}, arch


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(runs, arch, shards):
    res = runs[0][shards][f"lm/{arch}"]
    want_loss, want_grads = runs[1][arch]
    assert abs(res["loss"] - want_loss) <= LOSS_RTOL * abs(want_loss)
    want = dict(tree_leaves(model_params_from_numpy(want_grads, _tc(arch), "cpu")))
    got = dict(tree_leaves(params_from_numpy(res["grads"], "cpu")))
    tol = RWKV_FP32_GRAD_TOL if arch == "rwkv6-7b" else GRAD_TOL
    for path, w in want.items():
        scale_of = None
        if arch == "whisper-medium" and path[-2:] == ("wk", "b"):
            scale_of = want[path[:-2] + ("wv", "b")].numpy()
        _close_to_scale(got[path].numpy(), w.numpy(), tol, path, scale_of)


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_round_on_two_by_two_matches_the_reference(runs, arch):
    res = runs[0]["round"][arch]
    want_params, want_m = runs[1][("round", arch)]
    cfg = _tc(arch)
    tol = RWKV_FP32_GRAD_TOL if arch == "rwkv6-7b" else 1e-5
    got = dict(tree_leaves(params_from_numpy(res["params"], "cpu")))
    for i in range(ROUND_NODES):
        node = model_params_from_numpy(_index(want_params, i), cfg, "cpu")
        for path, w in tree_leaves(node):
            _close_to_scale(got[path][i].numpy(), w.numpy(), tol, (i, path))
    m = res["metrics"]
    for key in ("loss", "grad_norm_sq", "consensus_err", "local_loss", "alpha"):
        np.testing.assert_allclose(m[key], want_m[key], rtol=tol, err_msg=key)
    assert res["replicated_equal"] and res["rows"] == [0]


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_round_on_two_by_two_matches_the_whole_port(runs, arch):
    res = runs[0]["round"][arch]
    m, w = res["metrics"], res["whole_metrics"]
    tol = RWKV_TP_GRAD_TOL if arch == "rwkv6-7b" else 1e-5
    for key in ("loss", "grad_norm_sq", "consensus_err", "local_loss"):
        np.testing.assert_allclose(m[key], w[key], rtol=tol, err_msg=key)
    bad = {k: v for k, v in res["param_errs"].items() if not v <= tol}
    assert not bad, bad


# ---------------------------------------------------------------------------
# placement: the paired cut, and the production widths
# ---------------------------------------------------------------------------


def test_in_proj_is_cut_in_pairs():
    """RG-LRU's ``in_proj`` (d, 2W) = [u | gate]: shard s of S holds the
    columns [s W/S, (s+1) W/S) of each half side by side -- on a layer's
    leaf, on the layer-stacked ``pblocks`` and ``tail`` leaves of a
    patterned stack and on the node-stacked state the tree engine places
    -- and the shards put back together are the whole bitwise."""
    cfg = dataclasses.replace(_tc("recurrentgemma-2b"), n_layers=5)  # 2 periods + a tail
    params = build_model(cfg).init_fn(torch.Generator().manual_seed(0), device="cpu")
    assert "pblocks" in params and params["tail"]
    w = params["pblocks"][0]["rglru"]["in_proj"]["w"]  # (periods, d, 2W)
    half = w.shape[-1] // 2
    for shards in (2, 4):
        cut = half // shards
        for s in range(shards):
            mine = shard_params(params, s, shards)
            want = torch.cat([w[..., s * cut:(s + 1) * cut],
                              w[..., half + s * cut:half + (s + 1) * cut]], dim=-1)
            assert torch.equal(mine["pblocks"][0]["rglru"]["in_proj"]["w"], want)
            b = params["tail"][0]["rglru"]["in_proj"]["b"]
            assert torch.equal(mine["tail"][0]["rglru"]["in_proj"]["b"], torch.cat(
                [b[s * cut:(s + 1) * cut], b[half + s * cut:half + (s + 1) * cut]]))
        back = unshard_params([shard_params(params, s, shards) for s in range(shards)],
                              model_param_specs(params))
        for (path, a), (_, b) in zip(tree_leaves(back), tree_leaves(params)):
            assert torch.equal(a, b), path
    stacked = stack_for_nodes(params, 2, perturb=0.1,
                              generator=torch.Generator().manual_seed(1))
    placed = shard_params(stacked, 1, 2, stacked_param_specs(stacked))
    for node in range(2):
        one = shard_params(tree_map(lambda a, n=node: a[n], stacked), 1, 2)
        for (path, a), (_, b) in zip(tree_leaves(placed), tree_leaves(one)):
            assert torch.equal(a[node], b), path
    with pytest.raises(ValueError, match="in each half"):
        shard_params({"in_proj": {"b": torch.zeros(12)}}, 0, 4, {"in_proj": {"b": ("model",)}})


@pytest.mark.parametrize("arch", ARCHS)
def test_shards_and_rank_bytes_leaf_for_leaf_at_sixteen_ranks(arch):
    """At the production widths on meta, 16 shards: each placed leaf's
    bytes are ``rank_bytes`` of that leaf (RWKV6's 4 heads a rank, the
    RG-LRU's 160 channels a rank of each ``in_proj`` half, whisper's one
    head a rank and 3,248 vocab rows); on a smoke init the shards put back
    together are the whole tree bitwise."""
    cfg = get_config(arch)
    params = build_model(cfg).param_shapes()
    specs = spec_dict(model_param_specs(params))
    for shard in (0, 15):
        placed = dict(tree_leaves(shard_params(params, shard, 16)))
        for path, whole in tree_leaves(params):
            leaf = placed[path]
            assert leaf.numel() * leaf.element_size() == rank_bytes(
                {"x": whole}, {"x": specs[path]}, {"model": 16}), path
    assert rank_bytes(params, model_param_specs(params), {"model": 16}) == sum(
        t.numel() * t.element_size() for _, t in tree_leaves(shard_params(params, 0, 16)))
    placed = dict(tree_leaves(shard_params(params, 0, 16)))
    if arch == "rwkv6-7b":
        assert placed[("blocks", "rwkv", "time", "wr", "w")].shape[-1] == 4 * 64
        assert placed[("blocks", "rwkv", "time", "u")].shape == (cfg.n_layers, 64, 64)
    elif arch == "recurrentgemma-2b":
        assert placed[("pblocks", 0, "rglru", "in_proj", "w")].shape[-1] == 2 * 160
        assert placed[("pblocks", 0, "rglru", "lam")].shape[-1] == 2560
    else:
        assert placed[("dec", "embed", "table")].shape[0] == 3248
        assert placed[("dec", "blocks", "cross_attn", "wq", "w")].shape[-1] == 64
    small = build_model(get_config(arch, smoke=True)).init_fn(
        torch.Generator().manual_seed(0), device="cpu")
    back = unshard_params([shard_params(small, s, 4) for s in range(4)],
                          model_param_specs(small))
    for (path, a), (_, b) in zip(tree_leaves(back), tree_leaves(small)):
        assert torch.equal(a, b), path
