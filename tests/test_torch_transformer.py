"""The decoder stack of the PyTorch port (``repro_torch.models.transformer``
and ``models.model``) against ``repro.models.transformer`` on the smoke
SmolLM-360M and TinyLlama-1.1B configs (2 layers, width 192 / 256), the
smoke RWKV6-7B (2 ``rwkv`` layers, width 256) and RecurrentGemma-2B (a
``recurrent`` and a ``local_attention`` layer: the per-layer ``blocks``
list) configs, and a narrow patterned stack of 8 layers of (recurrent,
recurrent, local_attention) -- two layer-stacked periods (``pblocks``)
and a two-layer ``tail`` -- with a window of 8 that the decode wraps;
from the reference's own ``init_params`` carried over by
``repro_torch.convert``.

Tolerances on the logits, each relative to max(1, max|logit|):
* fp32 compute (``dataclasses.replace(cfg, compute_dtype="float32")``):
  1e-4 -- the same fp32 function summed in another order; the KV cache
  is bf16 on both sides (the reference's default), and a K/V value an
  ulp apart can round to a neighbouring bf16 there.
* bf16 compute: 4e-2 -- every product, q/k/v and the attention output
  are rounded to bf16 on both sides, and the reference's ``ref`` path
  also rounds the softmax probabilities to bf16 (the port keeps them in
  fp32, as the reference's kernels do).
* the port's own decode replay against its prefill: 1e-2 at fp32 (the
  cache rounds K/V to bf16, prefill does not), 5e-2 at bf16 with the
  same argmax (the reference suite's test_decode_logits_match_prefill).
* the recurrent stacks (``test_recurrent_*``), whose fp32 runs keep
  fp32 KV caches on both sides, so that no cache entry sits on a bf16
  rounding boundary: logits and states 1e-4 at fp32 (observed up to
  3.8e-5, at RWKV6's first step, see below). At bf16 (bf16 caches, the
  default): states 1e-1 (the bf16 residual stream drifts by an ulp or
  two a layer; observed up to 5.8e-2 at the 8th layer) and logits 4e-2,
  but 2e-1 for RWKV6: at its first decode step a head's WKV output is
  rank one, (r . (u * k)) v, and the per-head RMS norm (eps 1e-5)
  divides by |r . (u * k)| rms(v), so where that bonus is near 0 one
  bf16 ulp of r or k moves the normalized output by up to its own size
  (observed 0.13 at step 0, 4.1e-2 at step 1, 1.5e-2 from step 2 on).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

ARCHS = ["smollm-360m", "tinyllama-1.1b"]
TOL = {"float32": 1e-4, "bfloat16": 4e-2}
B, P, MAX_SEQ = 2, 10, 32


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _models(arch, dtype):
    jc = dataclasses.replace(j_get_config(arch, smoke=True), compute_dtype=dtype)
    tc = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=dtype)
    jp = jt.init_params(jc, jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _prompt(cfg):
    rng = np.random.default_rng(1)
    return rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _port_replay(tc, tp, toks):
    caches = tt.init_decode_state(tc, B, MAX_SEQ, device="cpu")
    logits = []
    for t in range(toks.shape[1]):
        lg, caches = tt.decode_step(tp, tc, torch.tensor(toks[:, t], dtype=torch.long),
                                    caches)
        logits.append(lg)
    return logits, caches


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    jc, tc, jp, tp = _models(arch, dtype)
    toks = _prompt(jc)
    got, got_h = tt.prefill(tp, tc, {"tokens": torch.tensor(toks, dtype=torch.long)})
    assert got.shape == (B, tc.padded_vocab) and got.dtype == getattr(torch, dtype)
    for impl in ("ref", "flash"):
        want, want_h = jax.jit(lambda p, t, impl=impl: jt.prefill(p, jc, t, impl=impl))(
            jp, {"tokens": jnp.asarray(toks)})
        _close(got, want, TOL[dtype])
        _close(got_h, want_h, TOL[dtype])

    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    jcache = jt.init_decode_state(jc, B, MAX_SEQ)
    logits, tcache = _port_replay(tc, tp, toks)
    for t in range(P):
        want, jcache = step(jp, jnp.asarray(toks[:, t]), jcache)
        _close(logits[t], want, TOL[dtype])
    assert tcache["k"].shape == (tc.n_layers, B, MAX_SEQ, tc.n_kv_heads, tc.head_dim)
    assert tcache["k"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    _close(tcache["k"], jcache["k"], TOL["bfloat16"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_replay_matches_prefill(arch, dtype):
    """Stepping the prompt through the cached decode path reproduces the
    full-sequence prefill logits at the last position, through the
    bundle's own functions."""
    tc = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=dtype)
    bundle = build_model(tc)
    params = bundle.init_fn(torch.Generator().manual_seed(0), device="cpu")
    toks = _prompt(tc)
    pre, _ = bundle.prefill_fn(params, {"tokens": torch.tensor(toks, dtype=torch.long)})
    caches = bundle.init_decode_state_fn(B, MAX_SEQ, device="cpu")
    for t in range(P):
        logits, caches = bundle.decode_fn(params, torch.tensor(toks[:, t]), caches)
    _close(logits, pre, 1e-2 if dtype == "float32" else 5e-2)
    assert torch.equal(logits.float().argmax(-1), pre.float().argmax(-1))


def test_sliding_override_uses_a_window_ring_buffer():
    """``sliding_override`` gives every layer a ring buffer of
    min(window, max_seq) slots, and the ring decode equals the
    reference's (smoke SmolLM: window 64, so a 70-step run wraps)."""
    jc, tc, jp, tp = _models("smollm-360m", "float32")
    caches = tt.init_decode_state(tc, 1, 128, sliding_override=True, device="cpu")
    assert caches["k"].shape[2] == 64
    jcache = jt.init_decode_state(jc, 1, 128, sliding_override=True)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c, sliding_override=True))
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, size=(1, 70)).astype(np.int32)
    for t in range(70):
        got, caches = tt.decode_step(tp, tc, torch.tensor(toks[:, t], dtype=torch.long),
                                     caches, sliding_override=True)
        want, jcache = step(jp, jnp.asarray(toks[:, t]), jcache)
    _close(got, want, TOL["float32"])


def test_unported_families_raise():
    """Every family of the reference's registry is ported now (the MoE,
    VLM and enc-dec ones in ``tests/test_torch_model_zoo.py``); what
    still raises is what the reference refuses too: an unknown arch id
    (``KeyError``, the reference's message) and an unknown block kind in
    a pattern (``ValueError``). A ``moe`` layer in a hybrid pattern
    builds, as the reference allows. Training is ported: the bundle's
    node-batched ``loss_fn`` gives one loss a node
    (``tests/test_torch_lm_loss.py`` holds it to the reference)."""
    with pytest.raises(KeyError, match="unknown arch 'gpt-5'"):
        get_config("gpt-5")
    base = get_config("smollm-360m", smoke=True)
    with pytest.raises(ValueError, match="unknown block kind"):
        build_model(dataclasses.replace(base, family="hybrid",
                                        block_pattern=("recurrent", "conv")))
    hybrid = dataclasses.replace(base, family="hybrid", n_experts=4, experts_per_token=1,
                                 block_pattern=("recurrent", "moe"))
    bundle = build_model(hybrid)
    assert "moe" in bundle.param_shapes()["blocks"][1]
    from repro_torch.core.fl import tree_map

    for cfg in (base, hybrid):
        params = build_model(cfg).init_fn(torch.Generator().manual_seed(0), device="cpu")
        losses = build_model(cfg).loss_fn(tree_map(lambda a: a[None], params),
                                          {"tokens": torch.zeros((1, 1, 9), dtype=torch.long)})
        assert losses.shape == (1,) and torch.isfinite(losses).all()


def test_param_shapes_match_the_reference_tree():
    for arch in ARCHS:
        jc = j_get_config(arch, smoke=True)
        want = jax.eval_shape(lambda k: jt.init_params(jc, k), jax.random.key(0))
        got = build_model(get_config(arch, smoke=True)).param_shapes()
        flat_w = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
                  for k, v in jax.tree_util.tree_leaves_with_path(want)}
        flat_g = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
                  for k, v in jax.tree_util.tree_leaves_with_path(got)}
        assert flat_g == flat_w


# ------------------------------------------------------------ recurrent stacks


def _patterned(get):
    """A narrow hybrid with two whole periods and a tail: 8 layers of
    (recurrent, recurrent, local_attention), window 8."""
    return dataclasses.replace(get("recurrentgemma-2b", smoke=True), n_layers=8,
                               block_pattern=("recurrent", "recurrent", "local_attention"),
                               window=8, name="recurrentgemma-patterned")


RECURRENT = {
    "rwkv6-7b": lambda get: get("rwkv6-7b", smoke=True),
    "recurrentgemma-2b": lambda get: get("recurrentgemma-2b", smoke=True),
    "patterned": _patterned,
}


def _rmodels(name, dtype):
    jc = dataclasses.replace(RECURRENT[name](j_get_config), compute_dtype=dtype)
    tc = dataclasses.replace(RECURRENT[name](get_config), compute_dtype=dtype)
    jp = jt.init_params(jc, jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _same_state_tree(got, want, tol):
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    assert [jax.tree_util.keystr(k) for k, _ in flat_g] == \
        [jax.tree_util.keystr(k) for k, _ in flat_w]
    for (path, g), (_, w) in zip(flat_g, flat_w):
        assert str(g.dtype).split(".")[-1] == str(w.dtype), jax.tree_util.keystr(path)
        assert tuple(g.shape) == w.shape, jax.tree_util.keystr(path)
        if g.dtype == torch.int32:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        else:
            _close(g, w, tol)


RECURRENT_TOL = {  # (logits, states) by compute dtype, see the module docstring
    "float32": (1e-4, 1e-4),
    "bfloat16": (4e-2, 1e-1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_prefill_and_decode_match_reference(name, dtype):
    """Prefill against the reference's ``ref`` and ``pallas`` paths, then
    the prompt stepped through ``decode_step`` against the reference's
    decode: the logits at every step, and the whole decode state (its
    layout, dtypes and values) after one, two and all steps."""
    jc, tc, jp, tp = _rmodels(name, dtype)
    logit_tol, state_tol = RECURRENT_TOL[dtype]
    if name == "rwkv6-7b" and dtype == "bfloat16":
        logit_tol = 2e-1
    cache_dtype = "float32" if dtype == "float32" else "bfloat16"
    toks = _prompt(jc)
    got, got_h = tt.prefill(tp, tc, {"tokens": torch.tensor(toks, dtype=torch.long)})
    assert got.shape == (B, tc.padded_vocab) and got.dtype == getattr(torch, dtype)
    for impl in ("ref", "pallas"):
        want, want_h = jax.jit(lambda p, t, impl=impl: jt.prefill(p, jc, t, impl=impl))(
            jp, {"tokens": jnp.asarray(toks)})
        _close(got, want, TOL[dtype])
        _close(got_h, want_h, TOL[dtype])

    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    jcache = jt.init_decode_state(jc, B, MAX_SEQ, cache_dtype=getattr(jnp, cache_dtype))
    tcache = tt.init_decode_state(tc, B, MAX_SEQ, cache_dtype=getattr(torch, cache_dtype),
                                  device="cpu")
    _same_state_tree(tcache, jcache, 0)
    for t in range(P):
        want, jcache = step(jp, jnp.asarray(toks[:, t]), jcache)
        lg, tcache = tt.decode_step(tp, tc, torch.tensor(toks[:, t], dtype=torch.long),
                                    tcache)
        _close(lg, want, logit_tol)
        if t < 2 or t == P - 1:
            _same_state_tree(tcache, jcache, state_tol)


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_decode_replay_matches_prefill(name):
    """Through the bundle's own functions, at bf16: stepping the prompt
    through decode reproduces prefill's last-position logits."""
    tc = RECURRENT[name](get_config)
    bundle = build_model(tc)
    params = bundle.init_fn(torch.Generator().manual_seed(0), device="cpu")
    toks = _prompt(tc)
    pre, _ = bundle.prefill_fn(params, {"tokens": torch.tensor(toks, dtype=torch.long)})
    caches = bundle.init_decode_state_fn(B, MAX_SEQ, device="cpu")
    for t in range(P):
        logits, caches = bundle.decode_fn(params, torch.tensor(toks[:, t]), caches)
    _close(logits, pre, 5e-2)
    assert torch.equal(logits.float().argmax(-1), pre.float().argmax(-1))


@pytest.mark.parametrize("name,layout", [("rwkv6-7b", "blocks"),
                                         ("recurrentgemma-2b", "blocks list"),
                                         ("patterned", "pblocks")])
def test_model_params_from_numpy_on_every_layout(name, layout):
    """The three storage layouts convert leaf for leaf and bit for bit,
    and the port's own init draws the same layout; a leaf of the wrong
    shape is refused by its path (list items by index)."""
    jc, tc, jp, tp = _rmodels(name, "float32")
    if layout == "blocks":
        assert isinstance(tp["blocks"], dict) and tp["blocks"]["ln1"]["scale"].shape[0] == 2
    elif layout == "blocks list":
        assert isinstance(tp["blocks"], list) and len(tp["blocks"]) == tc.n_layers
    else:
        assert len(tp["pblocks"]) == 3 and len(tp["tail"]) == 2 and "blocks" not in tp
        assert tp["pblocks"][2]["attn"]["wq"]["w"].shape[0] == 2
    want = jax.tree_util.tree_leaves_with_path(jp)
    got = jax.tree_util.tree_leaves_with_path(tp)
    assert [jax.tree_util.keystr(k) for k, _ in got] == \
        [jax.tree_util.keystr(k) for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    own = build_model(tc).init_fn(torch.Generator().manual_seed(0), device="cpu")
    assert [jax.tree_util.keystr(k) for k, _ in jax.tree_util.tree_leaves_with_path(own)] \
        == [jax.tree_util.keystr(k) for k, _ in want]

    bad = jax.tree_util.tree_map(np.asarray, jp)
    if layout == "pblocks":
        bad["pblocks"][1]["rglru"]["lam"] = np.zeros((3, 7), np.float32)
        leaf = "pblocks/1/rglru/lam"
    elif layout == "blocks list":
        bad["blocks"][1]["attn"]["wk"]["w"] = np.zeros((1, 1), np.float32)
        leaf = "blocks/1/attn/wk/w"
    else:
        bad["blocks"]["rwkv"]["time"]["u"] = bad["blocks"]["rwkv"]["time"]["u"].astype(
            np.float16)
        leaf = "blocks/rwkv/time/u"
    with pytest.raises(ValueError, match=leaf):
        model_params_from_numpy(bad, tc, "cpu")


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_param_shapes_match_the_reference_tree(name):
    jc = RECURRENT[name](j_get_config)
    want = jax.eval_shape(lambda k: jt.init_params(jc, k), jax.random.key(0))
    got = build_model(RECURRENT[name](get_config)).param_shapes()
    flat_w = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
              for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_g == flat_w


def test_rwkv_prefill_replay_gap_is_the_references():
    """RWKV6's bf16 prefill and decode round differently by design: the
    zero fp32 token-shift carries promote prefill's whole sequence to
    fp32, while decode runs the shift and lerp in bf16 from its second
    step on. On the reference's weights (smoke width, 32 layers, 128
    tokens) the reference's own last-position logits differ between the
    two paths by over 2e-2 of their scale (observed 4.0e-2), and the
    port's by no more than 1.25x the reference's (observed 3.8e-2): the
    gap ``chip_smoke.py`` allows RWKV6-7B's prefill against its replay
    (1e-1) is the reference's semantics, not the kernel's."""
    jc = dataclasses.replace(j_get_config("rwkv6-7b", smoke=True), n_layers=32)
    tc = dataclasses.replace(get_config("rwkv6-7b", smoke=True), n_layers=32)
    jp = jt.init_params(jc, jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    b, s = 4, 128
    toks = np.random.default_rng(0).integers(0, jc.vocab_size, size=(b, s)).astype(np.int32)

    def gap(pre, last):
        pre, last = _np(pre), _np(last)
        return float(np.abs(pre - last).max()) / max(1.0, float(np.abs(pre).max()))

    j_pre, _ = jax.jit(lambda p, t: jt.prefill(p, jc, t))(jp, {"tokens": jnp.asarray(toks)})
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    jcache = jt.init_decode_state(jc, b, s)
    t_pre, _ = tt.prefill(tp, tc, {"tokens": torch.tensor(toks, dtype=torch.long)})
    tcache = tt.init_decode_state(tc, b, s, device="cpu")
    for t in range(s):
        j_last, jcache = step(jp, jnp.asarray(toks[:, t]), jcache)
        t_last, tcache = tt.decode_step(tp, tc, torch.tensor(toks[:, t], dtype=torch.long),
                                        tcache)
    ref_gap, port_gap = gap(j_pre, j_last), gap(t_pre, t_last)
    assert ref_gap > 2e-2
    assert port_gap <= 1.25 * ref_gap
