"""GQA attention in the PyTorch port (``repro_torch.models.attention``)
against ``repro.models.attention``: full-sequence ``attn_apply`` and
one-token ``attn_decode`` over a contiguous cache and a ring buffer, with
a padded head layout (``tp_head_pad``), on the same numpy inputs and the
reference's own ``attn_init`` weights.

The port dispatches by device (CPU tensors run the kernels' twins); the
reference runs its ``impl="ref"`` path (``_sdpa``, probabilities cast to
v's dtype) and its Pallas kernels in interpret mode (``impl="flash"`` /
``"decode_kernel"``, probabilities kept in fp32, as the port's).

Tolerances: fp32 compute within 1e-5 against either reference path (the
same fp32 function summed in another order). bf16 compute within 2e-2 x
max|out| against the kernel path and 4e-2 x max|out| against the ``ref``
path: q/k/v, the attention output and the products are each rounded to
bf16 on both sides, and an fp32 difference in the last bits can flip
each rounding; the ``ref`` path also rounds the probabilities to bf16.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import attention as ja  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402

D, HD, THETA = 96, 64, 10000.0
TOL = {("float32", "kernel"): 1e-5, ("float32", "ref"): 1e-5,
       ("bfloat16", "kernel"): 2e-2, ("bfloat16", "ref"): 4e-2}
# (n_heads, n_kv_heads, tp_head_pad): GQA 3 with heads padded 3 -> 4, GQA 2
LAYOUTS = [(3, 1, 4), (4, 2, 0)]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _setup(h, kv, pad, seed=0):
    hl = ja.layout_heads(h, pad)
    jp = ja.attn_init(jax.random.key(seed), D, h, kv, HD, jnp.float32, n_heads_layout=hl)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return hl, jp, tp


def _close(got, want, dtype, path):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    tol = TOL[(dtype, path)] * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_attn_apply_matches_reference(layout, window, dtype):
    h, kv, pad = layout
    hl, jp, tp = _setup(h, kv, pad)
    rng = np.random.default_rng(1)
    b, s = 2, 11
    x = rng.normal(size=(b, s, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s))
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=HD, rope_theta=THETA, causal=True,
              window=window, n_heads_layout=hl)
    got = ta.attn_apply(tp, torch.tensor(x), torch.tensor(pos),
                        compute_dtype=getattr(torch, dtype), **kw)
    assert got.dtype == getattr(torch, dtype) and got.shape == (b, s, D)
    for impl, path in (("ref", "ref"), ("flash", "kernel")):
        want = ja.attn_apply(jp, jnp.asarray(x), jnp.asarray(pos), impl=impl,
                             compute_dtype=getattr(jnp, dtype), **kw)
        _close(got, want, dtype, path)


def _decode_run(attn_decode, p, x, cache, ring, kw, to_step):
    outs = []
    for t in range(x.shape[1]):
        o, cache = attn_decode(p, to_step(x[:, t:t + 1]), cache, ring=ring, **kw)
        outs.append(o)
    return outs, cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ring", [False, True], ids=["contiguous", "ring"])
@pytest.mark.parametrize("layout", LAYOUTS, ids=str)
def test_attn_decode_matches_reference(layout, ring, dtype):
    """Ten decode steps (the ring buffer of 4 slots wraps twice; the
    contiguous cache of 12 never fills), each step's output against both
    reference paths, and the caches after the last step. The cache is
    kept in the compute dtype (fp32 or bf16) on both sides."""
    h, kv, pad = layout
    hl, jp, tp = _setup(h, kv, pad, seed=2)
    rng = np.random.default_rng(3)
    b, s = 2, 10
    cache_len = 4 if ring else 12
    x = rng.normal(size=(b, s, D)).astype(np.float32)
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=HD, rope_theta=THETA, n_heads_layout=hl)
    got, tcache = _decode_run(
        ta.attn_decode, tp, x,
        ta.init_kv_cache(b, cache_len, kv, HD, getattr(torch, dtype), device="cpu"),
        ring, dict(kw, compute_dtype=getattr(torch, dtype)), torch.tensor)
    assert int(tcache["pos"]) == s
    for impl, path in (("ref", "ref"), ("decode_kernel", "kernel")):
        want, jcache = _decode_run(
            lambda *a, **k: ja.attn_decode(*a, impl=impl, **k), jp, x,
            ja.init_kv_cache(b, cache_len, kv, HD, getattr(jnp, dtype)), ring,
            dict(kw, compute_dtype=getattr(jnp, dtype)), jnp.asarray)
        for g, w in zip(got, want):
            _close(g, w, dtype, path)
        for key in ("k", "v"):
            _close(tcache[key], jcache[key], dtype, "kernel")


def test_ring_decode_equals_windowed_attention():
    """Token-by-token decode through a ring buffer of ``window`` slots
    reproduces full-sequence causal attention within that window, at
    every position (the port's counterpart of the reference's
    test_ring_buffer_decode_matches_windowed_attention)."""
    h, kv, win, b, s = 4, 2, 6, 2, 15
    _, _, tp = _setup(h, kv, 0, seed=4)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.normal(size=(b, s, D)), dtype=torch.float32)
    pos = torch.arange(s)[None].expand(b, s)
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=HD, rope_theta=THETA,
              compute_dtype=torch.float32)
    full = ta.attn_apply(tp, x, pos, causal=True, window=win, **kw)
    cache = ta.init_kv_cache(b, win, kv, HD, torch.float32, device="cpu")
    outs, _ = _decode_run(ta.attn_decode, tp, x, cache, True, kw, lambda a: a)
    torch.testing.assert_close(torch.cat(outs, dim=1), full, rtol=0, atol=1e-5)


def test_contiguous_decode_equals_causal_attention_and_clamps_past_the_end():
    """Stepping a contiguous cache reproduces causal attention; a step
    past the end writes the last slot, as the reference's clamped
    update does."""
    h, kv, b, s = 4, 2, 1, 6
    hl, jp, tp = _setup(h, kv, 0, seed=6)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(b, s + 2, D)).astype(np.float32)
    kw = dict(n_heads=h, n_kv_heads=kv, head_dim=HD, rope_theta=THETA)
    pos = torch.arange(s)[None].expand(b, s)
    full = ta.attn_apply(tp, torch.tensor(x[:, :s]), pos, causal=True,
                         compute_dtype=torch.float32, **kw)
    cache = ta.init_kv_cache(b, s, kv, HD, torch.float32, device="cpu")
    outs, cache = _decode_run(ta.attn_decode, tp, x, cache, False,
                              dict(kw, compute_dtype=torch.float32), torch.tensor)
    torch.testing.assert_close(torch.cat(outs[:s], dim=1), full, rtol=0, atol=1e-5)
    want, jcache = _decode_run(
        ja.attn_decode, jp, x, ja.init_kv_cache(b, s, kv, HD, jnp.float32), False,
        dict(kw, compute_dtype=jnp.float32), jnp.asarray)
    for g, w in zip(outs[s:], want[s:]):
        _close(g, w, "float32", "ref")
    _close(cache["k"], jcache["k"], "float32", "ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 5])
def test_sdpa_with_repeated_kv_is_the_reference_ref_path_and_the_twins_function(
        window, dtype):
    """The port's ``_sdpa`` on ``_repeat_kv``'d K/V is the reference's
    ``ref`` path (probabilities cast to v's dtype), and at fp32 it is the
    function the flash kernel's twin computes on un-repeated K/V."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    rng = np.random.default_rng(8)
    b, s, h, kv = 2, 9, 6, 2
    q, k, v = (rng.normal(size=(b, s, n, HD)).astype(np.float32) for n in (h, kv, kv))
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ja._sdpa(*(ja._repeat_kv(jnp.asarray(a).astype(jd), h) if a is not q
                      else jnp.asarray(a).astype(jd) for a in (q, k, v)),
                    causal=True, window=window)
    tq, tk, tv = (torch.tensor(a).to(td) for a in (q, k, v))
    got = ta._sdpa(tq, ta._repeat_kv(tk, h), ta._repeat_kv(tv, h), causal=True,
                   window=window)
    assert got.dtype == td
    _close(got, want, dtype, "ref")
    if dtype == "float32":
        torch.testing.assert_close(got, attention_ref(tq, tk, tv, window=window),
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq", [1, 7])
def test_cross_attention_matches_reference(sq, dtype):
    """Whisper's cross-attention: ``precompute_cross_kv`` over 13 encoder
    frames, then ``cross_attn_apply`` (the flash wrapper, non-causal, Sq
    != Sk) and, for one query, ``cross_attn_decode`` (the decode
    wrapper over every slot) against the reference's ``cross_attn_apply``
    (its plain ``_sdpa``: probabilities cast to v's dtype, so the ``ref``
    tolerances)."""
    h = 4
    jp = ja.cross_attn_init(jax.random.key(3), D, h, HD, jnp.float32)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    assert set(tp) == {"wq", "wk", "wv", "wo"} and "b" in tp["wk"]
    rng = np.random.default_rng(7)
    enc, x = rng.normal(size=(2, 13, D)), rng.normal(size=(2, sq, D))
    cj, ct = getattr(jnp, dtype), getattr(torch, dtype)
    jkv = ja.precompute_cross_kv(jp, jnp.asarray(enc, jnp.float32), h, HD, cj)
    tkv = ta.precompute_cross_kv(tp, torch.tensor(enc, dtype=torch.float32), h, HD, ct)
    for g, w in zip(tkv, jkv):
        _close(g, w, dtype, "kernel")
    want = ja.cross_attn_apply(jp, jnp.asarray(x, jnp.float32), jkv, n_heads=h, head_dim=HD,
                               compute_dtype=cj)
    tx = torch.tensor(x, dtype=torch.float32)
    got = ta.cross_attn_apply(tp, tx, tkv, n_heads=h, head_dim=HD, compute_dtype=ct)
    assert got.dtype == ct and got.shape == (2, sq, D)
    _close(got, want, dtype, "ref")
    if sq == 1:
        dec = ta.cross_attn_decode(tp, tx, tkv, n_heads=h, head_dim=HD, compute_dtype=ct)
        _close(dec, want, dtype, "ref")
