"""The dense decoder stack of the PyTorch port
(``repro_torch.models.transformer`` and ``models.model``) against
``repro.models.transformer`` on the smoke SmolLM-360M and TinyLlama-1.1B
configs (2 layers, width 192 / 256), from the reference's own
``init_params`` carried over by ``repro_torch.convert``.

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
    from repro_torch.configs.base import ModelConfig

    with pytest.raises(NotImplementedError, match="item 16"):
        get_config("rwkv6-7b")
    base = get_config("smollm-360m", smoke=True)
    moe = dataclasses.replace(base, family="moe", n_experts=4, experts_per_token=1)
    with pytest.raises(NotImplementedError, match="MoE"):
        build_model(moe)
    hybrid = dataclasses.replace(base, family="hybrid",
                                 block_pattern=("recurrent", "local_attention"))
    with pytest.raises(NotImplementedError, match="RG-LRU"):
        build_model(hybrid)
    with pytest.raises(NotImplementedError, match="enc-dec"):
        build_model(ModelConfig(name="a", family="audio", n_layers=1, d_model=64,
                                n_heads=1, n_kv_heads=1, d_ff=64, vocab_size=64))
    with pytest.raises(NotImplementedError, match="training"):
        build_model(base).loss_fn({}, {})


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
