"""The transformer's primitive layers in the PyTorch port
(``repro_torch.models.layers``) against ``repro.models.layers`` on the
same numpy inputs and parameters.

Tolerances: fp32 within 1e-6 (absolute, on values of order 1: the two
packages sum and take transcendentals in other orders); bf16 within one
bf16 ulp of the reference's value (both round one fp32 result to bf16,
and an fp32 difference in the last bits can flip that rounding).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import layers as jl  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402

F32_ATOL = 1e-6


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else
                      np.asarray(x, np.float32), np.float32)


def _bf16_ulp(x):
    """One bf16 ulp at |x| (8 significant bits), the smallest normal's at 0."""
    mag = np.maximum(np.abs(x), np.float32(2.0 ** -126))
    return np.exp2(np.floor(np.log2(mag)) - 7).astype(np.float32)


def _check(got, want, dtype):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=F32_ATOL)
    else:
        assert (np.abs(got - want) <= _bf16_ulp(want)).all(), \
            float(np.max(np.abs(got - want) / _bf16_ulp(want)))


def _pair(a, dtype):
    """The same numpy array as a JAX and a torch array of ``dtype``."""
    return (jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype)),
            torch.tensor(np.asarray(a, np.float32)).to(getattr(torch, dtype)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(0)
    x = 3.0 * rng.normal(size=(2, 5, 96))
    scale = 1.0 + 0.1 * rng.normal(size=(96,))
    jx, tx = _pair(x, dtype)
    want = jl.rmsnorm({"scale": jnp.asarray(scale, jnp.float32)}, jx, 1e-5)
    got = tl.rmsnorm({"scale": torch.tensor(scale, dtype=torch.float32)}, tx, 1e-5)
    assert got.dtype == tx.dtype
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("start", [0, 4000], ids=["prefill", "decode"])
def test_apply_rope(dtype, start):
    """Positions from 0 (prefill) and deep into a cache (one decode
    position per row), where the angles are large."""
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 3, 4, 64))
    pos = start + np.stack([np.arange(3), np.arange(3) + 7]).astype(np.int32)
    jx, tx = _pair(x, dtype)
    want = jl.apply_rope(jx, jnp.asarray(pos), 10000.0)
    got = tl.apply_rope(tx, torch.tensor(pos), 10000.0)
    assert got.dtype == tx.dtype
    _check(got, want, dtype)
    np.testing.assert_allclose(tl.rope_freqs(64, 10000.0).numpy(),
                               np.asarray(jl.rope_freqs(64, 10000.0)), rtol=1e-7)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linear(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 5, 48))
    w = rng.normal(size=(48, 40)) * 48 ** -0.5
    b = rng.normal(size=(40,))
    jp = {"w": jnp.asarray(w, jnp.float32), "b": jnp.asarray(b, jnp.float32)}
    tp = {"w": torch.tensor(w, dtype=torch.float32), "b": torch.tensor(b, dtype=torch.float32)}
    want = jl.linear(jp, jnp.asarray(x, jnp.float32), getattr(jnp, dtype))
    got = tl.linear(tp, torch.tensor(x, dtype=torch.float32), getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu(dtype):
    """SwiGLU is three products and an activation, each rounded to the
    compute dtype: at bf16 a one-ulp difference of an intermediate moves
    the down product by up to one ulp of its own scale."""
    rng = np.random.default_rng(3)
    d, ff = 32, 64
    x = rng.normal(size=(2, 3, d))
    mats = {"gate": (d, ff), "up": (d, ff), "down": (ff, d)}
    ws = {k: rng.normal(size=s) * s[0] ** -0.5 for k, s in mats.items()}
    jp = {k: {"w": jnp.asarray(w, jnp.float32)} for k, w in ws.items()}
    tp = {k: {"w": torch.tensor(w, dtype=torch.float32)} for k, w in ws.items()}
    want = jl.swiglu(jp, jnp.asarray(x, jnp.float32), getattr(jnp, dtype))
    got = tl.swiglu(tp, torch.tensor(x, dtype=torch.float32), getattr(torch, dtype))
    if dtype == "float32":
        _check(got, want, dtype)
    else:
        err = np.abs(_np(got) - _np(want))
        assert err.max() <= _bf16_ulp(np.abs(_np(want)).max()), err.max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_lookup_and_unembed(dtype):
    rng = np.random.default_rng(4)
    table = 0.02 * rng.normal(size=(256, 48))
    tokens = rng.integers(0, 256, size=(2, 7)).astype(np.int32)
    h = rng.normal(size=(2, 48))
    jt, tt = jnp.asarray(table, jnp.float32), torch.tensor(table, dtype=torch.float32)
    cd_j, cd_t = getattr(jnp, dtype), getattr(torch, dtype)
    want = jl.embed_lookup({"table": jt}, jnp.asarray(tokens), cd_j)
    got = tl.embed_lookup({"table": tt}, torch.tensor(tokens, dtype=torch.long), cd_t)
    np.testing.assert_array_equal(_np(got), _np(want))  # a gather and a cast: exact
    want = jl.unembed_logits(jt, jnp.asarray(h, jnp.float32), cd_j)
    got = tl.unembed_logits(tt, torch.tensor(h, dtype=torch.float32), cd_t)
    _check(got, want, dtype)


def test_init_shapes_and_scales():
    """The port draws from a torch.Generator (other numbers than
    jax.random), with the reference's shapes, dtypes and scales; the
    ``meta`` device gives shapes without drawing."""
    gen = torch.Generator().manual_seed(0)
    p = tl.dense_init(gen, 512, 256, "cpu", bias=True, lead=(3,))
    assert p["w"].shape == (3, 512, 256) and p["b"].shape == (3, 256)
    assert abs(float(p["w"].std()) - 512 ** -0.5) < 2e-3
    assert not p["b"].any()
    e = tl.embed_init(gen, 1024, 64, device="cpu")["table"]
    assert abs(float(e.std()) - 0.02) < 1e-3
    assert tl.rmsnorm_init(8, lead=(2,), device="cpu")["scale"].eq(1).all()
    m = tl.dense_init(None, 4, 5, "meta")
    assert m["w"].device.type == "meta" and m["w"].shape == (4, 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm(dtype):
    """LayerNorm with its bias (the enc-dec family's norm): the population
    variance, as ``jnp.var``, in fp32, cast back to the input's dtype."""
    rng = np.random.default_rng(5)
    x = 3.0 * rng.normal(size=(2, 5, 96)) + 1.5
    scale, bias = 1.0 + 0.1 * rng.normal(size=(96,)), 0.1 * rng.normal(size=(96,))
    jx, tx = _pair(x, dtype)
    want = jl.layernorm({"scale": jnp.asarray(scale, jnp.float32),
                         "bias": jnp.asarray(bias, jnp.float32)}, jx, 1e-5)
    got = tl.layernorm({"scale": torch.tensor(scale, dtype=torch.float32),
                        "bias": torch.tensor(bias, dtype=torch.float32)}, tx, 1e-5)
    assert got.dtype == tx.dtype
    _check(got, want, dtype)
    init = tl.layernorm_init(8, lead=(2,), device="cpu")
    assert init["scale"].eq(1).all() and not init["bias"].any()
    assert init["bias"].shape == (2, 8)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_mlp(dtype):
    """up -> tanh-approximate GELU (``jax.nn.gelu``'s default) -> down,
    both with biases; at bf16 within one ulp of the output's scale, as
    the SwiGLU."""
    rng = np.random.default_rng(6)
    d, ff = 32, 64
    x = rng.normal(size=(2, 3, d))
    p = {"up": {"w": rng.normal(size=(d, ff)) * d ** -0.5, "b": 0.1 * rng.normal(size=(ff,))},
         "down": {"w": rng.normal(size=(ff, d)) * ff ** -0.5, "b": 0.1 * rng.normal(size=(d,))}}
    jp = {k: {n: jnp.asarray(a, jnp.float32) for n, a in v.items()} for k, v in p.items()}
    tp = {k: {n: torch.tensor(a, dtype=torch.float32) for n, a in v.items()}
          for k, v in p.items()}
    want = jl.gelu_mlp(jp, jnp.asarray(x, jnp.float32), getattr(jnp, dtype))
    got = tl.gelu_mlp(tp, torch.tensor(x, dtype=torch.float32), getattr(torch, dtype))
    if dtype == "float32":
        _check(got, want, dtype)
    else:
        err = np.abs(_np(got) - _np(want))
        assert err.max() <= _bf16_ulp(np.abs(_np(want)).max()), err.max()
    shapes = {k: {n: tuple(a.shape) for n, a in v.items()}
              for k, v in tl.gelu_mlp_init(None, d, ff, device="meta").items()}
    assert shapes == {k: {n: a.shape for n, a in v.items()} for k, v in p.items()}


def test_uniform_init():
    """``U(-scale, scale)`` from a torch.Generator (the reference draws
    from jax.random): the range, the dtype, a seed's reproducibility, and
    shapes only on the meta device."""
    a = tl.uniform_init(torch.Generator().manual_seed(0), (64, 128), 0.5, device="cpu")
    b = tl.uniform_init(torch.Generator().manual_seed(0), (64, 128), 0.5, device="cpu")
    assert torch.equal(a, b) and a.dtype == torch.float32
    assert float(a.min()) >= -0.5 and float(a.max()) < 0.5
    assert abs(float(a.mean())) < 0.02 and abs(float(a.std()) - 0.5 / 3 ** 0.5) < 0.01
    h = tl.uniform_init(torch.Generator().manual_seed(0), (8,), 1.0, torch.bfloat16, "cpu")
    assert h.dtype == torch.bfloat16
    m = tl.uniform_init(None, (3, 4), 1.0, device="meta")
    assert m.device.type == "meta" and m.shape == (3, 4)
