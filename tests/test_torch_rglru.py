"""The RG-LRU block of the PyTorch port (``repro_torch.models.rglru``)
against ``repro.models.rglru`` on identical numpy inputs, from the
reference's own ``rglru_block_init`` carried over leaf for leaf.

The port's block runs the recurrence through the scan kernel's wrapper
(on the CPU: the step twin); the reference's runs its associative scan
(``impl="ref"``, also its decode path) or its Pallas kernel (interpret
mode).

Tolerances, each relative to max(1, max|want|):
* fp32 compute: 1e-5 -- the same fp32 function, the scan summed in
  another order (observed ~2e-7 against the associative scan, ~2e-6
  against the Pallas kernel's closed form);
* bf16 compute: 2e-2 -- the projections, the conv, the recurrence's
  output and the gelu gate are rounded to bf16 on both sides, the gelu
  at other places (observed ~5e-3);
* the fp32 states: 1e-5 (the conv state holds the in-projection's
  outputs, a matmul summed in another order; on identical inputs the
  conv itself is bit for bit the reference's).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import rglru as jg  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import rglru as tg  # noqa: E402

D, W, K, B, S = 128, 192, 4, 2, 128
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
STATE_TOL = 1e-5


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module")
def block():
    jp = jg.rglru_block_init(jax.random.key(0), D, W, K, jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(dtype, seed=0, s=S):
    x = np.random.default_rng(seed).normal(size=(B, s, D)).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.tensor(x).to(getattr(torch, dtype))


def _tstate(state):
    return {k: torch.tensor(np.asarray(v)) for k, v in state.items()}


def test_init_matches_the_reference_tree():
    gen = torch.Generator().manual_seed(0)
    got = tg.rglru_block_init(gen, D, W, K, torch.float32, "cpu")
    want = jax.eval_shape(lambda k: jg.rglru_block_init(k, D, W, K, jnp.float32),
                          jax.random.key(0))
    flat_w = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
              for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_g == flat_w
    lam = got["lam"]
    assert float(lam.min()) >= 2.0 and float(lam.max()) < 6.0
    assert not got["conv_b"].any() and not got["in_proj"]["b"].any()
    meta = tg.rglru_block_init(None, D, W, K, torch.float32, "meta", lead=(3,))
    assert meta["lam"].shape == (3, W) and meta["lam"].device.type == "meta"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_is_the_references_bit_for_bit(block, dtype):
    """The taps summed one by one in x's dtype, after the state is cast to
    it: the same roundings as the reference, so the same bits; the
    returned state is fp32, as the reference's."""
    jp, tp = block
    jx, tx = _x(dtype, seed=4, s=9)
    rng = np.random.default_rng(5)
    xs = rng.normal(size=(B, 9, W)).astype(np.float32)
    state = rng.normal(size=(B, K - 1, W)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want, want_state = jg._causal_conv1d(jnp.asarray(xs).astype(jd), jp["conv_w"],
                                         jp["conv_b"], jnp.asarray(state))
    got, got_state = tg._causal_conv1d(torch.tensor(xs).to(td), tp["conv_w"],
                                       tp["conv_b"], torch.tensor(state))
    assert got.dtype == td and got_state.dtype == torch.float32
    np.testing.assert_array_equal(_np(got), _np(want))
    np.testing.assert_array_equal(_np(got_state), _np(want_state))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_block_prefill_matches_reference(block, dtype):
    jp, tp = block
    jx, tx = _x(dtype)
    jst = jg.rglru_decode_state(B, W, K)
    got, st = tg.rglru_block_apply(tp, tx, tg.rglru_decode_state(B, W, K, "cpu"),
                                   getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype)
    assert st["h"].dtype == st["conv"].dtype == torch.float32
    for impl in ("ref", "pallas"):
        want, want_st = jax.jit(
            lambda p, x, s, impl=impl: jg.rglru_block_apply(p, x, s, getattr(jnp, dtype),
                                                            impl=impl))(jp, jx, jst)
        _close(got, want, TOL[dtype])
        _close(st["h"], want_st["h"], STATE_TOL)
        _close(st["conv"], want_st["conv"], STATE_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_decode_matches_reference_and_keeps_fp32_states(block, dtype):
    jp, tp = block
    jx, tx = _x(dtype, seed=6)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    jst = jg.rglru_decode_state(B, W, K)
    tst = tg.rglru_decode_state(B, W, K, "cpu")
    step = jax.jit(lambda p, x, s: jg.rglru_block_apply(p, x, s, jd))
    for t in range(12):
        want, jst = step(jp, jx[:, t:t + 1], jst)
        got, tst = tg.rglru_block_apply(tp, tx[:, t:t + 1], tst, td)
        _close(got, want, TOL[dtype])
        _close(tst["h"], jst["h"], STATE_TOL)
        _close(tst["conv"], jst["conv"], STATE_TOL)
        if t < 2:
            assert tst["h"].dtype == tst["conv"].dtype == torch.float32
            assert str(jst["h"].dtype) == str(jst["conv"].dtype) == "float32"
    # a prefill of the same tokens ends in the same state
    _, pre = tg.rglru_block_apply(tp, tx[:, :12], tg.rglru_decode_state(B, W, K, "cpu"), td)
    _close(pre["h"], tst["h"], STATE_TOL)
    _close(pre["conv"], tst["conv"], STATE_TOL)
