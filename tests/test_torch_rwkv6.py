"""The RWKV6 block of the PyTorch port (``repro_torch.models.rwkv6``)
against ``repro.models.rwkv6`` on identical numpy inputs, from the
reference's own ``rwkv_block_init`` carried over leaf for leaf.

The port's time mix runs WKV-6 through the kernel's wrapper (on the
CPU: the step-recurrence twin); the reference's prefill runs its chunked
jnp form (``impl="ref"``, chunk 64) or its Pallas kernel (interpret
mode), and its decode the chunked form at chunk 1.

Tolerances, each relative to max(1, max|want|):
* fp32 compute: 1e-5 -- the same fp32 function summed in another order
  (the step form against the chunked one; observed ~5e-7);
* bf16 compute: 2e-2 -- outputs, projections and the silu gate are
  rounded to bf16 on both sides, at a few places in another order
  (observed ~8e-3, two bf16 ulps of 2^-8);
* the WKV state is fp32 on both sides whatever the compute dtype: 1e-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models import rwkv6 as jr  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import rwkv6 as tr  # noqa: E402

D, D_FF, B, S = 128, 256, 2, 128
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
    jp = jr.rwkv_block_init(jax.random.key(0), D, D_FF, jnp.float32)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(dtype, seed=0):
    x = np.random.default_rng(seed).normal(size=(B, S, D)).astype(np.float32)
    return jnp.asarray(x).astype(getattr(jnp, dtype)), torch.tensor(x).to(getattr(torch, dtype))


def test_init_matches_the_reference_tree():
    gen = torch.Generator().manual_seed(0)
    got = tr.rwkv_block_init(gen, D, D_FF, torch.float32, "cpu")
    want = jax.eval_shape(lambda k: jr.rwkv_block_init(k, D, D_FF, jnp.float32),
                          jax.random.key(0))
    flat_w = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
              for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_g == flat_w
    assert float(got["time"]["w0"].mean()) == pytest.approx(-6.0, abs=0.1)
    assert float(got["time"]["u"].std()) == pytest.approx(0.3, rel=0.2)
    with pytest.raises(ValueError, match="head size"):
        tr.rwkv_block_init(gen, 100, D_FF)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_time_mix_prefill_matches_reference(block, dtype):
    jp, tp = block
    jx, tx = _x(dtype)
    st = jr.rwkv_decode_states(B, D)
    jd = getattr(jnp, dtype)
    tst = tr.rwkv_decode_states(B, D, device="cpu")
    got, prev, s = tr.rwkv_time_mix(tp["time"], tx, tst["tm_prev"], tst["s"],
                                    getattr(torch, dtype))
    assert got.dtype == prev.dtype == getattr(torch, dtype) and s.dtype == torch.float32
    for impl in ("ref", "pallas"):
        want, want_prev, want_s = jax.jit(
            lambda p, x, a, b, impl=impl: jr.rwkv_time_mix(p, x, a, b, jd, impl=impl))(
                jp["time"], jx, st["tm_prev"], st["s"])
        _close(got, want, TOL[dtype])
        _close(s, want_s, STATE_TOL)
        np.testing.assert_array_equal(_np(prev), _np(want_prev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_channel_mix_matches_reference(block, dtype):
    jp, tp = block
    jx, tx = _x(dtype, seed=1)
    prev = np.random.default_rng(2).normal(size=(B, D)).astype(np.float32)
    want, want_prev = jr.rwkv_channel_mix(jp["channel"], jx, jnp.asarray(prev),
                                          getattr(jnp, dtype))
    got, got_prev = tr.rwkv_channel_mix(tp["channel"], tx, torch.tensor(prev),
                                        getattr(torch, dtype))
    _close(got, want, TOL[dtype])
    np.testing.assert_array_equal(_np(got_prev), _np(want_prev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_step_decode_matches_reference_and_keeps_its_state_dtypes(block, dtype):
    """Token by token from zero fp32 states (the reference's decode, chunk
    1): outputs and states agree at every step, and the token-shift
    carries are the residual stream's dtype from the first step on --
    the first step's lerp ran in fp32 (the zero carry promotes), later
    ones in the compute dtype -- as in the reference, after one and after
    two steps."""
    jp, tp = block
    jx, tx = _x(dtype, seed=3)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    st = jr.rwkv_decode_states(B, D)
    jstate = (st["tm_prev"], st["cm_prev"], st["s"])
    tst = tr.rwkv_decode_states(B, D, device="cpu")
    tstate = (tst["tm_prev"], tst["cm_prev"], tst["s"])
    assert all(a.dtype == torch.float32 for a in tstate)
    tm = jax.jit(lambda p, x, a, b: jr.rwkv_time_mix(p, x, a, b, jd, chunk=1))
    cm = jax.jit(lambda p, x, a: jr.rwkv_channel_mix(p, x, a, jd))
    for t in range(12):
        want, j_tm, j_s = tm(jp["time"], jx[:, t:t + 1], jstate[0], jstate[2])
        want_c, j_cm = cm(jp["channel"], jx[:, t:t + 1], jstate[1])
        jstate = (j_tm, j_cm, j_s)
        got, t_tm, t_s = tr.rwkv_time_mix(tp["time"], tx[:, t:t + 1], tstate[0],
                                          tstate[2], td)
        got_c, t_cm = tr.rwkv_channel_mix(tp["channel"], tx[:, t:t + 1], tstate[1], td)
        tstate = (t_tm, t_cm, t_s)
        _close(got, want, TOL[dtype])
        _close(got_c, want_c, TOL[dtype])
        _close(t_s, j_s, STATE_TOL)
        if t < 2:
            for got_state, want_state in zip(tstate, jstate):
                assert str(got_state.dtype).split(".")[-1] == str(want_state.dtype)
            assert t_tm.dtype == t_cm.dtype == td and t_s.dtype == torch.float32
