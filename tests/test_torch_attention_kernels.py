"""The attention kernels of the PyTorch port
(``repro_torch.kernels.decode_attention`` and ``.flash_attention``).

* Their plain PyTorch twins against the JAX package's jnp oracles and its
  Pallas kernels (interpret mode on the CPU, as the JAX suite runs them),
  from identical numpy inputs. The port takes the model layout (q (B, S,
  H, hd), K/V (B, S, K, hd)); the reference's kernels take the folded
  (B·H, S, hd) layout, so the tests fold the same arrays for them.
* The CUDA kernels against the twins on the card (``cuda`` marker: they
  skip without one; ``python -m pytest -q -m cuda
  tests/test_torch_attention_kernels.py`` runs them there, where JAX is
  not needed).
* The wrappers' refusals.

Tolerances, as ``|got - want| <= tol x (1 + |want|)``: fp32 1e-5 (both
sides accumulate in fp32, in another order); bf16 1.6e-2 -- inputs and
output are rounded to bf16 (2^-8 relative), and the sums run in another
order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fl_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402

TOL = {"float32": 1e-5, "bfloat16": 1.6e-2}

DECODE_CASES = [
    # (b, h, kv, cache_len, hd, block_c of the Pallas kernel); GQA 1, 3, 4;
    # cache lengths not multiples of the block
    (3, 4, 4, 300, 64, 128),
    (3, 15, 5, 200, 64, 64),
    (3, 8, 2, 130, 128, 64),
    # hd 256: RecurrentGemma's MQA (10 q-heads over 1 kv-head, more than
    # one block's 4 q-heads)
    (3, 10, 1, 150, 256, 64),
]
FLASH_CASES = [
    # (b, h, kv, seq, hd, causal, window, block); seq not a multiple of the
    # block in the ragged cases
    (2, 2, 1, 200, 64, True, 0, 64),
    (1, 3, 1, 192, 64, True, 0, 64),
    (1, 4, 4, 160, 128, True, 48, 64),
    (1, 4, 2, 130, 64, False, 40, 64),
    (2, 2, 2, 96, 64, False, 0, 64),
    # hd 256: the reference suite's windowed case, and RecurrentGemma's
    # MQA group of 10 over a ragged length
    (1, 8, 2, 384, 256, True, 128, 128),
    (2, 10, 1, 130, 256, True, 48, 64),
]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def jax_kernels():
    """The JAX package's oracles and Pallas kernels (imported here, not at
    module level, so the card-only tests run where JAX is absent)."""
    pytest.importorskip("jax")
    from repro.kernels.decode_attention.decode_attention import decode_attention_bhd
    from repro.kernels.decode_attention.ref import decode_attention_ref as j_dec_ref
    from repro.kernels.flash_attention.flash_attention import flash_attention_bhsd
    from repro.kernels.flash_attention.ref import attention_ref_bhsd

    return decode_attention_bhd, j_dec_ref, flash_attention_bhsd, attention_ref_bhsd


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (python3 chip_smoke.py runs the same checks there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(got, want, dtype):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = TOL[dtype]
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def _torch(a, dtype, device="cpu"):
    return torch.tensor(np.asarray(a, np.float32), device=device).to(getattr(torch, dtype))


def _decode_inputs(case, seed):
    """q (B,1,H,hd), caches (B,C,K,hd) in fp32 numpy, and n_valid with a
    0 row, a full row and one in between."""
    b, h, kv, c, hd, _ = case
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, c, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, c, kv, hd)).astype(np.float32)
    n_valid = np.asarray([0, c, int(rng.integers(1, c))][:b], np.int32)
    return q, k, v, n_valid


def _fold(x):
    """(B, S, N, hd) -> (B*N, S, hd), the reference kernels' layout."""
    b, s, n, hd = x.shape
    return np.ascontiguousarray(x.transpose(0, 2, 1, 3).reshape(b * n, s, hd))


def _unfold(x, b):
    bn, s, hd = x.shape
    return np.asarray(x, np.float32).reshape(b, bn // b, s, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
def test_decode_twin_matches_reference_oracle_and_pallas(case, dtype, jax_kernels):
    import jax.numpy as jnp

    decode_attention_bhd, j_dec_ref, _, _ = jax_kernels
    b, h, kv, c, hd, block_c = case
    q, k, v, n_valid = _decode_inputs(case, seed=c)
    got = decode_attention_ref(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                               torch.tensor(n_valid)).float().numpy()
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(_fold(a)).astype(jd) for a in (q, k, v))
    nv = jnp.asarray(n_valid)
    want = j_dec_ref(jq, jk, jv, nv, n_q_heads=h, n_kv_heads=kv)
    pallas = decode_attention_bhd(jq, jk, jv, nv, n_q_heads=h, n_kv_heads=kv,
                                  block_c=block_c, interpret=True)
    _close(got, _unfold(want, b), dtype)
    _close(got, _unfold(pallas, b), dtype)
    assert not got[0].any(), "a row with n_valid = 0 must give zeros"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_twin_matches_reference_oracle_and_pallas(case, dtype, jax_kernels):
    import jax.numpy as jnp

    _, _, flash_attention_bhsd, attention_ref_bhsd = jax_kernels
    b, h, kv, s, hd, causal, window, block = case
    rng = np.random.default_rng(s + h)
    q = rng.normal(size=(b, s, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, s, kv, hd)).astype(np.float32)
    got = attention_ref(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                        causal=causal, window=window).float().numpy()
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(_fold(a)).astype(jd) for a in (q, k, v))
    kw = dict(causal=causal, window=window, n_q_heads=h, n_kv_heads=kv)
    want = attention_ref_bhsd(jq, jk, jv, **kw)
    pallas = flash_attention_bhsd(jq, jk, jv, block_q=block, block_k=block,
                                  interpret=True, **kw)
    _close(got, _unfold(want, b), dtype)
    _close(got, _unfold(pallas, b), dtype)


def test_flash_twin_window_one_keeps_the_diagonal_and_empty_rows_are_zero():
    """A causal window of 1 leaves each query its own key, so the output
    is v at that position; with fewer keys than queries, the rows past
    the last key have no live key and give zeros."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.tensor(rng.normal(size=(1, 5, 2, 64)), dtype=torch.float32)
               for _ in range(3))
    torch.testing.assert_close(attention_ref(q, k, v, causal=True, window=1), v,
                               rtol=0, atol=1e-6)
    out = attention_ref(q, k[:, :2], v[:, :2], causal=True, window=1)
    torch.testing.assert_close(out[:, :2], v[:, :2], rtol=0, atol=1e-6)
    assert not out[:, 2:].any()


def test_wrappers_dispatch_cpu_tensors_to_the_twins():
    dec_ops.decode_attention.launches = 0
    fl_ops.flash_attention.launches = 0
    q, k, v, n_valid = _decode_inputs(DECODE_CASES[1], seed=0)
    args = (torch.tensor(q), torch.tensor(k), torch.tensor(v), torch.tensor(n_valid))
    torch.testing.assert_close(dec_ops.decode_attention(*args),
                               decode_attention_ref(*args), rtol=0, atol=0)
    x = torch.randn(1, 70, 6, 64, generator=torch.Generator().manual_seed(0))
    kv = x[:, :, :2].contiguous()
    torch.testing.assert_close(fl_ops.flash_attention(x, kv, kv, window=16),
                               attention_ref(x, kv, kv, window=16), rtol=0, atol=0)
    assert dec_ops.decode_attention.launches == 0
    assert fl_ops.flash_attention.launches == 0


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q = torch.zeros(2, 1, 4, 96)
    kc = torch.zeros(2, 8, 2, 96)
    nv = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="head size 96"):
        dec_ops.decode_attention(q, kc, kc, nv)
    q, kc = torch.zeros(2, 1, 4, 64), torch.zeros(2, 8, 2, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        dec_ops.decode_attention(q, kc.bfloat16(), kc, nv)
    with pytest.raises(ValueError, match="kv-heads"):
        dec_ops.decode_attention(torch.zeros(2, 1, 3, 64), kc, kc, nv)
    with pytest.raises(ValueError, match="n_valid"):
        dec_ops.decode_attention(q, kc, kc, nv.float())
    with pytest.raises(TypeError, match="float16"):
        dec_ops.decode_attention(q.half(), kc.half(), kc.half(), nv)
    x = torch.zeros(1, 8, 4, 32)
    with pytest.raises(ValueError, match="head size 32"):
        fl_ops.flash_attention(x, x, x)
    x = torch.zeros(1, 8, 4, 64)
    with pytest.raises(ValueError, match="kv-heads"):
        fl_ops.flash_attention(x, x[:, :, :3], x[:, :, :3])
    with pytest.raises(ValueError, match="window"):
        fl_ops.flash_attention(x, x, x, window=-1)


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", DECODE_CASES, ids=[str(c) for c in DECODE_CASES])
def test_decode_kernel_matches_twin_on_card(case, dtype, cuda):
    q, k, v, n_valid = _decode_inputs(case, seed=case[3])
    args = (_torch(q, dtype, cuda), _torch(k, dtype, cuda), _torch(v, dtype, cuda),
            torch.tensor(n_valid, device=cuda))
    before = dec_ops.decode_attention.launches
    got = dec_ops.decode_attention(*args)
    torch.cuda.synchronize()
    assert dec_ops.decode_attention.launches == before + 1
    want = decode_attention_ref(*args)
    _close(got.float().cpu(), want.float().cpu(), dtype)
    assert not got[0].any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", FLASH_CASES, ids=[str(c) for c in FLASH_CASES])
def test_flash_kernel_matches_twin_on_card(case, dtype, cuda):
    b, h, kv, s, hd, causal, window, _ = case
    rng = np.random.default_rng(s + h)
    q = _torch(rng.normal(size=(b, s, h, hd)), dtype, cuda)
    k = _torch(rng.normal(size=(b, s, kv, hd)), dtype, cuda)
    v = _torch(rng.normal(size=(b, s, kv, hd)), dtype, cuda)
    before = fl_ops.flash_attention.launches
    got = fl_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fl_ops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    _close(got.float().cpu(), want.float().cpu(), dtype)
