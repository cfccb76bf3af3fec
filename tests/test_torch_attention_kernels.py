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
* The split-KV path of decode: ``decode_attention_split_ref`` (fp32
  partials per span, merged by ``combine_partials_ref``, the combine
  kernel's twin) against the unsplit twin and the Pallas kernel, with
  n_valid 0, 1, on a split boundary and at capacity, and splits with no
  live slot; ``plan_splits``, the host-side plan of the split.
* The wrappers' dtype dispatch and refusals.

Tolerances, as ``|got - want| <= tol x (1 + |want|)``: fp32 1e-5 (both
sides accumulate in fp32, in another order); bf16 1.6e-2 -- inputs and
output are rounded to bf16 (2^-8 relative), and the sums run in another
order.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import ops as dec_ops  # noqa: E402
from repro_torch.kernels.decode_attention.ref import (  # noqa: E402
    combine_partials_ref,
    decode_attention_ref,
    decode_attention_split_ref,
)
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


def _decode_inputs(case, seed, n_valid=None):
    """q (B,1,H,hd), caches (B,C,K,hd) in fp32 numpy, and n_valid: as
    given, else a 0 row, a full row and one in between."""
    b, h, kv, c, hd = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, 1, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, c, kv, hd)).astype(np.float32)
    v = rng.normal(size=(b, c, kv, hd)).astype(np.float32)
    if n_valid is None:
        n_valid = [0, c, int(rng.integers(1, c))][:b]
    return q, k, v, np.asarray(n_valid, np.int32)


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


H100_SMS = 132  # an H100 SXM's SMs, for the split plan
SPLIT_CASES = [
    # (b, h, kv, cache_len, hd, span, n_valid, block_c of the Pallas kernel)
    # GQA 1, span 64: a row on the first boundary, one with 1 live slot
    # (three splits with none), one at capacity
    (4, 4, 4, 256, 64, 64, [0, 1, 64, 256], 64),
    # GQA 3: the rows either side of the boundary at 128
    (4, 15, 5, 200, 64, 128, [0, 128, 129, 200], 64),
    # hd 128, a span longer than the cache: one split
    (2, 8, 2, 130, 128, 192, [130, 5], 64),
    # hd 256, RecurrentGemma's MQA (10 q-heads over 1 kv head)
    (3, 10, 1, 150, 256, 64, [0, 64, 150], 64),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SPLIT_CASES, ids=[str(c[:6]) for c in SPLIT_CASES])
def test_split_twin_matches_unsplit_twin_and_pallas(case, dtype, jax_kernels):
    import jax.numpy as jnp

    decode_attention_bhd = jax_kernels[0]
    b, h, kv, c, hd, span, _, block_c = case
    q, k, v, n_valid = _decode_inputs(case, seed=c + span, n_valid=case[6])
    args = (_torch(q, dtype), _torch(k, dtype), _torch(v, dtype), torch.tensor(n_valid))
    got = decode_attention_split_ref(*args, span=span).float().numpy()
    _close(got, decode_attention_ref(*args).float().numpy(), dtype)
    jd = getattr(jnp, dtype)
    jq, jk, jv = (jnp.asarray(_fold(a)).astype(jd) for a in (q, k, v))
    pallas = decode_attention_bhd(jq, jk, jv, jnp.asarray(n_valid), n_q_heads=h,
                                  n_kv_heads=kv, block_c=block_c, interpret=True)
    _close(got, _unfold(pallas, b), dtype)
    for row in np.flatnonzero(n_valid == 0):
        assert not got[row].any(), "a row with n_valid = 0 must give zeros"


@pytest.mark.parametrize("span", [64, 128, 192, 320, 4096])
def test_split_twin_at_every_span_equals_the_unsplit_twin(span):
    """fp32, one cache of 300 slots, every live count from 0 to capacity
    in steps that land on, before and after the span's boundaries."""
    case = (8, 6, 2, 300, 64, span, [0, 1, 63, 64, 65, 191, 299, 300], 64)
    q, k, v, n_valid = _decode_inputs(case, seed=span, n_valid=case[6])
    args = (_torch(q, "float32"), _torch(k, "float32"), _torch(v, "float32"),
            torch.tensor(n_valid))
    _close(decode_attention_split_ref(*args, span=span).numpy(),
           decode_attention_ref(*args).numpy(), "float32")


def test_combine_twin_guards_empty_splits_and_empty_rows():
    """A split with m = -inf and l = 0 weighs nothing; a row whose every
    split is empty gives zeros, not NaN."""
    acc = torch.tensor([[[[2.0, 4.0]]], [[[0.0, 0.0]]], [[[3.0, 3.0]]]])  # (3, 1, 1, 2)
    m = torch.tensor([[[0.5]], [[float("-inf")]], [[0.5]]])
    l = torch.tensor([[[1.0]], [[0.0]], [[2.0]]])
    out = combine_partials_ref(acc, m, l, torch.float32)
    torch.testing.assert_close(out, torch.tensor([[[[5 / 3, 7 / 3]]]]))
    empty = combine_partials_ref(torch.zeros(2, 1, 1, 2), torch.full((2, 1, 1), float("-inf")),
                                 torch.zeros(2, 1, 1), torch.bfloat16)
    assert empty.dtype == torch.bfloat16 and not empty.any()


@pytest.mark.parametrize("c", [1, 300, 2048, 4095, 4096, 4097, 8192, 32768, 100_000, 1 << 20])
@pytest.mark.parametrize("b,n_kv,group", [(1, 1, 1), (8, 5, 3), (8, 1, 10), (1, 4, 8)])
def test_plan_splits_covers_the_cache_in_aligned_spans(c, b, n_kv, group):
    splits, span = dec_ops.plan_splits(b, c, n_kv, group, H100_SMS)
    assert splits >= 1 and splits * span >= c and (splits - 1) * span < c
    assert span % dec_ops.SPAN_ALIGN == 0
    if c <= dec_ops.MIN_SPAN:
        assert splits == 1
    else:
        assert span >= dec_ops.MIN_SPAN or splits == 1


def test_plan_splits_fills_the_card_in_whole_waves_on_a_long_cache():
    """SmolLM-360M's attention (5 kv heads, groups of 3) at batch 8 over
    32,768 slots. Where an SM holds 3 split blocks, 8 splits give 320
    blocks, at least two per SM, in one wave; where it holds 2, a grid of
    at least 264 blocks would spill a few blocks into a second wave, so
    the plan takes the most splits that fit one wave: 6 (240 blocks). The
    serving paths' caches stay one split."""
    per_block = 8 * 5 * 1  # B x K x ceil(group / group_tile), one q-head tile
    assert dec_ops.group_tile(3) >= 3
    for per_sm, want in ((3, (8, 4096)), (2, (6, 5504))):
        splits, span = dec_ops.plan_splits(8, 32768, 5, 3, H100_SMS, per_sm)
        assert (splits, span) == want
        slots = H100_SMS * per_sm
        assert per_block * splits <= slots
        assert per_block * (splits + 1) > slots or splits == 32768 // dec_ops.MIN_SPAN
    assert per_block * 8 >= 2 * H100_SMS
    assert dec_ops.plan_splits(8, 4096, 5, 3, H100_SMS)[0] == 1
    assert dec_ops.plan_splits(8, 2048, 1, 10, H100_SMS, 2, 256)[0] == 1


def test_group_tile_holds_the_group_up_to_eight_or_four_at_hd_256():
    groups = (1, 2, 3, 4, 5, 8, 10, 16)
    assert [dec_ops.group_tile(g) for g in groups] == [1, 2, 4, 4, 8, 8, 8, 8]
    assert [dec_ops.group_tile(g, 256) for g in groups] == [1, 2, 4, 4, 4, 4, 4, 4]


def test_flash_wrapper_dispatches_each_dtype_to_its_source():
    assert fl_ops.SOURCES == {torch.bfloat16: "flash_attention_tc",
                              torch.float32: "flash_attention"}
    assert set(fl_ops.LIBS.names()) == set(fl_ops.SOURCES.values())


def test_flash_wrapper_refuses_operands_it_cannot_copy_in_16_byte_chunks():
    ok = torch.zeros(1, 8, 4, 64, dtype=torch.bfloat16)
    fl_ops.check_kernel_operands(q=ok, k=ok, v=ok)
    shifted = torch.zeros(1 + ok.numel(), dtype=torch.bfloat16)[1:].view(ok.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16
    with pytest.raises(ValueError, match="k must be contiguous and 16-byte aligned"):
        fl_ops.check_kernel_operands(q=ok, k=shifted, v=ok)
    with pytest.raises(ValueError, match="q must be contiguous"):
        fl_ops.check_kernel_operands(q=ok.transpose(1, 2), k=ok, v=ok)


def test_combine_wrapper_dispatches_cpu_tensors_to_its_twin():
    rng = np.random.default_rng(0)
    acc = torch.tensor(rng.normal(size=(3, 2, 4, 64)), dtype=torch.float32)
    m = torch.tensor(rng.normal(size=(3, 2, 4)), dtype=torch.float32)
    m[1, 0] = float("-inf")
    l = torch.tensor(rng.uniform(0.5, 2.0, size=(3, 2, 4)), dtype=torch.float32)
    l[1, 0] = 0.0
    before = dec_ops.decode_attention.combine_launches
    out = dec_ops.combine_partials(acc, torch.stack([m, l]), torch.empty(2, 1, 4, 64))
    torch.testing.assert_close(out, combine_partials_ref(acc, m, l, torch.float32),
                               rtol=0, atol=0)
    assert dec_ops.decode_attention.combine_launches == before
    with pytest.raises(ValueError, match="combine_partials"):
        dec_ops.combine_partials(acc, torch.stack([m, l])[:, :2], torch.empty(2, 1, 4, 64))


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


# bf16 goes to the tensor-core kernel: the long sequences it is for, at
# every head size, causal and window-only (b, h, kv, seq, hd, causal,
# window)
TC_FLASH_CASES = [
    (1, 4, 2, 4096, 64, True, 0),
    (1, 4, 2, 4096, 128, True, 0),
    (1, 2, 1, 4096, 256, True, 0),
    (1, 4, 2, 1000, 128, False, 300),
    (1, 10, 1, 777, 256, False, 100),
    (2, 15, 5, 4096, 64, True, 1000),
    # enough q tiles at hd 64 for two 16-row m-tiles a warp, ragged
    (4, 16, 4, 1000, 64, False, 300),
    (3, 16, 8, 1000, 64, True, 100),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", TC_FLASH_CASES, ids=[str(c) for c in TC_FLASH_CASES])
def test_tensor_core_flash_matches_twin_on_card(case, cuda):
    b, h, kv, s, hd, causal, window = case
    rng = np.random.default_rng(s + hd)
    q = _torch(rng.normal(size=(b, s, h, hd)), "bfloat16", cuda)
    k = _torch(rng.normal(size=(b, s, kv, hd)), "bfloat16", cuda)
    v = _torch(rng.normal(size=(b, s, kv, hd)), "bfloat16", cuda)
    before = fl_ops.flash_attention.launches
    got = fl_ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert fl_ops.flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal, window=window)
    _close(got.float().cpu(), want.float().cpu(), "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_split_path_matches_twin_on_card(dtype, cuda):
    """A 32,768-slot cache splits over blocks and the combine kernel
    merges them; one batch holds an empty row, one live slot, rows about
    4,096, the rows either side of the planned split boundary, and a full
    row."""
    b, h, kv, c, hd = 9, 15, 5, 32768, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, 1, h, hd, generator=gen, device=cuda).to(getattr(torch, dtype))
    k, v = (torch.randn(b, c, kv, hd, generator=gen, device=cuda).to(q.dtype)
            for _ in range(2))
    splits, span = dec_ops.split_plan(q, k)
    assert splits > 1
    n_valid = [0, 1, 4095, 4096, 4097, 20000, 32768, span, span + 1]
    nv = torch.tensor(n_valid, dtype=torch.int32, device=cuda)
    before = (dec_ops.decode_attention.launches, dec_ops.decode_attention.combine_launches)
    got = dec_ops.decode_attention(q, k, v, nv)
    torch.cuda.synchronize()
    assert (dec_ops.decode_attention.launches,
            dec_ops.decode_attention.combine_launches) == (before[0] + 1, before[1] + 1)
    _close(got.float().cpu(), decode_attention_ref(q, k, v, nv).float().cpu(), dtype)
    assert not got[0].any()
