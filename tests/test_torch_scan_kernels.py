"""The recurrence kernels of the PyTorch port
(``repro_torch.kernels.rwkv6_scan`` and ``.rglru_scan``).

* Their plain PyTorch twins against the JAX package's naive oracles and
  its Pallas kernels (interpret mode on the CPU, as the JAX suite runs
  them), from identical numpy inputs, at the reference suite's cases
  (``tests/test_kernels.py``) plus S = 1, a length that is not a multiple
  of the chunk, and strong decay.
* The wrappers in the model layout against the reference's model-layout
  dispatch (``repro.kernels.*.ops``).
* The CUDA kernels against the twins on the card (``cuda`` marker: they
  skip without one; ``python -m pytest -q -m cuda
  tests/test_torch_scan_kernels.py`` runs them there, where JAX is not
  needed), at the CPU cases and at the models' widths, S 4096, the decay
  clip, S either side of WKV-6's 16-step chunk and ragged RG-LRU widths
  and lengths; RG-LRU bitwise.
* The wrappers' refusals.

Tolerances are the reference suite's own for these functions: WKV-6 atol
5e-4, rtol 1e-3 (the chunked and the step forms sum in another order
over states that grow with S); RG-LRU 1e-4 (atol and rtol).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.rglru_scan import ops as lru_ops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan import ops as wkv_ops  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402

WKV_TOL = dict(atol=5e-4, rtol=1e-3)
LRU_TOL = dict(atol=1e-4, rtol=1e-4)

WKV_CASES = [
    # (bh, seq, chunk of the Pallas kernel, decay): the reference suite's
    # four, S = 1, S = 200 (not a multiple of 64), and strong decay
    # (log_w = -e^10, what the model's clip allows) and none (log_w ~ 0).
    # Strong decay runs the Pallas kernel at chunk 1, the reference's
    # decode path: within a longer chunk its cumulative log decays reach
    # -1.4e6 at chunk 64, where the fp32 ulp is 0.125, so its pairwise
    # ratios e^{cum_t - cum_a} are off by up to 13% and the reference's
    # kernel departs from its own oracle by up to 2.0 there. The twin
    # runs the step form, which has no cumulative sums.
    (4, 128, 64, "random"),
    (2, 256, 32, "random"),
    (3, 64, 64, "random"),
    (1, 512, 128, "random"),
    (3, 1, 1, "random"),
    (2, 200, 8, "random"),
    (2, 128, 1, "strong"),
    (2, 128, 64, "none"),
    # S either side of the CUDA kernel's 16-step chunk
    (2, 15, 1, "random"),
    (2, 17, 1, "random"),
]
LRU_CASES = [
    # (b, seq, width, block_d, chunk of the Pallas kernel): the reference
    # suite's four, S = 1, and a width that is not a multiple of 128
    (2, 128, 256, 128, 64),
    (3, 64, 128, 128, 64),
    (2, 256, 384, 128, 32),
    (1, 512, 128, 64, 128),
    (3, 1, 256, 128, 1),
    (2, 100, 200, 200, 4),
    # S one past the CUDA kernel's 32-step tile; a width that is not a
    # multiple of 4 (the kernel's 4-byte copies)
    (2, 33, 256, 128, 3),
    (3, 45, 199, 199, 5),
]
# The card's cases, (B, H, S, decay) and (B, S, W): the CPU cases (WKV-6 at
# B 1, H = bh), then the models' widths (RWKV6-7B: B 8, H 64; RecurrentGemma-
# 2B: B 8, W 2560) at S 4096, the prefill and decode shapes and WKV-6's
# decay clip on the prefill shape, and S at a 16-step chunk and one past two
WKV_CARD_CASES = [(1, bh, seq, decay) for bh, seq, _, decay in WKV_CASES] + [
    (8, 64, 4096, "random"), (8, 64, 128, "random"), (8, 64, 1, "random"),
    (8, 64, 128, "strong"), (2, 3, 16, "random"), (2, 3, 33, "random"),
]
LRU_CARD_CASES = [(b, seq, w) for b, seq, w, _, _ in LRU_CASES] + [
    (8, 4096, 2560), (8, 128, 2560), (8, 1, 2560),
]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def jax_scans():
    """The JAX package's oracles, Pallas kernels and model-layout ops
    (imported here, not at module level, so the card-only tests run
    where JAX is absent)."""
    pytest.importorskip("jax")
    from repro.kernels.rglru_scan import ops as j_lru_ops
    from repro.kernels.rglru_scan.ref import rglru_ref as j_lru_ref
    from repro.kernels.rglru_scan.rglru_scan import rglru_scan_pallas
    from repro.kernels.rwkv6_scan import ops as j_wkv_ops
    from repro.kernels.rwkv6_scan.ref import wkv6_ref as j_wkv_ref
    from repro.kernels.rwkv6_scan.rwkv6_scan import wkv6_chunked_pallas

    return dict(wkv_ref=j_wkv_ref, wkv_pallas=wkv6_chunked_pallas, wkv_ops=j_wkv_ops,
                lru_ref=j_lru_ref, lru_pallas=rglru_scan_pallas, lru_ops=j_lru_ops)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (python3 chip_smoke.py runs the same checks there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _wkv_inputs(bh, seq, decay, seed, hd=64):
    """The reference suite's draws: r, v ~ N(0, 1), k ~ N(0, 0.25), log_w
    = -exp(N(-1, 1)), u ~ N(0, 0.09), s0 ~ N(0, 0.01); fp32 numpy."""
    rng = np.random.default_rng(seed)
    r = rng.normal(size=(bh, seq, hd)).astype(np.float32)
    k = (0.5 * rng.normal(size=(bh, seq, hd))).astype(np.float32)
    v = rng.normal(size=(bh, seq, hd)).astype(np.float32)
    log_w = -np.exp(rng.normal(size=(bh, seq, hd)) - 1.0).astype(np.float32)
    if decay == "strong":
        log_w = np.full_like(log_w, -np.exp(10.0))
    elif decay == "none":
        log_w = np.full_like(log_w, -1e-6)
    u = (0.3 * rng.normal(size=(bh, hd))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(bh, hd, hd))).astype(np.float32)
    return r, k, v, log_w, u, s0


def _wkv_card_inputs(b, h, seq, decay, seed, device):
    """``_wkv_inputs``'s distributions in the model layout (r, k, v, log_w
    (B, S, H, 64), u (H, 64), s0 (B, H, 64, 64)), drawn on the card."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=device)

    r, k, v = rand(b, seq, h, 64), rand(b, seq, h, 64, scale=0.5), rand(b, seq, h, 64)
    log_w = -torch.exp(rand(b, seq, h, 64) - 1.0)
    if decay == "strong":
        log_w.fill_(-float(np.exp(10.0)))
    elif decay == "none":
        log_w.fill_(-1e-6)
    return r, k, v, log_w, rand(h, 64, scale=0.3), rand(b, h, 64, 64, scale=0.1)


def _wkv_twin(r, k, v, log_w, u, s0):
    """The twin in the model layout (it takes the folded one)."""
    b, s, h, hd = r.shape

    def fold(a):
        return a.transpose(1, 2).reshape(b * h, s, hd)

    y, s_fin = wkv6_ref(fold(r), fold(k), fold(v), fold(log_w),
                        u[None].expand(b, h, hd).reshape(b * h, hd), s0.reshape(b * h, hd, hd))
    return y.reshape(b, h, s, hd).transpose(1, 2), s_fin.reshape(b, h, hd, hd)


def _close_on_card(got, want, tol):
    """``_close`` without the copy to the host: |got - want| <= atol + rtol
    |want| everywhere, outputs finite."""
    assert got.shape == want.shape and torch.isfinite(got).all()
    excess = float(((got - want).abs() - (tol["atol"] + tol["rtol"] * want.abs())).max())
    assert excess <= 0, f"off by {float((got - want).abs().max())}"


def _lru_inputs(b, seq, w, seed):
    rng = np.random.default_rng(seed)
    log_a = -np.exp(rng.normal(size=(b, seq, w))).astype(np.float32)
    bb = rng.normal(size=(b, seq, w)).astype(np.float32)
    h0 = rng.normal(size=(b, w)).astype(np.float32)
    return log_a, bb, h0


def _t(arrays, device="cpu"):
    return [torch.tensor(a, device=device) for a in arrays]


def _np(x):
    return x.float().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(
        x, np.float32)


def _close(got, want, tol):
    np.testing.assert_allclose(_np(got), _np(want), **tol)


@pytest.mark.parametrize("case", WKV_CASES, ids=[str(c) for c in WKV_CASES])
def test_wkv6_twin_matches_reference_oracle_and_pallas(case, jax_scans):
    import jax.numpy as jnp

    bh, seq, chunk, decay = case
    arrays = _wkv_inputs(bh, seq, decay, seed=seq + bh)
    y, s = wkv6_ref(*_t(arrays))
    assert y.shape == (bh, seq, 64) and s.shape == (bh, 64, 64)
    assert y.dtype == s.dtype == torch.float32
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ja = [jnp.asarray(a) for a in arrays]
    y_r, s_r = jax_scans["wkv_ref"](*ja)
    y_p, s_p = jax_scans["wkv_pallas"](*ja, chunk=chunk, interpret=True)
    for want_y, want_s in ((y_r, s_r), (y_p, s_p)):
        _close(y, want_y, WKV_TOL)
        _close(s, want_s, WKV_TOL)
    if decay == "strong":  # exp(-e^10) = 0: only the current token's k v^T survives
        kv = arrays[1][:, -1, :, None] * arrays[2][:, -1, None, :]
        _close(s, kv, WKV_TOL)


@pytest.mark.parametrize("seq", [1, 64, 200])
def test_wkv6_wrapper_matches_reference_ops_in_model_layout(seq, jax_scans):
    """``ops.wkv6`` folds the model layout (B, S, H, 64) with u (H, 64) the
    way the reference's ``ops.wkv6`` does, at any S (the reference falls
    back to chunk 1 where S is not a multiple of 64; the port has no
    chunk)."""
    import jax.numpy as jnp

    b, h = 2, 3
    r, k, v, log_w, _, _ = _wkv_inputs(b * h, seq, "random", seed=seq)
    rng = np.random.default_rng(1)
    u = (0.3 * rng.normal(size=(h, 64))).astype(np.float32)
    s0 = (0.1 * rng.normal(size=(b, h, 64, 64))).astype(np.float32)

    def model(a):  # (B*H, S, 64) draws -> (B, S, H, 64)
        return np.ascontiguousarray(a.reshape(b, h, seq, 64).transpose(0, 2, 1, 3))

    arrays = [model(a) for a in (r, k, v, log_w)] + [u, s0]
    wkv_ops.wkv6.launches = 0
    y, s = wkv_ops.wkv6(*_t(arrays))
    assert wkv_ops.wkv6.launches == 0  # the twin ran, not the kernel
    y_j, s_j = jax_scans["wkv_ops"].wkv6(*[jnp.asarray(a) for a in arrays])
    assert y.shape == (b, seq, h, 64) and s.shape == (b, h, 64, 64)
    _close(y, y_j, WKV_TOL)
    _close(s, s_j, WKV_TOL)


@pytest.mark.parametrize("case", LRU_CASES, ids=[str(c) for c in LRU_CASES])
def test_rglru_twin_matches_reference_oracle_and_pallas(case, jax_scans):
    import jax.numpy as jnp

    b, seq, w, bd, ck = case
    arrays = _lru_inputs(b, seq, w, seed=b * seq)
    h, h_last = rglru_ref(*_t(arrays))
    assert h.shape == (b, seq, w) and h_last.shape == (b, w)
    ja = [jnp.asarray(a) for a in arrays]
    h_r, hl_r = jax_scans["lru_ref"](*ja)
    h_p, hl_p = jax_scans["lru_pallas"](*ja, block_d=bd, chunk=ck, interpret=True)
    for want_h, want_last in ((h_r, hl_r), (h_p, hl_p)):
        _close(h, want_h, LRU_TOL)
        _close(h_last, want_last, LRU_TOL)


def test_rglru_wrapper_matches_reference_ops(jax_scans):
    import jax.numpy as jnp

    arrays = _lru_inputs(2, 96, 320, seed=3)
    lru_ops.rglru_scan.launches = 0
    h, h_last = lru_ops.rglru_scan(*_t(arrays))
    assert lru_ops.rglru_scan.launches == 0
    h_j, hl_j = jax_scans["lru_ops"].rglru_scan(*[jnp.asarray(a) for a in arrays])
    _close(h, h_j, LRU_TOL)
    _close(h_last, hl_j, LRU_TOL)


def test_rglru_strong_decay_stability():
    """The reference suite's case: log_a = -60 forgets h0 = 1e6 in one
    step, so every later h is b = 1, finite."""
    b, s, w = 1, 64, 128
    log_a = torch.full((b, s, w), -60.0)
    h, h_last = lru_ops.rglru_scan(log_a, torch.ones(b, s, w), torch.full((b, w), 1e6))
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h[:, 1:], torch.ones(b, s - 1, w), rtol=0, atol=1e-5)
    torch.testing.assert_close(h_last, torch.ones(b, w), rtol=0, atol=1e-5)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    r = torch.zeros(1, 4, 2, 64)
    u, s0 = torch.zeros(2, 64), torch.zeros(1, 2, 64, 64)
    with pytest.raises(ValueError, match="64"):
        wkv_ops.wkv6(torch.zeros(1, 4, 2, 32), r, r, r, u, s0)
    with pytest.raises(ValueError, match="empty"):
        e = torch.zeros(1, 0, 2, 64)
        wkv_ops.wkv6(e, e, e, e, u, s0)
    with pytest.raises(ValueError, match="u must be"):
        wkv_ops.wkv6(r, r, r, r, torch.zeros(3, 64), s0)
    with pytest.raises(ValueError, match="s0 must be"):
        wkv_ops.wkv6(r, r, r, r, u, torch.zeros(2, 2, 64, 64))
    with pytest.raises(TypeError, match="float32"):
        wkv_ops.wkv6(r.bfloat16(), r, r, r, u, s0)
    la = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="S >= 1"):
        lru_ops.rglru_scan(torch.zeros(2, 0, 8), torch.zeros(2, 0, 8), torch.zeros(2, 8))
    with pytest.raises(ValueError, match="h0 must be"):
        lru_ops.rglru_scan(la, la, torch.zeros(2, 9))
    with pytest.raises(TypeError, match="float32"):
        lru_ops.rglru_scan(la, la.double(), torch.zeros(2, 8))


def test_wkv6_kernel_operands_must_be_contiguous_and_aligned():
    """The kernel copies its operands in 16-byte runs: the CUDA path
    refuses operands that are not contiguous or start off a 16-byte
    boundary (checked here on CPU tensors, which the twin would take)."""
    ok = torch.zeros(1, 4, 2, 64)
    wkv_ops.check_kernel_operands(r=ok, k=ok, v=ok, log_w=ok, u=torch.zeros(2, 64),
                                  s0=torch.zeros(1, 2, 64, 64))
    shifted = torch.zeros(ok.numel() + 1)[1:].view(ok.shape)
    with pytest.raises(ValueError, match="16-byte aligned"):
        wkv_ops.check_kernel_operands(r=ok, k=shifted)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops.check_kernel_operands(s0=torch.zeros(1, 2, 64, 64).transpose(2, 3))
    with pytest.raises(ValueError, match="u must be 16-byte aligned"):
        wkv_ops.check_kernel_operands(u=torch.zeros(2 * 64 + 1)[1:].view(2, 64))


# ---------------------------------------------------------------- the card


@pytest.mark.cuda
@pytest.mark.parametrize("case", WKV_CARD_CASES, ids=[str(c) for c in WKV_CARD_CASES])
def test_wkv6_kernel_matches_twin_on_card(case, cuda):
    b, h, seq, decay = case
    args = _wkv_card_inputs(b, h, seq, decay, seed=seq + b * h, device=cuda)
    before = wkv_ops.wkv6.launches
    y, s = wkv_ops.wkv6(*args)
    torch.cuda.synchronize()
    assert wkv_ops.wkv6.launches == before + 1
    y_t, s_t = _wkv_twin(*args)
    _close_on_card(y, y_t, WKV_TOL)
    _close_on_card(s, s_t, WKV_TOL)
    if decay == "strong":  # exp(-e^10) = 0: only the last k v^T is left
        k, v = args[1], args[2]
        _close_on_card(s, k[:, -1, :, :, None] * v[:, -1, :, None, :], WKV_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LRU_CARD_CASES, ids=[str(c) for c in LRU_CARD_CASES])
def test_rglru_kernel_matches_twin_on_card(case, cuda):
    b, seq, w = case
    args = _t(_lru_inputs(b, seq, w, seed=b * seq), cuda)
    before = lru_ops.rglru_scan.launches
    h, h_last = lru_ops.rglru_scan(*args)
    torch.cuda.synchronize()
    assert lru_ops.rglru_scan.launches == before + 1
    h_t, hl_t = rglru_ref(*args)
    _close(h, h_t, LRU_TOL)
    _close(h_last, hl_t, LRU_TOL)


@pytest.mark.cuda
def test_rglru_kernel_strong_decay_on_card(cuda):
    log_a = torch.full((1, 64, 128), -60.0, device=cuda)
    h, _ = lru_ops.rglru_scan(log_a, torch.ones_like(log_a),
                              torch.full((1, 128), 1e6, device=cuda))
    torch.cuda.synchronize()
    assert torch.isfinite(h).all()
    torch.testing.assert_close(h[:, 1:].cpu(), torch.ones(1, 63, 128), rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("case", LRU_CARD_CASES, ids=[str(c) for c in LRU_CARD_CASES])
def test_rglru_kernel_is_bitwise_the_twin_on_card(case, cuda):
    """The kernel follows the twin's arithmetic (exp, a rounded product, a
    rounded sum), so the two agree bit for bit."""
    b, seq, w = case
    args = _t(_lru_inputs(b, seq, w, seed=b * seq + 1), cuda)
    h, h_last = lru_ops.rglru_scan(*args)
    h_t, hl_t = rglru_ref(*args)
    assert torch.equal(h, h_t) and torch.equal(h_last, hl_t)


@pytest.mark.cuda
def test_rglru_kernel_takes_unaligned_inputs_on_card(cuda):
    """Inputs that start off a 16-byte boundary take the kernel's 4-byte
    copies, bitwise the twin as well."""
    log_a, bb, h0 = _t(_lru_inputs(2, 70, 65, seed=7), cuda)
    log_a, bb = log_a[..., 1:].contiguous(), bb[..., 1:].contiguous()
    shifted = [torch.empty(a.numel() + 1, device=cuda)[1:].view(a.shape) for a in (log_a, bb)]
    for dst, src in zip(shifted, (log_a, bb)):
        dst.copy_(src)
    assert shifted[0].data_ptr() % 16 and shifted[0].is_contiguous()
    args = (shifted[0], shifted[1], h0[:, 1:].contiguous())
    got, want = lru_ops.rglru_scan(*args), rglru_ref(*args)
    assert all(torch.equal(g, x) for g, x in zip(got, want))
