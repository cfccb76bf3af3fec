"""The backward of the port's kernel wrappers: ``flash_attention``,
``wkv6`` and ``rglru_scan`` are ``torch.autograd.Function``s whose
forward is the device dispatch (the twin here, the hand kernel on the
card) and whose backward is a closed-form gradient in plain PyTorch
(``ref.attention_backward``, ``wkv6_backward``, ``rglru_backward``), the
same code on both devices. Held here:

* against autograd through the plain twins at fp32 (GQA, MQA, sliding
  windows, non-causal, S 1, batched WKV-6 bonus): within 1e-5 of each
  gradient's scale (one fp32 function, summed in another order); at
  bf16 (flash), 1e-2 of the scale (both round the same fp32 gradient to
  bf16);
* ``torch.autograd.gradcheck`` at fp64 on the Functions themselves (the
  twins and the backwards compute in fp64 for fp64 inputs; the public
  wrappers take the kernels' dtypes and WKV-6's head size 64 only, the
  Functions any), at its default tolerances;
* the launch counters: a CPU call, forward or backward, counts nothing.

The card cases (``cuda`` marker; ``python -m pytest -q -m cuda
tests/test_torch_kernel_grads.py`` on a machine with a card) hold the
kernels' Functions against autograd through the twins on the card, and
a smoke model's every leaf gradient against the CPU's, none zero.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fl import tree_map, value_and_grad  # noqa: E402
from repro_torch.core.packing import tree_leaves  # noqa: E402
from repro_torch.kernels.flash_attention.ops import FlashAttention, flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import RGLRUScan, rglru_scan  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_ref  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ops import WKV6, wkv6  # noqa: E402
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.trainer import stack_for_nodes  # noqa: E402


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _t(a, device="cpu", dtype=torch.float32):
    return torch.from_numpy(np.asarray(a, np.float32)).to(device=device, dtype=dtype)


def _grads(fn, inputs, seed):
    """Gradients of sum(out * cotangent) over ``fn``'s outputs."""
    inputs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    rng = np.random.default_rng(seed)
    cots = [_t(rng.normal(size=o.shape), o.device, o.dtype) for o in outs]
    return torch.autograd.grad(outs, inputs, cots)


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        scale = float(w.float().abs().max())
        if scale == 0.0:  # e.g. s0 and log_w under a decay that forgets in a step
            assert float(g.float().abs().max()) == 0.0
            continue
        assert float((g.float() - w.float()).abs().max()) <= tol * scale


def _attn_inputs(b, s, h, k, hd, seed, device="cpu", dtype=torch.float32):
    rng = np.random.default_rng(seed)
    return (_t(rng.normal(size=(b, s, h, hd)), device, dtype),
            _t(rng.normal(size=(b, s, k, hd)), device, dtype),
            _t(rng.normal(size=(b, s, k, hd)), device, dtype))


def _wkv_inputs(b, s, h, seed, device="cpu", decay="random"):
    """The reference suite's draws: r, v ~ N(0, 1), k ~ N(0, 1/4),
    log_w = -exp(N(-1, 1)), u ~ N(0, 0.09), s0 ~ N(0, 0.01)."""
    rng = np.random.default_rng(seed)
    log_w = -np.exp(rng.normal(size=(b, s, h, 64)) - 1.0)
    if decay == "strong":
        log_w[:] = -np.exp(10.0)
    return tuple(_t(a, device) for a in (
        rng.normal(size=(b, s, h, 64)), 0.5 * rng.normal(size=(b, s, h, 64)),
        rng.normal(size=(b, s, h, 64)), log_w, 0.3 * rng.normal(size=(h, 64)),
        0.1 * rng.normal(size=(b, h, 64, 64))))


def _lru_inputs(b, s, w, seed, device="cpu"):
    rng = np.random.default_rng(seed)
    return tuple(_t(a, device) for a in (-np.exp(rng.normal(size=(b, s, w))),
                                         rng.normal(size=(b, s, w)),
                                         rng.normal(size=(b, w))))


def _wkv_twin(r, k, v, log_w, u, s0):
    """The twin in the model layout, differentiable by autograd."""
    b, s, h, hd = r.shape

    def fold(a):
        return a.transpose(1, 2).reshape(b * h, s, hd)

    y, s_fin = wkv6_ref(fold(r), fold(k), fold(v), fold(log_w),
                        u[None].expand(b, h, hd).reshape(b * h, hd), s0.reshape(b * h, hd, hd))
    return y.reshape(b, h, s, hd).transpose(1, 2), s_fin.reshape(b, h, hd, hd)


ATTN_CASES = [  # (B, S, H, K, hd, causal, window)
    (1, 13, 6, 2, 64, True, 0),     # GQA, causal
    (2, 9, 4, 1, 64, True, 0),      # MQA
    (1, 17, 4, 2, 128, True, 5),    # a sliding window that masks
    (2, 8, 2, 2, 64, False, 0),     # MHA, not causal
    (1, 11, 2, 1, 256, False, 3),   # window without causality, hd 256
]


@pytest.mark.parametrize("case", ATTN_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_matches_autograd_through_the_twin(case, dtype):
    b, s, h, k, hd, causal, window = case
    args = _attn_inputs(b, s, h, k, hd, seed=s, dtype=dtype)
    got = _grads(lambda *a: flash_attention(*a, causal=causal, window=window), args, 1)
    want = _grads(lambda *a: attention_ref(*a, causal=causal, window=window), args, 1)
    _close(got, want, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("case", [(2, 7, 3, "random"), (1, 1, 2, "random"),
                                  (2, 20, 1, "random"), (1, 9, 2, "strong")])
def test_wkv6_backward_matches_autograd_through_the_twin(case):
    b, s, h, decay = case
    args = _wkv_inputs(b, s, h, seed=s, decay=decay)
    got = _grads(wkv6, args, 2)
    want = _grads(_wkv_twin, args, 2)
    assert got[4].shape == (h, 64)  # u's gradient summed over the batch
    _close(got, want, 1e-5)


@pytest.mark.parametrize("case", [(2, 9, 40), (1, 1, 7), (3, 33, 256)])
def test_rglru_backward_matches_autograd_through_the_twin(case):
    args = _lru_inputs(*case, seed=case[1])
    _close(_grads(rglru_scan, args, 3), _grads(rglru_ref, args, 3), 1e-5)


def test_gradcheck_fp64():
    rng = np.random.default_rng(0)

    def f64(*shape, scale=1.0):
        return torch.from_numpy(scale * rng.normal(size=shape)).requires_grad_(True)

    q, k, v = f64(1, 6, 4, 8), f64(1, 6, 2, 8), f64(1, 6, 2, 8)
    for causal, window in ((True, 0), (True, 3), (False, 2)):
        assert torch.autograd.gradcheck(
            lambda a, b, c: FlashAttention.apply(a, b, c, causal, window), (q, k, v))
    r, kk, vv = f64(2, 5, 2, 4), f64(2, 5, 2, 4, scale=0.5), f64(2, 5, 2, 4)
    log_w = (-torch.exp(torch.from_numpy(rng.normal(size=(2, 5, 2, 4)) - 1.0))
             ).requires_grad_(True)
    u, s0 = f64(2, 4, scale=0.3), f64(2, 2, 4, 4, scale=0.1)
    assert torch.autograd.gradcheck(WKV6.apply, (r, kk, vv, log_w, u, s0))
    log_a = (-torch.exp(torch.from_numpy(rng.normal(size=(2, 6, 5))))).requires_grad_(True)
    assert torch.autograd.gradcheck(RGLRUScan.apply, (log_a, f64(2, 6, 5), f64(2, 5)))


def test_cpu_calls_count_no_launch():
    counters = (flash_attention, wkv6, rglru_scan)
    before = [c.launches for c in counters]
    _grads(flash_attention, _attn_inputs(1, 5, 2, 1, 64, seed=0), 0)
    _grads(wkv6, _wkv_inputs(1, 3, 1, seed=0), 0)
    _grads(rglru_scan, _lru_inputs(1, 4, 8, seed=0), 0)
    assert [c.launches for c in counters] == before


def test_wrappers_are_differentiable_in_every_operand():
    q, k, v = (x.requires_grad_(True) for x in _attn_inputs(1, 5, 2, 1, 64, seed=1))
    flash_attention(q, k, v).sum().backward()
    assert all(x.grad is not None and float(x.grad.abs().max()) > 0 for x in (q, k, v))
    args = [x.requires_grad_(True) for x in _wkv_inputs(2, 4, 1, seed=1)]
    y, s_fin = wkv6(*args)
    (y.sum() + s_fin.sum()).backward()
    assert all(float(x.grad.abs().max()) > 0 for x in args)
    args = [x.requires_grad_(True) for x in _lru_inputs(1, 4, 8, seed=1)]
    h, h_last = rglru_scan(*args)
    (h.sum() + h_last.sum()).backward()
    assert all(float(x.grad.abs().max()) > 0 for x in args)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ATTN_CASES[:3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_gradients_on_card(case, dtype, cuda):
    """The kernel forward with the closed-form backward against autograd
    through the twin, both on the card: fp32 1e-3 (the kernel's output
    feeds the backward, within the forward's own 1e-5), bf16 5e-2."""
    b, s, h, k, hd, causal, window = case
    args = _attn_inputs(b, s, h, k, hd, seed=s, device=cuda, dtype=dtype)
    launches = flash_attention.launches
    got = _grads(lambda *a: flash_attention(*a, causal=causal, window=window), args, 1)
    assert flash_attention.launches == launches + 1
    want = _grads(lambda *a: attention_ref(*a, causal=causal, window=window), args, 1)
    _close(got, want, 1e-3 if dtype == torch.float32 else 5e-2)


@pytest.mark.cuda
def test_scan_gradients_on_card(cuda):
    """WKV-6 at RWKV6-7B's 64 heads and RG-LRU at RecurrentGemma-2B's
    width, S 128: within 1e-3 of the scale (the kernels' outputs are
    within the forward tolerances of the twins')."""
    args = _wkv_inputs(1, 128, 64, seed=4, device=cuda)
    _close(_grads(wkv6, args, 2), _grads(_wkv_twin, args, 2), 1e-3)
    args = _lru_inputs(1, 128, 2560, seed=5, device=cuda)
    _close(_grads(rglru_scan, args, 3), _grads(rglru_ref, args, 3), 1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-360m", "recurrentgemma-2b", "rwkv6-7b"])
def test_smoke_model_gradients_on_card(arch, cuda):
    """A smoke model's node-batched loss on the card: every leaf's
    gradient nonzero and within 1e-3 of the CPU's at fp32 compute (2e-3
    for RWKV6: its first-step bonus, see tests/test_torch_lm_loss.py)."""
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")
    bundle = build_model(cfg)
    host = stack_for_nodes(bundle.init_fn(torch.Generator().manual_seed(0), device="cpu"), 2)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 1, 33)).astype(np.int32))
    grad_fn = value_and_grad(bundle.loss_fn)
    _, got = grad_fn(tree_map(lambda a: a.to(cuda), host), {"tokens": toks.to(cuda)})
    _, want = grad_fn(host, {"tokens": toks})
    tol = 2e-3 if arch == "rwkv6-7b" else 1e-3
    for (path, g), (_, w) in zip(tree_leaves(got), tree_leaves(want)):
        assert float(g.abs().max()) > 0, path
        _close([g.cpu()], [w], tol)
