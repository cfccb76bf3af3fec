"""Dispatch for the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``), in the model layout.

CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to a
hand-written kernel chosen by dtype: bfloat16 (what serving runs) to the
tensor-core kernel in ``csrc/flash_attention_tc.cu``, float32 to the
fp32 kernel in ``csrc/flash_attention.cu``. There is no switch and no
fallback: a CUDA call that cannot launch raises. The wrapper allocates
the output, launches on the current stream without synchronizing, and
raises if the launch reports an error. On ``meta`` tensors (the dry
run) it allocates the output and launches nothing. It counts the
launches of both kernels, and the ``meta`` stand-ins, in
``flash_attention.launches`` (twin calls do not count).

``flash_attention`` is differentiable (:class:`FlashAttention`, a
``torch.autograd.Function``): its forward is the dispatch above, its
backward ``ref.attention_backward``, the closed-form gradient in plain
PyTorch, the same code on every device. It saves q, k, v and the output
and recomputes the probabilities; no kernel runs in the backward (the
reference's Pallas kernel defines no VJP; a hand backward kernel is
later work, ROADMAP.md queue 2).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BASE_FLAGS, KernelLibraries
from repro_torch.kernels.flash_attention.ref import attention_backward, attention_ref
from repro_torch.kernels.launches import launched

__all__ = ["flash_attention", "FlashAttention", "check_kernel_operands", "HEAD_DIMS", "LIBS", "SOURCES",
           "SMEM_LIMIT_BYTES"]

LIBS = KernelLibraries(Path(__file__).resolve().parent, BASE_FLAGS)
#: head sizes the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
#: dynamic shared memory one Hopper block may opt in to (227 KB)
SMEM_LIMIT_BYTES = 232448
#: the library (``csrc/<name>.cu``) that serves each dtype on the card
SOURCES = {torch.bfloat16: "flash_attention_tc", torch.float32: "flash_attention"}
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


@functools.cache
def _kernel(name: str) -> tuple:
    """``(launch, smem_bytes, error_string)`` of the built library ``name``,
    with their C signatures declared (pointers and the stream as void*, so
    ctypes never truncates them). Both libraries' launch takes (q, k, v,
    out, B, Sq, Sk, H, K, hd, causal, window, scale, stream)."""
    lib = LIBS.load(name)
    launch, smem, error = (getattr(lib, f"{name}_{fn}")
                           for fn in ("launch", "smem_bytes", "error_string"))
    launch.argtypes, launch.restype = [_P] * 4 + [_I] * 8 + [_F, _P], _I
    smem.argtypes, smem.restype = [_I], ctypes.c_size_t
    error.argtypes, error.restype = [_I], ctypes.c_char_p
    return launch, smem, error


def check_kernel_operands(**tensors: torch.Tensor) -> None:
    """The kernels read whole 16-byte chunks: every operand must be
    contiguous and start on a 16-byte boundary."""
    for name, t in tensors.items():
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             f"16-byte aligned")


def _check(q, k, v, window):
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"flash_attention: q (B, Sq, H, hd) and k/v (B, Sk, K, hd), "
                         f"got {tuple(q.shape)} / {tuple(k.shape)}")
    b, _, h, hd = q.shape
    if k.shape[0] != b or k.shape[3] != hd or v.shape != k.shape:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} / v {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if h % k.shape[2]:
        raise ValueError(f"flash_attention: {h} q-heads over {k.shape[2]} kv-heads")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {hd} not in {HEAD_DIMS}")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    for name, t in (("k", k), ("v", v)):
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q is {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on {q.device}")
    if q.dtype not in SOURCES:
        raise TypeError(f"flash_attention: {q.dtype} is not float32 or bfloat16")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention: tensors on {q.device} are not supported")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Self-attention over a full sequence, causal and/or within a
    sliding ``window`` (0: none), with GQA on un-repeated K/V.

    q (B, Sq, H, hd); k, v (B, Sk, K, hd) with K dividing H, q's dtype
    (float32 or bfloat16); hd 64, 128 or 256. Returns (B, Sq, H, hd) in q's
    dtype. Differentiable in q, k and v (:class:`FlashAttention`)."""
    _check(q, k, v, window)
    return FlashAttention.apply(q, k, v, bool(causal), int(window))


class FlashAttention(torch.autograd.Function):
    """The dispatch forward (:func:`_forward`) with the closed-form
    plain-PyTorch backward (``ref.attention_backward``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int):
        out = _forward(q, k, v, causal, window)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = attention_backward(q, k, v, out, d_out, causal=ctx.causal,
                                        window=ctx.window)
        return dq, dk, dv, None, None


def _forward(q, k, v, causal: bool, window: int) -> torch.Tensor:
    """The twin on CPU tensors, the dtype's hand kernel on CUDA ones, the
    kernel's output alone on ``meta`` ones."""
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    if q.device.type == "cuda":
        check_kernel_operands(q=q, k=k, v=v)
        launch, smem_bytes, error = _kernel(SOURCES[q.dtype])
        smem = smem_bytes(hd)
        if smem > SMEM_LIMIT_BYTES:
            raise ValueError(f"flash_attention: head size {hd} needs {smem} B of "
                             f"shared memory, over {SMEM_LIMIT_BYTES}")
        with torch.cuda.device(q.device):
            stream = torch.cuda.current_stream(q.device).cuda_stream
            err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq,
                         sk, h, n_kv, hd, int(bool(causal)), int(window), hd ** -0.5, stream)
        if err != 0:
            raise RuntimeError(f"{SOURCES[q.dtype]} kernel launch failed: "
                               + error(err).decode())
    launched(flash_attention, b=b, sq=sq, sk=sk, h=h, kv=n_kv, hd=hd, causal=bool(causal),
             window=int(window), itemsize=q.element_size())
    return out


flash_attention.launches = 0
