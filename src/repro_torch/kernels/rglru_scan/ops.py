"""Dispatch for the RG-LRU scan kernel (counterpart of
``repro.kernels.rglru_scan.ops``), in the model layout.

CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/rglru_scan.cu`` -- there is no switch,
no block or chunk size and no fallback: a CUDA call that cannot launch
raises. Any S >= 1 and any width W take the same path. The wrapper
allocates the outputs, launches on the current stream without
synchronizing, and raises if the launch reports an error. It counts its
kernel launches in ``rglru_scan.launches`` (twin calls do not count).

``rglru_scan`` is differentiable in log_a, b and h0 (:class:`RGLRUScan`,
a ``torch.autograd.Function``): its forward is the dispatch above, its
backward ``ref.rglru_backward``, the closed-form gradient in plain
PyTorch, the same code on every device, from the saved log_a, h0 and
output h. No kernel runs in the backward (the reference's Pallas kernel
defines no VJP; a hand backward kernel is later work, ROADMAP.md queue
2).
On ``meta`` tensors (the dry run) the wrapper allocates the kernel's
outputs, launches nothing and counts one launch.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels.build import BASE_FLAGS, KernelLibraries
from repro_torch.kernels.launches import launched
from repro_torch.kernels.rglru_scan.ref import rglru_backward, rglru_ref

__all__ = ["rglru_scan", "RGLRUScan", "LIBS"]

LIBS = KernelLibraries(Path(__file__).resolve().parent, BASE_FLAGS)
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them)."""
    lib = LIBS.load("rglru_scan")
    lib.rglru_scan_launch.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    lib.rglru_scan_launch.restype = _I
    lib.rglru_scan_error_string.argtypes = [_I]
    lib.rglru_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(log_a, b, h0):
    if log_a.ndim != 3 or log_a.shape[1] < 1:
        raise ValueError(f"rglru_scan: log_a must be (B, S >= 1, W), got "
                         f"{tuple(log_a.shape)}")
    if b.shape != log_a.shape:
        raise ValueError(f"rglru_scan: b {tuple(b.shape)} != log_a {tuple(log_a.shape)}")
    bsz, _, w = log_a.shape
    if tuple(h0.shape) != (bsz, w):
        raise ValueError(f"rglru_scan: h0 must be ({bsz}, {w}), got {tuple(h0.shape)}")
    for name, t in (("log_a", log_a), ("b", b), ("h0", h0)):
        if t.dtype != torch.float32:
            raise TypeError(f"rglru_scan: {name} is {t.dtype}, the kernel takes float32")
        if t.device != log_a.device:
            raise ValueError(f"rglru_scan: {name} on {t.device}, log_a on {log_a.device}")
    if log_a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rglru_scan: tensors on {log_a.device} are not supported")


def rglru_scan(log_a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = exp(log_a_t) h_{t-1} + b_t`` per channel: log_a (<= 0) and b
    (B, S, W) fp32, h0 (B, W) fp32, S >= 1. Returns (h (B, S, W), h_last
    (B, W)), both fp32. Differentiable in log_a, b and h0
    (:class:`RGLRUScan`)."""
    _check(log_a, b, h0)
    return RGLRUScan.apply(log_a, b, h0)


class RGLRUScan(torch.autograd.Function):
    """The dispatch forward (:func:`_forward`) with the closed-form
    plain-PyTorch backward (``ref.rglru_backward``)."""

    @staticmethod
    def forward(ctx, log_a, b, h0):
        h, h_last = _forward(log_a, b, h0)
        ctx.save_for_backward(log_a, h0, h)
        return h, h_last

    @staticmethod
    def backward(ctx, dh, dh_last):
        log_a, h0, h = ctx.saved_tensors
        return rglru_backward(log_a, h, h0, dh, dh_last)


def _forward(log_a, b, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin on CPU tensors, the hand kernel on CUDA ones, the kernel's
    outputs alone on ``meta`` ones."""
    if log_a.device.type == "cpu":
        return rglru_ref(log_a, b, h0)
    bsz, s, w = log_a.shape
    h = torch.empty_like(log_a)
    h_last = torch.empty_like(h0)
    if log_a.device.type == "cuda":
        for name, t in (("log_a", log_a), ("b", b), ("h0", h0)):
            if not t.is_contiguous():
                raise ValueError(f"rglru_scan: {name} must be contiguous")
        lib = _lib()
        with torch.cuda.device(log_a.device):
            stream = torch.cuda.current_stream(log_a.device).cuda_stream
            err = lib.rglru_scan_launch(log_a.data_ptr(), b.data_ptr(), h0.data_ptr(),
                                        h.data_ptr(), h_last.data_ptr(), bsz, s, w, stream)
        if err != 0:
            raise RuntimeError("rglru_scan kernel launch failed: "
                               + lib.rglru_scan_error_string(err).decode())
    launched(rglru_scan, b=bsz, s=s, w=w)
    return h, h_last


rglru_scan.launches = 0
