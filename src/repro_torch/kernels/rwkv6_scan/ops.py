"""Dispatch for the WKV-6 kernel (counterpart of
``repro.kernels.rwkv6_scan.ops``), in the model layout.

CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/rwkv6_scan.cu`` -- there is no switch,
no chunk size and no fallback: a CUDA call that cannot launch raises.
The function does not depend on a chunk length, so any S >= 1 takes the
same path (the kernel stages its inputs in chunks of 16 steps and handles
a short last chunk itself). The kernel copies its operands in 16-byte
runs, so each must be 16-byte aligned (fresh tensors are). The wrapper allocates the outputs, launches on the current
stream without synchronizing, and raises if the launch reports an error.
It counts its kernel launches in ``wkv6.launches`` (twin calls do not
count).

``wkv6`` is differentiable in all six operands (:class:`WKV6`, a
``torch.autograd.Function``): its forward is the dispatch above, its
backward ``ref.wkv6_backward``, the closed-form gradient in plain
PyTorch, the same code on every device, from the saved operands (the
states are recomputed). No kernel runs in the backward (the reference's
Pallas kernel defines no VJP; a hand backward kernel is later work,
ROADMAP.md queue 2).
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
from repro_torch.kernels.rwkv6_scan.ref import wkv6_backward, wkv6_ref

__all__ = ["wkv6", "WKV6", "check_kernel_operands", "HEAD_SIZE", "LIBS"]

LIBS = KernelLibraries(Path(__file__).resolve().parent, BASE_FLAGS)
#: the one head size the kernel holds a state for
HEAD_SIZE = 64
_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them)."""
    lib = LIBS.load("rwkv6_scan")
    lib.wkv6_launch.argtypes = [_P] * 8 + [_I] * 3 + [_P]
    lib.wkv6_launch.restype = _I
    lib.wkv6_error_string.argtypes = [_I]
    lib.wkv6_error_string.restype = ctypes.c_char_p
    return lib


def _check(r, k, v, log_w, u, s0):
    if r.ndim != 4 or r.shape[-1] != HEAD_SIZE:
        raise ValueError(f"wkv6: r must be (B, S, H, {HEAD_SIZE}), got {tuple(r.shape)}")
    b, s, h, hd = r.shape
    if s < 1:
        raise ValueError("wkv6: the sequence is empty")
    for name, t in (("k", k), ("v", v), ("log_w", log_w)):
        if t.shape != r.shape:
            raise ValueError(f"wkv6: {name} {tuple(t.shape)} != r {tuple(r.shape)}")
    if tuple(u.shape) != (h, hd):
        raise ValueError(f"wkv6: u must be ({h}, {hd}), got {tuple(u.shape)}")
    if tuple(s0.shape) != (b, h, hd, hd):
        raise ValueError(f"wkv6: s0 must be ({b}, {h}, {hd}, {hd}), got {tuple(s0.shape)}")
    for name, t in (("r", r), ("k", k), ("v", v), ("log_w", log_w), ("u", u), ("s0", s0)):
        if t.dtype != torch.float32:
            raise TypeError(f"wkv6: {name} is {t.dtype}, the kernel takes float32")
        if t.device != r.device:
            raise ValueError(f"wkv6: {name} on {t.device}, r on {r.device}")
    if r.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"wkv6: tensors on {r.device} are not supported")


def check_kernel_operands(**tensors: torch.Tensor) -> None:
    """The kernel copies every operand in whole 16-byte runs: each must be
    contiguous and start on a 16-byte boundary."""
    for name, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"wkv6: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"wkv6: {name} must be 16-byte aligned")


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
         u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """WKV-6 in the model layout: r, k, v, log_w (B, S, H, 64) fp32 (log_w
    <= 0, the log of the decay); u (H, 64); s0 (B, H, 64, 64); S >= 1.
    Returns (y (B, S, H, 64), S_final (B, H, 64, 64)), both fp32.
    Differentiable in every operand (:class:`WKV6`)."""
    _check(r, k, v, log_w, u, s0)
    return WKV6.apply(r, k, v, log_w, u, s0)


def _fold(a: torch.Tensor) -> torch.Tensor:
    """(B, S, H, hd) -> (B*H, S, hd), the twin's layout."""
    b, s, h, hd = a.shape
    return a.transpose(1, 2).reshape(b * h, s, hd)


def _unfold(a: torch.Tensor, b: int, h: int) -> torch.Tensor:
    """(B*H, S, hd) -> (B, S, H, hd)."""
    return a.reshape(b, h, *a.shape[1:]).transpose(1, 2)


class WKV6(torch.autograd.Function):
    """The dispatch forward (:func:`_forward`) with the closed-form
    plain-PyTorch backward (``ref.wkv6_backward``) in the twin's folded
    layout; u's gradient is summed over the batch."""

    @staticmethod
    def forward(ctx, r, k, v, log_w, u, s0):
        ctx.save_for_backward(r, k, v, log_w, u, s0)
        return _forward(r, k, v, log_w, u, s0)

    @staticmethod
    def backward(ctx, dy, ds):
        r, k, v, log_w, u, s0 = ctx.saved_tensors
        b, _, h, hd = r.shape
        grads = wkv6_backward(_fold(r), _fold(k), _fold(v), _fold(log_w),
                              u[None].expand(b, h, hd).reshape(b * h, hd),
                              s0.reshape(b * h, hd, hd), _fold(dy),
                              ds.reshape(b * h, hd, hd))
        dr, dk, dv, dlw, du, ds0 = grads
        return (_unfold(dr, b, h), _unfold(dk, b, h), _unfold(dv, b, h),
                _unfold(dlw, b, h), du.reshape(b, h, hd).sum(0),
                ds0.reshape(b, h, hd, hd))


def _forward(r, k, v, log_w, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The twin on CPU tensors, the hand kernel on CUDA ones, the kernel's
    outputs alone on ``meta`` ones."""
    b, s, h, hd = r.shape
    if r.device.type == "cpu":
        y, s_fin = wkv6_ref(_fold(r), _fold(k), _fold(v), _fold(log_w),
                            u[None].expand(b, h, hd).reshape(b * h, hd),
                            s0.reshape(b * h, hd, hd))
        return _unfold(y, b, h), s_fin.reshape(b, h, hd, hd)
    y = torch.empty_like(r)
    s_fin = torch.empty_like(s0)
    if r.device.type == "cuda":
        check_kernel_operands(r=r, k=k, v=v, log_w=log_w, u=u, s0=s0)
        lib = _lib()
        with torch.cuda.device(r.device):
            stream = torch.cuda.current_stream(r.device).cuda_stream
            err = lib.wkv6_launch(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  log_w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                                  y.data_ptr(), s_fin.data_ptr(), b, s, h, stream)
        if err != 0:
            raise RuntimeError("wkv6 kernel launch failed: "
                               + lib.wkv6_error_string(err).decode())
    launched(wkv6, b=b, s=s, h=h)
    return y, s_fin


wkv6.launches = 0
