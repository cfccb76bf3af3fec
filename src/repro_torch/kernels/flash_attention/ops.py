"""Dispatch for the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ops``), in the model layout.

CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/flash_attention.cu`` -- there is no
switch and no fallback: a CUDA call that cannot launch raises. The
wrapper allocates the output, launches on the current stream without
synchronizing, and raises if the launch reports an error. It counts its
kernel launches in ``flash_attention.launches`` (twin calls do not
count).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BASE_FLAGS, KernelLibraries
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "HEAD_DIMS", "LIBS", "SMEM_LIMIT_BYTES"]

LIBS = KernelLibraries(Path(__file__).resolve().parent, BASE_FLAGS)
#: head sizes the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
#: dynamic shared memory one Hopper block may opt in to (227 KB)
SMEM_LIMIT_BYTES = 232448
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them)."""
    lib = LIBS.load("flash_attention")
    lib.flash_attention_launch.argtypes = [_P] * 4 + [_I] * 9 + [_F, _P]
    lib.flash_attention_launch.restype = _I
    lib.flash_attention_smem_bytes.argtypes = [_I]
    lib.flash_attention_smem_bytes.restype = ctypes.c_size_t
    lib.flash_attention_error_string.argtypes = [_I]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


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
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention: {q.dtype} is not float32 or bfloat16")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention: tensors on {q.device} are not supported")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Self-attention over a full sequence, causal and/or within a
    sliding ``window`` (0: none), with GQA on un-repeated K/V.

    q (B, Sq, H, hd); k, v (B, Sk, K, hd) with K dividing H, q's dtype
    (float32 or bfloat16); hd 64, 128 or 256. Returns (B, Sq, H, hd) in q's
    dtype."""
    _check(q, k, v, window)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} must be contiguous")
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    lib = _lib()
    smem = lib.flash_attention_smem_bytes(hd)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(f"flash_attention: head size {hd} needs {smem} B of "
                         f"shared memory, over {SMEM_LIMIT_BYTES}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, sq, sk, h,
            n_kv, hd, _DTYPES[q.dtype], int(bool(causal)), int(window), hd ** -0.5,
            stream)
    if err != 0:
        raise RuntimeError("flash_attention kernel launch failed: "
                           + lib.flash_attention_error_string(err).decode())
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
