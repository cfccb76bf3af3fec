"""Dispatch for the decode-attention kernel (counterpart of
``repro.kernels.decode_attention.ops``), in the model's cache layout.

CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/decode_attention.cu`` -- there is no
switch and no fallback: a CUDA call that cannot launch raises. The
wrapper allocates the output, launches on the current stream without
synchronizing, and raises if the launch reports an error. It counts its
kernel launches in ``decode_attention.launches`` (twin calls do not
count).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BASE_FLAGS, KernelLibraries
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "HEAD_DIMS", "LIBS"]

LIBS = KernelLibraries(Path(__file__).resolve().parent, BASE_FLAGS)
#: head sizes the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them)."""
    lib = LIBS.load("decode_attention")
    lib.decode_attention_launch.argtypes = [_P] * 5 + [_I] * 6 + [_F, _P]
    lib.decode_attention_launch.restype = _I
    lib.decode_attention_error_string.argtypes = [_I]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k_cache, v_cache, n_valid):
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention: q must be (B, 1, H, hd), got {tuple(q.shape)}")
    b, _, h, hd = q.shape
    if k_cache.ndim != 4 or k_cache.shape[0] != b or k_cache.shape[3] != hd:
        raise ValueError(f"decode_attention: caches must be (B={b}, C, K, hd={hd}), "
                         f"got {tuple(k_cache.shape)}")
    if v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: v cache {tuple(v_cache.shape)} != "
                         f"k cache {tuple(k_cache.shape)}")
    if h % k_cache.shape[2]:
        raise ValueError(f"decode_attention: {h} q-heads over {k_cache.shape[2]} kv-heads")
    if tuple(n_valid.shape) != (b,) or n_valid.dtype.is_floating_point:
        raise ValueError(f"decode_attention: n_valid must be ({b},) integer, got "
                         f"{tuple(n_valid.shape)} {n_valid.dtype}")
    if hd not in HEAD_DIMS:
        raise ValueError(f"decode_attention: head size {hd} not in {HEAD_DIMS}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {t.dtype}, q is {q.dtype}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"decode_attention: {q.dtype} is not float32 or bfloat16")
    for t in (k_cache, v_cache, n_valid):
        if t.device != q.device:
            raise ValueError(f"decode_attention: operands on {t.device} and {q.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"decode_attention: tensors on {q.device} are not supported")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     n_valid: torch.Tensor) -> torch.Tensor:
    """One query token per (batch, q-head) against the first
    ``n_valid[b]`` slots of the KV cache (a contiguous cache passes pos
    + 1, a ring buffer min(pos + 1, C)); GQA when K divides H.

    q (B, 1, H, hd); k_cache, v_cache (B, C, K, hd) in the cache's own
    layout, q's dtype (float32 or bfloat16); n_valid (B,) integer; hd 64,
    128 or 256. Returns (B, 1, H, hd) in q's dtype."""
    _check(q, k_cache, v_cache, n_valid)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, n_valid)
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be contiguous and "
                             f"16-byte aligned")
    b, _, h, hd = q.shape
    c, n_kv = k_cache.shape[1], k_cache.shape[2]
    nv = n_valid.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), nv.data_ptr(),
            out.data_ptr(), b, c, n_kv, h // n_kv, hd, _DTYPES[q.dtype],
            hd ** -0.5, stream)
    if err != 0:
        raise RuntimeError("decode_attention kernel launch failed: "
                           + lib.decode_attention_error_string(err).decode())
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
