"""Dispatch for the decode-attention kernel (counterpart of
``repro.kernels.decode_attention.ops``), in the model's cache layout.

CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernels in ``csrc/decode_attention.cu`` -- there is no
switch and no fallback: a CUDA call that cannot launch raises. The
wrapper plans the split of the cache over blocks (:func:`plan_splits`,
from the cache's capacity, so the host never reads ``n_valid``),
allocates the output and the split path's fp32 scratch, launches on the
current stream without synchronizing, and raises if a launch reports an
error. ``decode_attention.launches`` counts the calls that reached the
card (one split kernel each); ``decode_attention.combine_launches``
counts the combine kernel, which runs only when a call has more than one
split (twin calls count in neither).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels.build import BASE_FLAGS, KernelLibraries
from repro_torch.kernels.decode_attention.ref import combine_partials_ref, decode_attention_ref

__all__ = ["decode_attention", "combine_partials", "plan_splits", "split_plan",
           "group_tile", "HEAD_DIMS", "LIBS", "MIN_SPAN", "SPAN_ALIGN"]

LIBS = KernelLibraries(Path(__file__).resolve().parent, BASE_FLAGS)
#: head sizes the kernel is instantiated for
HEAD_DIMS = (64, 128, 256)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the fewest cache slots a split covers: every cache the serving paths
#: hold (4,096 slots, or a 2,048-slot ring) runs as one split
MIN_SPAN = 4096
#: a split's span is a multiple of this (of every tile height the kernel uses)
SPAN_ALIGN = 64
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared (pointers and the
    stream as void*, so ctypes never truncates them)."""
    lib = LIBS.load("decode_attention")
    lib.decode_attention_launch.argtypes = [_P] * 7 + [_I] * 9 + [_F, _P]
    lib.decode_attention_launch.restype = _I
    lib.decode_attention_combine_launch.argtypes = [_P] * 3 + [_I] * 4 + [_P]
    lib.decode_attention_combine_launch.restype = _I
    lib.decode_attention_blocks_per_sm.argtypes = [_I] * 3
    lib.decode_attention_blocks_per_sm.restype = _I
    lib.decode_attention_error_string.argtypes = [_I]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def group_tile(group: int, hd: int = 64) -> int:
    """The q-heads one block serves: the smallest of 1, 2, 4, 8 that holds
    the GQA group, at most 8 (4 at hd 256, where each q-head's share of
    the tile costs twice the work); a larger group takes several blocks,
    each reading the kv head's cache (the copies meet in L2)."""
    cap = 4 if hd > 128 else 8
    return next(gt for gt in (1, 2, 4, 8) if gt >= min(group, cap))


@functools.lru_cache(maxsize=None)
def plan_splits(b: int, c: int, n_kv: int, group: int, sms: int, per_sm: int = 2,
                hd: int = 64) -> tuple:
    """How many blocks share one (batch row, kv head, q-head tile)'s cache:
    returns ``(splits, span)``, split s covering slots ``[s * span, (s +
    1) * span)``.

    Planned from the capacity ``c``, not the live count. The span is a
    multiple of ``SPAN_ALIGN`` and at least ``MIN_SPAN`` slots, so a cache
    of ``MIN_SPAN`` slots or fewer is one split. Among those, the plan
    takes the split count that minimises waves x span -- a full cache's
    time, when each of the ``sms`` SMs holds ``per_sm`` blocks at once --
    and of equal costs the fewest splits: a grid a few blocks over one
    wave would run its last blocks alone for a whole block's time."""
    base = b * n_kv * _ceil(group, group_tile(group, hd))
    slots = sms * per_sm
    best = None
    for want in range(1, max(1, c // MIN_SPAN) + 1):
        span = _ceil(_ceil(c, want), SPAN_ALIGN) * SPAN_ALIGN
        splits = _ceil(c, span)
        cost = _ceil(base * splits, slots) * span
        if best is None or cost < best[0]:
            best = (cost, splits, span)
    return best[1], best[2]


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(q: torch.Tensor, k_cache: torch.Tensor) -> tuple:
    """``(splits, span)`` as the wrapper plans them for these CUDA operands
    (q (B, 1, H, hd), cache (B, C, K, hd)) on their card: ``plan_splits``
    with the card's SM count and the split kernel's occupancy."""
    b, _, h, hd = q.shape
    c, n_kv = k_cache.shape[1], k_cache.shape[2]
    group = h // n_kv
    index = q.device.index if q.device.index is not None else torch.cuda.current_device()
    per_sm = _blocks_per_sm(index, hd, _DTYPES[q.dtype], group_tile(group, hd))
    return plan_splits(b, c, n_kv, group, _sm_count(index), per_sm, hd)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _blocks_per_sm(index: int, hd: int, dtype: int, gt: int) -> int:
    with torch.cuda.device(index):
        n = _lib().decode_attention_blocks_per_sm(hd, dtype, gt)
    if n < 1:
        raise RuntimeError(f"decode_attention: no block fits an SM at hd {hd}, gt {gt}")
    return n


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
    group = h // n_kv
    splits, span = split_plan(q, k_cache)
    nv = n_valid.to(torch.int32).contiguous()
    out = torch.empty_like(q)
    part_acc = part_ml = None
    if splits > 1:
        part_acc = torch.empty(splits, b, h, hd, dtype=torch.float32, device=q.device)
        part_ml = torch.empty(2, splits, b, h, dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decode_attention_launch(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), nv.data_ptr(),
            out.data_ptr(), part_acc.data_ptr() if splits > 1 else None,
            part_ml.data_ptr() if splits > 1 else None, b, c, n_kv, group,
            group_tile(group, hd), hd, _DTYPES[q.dtype], splits, span, hd ** -0.5, stream)
    _raise_if("decode_attention", err, lib)
    decode_attention.launches += 1
    if splits > 1:
        combine_partials(part_acc, part_ml, out)
    return out


def combine_partials(part_acc: torch.Tensor, part_ml: torch.Tensor,
                     out: torch.Tensor) -> torch.Tensor:
    """The split path's second kernel: merges fp32 partials ``part_acc``
    (S, B, H, hd) with their ``part_ml`` (2, S, B, H) -- m, then l; a split
    with no live slot has m = -inf, l = 0 -- into ``out`` (B, 1, H, hd, in
    its dtype), in place; zeros where every split is empty. CPU tensors
    go to ``combine_partials_ref``. Counts its launches in
    ``decode_attention.combine_launches``."""
    s, b, h, hd = part_acc.shape
    if (tuple(part_ml.shape) != (2, s, b, h) or tuple(out.shape) != (b, 1, h, hd)
            or part_acc.dtype != torch.float32 or part_ml.dtype != torch.float32
            or out.dtype not in _DTYPES or hd not in HEAD_DIMS):
        raise ValueError(f"combine_partials: acc {tuple(part_acc.shape)}, m/l "
                         f"{tuple(part_ml.shape)}, out {tuple(out.shape)} {out.dtype}")
    if out.device.type == "cpu":
        out.copy_(combine_partials_ref(part_acc, part_ml[0], part_ml[1], out.dtype))
        return out
    for name, t in (("part_acc", part_acc), ("part_ml", part_ml), ("out", out)):
        if not t.is_contiguous() or t.device != out.device:
            raise ValueError(f"combine_partials: {name} must be contiguous on {out.device}")
    lib = _lib()
    with torch.cuda.device(out.device):
        err = lib.decode_attention_combine_launch(
            part_acc.data_ptr(), part_ml.data_ptr(), out.data_ptr(), b * h, hd,
            _DTYPES[out.dtype], s, torch.cuda.current_stream(out.device).cuda_stream)
    _raise_if("decode_attention combine", err, lib)
    decode_attention.combine_launches += 1
    return out


def _raise_if(what: str, err: int, lib) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + lib.decode_attention_error_string(err).decode())


decode_attention.launches = 0
decode_attention.combine_launches = 0
