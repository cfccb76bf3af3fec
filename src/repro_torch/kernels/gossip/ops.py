"""Dispatch for the round megakernels (counterpart of
``repro.kernels.gossip.ops``).

A wrapper checks its operands, then dispatches by the tensors' device:
CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/fused_round.cu`` -- there is no switch
and no fallback: a CUDA call that cannot launch raises. The wrapper
allocates the outputs, launches on the current stream without
synchronizing, and raises if the launch reports an error. Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (twin calls do not
count).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.gossip.build import load
from repro_torch.kernels.gossip.ref import (
    fused_round_gt_ref,
    fused_round_ref,
    refuse_unported,
)

__all__ = ["fused_round", "fused_round_gt", "SMEM_LIMIT_BYTES"]

#: dynamic shared memory one Hopper block may opt in to (227 KB)
SMEM_LIMIT_BYTES = 232448

_LIB = "fused_round"
_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared
    (pointers and the stream as void*, so ctypes never truncates them)."""
    lib = load(_LIB)
    lib.fused_round_launch.argtypes = [_P] * 6 + [_F] + [_P] * 4 + [_I] * 6 + [_P]
    lib.fused_round_launch.restype = _I
    lib.fused_round_gt_launch.argtypes = [_P] * 10 + [_F] + [_P] * 8 + [_I] * 6 + [_P]
    lib.fused_round_gt_launch.restype = _I
    lib.fused_round_smem_bytes.argtypes = [_I, _I]
    lib.fused_round_smem_bytes.restype = ctypes.c_size_t
    lib.gossip_error_string.argtypes = [_I]
    lib.gossip_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(name: str, bufs: Sequence[torch.Tensor],
                    w_off: torch.Tensor, w_self: torch.Tensor,
                    scale_chunk: int) -> Tuple[int, int]:
    """Validate the (n, t) buffers and the weights; returns (n, t)."""
    if bufs[0].ndim != 2:
        raise ValueError(f"{name}: buffers must be (n, t), got {tuple(bufs[0].shape)}")
    n, t = bufs[0].shape
    dev = bufs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev} are not supported")
    for k, b in enumerate(list(bufs) + [w_off, w_self]):
        if b.dtype != torch.float32:
            raise TypeError(f"{name}: operand {k} is {b.dtype}, expected float32")
        if b.device != dev:
            raise ValueError(f"{name}: operand {k} on {b.device}, expected {dev}")
        if not b.is_contiguous():
            raise ValueError(f"{name}: operand {k} is not contiguous")
    for k, b in enumerate(bufs):
        if tuple(b.shape) != (n, t):
            raise ValueError(f"{name}: operand {k} is {tuple(b.shape)}, expected {(n, t)}")
    if tuple(w_off.shape) != (n, n) or tuple(w_self.shape) != (n,):
        raise ValueError(
            f"{name}: w_off {tuple(w_off.shape)} / w_self {tuple(w_self.shape)} "
            f"do not match n={n}"
        )
    if scale_chunk < 1 or t % scale_chunk:
        raise ValueError(f"{name}: total {t} not a multiple of scale_chunk {scale_chunk}")
    return n, t


def _alpha32(alpha) -> np.float32:
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.item()
    return np.float32(alpha)


def _launch_args(n: int, t: int, scale_chunk: int, flags, dev):
    lib = _lib()
    smem = lib.fused_round_smem_bytes(n, scale_chunk)
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"an (n={n}, chunk={scale_chunk}) tile needs {smem} B of shared "
            f"memory, over the {SMEM_LIMIT_BYTES} B a block may use; use a "
            "smaller scale_chunk"
        )
    stream = torch.cuda.current_stream(dev).cuda_stream
    return lib, [n, t, scale_chunk] + [int(bool(f)) for f in flags] + [stream]


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.gossip_error_string(err).decode()}"
        )


def fused_round(
    x: torch.Tensor,
    g: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    w_off: torch.Tensor,
    w_self: torch.Tensor,
    alpha,
    scale_chunk: int = 512,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    stale_mix: bool = False,
    dp_clip=None,
    dp_noise=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGD round megakernel: ``h = x - alpha * g``, then the int8
    difference-coded quantization of h with error feedback and the mix
    ``W_off @ recon' + w_self * h`` (``stale_mix``: against the input
    recon), in one kernel launch.

    x, g, recon, res: (n, t) fp32 contiguous, t % scale_chunk == 0;
    w_off (n, n) with a zero diagonal; w_self (n,); alpha an fp32 scalar.
    Returns (mixed, new_recon, new_res, scales (n, t // scale_chunk)).
    ``topk`` and the DP arguments are not ported and raise."""
    refuse_unported(topk, dp_clip, dp_noise)
    n, t = _check_operands("fused_round", (x, g, recon, res), w_off, w_self,
                           scale_chunk)
    a = _alpha32(alpha)
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, stale_mix=stale_mix)
    if x.device.type == "cpu":
        return fused_round_ref(x, g, recon, res, w_off, w_self, a, **flags)
    lib, tail = _launch_args(
        n, t, scale_chunk, (error_feedback, difference_coding, stale_mix), x.device
    )
    mixed, new_recon, new_res = (torch.empty_like(x) for _ in range(3))
    scales = torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device)
    ptrs = [b.data_ptr() for b in (x, g, recon, res, w_off, w_self)]
    outs = [b.data_ptr() for b in (mixed, new_recon, new_res, scales)]
    with torch.cuda.device(x.device):
        err = lib.fused_round_launch(*ptrs, float(a), *outs, *tail)
    _raise_on(lib, err, "fused_round")
    fused_round.launches += 1
    return mixed, new_recon, new_res, scales


fused_round.launches = 0


def fused_round_gt(
    x: torch.Tensor,
    t: torch.Tensor,
    g: torch.Tensor,
    g_prev: torch.Tensor,
    recon_x: torch.Tensor,
    res_x: torch.Tensor,
    recon_t: torch.Tensor,
    res_t: torch.Tensor,
    w_off: torch.Tensor,
    w_self: torch.Tensor,
    alpha,
    scale_chunk: int = 512,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    stale_mix: bool = False,
    dp_clip=None,
    dp_noise=None,
    dp_noise_t=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGT round megakernel: ``t_half = t + g - g_prev``, ``h = x -
    alpha * t_half``, then the quantize-mix-EF stage on the tracker wire
    and on the parameter wire, in one kernel launch. ``(recon_x, res_x)``
    and ``(recon_t, res_t)`` are the two wires' compression states.
    Returns (mixed_x, mixed_t, new_recon_x, new_res_x, new_recon_t,
    new_res_t, scales_x, scales_t); keep ``g`` as the next ``g_prev``."""
    refuse_unported(topk, dp_clip, dp_noise if dp_noise is not None else dp_noise_t)
    bufs = (x, t, g, g_prev, recon_x, res_x, recon_t, res_t)
    n, tot = _check_operands("fused_round_gt", bufs, w_off, w_self, scale_chunk)
    a = _alpha32(alpha)
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, stale_mix=stale_mix)
    if x.device.type == "cpu":
        return fused_round_gt_ref(*bufs, w_off, w_self, a, **flags)
    lib, tail = _launch_args(
        n, tot, scale_chunk, (error_feedback, difference_coding, stale_mix),
        x.device,
    )
    outs = [torch.empty_like(x) for _ in range(6)] + [
        torch.empty(n, tot // scale_chunk, dtype=torch.float32, device=x.device)
        for _ in range(2)
    ]
    ptrs = [b.data_ptr() for b in bufs + (w_off, w_self)]
    with torch.cuda.device(x.device):
        err = lib.fused_round_gt_launch(
            *ptrs, float(a), *[o.data_ptr() for o in outs], *tail
        )
    _raise_on(lib, err, "fused_round_gt")
    fused_round_gt.launches += 1
    return tuple(outs)


fused_round_gt.launches = 0
