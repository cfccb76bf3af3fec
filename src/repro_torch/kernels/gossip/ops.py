"""Dispatch for the gossip kernels (counterpart of
``repro.kernels.gossip.ops``).

A wrapper checks its operands, then dispatches by the tensors' device:
CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/fused_round.cu`` (the gossip stage
``gossip_mix`` and the round megakernels) or ``csrc/wire_stage.cu`` (the
wire stages) -- there is no
switch and no fallback: a CUDA call that cannot launch raises. The
wrapper allocates the outputs, launches on the current stream without
synchronizing, and raises if the launch reports an error. Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (twin calls do not
count).

Every wrapper takes ``topk``: None (the dense int8 wire) or the number
of largest-|payload| columns each (node, scale chunk) keeps, ties at the
threshold included; ``topk >= scale_chunk`` keeps them all.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels.gossip.build import load
from repro_torch.kernels.gossip.ref import (
    check_topk,
    fused_round_gt_ref,
    fused_round_ref,
    gossip_mix_ref,
    refuse_unported,
    wire_stage_gt_ref,
    wire_stage_ref,
)

__all__ = ["gossip_mix", "fused_round", "fused_round_gt", "wire_stage",
           "wire_stage_gt", "SMEM_LIMIT_BYTES"]

#: dynamic shared memory one Hopper block may opt in to (227 KB)
SMEM_LIMIT_BYTES = 232448

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


def _declare(lib, name, argtypes, restype=_I):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype


@functools.cache
def _round_lib() -> ctypes.CDLL:
    """The built round-kernel library with every entry point's C
    signature declared (pointers and the stream as void*, so ctypes never
    truncates them)."""
    lib = load("fused_round")
    _declare(lib, "gossip_mix_launch", [_P] * 9 + [_I] * 7 + [_P])
    _declare(lib, "fused_round_launch", [_P] * 6 + [_F] + [_P] * 4 + [_I] * 7 + [_P])
    _declare(lib, "fused_round_gt_launch",
             [_P] * 10 + [_F] + [_P] * 8 + [_I] * 7 + [_P])
    _declare(lib, "fused_round_smem_bytes", [_I, _I], ctypes.c_size_t)
    _declare(lib, "gossip_error_string", [_I], ctypes.c_char_p)
    return lib


@functools.cache
def _wire_lib() -> ctypes.CDLL:
    """The built wire-stage library, declared as :func:`_round_lib`."""
    lib = load("wire_stage")
    _declare(lib, "wire_stage_launch", [_P] * 4 + [_F] + [_P] * 5 + [_I] * 6 + [_P])
    _declare(lib, "wire_stage_gt_launch",
             [_P] * 8 + [_F] + [_P] * 10 + [_I] * 6 + [_P])
    _declare(lib, "wire_stage_smem_bytes", [_I], ctypes.c_size_t)
    _declare(lib, "gossip_error_string", [_I], ctypes.c_char_p)
    return lib


def _check_operands(name: str, bufs: Sequence[torch.Tensor], scale_chunk: int,
                    topk, weights: Sequence[torch.Tensor] = ()) -> Tuple[int, int]:
    """Validate the (n, t) buffers, the weights (w_off (n, n), w_self
    (n,)) if given, the chunk and topk; returns (n, t)."""
    if bufs[0].ndim != 2:
        raise ValueError(f"{name}: buffers must be (n, t), got {tuple(bufs[0].shape)}")
    n, t = bufs[0].shape
    dev = bufs[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: tensors on {dev} are not supported")
    for k, b in enumerate(list(bufs) + list(weights)):
        if b.dtype != torch.float32:
            raise TypeError(f"{name}: operand {k} is {b.dtype}, expected float32")
        if b.device != dev:
            raise ValueError(f"{name}: operand {k} on {b.device}, expected {dev}")
        if not b.is_contiguous():
            raise ValueError(f"{name}: operand {k} is not contiguous")
    for k, b in enumerate(bufs):
        if tuple(b.shape) != (n, t):
            raise ValueError(f"{name}: operand {k} is {tuple(b.shape)}, expected {(n, t)}")
    if weights:
        w_off, w_self = weights
        if tuple(w_off.shape) != (n, n) or tuple(w_self.shape) != (n,):
            raise ValueError(
                f"{name}: w_off {tuple(w_off.shape)} / w_self {tuple(w_self.shape)} "
                f"do not match n={n}"
            )
    if scale_chunk < 1 or t % scale_chunk:
        raise ValueError(f"{name}: total {t} not a multiple of scale_chunk {scale_chunk}")
    check_topk(topk)
    return n, t


def _alpha32(alpha) -> np.float32:
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.item()
    return np.float32(alpha)


def _topk_arg(topk, scale_chunk: int) -> int:
    """The kernels' topk argument: 0 launches the dense instantiation,
    which keeps every column."""
    return 0 if topk is None or topk >= scale_chunk else int(topk)


def _check_smem(smem: int, what: str) -> None:
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{what} needs {smem} B of shared memory, over the "
            f"{SMEM_LIMIT_BYTES} B a block may use; use a smaller scale_chunk"
        )


def _tail(n: int, t: int, scale_chunk: int, topk, flags, dev) -> list:
    """The trailing C arguments: geometry, topk, flags, the stream."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    return ([n, t, scale_chunk, _topk_arg(topk, scale_chunk)]
            + [int(bool(f)) for f in flags] + [stream])


def _raise_on(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(
            f"{name} kernel launch failed: {lib.gossip_error_string(err).decode()}"
        )


def _ptrs(*tensors) -> list:
    return [b.data_ptr() for b in tensors]


def gossip_mix(
    x: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    w_off: torch.Tensor,
    w_self: torch.Tensor,
    scale_chunk: int = 512,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    stale_mix: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """One compressed gossip round on the flat buffer in one kernel
    launch: the int8 difference-coded quantization of x with error
    feedback (top-k masked when ``topk`` is set), then the mix
    ``W_off @ recon' + w_self * x`` -- neighbours through what crossed
    the wire, self through the exact x (``stale_mix``: against the input
    recon).

    x, recon, res: (n, t) fp32 contiguous, t % scale_chunk == 0; w_off
    (n, n) with a zero diagonal; w_self (n,). Returns (mixed, new_recon,
    new_res, scales (n, t // scale_chunk))."""
    n, t = _check_operands("gossip_mix", (x, recon, res), scale_chunk, topk,
                           (w_off, w_self))
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk,
                 stale_mix=stale_mix)
    if x.device.type == "cpu":
        return gossip_mix_ref(x, recon, res, w_off, w_self, **flags)
    lib = _round_lib()
    _check_smem(lib.fused_round_smem_bytes(n, scale_chunk),
                f"an (n={n}, chunk={scale_chunk}) tile")
    tail = _tail(n, t, scale_chunk, topk,
                 (error_feedback, difference_coding, stale_mix), x.device)
    mixed, new_recon, new_res = (torch.empty_like(x) for _ in range(3))
    scales = torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gossip_mix_launch(
            *_ptrs(x, recon, res, w_off, w_self),
            *_ptrs(mixed, new_recon, new_res, scales), *tail)
    _raise_on(lib, err, "gossip_mix")
    gossip_mix.launches += 1
    return mixed, new_recon, new_res, scales


gossip_mix.launches = 0


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
    difference-coded quantization of h with error feedback (top-k masked
    when ``topk`` is set) and the mix ``W_off @ recon' + w_self * h``
    (``stale_mix``: against the input recon), in one kernel launch.

    x, g, recon, res: (n, t) fp32 contiguous, t % scale_chunk == 0;
    w_off (n, n) with a zero diagonal; w_self (n,); alpha an fp32 scalar.
    Returns (mixed, new_recon, new_res, scales (n, t // scale_chunk)).
    The DP arguments are not ported and raise."""
    refuse_unported(dp_clip, dp_noise)
    n, t = _check_operands("fused_round", (x, g, recon, res), scale_chunk, topk,
                           (w_off, w_self))
    a = _alpha32(alpha)
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk,
                 stale_mix=stale_mix)
    if x.device.type == "cpu":
        return fused_round_ref(x, g, recon, res, w_off, w_self, a, **flags)
    lib = _round_lib()
    _check_smem(lib.fused_round_smem_bytes(n, scale_chunk),
                f"an (n={n}, chunk={scale_chunk}) tile")
    tail = _tail(n, t, scale_chunk, topk,
                 (error_feedback, difference_coding, stale_mix), x.device)
    mixed, new_recon, new_res = (torch.empty_like(x) for _ in range(3))
    scales = torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_round_launch(
            *_ptrs(x, g, recon, res, w_off, w_self), float(a),
            *_ptrs(mixed, new_recon, new_res, scales), *tail)
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
    refuse_unported(dp_clip, dp_noise if dp_noise is not None else dp_noise_t)
    bufs = (x, t, g, g_prev, recon_x, res_x, recon_t, res_t)
    n, tot = _check_operands("fused_round_gt", bufs, scale_chunk, topk,
                             (w_off, w_self))
    a = _alpha32(alpha)
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk,
                 stale_mix=stale_mix)
    if x.device.type == "cpu":
        return fused_round_gt_ref(*bufs, w_off, w_self, a, **flags)
    lib = _round_lib()
    _check_smem(lib.fused_round_smem_bytes(n, scale_chunk),
                f"an (n={n}, chunk={scale_chunk}) tile")
    tail = _tail(n, tot, scale_chunk, topk,
                 (error_feedback, difference_coding, stale_mix), x.device)
    outs = [torch.empty_like(x) for _ in range(6)] + [
        torch.empty(n, tot // scale_chunk, dtype=torch.float32, device=x.device)
        for _ in range(2)
    ]
    with torch.cuda.device(x.device):
        err = lib.fused_round_gt_launch(
            *_ptrs(*bufs, w_off, w_self), float(a), *_ptrs(*outs), *tail)
    _raise_on(lib, err, "fused_round_gt")
    fused_round_gt.launches += 1
    return tuple(outs)


fused_round_gt.launches = 0


def _wire_outs(x: torch.Tensor, n: int, t: int, scale_chunk: int):
    """One wire's outputs: q int8 (n, t), scales, recon', res'."""
    return (torch.empty(n, t, dtype=torch.int8, device=x.device),
            torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device),
            torch.empty_like(x), torch.empty_like(x))


def wire_stage(
    x: torch.Tensor,
    g: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    alpha,
    scale_chunk: int = 512,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    dp_clip=None,
    dp_noise=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGD wire stage: the round megakernel without its mix -- ``h = x -
    alpha * g``, then the int8 difference-coded quantization of h with
    error feedback (top-k masked when ``topk`` is set) -- in one kernel
    launch. Returns (h, q int8 (n, t), scales (n, t // scale_chunk),
    new_recon, new_res); the caller mixes. The DP arguments are not
    ported and raise."""
    refuse_unported(dp_clip, dp_noise)
    n, t = _check_operands("wire_stage", (x, g, recon, res), scale_chunk, topk)
    a = _alpha32(alpha)
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk)
    if x.device.type == "cpu":
        return wire_stage_ref(x, g, recon, res, a, **flags)
    lib = _wire_lib()
    _check_smem(lib.wire_stage_smem_bytes(scale_chunk), f"chunk {scale_chunk}")
    tail = _tail(n, t, scale_chunk, topk, (error_feedback, difference_coding),
                 x.device)
    h = torch.empty_like(x)
    outs = _wire_outs(x, n, t, scale_chunk)
    with torch.cuda.device(x.device):
        err = lib.wire_stage_launch(*_ptrs(x, g, recon, res), float(a),
                                    *_ptrs(h, *outs), *tail)
    _raise_on(lib, err, "wire_stage")
    wire_stage.launches += 1
    return (h, *outs)


wire_stage.launches = 0


def wire_stage_gt(
    x: torch.Tensor,
    t: torch.Tensor,
    g: torch.Tensor,
    g_prev: torch.Tensor,
    recon_x: torch.Tensor,
    res_x: torch.Tensor,
    recon_t: torch.Tensor,
    res_t: torch.Tensor,
    alpha,
    scale_chunk: int = 512,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    dp_clip=None,
    dp_noise=None,
    dp_noise_t=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGT wire stage: ``t_half = t + g - g_prev``, ``h = x - alpha *
    t_half``, then the quantize-EF stage on the tracker wire and on the
    parameter wire, in one kernel launch. Returns (h, t_half, q_x,
    scales_x, new_recon_x, new_res_x, q_t, scales_t, new_recon_t,
    new_res_t), q int8 (n, t)."""
    refuse_unported(dp_clip, dp_noise if dp_noise is not None else dp_noise_t)
    bufs = (x, t, g, g_prev, recon_x, res_x, recon_t, res_t)
    n, tot = _check_operands("wire_stage_gt", bufs, scale_chunk, topk)
    a = _alpha32(alpha)
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk)
    if x.device.type == "cpu":
        return wire_stage_gt_ref(*bufs, a, **flags)
    lib = _wire_lib()
    _check_smem(lib.wire_stage_smem_bytes(scale_chunk), f"chunk {scale_chunk}")
    tail = _tail(n, tot, scale_chunk, topk, (error_feedback, difference_coding),
                 x.device)
    h, t_half = torch.empty_like(x), torch.empty_like(x)
    outs_x = _wire_outs(x, n, tot, scale_chunk)
    outs_t = _wire_outs(x, n, tot, scale_chunk)
    with torch.cuda.device(x.device):
        err = lib.wire_stage_gt_launch(*_ptrs(*bufs), float(a),
                                       *_ptrs(h, t_half, *outs_x, *outs_t), *tail)
    _raise_on(lib, err, "wire_stage_gt")
    wire_stage_gt.launches += 1
    return (h, t_half, *outs_x, *outs_t)


wire_stage_gt.launches = 0
