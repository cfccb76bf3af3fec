"""Dispatch for the gossip kernels (counterpart of
``repro.kernels.gossip.ops``).

A wrapper checks its operands, then dispatches by the tensors' device:
CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/fused_round_cluster.cu`` (the round
megakernels and the gossip stage ``gossip_mix``, on thread-block
clusters laid out by :func:`plan_round`), ``csrc/wire_stage.cu`` (the
wire stages) or ``csrc/wire_stage_compact.cu`` (the compact top-k wire
stages; the DSGT one laid out by :func:`compact_gt_plan`) -- there is no
switch and no fallback: a CUDA call that cannot launch raises. The
wrapper allocates the outputs, launches on the current stream without
synchronizing, and raises if the launch reports an error. Each wrapper
counts its kernel launches in ``<wrapper>.launches`` (twin calls do not
count).

Every wrapper but the compact ones takes ``topk``: None (the dense int8
wire) or the number of largest-|payload| columns each (node, scale
chunk) keeps, ties at the threshold included; ``topk >= scale_chunk``
keeps them all. The compact wire stages keep exactly ``1 <= topk <
scale_chunk`` columns, ties toward the lower index.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.packing import compact_pos_dtype
from repro_torch.kernels.gossip.build import load
from repro_torch.kernels.gossip.ref import (
    check_compact,
    check_topk,
    fused_round_gt_ref,
    fused_round_ref,
    gossip_mix_ref,
    refuse_unported,
    wire_stage_compact_ref,
    wire_stage_gt_compact_ref,
    wire_stage_gt_ref,
    wire_stage_ref,
)

__all__ = ["gossip_mix", "fused_round", "fused_round_gt", "wire_stage",
           "wire_stage_gt", "wire_stage_compact", "wire_stage_gt_compact",
           "plan_round", "round_smem_bytes", "compact_gt_plan", "GOSSIP_STAGE",
           "SMEM_LIMIT_BYTES"]

#: dynamic shared memory one Hopper block may opt in to (227 KB)
SMEM_LIMIT_BYTES = 232448
#: shared memory of one H100 SM (228 KB), and what the card reserves of it
#: for each resident block
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233472, 1024
#: the H100 SXM's SMs, for which :func:`plan_round` plans by default
H100_SMS = 132
#: cluster sizes the round kernels take (16 is past the portable 8, which
#: Hopper allows per kernel), and the fewest columns a cluster's block
#: owns: one warp's width, so a row's pass keeps its lanes busy
CLUSTER_SIZES = (1, 2, 4, 8, 16)
MIN_BLOCK_COLS = 32
#: the round kernels' warps a block (csrc/fused_round_cluster.cu kThreads /
#: 32) and the bins of the radix select (csrc/select.cuh kRadixBins)
_ROUND_WARPS, _RADIX_BINS = 8, 256
#: :func:`plan_round`'s ``wires`` for the gossip stage: one wire with no
#: local update, on the DSGD round's layout
GOSSIP_STAGE = 0
#: the DSGT compact kernel's warps a block (csrc/wire_stage_compact.cu
#: kGtThreads / 32)
_GT_WARPS = 4

_P, _F, _I = ctypes.c_void_p, ctypes.c_float, ctypes.c_int


def _declare(lib, name, argtypes, restype=_I):
    fn = getattr(lib, name)
    fn.argtypes, fn.restype = argtypes, restype


@functools.cache
def _cluster_lib() -> ctypes.CDLL:
    """The built cluster round-kernel library (the round kernels and the
    gossip stage) with every entry point's C signature declared (pointers
    and the stream as void*, so ctypes never truncates them)."""
    lib = load("fused_round_cluster")
    _declare(lib, "gossip_mix_cluster_launch", [_P] * 9 + [_I] * 10 + [_P])
    _declare(lib, "fused_round_cluster_launch",
             [_P] * 6 + [_F] + [_P] * 4 + [_I] * 10 + [_P])
    _declare(lib, "fused_round_gt_cluster_launch",
             [_P] * 10 + [_F] + [_P] * 8 + [_I] * 10 + [_P])
    _declare(lib, "fused_round_cluster_smem_bytes", [_I] * 6, ctypes.c_size_t)
    _declare(lib, "fused_round_cluster_max_active", [_I] * 9)
    _declare(lib, "gossip_error_string", [_I], ctypes.c_char_p)
    return lib


@functools.cache
def _wire_lib() -> ctypes.CDLL:
    """The built wire-stage library, declared as :func:`_cluster_lib`."""
    lib = load("wire_stage")
    _declare(lib, "wire_stage_launch", [_P] * 4 + [_F] + [_P] * 5 + [_I] * 6 + [_P])
    _declare(lib, "wire_stage_gt_launch",
             [_P] * 8 + [_F] + [_P] * 10 + [_I] * 6 + [_P])
    _declare(lib, "wire_stage_smem_bytes", [_I], ctypes.c_size_t)
    _declare(lib, "gossip_error_string", [_I], ctypes.c_char_p)
    return lib


@functools.cache
def _compact_lib() -> ctypes.CDLL:
    """The built compact wire-stage library, declared as :func:`_cluster_lib`."""
    lib = load("wire_stage_compact")
    _declare(lib, "wire_stage_compact_launch",
             [_P] * 4 + [_F] + [_P] * 6 + [_I] * 7 + [_P])
    _declare(lib, "wire_stage_gt_compact_launch",
             [_P] * 8 + [_F] + [_P] * 12 + [_I] * 8 + [_P])
    _declare(lib, "wire_stage_compact_smem_bytes", [_I, _I], ctypes.c_size_t)
    _declare(lib, "wire_stage_gt_compact_smem_bytes", [_I] * 4, ctypes.c_size_t)
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


def round_smem_bytes(n: int, chunk: int, clusters: int, cols: int, wires: int,
                     topk) -> int:
    """Dynamic shared memory of one round-kernel block (the layout of
    ``Layout`` in csrc/fused_round_cluster.cu): the (n, cols) input tiles
    (DSGD and the gossip stage, ``wires`` = :data:`GOSSIP_STAGE`, 4; DSGT
    8), W_off and w_self padded to a multiple of 4, a
    64-bit mask of W_off's nonzero 4 x 4 blocks a row group, the block's
    row maxes, every block's (one slot a block, in two sets for the
    dense wire; with top-k one set, which the radix select's histograms,
    256 bins a warp, reuse once the chunk's row maxes are taken from it)
    and the chunk's; with top-k also the thresholds and the owned rows'
    |payload| (ceil(wires n / clusters) rows of the chunk). ``topk`` is
    the kernels' argument: 0 or None for the dense wire."""
    wires = max(wires, 1)  # the gossip stage takes DSGD's layout
    n_pad = -(-n // 4) * 4
    wn = wires * n
    wn4 = -(-wn // 4) * 4
    hist = _ROUND_WARPS * _RADIX_BINS if topk else 0
    jmask = -(-(2 * (n_pad // 4)) // 4) * 4  # a 64-bit mask a row group
    words = (4 * wires * n * cols + n_pad * n_pad + n_pad + jmask + wn4
             + (1 if topk else 2) * max(clusters * wn4, hist) + wn4)
    if topk:
        words += wn4 + -(-wn // clusters) * chunk
    return 4 * words


@functools.lru_cache(maxsize=None)
def plan_round(n: int, t: int, chunk: int, topk, wires: int,
               sms: int = H100_SMS) -> Tuple[int, int, int]:
    """How the round kernel lays a round over clusters: returns ``(C,
    cols_per_block, smem_bytes)`` -- clusters of C blocks, one a scale
    chunk, block r owning columns ``[r * cols, (r + 1) * cols)`` of it
    (the last block the ragged rest) for all n rows.

    ``cols`` is ceil(chunk / C) rounded up to 4 (16-byte rows), at least
    ``MIN_BLOCK_COLS`` when C > 1, and every block owns a column. Among the
    C whose block fits ``SMEM_LIMIT_BYTES``, those whose blocks fit two an
    SM come first (one block's copies then run while the other computes);
    of those the plan takes the fewest blocks a cluster that still give
    every SM two (a chunk's fixed costs -- its barriers and row passes --
    then cover more bytes), and when no C gives that many -- a small
    round -- the most, to spread it over the most SMs.
    ``topk``: None or >= chunk is the dense wire. ``wires``: 1 (DSGD), 2
    (DSGT) or :data:`GOSSIP_STAGE` (one wire, no update), which is planned
    as DSGD. Raises ``ValueError`` when no cluster size fits."""
    if wires not in (GOSSIP_STAGE, 1, 2):
        raise ValueError(f"wires must be {GOSSIP_STAGE} (the gossip stage), 1 or 2, "
                         f"got {wires}")
    if n > 256:  # W_off alone is over the limit (and its block masks are 64 bits)
        raise ValueError(f"an n={n} round needs more shared memory than a block may use")
    k = _topk_arg(topk, chunk)
    n_chunks = t // chunk
    fits = []
    for c in CLUSTER_SIZES:
        cols = -(-chunk // c)
        cols += -cols % 4
        if c > 1 and (cols < MIN_BLOCK_COLS or (c - 1) * cols >= chunk):
            continue
        smem = round_smem_bytes(n, chunk, c, cols, wires, k)
        if smem <= SMEM_LIMIT_BYTES:
            fits.append((c, cols, smem))
    if not fits:
        what = "gossip stage" if wires == GOSSIP_STAGE else f"round with {wires} wire(s)"
        raise ValueError(
            f"an (n={n}, chunk={chunk}) {what}"
            f"{' at topk ' + str(k) if k else ''} needs more "
            f"than the {SMEM_LIMIT_BYTES} B of shared memory a block may use "
            "at every cluster size; use a smaller scale_chunk")
    two = [f for f in fits if 2 * (f[2] + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES]
    pool = two or fits
    full = [f for f in pool if n_chunks * f[0] >= 2 * sms]
    return min(full) if full else max(pool)


def _check_smem(smem: int, what: str) -> None:
    if smem > SMEM_LIMIT_BYTES:
        raise ValueError(
            f"{what} needs {smem} B of shared memory, over the "
            f"{SMEM_LIMIT_BYTES} B a block may use; use a smaller scale_chunk"
        )


@functools.lru_cache(maxsize=None)
def _cluster_plan(index: int, n: int, t: int, chunk: int, k: int, wires: int,
                  flags: Tuple[bool, ...]) -> Tuple[int, int, int]:
    """:func:`plan_round` for card ``index`` (its SM count), held to the
    kernel's own shared-memory layout, and the card's cluster occupancy:
    ``(C, cols, resident clusters)`` -- the kernel launches at most that
    many clusters, each walking its share of the chunks. Raises if the
    card cannot hold one such cluster."""
    lib = _cluster_lib()
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        c, cols, smem = plan_round(n, t, chunk, k or None, wires, sms)
        own = lib.fused_round_cluster_smem_bytes(wires, n, chunk, c, cols, k)
        if own != smem:
            raise RuntimeError(f"round kernel layout {own} B != planned {smem} B")
        active = lib.fused_round_cluster_max_active(
            wires, n, chunk, c, cols, k, *(int(f) for f in flags))
    if active < 0:
        raise RuntimeError(f"round kernel occupancy query failed: "
                           f"{lib.gossip_error_string(-active).decode()}")
    if active == 0:
        raise RuntimeError(f"no cluster of {c} blocks with {smem} B of shared "
                           f"memory each fits card {index}")
    return c, cols, active


def _tail(n: int, t: int, scale_chunk: int, topk, flags, dev) -> list:
    """The trailing C arguments: geometry, topk, flags, the stream."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    return ([n, t, scale_chunk, _topk_arg(topk, scale_chunk)]
            + [int(bool(f)) for f in flags] + [stream])


def _round_tail(n: int, t: int, scale_chunk: int, topk, flags, wires: int,
                dev) -> list:
    """The round kernels' trailing C arguments: geometry, topk, flags, the
    planned cluster size and columns a block, the clusters to launch, the
    stream."""
    k = _topk_arg(topk, scale_chunk)
    flags = tuple(bool(f) for f in flags)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    c, cols, grid = _cluster_plan(index, n, t, scale_chunk, k, wires, flags)
    stream = torch.cuda.current_stream(dev).cuda_stream
    return [n, t, scale_chunk, k, *(int(f) for f in flags), c, cols, grid, stream]


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
    lib = _cluster_lib()
    tail = _round_tail(n, t, scale_chunk, topk,
                       (error_feedback, difference_coding, stale_mix), GOSSIP_STAGE,
                       x.device)
    mixed, new_recon, new_res = (torch.empty_like(x) for _ in range(3))
    scales = torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.gossip_mix_cluster_launch(
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
    lib = _cluster_lib()
    tail = _round_tail(n, t, scale_chunk, topk,
                       (error_feedback, difference_coding, stale_mix), 1, x.device)
    mixed, new_recon, new_res = (torch.empty_like(x) for _ in range(3))
    scales = torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.fused_round_cluster_launch(
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
    lib = _cluster_lib()
    tail = _round_tail(n, tot, scale_chunk, topk,
                       (error_feedback, difference_coding, stale_mix), 2, x.device)
    outs = [torch.empty_like(x) for _ in range(6)] + [
        torch.empty(n, tot // scale_chunk, dtype=torch.float32, device=x.device)
        for _ in range(2)
    ]
    with torch.cuda.device(x.device):
        err = lib.fused_round_gt_cluster_launch(
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


def _compact_outs(x: torch.Tensor, n: int, t: int, scale_chunk: int, topk: int,
                  bitmap: bool):
    """One compact wire's outputs: q int8 (n, C*k), the positions (n, C*k)
    or the bitmap (n, C*chunk/8) uint8, scales (n, C), recon', res'."""
    c = t // scale_chunk
    idx = (torch.empty(n, c * (scale_chunk // 8), dtype=torch.uint8, device=x.device)
           if bitmap else
           torch.empty(n, c * topk, dtype=compact_pos_dtype(scale_chunk), device=x.device))
    return (torch.empty(n, c * topk, dtype=torch.int8, device=x.device), idx,
            torch.empty(n, c, dtype=torch.float32, device=x.device),
            torch.empty_like(x), torch.empty_like(x))


def _encoding(scale_chunk: int, bitmap: bool) -> int:
    """The compact kernels' index encoding: 0 int16 positions, 1 int32, 2
    the bitmap."""
    return 2 if bitmap else (0 if compact_pos_dtype(scale_chunk) == torch.int16 else 1)


def _compact_tail(n: int, t: int, scale_chunk: int, topk: int, ef: bool, dc: bool,
                  bitmap: bool, dev, *layout: int) -> list:
    """The compact kernels' trailing C arguments: geometry, flags, the
    index encoding, the DSGT kernel's ``layout`` arguments, the stream."""
    return [n, t, scale_chunk, int(topk), int(bool(ef)), int(bool(dc)),
            _encoding(scale_chunk, bitmap), *layout,
            torch.cuda.current_stream(dev).cuda_stream]


def compact_gt_plan(scale_chunk: int, topk: int, bitmap: bool) -> Tuple[bool, int]:
    """How the DSGT compact kernel lays out a (row, chunk): returns
    ``(together, smem_bytes)``. A block of 128 threads owns a (row,
    chunk) and keeps each wire's payload row in shared memory (the layout
    of ``GtLayout`` in csrc/wire_stage_compact.cu): the rows, a 256-bin
    radix histogram for each wire's select warp, with positions the
    survivors' positions and |payload| bits (k each), and the warps'
    counts, maxes and each wire's threshold. ``together``: both wires'
    rows fit, and the block runs the wires at once; else it runs them one
    after the other (one row). Raises ``ValueError`` when neither fits."""
    for together in (True, False):
        rows = 2 if together else 1
        words = (rows * scale_chunk + 2 * _RADIX_BINS + (0 if bitmap else 2 * rows * topk)
                 + 2 * _GT_WARPS * 2 + 2 * _GT_WARPS + 4)
        if 4 * words <= SMEM_LIMIT_BYTES:
            return together, 4 * words
    raise ValueError(
        f"the DSGT compact wire at chunk {scale_chunk}, topk {topk} needs "
        f"{4 * words} B of shared memory, over the {SMEM_LIMIT_BYTES} B a block "
        "may use; use a smaller scale_chunk or topk")


@functools.lru_cache(maxsize=None)
def _compact_gt_layout(scale_chunk: int, topk: int, bitmap: bool) -> int:
    """:func:`compact_gt_plan`'s ``together``, held to the kernel's own
    shared-memory layout."""
    together, smem = compact_gt_plan(scale_chunk, topk, bitmap)
    own = _compact_lib().wire_stage_gt_compact_smem_bytes(
        scale_chunk, topk, _encoding(scale_chunk, bitmap), int(together))
    if own != smem:
        raise RuntimeError(f"compact kernel layout {own} B != planned {smem} B")
    return int(together)


def wire_stage_compact(
    x: torch.Tensor,
    g: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    alpha,
    scale_chunk: int = 512,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    bitmap: bool = False,
    dp_clip=None,
    dp_noise=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGD wire stage with the compact epilogue: ``h = x - alpha * g``,
    difference coding, EXACT-k selection per (node, chunk) (the k
    largest |payload|, ties toward the lower index), int8 quantization of
    the survivors and error feedback, in one kernel launch. Returns (h,
    q int8 (n, C*k), pos (n, C*k) int16 (int32 for chunks over 32768),
    scales (n, C), new_recon, new_res); only (q, pos, scales) cross the
    wire. ``bitmap=True`` (byte-aligned chunks) emits the values in
    ascending-position order and the packed LSB-first presence bitmap
    (n, C*chunk/8) uint8 in place of the positions. The DP arguments are
    not ported and raise."""
    refuse_unported(dp_clip, dp_noise)
    n, t = _check_operands("wire_stage_compact", (x, g, recon, res), scale_chunk, None)
    check_compact(topk, scale_chunk, bitmap)
    a = _alpha32(alpha)
    if x.device.type == "cpu":
        return wire_stage_compact_ref(
            x, g, recon, res, a, scale_chunk=scale_chunk, error_feedback=error_feedback,
            difference_coding=difference_coding, topk=topk, bitmap=bitmap)
    lib = _compact_lib()
    _check_smem(lib.wire_stage_compact_smem_bytes(scale_chunk, topk),
                f"chunk {scale_chunk} at topk {topk}")
    tail = _compact_tail(n, t, scale_chunk, topk, error_feedback, difference_coding,
                         bitmap, x.device)
    h = torch.empty_like(x)
    outs = _compact_outs(x, n, t, scale_chunk, topk, bitmap)
    with torch.cuda.device(x.device):
        err = lib.wire_stage_compact_launch(*_ptrs(x, g, recon, res), float(a),
                                            *_ptrs(h, *outs), *tail)
    _raise_on(lib, err, "wire_stage_compact")
    wire_stage_compact.launches += 1
    return (h, *outs)


wire_stage_compact.launches = 0


def wire_stage_gt_compact(
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
    bitmap: bool = False,
    dp_clip=None,
    dp_noise=None,
    dp_noise_t=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGT wire stage with the compact epilogue on both wires:
    ``t_half = t + g - g_prev``, ``h = x - alpha * t_half``, then the
    tracker wire's and the parameter wire's exact-k quantize-EF, in one
    kernel launch. Returns (h, t_half, q_x, pos_x, scales_x, new_recon_x,
    new_res_x, q_t, pos_t, scales_t, new_recon_t, new_res_t);
    ``bitmap`` as in :func:`wire_stage_compact`, on both wires."""
    refuse_unported(dp_clip, dp_noise if dp_noise is not None else dp_noise_t)
    bufs = (x, t, g, g_prev, recon_x, res_x, recon_t, res_t)
    n, tot = _check_operands("wire_stage_gt_compact", bufs, scale_chunk, None)
    check_compact(topk, scale_chunk, bitmap)
    a = _alpha32(alpha)
    if x.device.type == "cpu":
        return wire_stage_gt_compact_ref(
            *bufs, a, scale_chunk=scale_chunk, error_feedback=error_feedback,
            difference_coding=difference_coding, topk=topk, bitmap=bitmap)
    lib = _compact_lib()
    tail = _compact_tail(n, tot, scale_chunk, topk, error_feedback, difference_coding,
                         bitmap, x.device, _compact_gt_layout(scale_chunk, topk, bitmap))
    h, t_half = torch.empty_like(x), torch.empty_like(x)
    outs_x = _compact_outs(x, n, tot, scale_chunk, topk, bitmap)
    outs_t = _compact_outs(x, n, tot, scale_chunk, topk, bitmap)
    with torch.cuda.device(x.device):
        err = lib.wire_stage_gt_compact_launch(
            *_ptrs(*bufs), float(a), *_ptrs(h, t_half, *outs_x, *outs_t), *tail)
    _raise_on(lib, err, "wire_stage_gt_compact")
    wire_stage_gt_compact.launches += 1
    return (h, t_half, *outs_x, *outs_t)


wire_stage_gt_compact.launches = 0
