"""Dispatch for the gossip kernels (counterpart of
``repro.kernels.gossip.ops``).

A wrapper checks its operands, then dispatches by the tensors' device:
CPU tensors go to the plain PyTorch twin (``ref.py``), CUDA tensors to
the hand-written kernel in ``csrc/fused_round_cluster.cu`` (the round
megakernels and the gossip stage ``gossip_mix``, on thread-block
clusters laid out by :func:`plan_round`; where that one-pass plan cannot
hold the round in a block's shared memory, the two-pass route of
:func:`plan_route`: the wire stage of ``csrc/wire_stage.cu``, then the
mix of ``csrc/round_mix.cu``), ``csrc/wire_stage.cu`` (the
wire stages) or ``csrc/wire_stage_compact.cu`` (the compact top-k wire
stages; the DSGT one laid out by :func:`compact_gt_plan`) -- there is no
switch and no fallback: a CUDA call that cannot launch raises. The
wrapper allocates the outputs, launches on the current stream without
synchronizing, and raises if the launch reports an error. On ``meta``
tensors (the dry run) it allocates the kernel's outputs and launches
nothing. Each wrapper counts its kernel launches, and its ``meta``
stand-ins, in ``<wrapper>.launches`` through ``kernels.launches``
(twin calls do not count); a round wrapper on the two-pass route counts
nothing itself: its wire stage counts under ``wire_stage_gossip``,
``wire_stage`` or ``wire_stage_gt`` and its mix under ``round_mix``.

Every wrapper but the compact ones takes ``topk``: None (the dense int8
wire) or the number of largest-|payload| columns each (node, scale
chunk) keeps, ties at the threshold included; ``topk >= scale_chunk``
keeps them all. The compact wire stages keep exactly ``1 <= topk <
scale_chunk`` columns, ties toward the lower index.

Every wrapper but ``gossip_mix`` takes the differential-privacy epilogue
``dp_clip`` / ``dp_noise`` (and DSGT's ``dp_noise_t``): the wire payload
clipped per node to L2 norm ``dp_clip`` plus the pre-scaled Gaussian
noise (``core.privacy.dp_noise``), quantized in place of the payload. It
reaches the unchanged kernels (and, on the CPU, the unchanged twins) by
residual substitution (:func:`_dp_substitute`), so a round is still one
launch; error feedback absorbs the clip and the noise.
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
    dp_scale,
    require_ef_for_dp,
    round_mix_ref,
    wire_stage_compact_ref,
    wire_stage_gt_compact_ref,
    wire_stage_gossip_ref,
    wire_stage_gt_ref,
    wire_stage_ref,
)
from repro_torch.kernels.launches import launched

__all__ = ["gossip_mix", "fused_round", "fused_round_gt", "wire_stage",
           "wire_stage_gt", "wire_stage_compact", "wire_stage_gt_compact",
           "wire_stage_gossip", "round_mix", "plan_round", "plan_route", "mix_plan",
           "mix_lists", "round_smem_bytes",
           "compact_gt_plan", "SharedMemoryRefusal", "GOSSIP_STAGE", "ONE_PASS",
           "TWO_PASS", "SMEM_LIMIT_BYTES"]

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
#: :func:`plan_route`'s routes: the one-pass cluster kernel, or the wire
#: stage then the mix kernel
ONE_PASS, TWO_PASS = "one_pass", "two_pass"
#: the mix kernel's rows a band on its band path (csrc/round_mix.cu
#: kBandRows), and its warps' rings of row copies on the strip path (32
#: warps x kDepth 2 stages x 384 B)
_MIX_BAND_ROWS, _MIX_RING_BYTES = 256, 24576

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
    _declare(lib, "wire_stage_gossip_launch", [_P] * 7 + [_I] * 6 + [_P])
    _declare(lib, "wire_stage_smem_bytes", [_I], ctypes.c_size_t)
    _declare(lib, "gossip_error_string", [_I], ctypes.c_char_p)
    return lib


@functools.cache
def _mix_lib() -> ctypes.CDLL:
    """The built mix-kernel library, declared as :func:`_cluster_lib`."""
    lib = load("round_mix")
    _declare(lib, "round_mix_launch", [_P] * 10 + [_I] * 6 + [_P])
    _declare(lib, "round_mix_smem_bytes", [_I] * 3, ctypes.c_size_t)
    _declare(lib, "round_mix_max_active", [_I] * 4)
    _declare(lib, "round_mix_vec", [_P, _P, _I])
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
    if dev.type not in ("cpu", "cuda", "meta"):
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


def _dp_substitute(h, base, res, dp_clip, dp_noise):
    """Residual substitution: the kernels quantize ``(h - base) + res``;
    with ``res_sub = res + (wire - payload)`` they quantize the DP wire
    ``cs * payload + noise`` instead (to an ulp of float association), so
    their q, scales and recon are the DP wire's. Their residual is then
    ``wire - dq``; adding the returned ``correction = payload - wire``
    restores ``payload - dq``. Every step is its own rounded operation.
    Returns (res_sub, correction)."""
    payload = (h - base) + res
    wire = dp_scale(payload, dp_clip) * payload + dp_noise
    return res + (wire - payload), payload - wire


def _dp_operands(error_feedback: bool, dp_clip, noises) -> bool:
    """Validate the DP arguments: all of them or none (``noises`` the
    wrapper's noise tensors); returns whether the epilogue is on."""
    given = [v is not None for v in noises]
    if not any(given) and dp_clip is None:
        return False
    if not all(given) or dp_clip is None:
        raise ValueError(
            "the DP epilogue needs dp_clip and every wire's noise "
            f"({len(noises)} noise tensor(s)); got dp_clip={dp_clip!r} and "
            f"{sum(given)} noise tensor(s)")
    require_ef_for_dp(error_feedback)
    return True


def _dp_dsgd(x, g, recon, res, alpha, difference_coding, dp_clip, dp_noise):
    """The DSGD wrappers' substitution (``h = x - alpha * g`` as the
    kernel computes it, two rounded operations): (res_sub, correction)."""
    h = x - torch.as_tensor(alpha, dtype=torch.float32) * g
    base = recon if difference_coding else torch.zeros_like(recon)
    return _dp_substitute(h, base, res, dp_clip, dp_noise)


def _dp_dsgt(x, t, g, g_prev, recon_x, res_x, recon_t, res_t, alpha, difference_coding,
             dp_clip, dp_noise, dp_noise_t):
    """The DSGT wrappers' substitution on both wires: (res_x_sub,
    res_t_sub, correction_x, correction_t)."""
    t_half = t + g - g_prev
    h = x - torch.as_tensor(alpha, dtype=torch.float32) * t_half
    if not difference_coding:
        recon_x = recon_t = torch.zeros_like(recon_x)
    sx, cx = _dp_substitute(h, recon_x, res_x, dp_clip, dp_noise)
    st, ct = _dp_substitute(t_half, recon_t, res_t, dp_clip, dp_noise_t)
    return sx, st, cx, ct


def _alpha32(alpha) -> np.float32:
    if isinstance(alpha, torch.Tensor):
        alpha = alpha.item()
    return np.float32(alpha)


def _topk_arg(topk, scale_chunk: int) -> int:
    """The kernels' topk argument: 0 launches the dense instantiation,
    which keeps every column."""
    return 0 if topk is None or topk >= scale_chunk else int(topk)


class SharedMemoryRefusal(ValueError):
    """:func:`plan_round`'s refusal: no cluster size holds the round in a
    block's shared memory. The round wrappers take the two-pass route
    there (:func:`plan_route`)."""


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
    as DSGD. Raises :class:`SharedMemoryRefusal` (a ``ValueError``) when
    no cluster size fits."""
    if wires not in (GOSSIP_STAGE, 1, 2):
        raise ValueError(f"wires must be {GOSSIP_STAGE} (the gossip stage), 1 or 2, "
                         f"got {wires}")
    if n > 256:  # W_off alone is over the limit (and its block masks are 64 bits)
        raise SharedMemoryRefusal(
            f"an n={n} round needs more shared memory than a block may use")
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
        raise SharedMemoryRefusal(
            f"an (n={n}, chunk={chunk}) {what}"
            f"{' at topk ' + str(k) if k else ''} needs more "
            f"than the {SMEM_LIMIT_BYTES} B of shared memory a block may use "
            "at every cluster size; use a smaller scale_chunk")
    two = [f for f in fits if 2 * (f[2] + BLOCK_RESERVED_BYTES) <= SM_SMEM_BYTES]
    pool = two or fits
    full = [f for f in pool if n_chunks * f[0] >= 2 * sms]
    return min(full) if full else max(pool)


def mix_plan(n: int, t: int, wires: int, sms: int = H100_SMS) -> Tuple[int, int, int, int]:
    """The mix kernel's layout (``csrc/round_mix.cu``) for ``wires`` (1 or
    2) wires of (n, t): ``(cols, window, smem, grid)``. A block (one an
    SM, 32 warps) stages ``window`` rows of one wire's strip of ``cols``
    columns (a multiple of 4, a lane each: at most 128 B a row, which HBM
    serves best). The strip path stages all n rows (``window == n``)
    beside the warps' rings of row copies (:data:`_MIX_RING_BYTES`) and
    each row's count and w_self: the widest strip that fits, narrower as
    n grows. Where not even a 4-column strip of all n rows fits, the
    band path: 32-column strips, ``window`` rows of them at a time.
    ``smem``: the bytes a block uses; ``grid``: the persistent blocks, at
    most the tiles (a strip and wire; on the band path also a band of
    :data:`_MIX_BAND_ROWS` rows) and one an SM."""
    if wires not in (1, 2):
        raise ValueError(f"the mix takes one or two wires, got {wires}")
    meta = _MIX_RING_BYTES + 16 * -(-2 * n // 4)
    cols = min(32, (SMEM_LIMIT_BYTES - meta) // (4 * n)) // 4 * 4
    if cols:
        window, smem, bands = n, meta + 4 * n * cols, 1
    else:
        cols, window = 32, SMEM_LIMIT_BYTES // 128
        smem, bands = 4 * window * cols, -(-n // _MIX_BAND_ROWS)
    return cols, window, smem, min(-(-t // cols) * wires * bands, sms)


def mix_lists(w_off: torch.Tensor) -> list:
    """The mix kernel's neighbour lists (``list_kernel`` in
    csrc/round_mix.cu), in Python: for each row of W_off, its nonzero
    columns in ascending order and their weights -- the only neighbour
    rows, and the only terms, the mix runs for that row. The kernel lists
    them on the card from the W it is handed, every launch, each column
    stored times the strip width (its staged row's offset)."""
    return [(torch.nonzero(row).flatten(), row[row != 0]) for row in w_off]


@functools.lru_cache(maxsize=None)
def plan_route(n: int, t: int, chunk: int, topk, wires: int,
               sms: int = H100_SMS) -> Tuple[str, tuple]:
    """How a round (``wires`` as :func:`plan_round`) runs on the card:
    ``(ONE_PASS, plan_round's plan)`` wherever the one-pass cluster kernel
    holds it, else ``(TWO_PASS, mix_plan's plan)`` -- the wire stage
    (``csrc/wire_stage.cu``: the update, the quantization and error
    feedback, one warp a (row, chunk), with no node limit) and then the
    mix (``csrc/round_mix.cu``), two launches. Only
    :class:`SharedMemoryRefusal` turns a round to two passes; any other
    refusal of :func:`plan_round` stands. The route depends on the shape
    and the card's SM count alone."""
    try:
        return ONE_PASS, plan_round(n, t, chunk, topk, wires, sms)
    except SharedMemoryRefusal:
        return TWO_PASS, mix_plan(n, t, max(wires, 1), sms)


def _sms(dev: torch.device) -> int:
    """The SMs :func:`plan_route` plans for: the card's own, the H100's
    for ``meta`` tensors."""
    if dev.type != "cuda":
        return H100_SMS
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    return torch.cuda.get_device_properties(index).multi_processor_count


def _two_pass(n: int, t: int, chunk: int, topk, wires: int, dev) -> bool:
    return plan_route(n, t, chunk, _topk_arg(topk, chunk) or None, wires,
                      _sms(dev))[0] == TWO_PASS


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


@functools.lru_cache(maxsize=None)
def _mix_launch_plan(index: int, n: int, t: int, wires: int, vec: int) -> Tuple[int, int, int]:
    """:func:`mix_plan` for card ``index`` (its SM count), held to the
    kernel's own shared-memory size, its grid cut to the blocks the card
    holds at once: ``(cols, window, grid)``. Raises if the card cannot
    hold one block."""
    lib = _mix_lib()
    with torch.cuda.device(index):
        sms = torch.cuda.get_device_properties(index).multi_processor_count
        cols, window, smem, grid = mix_plan(n, t, wires, sms)
        own = lib.round_mix_smem_bytes(n, window, cols)
        if own != smem:
            raise RuntimeError(f"mix kernel layout {own} B != planned {smem} B")
        active = lib.round_mix_max_active(n, cols, window, vec)
    if active < 0:
        raise RuntimeError(f"mix kernel occupancy query failed: "
                           f"{lib.gossip_error_string(-active).decode()}")
    if active == 0:
        raise RuntimeError(f"no mix block with {smem} B of shared memory fits card {index}")
    return cols, window, min(grid, active * sms)


def round_mix(
    w_off: torch.Tensor,
    w_self: torch.Tensor,
    nbrs: Sequence[torch.Tensor],
    srcs: Sequence[torch.Tensor],
) -> Tuple[torch.Tensor, ...]:
    """The two-pass route's mix, in one launch (``csrc/round_mix.cu``):
    ``mixed = W_off @ nbr + w_self * src`` for each of one or two wires
    (``nbrs[i]``, ``srcs[i]``), the neighbour view and the self term. The
    launch runs two kernels on the current stream: the listing of each
    row's nonzeros of the W handed in (:func:`mix_lists`) into scratch
    allocated here, then the mix over strips of each wire's nbr staged in
    shared memory (:func:`mix_plan`). nbr, src: (n, t) fp32 contiguous; w_off
    (n, n) with a zero diagonal; w_self (n,). Returns the mixed buffers."""
    nbrs, srcs = tuple(nbrs), tuple(srcs)
    if not 1 <= len(nbrs) == len(srcs) <= 2:
        raise ValueError(f"round_mix takes one or two wires, got {len(nbrs)} "
                         f"neighbour and {len(srcs)} self buffers")
    n, t = _check_operands("round_mix", nbrs + srcs, 1, None, (w_off, w_self))
    if w_off.device.type == "cpu":
        return tuple(round_mix_ref(w_off, w_self, a, b) for a, b in zip(nbrs, srcs))
    outs = tuple(torch.empty_like(a) for a in nbrs)
    if w_off.device.type == "cuda":
        lib = _mix_lib()
        dev = w_off.device
        wires = [p for a, b, o in zip(nbrs, srcs, outs) for p in _ptrs(a, b, o)]
        wires += [None] * (6 - len(wires))
        vec = lib.round_mix_vec(nbrs[0].data_ptr(), nbrs[-1].data_ptr(), t)
        index = dev.index if dev.index is not None else torch.cuda.current_device()
        cols, window, grid = _mix_launch_plan(index, n, t, len(nbrs), vec)
        # the lists (n x n (column, weight) pairs, ELL) and their counts
        scratch = torch.empty(n * (2 * n + 1), dtype=torch.int32, device=dev)
        with torch.cuda.device(dev):
            err = lib.round_mix_launch(
                *_ptrs(w_off, w_self), *wires, scratch.data_ptr(),
                scratch.data_ptr() + 8 * n * n, n, t, len(nbrs), cols, window, grid,
                torch.cuda.current_stream(dev).cuda_stream)
        _raise_on(lib, err, "round_mix")
    launched(round_mix, n=n, t=t, wires=len(nbrs))
    return outs


round_mix.launches = 0


def _route(wires: int, bufs, olds, w_off, w_self, alpha, stale_mix: bool, **flags):
    """The two-pass route: the round's wire stage with no int8 store
    (:func:`wire_stage_gossip`, :func:`wire_stage` or
    :func:`wire_stage_gt`, counted under its own name), then
    :func:`round_mix` against the new reconstructions (``stale_mix``:
    ``olds``, the input ones) and the self terms (x for the gossip stage,
    h, and t_half on DSGT's tracker wire). Returns (mixed, new_recons,
    new_ress, scales), a tuple a wire."""
    if wires == GOSSIP_STAGE:
        _, scales, recon, res = wire_stage_gossip(*bufs, **flags, store_q=False)
        selfs, recons, ress, scales = (bufs[0],), (recon,), (res,), (scales,)
    elif wires == 1:
        h, _, scales, recon, res = wire_stage(*bufs, alpha, **flags, store_q=False)
        selfs, recons, ress, scales = (h,), (recon,), (res,), (scales,)
    else:
        h, t_half, _, scx, nrx, nsx, _, sct, nrt, nst = wire_stage_gt(
            *bufs, alpha, **flags, store_q=False)
        selfs, recons, ress, scales = (h, t_half), (nrx, nrt), (nsx, nst), (scx, sct)
    mixed = round_mix(w_off, w_self, olds if stale_mix else recons, selfs)
    return mixed, recons, ress, scales


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
    if _two_pass(n, t, scale_chunk, topk, GOSSIP_STAGE, x.device):
        (mixed,), (new_recon,), (new_res,), (scales,) = _route(
            GOSSIP_STAGE, (x, recon, res), (recon,), w_off, w_self, None, **flags)
        return mixed, new_recon, new_res, scales
    mixed, new_recon, new_res = (torch.empty_like(x) for _ in range(3))
    scales = torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        lib = _cluster_lib()
        tail = _round_tail(n, t, scale_chunk, topk,
                           (error_feedback, difference_coding, stale_mix), GOSSIP_STAGE,
                           x.device)
        with torch.cuda.device(x.device):
            err = lib.gossip_mix_cluster_launch(
                *_ptrs(x, recon, res, w_off, w_self),
                *_ptrs(mixed, new_recon, new_res, scales), *tail)
        _raise_on(lib, err, "gossip_mix")
    launched(gossip_mix, n=n, t=t, chunk=scale_chunk, topk=topk)
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
    ``dp_clip`` / ``dp_noise`` (n, t): the DP epilogue."""
    dp = _dp_operands(error_feedback, dp_clip, (dp_noise,))
    n, t = _check_operands("fused_round", (x, g, recon, res) + ((dp_noise,) if dp else ()),
                           scale_chunk, topk, (w_off, w_self))
    a = _alpha32(alpha)
    if dp:
        res, corr = _dp_dsgd(x, g, recon, res, a, difference_coding,
                             dp_clip, dp_noise)
        mixed, new_recon, new_res, scales = fused_round(
            x, g, recon, res, w_off, w_self, a, scale_chunk, error_feedback,
            difference_coding, topk, stale_mix)
        return mixed, new_recon, new_res + corr, scales
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk,
                 stale_mix=stale_mix)
    if x.device.type == "cpu":
        return fused_round_ref(x, g, recon, res, w_off, w_self, a, **flags)
    if _two_pass(n, t, scale_chunk, topk, 1, x.device):
        (mixed,), (new_recon,), (new_res,), (scales,) = _route(
            1, (x, g, recon, res), (recon,), w_off, w_self, a, **flags)
        return mixed, new_recon, new_res, scales
    mixed, new_recon, new_res = (torch.empty_like(x) for _ in range(3))
    scales = torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device)
    if x.device.type == "cuda":
        lib = _cluster_lib()
        tail = _round_tail(n, t, scale_chunk, topk,
                           (error_feedback, difference_coding, stale_mix), 1, x.device)
        with torch.cuda.device(x.device):
            err = lib.fused_round_cluster_launch(
                *_ptrs(x, g, recon, res, w_off, w_self), float(a),
                *_ptrs(mixed, new_recon, new_res, scales), *tail)
        _raise_on(lib, err, "fused_round")
    launched(fused_round, n=n, t=t, chunk=scale_chunk, topk=topk)
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
    new_res_t, scales_x, scales_t); keep ``g`` as the next ``g_prev``.
    ``dp_clip`` / ``dp_noise`` / ``dp_noise_t``: the DP epilogue on the
    parameter and the tracker wire."""
    dp = _dp_operands(error_feedback, dp_clip, (dp_noise, dp_noise_t))
    bufs = (x, t, g, g_prev, recon_x, res_x, recon_t, res_t)
    n, tot = _check_operands("fused_round_gt", bufs + ((dp_noise, dp_noise_t) if dp else ()),
                             scale_chunk, topk, (w_off, w_self))
    a = _alpha32(alpha)
    if dp:
        sx, st, cx, ct = _dp_dsgt(*bufs, a, difference_coding, dp_clip,
                                  dp_noise, dp_noise_t)
        mx, mt, nrx, nsx, nrt, nst, scx, sct = fused_round_gt(
            x, t, g, g_prev, recon_x, sx, recon_t, st, w_off, w_self, a, scale_chunk,
            error_feedback, difference_coding, topk, stale_mix)
        return mx, mt, nrx, nsx + cx, nrt, nst + ct, scx, sct
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk,
                 stale_mix=stale_mix)
    if x.device.type == "cpu":
        return fused_round_gt_ref(*bufs, w_off, w_self, a, **flags)
    if _two_pass(n, tot, scale_chunk, topk, 2, x.device):
        (mx, mt), (nrx, nrt), (nsx, nst), (scx, sct) = _route(
            2, bufs, (recon_x, recon_t), w_off, w_self, a, **flags)
        return mx, mt, nrx, nsx, nrt, nst, scx, sct
    outs = [torch.empty_like(x) for _ in range(6)] + [
        torch.empty(n, tot // scale_chunk, dtype=torch.float32, device=x.device)
        for _ in range(2)
    ]
    if x.device.type == "cuda":
        lib = _cluster_lib()
        tail = _round_tail(n, tot, scale_chunk, topk,
                           (error_feedback, difference_coding, stale_mix), 2, x.device)
        with torch.cuda.device(x.device):
            err = lib.fused_round_gt_cluster_launch(
                *_ptrs(*bufs, w_off, w_self), float(a), *_ptrs(*outs), *tail)
        _raise_on(lib, err, "fused_round_gt")
    launched(fused_round_gt, n=n, t=tot, chunk=scale_chunk, topk=topk)
    return tuple(outs)


fused_round_gt.launches = 0


def _wire_outs(x: torch.Tensor, n: int, t: int, scale_chunk: int, store_q: bool):
    """One wire's outputs: q int8 (n, t) (None without ``store_q``),
    scales, recon', res'."""
    return (torch.empty(n, t, dtype=torch.int8, device=x.device) if store_q else None,
            torch.empty(n, t // scale_chunk, dtype=torch.float32, device=x.device),
            torch.empty_like(x), torch.empty_like(x))


def _drop_q(outs: tuple, store_q: bool, *at: int) -> tuple:
    """A twin's outputs with the int8 payloads at ``at`` set to None
    without ``store_q``, as the kernel leaves them."""
    return outs if store_q else tuple(None if i in at else o for i, o in enumerate(outs))


def _wire_ptrs(*tensors) -> list:
    """:func:`_ptrs`, a null pointer for a payload not stored."""
    return [None if b is None else b.data_ptr() for b in tensors]


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
    store_q: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """DSGD wire stage: the round megakernel without its mix -- ``h = x -
    alpha * g``, then the int8 difference-coded quantization of h with
    error feedback (top-k masked when ``topk`` is set) -- in one kernel
    launch. Returns (h, q int8 (n, t), scales (n, t // scale_chunk),
    new_recon, new_res); the caller mixes. ``dp_clip`` / ``dp_noise``:
    the DP epilogue. ``store_q=False`` skips the int8 store (q None): the
    two-pass route's mix reads recon'."""
    dp = _dp_operands(error_feedback, dp_clip, (dp_noise,))
    n, t = _check_operands("wire_stage", (x, g, recon, res) + ((dp_noise,) if dp else ()),
                           scale_chunk, topk)
    a = _alpha32(alpha)
    if dp:
        res, corr = _dp_dsgd(x, g, recon, res, a, difference_coding,
                             dp_clip, dp_noise)
        h, q, scales, new_recon, new_res = wire_stage(
            x, g, recon, res, a, scale_chunk, error_feedback, difference_coding, topk,
            store_q=store_q)
        return h, q, scales, new_recon, new_res + corr
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk)
    if x.device.type == "cpu":
        return _drop_q(wire_stage_ref(x, g, recon, res, a, **flags), store_q, 1)
    h = torch.empty_like(x)
    outs = _wire_outs(x, n, t, scale_chunk, store_q)
    if x.device.type == "cuda":
        lib = _wire_lib()
        _check_smem(lib.wire_stage_smem_bytes(scale_chunk), f"chunk {scale_chunk}")
        tail = _tail(n, t, scale_chunk, topk, (error_feedback, difference_coding),
                     x.device)
        with torch.cuda.device(x.device):
            err = lib.wire_stage_launch(*_ptrs(x, g, recon, res), float(a),
                                        *_wire_ptrs(h, *outs), *tail)
        _raise_on(lib, err, "wire_stage")
    launched(wire_stage, n=n, t=t, chunk=scale_chunk, topk=topk, q=store_q)
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
    store_q: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """DSGT wire stage: ``t_half = t + g - g_prev``, ``h = x - alpha *
    t_half``, then the quantize-EF stage on the tracker wire and on the
    parameter wire, in one kernel launch. Returns (h, t_half, q_x,
    scales_x, new_recon_x, new_res_x, q_t, scales_t, new_recon_t,
    new_res_t), q int8 (n, t). ``dp_clip`` / ``dp_noise`` /
    ``dp_noise_t``: the DP epilogue on both wires. ``store_q``: as in
    :func:`wire_stage`, on both wires."""
    dp = _dp_operands(error_feedback, dp_clip, (dp_noise, dp_noise_t))
    bufs = (x, t, g, g_prev, recon_x, res_x, recon_t, res_t)
    n, tot = _check_operands("wire_stage_gt", bufs + ((dp_noise, dp_noise_t) if dp else ()),
                             scale_chunk, topk)
    a = _alpha32(alpha)
    if dp:
        sx, st, cx, ct = _dp_dsgt(*bufs, a, difference_coding, dp_clip,
                                  dp_noise, dp_noise_t)
        h, th, qx, scx, nrx, nsx, qt, sct, nrt, nst = wire_stage_gt(
            x, t, g, g_prev, recon_x, sx, recon_t, st, a, scale_chunk, error_feedback,
            difference_coding, topk, store_q=store_q)
        return h, th, qx, scx, nrx, nsx + cx, qt, sct, nrt, nst + ct
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk)
    if x.device.type == "cpu":
        return _drop_q(wire_stage_gt_ref(*bufs, a, **flags), store_q, 2, 6)
    h, t_half = torch.empty_like(x), torch.empty_like(x)
    outs_x = _wire_outs(x, n, tot, scale_chunk, store_q)
    outs_t = _wire_outs(x, n, tot, scale_chunk, store_q)
    if x.device.type == "cuda":
        lib = _wire_lib()
        _check_smem(lib.wire_stage_smem_bytes(scale_chunk), f"chunk {scale_chunk}")
        tail = _tail(n, tot, scale_chunk, topk, (error_feedback, difference_coding),
                     x.device)
        with torch.cuda.device(x.device):
            err = lib.wire_stage_gt_launch(*_ptrs(*bufs), float(a),
                                           *_wire_ptrs(h, t_half, *outs_x, *outs_t), *tail)
        _raise_on(lib, err, "wire_stage_gt")
    launched(wire_stage_gt, n=n, t=tot, chunk=scale_chunk, topk=topk, q=store_q)
    return (h, t_half, *outs_x, *outs_t)


wire_stage_gt.launches = 0


def wire_stage_gossip(
    x: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    scale_chunk: int = 512,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    store_q: bool = True,
) -> Tuple[torch.Tensor, ...]:
    """The gossip stage's wire stage, pass 1 of ``gossip_mix``'s two-pass
    route: the int8 difference-coded quantization of x with error
    feedback (top-k masked when ``topk`` is set), no local update, in one
    kernel launch. Returns (q int8 (n, t), scales (n, t // scale_chunk),
    new_recon, new_res); ``store_q`` as in :func:`wire_stage`."""
    n, t = _check_operands("wire_stage_gossip", (x, recon, res), scale_chunk, topk)
    flags = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
                 difference_coding=difference_coding, topk=topk)
    if x.device.type == "cpu":
        return _drop_q(wire_stage_gossip_ref(x, recon, res, **flags), store_q, 0)
    outs = _wire_outs(x, n, t, scale_chunk, store_q)
    if x.device.type == "cuda":
        lib = _wire_lib()
        _check_smem(lib.wire_stage_smem_bytes(scale_chunk), f"chunk {scale_chunk}")
        tail = _tail(n, t, scale_chunk, topk, (error_feedback, difference_coding),
                     x.device)
        with torch.cuda.device(x.device):
            err = lib.wire_stage_gossip_launch(*_ptrs(x, recon, res), *_wire_ptrs(*outs),
                                               *tail)
        _raise_on(lib, err, "wire_stage_gossip")
    launched(wire_stage_gossip, n=n, t=t, chunk=scale_chunk, topk=topk, q=store_q)
    return outs


wire_stage_gossip.launches = 0


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
    (n, C*chunk/8) uint8 in place of the positions. ``dp_clip`` /
    ``dp_noise``: the DP epilogue (the selection then runs on the noised
    wire)."""
    dp = _dp_operands(error_feedback, dp_clip, (dp_noise,))
    n, t = _check_operands("wire_stage_compact",
                           (x, g, recon, res) + ((dp_noise,) if dp else ()), scale_chunk, None)
    check_compact(topk, scale_chunk, bitmap)
    a = _alpha32(alpha)
    if dp:
        res, corr = _dp_dsgd(x, g, recon, res, a, difference_coding,
                             dp_clip, dp_noise)
        h, q, idx, scales, new_recon, new_res = wire_stage_compact(
            x, g, recon, res, a, scale_chunk, error_feedback, difference_coding, topk,
            bitmap)
        return h, q, idx, scales, new_recon, new_res + corr
    if x.device.type == "cpu":
        return wire_stage_compact_ref(
            x, g, recon, res, a, scale_chunk=scale_chunk, error_feedback=error_feedback,
            difference_coding=difference_coding, topk=topk, bitmap=bitmap)
    h = torch.empty_like(x)
    outs = _compact_outs(x, n, t, scale_chunk, topk, bitmap)
    if x.device.type == "cuda":
        lib = _compact_lib()
        _check_smem(lib.wire_stage_compact_smem_bytes(scale_chunk, topk),
                    f"chunk {scale_chunk} at topk {topk}")
        tail = _compact_tail(n, t, scale_chunk, topk, error_feedback, difference_coding,
                             bitmap, x.device)
        with torch.cuda.device(x.device):
            err = lib.wire_stage_compact_launch(*_ptrs(x, g, recon, res), float(a),
                                                *_ptrs(h, *outs), *tail)
        _raise_on(lib, err, "wire_stage_compact")
    launched(wire_stage_compact, n=n, t=t, chunk=scale_chunk, topk=topk, bitmap=bitmap)
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
    ``bitmap`` as in :func:`wire_stage_compact`, on both wires; ``dp_clip``
    / ``dp_noise`` / ``dp_noise_t``: the DP epilogue on both wires."""
    dp = _dp_operands(error_feedback, dp_clip, (dp_noise, dp_noise_t))
    bufs = (x, t, g, g_prev, recon_x, res_x, recon_t, res_t)
    n, tot = _check_operands("wire_stage_gt_compact",
                             bufs + ((dp_noise, dp_noise_t) if dp else ()), scale_chunk, None)
    check_compact(topk, scale_chunk, bitmap)
    a = _alpha32(alpha)
    if dp:
        sx, st, cx, ct = _dp_dsgt(*bufs, a, difference_coding, dp_clip,
                                  dp_noise, dp_noise_t)
        (h, th, qx, ix, scx, nrx, nsx, qt, it, sct, nrt, nst) = wire_stage_gt_compact(
            x, t, g, g_prev, recon_x, sx, recon_t, st, a, scale_chunk, error_feedback,
            difference_coding, topk, bitmap)
        return h, th, qx, ix, scx, nrx, nsx + cx, qt, it, sct, nrt, nst + ct
    if x.device.type == "cpu":
        return wire_stage_gt_compact_ref(
            *bufs, a, scale_chunk=scale_chunk, error_feedback=error_feedback,
            difference_coding=difference_coding, topk=topk, bitmap=bitmap)
    h, t_half = torch.empty_like(x), torch.empty_like(x)
    outs_x = _compact_outs(x, n, tot, scale_chunk, topk, bitmap)
    outs_t = _compact_outs(x, n, tot, scale_chunk, topk, bitmap)
    if x.device.type == "cuda":
        lib = _compact_lib()
        tail = _compact_tail(n, tot, scale_chunk, topk, error_feedback, difference_coding,
                             bitmap, x.device, _compact_gt_layout(scale_chunk, topk, bitmap))
        with torch.cuda.device(x.device):
            err = lib.wire_stage_gt_compact_launch(
                *_ptrs(*bufs), float(a), *_ptrs(h, t_half, *outs_x, *outs_t), *tail)
        _raise_on(lib, err, "wire_stage_gt_compact")
    launched(wire_stage_gt_compact, n=n, t=tot, chunk=scale_chunk, topk=topk,
             bitmap=bitmap)
    return (h, t_half, *outs_x, *outs_t)


wire_stage_gt_compact.launches = 0
