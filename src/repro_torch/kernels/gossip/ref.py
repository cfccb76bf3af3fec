"""Plain PyTorch twins of the gossip kernels (counterpart of
``repro.kernels.gossip.ref``).

They compute the CHOCO-gossip stage on a flat ``(nodes, total)`` buffer
with per-``(node, scale_chunk)`` int8 scales and an optional top-k mask,
materializing the payload, dq and recon intermediates that the CUDA
kernels (``csrc/fused_round_cluster.cu``, ``csrc/wire_stage.cu``,
``csrc/wire_stage_compact.cu``) keep on chip.
They are what the kernel wrappers run for CPU tensors, and the oracle
every kernel is held to on the card.

Each elementwise step is its own rounded fp32 operation, in the
reference's order, so the kernels (which use explicitly rounded
intrinsics, no FMA contraction) reproduce ``h``, ``t_half``, ``q``,
``new_recon``, ``new_res`` and ``scales`` bit for bit; only ``mixed``
differs, by the summation order of the ``W_off @ recon'`` contraction.

The compact top-k wire (``wire_stage_compact_ref`` and its DSGT twin)
keeps EXACTLY k columns per (row, chunk) -- the k largest |payload|,
ties broken toward the lower index, as ``jax.lax.top_k`` does -- and
ships (k int8 values, k positions or a presence bitmap, one scale) per
chunk; the receive side (``scatter_compact_dq``, ``compact_to_bitmap``,
``scatter_bitmap_dq``) rebuilds the dense dq from exactly those bytes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.packing import compact_pos_dtype

__all__ = ["gossip_mix_ref", "fused_round_ref", "fused_round_gt_ref",
           "wire_stage_ref", "wire_stage_gt_ref", "wire_stage_compact_ref",
           "wire_stage_gt_compact_ref", "scatter_compact_dq",
           "compact_to_bitmap", "scatter_bitmap_dq", "check_compact"]

DP_MSG = (
    "the differential-privacy wire epilogue is not ported yet (ROADMAP.md "
    "queue 1, item 12)"
)


def refuse_unported(dp_clip=None, dp_noise=None) -> None:
    """Raise for the wire options the port does not have yet (shared by
    the twins' callers and the kernel wrappers)."""
    if dp_clip is not None or dp_noise is not None:
        raise NotImplementedError(DP_MSG)


def check_topk(topk) -> None:
    """``topk`` is None (dense wire) or a positive column count per scale
    chunk; ``topk >= scale_chunk`` keeps every column."""
    if topk is not None and topk < 1:
        raise ValueError(f"topk must be >= 1 or None, got {topk}")


def check_compact(topk, scale_chunk: int, bitmap: bool = False) -> None:
    """The compact wire's geometry rule (the reference's
    ``gossip._check_compact``): exactly k < chunk columns per chunk, and a
    bitmap only on a byte-aligned chunk."""
    if topk is None or not 1 <= topk < scale_chunk:
        raise ValueError(
            f"the compact wire needs 1 <= topk < scale_chunk, got "
            f"topk={topk}, scale_chunk={scale_chunk} (use the dense wire "
            "stage when the payload is not sparsified)"
        )
    if bitmap and scale_chunk % 8:
        raise ValueError(f"bitmap wire needs a byte-aligned chunk, got {scale_chunk}")


def _div127(x: torch.Tensor) -> torch.Tensor:
    """x / 127 by IEEE division: PyTorch's CUDA division by a CPU scalar
    multiplies by the reciprocal, one ulp off, so divide by a tensor on
    x's device."""
    return x / torch.full((), 127.0, dtype=torch.float32, device=x.device)


def _quantize_ef_chunks(payload: torch.Tensor, scale_chunk: int, topk=None):
    """Per-(node, scale_chunk) symmetric int8 quantization, with the
    optional top-k mask of ``gossip.py:_topk_mask``: the threshold is the
    k-th largest |payload| of the (node, chunk), counted with
    multiplicity, and every element at or above it is kept (all ties);
    the rest become +0.0. Returns (q as fp32 integers (n, C, chunk),
    scales (n, C), dq (n, t))."""
    n, t = payload.shape
    p3 = payload.reshape(n, t // scale_chunk, scale_chunk)
    if topk is not None and topk < scale_chunk:
        mag = p3.abs()
        thr = torch.sort(mag, dim=2).values[:, :, scale_chunk - topk, None]
        p3 = torch.where(mag >= thr, p3, 0.0)
    scales = _div127(p3.abs().amax(dim=2))
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(p3 / safe.unsqueeze(-1)), -127.0, 127.0)
    dq = (q * scales.unsqueeze(-1)).reshape(n, t)
    return q, scales, dq


def _stage(x, recon, res, scale_chunk, error_feedback, difference_coding,
           topk):
    """The quantize-EF stage on one wire: difference coding, error
    feedback, (top-k,) int8. Returns (q, scales, new_recon, new_res)."""
    if x.shape[1] % scale_chunk:
        raise ValueError(
            f"total {x.shape[1]} not a multiple of scale_chunk {scale_chunk}")
    check_topk(topk)
    base = recon if difference_coding else torch.zeros_like(recon)
    payload = x - base
    if error_feedback:
        payload = payload + res
    q, scales, dq = _quantize_ef_chunks(payload, scale_chunk, topk)
    new_recon = base + dq
    new_res = payload - dq if error_feedback else res
    return q, scales, new_recon, new_res


def gossip_mix_ref(
    x: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    w_off: torch.Tensor,
    w_self: torch.Tensor,
    *,
    scale_chunk: int,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    stale_mix: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """One compressed gossip round on flat fp32 buffers.

    x, recon, res: (n, t) with t % scale_chunk == 0; w_off (n, n) with a
    zero diagonal; w_self (n,). ``topk`` keeps the k largest-|payload|
    columns of each (node, chunk), ties included. ``stale_mix`` mixes
    against the INPUT recon (the pipelined schedule's one-round-stale
    neighbor view). Returns (mixed, new_recon, new_res, scales
    (n, t // scale_chunk)).
    """
    _, scales, new_recon, new_res = _stage(
        x, recon, res, scale_chunk, error_feedback, difference_coding, topk)
    nbr = recon if stale_mix else new_recon
    mixed = w_off @ nbr + w_self.unsqueeze(1) * x
    return mixed, new_recon, new_res, scales


def fused_round_ref(
    x: torch.Tensor,
    g: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    w_off: torch.Tensor,
    w_self: torch.Tensor,
    alpha,
    *,
    scale_chunk: int,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    stale_mix: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """DSGD round: the local update ``h = x - alpha * g`` followed by one
    compressed gossip round on h (adapt-then-combine). ``alpha`` is an
    fp32 scalar (float, numpy scalar or 0-dim tensor)."""
    a = torch.as_tensor(alpha, dtype=torch.float32)
    h = x - a * g
    return gossip_mix_ref(
        h, recon, res, w_off, w_self, scale_chunk=scale_chunk,
        error_feedback=error_feedback, difference_coding=difference_coding,
        topk=topk, stale_mix=stale_mix,
    )


def fused_round_gt_ref(
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
    *,
    scale_chunk: int,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    stale_mix: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """DSGT round (adapt-then-combine gradient tracking):

        t_half = t + g - g_prev
        h      = x - alpha * t_half
        t'     = quantize-mix(t_half)    (tracker wire)
        x'     = quantize-mix(h)         (parameter wire)

    Returns (mixed_x, mixed_t, new_recon_x, new_res_x, new_recon_t,
    new_res_t, scales_x, scales_t); the caller keeps ``g`` as the next
    round's ``g_prev``."""
    a = torch.as_tensor(alpha, dtype=torch.float32)
    t_half = t + g - g_prev
    h = x - a * t_half
    kw = dict(scale_chunk=scale_chunk, error_feedback=error_feedback,
              difference_coding=difference_coding, topk=topk,
              stale_mix=stale_mix)
    mt, nrt, nst, sct = gossip_mix_ref(t_half, recon_t, res_t, w_off, w_self, **kw)
    mx, nrx, nsx, scx = gossip_mix_ref(h, recon_x, res_x, w_off, w_self, **kw)
    return mx, mt, nrx, nsx, nrt, nst, scx, sct


def _int8(q: torch.Tensor, n: int, t: int) -> torch.Tensor:
    """The wire's int8 payload from the clipped fp32 integers (exact)."""
    return q.reshape(n, t).to(torch.int8)


def wire_stage_ref(
    x: torch.Tensor,
    g: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    alpha,
    *,
    scale_chunk: int,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGD wire stage (the round without its mix): local update +
    difference coding + (top-k) int8 quantize + EF. Returns (h, q int8
    (n, t), scales (n, t // scale_chunk), new_recon, new_res); the caller
    mixes against whatever neighbor reconstruction its schedule wants."""
    a = torch.as_tensor(alpha, dtype=torch.float32)
    h = x - a * g
    q, scales, new_recon, new_res = _stage(
        h, recon, res, scale_chunk, error_feedback, difference_coding, topk)
    return h, _int8(q, *x.shape), scales, new_recon, new_res


def wire_stage_gt_ref(
    x: torch.Tensor,
    t: torch.Tensor,
    g: torch.Tensor,
    g_prev: torch.Tensor,
    recon_x: torch.Tensor,
    res_x: torch.Tensor,
    recon_t: torch.Tensor,
    res_t: torch.Tensor,
    alpha,
    *,
    scale_chunk: int,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
) -> Tuple[torch.Tensor, ...]:
    """DSGT wire stage: tracker arithmetic + parameter update + both
    wires' quantize-EF (the tracker wire quantizes ``t_half`` itself).
    Returns (h, t_half, q_x, scales_x, new_recon_x, new_res_x, q_t,
    scales_t, new_recon_t, new_res_t)."""
    a = torch.as_tensor(alpha, dtype=torch.float32)
    t_half = t + g - g_prev
    h = x - a * t_half
    flags = (scale_chunk, error_feedback, difference_coding, topk)
    qt, sct, nrt, nst = _stage(t_half, recon_t, res_t, *flags)
    qx, scx, nrx, nsx = _stage(h, recon_x, res_x, *flags)
    shape = x.shape
    return (h, t_half, _int8(qx, *shape), scx, nrx, nsx, _int8(qt, *shape),
            sct, nrt, nst)


def _quantize_ef_compact_chunks(payload: torch.Tensor, scale_chunk: int, topk: int):
    """Exact-k quantize core (the reference's
    ``_quantize_ef_compact_chunks``): per (row, chunk) the k largest
    |payload| in descending order, ties toward the lower index (a stable
    descending sort; ``torch.topk`` leaves tie order unspecified), int8
    quantization of the survivors against ``max|survivors| / 127``, and
    the dense dq added into zeros (so a quantized -0.0 lands as +0.0).
    Returns (q (n, C*k) fp32 integers, pos (n, C*k) int64, scales (n, C),
    dq (n, t))."""
    n, t = payload.shape
    c = t // scale_chunk
    p2 = payload.reshape(n * c, scale_chunk)
    pos = torch.sort(p2.abs(), dim=1, descending=True, stable=True).indices[:, :topk]
    vals = torch.gather(p2, 1, pos)
    scales = _div127(vals.abs().amax(dim=1, keepdim=True))
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(vals / safe), -127.0, 127.0)
    dq = torch.zeros_like(p2).scatter_add_(1, pos, q * scales).reshape(n, t)
    return (q.reshape(n, c * topk), pos.reshape(n, c * topk),
            scales.reshape(n, c), dq)


def _compact_stage(x, recon, res, scale_chunk, error_feedback,
                   difference_coding, topk):
    """The compact quantize-EF stage on one wire. Returns (q int8, pos,
    scales, new_recon, new_res)."""
    base = recon if difference_coding else torch.zeros_like(recon)
    payload = x - base
    if error_feedback:
        payload = payload + res
    q, pos, scales, dq = _quantize_ef_compact_chunks(payload, scale_chunk, topk)
    new_recon = base + dq
    new_res = payload - dq if error_feedback else res
    return (q.to(torch.int8), pos.to(compact_pos_dtype(scale_chunk)), scales,
            new_recon, new_res)


def _check_compact_geometry(t: int, scale_chunk: int, topk, bitmap: bool) -> None:
    if t % scale_chunk:
        raise ValueError(f"total {t} not a multiple of scale_chunk {scale_chunk}")
    check_compact(topk, scale_chunk, bitmap)


def _encode(q, pos, scales, nrecon, nres, scale_chunk, topk, bitmap):
    """One wire's outputs, the index side as positions or, with
    ``bitmap``, re-encoded as ``compact_to_bitmap`` does."""
    if bitmap:
        q, pos = compact_to_bitmap(q, pos, scale_chunk, topk)
    return q, pos, scales, nrecon, nres


def wire_stage_compact_ref(
    x: torch.Tensor,
    g: torch.Tensor,
    recon: torch.Tensor,
    res: torch.Tensor,
    alpha,
    *,
    scale_chunk: int,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    bitmap: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """DSGD compact wire stage: local update + difference coding +
    EXACT-k selection + int8 quantize + EF. Returns (h, q int8
    (n, C*k), pos (n, C*k) at ``compact_pos_dtype``, scales (n, C),
    new_recon, new_res); only (q, pos, scales) cross the wire. With
    ``bitmap`` the values come in ascending-position order and the index
    output is the packed LSB-first presence bitmap (n, C*chunk/8) uint8
    (``compact_to_bitmap`` of the explicit-position output)."""
    _check_compact_geometry(x.shape[1], scale_chunk, topk, bitmap)
    a = torch.as_tensor(alpha, dtype=torch.float32)
    h = x - a * g
    outs = _compact_stage(h, recon, res, scale_chunk, error_feedback,
                          difference_coding, topk)
    return (h, *_encode(*outs, scale_chunk, topk, bitmap))


def wire_stage_gt_compact_ref(
    x: torch.Tensor,
    t: torch.Tensor,
    g: torch.Tensor,
    g_prev: torch.Tensor,
    recon_x: torch.Tensor,
    res_x: torch.Tensor,
    recon_t: torch.Tensor,
    res_t: torch.Tensor,
    alpha,
    *,
    scale_chunk: int,
    error_feedback: bool = True,
    difference_coding: bool = True,
    topk=None,
    bitmap: bool = False,
) -> Tuple[torch.Tensor, ...]:
    """DSGT compact wire stage: tracker arithmetic + parameter update +
    both wires' compact quantize-EF. Returns (h, t_half, q_x, pos_x,
    scales_x, new_recon_x, new_res_x, q_t, pos_t, scales_t, new_recon_t,
    new_res_t); ``bitmap`` as in :func:`wire_stage_compact_ref`, on both
    wires."""
    _check_compact_geometry(x.shape[1], scale_chunk, topk, bitmap)
    a = torch.as_tensor(alpha, dtype=torch.float32)
    t_half = t + g - g_prev
    h = x - a * t_half
    flags = (scale_chunk, error_feedback, difference_coding, topk)
    wire_t = _compact_stage(t_half, recon_t, res_t, *flags)
    wire_x = _compact_stage(h, recon_x, res_x, *flags)
    return (h, t_half, *_encode(*wire_x, scale_chunk, topk, bitmap),
            *_encode(*wire_t, scale_chunk, topk, bitmap))


def _compact_width(ck: int, total: int, scale_chunk: int) -> Tuple[int, int]:
    """(n_chunks, k) of a compact payload of width ``ck``."""
    if total % scale_chunk:
        raise ValueError(f"total {total} not a multiple of scale_chunk {scale_chunk}")
    c = total // scale_chunk
    if ck % c:
        raise ValueError(f"compact width {ck} not a multiple of n_chunks {c}")
    return c, ck // c


def scatter_compact_dq(q: torch.Tensor, pos: torch.Tensor, scales: torch.Tensor,
                       scale_chunk: int, total: int) -> torch.Tensor:
    """Receive side of the compact wire: the (rows, total) fp32 dense dq
    rebuilt from (q (rows, C*k) int8, pos (rows, C*k) in-chunk positions,
    scales (rows, C)) by adding each value into zeros -- equal to the
    sender's dq bit for bit."""
    rows, ck = q.shape
    c, k = _compact_width(ck, total, scale_chunk)
    v = (q.to(torch.float32).reshape(rows, c, k) * scales[:, :, None]).reshape(rows, ck)
    cols = (pos.to(torch.int64).reshape(rows, c, k)
            + torch.arange(c, device=q.device)[None, :, None] * scale_chunk)
    return torch.zeros(rows, total, dtype=torch.float32, device=q.device).scatter_add_(
        1, cols.reshape(rows, ck), v)


def compact_to_bitmap(q: torch.Tensor, pos: torch.Tensor, scale_chunk: int,
                      topk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-encode a compact payload's index side as a presence bitmap:
    returns (the same k values per chunk in ascending-position order
    (rows, C*k) int8, the packed LSB-first bitmap (rows, C*chunk/8)
    uint8: bit ``c % 8`` of byte ``c // 8`` marks column c)."""
    if scale_chunk % 8:
        raise ValueError(f"bitmap wire needs a byte-aligned chunk, got {scale_chunk}")
    rows, ck = q.shape
    if ck % topk:
        raise ValueError(f"compact width {ck} not a multiple of k={topk}")
    c = ck // topk
    p3 = pos.to(torch.int64).reshape(rows, c, topk)
    order = torch.argsort(p3, dim=-1)  # positions in a chunk are distinct
    vals = torch.gather(q.reshape(rows, c, topk), -1, order)
    present = torch.zeros(rows, c, scale_chunk, dtype=torch.int32, device=q.device)
    present.scatter_(2, p3, 1)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=q.device)
    bits = (present.reshape(rows, c, scale_chunk // 8, 8) * weights).sum(-1)
    return vals.reshape(rows, ck), bits.to(torch.uint8).reshape(rows, c * (scale_chunk // 8))


def scatter_bitmap_dq(vals: torch.Tensor, bits: torch.Tensor, scales: torch.Tensor,
                      scale_chunk: int, total: int) -> torch.Tensor:
    """Receive side of the bitmap wire: unpack the LSB-first bits,
    prefix-sum them along the chunk into each present column's slot in
    the ascending-position value list, gather; 0.0 off the bitmap."""
    if scale_chunk % 8:
        raise ValueError(f"bad geometry: total={total}, scale_chunk={scale_chunk}")
    rows, ck = vals.shape
    c, k = _compact_width(ck, total, scale_chunk)
    shifts = torch.arange(8, dtype=torch.int32, device=vals.device)
    present = ((bits.reshape(rows, c, scale_chunk // 8, 1).to(torch.int32) >> shifts) & 1
               ).reshape(rows, c, scale_chunk)
    slot = torch.cumsum(present, dim=-1) - 1
    v3 = vals.to(torch.float32).reshape(rows, c, k) * scales[:, :, None]
    gathered = torch.gather(v3, -1, slot.clamp(0, k - 1).to(torch.int64))
    return torch.where(present > 0, gathered, 0.0).reshape(rows, total)
