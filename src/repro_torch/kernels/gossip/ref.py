"""Plain PyTorch twins of the gossip kernels (counterpart of
``repro.kernels.gossip.ref``).

They compute the CHOCO-gossip stage on a flat ``(nodes, total)`` buffer
with per-``(node, scale_chunk)`` int8 scales and an optional top-k mask,
materializing the payload, dq and recon intermediates that the CUDA
kernels (``csrc/fused_round.cu``, ``csrc/wire_stage.cu``) keep on chip.
They are what the kernel wrappers run for CPU tensors, and the oracle
every kernel is held to on the card.

Each elementwise step is its own rounded fp32 operation, in the
reference's order, so the kernels (which use explicitly rounded
intrinsics, no FMA contraction) reproduce ``h``, ``t_half``, ``q``,
``new_recon``, ``new_res`` and ``scales`` bit for bit; only ``mixed``
differs, by the summation order of the ``W_off @ recon'`` contraction.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["gossip_mix_ref", "fused_round_ref", "fused_round_gt_ref",
           "wire_stage_ref", "wire_stage_gt_ref"]

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
    # divide by a tensor ON the payload's device: PyTorch's CUDA division
    # by a CPU scalar multiplies by its reciprocal, off by one ulp
    d127 = torch.full((), 127.0, dtype=torch.float32, device=payload.device)
    scales = p3.abs().amax(dim=2) / d127
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
