"""GQA self-attention for full sequences and for one-token decode against
a KV cache (counterpart of ``repro.models.attention``).

Parameters use FUSED head dims, as in the reference -- wq: (d, H*hd),
wk/wv: (d, K*hd), wo: (H*hd, d) -- so the two packages' trees match leaf
for leaf. The reference picks its inner attention with ``impl``; the
port dispatches by device instead: :func:`attn_apply` calls the flash
kernel's wrapper and :func:`attn_decode` the decode kernel's, which run
the hand-written CUDA kernels on CUDA tensors and their plain twins on
CPU tensors. Both kernels take un-repeated K/V (GQA native) and keep the
softmax probabilities in fp32, as the reference's Pallas kernels do (its
``_sdpa`` casts them to v's dtype, so at bf16 the port follows the
reference's kernel paths more closely than its ``ref`` path).

Cross-attention (the whisper decoder's) attends unmasked over the
encoder's precomputed K/V: :func:`cross_attn_apply` is one non-causal
flash call with Sq the decoder's tokens and Sk the encoder's frames
(prefill, loss), :func:`cross_attn_decode` one decode-kernel call with
every row's ``n_valid`` the encoder length (a decode step). The
reference runs its plain ``_sdpa`` for both; the kernels compute the
same function, with fp32 probabilities.

On a model group (``tp``, ``models.tensor_parallel``) :func:`attn_apply`
runs on the rank's shards: ``wq``/``wk``/``wv`` column-parallel and
``wo`` row-parallel over the same range of the fused H*hd dimension
(:func:`tp_head_plan`). Where the range holds whole heads and whole GQA
groups, the rank attends on its own heads and no collective is added.
Where it cuts through a head (SmolLM-360M's 15 heads, phi3-medium's and
qwen2.5's 40 over 16 ranks) or through a kv head (TinyLlama's 4 kv heads
over 16), ONE all-gather of the rank's q / k / v columns (only those
that some rank's range cuts: the choice is the group's, so every rank
issues the same collectives) over the model group gives every rank the
whole heads its ``wo`` rows cover; it attends on those heads with K/V
expanded to them where they are not whole GQA groups (the flash wrapper
takes q heads a multiple of kv heads), and keeps its own columns of the
output. Backward the gather costs one all-reduce of its gradient.
Cross-attention takes the same plan (``n_heads`` q and kv heads, no pad
heads): :func:`precompute_cross_kv` projects the rank's k / v columns of
the encoder output and :func:`cross_attn_apply` its q columns of the
decoder stream, each all-gathered (k and v together) only where a
rank's columns cut a head; ``wo`` is row-parallel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, linear, row_parallel_linear
from repro_torch.models.tensor_parallel import TPGroup, copy_to_model, gather_from_model

__all__ = [
    "layout_heads",
    "attn_init",
    "attn_apply",
    "tp_head_plan",
    "init_kv_cache",
    "attn_decode",
    "cross_attn_init",
    "precompute_cross_kv",
    "cross_attn_apply",
    "cross_attn_decode",
    "NEG_INF",
]

NEG_INF = -1e30


def layout_heads(n_heads: int, pad_to: int) -> int:
    """Physical head count: logical heads padded up to a multiple of
    ``pad_to`` (the reference's tensor-parallel degree). Padded heads
    contribute exactly zero, so the model is the logical-head model."""
    if pad_to <= 0 or n_heads % pad_to == 0:
        return n_heads
    return ((n_heads + pad_to - 1) // pad_to) * pad_to


def _pad_heads(x: torch.Tensor, n_layout: int) -> torch.Tensor:
    """(B, T, H, hd) -> (B, T, n_layout, hd) with zero pad heads."""
    h = x.shape[-2]
    if h == n_layout:
        return x
    return F.pad(x, (0, 0, 0, n_layout - h))


def _head_mask(n_heads: int, n_layout: int, dtype, device) -> Optional[torch.Tensor]:
    if n_layout == n_heads:
        return None
    mask = (torch.arange(n_layout, device=device) < n_heads).to(dtype)
    return mask[None, None, :, None]


def attn_init(generator, d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
              dtype=torch.float32, qkv_bias: bool = False,
              n_heads_layout: Optional[int] = None, device=None, lead=()) -> Dict:
    hl = n_heads_layout or n_heads
    return {
        "wq": dense_init(generator, d_model, hl * head_dim, device, qkv_bias, dtype, lead),
        "wk": dense_init(generator, d_model, n_kv_heads * head_dim, device, qkv_bias,
                         dtype, lead),
        "wv": dense_init(generator, d_model, n_kv_heads * head_dim, device, qkv_bias,
                         dtype, lead),
        "wo": dense_init(generator, hl * head_dim, d_model, device, False, dtype, lead),
    }


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _repeat_kv(kv: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,T,K,hd) -> (B,T,H,hd) by repeating each kv head H/K times."""
    n_kv = kv.shape[-2]
    if n_kv == n_heads:
        return kv
    return torch.repeat_interleave(kv, n_heads // n_kv, dim=-2)


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool,
          window: int, q_offset=0, kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The reference's plain scaled-dot-product attention, op for op:
    scores in the operands' dtype then fp32, softmax in fp32, the
    probabilities cast to v's dtype before P·V. q (B,S,H,hd); k, v
    (B,T,H,hd), repeated to H heads (:func:`_repeat_kv`); ``q_offset`` is
    q[0]'s absolute position minus k[0]'s; ``kv_valid`` (B,T) bool marks
    populated cache slots. The port's own paths run the kernels' wrappers
    (their twins compute this function with fp32 probabilities); this
    one is kept as the reference's ``ref`` path for comparisons."""
    s, hd = q.shape[1], q.shape[-1]
    t = k.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).float()
    scores = scores / float(hd) ** 0.5
    qpos = torch.arange(s, device=q.device)[:, None] + q_offset
    kpos = torch.arange(t, device=q.device)[None, :]
    mask = torch.ones(s, t, dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    scores = torch.where(mask[None, None], scores, NEG_INF)
    if kv_valid is not None:
        scores = torch.where(kv_valid[:, None, None, :], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _logical_heads(q: torch.Tensor, n_heads: int) -> torch.Tensor:
    """The logical q heads of a padded layout, contiguous for the kernel."""
    return q if q.shape[-2] == n_heads else q[..., :n_heads, :].contiguous()


class TPHeads(NamedTuple):
    """One rank's share of the heads (:func:`tp_head_plan`): its q columns
    ``[q_lo, q_hi)`` of the fused H*hd dimension (``wq``'s columns,
    ``wo``'s rows), the layout heads ``[h_lo, h_hi)`` they touch, the
    logical heads among them ``[h_lo, a_hi)``, the kv heads those read
    ``[kv_lo, kv_hi)``, whether the q and the k/v columns are gathered,
    and whether K/V are expanded to the q heads."""

    q_lo: int
    q_hi: int
    h_lo: int
    h_hi: int
    a_hi: int
    kv_lo: int
    kv_hi: int
    gather_q: bool
    gather_kv: bool
    expand_kv: bool


def tp_head_plan(n_heads: int, n_kv_heads: int, head_dim: int, n_layout: int,
                 rank: int, size: int) -> TPHeads:
    """Rank ``rank`` of ``size``'s heads under the column split of
    ``models.sharding`` (``n_layout`` layout q heads, ``n_kv_heads`` kv
    heads of ``head_dim``): q is gathered where its columns cut a head,
    k/v where any rank's kv columns are not exactly the kv heads its q
    heads read. Every rank of the group must issue the same collectives,
    so both choices are the group's, the same on every rank (a padded
    layout can leave one rank's kv columns exact and another's not)."""
    hd, g = head_dim, n_heads // n_kv_heads
    if (n_layout * hd) % size or (n_kv_heads * hd) % size:
        raise ValueError(f"{n_layout} q / {n_kv_heads} kv heads of {hd} do not split "
                         f"evenly over {size} model ranks")
    cq, ck = n_layout * hd // size, n_kv_heads * hd // size

    def heads(r):
        q_lo, q_hi = r * cq, (r + 1) * cq
        h_lo, h_hi = q_lo // hd, -(-q_hi // hd)
        a_hi = max(h_lo, min(h_hi, n_heads))
        kv_lo = h_lo // g if a_hi > h_lo else 0
        kv_hi = (a_hi - 1) // g + 1 if a_hi > h_lo else 0
        return q_lo, q_hi, h_lo, h_hi, a_hi, kv_lo, kv_hi

    def kv_exact(r):
        kv_lo, kv_hi = heads(r)[5:]
        return (kv_lo * hd, kv_hi * hd) == (r * ck, (r + 1) * ck)

    q_lo, q_hi, h_lo, h_hi, a_hi, kv_lo, kv_hi = heads(rank)
    gather_q = cq % hd != 0
    gather_kv = gather_q or not all(kv_exact(r) for r in range(size))
    expand_kv = a_hi > h_lo and (h_lo % g != 0 or a_hi % g != 0)
    return TPHeads(q_lo, q_hi, h_lo, h_hi, a_hi, kv_lo, kv_hi, gather_q, gather_kv,
                   expand_kv)


def _attn_apply_tp(p: Dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
                   n_kv_heads: int, head_dim: int, rope_theta: Optional[float],
                   causal: bool, window: int, compute_dtype, hl: int,
                   tp: TPGroup) -> torch.Tensor:
    """:func:`attn_apply` on the rank's shards (see the module docstring)."""
    hd = head_dim
    plan = tp_head_plan(n_heads, n_kv_heads, hd, hl, tp.rank, tp.size)
    x = copy_to_model(x, tp)
    q = linear(p["wq"], x, compute_dtype)
    k = linear(p["wk"], x, compute_dtype)
    v = linear(p["wv"], x, compute_dtype)
    cq, ck = q.shape[-1], k.shape[-1]
    parts = ([q] if plan.gather_q else []) + ([k, v] if plan.gather_kv else [])
    if parts:
        got = gather_from_model(torch.cat(parts, dim=-1), tp)
        got = got.reshape(*got.shape[:-1], tp.size, -1)
        off = 0
        if plan.gather_q:
            q = got[..., off:off + cq].flatten(-2)
            off += cq
        if plan.gather_kv:
            k = got[..., off:off + ck].flatten(-2)
            v = got[..., off + ck:off + 2 * ck].flatten(-2)
        q_base = 0 if plan.gather_q else plan.q_lo // hd
        kv_base = 0
    else:
        q_base, kv_base = plan.h_lo, plan.kv_lo
    b, s = x.shape[:2]
    n_act = plan.a_hi - plan.h_lo
    out = x.new_zeros((b, s, plan.h_hi - plan.h_lo, hd), dtype=compute_dtype)
    if n_act:
        qh = _split_heads(q, q.shape[-1] // hd, hd)[..., plan.h_lo - q_base:
                                                     plan.a_hi - q_base, :]
        kh = _split_heads(k, k.shape[-1] // hd, hd)
        vh = _split_heads(v, v.shape[-1] // hd, hd)
        if plan.expand_kv:
            g = n_heads // n_kv_heads
            idx = torch.arange(plan.h_lo, plan.a_hi, device=x.device) // g - kv_base
            kh, vh = kh.index_select(-2, idx), vh.index_select(-2, idx)
        else:
            kh = kh[..., plan.kv_lo - kv_base:plan.kv_hi - kv_base, :]
            vh = vh[..., plan.kv_lo - kv_base:plan.kv_hi - kv_base, :]
        if rope_theta is not None:
            qh = apply_rope(qh, positions, rope_theta)
            kh = apply_rope(kh, positions, rope_theta)
        att = flash_attention(qh.contiguous(), kh.contiguous(), vh.contiguous(),
                              causal=causal, window=window)
        out = att if n_act == plan.h_hi - plan.h_lo else F.pad(
            att, (0, 0, 0, plan.h_hi - plan.a_hi))
    else:
        # pad heads only: the output is zero, but it must still reach q, k
        # and v, so that this rank issues the backward collectives of the
        # gather and of copy_to_model with the rest of the group
        out = out + sum(t[..., :0].sum() for t in (q, k, v))
    out = out.reshape(b, s, -1)[..., plan.q_lo - plan.h_lo * hd:plan.q_hi - plan.h_lo * hd]
    return row_parallel_linear(p["wo"], out, compute_dtype, tp)


def attn_apply(p: Dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
               n_kv_heads: int, head_dim: int, rope_theta: Optional[float],
               causal: bool = True, window: int = 0, compute_dtype=torch.bfloat16,
               n_heads_layout: Optional[int] = None,
               tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Self-attention over a full sequence (prefill): x (B, S, d),
    positions (B, S). The attention itself is one flash-kernel call on
    the logical heads with un-repeated K/V; padded layout heads are zero.
    ``tp``: the rank's shards of a model group (the module docstring)."""
    hl = n_heads_layout or n_heads
    if tp is not None:
        return _attn_apply_tp(p, x, positions, n_heads=n_heads, n_kv_heads=n_kv_heads,
                              head_dim=head_dim, rope_theta=rope_theta, causal=causal,
                              window=window, compute_dtype=compute_dtype, hl=hl, tp=tp)
    q = _split_heads(linear(p["wq"], x, compute_dtype), hl, head_dim)
    k = _split_heads(linear(p["wk"], x, compute_dtype), n_kv_heads, head_dim)
    v = _split_heads(linear(p["wv"], x, compute_dtype), n_kv_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    out = flash_attention(_logical_heads(q, n_heads), k.contiguous(), v.contiguous(),
                          causal=causal, window=window)
    out = _pad_heads(out, hl)
    mask = _head_mask(n_heads, hl, out.dtype, out.device)
    if mask is not None:
        out = out * mask
    return linear(p["wo"], out.reshape(*x.shape[:-1], hl * head_dim), compute_dtype)


def init_kv_cache(batch: int, length: int, n_kv_heads: int, head_dim: int,
                  dtype=torch.bfloat16, device=None) -> Dict:
    """Contiguous cache (full attention) or ring buffer (window attention:
    pass length=window), zeros on ``device`` (``cuda`` unless given).
    ``pos`` is the absolute next-token position, a 0-d int32 tensor."""
    dev = resolve_device(device)
    return {
        "k": torch.zeros(batch, length, n_kv_heads, head_dim, dtype=dtype, device=dev),
        "v": torch.zeros(batch, length, n_kv_heads, head_dim, dtype=dtype, device=dev),
        "pos": torch.zeros((), dtype=torch.int32, device=dev),
    }


def attn_decode(p: Dict, x: torch.Tensor, cache: Dict, *, n_heads: int, n_kv_heads: int,
                head_dim: int, rope_theta: Optional[float], ring: bool = False,
                compute_dtype=torch.bfloat16,
                n_heads_layout: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """One-token decode: x (B, 1, d) against the cache.

    ``ring=True`` treats the cache as a sliding-window ring buffer of size
    ``cache_len`` (keys stay rope'd at absolute positions, so the slot
    order does not matter). The new K/V row is written into the cache IN
    PLACE (one buffer per layer, where the reference returns an updated
    copy; past the end of a contiguous cache it lands on the last slot,
    as the reference's clamped update does); the returned dict holds the
    same k/v tensors and ``pos + 1``. The attention is one decode-kernel
    call over the first ``n_valid = min(pos + 1, cache_len)`` slots, on
    the logical heads, with the cache in its own layout."""
    b = x.shape[0]
    ck, cv, pos = cache["k"], cache["v"], cache["pos"]
    cache_len = ck.shape[1]
    positions = pos.reshape(1, 1).expand(b, 1)

    hl = n_heads_layout or n_heads
    q = _split_heads(linear(p["wq"], x, compute_dtype), hl, head_dim)
    k = _split_heads(linear(p["wk"], x, compute_dtype), n_kv_heads, head_dim)
    v = _split_heads(linear(p["wv"], x, compute_dtype), n_kv_heads, head_dim)
    if rope_theta is not None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)

    slot = pos % cache_len if ring else torch.clamp(pos, max=cache_len - 1)
    slot = slot.reshape(1).long()
    ck.index_copy_(1, slot, k.to(ck.dtype))
    cv.index_copy_(1, slot, v.to(cv.dtype))
    n_valid = torch.clamp(pos + 1, max=cache_len).reshape(1).expand(b)
    out = decode_attention(_logical_heads(q, n_heads), ck.to(compute_dtype),
                           cv.to(compute_dtype), n_valid)
    out = _pad_heads(out, hl)
    mask = _head_mask(n_heads, hl, out.dtype, out.device)
    if mask is not None:
        out = out * mask
    out = linear(p["wo"], out.reshape(b, 1, hl * head_dim), compute_dtype)
    return out, {"k": ck, "v": cv, "pos": pos + 1}


# ---------------------------------------------------------------------------
# cross attention (whisper decoder)
# ---------------------------------------------------------------------------


def cross_attn_init(generator, d_model: int, n_heads: int, head_dim: int,
                    dtype=torch.float32, device=None, lead=()) -> Dict:
    return attn_init(generator, d_model, n_heads, n_heads, head_dim, dtype, qkv_bias=True,
                     device=device, lead=lead)


def precompute_cross_kv(p: Dict, enc_out: torch.Tensor, n_heads: int, head_dim: int,
                        compute_dtype=torch.bfloat16, tp: Optional[TPGroup] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V, (B, T, H, hd) each, in ``compute_dtype``.
    ``tp``: the kv heads ``[kv_lo, kv_hi)`` the rank's q heads read
    (:func:`tp_head_plan`), column-parallel on ``enc_out`` -- which must
    have passed ``copy_to_model`` (``models.encdec`` passes the encoder
    output once for every decoder layer)."""
    k = linear(p["wk"], enc_out, compute_dtype)
    v = linear(p["wv"], enc_out, compute_dtype)
    if tp is not None:
        plan = tp_head_plan(n_heads, n_heads, head_dim, n_heads, tp.rank, tp.size)
        if plan.gather_kv:  # else the rank's columns are its kv heads
            ck = k.shape[-1]
            kv = gather_from_model(torch.cat([k, v], dim=-1), tp)
            kv = kv.reshape(*kv.shape[:-1], tp.size, 2 * ck)
            lo, hi = plan.kv_lo * head_dim, plan.kv_hi * head_dim
            k = kv[..., :ck].flatten(-2)[..., lo:hi]
            v = kv[..., ck:].flatten(-2)[..., lo:hi]
    return (_split_heads(k, k.shape[-1] // head_dim, head_dim),
            _split_heads(v, v.shape[-1] // head_dim, head_dim))


def cross_attn_apply(p: Dict, x: torch.Tensor, kv: Tuple[torch.Tensor, torch.Tensor], *,
                     n_heads: int, head_dim: int, compute_dtype=torch.bfloat16,
                     tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Decoder queries x (B, S, d) attend, unmasked, over precomputed
    encoder K/V (B, T, H, hd): one non-causal flash-kernel call. ``tp``:
    on the rank's heads, ``kv`` its :func:`precompute_cross_kv`."""
    k, v = kv
    if tp is None:
        q = _split_heads(linear(p["wq"], x, compute_dtype), n_heads, head_dim)
        out = flash_attention(q, k.contiguous(), v.contiguous(), causal=False, window=0)
        return linear(p["wo"], out.reshape(*x.shape[:-1], n_heads * head_dim), compute_dtype)
    hd = head_dim
    plan = tp_head_plan(n_heads, n_heads, hd, n_heads, tp.rank, tp.size)
    q = linear(p["wq"], copy_to_model(x, tp), compute_dtype)
    q_base = plan.h_lo
    if plan.gather_q:
        q, q_base = gather_from_model(q, tp), 0
    qh = _split_heads(q, q.shape[-1] // hd, hd)[..., plan.h_lo - q_base:plan.a_hi - q_base, :]
    out = flash_attention(qh.contiguous(), k.contiguous(), v.contiguous(), causal=False,
                          window=0)
    out = out.reshape(*x.shape[:-1], -1)[..., plan.q_lo - plan.h_lo * hd:
                                         plan.q_hi - plan.h_lo * hd]
    return row_parallel_linear(p["wo"], out, compute_dtype, tp)


def cross_attn_decode(p: Dict, x: torch.Tensor, kv: Tuple[torch.Tensor, torch.Tensor], *,
                      n_heads: int, head_dim: int,
                      compute_dtype=torch.bfloat16) -> torch.Tensor:
    """:func:`cross_attn_apply` for one decoder token x (B, 1, d): one
    decode-kernel call over all T slots of the cross cache (B, T, H, hd)."""
    b = x.shape[0]
    q = _split_heads(linear(p["wq"], x, compute_dtype), n_heads, head_dim)
    k, v = kv
    n_valid = torch.full((b,), k.shape[1], dtype=torch.int32, device=k.device)
    out = decode_attention(q, k.contiguous(), v.contiguous(), n_valid)
    return linear(p["wo"], out.reshape(b, 1, n_heads * head_dim), compute_dtype)
