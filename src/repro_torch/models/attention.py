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
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models.layers import apply_rope, dense_init, linear

__all__ = [
    "layout_heads",
    "attn_init",
    "attn_apply",
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


def attn_apply(p: Dict, x: torch.Tensor, positions: torch.Tensor, *, n_heads: int,
               n_kv_heads: int, head_dim: int, rope_theta: Optional[float],
               causal: bool = True, window: int = 0, compute_dtype=torch.bfloat16,
               n_heads_layout: Optional[int] = None) -> torch.Tensor:
    """Self-attention over a full sequence (prefill): x (B, S, d),
    positions (B, S). The attention itself is one flash-kernel call on
    the logical heads with un-repeated K/V; padded layout heads are zero."""
    hl = n_heads_layout or n_heads
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
                        compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V, (B, T, H, hd) each, in ``compute_dtype``."""
    k = _split_heads(linear(p["wk"], enc_out, compute_dtype), n_heads, head_dim)
    v = _split_heads(linear(p["wv"], enc_out, compute_dtype), n_heads, head_dim)
    return k, v


def cross_attn_apply(p: Dict, x: torch.Tensor, kv: Tuple[torch.Tensor, torch.Tensor], *,
                     n_heads: int, head_dim: int,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Decoder queries x (B, S, d) attend, unmasked, over precomputed
    encoder K/V (B, T, H, hd): one non-causal flash-kernel call."""
    q = _split_heads(linear(p["wq"], x, compute_dtype), n_heads, head_dim)
    k, v = kv
    out = flash_attention(q, k.contiguous(), v.contiguous(), causal=False, window=0)
    return linear(p["wo"], out.reshape(*x.shape[:-1], n_heads * head_dim), compute_dtype)


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
