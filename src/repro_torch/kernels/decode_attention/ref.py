"""Plain PyTorch twin of the decode-attention kernel (counterpart of
``repro.kernels.decode_attention.ref``), in the kernel's contract.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card. It takes the model layout the kernel takes -- q (B, 1,
H, hd) and the caches (B, C, K, hd) as they are stored -- where the
reference's oracle takes the folded (B·H, 1, hd) / (B·K, C, hd) layout;
the function is the same.

``decode_attention_split_ref`` computes the same function the way the
kernel's split path does -- fp32 partials per span of the cache, then
``combine_partials_ref``, the combine kernel's twin -- for the tests; on
the card the whole call is held against the unsplit twin.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_ref", "decode_attention_split_ref", "combine_partials_ref"]


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """One query row per (batch, q-head) over the first ``n_valid[b]``
    cache slots of its batch row; q-head h reads kv-head h // (H / K).
    Softmax in fp32 with scale hd**-0.5, probabilities kept in fp32, the
    output cast to q's dtype; a row with ``n_valid = 0`` gives zeros.

    q (B, 1, H, hd); k_cache, v_cache (B, C, K, hd); n_valid (B,) int.
    Returns (B, 1, H, hd)."""
    b, _, h, hd = q.shape
    c, n_kv = k_cache.shape[1], k_cache.shape[2]
    group = h // n_kv
    qf = q.float().reshape(b, n_kv, group, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_cache.float()) * hd ** -0.5
    live = torch.arange(c, device=q.device)[None, :] < n_valid.to(q.device)[:, None]
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    p = torch.nan_to_num(p, nan=0.0)  # rows with no live slot
    out = torch.einsum("bkgc,bckd->bkgd", p, v_cache.float())
    return out.reshape(b, 1, h, hd).to(q.dtype)


def combine_partials_ref(acc: torch.Tensor, m: torch.Tensor, l: torch.Tensor,
                         dtype: torch.dtype) -> torch.Tensor:
    """Merge split partials: acc (S, B, H, hd), m and l (S, B, H), fp32, a
    split with no live slot having m = -inf and l = 0. Returns
    ``sum_s e^(m_s - m*) acc_s / sum_s e^(m_s - m*) l_s`` as (B, 1, H, hd)
    in ``dtype``, with m* = max_s m_s; zeros where every split is empty."""
    m_max = m.amax(dim=0)
    w = torch.where(torch.isinf(m), torch.zeros_like(m), torch.exp(m - m_max))
    num = (acc * w[..., None]).sum(dim=0)
    den = (l * w).sum(dim=0)
    out = torch.where(den[..., None] > 0, num / den.clamp_min(1e-30)[..., None],
                      torch.zeros_like(num))
    return out[:, None].to(dtype)


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, n_valid: torch.Tensor,
                               span: int) -> torch.Tensor:
    """``decode_attention_ref``'s function computed as the kernel's split
    path computes it: split s covers slots ``[s * span, (s + 1) * span)``
    of the live ``[0, n_valid[b])``; each gives fp32 ``m`` (its max score,
    -inf with no live slot), ``l = sum e^(s - m)`` and ``acc = sum e^(s -
    m) v``; :func:`combine_partials_ref` merges them."""
    b, _, h, hd = q.shape
    c, n_kv = k_cache.shape[1], k_cache.shape[2]
    group = h // n_kv
    qf = q.float().reshape(b, n_kv, group, hd)
    s = torch.einsum("bkgd,bckd->bkgc", qf, k_cache.float()) * hd ** -0.5
    pos = torch.arange(c, device=q.device)
    live = pos[None, :] < n_valid.to(q.device)[:, None]
    accs, ms, ls = [], [], []
    for lo in range(0, c, span):
        part = live & (pos >= lo)[None, :] & (pos < lo + span)[None, :]
        sp = s.masked_fill(~part[:, None, None, :], float("-inf"))
        m = sp.amax(dim=-1)
        p = torch.exp(sp - torch.where(torch.isinf(m), torch.zeros_like(m), m)[..., None])
        accs.append(torch.einsum("bkgc,bckd->bkgd", p, v_cache.float()).reshape(b, h, hd))
        ms.append(m.reshape(b, h))
        ls.append(p.sum(dim=-1).reshape(b, h))
    return combine_partials_ref(torch.stack(accs), torch.stack(ms), torch.stack(ls), q.dtype)
