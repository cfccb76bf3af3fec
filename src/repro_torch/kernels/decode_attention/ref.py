"""Plain PyTorch twin of the decode-attention kernel (counterpart of
``repro.kernels.decode_attention.ref``), in the kernel's contract.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card. It takes the model layout the kernel takes -- q (B, 1,
H, hd) and the caches (B, C, K, hd) as they are stored -- where the
reference's oracle takes the folded (B·H, 1, hd) / (B·K, C, hd) layout;
the function is the same.
"""

from __future__ import annotations

import torch

__all__ = ["decode_attention_ref"]


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
