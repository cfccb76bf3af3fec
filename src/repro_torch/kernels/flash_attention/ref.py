"""Plain PyTorch twin of the flash-attention kernel (counterpart of
``repro.kernels.flash_attention.ref``), in the kernel's contract.

The CPU tests run it, and ``chip_smoke.py`` holds the CUDA kernel against
it on the card. It takes the model layout the kernel takes -- q (B, Sq,
H, hd), k and v (B, Sk, K, hd) with K dividing H, not repeated -- where
the reference's oracle takes the folded (B·H, S, hd) layout; the
function is the same.

The twin keeps the probabilities in fp32, as the Pallas kernel does. The
bf16 tensor-core kernel (``csrc/flash_attention_tc.cu``) rounds P to bf16
for the P·V product and sums l from the same rounded P, which moves an
output by at most 2^-9 max|v|, inside the bf16 tolerance.
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Self-attention with q and k positions both counted from 0: key j
    is live for query i when ``j <= i`` (``causal``) and ``j > i -
    window`` (``window`` > 0); q-head h reads kv-head h // (H / K).
    Softmax in fp32 with scale hd**-0.5, probabilities kept in fp32, the
    output cast to q's dtype; a row with no live key gives zeros.

    q (B, Sq, H, hd); k, v (B, Sk, K, hd). Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    sk, n_kv = k.shape[1], k.shape[2]
    group = h // n_kv
    qf = q.float().reshape(b, sq, n_kv, group, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qf, k.float()) * hd ** -0.5
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    live = torch.ones(sq, sk, dtype=torch.bool, device=q.device)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= kpos > qpos - window
    s = s.masked_fill(~live, float("-inf"))
    p = torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)  # rows with no live key
    out = torch.einsum("bkgst,btkd->bskgd", p, v.float())
    return out.reshape(b, sq, h, hd).to(q.dtype)
