"""Plain PyTorch twin of the WKV-6 kernel (counterpart of
``repro.kernels.rwkv6_scan.ref``), in the kernel's folded layout.

The CPU path runs it (through ``ops.wkv6``), the CPU tests hold it to the
reference's naive oracle and its Pallas kernel, and ``chip_smoke.py``
holds the CUDA kernel against it on the card. It runs the step
recurrence, one time step at a time, as the reference's oracle does.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["wkv6_ref"]


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
             u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, log_w (BH, S, hd) fp32; u (BH, hd); s0 (BH, hd, hd), S >= 1.

        y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T

    Returns (y (BH, S, hd) in r's dtype, S_final (BH, hd, hd) fp32)."""
    s = s0.float()
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], log_w[:, t]
        kv = kt[:, :, None] * vt[:, None, :]
        ys.append(torch.einsum("bi,bij->bj", rt, s + u[:, :, None] * kv))
        s = torch.exp(lwt)[:, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s
