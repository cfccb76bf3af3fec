"""Plain PyTorch twin of the RG-LRU scan kernel (counterpart of
``repro.kernels.rglru_scan.ref``), in the kernel's layout.

The CPU path runs it (through ``ops.rglru_scan``), the CPU tests hold it
to the reference's naive oracle and its Pallas kernel, and
``chip_smoke.py`` holds the CUDA kernel against it on the card. It runs
the recurrence one time step at a time, as the reference's oracle does.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rglru_ref"]


def rglru_ref(log_a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = exp(log_a_t) h_{t-1} + b_t`` per channel. log_a, b (B, S, W)
    fp32; h0 (B, W); S >= 1. Returns (h (B, S, W) in log_a's dtype,
    h_last (B, W) fp32)."""
    h = h0.float()
    hs = []
    for t in range(log_a.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(log_a.dtype), h
