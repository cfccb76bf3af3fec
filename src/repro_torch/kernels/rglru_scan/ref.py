"""Plain PyTorch twin of the RG-LRU scan kernel (counterpart of
``repro.kernels.rglru_scan.ref``), in the kernel's layout.

The CPU path runs it (through ``ops.rglru_scan``), the CPU tests hold it
to the reference's naive oracle and its Pallas kernel, and
``chip_smoke.py`` holds the CUDA kernel against it on the card. It runs
the recurrence one time step at a time, as the reference's oracle does.

:func:`rglru_backward` is the gradient in closed form, in plain PyTorch:
the backward ``ops.rglru_scan`` runs on every device (the reference's
Pallas kernel defines no VJP). Both compute in fp32, or in fp64 for fp64
inputs (which only the gradient checks pass).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["rglru_ref", "rglru_backward"]


def rglru_ref(log_a: torch.Tensor, b: torch.Tensor,
              h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``h_t = exp(log_a_t) h_{t-1} + b_t`` per channel. log_a, b (B, S, W)
    fp32; h0 (B, W); S >= 1. Returns (h (B, S, W) in log_a's dtype,
    h_last (B, W) fp32)."""
    h = h0.to(torch.promote_types(h0.dtype, torch.float32))
    hs = []
    for t in range(log_a.shape[1]):
        h = torch.exp(log_a[:, t]) * h + b[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1).to(log_a.dtype), h


def rglru_backward(log_a: torch.Tensor, h: torch.Tensor, h0: torch.Tensor,
                   dh: torch.Tensor, dh_last: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dlog_a, db, dh0) of :func:`rglru_ref` from its output ``h`` (B, S,
    W) and the gradients of h and of h_last. With g the gradient of h_t
    (its own and every later step's), walking t down:

        db_t = g,  dlog_a_t = g * a_t * h_{t-1},  g <- a_t * g + dh_{t-1}

    and dh0 is the last a_1 * g."""
    ct = torch.promote_types(log_a.dtype, torch.float32)
    a, h, dh = torch.exp(log_a.to(ct)), h.to(ct), dh.to(ct)
    g = dh_last.to(ct)
    dlog_a, db = torch.empty_like(a), torch.empty_like(a)
    for t in reversed(range(a.shape[1])):
        g = g + dh[:, t]
        db[:, t] = g
        dlog_a[:, t] = g * a[:, t] * (h[:, t - 1] if t else h0.to(ct))
        g = a[:, t] * g
    return dlog_a, db, g
