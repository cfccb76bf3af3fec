"""Plain PyTorch twin of the WKV-6 kernel (counterpart of
``repro.kernels.rwkv6_scan.ref``), in the kernel's folded layout.

The CPU path runs it (through ``ops.wkv6``), the CPU tests hold it to the
reference's naive oracle and its Pallas kernel, and ``chip_smoke.py``
holds the CUDA kernel against it on the card. It runs the step
recurrence, one time step at a time, as the reference's oracle does.

:func:`wkv6_backward` is the function's gradient in closed form, in
plain PyTorch: the backward ``ops.wkv6`` runs on every device (the
reference's Pallas kernel defines no VJP). Both compute in fp32, or in
fp64 for fp64 inputs (which only the gradient checks pass).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["wkv6_ref", "wkv6_backward"]


def wkv6_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, log_w: torch.Tensor,
             u: torch.Tensor, s0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, log_w (BH, S, hd) fp32; u (BH, hd); s0 (BH, hd, hd), S >= 1.

        y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
        S_t = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T

    Returns (y (BH, S, hd) in r's dtype, S_final (BH, hd, hd) fp32)."""
    s = s0.to(torch.promote_types(s0.dtype, torch.float32))
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, lwt = r[:, t], k[:, t], v[:, t], log_w[:, t]
        kv = kt[:, :, None] * vt[:, None, :]
        ys.append(torch.einsum("bi,bij->bj", rt, s + u[:, :, None] * kv))
        s = torch.exp(lwt)[:, :, None] * s + kv
    return torch.stack(ys, dim=1).to(r.dtype), s


def wkv6_backward(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  log_w: torch.Tensor, u: torch.Tensor, s0: torch.Tensor,
                  dy: torch.Tensor, ds: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(dr, dk, dv, dlog_w, du, ds0) of :func:`wkv6_ref` (same layout),
    given the gradients of y (BH, S, hd) and of S_final (BH, hd, hd).

    The states S_0 .. S_{S-1} are recomputed forward, then with G the
    gradient of the state after step t, walking t down:

        dr_t = S_{t-1} dy_t + u * k_t (dy_t . v_t)
        dk_t = r_t * u (dy_t . v_t) + G v_t
        dv_t = dy_t (r_t . u * k_t) + G^T k_t
        dlog_w_t = w_t * rowsum(G * S_{t-1})
        du += r_t * k_t (dy_t . v_t)
        G <- diag(w_t) G + r_t dy_t^T     (then G is dL/dS_{t-1})

    and ds0 is the last G."""
    ct = torch.promote_types(r.dtype, torch.float32)
    r, k, v, log_w, u, dy = (a.to(ct) for a in (r, k, v, log_w, u, dy))
    w = torch.exp(log_w)
    states = [s0.to(ct)]
    for t in range(r.shape[1] - 1):
        states.append(w[:, t, :, None] * states[-1] + k[:, t, :, None] * v[:, t, None, :])
    g = ds.to(ct)
    dr, dk, dv, dlw = (torch.empty_like(r) for _ in range(4))
    du = torch.zeros_like(u)
    for t in reversed(range(r.shape[1])):
        sp, rt, kt, vt, dyt = states[t], r[:, t], k[:, t], v[:, t], dy[:, t]
        dyv = (dyt * vt).sum(-1, keepdim=True)
        dr[:, t] = torch.einsum("bij,bj->bi", sp, dyt) + u * kt * dyv
        dk[:, t] = rt * u * dyv + torch.einsum("bij,bj->bi", g, vt)
        dv[:, t] = dyt * (rt * u * kt).sum(-1, keepdim=True) + torch.einsum("bij,bi->bj", g, kt)
        dlw[:, t] = w[:, t] * (g * sp).sum(-1)
        du = du + rt * kt * dyv
        g = w[:, t, :, None] * g + rt[:, :, None] * dyt[:, None, :]
    return dr, dk, dv, dlw, du, g
