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

:func:`attention_backward` is the gradient of the same function in closed
form, in plain PyTorch: the backward that ``ops.flash_attention`` runs on
every device (the reference's Pallas kernel has no VJP, so no hand
backward kernel replaces one). Both compute in fp32, or in fp64 for fp64
inputs (which only the gradient checks pass).
"""

from __future__ import annotations

import torch

__all__ = ["attention_ref", "attention_backward"]


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Self-attention with q and k positions both counted from 0: key j
    is live for query i when ``j <= i`` (``causal``) and ``j > i -
    window`` (``window`` > 0); q-head h reads kv-head h // (H / K).
    Softmax in fp32 with scale hd**-0.5, probabilities kept in fp32, the
    output cast to q's dtype; a row with no live key gives zeros.

    q (B, Sq, H, hd); k, v (B, Sk, K, hd). Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    ct = torch.promote_types(q.dtype, torch.float32)
    p = _probs(_grouped(q, k.shape[2], ct), k.to(ct), causal, window)
    out = torch.einsum("bkgst,btkd->bskgd", p, v.to(ct))
    return out.reshape(b, sq, h, hd).to(q.dtype)


def _grouped(x: torch.Tensor, n_kv: int, ct) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, K, H/K, hd) in ``ct``: q-head h as (h // G, h % G)."""
    b, s, h, hd = x.shape
    return x.to(ct).reshape(b, s, n_kv, h // n_kv, hd)


def _probs(qg: torch.Tensor, k: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    """The probabilities (B, K, G, Sq, Sk) of grouped q against k, zero
    where a key is not live and on rows with no live key."""
    sq, sk, hd = qg.shape[1], k.shape[1], qg.shape[-1]
    s = torch.einsum("bskgd,btkd->bkgst", qg, k) * hd ** -0.5
    qpos = torch.arange(sq, device=qg.device)[:, None]
    kpos = torch.arange(sk, device=qg.device)[None, :]
    live = torch.ones(sq, sk, dtype=torch.bool, device=qg.device)
    if causal:
        live &= kpos <= qpos
    if window:
        live &= kpos > qpos - window
    s = s.masked_fill(~live, float("-inf"))
    return torch.nan_to_num(torch.softmax(s, dim=-1), nan=0.0)  # rows with no live key


def attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       out: torch.Tensor, d_out: torch.Tensor, *, causal: bool = True,
                       window: int = 0):
    """(dq, dk, dv) of :func:`attention_ref` given its output ``out`` and
    the output's gradient ``d_out`` (both (B, Sq, H, hd)), each in its
    input's dtype. P is recomputed from q and k (nothing of it is saved):

        dV = P^T dO,  dP = dO V^T,  dS = P * (dP - rowsum(dO * O)),
        dQ = dS K / sqrt(hd),  dK = dS^T Q / sqrt(hd),

    with dK and dV of a kv head summed over the q heads that read it."""
    b, sq, h, hd = q.shape
    n_kv = k.shape[2]
    ct = torch.promote_types(q.dtype, torch.float32)
    qg, kf, vf = _grouped(q, n_kv, ct), k.to(ct), v.to(ct)
    do, og = _grouped(d_out, n_kv, ct), _grouped(out, n_kv, ct)
    p = _probs(qg, kf, causal, window)
    dv = torch.einsum("bkgst,bskgd->btkd", p, do)
    dp = torch.einsum("bskgd,btkd->bkgst", do, vf)
    delta = (do * og).sum(-1).permute(0, 2, 3, 1)[..., None]  # (B, K, G, Sq, 1)
    ds = p * (dp - delta) * hd ** -0.5
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).reshape(b, sq, h, hd)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
