"""RG-LRU recurrent block (counterpart of ``repro.models.rglru``;
RecurrentGemma / Griffin):

    x -> in_proj -> branch1 -> conv1d(width 4) -> RG-LRU -> * gelu(branch2) -> out_proj

with, per channel,

    r_t = sigmoid(x_t W_a + b_a)          recurrence gate
    i_t = sigmoid(x_t W_x + b_x)          input gate
    log a_t = -c * softplus(lambda) * r_t (c = 8)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

:func:`rglru_block_apply` hands the recurrence to the RG-LRU scan
kernel's wrapper (``kernels.rglru_scan.ops.rglru_scan``): the CUDA kernel
on the card, its plain step twin on the CPU, in prefill and decode alike;
the reference's associative-scan form (``rglru_scan_assoc``) has no
counterpart. Numerics follow the reference: the conv sums its taps one
by one in x's dtype (:func:`_causal_conv1d`), ``softplus`` is
``logaddexp(x, 0)`` (``jax.nn.softplus``), and ``gelu`` is the tanh
approximation (``jax.nn.gelu``'s default).
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.models.layers import dense_init, linear, normal_init

__all__ = ["RGLRU_C", "rglru_block_init", "rglru_block_apply", "rglru_decode_state"]

RGLRU_C = 8.0


def rglru_block_init(generator, d_model: int, width: int, conv_width: int,
                     dtype=torch.float32, device=None, lead: Sequence[int] = ()) -> Dict:
    """The reference's tree, field for field: biased in/out projections and
    gates, the depthwise conv (taps ~ N(0, 1/conv_width), zero bias), and
    ``lam`` ~ U[2, 6) in fp32 (so a^c = sigmoid(lam)^c spreads in (0.9,
    0.999)). ``lead`` prepends stacking axes."""
    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, device, bias=True, dtype=dtype, lead=lead)

    dev = torch.device(device) if device is not None else generator.device
    if dev.type == "meta":
        lam = torch.empty((*lead, width), dtype=torch.float32, device=dev)
    else:
        lam = torch.rand((*lead, width), generator=generator, dtype=torch.float32,
                         device=generator.device).mul_(4.0).add_(2.0).to(dev)
    return {
        "in_proj": dense(d_model, 2 * width),
        "conv_w": normal_init(generator, (*lead, conv_width, width), conv_width ** -0.5,
                              dtype, device),
        "conv_b": torch.zeros((*lead, width), dtype=dtype, device=device),
        "gate_a": dense(width, width),
        "gate_x": dense(width, width),
        "lam": lam,
        "out_proj": dense(width, d_model),
    }


def _causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                   state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv. x (B, S, W); w (K, W); state (B, K-1, W)
    holds the trailing inputs of the previous segment. As the reference:
    the state is cast to x's dtype before the concatenation, the K taps
    are summed one by one in x's dtype, and the new state is cast back
    to the state's dtype."""
    k, s = w.shape[0], x.shape[1]
    xp = torch.cat([state.to(x.dtype), x], dim=1)  # (B, S+K-1, W)
    out = xp[:, 0:s] * w[0].to(x.dtype)
    for i in range(1, k):
        out = out + xp[:, i:i + s] * w[i].to(x.dtype)
    out = out + b.to(x.dtype)
    return out, xp[:, -(k - 1):].to(state.dtype)


def rglru_block_apply(p: Dict, x: torch.Tensor, state: Dict,
                      compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, Dict]:
    """x (B, S, d) -> (out (B, S, d), new state {h, conv})."""
    cd = compute_dtype
    xw = linear(p["in_proj"], x, cd)
    u, gate_branch = torch.chunk(xw, 2, dim=-1)
    u, conv_state = _causal_conv1d(u, p["conv_w"], p["conv_b"], state["conv"])

    uf = u.float()
    r = torch.sigmoid(linear(p["gate_a"], u, cd).float())
    i = torch.sigmoid(linear(p["gate_x"], u, cd).float())
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    log_a = -RGLRU_C * softplus[None, None] * r  # (B, S, W) <= 0
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    bx = beta * (i * uf)

    h, h_last = rglru_scan(log_a.contiguous(), bx.contiguous(), state["h"])
    y = h.to(cd) * F.gelu(gate_branch, approximate="tanh")
    out = linear(p["out_proj"], y, cd)
    return out, {"h": h_last, "conv": conv_state}


def rglru_decode_state(batch: int, width: int, conv_width: int, device=None) -> Dict:
    """Zero fp32 states: the recurrence ``h`` (B, W) and the conv's
    trailing inputs (B, conv_width - 1, W)."""
    return {
        "h": torch.zeros((batch, width), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, conv_width - 1, width), dtype=torch.float32,
                            device=device),
    }
