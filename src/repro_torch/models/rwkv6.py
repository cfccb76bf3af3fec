"""RWKV-6 "Finch" block (counterpart of ``repro.models.rwkv6``): token-
shift time mixing with a data-dependent decay, and the channel mix.

Per head (size 64) the WKV recurrence over the kv-state S in R^{64x64} is

    y_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t = diag(w_t) S_{t-1} + k_t v_t^T

with the per-channel decay w_t = exp(-exp(w0 + lora_w(x~_t))) in (0, 1].
:func:`rwkv_time_mix` hands the recurrence to the WKV-6 kernel's wrapper
(``kernels.rwkv6_scan.ops.wkv6``): the CUDA kernel on the card, its
plain step-recurrence twin on the CPU, for prefill and decode alike.
The reference's chunked jnp form (``wkv6_chunked``) and its ``chunk``
argument have no counterpart: the wrapper computes the same function at
any length.

dtypes follow the reference: the decode states start as fp32 zeros, so
the first step's (and prefill's) token shift promotes the bf16 residual
stream to fp32; the returned ``x[:, -1]`` is bf16, so from the second
step on the shift and the lerp run in bf16.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.ops import HEAD_SIZE, wkv6
from repro_torch.models.layers import dense_init, linear, normal_init

__all__ = ["HEAD_SIZE", "rwkv_block_init", "rwkv_time_mix", "rwkv_channel_mix",
           "rwkv_decode_states"]

_LORA = 64  # width of the decay LoRA


def rwkv_block_init(generator, d_model: int, d_ff: int, dtype=torch.float32,
                    device=None, lead: Sequence[int] = ()) -> Dict:
    """The reference's tree, field for field: lerp coefficients 0.5, the
    r/k/v/g/o projections, the decay base ``w0`` ~ N(-6, 0.3^2) and its
    LoRA, the bonus ``u`` ~ N(0, 0.3^2) (both fp32 whatever ``dtype``),
    the per-head norm scale, and the channel mix. ``lead`` prepends
    stacking axes, as in :func:`repro_torch.models.layers.dense_init`."""
    if d_model % HEAD_SIZE:
        raise ValueError(f"d_model={d_model} not a multiple of head size {HEAD_SIZE}")
    n_heads = d_model // HEAD_SIZE

    def full(n, value=0.5):
        return torch.full((*lead, n), value, dtype=dtype, device=device)

    def dense(d_in, d_out):
        return dense_init(generator, d_in, d_out, device, dtype=dtype, lead=lead)

    return {
        "time": {
            "mu_r": full(d_model), "mu_k": full(d_model), "mu_v": full(d_model),
            "mu_g": full(d_model), "mu_w": full(d_model),
            "wr": dense(d_model, d_model),
            "wk": dense(d_model, d_model),
            "wv": dense(d_model, d_model),
            "wg": dense(d_model, d_model),
            "wo": dense(d_model, d_model),
            "w0": normal_init(generator, (*lead, d_model), 0.3, torch.float32, device) - 6.0,
            "wa": dense(d_model, _LORA),
            "wb": dense(_LORA, d_model),
            "u": normal_init(generator, (*lead, n_heads, HEAD_SIZE), 0.3, torch.float32,
                             device),
            "ln_scale": torch.ones((*lead, n_heads, HEAD_SIZE), dtype=dtype, device=device),
        },
        "channel": {
            "mu_k": full(d_model),
            "wk": dense(d_model, d_ff),
            "wv": dense(d_ff, d_model),
        },
    }


def _token_shift(x: torch.Tensor, prev: torch.Tensor) -> torch.Tensor:
    """x_{t-1}, with ``prev`` (B, d) the last token of the previous
    segment; promotes to the wider of the two dtypes, as the reference's
    concatenate does."""
    dt = torch.promote_types(prev.dtype, x.dtype)
    return torch.cat([prev[:, None].to(dt), x[:, :-1].to(dt)], dim=1)


def _lerp(x: torch.Tensor, xs: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (xs - x) * mu.to(x.dtype)


def _group_norm(y: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Per-head RMS normalization of (B, S, H, hd), in fp32."""
    yf = y.float()
    var = torch.mean(yf * yf, dim=-1, keepdim=True)
    return (yf * torch.rsqrt(var + eps) * scale.float()).to(y.dtype)


def rwkv_time_mix(p: Dict, x: torch.Tensor, prev_x: torch.Tensor, s0: torch.Tensor,
                  compute_dtype=torch.bfloat16
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, new_prev_x, new_state). x (B, S, d); prev_x (B, d); s0 (B, H,
    64, 64) fp32."""
    b, s, d = x.shape
    h = d // HEAD_SIZE
    cd = compute_dtype
    xs = _token_shift(x, prev_x)
    r = linear(p["wr"], _lerp(x, xs, p["mu_r"]), cd)
    k = linear(p["wk"], _lerp(x, xs, p["mu_k"]), cd)
    v = linear(p["wv"], _lerp(x, xs, p["mu_v"]), cd)
    g = linear(p["wg"], _lerp(x, xs, p["mu_g"]), cd)
    xw = _lerp(x, xs, p["mu_w"])
    dd = linear({"w": p["wb"]["w"]}, torch.tanh(linear(p["wa"], xw, cd)), cd)
    log_w = -torch.exp(torch.clamp(p["w0"].float() + dd.float(), -20.0, 10.0))  # <= 0

    shape4 = (b, s, h, HEAD_SIZE)
    rf, kf, vf = (a.float().reshape(shape4) for a in (r, k, v))
    y, s_fin = wkv6(rf, kf, vf, log_w.reshape(shape4), p["u"].float(), s0)
    y = _group_norm(y, p["ln_scale"]).reshape(b, s, d)
    out = linear(p["wo"], y.to(cd) * F.silu(g), cd)
    return out, x[:, -1], s_fin


def rwkv_channel_mix(p: Dict, x: torch.Tensor, prev_x: torch.Tensor,
                     compute_dtype=torch.bfloat16) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, new_prev_x): the squared-ReLU channel mix on the shifted
    token."""
    xs = _token_shift(x, prev_x)
    kx = _lerp(x, xs, p["mu_k"])
    hdn = torch.square(F.relu(linear(p["wk"], kx, compute_dtype)))
    return linear(p["wv"], hdn, compute_dtype), x[:, -1]


def rwkv_decode_states(batch: int, d_model: int, device=None) -> Dict:
    """Zero fp32 states, as the reference's: the two token-shift carries
    (B, d) and the WKV state (B, H, 64, 64)."""
    h = d_model // HEAD_SIZE
    return {
        "tm_prev": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
        "cm_prev": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
        "s": torch.zeros((batch, h, HEAD_SIZE, HEAD_SIZE), dtype=torch.float32,
                       device=device),
    }
