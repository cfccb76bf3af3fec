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

On a model group (``tp``, ``models.tensor_parallel``) rank s of S holds
the heads ``[s H/S, (s+1) H/S)``: the token shift and the five lerps stay
replicated, the four lerped inputs of ``wr`` / ``wk`` / ``wv`` / ``wg``
pass ``copy_to_model`` (one stacked tensor, one all-reduce backward)
after the lerp, so the gradient of each ``mu_*`` is whole, before their
column-parallel products; the decay is computed whole from the
replicated LoRA and then cut to the rank's channels, and ``u`` and
``ln_scale`` to its heads, by ``scatter_to_model`` (each gradient
all-gathered backward, the same on every rank); the WKV-6 kernel runs on
(B, S, H/S, 64) and ``wo`` is row-parallel. The channel mix is the
MLP's split: ``wk`` column-parallel, the channel ``wv`` row-parallel.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.ops import HEAD_SIZE, wkv6
from repro_torch.models.layers import dense_init, linear, normal_init, row_parallel_linear
from repro_torch.models.tensor_parallel import TPGroup, copy_to_model, scatter_to_model

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
                  compute_dtype=torch.bfloat16, tp: Optional[TPGroup] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(out, new_prev_x, new_state). x (B, S, d); prev_x (B, d); s0 (B, H,
    64, 64) fp32 -- on a model group (``tp``) the rank's H/S heads, and
    the returned state too."""
    b, s, _ = x.shape
    cd = compute_dtype
    xs = _token_shift(x, prev_x)
    lerps = [_lerp(x, xs, p[f"mu_{c}"]) for c in "rkvg"]
    if tp is not None:
        lerps = copy_to_model(torch.stack(lerps), tp).unbind(0)
    r, k, v, g = (linear(p[f"w{c}"], a, cd) for c, a in zip("rkvg", lerps))
    xw = _lerp(x, xs, p["mu_w"])
    dd = linear({"w": p["wb"]["w"]}, torch.tanh(linear(p["wa"], xw, cd)), cd)
    log_w = -torch.exp(torch.clamp(p["w0"].float() + dd.float(), -20.0, 10.0))  # <= 0

    d = r.shape[-1]
    shape4 = (b, s, d // HEAD_SIZE, HEAD_SIZE)
    rf, kf, vf = (a.float().reshape(shape4) for a in (r, k, v))
    y, s_fin = wkv6(rf, kf, vf, scatter_to_model(log_w, tp).reshape(shape4),
                    scatter_to_model(p["u"].float(), tp, 0), s0)
    y = _group_norm(y, scatter_to_model(p["ln_scale"], tp, 0)).reshape(b, s, d)
    out = row_parallel_linear(p["wo"], y.to(cd) * F.silu(g), cd, tp)
    return out, x[:, -1], s_fin


def rwkv_channel_mix(p: Dict, x: torch.Tensor, prev_x: torch.Tensor,
                     compute_dtype=torch.bfloat16,
                     tp: Optional[TPGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, new_prev_x): the squared-ReLU channel mix on the shifted
    token (on a model group ``wk`` column- and ``wv`` row-parallel)."""
    xs = _token_shift(x, prev_x)
    kx = copy_to_model(_lerp(x, xs, p["mu_k"]), tp)
    hdn = torch.square(F.relu(linear(p["wk"], kx, compute_dtype)))
    return row_parallel_linear(p["wv"], hdn, compute_dtype, tp), x[:, -1]


def rwkv_decode_states(batch: int, d_model: int, device=None, model_shards: int = 1) -> Dict:
    """Zero fp32 states, as the reference's: the two token-shift carries
    (B, d) and the WKV state (B, H, 64, 64) -- of one rank's H /
    ``model_shards`` heads on a model group."""
    h = d_model // HEAD_SIZE // model_shards
    return {
        "tm_prev": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
        "cm_prev": torch.zeros((batch, d_model), dtype=torch.float32, device=device),
        "s": torch.zeros((batch, h, HEAD_SIZE, HEAD_SIZE), dtype=torch.float32,
                       device=device),
    }
