"""Primitive layers (counterpart of the dense part of
``repro.models.layers``): inits, ``linear``, RMSNorm, SwiGLU, RoPE and
the embedding lookups. Parameters are nested dicts of tensors, like the
reference's pytrees, so packing and conversion see the same leaves.

Matmul operands are cast to ``compute_dtype`` (bf16 for the transformer)
while parameters stay in their storage dtype (fp32); norm statistics and
the rotation run in fp32 and cast back, as in the reference.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

__all__ = [
    "normal_init",
    "dense_init",
    "linear",
    "rmsnorm_init",
    "rmsnorm",
    "swiglu_init",
    "swiglu",
    "rope_freqs",
    "apply_rope",
    "embed_init",
    "embed_lookup",
    "unembed_logits",
]


def normal_init(generator: Optional[torch.Generator], shape: Sequence[int],
                scale: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 on the generator's device, then
    moved to ``device`` (default: the generator's) and cast to ``dtype``.
    On the ``meta`` device nothing is drawn (shapes only). The draws
    differ from ``jax.random``'s for the same seed; tests feed the
    reference's init through ``repro_torch.convert``."""
    dev = torch.device(device) if device is not None else generator.device
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=dev)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(device=dev, dtype=dtype)


def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               device, bias: bool = False, dtype=torch.float32,
               lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Fan-in scaled normal init (std 1/sqrt(d_in)), the llama convention.
    ``lead`` prepends stacking axes (``(n_layers,)`` for a layer-stacked
    block, as the reference's ``vmap`` over layer keys)."""
    p = {"w": normal_init(generator, (*lead, d_in, d_out), d_in ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
           compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ w + b`` with both operands cast to ``compute_dtype`` first.
    The default fp32 is the EHR MLP's (no cast: bit for bit its old
    path); the transformer passes its config's compute dtype. Works for
    one weight (``w`` (d_in, d_out), ``x`` (..., d_in)) and for a node
    stack (``w`` (n, d_in, d_out), ``x`` (n, m, d_in)): the bias
    broadcasts over the sample axis either way."""
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype).unsqueeze(-2)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None,
                 lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def swiglu_init(generator, d: int, d_ff: int, dtype=torch.float32, device=None,
                lead: Sequence[int] = ()) -> Dict:
    return {
        "gate": dense_init(generator, d, d_ff, device, dtype=dtype, lead=lead),
        "up": dense_init(generator, d, d_ff, device, dtype=dtype, lead=lead),
        "down": dense_init(generator, d_ff, d, device, dtype=dtype, lead=lead),
    }


def swiglu(p: Dict, x: torch.Tensor, compute_dtype=torch.bfloat16) -> torch.Tensor:
    g = linear(p["gate"], x, compute_dtype)
    u = linear(p["up"], x, compute_dtype)
    return linear(p["down"], F.silu(g) * u, compute_dtype)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (..., seq, heads, head_dim) by per-position angles, in fp32,
    cast back to x's dtype. ``positions``: (..., seq) integer absolute
    positions (decode passes the absolute write position)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    ang = positions.float()[..., None] * inv  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_init(generator, vocab: int, d: int, dtype=torch.float32, device=None,
               scale: float = 0.02) -> Dict[str, torch.Tensor]:
    return {"table": normal_init(generator, (vocab, d), scale, dtype, device)}


def embed_lookup(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``, in ``compute_dtype``. The
    reference casts the whole table and then gathers; gathering first
    gives the same values and casts only the rows it needs."""
    return p["table"][tokens].to(compute_dtype)


def unembed_logits(table: torch.Tensor, h: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """h (..., d) @ table^T (v, d) -> (..., v)."""
    return torch.matmul(h.to(compute_dtype), table.to(compute_dtype).T)
