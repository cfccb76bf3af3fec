"""Primitive layers the EHR MLP needs (counterpart of the dense part of
``repro.models.layers``). Parameters are nested dicts of tensors, like
the reference's pytrees, so packing and conversion see the same leaves.
"""

from __future__ import annotations

from typing import Dict

import torch

__all__ = ["dense_init", "linear"]


def dense_init(generator: torch.Generator, d_in: int, d_out: int,
               device, bias: bool = False) -> Dict[str, torch.Tensor]:
    """Fan-in scaled normal init (std 1/sqrt(d_in)), fp32. The draws come
    from ``generator`` and so differ from ``jax.random``'s for the same
    seed; tests feed the reference's init through ``repro_torch.convert``.
    """
    w = torch.randn(d_in, d_out, generator=generator, dtype=torch.float32)
    p = {"w": (w * d_in ** -0.5).to(device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=torch.float32, device=device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """``x @ w + b`` in fp32. Works for one node (``w`` (d_in, d_out),
    ``x`` (m, d_in)) and for a node stack (``w`` (n, d_in, d_out), ``x``
    (n, m, d_in)): the bias broadcasts over the sample axis either way."""
    y = torch.matmul(x, p["w"])
    if "b" in p:
        y = y + p["b"].unsqueeze(-2)
    return y
