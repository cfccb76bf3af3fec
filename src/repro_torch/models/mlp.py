"""The paper's own model: a 2-layer tanh MLP over the 42 EHR features,
classifying AD vs MCI (counterpart of ``repro.models.mlp``).

Every function here takes either one node's parameters (``w`` (d_in,
d_out), ``b`` (d_out,)) with a batch ``x`` (m, 42), or a node stack
(leaves with a leading ``n`` axis) with ``x`` (n, m, 42). The reference
vmaps its per-node functions over the node axis; here the batch axis is
written out. Nodes never interact in the forward pass, so autograd of
the summed per-node losses gives each node its own gradient.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.layers import dense_init, linear

__all__ = [
    "mlp_init",
    "mlp_logits",
    "make_mlp_loss",
    "mlp_accuracy",
    "mlp_balanced_accuracy",
]


def mlp_init(seed: int = 0, d_in: int = 42, d_hidden: int = 32,
             n_classes: int = 2, device=None) -> Dict:
    """One node's random init from a ``torch.Generator`` seeded with
    ``seed`` (numbers differ from the reference's ``jax.random`` init)."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    return {
        "fc1": dense_init(gen, d_in, d_hidden, dev, bias=True),
        "fc2": dense_init(gen, d_hidden, n_classes, dev, bias=True),
    }


def mlp_logits(params: Dict, x: torch.Tensor) -> torch.Tensor:
    h = torch.tanh(linear(params["fc1"], x))
    return linear(params["fc2"], h)


def make_mlp_loss(class_weight=None):
    """Build the loss ``(params, batch) -> loss``, optionally
    class-weighted: ``sum_i w_{y_i} ce_i / sum_i w_{y_i}`` over the
    sample axis (the plain mean when ``class_weight`` is None). For a
    node stack it returns the (n,) per-node losses.

    ``class_weight``: a length-2 array (``configs.ehr_mlp.class_weights``)
    or None.
    """
    weights = None if class_weight is None else torch.as_tensor(
        np.asarray(class_weight), dtype=torch.float32
    )
    on_device = {}  # the weights copied once per device, not per call

    def loss(params: Dict, batch: Dict) -> torch.Tensor:
        """batch: {"x": (..., m, 42) fp32, "y": (..., m) int} -> loss."""
        logits = mlp_logits(params, batch["x"])
        y = batch["y"].long()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, y.unsqueeze(-1)).squeeze(-1)
        ce = logz - gold
        if weights is None:
            return ce.mean(dim=-1)
        if ce.device not in on_device:
            on_device[ce.device] = weights.to(ce.device)
        w = on_device[ce.device][y]
        return (w * ce).sum(dim=-1) / torch.clamp_min(w.sum(dim=-1), 1e-6)

    return loss


def mlp_accuracy(params: Dict, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    pred = torch.argmax(mlp_logits(params, x), dim=-1)
    return (pred == y).float().mean()


def mlp_balanced_accuracy(params: Dict, x: torch.Tensor,
                          y: torch.Tensor) -> torch.Tensor:
    """Mean per-class recall (chance = 0.5 for the 2-class cohort)."""
    pred = torch.argmax(mlp_logits(params, x), dim=-1)
    accs = []
    for k in (0, 1):
        mask = (y == k).float()
        hit = ((pred == k).float() * mask).sum()
        accs.append(hit / torch.clamp_min(mask.sum(), 1.0))
    return (accs[0] + accs[1]) / 2.0
