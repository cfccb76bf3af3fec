"""Carry weights from the reference into the port.

The reference's parameters are pytrees of JAX arrays; hand them over as
nested dicts of numpy arrays (``jax.tree_util.tree_map(np.asarray,
params)``) and they come out as the port's tensors, leaf for leaf and
bit for bit. The port's own initializers draw from ``torch.Generator``s,
whose numbers differ from ``jax.random``'s, so this is how a comparison
starts both packages from the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.core.fl import tree_map
from repro_torch.core.packing import FlatLayout
from repro_torch.device import resolve_device

__all__ = ["params_from_numpy", "flat_from_numpy"]


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (``cuda`` unless given), dtypes unchanged."""
    dev = resolve_device(device)
    return tree_map(lambda a: torch.tensor(np.asarray(a), device=dev), tree)


def flat_from_numpy(flat: np.ndarray, layout: FlatLayout, device=None) -> torch.Tensor:
    """A packed ``(n_nodes, total)`` fp32 buffer (the reference's
    ``packing.pack`` output) -> the port's flat tensor for ``layout``."""
    arr = np.asarray(flat)
    if arr.shape != (layout.n_nodes, layout.total) or arr.dtype != np.float32:
        raise ValueError(
            f"flat buffer {arr.shape} {arr.dtype} does not match layout "
            f"({layout.n_nodes}, {layout.total}) float32"
        )
    return torch.tensor(arr, device=resolve_device(device))
