"""Communication accounting and run metrics (counterpart of
``repro.training.metrics``).

The paper's headline metric is *communication rounds*; deployments also
pay for *bytes on the wire*. Both are derived here from the parameter
tree and the topology.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.core.mixing import as_dtype
from repro_torch.core.packing import tree_leaves
from repro_torch.core.topology import mixing_matrix

Tree = Any

__all__ = ["param_bytes", "comm_bytes_per_gossip", "allreduce_bytes", "MetricHistory"]


def param_bytes(params: Tree, wire_dtype=None) -> int:
    """Bytes of ONE node's parameters as sent on the wire."""
    total = 0
    for _, leaf in tree_leaves(params):
        dtype = leaf.dtype if wire_dtype is None else as_dtype(wire_dtype)
        total += leaf.numel() * torch.empty((), dtype=dtype).element_size()
    return total


def comm_bytes_per_gossip(params: Tree, topology: str, n_nodes: int,
                          wire_dtype=None) -> int:
    """Per-NODE egress bytes for one gossip round.

    ring/torus: one parameter copy per outgoing direction.
    complete: N-1 copies. star: 1 (upload) + broadcast share. Any other
    graph: the mean degree of its mixing matrix.
    """
    p = param_bytes(params, wire_dtype)
    if topology.startswith("torus"):
        return 4 * p
    if topology == "ring":
        return 2 * p
    if topology == "complete":
        return (n_nodes - 1) * p
    if topology == "star":
        return 2 * p  # up to server + down
    w = mixing_matrix(topology, n_nodes)
    mean_deg = float((np.abs(w) > 1e-12).sum(1).mean() - 1.0)
    return int(mean_deg * p)


def allreduce_bytes(params: Tree, n_nodes: int, wire_dtype=None) -> int:
    """Per-node bytes of a ring all-reduce: 2 (N-1)/N x payload."""
    p = param_bytes(params, wire_dtype)
    return int(2 * (n_nodes - 1) / n_nodes * p)


class MetricHistory:
    """Append-only metric recorder with numpy export."""

    def __init__(self) -> None:
        self._rows: list[Dict[str, float]] = []

    def append(self, **kv: float) -> None:
        self._rows.append({k: float(v) for k, v in kv.items()})

    def __len__(self) -> int:
        return len(self._rows)

    def column(self, key: str) -> np.ndarray:
        return np.array([r[key] for r in self._rows if key in r])

    def last(self) -> Dict[str, float]:
        return dict(self._rows[-1]) if self._rows else {}

    def rows(self) -> list[Dict[str, float]]:
        return [dict(r) for r in self._rows]
