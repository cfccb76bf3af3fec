"""Exact-wire gossip: the dense-W mixing backend of the tree and flat
engines (counterpart of the single-device half of ``repro.core.mixing``).

The paper's algorithms interleave local steps with a *mixing* step

    theta_i <- sum_j W_ij theta_j

over the node graph. Here it is one ``W_off @ sent + w_self * x`` product
on the packed ``(nodes, total)`` buffer (``core.packing``), accumulated in
fp32, for any mixing matrix, on whatever device the buffer lives.

``wire_dtype`` (e.g. ``torch.bfloat16`` or ``"bfloat16"``) rounds what
crosses the wire -- the off-diagonal contributions -- to that dtype and
back (round to nearest even, as ``jnp.astype`` does); the self term stays
at full precision. ``None`` is the paper's fp32 wire.

The mesh backends (ppermute and all-gather gossip across devices) belong
to the multi-GPU engine (ROADMAP.md queue 1, item 15).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.fl import tree_map
from repro_torch.core.packing import pack, unpack

Tree = Any
GossipFn = Callable[[Tree], Tree]
FlatMixFn = Callable[[torch.Tensor], torch.Tensor]

__all__ = [
    "make_dense_gossip",
    "make_dense_flat_mix",
    "make_dense_gossip_per_leaf",
    "make_mean_consensus",
    "as_dtype",
]


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    d = getattr(torch, str(dtype), None)
    if not isinstance(d, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return d


def _wire(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    """Round a payload to the wire dtype (simulating the comm precision)."""
    if wire_dtype is None:
        return x
    return x.to(as_dtype(wire_dtype)).to(x.dtype)


def _split_w(w: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """(diag, off-diagonal) of W as fp32 tensors: split in float64, then
    each part rounded once to fp32."""
    w = np.asarray(w, dtype=np.float64)
    w_self = torch.tensor(np.diag(w), dtype=torch.float32)
    w_off = torch.tensor(w - np.diag(np.diag(w)), dtype=torch.float32)
    return w_self, w_off


def _weights_on(w: np.ndarray):
    """``on(device) -> (w_self, w_off)``, copied to each device once."""
    host = _split_w(w)
    cache: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def on(device: torch.device):
        if device not in cache:
            cache[device] = tuple(t.to(device) for t in host)
        return cache[device]

    return on


def make_dense_flat_mix(w: np.ndarray, wire_dtype=None) -> FlatMixFn:
    """Flat-native dense mixing: ONE ``W_off @ sent + w_self * x`` product
    on the packed ``(nodes, total)`` buffer, the self term at full
    precision and only the off-diagonal contributions through the wire
    dtype."""
    on = _weights_on(w)
    n = np.asarray(w).shape[0]

    def mix(flat: torch.Tensor) -> torch.Tensor:
        if flat.ndim != 2 or flat.shape[0] != n:
            raise ValueError(f"flat buffer {tuple(flat.shape)} != ({n}, total)")
        w_self, w_off = on(flat.device)
        xf = flat.to(torch.float32)
        sent = _wire(xf, wire_dtype)
        return (w_off @ sent + w_self[:, None] * xf).to(flat.dtype)

    return mix


def make_dense_gossip(w: np.ndarray, wire_dtype=None) -> GossipFn:
    """theta' = W @ Theta over the leading node axis of every leaf: packs
    the tree into one ``(nodes, total)`` buffer, mixes it with one
    product and unpacks."""
    mix = make_dense_flat_mix(w, wire_dtype)

    def gossip(tree: Tree) -> Tree:
        flat, layout = pack(tree)
        return unpack(mix(flat), layout)

    return gossip


def make_dense_gossip_per_leaf(w: np.ndarray, wire_dtype=None) -> GossipFn:
    """Leaf-by-leaf reference: one product per leaf per round (the
    equivalence oracle of the flat path)."""
    on = _weights_on(w)
    n = np.asarray(w).shape[0]

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != n:
            raise ValueError(f"leaf leading axis {x.shape[0]} != n_nodes {n}")
        w_self, w_off = on(x.device)
        flat = x.reshape(n, -1)
        sent = _wire(flat, wire_dtype).to(torch.float32)
        mixed = w_off @ sent + w_self[:, None] * flat.to(torch.float32)
        return mixed.to(x.dtype).reshape(x.shape)

    return lambda tree: tree_map(mix_leaf, tree)


def make_mean_consensus(n: int) -> GossipFn:
    """W = (1/N) 1 1^T: exact averaging (the fusion center / FedAvg
    server, and the limit of infinitely many gossip rounds)."""
    return make_dense_gossip(np.full((n, n), 1.0 / n))
