"""Flat-buffer packing: the node-stacked parameter tree as ONE contiguous
``(nodes, total_params)`` fp32 matrix (counterpart of
``repro.core.packing``).

Trees are nested dicts (and lists) of tensors whose leaves all carry a
leading ``nodes`` axis. Leaves are ordered like ``jax.tree_util``'s
flattening, dict keys sorted at every level (``fc1.b``, ``fc1.w``,
``fc2.b``, ``fc2.w`` for the MLP), so a buffer packed here and one packed
by the reference compare column for column. ``pack(..., pad_to=k)``
rounds ``total`` up to a multiple of ``k`` with zero columns, so the
buffer tiles evenly into kernel ``scale_chunk`` blocks; every engine op
is columnwise and keeps those columns zero.

Wire-byte accounting (:func:`flat_wire_bytes`): a flat int8 payload
costs ``total`` bytes plus 4 bytes per (node, scale chunk) for the fp32
scales; a top-k payload is accounted in its compact encoding (k int8
values, the cheaper of k positions or a chunk/8-byte presence bitmap,
and the scale, per chunk).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Tree = Any
Path = Tuple[Any, ...]  # dict keys (str) and list indices (int)

__all__ = [
    "LeafSpec",
    "FlatLayout",
    "tree_leaves",
    "tree_unflatten",
    "pack",
    "pack_layout",
    "pack_like",
    "unpack",
    "compact_pos_dtype",
    "bitmap_bytes_per_chunk",
    "compact_index_bytes",
    "flat_wire_bytes",
]


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    offset: int  # column offset into the flat buffer
    shape: Tuple[int, ...]  # per-node shape (leading nodes axis stripped)
    dtype: str  # original leaf dtype name, restored by unpack

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.shape else 1


@dataclasses.dataclass(frozen=True)
class FlatLayout:
    """Static description of a packed node-stacked tree.

    Leaf ``k`` (key path ``paths[k]``) occupies columns
    ``[leaves[k].offset, leaves[k].offset + leaves[k].size)``; leaves are
    contiguous and in order, and columns ``[used, total)`` are zero
    padding. ``unpack(pack(tree)) == tree`` exactly for fp32 leaves.
    """

    paths: Tuple[Path, ...]
    leaves: Tuple[LeafSpec, ...]
    n_nodes: int
    total: int

    @property
    def used(self) -> int:
        return sum(l.size for l in self.leaves)

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)


def tree_leaves(tree: Tree, prefix: Path = ()) -> List[Tuple[Path, torch.Tensor]]:
    """``(key path, leaf)`` pairs in ``jax.tree_util``'s order for trees of
    dicts and lists: dict keys sorted at every level, list items by
    index (an int in the path), depth first."""
    if isinstance(tree, dict):
        out: List[Tuple[Path, torch.Tensor]] = []
        for k in sorted(tree):
            out.extend(tree_leaves(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, list):
        return [item for i, sub in enumerate(tree) for item in tree_leaves(sub, prefix + (i,))]
    return [(prefix, tree)]


def tree_unflatten(paths: Tuple[Path, ...], values) -> Tree:
    """Inverse of :func:`tree_leaves`: nested dicts from key paths, a
    list wherever a level's keys are list indices. (A list without
    leaves has no path, so it does not come back.)"""
    out: Dict = {}
    for path, v in zip(paths, values):
        if not path:
            return v
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return _relist(out)


def _relist(node):
    if not isinstance(node, dict):
        return node
    node = {k: _relist(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        return [node[i] for i in range(len(node))]
    return node


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def pack_layout(tree: Tree, pad_to: int = 1) -> FlatLayout:
    """The layout of ``tree`` without materializing the buffer."""
    items = tree_leaves(tree)
    if not items:
        raise ValueError("cannot pack an empty tree")
    n_nodes = items[0][1].shape[0]
    specs = []
    off = 0
    for _, leaf in items:
        if leaf.ndim < 1 or leaf.shape[0] != n_nodes:
            raise ValueError(
                f"leaf shape {tuple(leaf.shape)} is not node-stacked for "
                f"n={n_nodes}"
            )
        specs.append(LeafSpec(off, tuple(leaf.shape[1:]), _dtype_name(leaf.dtype)))
        off += specs[-1].size
    unit = max(int(pad_to), 1)
    total = ((off + unit - 1) // unit) * unit
    return FlatLayout(tuple(p for p, _ in items), tuple(specs), n_nodes, total)


def _pack_into(items, layout: FlatLayout) -> torch.Tensor:
    n = layout.n_nodes
    cols = [leaf.reshape(n, -1).to(torch.float32) for _, leaf in items]
    if layout.total > layout.used:
        cols.append(torch.zeros(n, layout.total - layout.used,
                                dtype=torch.float32, device=cols[0].device))
    return torch.cat(cols, dim=1).contiguous()


def pack(tree: Tree, pad_to: int = 1) -> Tuple[torch.Tensor, FlatLayout]:
    """Pack a node-stacked tree into one ``(nodes, total)`` fp32 buffer
    (zero-padded to a multiple of ``pad_to``). Returns (flat, layout)."""
    layout = pack_layout(tree, pad_to)
    return _pack_into(tree_leaves(tree), layout), layout


def pack_like(tree: Tree, layout: FlatLayout) -> torch.Tensor:
    """Pack a tree into an EXISTING layout (same key paths and per-leaf
    shapes)."""
    items = tree_leaves(tree)
    if tuple(p for p, _ in items) != layout.paths:
        raise ValueError(
            f"tree paths {[p for p, _ in items]} != layout {list(layout.paths)}"
        )
    n = layout.n_nodes
    for (_, leaf), spec in zip(items, layout.leaves):
        if tuple(leaf.shape) != (n,) + spec.shape:
            raise ValueError(
                f"leaf shape {tuple(leaf.shape)} != layout {(n,) + spec.shape}"
            )
    return _pack_into(items, layout)


def unpack(flat: torch.Tensor, layout: FlatLayout) -> Tree:
    """Invert :func:`pack`: each leaf is a view of its columns, reshaped
    and restored to its dtype (a copy only where the dtype differs)."""
    if tuple(flat.shape) != (layout.n_nodes, layout.total):
        raise ValueError(
            f"flat buffer {tuple(flat.shape)} does not match layout "
            f"({layout.n_nodes}, {layout.total})"
        )
    n = layout.n_nodes
    leaves = [
        flat[:, s.offset:s.offset + s.size].reshape((n,) + s.shape)
        .to(getattr(torch, s.dtype))
        for s in layout.leaves
    ]
    return tree_unflatten(layout.paths, leaves)


def compact_pos_dtype(scale_chunk: int) -> torch.dtype:
    """Dtype of the compact wire's in-chunk positions: int16 when a chunk
    index fits (chunk <= 32768), int32 otherwise."""
    return torch.int16 if scale_chunk <= 2 ** 15 else torch.int32


def bitmap_bytes_per_chunk(scale_chunk: int) -> int | None:
    """Bytes of one chunk's presence bitmap, or None when the chunk is not
    byte-aligned (no bitmap encoding)."""
    return scale_chunk // 8 if scale_chunk % 8 == 0 else None


def compact_index_bytes(scale_chunk: int, topk: int) -> int:
    """Index bytes of ONE chunk's compact top-k payload: the cheaper of
    explicit positions (k x :func:`compact_pos_dtype`) and the presence
    bitmap (chunk/8 B, byte-aligned chunks only)."""
    explicit = topk * (torch.iinfo(compact_pos_dtype(scale_chunk)).bits // 8)
    bitmap = bitmap_bytes_per_chunk(scale_chunk)
    return explicit if bitmap is None else min(explicit, bitmap)


def flat_wire_bytes(layout: FlatLayout, degree: int, scale_chunk: int = 0,
                    topk: int | None = None) -> int:
    """Per-node egress bytes per round for an int8 flat payload, times the
    out-degree.

    Dense int8 (``topk=None``, or ``topk >= scale_chunk``): 1 B per
    column (padding included: it travels) plus 4 B per scale chunk
    (``scale_chunk=0``: one scale per node). Top-k: per scale chunk, k
    int8 values + :func:`compact_index_bytes` + the 4 B scale, capped at
    the dense chunk's bytes."""
    n_scales = 1 if scale_chunk <= 0 else -(-layout.total // scale_chunk)
    if topk is None or scale_chunk <= 0 or topk >= scale_chunk:
        return degree * (layout.total + 4 * n_scales)
    per_chunk = min(topk + compact_index_bytes(scale_chunk, topk) + 4,
                    scale_chunk + 4)
    return degree * (n_scales * per_chunk)
