"""Flat-buffer packing: the node-stacked parameter tree as ONE contiguous
``(nodes, total_params)`` matrix (counterpart of ``repro.core.packing``).

Trees are nested dicts (and lists) of tensors whose leaves all carry a
leading ``nodes`` axis. Leaves are ordered like ``jax.tree_util``'s
flattening, dict keys sorted at every level (``fc1.b``, ``fc1.w``,
``fc2.b``, ``fc2.w`` for the MLP), so a buffer packed here and one packed
by the reference compare column for column. ``pack(..., pad_to=k)``
rounds ``total`` up to a multiple of ``k`` with zero columns, so the
buffer tiles evenly into kernel ``scale_chunk`` blocks; every engine op
is columnwise and keeps those columns zero.

Storage dtype: the buffer is fp32 by default, which holds fp32, bf16 and
fp16 leaves exactly. ``pack(..., buffer_dtype=torch.bfloat16)`` stores it
in bf16 (``FlatLayout.storage_dtype``), rounding wider leaves once; the
flat and fused engines then keep fp32 only in their transient arithmetic
and round every stored buffer back. ``unpack`` restores each leaf's own
dtype either way.

Wire-byte accounting (:func:`flat_wire_bytes`): a flat int8 payload
costs ``total`` bytes plus 4 bytes per (node, scale chunk) for the fp32
scales; a top-k payload is accounted in its compact encoding (k int8
values, the cheaper of k positions or a chunk/8-byte presence bitmap,
and the scale, per chunk). A federation scope's wire
(:func:`scoped_layout`) is accounted the same way at its own width.

Two-axis layouts: ``pack(..., shards=S)`` pads ``total`` to a multiple of
``pad_to * S`` so the buffer splits into S equal column tiles
(``FlatLayout.shard_width`` columns each), every tile a whole number of
kernel chunks; the sharded engine's rank ``(a, s)`` holds tile ``s`` of
its rows, and :func:`flat_wire_bytes_per_shard` accounts one tile's
payload, ``flat_wire_bytes / S``.
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
    "tree_bytes",
    "pack",
    "pack_layout",
    "pack_like",
    "as_dtype",
    "unpack",
    "compact_pos_dtype",
    "bitmap_bytes_per_chunk",
    "compact_index_bytes",
    "flat_wire_bytes",
    "flat_wire_bytes_per_shard",
    "scoped_layout",
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
    #: the dtype the buffer is stored in: "float32" (lossless for fp32,
    #: bf16 and fp16 leaves) or "bfloat16" (bf16 flat storage)
    storage_dtype: str = "float32"
    #: how many equal column tiles the buffer splits into on the two-axis
    #: (node, model_shard) layout: shard s owns columns ``[s *
    #: shard_width, (s + 1) * shard_width)``; 1 is the single-axis layout
    shards: int = 1

    def __post_init__(self):
        if self.shards < 1:
            raise ValueError(f"shards={self.shards} must be >= 1")
        if self.total % self.shards:
            raise ValueError(
                f"layout.total {self.total} not divisible by "
                f"shards={self.shards}; pack with pad_to and shards "
                "together so each shard is a whole tile"
            )

    @property
    def used(self) -> int:
        return sum(l.size for l in self.leaves)

    @property
    def n_leaves(self) -> int:
        return len(self.leaves)

    @property
    def shard_width(self) -> int:
        """Columns each model shard owns (``total / shards``)."""
        return self.total // self.shards

    def with_shards(self, shards: int) -> "FlatLayout":
        """The same layout re-tiled over ``shards`` model shards (the
        padded ``total`` must already divide evenly: pack with
        ``shards=`` to get the padding up front)."""
        return dataclasses.replace(self, shards=int(shards))


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


def tree_bytes(tree: Tree) -> int:
    """The bytes of a tree's leaves, each counted whole."""
    return int(sum(t.numel() * t.element_size() for _, t in tree_leaves(tree)))


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


def pack_layout(tree: Tree, pad_to: int = 1,
                storage_dtype=torch.float32, shards: int = 1) -> FlatLayout:
    """The layout of ``tree`` without materializing the buffer, stored in
    ``storage_dtype``. ``shards > 1`` pads ``total`` to a multiple of
    ``pad_to * shards``, so every model shard is a whole number of
    kernel chunks."""
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
    shards = max(int(shards), 1)
    unit = max(int(pad_to), 1) * shards
    total = ((off + unit - 1) // unit) * unit
    return FlatLayout(tuple(p for p, _ in items), tuple(specs), n_nodes, total,
                      _dtype_name(as_dtype(storage_dtype)), shards)


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or its name (``"bfloat16"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def _pack_into(items, layout: FlatLayout, dtype: torch.dtype) -> torch.Tensor:
    n = layout.n_nodes
    cols = [leaf.reshape(n, -1).to(dtype) for _, leaf in items]
    if layout.total > layout.used:
        cols.append(torch.zeros(n, layout.total - layout.used,
                                dtype=dtype, device=cols[0].device))
    return torch.cat(cols, dim=1).contiguous()


def pack(tree: Tree, pad_to: int = 1, buffer_dtype=torch.float32,
         shards: int = 1) -> Tuple[torch.Tensor, FlatLayout]:
    """Pack a node-stacked tree into one ``(nodes, total)`` buffer of
    ``buffer_dtype`` (recorded as ``layout.storage_dtype``; bf16 rounds
    fp32 leaves), zero-padded to a multiple of ``pad_to * shards``.
    Returns (flat, layout)."""
    layout = pack_layout(tree, pad_to, storage_dtype=buffer_dtype, shards=shards)
    return _pack_into(tree_leaves(tree), layout, as_dtype(buffer_dtype)), layout


def pack_like(tree: Tree, layout: FlatLayout, buffer_dtype=None) -> torch.Tensor:
    """Pack a tree into an EXISTING layout (same key paths and per-leaf
    shapes), stored in the layout's ``storage_dtype`` unless
    ``buffer_dtype`` is given (the engines pack gradients this way)."""
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
    if buffer_dtype is None:
        buffer_dtype = layout.storage_dtype
    return _pack_into(items, layout, as_dtype(buffer_dtype))


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


def scoped_layout(layout: FlatLayout, ranges, scale_chunk: int
                  ) -> Tuple[FlatLayout, Tuple[Tuple[int, int], ...]]:
    """The wire layout and shard-local column ranges of a SCOPED wire.

    A federation scope (``core.scope``) restricts gossip to the merged,
    disjoint global column ``ranges`` of ``layout``. The fused engines
    gather those columns into one contiguous buffer (per shard tile on
    the two-axis layout), run the unchanged wire stage on it and scatter
    the mixed result back, so the wire state (recon, residual, in-flight
    rings), the scales, the collectives and the byte accounting all live
    at the scoped width.

    Returns ``(wire_layout, local_ranges)``:

    * ``local_ranges`` -- the ranges intersected with one shard tile, in
      shard-local coordinates. They must come out IDENTICAL for every
      shard (each shard's wire slice must have the same width and chunk
      geometry); a scope whose ranges straddle the tiles unevenly is
      refused with the shards' widths named. At one shard they are the
      ranges themselves.
    * ``wire_layout`` -- a one-leaf layout whose ``total`` is the
      chunk-padded per-shard scoped width times the shards (shards
      kept) and whose ``used`` is the shared column count, so
      :func:`flat_wire_bytes` / :func:`flat_wire_bytes_per_shard` on it
      ARE the scoped wire's accounting. It keeps the layout's
      ``storage_dtype``."""
    ranges = tuple((int(a), int(b)) for a, b in ranges)
    pos = 0
    for a, b in ranges:
        if not (pos <= a < b <= layout.total):
            raise ValueError(
                f"scoped ranges {ranges!r} must be sorted, disjoint, "
                f"non-empty, within [0, {layout.total})"
            )
        pos = b
    s = layout.shards
    w = layout.shard_width
    per_shard = []
    for i in range(s):
        lo, hi = i * w, (i + 1) * w
        per_shard.append(tuple((max(a, lo) - lo, min(b, hi) - lo)
                               for a, b in ranges if a < hi and b > lo))
    if any(local != per_shard[0] for local in per_shard):
        widths = [sum(b - a for a, b in local) for local in per_shard]
        raise ValueError(
            f"scoped ranges are not uniform across the {s} model shards "
            f"(per-shard shared widths {widths}); every shard tile must "
            "carry the same scoped slice -- align the scope's ranges "
            f"with the shard tiles (shard_width={w}) or run single-axis"
        )
    local_ranges = per_shard[0]
    shared = sum(b - a for a, b in local_ranges)
    if shared == 0:
        raise ValueError(
            f"scoped ranges {ranges!r} share no columns; a scope must "
            "leave something on the wire"
        )
    unit = max(int(scale_chunk), 1)
    wire = FlatLayout(paths=((),), leaves=(LeafSpec(0, (shared * s,), "float32"),),
                      n_nodes=layout.n_nodes, total=-(-shared // unit) * unit * s,
                      storage_dtype=layout.storage_dtype, shards=s)
    return wire, local_ranges


def flat_wire_bytes_per_shard(layout: FlatLayout, degree: int, scale_chunk: int = 0,
                              topk: int | None = None) -> int:
    """Per-(node, shard) egress bytes a round on the two-axis layout: each
    model shard ships its own chunk-aligned slice of the wire, so this
    is exactly ``flat_wire_bytes / shards``. Needs the shard-aligned
    padding ``pack(..., shards=)`` gives (``total % (scale_chunk *
    shards) == 0``)."""
    s = layout.shards
    if s <= 1:
        return flat_wire_bytes(layout, degree, scale_chunk, topk)
    if scale_chunk > 0 and layout.shard_width % scale_chunk:
        raise ValueError(
            f"shard width {layout.shard_width} not a multiple of "
            f"scale_chunk {scale_chunk}; pack with pad_to={scale_chunk}, "
            f"shards={s}"
        )
    n_scales = 1 if scale_chunk <= 0 else layout.shard_width // scale_chunk
    if topk is None or scale_chunk <= 0 or topk >= scale_chunk:
        return degree * (layout.shard_width + 4 * n_scales)
    per_chunk = min(topk + compact_index_bytes(scale_chunk, topk) + 4,
                    scale_chunk + 4)
    return degree * (n_scales * per_chunk)
