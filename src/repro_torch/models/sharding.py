"""Tensor-parallel partition specs for model parameters (counterpart of
``repro.models.sharding``).

The reference's Megatron-style layout over the ``model`` mesh axis,
applied to FUSED dims:

  embed/head tables (V, d)      -> ("model", None)        vocab-sharded
  attn wq/wk/wv     (d, H*hd)   -> (None, "model")        column-parallel
  attn wo           (H*hd, d)   -> ("model", None)        row-parallel
  mlp gate/up       (d, ff)     -> (None, "model")
  mlp down          (ff, d)     -> ("model", None)
  moe experts       (E, d, ff)  -> ("model", None, None)  expert-parallel
  rglru in_proj     (d, 2W)     -> (None, "model")        etc.
  norms, lerp coefficients, decay vectors -> replicated

A spec is a plain tuple with one entry a dimension: an axis name, a
tuple of axis names (the node axes), or None (not split) -- the
reference's ``PartitionSpec`` as a tuple, over the port's parameter dict
(the same paths, ``core.packing.tree_leaves``). Layer-stacked leaves
(under a ``blocks`` dict, or a ``pblocks`` pattern-period stack) get a
leading None for the layer axis. ``node_stack_specs`` prepends the FL
node axes for the node-stacked optimizer state; ``rank_bytes`` is what
one rank holds when every split dimension is divided over its axes.

The specs also place tensors: :func:`shard_params` cuts a whole tree
into shard ``s`` of ``S`` along every dimension split over the model
axis (the tree a rank of a model group holds, ``models.
tensor_parallel``; the ``tree`` engine's state on the ``(node, model)``
layout), :func:`unshard_params` puts S shards back together. Every
family's layers run on such shards. One leaf is cut in pairs: RG-LRU's
``in_proj`` (its ``w`` and ``b``) fuses the u and the gate columns, (d,
2W) = [u | gate], so shard s holds the columns ``[s W/S, (s+1) W/S)`` of
each half side by side (:func:`cut_leaf`, :func:`join_leaf`); its spec
stays the reference's ``(None, "model")`` and its bytes a rank
:func:`rank_bytes`' 2W/S columns.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from repro_torch.core.fl import tree_map
from repro_torch.core.packing import tree_leaves, tree_unflatten

__all__ = ["model_param_specs", "node_stack_specs", "batch_specs", "rank_bytes",
           "stacked_param_specs", "shard_params", "unshard_params", "is_split",
           "split_dim", "spec_dict", "cut_leaf", "join_leaf"]

Spec = Tuple[Any, ...]

_COL = {"wq", "wk", "wv", "wg", "wr", "gate", "up", "in_proj", "gate_a", "gate_x"}
_ROW = {"wo", "down", "out_proj"}


def _leaf_spec(path: Tuple, leaf: torch.Tensor) -> Spec:
    keys = [k for k in path if isinstance(k, str)]
    name = keys[-1] if keys else ""
    parent = keys[-2] if len(keys) > 1 else ""
    gparent = keys[-3] if len(keys) > 2 else ""
    stacked = ("blocks" in keys and not any(isinstance(k, int) for k in path)) or (
        "pblocks" in keys  # pattern-period stacks: list index + layer-stacked leaves
    )
    nd = leaf.ndim - (1 if stacked else 0)

    def wrap(*spec) -> Spec:
        spec = tuple(spec) + (None,) * (nd - len(spec))
        return ((None,) + spec) if stacked else spec

    # embedding / unembedding tables
    if name == "table":
        return wrap("model", None)
    # learned positional tables / norms / scalars / gates' vectors
    if (name in ("pos", "scale", "bias", "w0", "u", "ln_scale", "lam", "conv_b")
            or name.startswith("mu_")):
        return wrap(*([None] * nd))
    # MoE expert stacks (E, d, ff) / (E, ff, d) and router
    if parent == "moe" and name in ("gate", "up", "down"):
        return wrap("model", None, None)
    if parent == "router" or gparent == "router":
        return wrap(*([None] * nd))
    # dense kernels: match on the dict that OWNS the w/b leaf
    owner = parent if name in ("w", "b") else name
    # rwkv channel-mix down projection (ff -> d) is row-parallel, unlike
    # the attention/time-mix "wv" which is column-parallel
    if owner == "wv" and gparent == "channel":
        owner = "down"
    if owner in _COL:
        if name == "b":
            return wrap("model")
        return wrap(None, "model")
    if owner in _ROW:
        if name == "b":
            return wrap(*([None] * nd))
        return wrap("model", None)
    if owner == "conv_w":
        return wrap(None, "model")
    # rwkv decay lora (wa: d->64, wb: 64->d) and anything small: replicate
    return wrap(*([None] * nd))


def model_param_specs(params) -> Any:
    """The spec tree (model/TP axes only) matching ``params``."""
    leaves = tree_leaves(params)
    return tree_unflatten(tuple(p for p, _ in leaves),
                          [_leaf_spec(p, leaf) for p, leaf in leaves])


def _spec_leaves(specs) -> list:
    """``(path, spec)`` pairs of a spec tree (a spec is a tuple leaf)."""
    if isinstance(specs, dict):
        return [((k,) + p, s) for k in sorted(specs) for p, s in _spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [((i,) + p, s) for i, sub in enumerate(specs) for p, s in _spec_leaves(sub)]
    return [((), specs)]


def spec_dict(specs) -> Dict[Tuple, Spec]:
    """``{leaf path: spec}`` of a spec tree."""
    return dict(_spec_leaves(specs))


def node_stack_specs(specs, node_axes: Sequence[str]) -> Any:
    """Prepend the FL node axes to every spec (node-stacked state layout)."""
    na = tuple(node_axes)
    leaves = _spec_leaves(specs)
    return tree_unflatten(tuple(p for p, _ in leaves), [(na,) + tuple(s) for _, s in leaves])


def batch_specs(batch_tree: Dict[str, torch.Tensor], node_axes: Sequence[str],
                leading_scan: bool = True) -> Dict[str, Spec]:
    """Specs for FL batches: (Q, nodes, per_node, ...) -> (None, nodes, ...)."""
    na = tuple(node_axes)

    def f(leaf) -> Spec:
        extra = (None,) * (leaf.ndim - (2 if leading_scan else 1))
        return (None, na) + extra if leading_scan else (na,) + extra

    return tree_map(f, batch_tree)


def _split(entry, sizes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(sizes[a] for a in names)


def rank_bytes(params, specs, mesh) -> int:
    """The bytes one rank holds of ``params`` laid out by ``specs`` on
    ``mesh`` (a ``launch.mesh.MeshLayout``, or ``{axis: size}``): every
    split dimension divided over the product of its axes' sizes, rounded
    up as a padded shard would be."""
    sizes = dict(mesh.shape if hasattr(mesh, "shape") else mesh)
    spec_of = spec_dict(specs)
    total = 0
    for path, leaf in tree_leaves(params):
        spec = spec_of[path]
        if len(spec) != leaf.ndim:
            raise ValueError(f"spec {spec} does not match leaf {'/'.join(map(str, path))} "
                             f"of {leaf.ndim} dims")
        numel = math.prod(-(-d // _split(e, sizes)) for d, e in zip(leaf.shape, spec))
        total += numel * leaf.element_size()
    return total


def stacked_param_specs(stacked, node_axes: Sequence[str] = ("nodes",)) -> Any:
    """The specs of a node-stacked tree (a leading node axis on every
    leaf): the rules read the tree of one node, then the node axes go
    first (:func:`node_stack_specs`)."""
    return node_stack_specs(model_param_specs(tree_map(lambda x: x[0], stacked)), node_axes)


def is_split(spec: Spec, axis: str = "model") -> bool:
    """Whether a spec splits a dimension over ``axis``."""
    return any(axis == e or (isinstance(e, tuple) and axis in e) for e in spec)


def split_dim(spec: Spec, path=(), axis: str = "model") -> Optional[int]:
    """The dimension a spec splits over ``axis``, or None (``path``: the
    leaf's, for the error of a spec that splits two)."""
    dims = [i for i, e in enumerate(spec)
            if axis == e or (isinstance(e, tuple) and axis in e)]
    if len(dims) > 1:
        raise ValueError(f"leaf {'/'.join(map(str, path))} splits {len(dims)} dims over "
                         f"{axis!r}")
    return dims[0] if dims else None


def _paired(path) -> bool:
    """Whether the leaf at ``path`` is cut in pairs: RG-LRU's fused
    ``in_proj`` (the u half, then the gate half)."""
    return "in_proj" in [k for k in path if isinstance(k, str)]


def cut_leaf(path, leaf: torch.Tensor, dim: int, shard: int, shards: int) -> torch.Tensor:
    """Shard ``shard`` of ``shards`` of ``leaf`` along ``dim``: a slice,
    or for RG-LRU's fused ``in_proj`` (:func:`_paired`) the same slice of
    each half, side by side. A dimension that does not split evenly is
    refused."""
    size, pairs = leaf.shape[dim], 2 if _paired(path) else 1
    if size % (pairs * shards):
        raise ValueError(f"leaf {'/'.join(map(str, path))}: dim {dim} of size {size} "
                         f"does not split evenly over {shards} shards"
                         + (" in each half" if pairs == 2 else ""))
    width = size // pairs // shards
    halves = leaf.unflatten(dim, (pairs, size // pairs))
    return halves.narrow(dim + 1, shard * width, width).flatten(dim, dim + 1)


def join_leaf(path, parts: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
    """The whole leaf of its shards (in shard order): :func:`cut_leaf`
    undone."""
    if not _paired(path):
        return torch.cat(list(parts), dim=dim)
    halves = [p.unflatten(dim, (2, p.shape[dim] // 2)) for p in parts]
    return torch.cat(halves, dim=dim + 1).flatten(dim, dim + 1)


def shard_params(params, shard: int, shards: int, specs=None, axis: str = "model") -> Any:
    """Shard ``shard`` of ``shards`` of a whole tree under ``specs``
    (default :func:`model_param_specs`): the same paths, every dimension
    split over ``axis`` cut into ``shards`` equal slices (:func:`cut_leaf`:
    a paired leaf in pairs) and this one kept and the other leaves whole,
    each a copy of its own (a rank holds its tree, not views into the
    whole). A split dimension that ``shards`` does not divide is refused
    -- :func:`rank_bytes` would price a padded shard the layers cannot
    run on."""
    if not 0 <= shard < shards:
        raise ValueError(f"shard {shard} is not one of {shards}")
    specs = model_param_specs(params) if specs is None else specs
    spec_of = spec_dict(specs)
    items = tree_leaves(params)
    out = []
    for path, leaf in items:
        spec = spec_of[path]
        if len(spec) != leaf.ndim:
            raise ValueError(f"spec {spec} does not match leaf {'/'.join(map(str, path))} "
                             f"of {leaf.ndim} dims")
        dim = split_dim(spec, path, axis)
        if dim is None or shards == 1:
            out.append(leaf.clone())
            continue
        out.append(cut_leaf(path, leaf, dim, shard, shards).clone())
    return tree_unflatten(tuple(p for p, _ in items), out)


def unshard_params(shards: Sequence, specs, axis: str = "model") -> Any:
    """The whole tree of :func:`shard_params`' ``len(shards)`` shards (in
    shard order): each split leaf put back together along its split
    dimension (:func:`join_leaf`), each other leaf taken from shard 0."""
    spec_of = spec_dict(specs)
    items = [tree_leaves(s) for s in shards]
    out = []
    for j, (path, leaf) in enumerate(items[0]):
        dim = split_dim(spec_of[path], path, axis)
        out.append(leaf if dim is None else join_leaf(path, [it[j][1] for it in items], dim))
    return tree_unflatten(tuple(p for p, _ in items[0]), out)
