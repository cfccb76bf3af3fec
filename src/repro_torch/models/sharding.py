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
The port's model layers do not run tensor-parallel: the specs price a
rank's share (``launch.dryrun``), they do not place tensors.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Sequence, Tuple

import torch

from repro_torch.core.fl import tree_map
from repro_torch.core.packing import tree_leaves, tree_unflatten

__all__ = ["model_param_specs", "node_stack_specs", "batch_specs", "rank_bytes"]

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
    spec_of = dict(_spec_leaves(specs))
    total = 0
    for path, leaf in tree_leaves(params):
        spec = spec_of[path]
        if len(spec) != leaf.ndim:
            raise ValueError(f"spec {spec} does not match leaf {'/'.join(map(str, path))} "
                             f"of {leaf.ndim} dims")
        numel = math.prod(-(-d // _split(e, sizes)) for d, e in zip(leaf.shape, spec))
        total += numel * leaf.element_size()
    return total
