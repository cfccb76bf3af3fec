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
from repro_torch.core.packing import FlatLayout, tree_leaves
from repro_torch.device import resolve_device
from repro_torch.models.model import build_model

__all__ = ["params_from_numpy", "flat_from_numpy", "model_params_from_numpy"]


def params_from_numpy(tree: Any, device=None) -> Any:
    """Nested dicts (and lists) of numpy arrays -> the same tree of
    tensors on ``device`` (``cuda`` unless given), dtypes unchanged."""
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


def _name(path) -> str:
    return "/".join(map(str, path))


def model_params_from_numpy(tree: Any, cfg, device=None) -> Any:
    """A reference model's parameter tree (its bundle's ``init_fn`` output
    as nested dicts and lists of numpy arrays) -> the port's tensors on
    ``device``, in the same layout. Decoder-only: ``embed``,
    ``final_norm``, the blocks -- layer-stacked ``blocks``, or
    ``pblocks`` and ``tail`` lists, or a ``blocks`` list; a ``moe``
    block's ``router/w``, ``gate``, ``up``, ``down`` and ``shared`` --
    and, untied, ``head``; enc-dec: ``enc`` and ``dec``, each with its
    layer-stacked ``blocks``. Every leaf's path, shape and dtype is
    checked against the port's own init for ``cfg`` on the meta device
    first, in ``jax.tree_util``'s order (list items by index); a mismatch
    raises ``ValueError`` naming the leaf."""
    want = {path: leaf for path, leaf in tree_leaves(build_model(cfg).param_shapes())}
    got = {path: np.asarray(leaf) for path, leaf in tree_leaves(tree)}
    if set(got) != set(want):
        raise ValueError(
            f"parameter tree does not match {cfg.name}: missing "
            f"{sorted(map(_name, set(want) - set(got)))}, unexpected "
            f"{sorted(map(_name, set(got) - set(want)))}"
        )
    for path, leaf in want.items():
        arr = got[path]
        dtype = str(leaf.dtype).removeprefix("torch.")
        if tuple(arr.shape) != tuple(leaf.shape) or arr.dtype.name != dtype:
            raise ValueError(
                f"leaf {_name(path)}: {arr.shape} {arr.dtype.name}, {cfg.name} "
                f"wants {tuple(leaf.shape)} {dtype}"
            )
    return params_from_numpy(tree, device)
