"""Compressed gossip: int8 quantization with error feedback (counterpart
of ``repro.core.compression``).

The paper saves communication ROUNDS (Q local steps); this module saves
BYTES PER ROUND: neighbor payloads are quantized to int8 with symmetric
scaling, and the quantization residual is fed back into the next round's
payload (error feedback), which keeps the long-run mixing unbiased.

The hot path works on the packed ``(nodes, total)`` buffer
(``core.packing``): one quantize-mix-EF pass per round, with one scale
per ``(node, scale_chunk)`` column block, in one call of
``kernels.gossip.ops.gossip_mix`` -- the hand-written CUDA kernel for
CUDA tensors, its plain PyTorch twin for CPU tensors.
``make_compressed_dense_gossip`` wraps it in pack/unpack for trees;
``make_compressed_dense_gossip_per_leaf`` keeps the per-leaf version
(per-node-per-leaf scales) as the equivalence oracle.

State per node: the shared reconstruction theta_hat (what neighbors can
rebuild from wire traffic alone) and the error-feedback residual. A
compressed gossip maps ``(x, state) -> (mixed, new_state)``.

Quantizer: symmetric int8, q = round(x / s), s = max|x| / 127,
dequant = q * s. Wire payload per round: 1 byte per parameter plus 4
bytes per scale block (``packing.flat_wire_bytes`` for the flat path,
:func:`compressed_wire_bytes` for the per-leaf one).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from repro_torch.core.fl import tree_map
from repro_torch.core.mixing import _weights_on
from repro_torch.core.packing import pack, tree_leaves, tree_unflatten, unpack
from repro_torch.kernels.gossip.ops import gossip_mix

Tree = Any
FlatGossipFn = Callable[[torch.Tensor, Dict[str, torch.Tensor]],
                        Tuple[torch.Tensor, Dict[str, torch.Tensor]]]

#: one fp32 scale per 512 int8 columns (0.8% wire overhead); the column
#: block of one kernel tile
DEFAULT_SCALE_CHUNK = 512

__all__ = [
    "DEFAULT_SCALE_CHUNK",
    "quantize_int8",
    "dequantize_int8",
    "make_compressed_dense_gossip",
    "make_compressed_dense_gossip_per_leaf",
    "make_compressed_flat_gossip",
    "init_compression_state",
    "init_flat_compression_state",
    "zeros_like_residual",
    "compressed_wire_bytes",
]


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-node symmetric int8. x: (nodes, ...) -> (q int8, scale (nodes,))."""
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    # divide by a tensor ON the device: CUDA division by a host scalar
    # multiplies by its reciprocal, one ulp off IEEE division
    d127 = torch.full((), 127.0, dtype=torch.float32, device=x.device)
    scale = flat.abs().amax(dim=1) / d127
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(flat / safe[:, None]), -127, 127).to(torch.int8)
    return q.reshape(x.shape), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    flat = q.reshape(q.shape[0], -1).to(torch.float32)
    return (flat * scale[:, None]).reshape(q.shape)


def zeros_like_residual(tree: Tree) -> Tree:
    return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32), tree)


def init_compression_state(tree: Tree) -> Dict[str, Tree]:
    """{recon, residual} per leaf, fp32 zeros: the first round effectively
    transmits the full parameters."""
    return {"recon": zeros_like_residual(tree), "residual": zeros_like_residual(tree)}


def init_flat_compression_state(flat: torch.Tensor) -> Dict[str, torch.Tensor]:
    """The flat path's {recon, residual}: (nodes, total) fp32 zeros."""
    return {k: torch.zeros(flat.shape, dtype=torch.float32, device=flat.device)
            for k in ("recon", "residual")}


def make_compressed_flat_gossip(
    w: np.ndarray,
    error_feedback: bool = True,
    difference_coding: bool = True,
    scale_chunk: int = DEFAULT_SCALE_CHUNK,
    topk: int | None = None,
) -> FlatGossipFn:
    """CHOCO-style gossip on the packed ``(nodes, total)`` buffer
    (``total`` a multiple of ``scale_chunk``; pack with
    ``pad_to=scale_chunk``), ONE ``gossip_mix`` call per round:

        payload    = theta - theta_hat + residual
        q, s       = int8(payload)               <- the only wire bytes
        theta_hat' = theta_hat + dq(q, s)
        residual'  = payload - dq(q, s)          (EF)
        theta'     = W_ii theta + sum_{j!=i} W_ij theta_hat_j'

    ``topk=k`` ships only the k largest-|payload| columns per scale chunk
    (ties at the threshold kept); the EF residual absorbs the truncation.
    The buffer's device picks the kernel or its twin; there is no other
    switch."""
    on = _weights_on(w)

    def gossip(flat: torch.Tensor, state: Dict[str, torch.Tensor]):
        w_self, w_off = on(flat.device)
        mixed, recon, res, _ = gossip_mix(
            flat.to(torch.float32), state["recon"], state["residual"], w_off,
            w_self, scale_chunk=scale_chunk, error_feedback=error_feedback,
            difference_coding=difference_coding, topk=topk,
        )
        return mixed.to(flat.dtype), {"recon": recon, "residual": res}

    return gossip


def make_compressed_dense_gossip(
    w: np.ndarray,
    error_feedback: bool = True,
    difference_coding: bool = True,
    scale_chunk: int = DEFAULT_SCALE_CHUNK,
) -> Callable[[Tree, Dict[str, Tree]], Tuple[Tree, Dict[str, Tree]]]:
    """Tree wrapper of :func:`make_compressed_flat_gossip`: packs the
    parameters and the {recon, residual} state into flat buffers, runs ONE
    quantize-mix-EF pass, and unpacks."""
    flat_gossip = make_compressed_flat_gossip(
        w, error_feedback, difference_coding, scale_chunk)

    def gossip(tree: Tree, state: Dict[str, Tree]):
        flat, layout = pack(tree, pad_to=scale_chunk)
        recon, f32_layout = pack(state["recon"], pad_to=scale_chunk)
        res, _ = pack(state["residual"], pad_to=scale_chunk)
        mixed, new_state = flat_gossip(flat, {"recon": recon, "residual": res})
        return unpack(mixed, layout), {
            "recon": unpack(new_state["recon"], f32_layout),
            "residual": unpack(new_state["residual"], f32_layout),
        }

    return gossip


def make_compressed_dense_gossip_per_leaf(
    w: np.ndarray, error_feedback: bool = True, difference_coding: bool = True
) -> Callable[[Tree, Dict[str, Tree]], Tuple[Tree, Dict[str, Tree]]]:
    """Leaf-by-leaf CHOCO gossip with per-node-per-LEAF scales (one
    quantize and one product per leaf per round): the flat path's
    equivalence oracle."""
    on = _weights_on(w)
    n = np.asarray(w).shape[0]

    def mix_leaf(x, recon, res):
        w_self, w_off = on(x.device)
        xf = x.to(torch.float32)
        base = recon if difference_coding else torch.zeros_like(recon)
        payload = xf - base + res if error_feedback else xf - base
        q, s = quantize_int8(payload)
        dq = dequantize_int8(q, s)
        new_recon = base + dq
        new_res = payload - dq if error_feedback else res
        mixed = w_off @ new_recon.reshape(n, -1) + w_self[:, None] * xf.reshape(n, -1)
        return mixed.reshape(x.shape).to(x.dtype), new_recon, new_res

    def gossip(tree: Tree, state: Dict[str, Tree]):
        items = tree_leaves(tree)
        paths = tuple(p for p, _ in items)
        triples = [mix_leaf(x, r, e) for (_, x), (_, r), (_, e) in zip(
            items, tree_leaves(state["recon"]), tree_leaves(state["residual"]))]
        mixed, recon, res = (tree_unflatten(paths, list(col)) for col in zip(*triples))
        return mixed, {"recon": recon, "residual": res}

    return gossip


def compressed_wire_bytes(tree: Tree, degree: int) -> int:
    """Per-node egress bytes per round of the PER-LEAF path: 1 B per
    parameter plus a 4 B scale per leaf, times the out-degree (the flat
    path's accounting is ``packing.flat_wire_bytes``)."""
    total = 0
    for _, leaf in tree_leaves(tree):
        per_node = int(np.prod(leaf.shape[1:])) if leaf.ndim > 1 else 1
        total += per_node + 4
    return degree * total
