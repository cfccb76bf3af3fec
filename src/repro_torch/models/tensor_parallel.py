"""Megatron tensor parallelism over a model group: the collectives of the
column- and row-parallel layers (the reference partitions its layers by
GSPMD over the ``model`` mesh axis, ``repro.models.sharding``; the port
issues the collectives itself).

A layer's S model ranks each hold one shard of its split weights
(``models.sharding.shard_params``) and the whole of its replicated ones;
the residual stream, the norms and the loss stay replicated. Two
conjugate ``torch.autograd.Function``s carry a layer across the split:

  * :func:`copy_to_model` (Megatron's ``f``): the identity forward, an
    all-reduce of the gradient backward -- the input of a column-parallel
    product, whose S shards each reach only their columns' gradient;
  * :func:`reduce_from_model` (``g``): an all-reduce forward, the
    identity backward -- the output of a row-parallel product (each rank
    holds a partial sum), and the vocab-parallel lookups and loss terms.

:func:`gather_from_model` all-gathers a column-split activation along
its last dimension (the attention heads a rank's columns cut through);
its backward all-reduces the whole gradient and keeps the rank's slice.
:func:`scatter_to_model` (Megatron's split) is its conjugate: forward it
keeps the rank's slice of a replicated tensor, backward it all-gathers
the slices' gradients, so every rank holds the whole gradient of what
it cut -- a replicated leaf (or a replicated computation) that a layer
uses only on the rank's heads or channels (RWKV6's ``u``, ``ln_scale``
and decay, RG-LRU's ``lam`` and ``conv_b``) keeps one gradient, the
same on every rank.
:func:`all_reduce_max` is the detached all-reduced max of the
vocab-parallel softmax.

Every collective is an all-reduce or a list all-gather: gloo takes both
on CPU and CUDA tensors (a model group of two processes on one card runs
gloo: NCCL refuses two ranks on one device), NCCL takes both, and the
dry run's ``fake`` backend counts them (``launch.op_analysis``).

A group of None means the whole layer: every function here is then the
identity and issues nothing, so a single-rank model runs exactly the
operations it ran before.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

__all__ = [
    "TPGroup",
    "tp_group",
    "copy_to_model",
    "reduce_from_model",
    "gather_from_model",
    "scatter_to_model",
    "all_reduce_max",
]


@dataclasses.dataclass(frozen=True)
class TPGroup:
    """A model group as the layers see it: the process group, this rank's
    index in it (its shard) and its size S."""

    pg: dist.ProcessGroup
    rank: int
    size: int


def tp_group(pg: Optional[dist.ProcessGroup]) -> Optional[TPGroup]:
    """The :class:`TPGroup` of a model process group (``NodeGroup.model_pg``);
    None for None (the whole layer)."""
    if pg is None:
        return None
    return TPGroup(pg, dist.get_rank(group=pg), dist.get_world_size(group=pg))


def _all_reduce(x: torch.Tensor, pg) -> torch.Tensor:
    x = x.contiguous().clone()
    dist.all_reduce(x, group=pg)
    return x


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        ctx.pg = pg
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _all_reduce(grad, ctx.pg), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pg):
        return _all_reduce(x, pg)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.width = tp, x.shape[-1]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(tp.size)]
        dist.all_gather(parts, x, group=tp.pg)
        return torch.cat(parts, dim=-1)

    @staticmethod
    def backward(ctx, grad):
        tp, w = ctx.tp, ctx.width
        return _all_reduce(grad, tp.pg).narrow(-1, tp.rank * w, w).contiguous(), None


class _ScatterToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        w = x.shape[dim] // tp.size
        return x.narrow(dim, tp.rank * w, w).clone(memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, grad):
        tp = ctx.tp
        grad = grad.contiguous()
        parts = [torch.empty_like(grad) for _ in range(tp.size)]
        dist.all_gather(parts, grad, group=tp.pg)
        return torch.cat(parts, dim=ctx.dim), None, None


def copy_to_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``f``: ``x`` itself forward; backward, the gradient all-reduced over
    the model group."""
    return x if tp is None else _CopyToModel.apply(x, tp.pg)


def reduce_from_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """``g``: the sum of every rank's ``x`` forward; backward, the gradient
    itself."""
    return x if tp is None else _ReduceFromModel.apply(x, tp.pg)


def gather_from_model(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """Every rank's ``x`` (..., w) side by side, (..., S * w) in rank order;
    backward, this rank's slice of the all-reduced gradient."""
    return x if tp is None else _GatherFromModel.apply(x, tp)


def scatter_to_model(x: torch.Tensor, tp: Optional[TPGroup], dim: int = -1) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` (S equal slices, in rank
    order), contiguous; backward, every rank's slice of the gradient side
    by side (an all-gather), the same whole gradient on every rank."""
    if tp is None:
        return x
    if x.shape[dim] % tp.size:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split evenly over "
                         f"{tp.size} model ranks")
    return _ScatterToModel.apply(x, tp, dim % x.ndim)


def all_reduce_max(x: torch.Tensor, tp: Optional[TPGroup]) -> torch.Tensor:
    """The elementwise max over the model group, outside autograd."""
    if tp is None:
        return x.detach()
    x = x.detach().contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=tp.pg)
    return x
