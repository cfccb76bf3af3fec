"""Mixture-of-Experts FFN: a top-k router and capacity-based sorted
dispatch (counterpart of ``repro.models.moe``).

Expert weights carry a leading E axis: ``gate`` / ``up`` (E, d, f),
``down`` (E, f, d), and the fp32 router ``router/w`` (d, E); llama4's
always-on ``shared`` expert is a SwiGLU beside them.

Dispatch is the reference's sort-free capacity scheme, without the
O(N*E*C) one-hot of GShard: assignments are ranked within each expert by
a stable sort of the expert ids, those past the capacity
C = ceil(N*k/E * capacity_factor) (rounded up to a multiple of 8, at
least 8) are DROPPED -- their combine weight contributes nothing, the
residual stream carries the token -- and scatter and gather go through
a drop-sink row ``E * C``. The capacity depends on the token count N, so
a full-sequence pass (N = B*S) and a decode step (N = B) can drop
different tokens, as in the reference.

Routing runs in fp32. Ties are broken as the reference's
``jax.lax.top_k`` breaks them, toward the lower expert index: a stable
descending sort keeps equal probabilities in index order (``torch.topk``
leaves their order unspecified). The expert products stay batched
matrix products (the reference computes them outside any Pallas kernel);
the combine sums a token's k contributions in fp32 by ``index_add_``,
whose order on CUDA is unspecified -- a rounding-level difference.

Expert parallelism (``tp``, a ``models.tensor_parallel.TPGroup``): a rank
holds experts ``[s E/S, (s+1) E/S)`` -- ``models.sharding``'s cut of the
``("model", None, None)`` expert stacks -- and the whole router. Every
rank routes every token alike: the residual stream is replicated and the
capacity comes from the node's whole token count. A rank dispatches and
combines only the slots of its experts, a static (E/S * C, d) buffer
whatever the routing (so the ranks' collectives pair, and ``meta`` runs
count the buffer's FLOPs); its partial output -- its experts' combine,
plus the shared expert's row-parallel partial -- leaves the layer through
ONE all-reduce in the compute dtype (``reduce_from_model``). The expert
inputs and the combine weights pass ``copy_to_model``, so their gradients
sum over the ranks; the router's logits and the aux loss do not (every
rank holds them whole), so ``router/w``'s gradient is the same on every
rank and counts once.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import linear, normal_init, swiglu, swiglu_init
from repro_torch.models.tensor_parallel import TPGroup, copy_to_model, reduce_from_model

__all__ = ["moe_capacity", "moe_init", "moe_route", "routing_of", "moe_apply", "Routing"]


def moe_capacity(n_tokens: int, n_experts: int, k: int, factor: float) -> int:
    cap = int(-(-(n_tokens * k * factor) // n_experts))  # ceil
    # round to a lane-friendly multiple of 8 and keep >= k
    return max(8, ((cap + 7) // 8) * 8)


def moe_init(generator: Optional[torch.Generator], d_model: int, d_ff: int,
             n_experts: int, dtype=torch.float32, shared_expert: bool = False,
             device=None, lead=()) -> Dict:
    """The router (fp32 whatever ``dtype``), the experts' SwiGLU weights
    and, with ``shared_expert``, the shared expert; ``lead=(n,)`` draws a
    layer-stacked tree."""
    scale = d_model ** -0.5
    p = {
        "router": {"w": normal_init(generator, (*lead, d_model, n_experts), scale,
                                    torch.float32, device)},
        "gate": normal_init(generator, (*lead, n_experts, d_model, d_ff), scale, dtype,
                            device),
        "up": normal_init(generator, (*lead, n_experts, d_model, d_ff), scale, dtype,
                          device),
        "down": normal_init(generator, (*lead, n_experts, d_ff, d_model), d_ff ** -0.5,
                            dtype, device),
    }
    if shared_expert:
        p["shared"] = swiglu_init(generator, d_model, d_ff, dtype, device, lead)
    return p


class Routing(NamedTuple):
    """One batch's routing: the router's fp32 ``probs`` (N, E), each
    token's chosen experts ``top_e`` (N, k) and renormalized weights
    ``top_p``, then per assignment (token-major, N*k) its ``rank`` within
    its expert, ``keep`` (rank < capacity) and its buffer ``slot``
    (expert * capacity + rank, or the sink row E * capacity), and the
    load-balance ``aux`` loss."""

    probs: torch.Tensor
    top_p: torch.Tensor
    top_e: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    aux: torch.Tensor


def moe_route(router_w: torch.Tensor, xf: torch.Tensor, n_experts: int, k: int,
              cap: int) -> Routing:
    """Route tokens xf (N, d) with the router ``router_w`` (d, E) into a
    capacity of ``cap`` slots an expert."""
    probs = torch.softmax(xf.float() @ router_w, dim=-1)
    # a stable descending sort: equal probabilities keep the lower index first
    sorted_p, sorted_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return routing_of(probs, sorted_p[:, :k], sorted_idx[:, :k], n_experts, cap)


def routing_of(probs: torch.Tensor, top_p: torch.Tensor, top_e: torch.Tensor,
               n_experts: int, cap: int) -> Routing:
    """The :class:`Routing` of the chosen experts ``top_e`` (N, k), whose
    router probabilities are ``top_p``: the weights renormalized, each
    assignment's rank within its expert, ``keep`` and ``slot``, and the
    aux loss."""
    n, k = top_e.shape
    top_p = top_p / torch.sum(top_p, dim=-1, keepdim=True)  # renormalize

    # load-balance auxiliary loss (Switch / GShard)
    frac = torch.mean(F.one_hot(top_e[:, 0], n_experts).float(), dim=0)
    aux = n_experts * torch.sum(frac * torch.mean(probs, dim=0))

    # rank of each assignment within its expert (stable sort by expert id);
    # the reference's bincount as a scatter of ones (exact integer counts),
    # which on CUDA, unlike torch.bincount, does not wait for the card
    flat_e = top_e.reshape(-1)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = torch.zeros(n_experts, dtype=sorted_e.dtype, device=probs.device).index_add_(
        0, sorted_e, torch.ones_like(sorted_e))
    starts = torch.cumsum(counts, 0) - counts
    rank_sorted = torch.arange(n * k, device=probs.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted).scatter_(0, order, rank_sorted)
    keep = rank < cap
    slot = torch.where(keep, flat_e * cap + rank, torch.full_like(rank, n_experts * cap))
    return Routing(probs, top_p, top_e, rank, keep, slot, aux)


def moe_apply(p: Dict, x: torch.Tensor, *, n_experts: int, k: int,
              capacity_factor: float = 1.25, compute_dtype=torch.bfloat16,
              tp: Optional[TPGroup] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d) in ``compute_dtype``, fp32 aux loss).

    The aux loss is the load-balance term E * sum_e f_e * p_e, which the
    trainer scales by ``router_aux_coef``. ``tp``: the rank's experts of a
    model group (every rank returns the whole output)."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    cap = moe_capacity(n, n_experts, k, capacity_factor)
    r = moe_route(p["router"]["w"], xf, n_experts, k, cap)
    if tp is not None:
        return _experts_tp(p, xf, r, n_experts, cap, compute_dtype, tp).reshape(b, s, d), r.aux
    flat_tok = torch.arange(n, device=x.device).repeat_interleave(k)

    # dispatch: scatter tokens into the (E*C [+1 sink], d) buffer; the
    # sink row's duplicate writes are discarded with it
    buf = torch.zeros(n_experts * cap + 1, d, dtype=compute_dtype, device=x.device)
    buf = buf.index_put((r.slot,), xf[flat_tok].to(compute_dtype))
    buf = buf[: n_experts * cap].reshape(n_experts, cap, d)

    # the experts' SwiGLU, batched over E
    g = torch.bmm(buf, p["gate"].to(compute_dtype))
    u = torch.bmm(buf, p["up"].to(compute_dtype))
    y = torch.bmm(F.silu(g) * u, p["down"].to(compute_dtype))

    # combine: gather back through the zero sink row and weight, in fp32
    y_flat = torch.cat([y.reshape(n_experts * cap, d), y.new_zeros(1, d)])
    contrib = y_flat[r.slot] * r.top_p.reshape(-1, 1).to(y.dtype)
    out = torch.zeros(n, d, dtype=torch.float32, device=x.device)
    out = out.index_add(0, flat_tok, contrib.float()).to(compute_dtype)

    if "shared" in p:
        out = out + swiglu(p["shared"], xf, compute_dtype)
    return out.reshape(b, s, d), r.aux


def _experts_tp(p: Dict, xf: torch.Tensor, r: Routing, n_experts: int, cap: int,
                compute_dtype, tp: TPGroup) -> torch.Tensor:
    """The routed experts (and the shared one) on the rank's experts
    ``p["gate"]`` (E/S, d, f): each slot of the rank's span of the
    (E * C) buffer takes its token (an empty slot, a zero row) and its
    combine weight, the experts run on the (E/S, C, d) buffer, and the
    weighted rows go back to their tokens in fp32; the partial output
    (N, d), all-reduced over the model group."""
    n, d = xf.shape
    local = p["gate"].shape[0]
    if local * tp.size != n_experts:
        raise ValueError(f"{local} experts a rank over {tp.size} ranks is not the "
                         f"config's {n_experts}")
    lo, span = tp.rank * local * cap, local * cap
    tok = torch.arange(n, device=xf.device).repeat_interleave(r.top_e.shape[1])
    # the whole buffer's slots (and the sink's, dropped) -> token, weight;
    # a kept assignment owns its slot alone
    slot_tok = torch.full((n_experts * cap + 1,), n, dtype=tok.dtype,
                          device=xf.device).scatter(0, r.slot, tok)[lo:lo + span]
    w = copy_to_model(r.top_p, tp).reshape(-1)
    slot_w = w.new_zeros(n_experts * cap + 1).scatter(0, r.slot, w)[lo:lo + span]
    xs = copy_to_model(xf, tp)
    buf = xs[slot_tok.clamp(max=n - 1)].masked_fill((slot_tok == n)[:, None], 0)
    buf = buf.to(compute_dtype).reshape(local, cap, d)
    g = torch.bmm(buf, p["gate"].to(compute_dtype))
    u = torch.bmm(buf, p["up"].to(compute_dtype))
    y = torch.bmm(F.silu(g) * u, p["down"].to(compute_dtype)).reshape(span, d)
    part = torch.zeros(n + 1, d, dtype=torch.float32, device=xf.device).index_add(
        0, slot_tok, (y * slot_w[:, None].to(y.dtype)).float())[:n]
    if "shared" in p:  # gate / up column-parallel, down's partial sum
        sh = p["shared"]
        hs = F.silu(linear(sh["gate"], xs, compute_dtype)) * linear(sh["up"], xs, compute_dtype)
        part = part + linear(sh["down"], hs, compute_dtype).float()
    return reduce_from_model(part.to(compute_dtype), tp)
