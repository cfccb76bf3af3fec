"""Fully decentralized federated learning: DSGD / DSGT with Q local steps
(counterpart of ``repro.core.fl``).

State is **node-stacked**: every parameter tensor carries a leading
``nodes`` axis. Mixing and the wire live behind the engine
(:mod:`repro_torch.core.engine`); ``make_fl_round`` builds one round
function for whichever engine it is handed.

Update equations (r is the global iteration counter, 1-indexed):

  local (Eq. 4):  theta_i <- theta_i - alpha^r * grad g_i(theta_i)

The fused engine's communication step uses the adapt-then-combine
ordering, so the round kernel quantizes exactly what goes on the wire:

  DSGD:  theta_i <- sum_j W_ij Q[theta_j - alpha^r g_j]
  DSGT:  vtheta_half = vtheta + (g_new - g_prev)
         vtheta <- sum_j W_ij Q[vtheta_half_j]
         theta  <- sum_j W_ij Q[theta_j - alpha^r vtheta_half_j]

with Q[.] the difference-coded int8 quantizer with error feedback.
``g_prev`` is the gradient of the previous communication round, so the
gradient-tracking invariant mean_i vtheta_i == mean_i g_i holds at every
communication round for any doubly-stochastic W, up to the
error-feedback-corrected quantization drift.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.core.packing import tree_leaves, tree_unflatten

Tree = Any
#: node-batched loss: (params with (n, ...) leaves, batch with (n, ...)
#: leaves) -> (n,) per-node losses
LossFn = Callable[[Tree, Dict[str, torch.Tensor]], torch.Tensor]

__all__ = [
    "FLState",
    "FLConfig",
    "init_fl_state",
    "make_fl_round",
    "consensus_params",
    "tree_map",
]


def tree_map(f, *trees) -> Tree:
    """Apply ``f`` leafwise over dict trees of the same structure."""
    items = [tree_leaves(t) for t in trees]
    paths = [p for p, _ in items[0]]
    return tree_unflatten(tuple(paths), [f(*(v for _, v in leaves))
                                         for leaves in zip(*items)])


class FLState(NamedTuple):
    """Node-stacked optimizer state. ``tracker``/``prev_grad`` are None for
    DSGD. ``comm`` holds the fused engine's int8 wire state
    (``engine.comm_keys``): ``{"recon", "residual"}`` (n, total) fp32 for
    the parameter wire and ``{"recon_t", "residual_t"}`` for DSGT's
    tracker wire; at staleness depth k >= 2 also the in-flight ring
    ``{"wire_q", "wire_scales"}`` (and ``_t``): int8 (n, k-1, total)
    payloads and their fp32 scales. ``step`` is the global iteration
    counter r, a host int (local steps count too)."""

    step: int
    params: Tree
    tracker: Optional[Tree]
    prev_grad: Optional[Tree]
    comm: Optional[Dict[str, torch.Tensor]] = None


@dataclasses.dataclass(frozen=True)
class FLConfig:
    algorithm: str = "dsgt"  # "dsgd" | "dsgt"
    q: int = 1  # local steps per communication round (Q in Alg. 1)
    n_nodes: int = 1

    def __post_init__(self) -> None:
        if self.algorithm not in ("dsgd", "dsgt"):
            raise ValueError(f"unknown algorithm {self.algorithm!r}")
        if self.q < 1:
            raise ValueError("q must be >= 1")
        if self.n_nodes < 1:
            raise ValueError("n_nodes must be >= 1")


def init_fl_state(cfg: FLConfig, stacked_params: Tree, engine) -> FLState:
    """Initial state for ``engine``: the engine validates its
    representation (the fused engine wants the packed ``(nodes, total)``
    buffer) and contributes its zero-initialized wire state. DSGT's
    tracker and ``prev_grad`` start at zero, so the first comm round's
    ``g_new - g_prev`` loads the first gradient into the tracker."""
    engine.check_params(cfg, stacked_params)
    comm = engine.init_comm_state(cfg, stacked_params)
    if cfg.algorithm == "dsgt":
        zeros = tree_map(torch.zeros_like, stacked_params)
        return FLState(0, stacked_params, zeros,
                       tree_map(torch.zeros_like, stacked_params), comm)
    return FLState(0, stacked_params, None, None, comm)


def consensus_params(state: FLState) -> Tree:
    """theta_bar = (1/N) sum_i theta_i -- the model you deploy/serve."""
    return tree_map(lambda p: p.mean(dim=0), state.params)


def make_fl_round(loss_fn: LossFn, schedule, cfg: FLConfig, engine):
    """Build one *communication round*: (Q-1) local steps + 1 comm step.

    ``loss_fn`` is node-batched (see :data:`LossFn`); nodes never
    interact in it, so autograd of the summed losses gives each node its
    own gradient (the reference vmaps ``jax.value_and_grad`` instead).
    ``schedule`` maps the iteration counter to an fp32 alpha; ``engine``
    owns the state representation, the wire and the mixing, and its
    ``round_schedule`` lays the round out in time.

    Returns ``round_fn(state, batches) -> (state, metrics)``, where each
    ``batches`` leaf is (Q, nodes, ...) -- numpy or tensors; they are
    moved to the engine's device once per round. Metrics: mean loss,
    ``grad_norm_sq`` ||mean_i grad_i||^2, ``consensus_err`` (1/N) sum_i
    ||theta_i - theta_bar||^2, ``comm_rounds`` (1), ``alpha``,
    ``local_loss``, and the engine's wire metrics (``wire_bytes``, summed
    egress of all nodes, and ``ef_residual_rms``).
    """
    eval_grads = engine.make_eval_grads(loss_fn)

    def local_step(state: FLState, batch) -> Tuple[FLState, torch.Tensor]:
        step = state.step + 1
        alpha = schedule(step)
        losses, grads = eval_grads(state.params, batch)
        params = engine.local_step(state.params, grads, alpha)
        return state._replace(step=step, params=params), losses.mean()

    return engine.round_schedule.build_round(engine, eval_grads, schedule,
                                             cfg, local_step)


def _mean_grad_norm_sq(stacked_grads: Tree) -> torch.Tensor:
    """|| (1/N) sum_i grad_i ||^2 -- the first term of Theorem 1's LHS."""
    sq = 0.0
    for _, g in tree_leaves(stacked_grads):
        mean_g = g.float().mean(dim=0)
        sq = sq + (mean_g * mean_g).sum()
    return sq


def _consensus_error(stacked_params: Tree) -> torch.Tensor:
    """(1/N) sum_i ||theta_i - theta_bar||^2 -- Theorem 1's second term."""
    err = 0.0
    for _, p in tree_leaves(stacked_params):
        pf = p.float()
        dev = pf - pf.mean(dim=0, keepdim=True)
        err = err + (dev * dev).sum() / pf.shape[0]
    return err
