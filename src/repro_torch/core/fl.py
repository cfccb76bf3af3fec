"""Fully decentralized federated learning: DSGD / DSGT with Q local steps
(counterpart of ``repro.core.fl``).

State is **node-stacked**: every parameter tensor carries a leading
``nodes`` axis. Mixing and the wire live behind the engine
(:mod:`repro_torch.core.engine`); ``make_fl_round`` builds one round
function for whichever engine it is handed:

* ``tree``  -- the parameter tree itself, mixed by the dense-W backend of
  ``core.mixing`` (the paper's Fig. 2 runs);
* ``flat``  -- the state packed into one ``(nodes, total)`` buffer
  (``core.packing``), mixed by one product per round;
* ``fused`` -- the flat buffer with the round megakernel: local update +
  int8 quantize + W mix + error feedback in one kernel call.

Update equations (r is the global iteration counter, 1-indexed):

  local (Eq. 4):  theta_i <- theta_i - alpha^r * grad g_i(theta_i)

The exact-wire engines (tree, flat) mix, then adapt, as the paper's
Eqs. 2/3 are written:

  DSGD (Eq. 2):  theta_i <- sum_j W_ij theta_j - alpha^r * g_i
  DSGT (Eq. 3):  vtheta_i <- sum_j W_ij vtheta_j + (g_new - g_prev)
                 theta_i  <- sum_j W_ij theta_j - alpha^r * vtheta_i

The fused engine adapts, then combines, so the round kernel quantizes
exactly what goes on the wire:

  DSGD:  theta_i <- sum_j W_ij Q[theta_j - alpha^r g_j]
  DSGT:  vtheta_half = vtheta + (g_new - g_prev)
         vtheta <- sum_j W_ij Q[vtheta_half_j]
         theta  <- sum_j W_ij Q[theta_j - alpha^r vtheta_half_j]

with Q[.] the difference-coded int8 quantizer with error feedback.
``g_prev`` is the gradient of the previous communication round, so the
gradient-tracking invariant mean_i vtheta_i == mean_i g_i holds at every
communication round for any doubly-stochastic W (exactly up to fp32
rounding on the exact wire, up to the error-feedback-corrected
quantization drift on the int8 wire).
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
    "check_node_stacked",
    "make_fl_round",
    "consensus_params",
    "tree_map",
    "value_and_grad",
]


def tree_map(f, *trees) -> Tree:
    """Apply ``f`` leafwise over dict trees of the same structure."""
    items = [tree_leaves(t) for t in trees]
    paths = [p for p, _ in items[0]]
    return tree_unflatten(tuple(paths), [f(*(v for _, v in leaves))
                                         for leaves in zip(*items)])


class FLState(NamedTuple):
    """Node-stacked optimizer state: ``params`` is the engine's state
    representation (the tree, or the packed flat buffer), and
    ``tracker``/``prev_grad`` share it; they are None for DSGD. ``comm``
    is None on the exact-wire engines (tree, flat) and holds the fused
    engine's int8 wire state (``engine.comm_keys``): ``{"recon", "residual"}`` (n, total) fp32 for
    the parameter wire and ``{"recon_t", "residual_t"}`` for DSGT's
    tracker wire; at staleness depth k >= 2 also the in-flight ring
    ``{"wire_q", "wire_scales"}`` (and ``_t``): int8 (n, k-1, total)
    payloads and their fp32 scales. A dynamic topology or node program
    adds its counters on the device (``topo_round``, ``topo_key``,
    ``topo_up``, ``node_key``), on the exact-wire engines too. ``step``
    is the global iteration counter r, a host int (local steps count
    too)."""

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


def init_fl_state(cfg: FLConfig, stacked_params: Tree, engine=None) -> FLState:
    """Initial state. ``engine`` (the engine the state will train with)
    validates its representation (the flat and fused engines want the
    packed ``(nodes, total)`` buffer) and contributes its zero-initialized
    wire state; ``engine=None`` only checks the node stacking, for the
    exact-wire engines. DSGT's tracker and ``prev_grad`` start at zero in
    the state's own dtype (the engine's storage dtype: bf16 under bf16
    flat storage), so the first comm round's ``g_new - g_prev`` loads the
    first gradient into the tracker."""
    comm = None
    if engine is not None:
        engine.check_params(cfg, stacked_params)
        comm = engine.init_comm_state(cfg, stacked_params)
    else:
        check_node_stacked(cfg, stacked_params)
    if cfg.algorithm == "dsgt":
        zeros = tree_map(torch.zeros_like, stacked_params)
        return FLState(0, stacked_params, zeros,
                       tree_map(torch.zeros_like, stacked_params), comm)
    return FLState(0, stacked_params, None, None, comm)


def check_node_stacked(cfg: FLConfig, params: Tree) -> None:
    """Every leaf of a non-empty tree carries the leading nodes axis."""
    leaves = tree_leaves(params)
    if not leaves:
        raise ValueError("empty parameter tree")
    for _, leaf in leaves:
        if tuple(leaf.shape[:1]) != (cfg.n_nodes,):
            raise ValueError(
                f"param leaf {tuple(leaf.shape)} is not node-stacked for "
                f"n={cfg.n_nodes}"
            )


def consensus_params(state: FLState) -> Tree:
    """theta_bar = (1/N) sum_i theta_i -- the model you deploy/serve."""
    return tree_map(lambda p: p.mean(dim=0), state.params)


def value_and_grad(loss_fn: LossFn):
    """``grad_fn(params, batch) -> (losses (n,), grads)`` on node-stacked
    trees: nodes never interact in ``loss_fn``, so autograd of the summed
    per-node losses gives each node its own gradient (the reference vmaps
    ``jax.value_and_grad`` instead). A leaf the loss does not reach gets
    a zero gradient."""

    def grad_fn(params: Tree, batch) -> Tuple[torch.Tensor, Tree]:
        items = tree_leaves(params)
        paths = tuple(p for p, _ in items)
        leaves = [l.detach().requires_grad_(True) for _, l in items]
        with torch.enable_grad():
            losses = loss_fn(tree_unflatten(paths, leaves), batch)
            grads = torch.autograd.grad(losses.sum(), leaves, allow_unused=True)
        grads = [torch.zeros_like(l) if g is None else g
                 for l, g in zip(leaves, grads)]
        return losses.detach(), tree_unflatten(paths, grads)

    return grad_fn


def make_fl_round(loss_fn: LossFn, schedule, cfg: FLConfig, engine):
    """Build one *communication round*: (Q-1) local steps + 1 comm step.

    ``loss_fn`` is node-batched (see :data:`LossFn`); its gradients come
    from :func:`value_and_grad`.
    ``schedule`` maps the iteration counter to an fp32 alpha; ``engine``
    owns the state representation, the wire and the mixing, and its
    ``round_schedule`` lays the round out in time.

    Returns ``round_fn(state, batches) -> (state, metrics)``, where each
    ``batches`` leaf is (Q, nodes, ...) -- numpy or tensors; they are
    moved to the engine's device once per round. Metrics: mean loss,
    ``grad_norm_sq`` ||mean_i grad_i||^2, ``consensus_err`` (1/N) sum_i
    ||theta_i - theta_bar||^2, ``comm_rounds`` (1), ``alpha``,
    ``local_loss``, and the fused engine's wire metrics (``wire_bytes``,
    summed egress of all nodes, and ``ef_residual_rms``). Under the
    engine's topology / node programs also the realized
    ``edge_fraction``, ``payload_fraction`` and ``compute_fraction``.
    """
    eval_grads = engine.make_eval_grads(value_and_grad(loss_fn))

    def local_step(state: FLState, batch, mask=None) -> Tuple[FLState, torch.Tensor]:
        step = state.step + 1
        alpha = schedule(step)
        losses, grads = eval_grads(state.params, batch)
        params = engine.local_step(state.params, grads, alpha, mask)
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
