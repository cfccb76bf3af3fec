"""End-to-end decentralized-FL training driver (counterpart of
``repro.training.trainer``, the fused-engine path).

Runs the paper's Algorithm 1 on one device: nodes live on the leading
tensor axis, and every communication round is one round-megakernel call
of the registry engine (``fused``, the only one ported so far) on the
sequential round schedule.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator

import numpy as np
import torch

from repro_torch.configs.base import FLRunConfig
from repro_torch.core.engine import GossipEngine, get_engine
from repro_torch.core.fl import FLConfig, FLState, init_fl_state, make_fl_round, tree_map
from repro_torch.core.packing import tree_leaves
from repro_torch.core.schedules import constant, inv_sqrt
from repro_torch.core.topology import check_assumption1, mixing_matrix
from repro_torch.device import resolve_device
from repro_torch.training.metrics import MetricHistory

Tree = Any

__all__ = ["TrainResult", "train_decentralized", "make_schedule",
           "stack_for_nodes", "stack_batches"]


@dataclasses.dataclass
class TrainResult:
    state: FLState
    history: MetricHistory
    consensus: Tree
    w: np.ndarray
    engine: GossipEngine = None  # the engine the run trained with


def make_schedule(run: FLRunConfig):
    if run.schedule == "inv_sqrt":
        return inv_sqrt(run.alpha0)
    if run.schedule == "constant":
        return constant(run.alpha0)
    raise ValueError(f"unknown or unported schedule {run.schedule!r}")


def stack_for_nodes(params: Tree, n_nodes: int) -> Tree:
    """Replicate one node's params across the node axis (identical init)."""
    return tree_map(
        lambda p: p.unsqueeze(0).expand((n_nodes,) + tuple(p.shape)).clone(),
        params,
    )


def stack_batches(step_batches: Iterator[Dict[str, np.ndarray]], q: int
                  ) -> Dict[str, np.ndarray]:
    """Draw Q per-step batches and stack them to one round's (Q, ...)."""
    qs = [next(step_batches) for _ in range(q)]
    return {k: np.stack([b[k] for b in qs]) for k in qs[0]}


def train_decentralized(
    loss_fn: Callable[[Tree, Dict], torch.Tensor],
    params_single: Tree,
    run: FLRunConfig,
    step_batches: Iterator[Dict[str, np.ndarray]],
    rounds: int,
    engine: str = "fused",
    scale_chunk: int = 512,
    device=None,
) -> TrainResult:
    """Train for ``rounds`` communication rounds on ``device`` (``cuda``
    unless given; raises without a card).

    ``loss_fn`` is node-batched (``core.fl.LossFn``); ``params_single``
    one node's parameters (replicated to every node) or an already
    node-stacked tree. ``step_batches`` yields PER-STEP node-stacked
    numpy batches; the driver groups Q of them per round (paper: Q local
    updates, then one communication). ``engine`` is a registry name,
    built with its ``simulated`` constructor against the run topology's W;
    ``scale_chunk`` sets the fused engine's int8 scale chunk.
    """
    dev = resolve_device(device)
    w = mixing_matrix(run.topology, run.n_nodes)
    check_assumption1(w)
    cfg = FLConfig(algorithm=run.algorithm, q=run.q, n_nodes=run.n_nodes)
    params = tree_map(lambda p: torch.as_tensor(p, device=dev), params_single)
    stacked = params if _is_stacked(params, run.n_nodes) else stack_for_nodes(
        params, run.n_nodes)
    engine, params0 = get_engine(engine).simulated(w, stacked, scale_chunk=scale_chunk)
    round_fn = make_fl_round(loss_fn, make_schedule(run), cfg, engine)
    state = init_fl_state(cfg, params0, engine)

    history = MetricHistory()
    t0 = time.time()
    cum_bytes = 0.0
    for rnd in range(1, rounds + 1):
        state, m = round_fn(state, stack_batches(step_batches, run.q))
        cum_bytes += float(m["wire_bytes"])
        history.append(
            round=rnd,
            iteration=state.step,
            comm_rounds=rnd,
            comm_bytes=cum_bytes,
            loss=float(m["loss"]),
            local_loss=float(m["local_loss"]),
            grad_norm_sq=float(m["grad_norm_sq"]),
            consensus_err=float(m["consensus_err"]),
            alpha=float(m["alpha"]),
            wall_s=time.time() - t0,
        )
    return TrainResult(state=state, history=history,
                       consensus=_consensus(engine, state), w=w, engine=engine)


def _consensus(engine: GossipEngine, state: FLState) -> Tree:
    """theta_bar on the TREE view, whatever the engine's representation."""
    return tree_map(lambda p: p.mean(dim=0), engine.params_view(state.params))


def _is_stacked(params: Tree, n_nodes: int) -> bool:
    leaves = [l for _, l in tree_leaves(params)]
    return bool(leaves) and all(l.ndim >= 1 and l.shape[0] == n_nodes for l in leaves)
