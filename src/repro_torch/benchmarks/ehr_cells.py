"""One cell of the EHR round-axis experiments (the staleness, churn,
straggler, privacy and personalization drivers): FD-DSGT on the
``fused`` engine over the paper's 20-hospital cohort and graph (or its
hardened variant), m = 20, the class-weighted loss, alpha =
alpha0/sqrt(r), under one round schedule, topology program, node
program, privacy spec and federation scope. The reference's drivers each
repeat this body; the port keeps it once."""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.ehr_mlp import class_weights
from repro_torch.core.engine import get_engine
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round, tree_map
from repro_torch.core.schedules import inv_sqrt, robust_alpha_scale, scaled
from repro_torch.core.topology import mixing_matrix
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher
from repro_torch.device import resolve_device
from repro_torch.models.mlp import make_mlp_loss, mlp_balanced_accuracy, mlp_init
from repro_torch.training.trainer import stack_batches, stack_for_nodes

__all__ = ["FRACTIONS", "run_ehr_cell"]

#: the per-round fractions a dynamic round reports, averaged over the cell
FRACTIONS = ("edge_fraction", "payload_fraction", "compute_fraction")


def run_ehr_cell(q: int, rounds: int, *, round_schedule: str = "sequential",
                 topology_program: Optional[str] = None,
                 node_program: Optional[str] = None, privacy: Optional[str] = None,
                 scope: Optional[str] = None, scale_chunk: int = 512,
                 alpha0: float = 0.02, robust_alpha: bool = False,
                 cohort: Optional[Dict[str, float]] = None, seed: int = 0, device=None,
                 init_params: Optional[Dict] = None) -> Dict:
    """Train one cell for ``rounds`` communication rounds of ``q`` local
    steps on ``device`` (``cuda`` unless given). ``init_params``: one
    node's starting weights (a tree of tensors or arrays), default
    ``mlp_init(seed)``; tests pass the reference's init. ``robust_alpha``
    scales alpha by ``robust_alpha_scale(uptime, depth)``, the uptime the
    topology program's times the node program's. ``cohort``: the hardened
    cohort's knobs (``label_shift``, ``minority_concentration``,
    ``conditional_shift`` of ``generate_ehr_cohort``); ``scale_chunk``
    pads the flat buffer and sets the wire's scale chunk.

    Returns the engine, the last round's ``metrics`` and the cell's
    numbers: ``iterations``, ``bal_acc`` of the consensus model on the
    whole cohort, ``final_loss`` and ``consensus_err`` of the last round,
    and the mean
    over the rounds of each realized fraction (``mean_edge_fraction``,
    ``mean_payload_fraction``, ``mean_compute_fraction``; 1.0 where the
    round reports none). The fractions are read back once, at the end.
    And each hospital's balanced accuracy on its own patients, of its own
    row (under a partial scope the gossiped backbone with its private
    head; ``bal_acc_per_hospital``) and of the consensus model
    (``bal_acc_consensus_per_hospital``)."""
    dev = resolve_device(device)
    n = 20
    data = generate_ehr_cohort(seed=seed, **(cohort or {}))
    w = mixing_matrix("hospital20", n)
    batcher = make_node_batcher(data, m=20, seed=seed + 1)
    single = mlp_init(seed, device=dev) if init_params is None else tree_map(
        lambda p: torch.as_tensor(np.asarray(p), device=dev), init_params)
    cfg = FLConfig(algorithm="dsgt", q=q, n_nodes=n)
    engine, flat = get_engine("fused").simulated(
        w, stack_for_nodes(single, n), scale_chunk=scale_chunk,
        round_schedule=round_schedule, topology_program=topology_program,
        node_program=node_program, privacy=privacy, scope=scope)
    sched = inv_sqrt(alpha0)
    if robust_alpha:
        uptime = (engine.topology_program.expected_uptime()
                  * engine.node_program.expected_uptime())
        sched = scaled(sched, robust_alpha_scale(uptime, engine.round_schedule.depth))
    round_fn = make_fl_round(make_mlp_loss(class_weights("balanced")), sched, cfg,
                             engine)
    state = init_fl_state(cfg, flat, engine)
    m: Dict = {}
    seen: Dict[str, list] = {k: [] for k in FRACTIONS}
    for _ in range(rounds):
        state, m = round_fn(state, stack_batches(batcher, q))
        for k in FRACTIONS:
            if k in m:
                seen[k].append(m[k])
    view = engine.params_view(state.params)
    consensus = tree_map(lambda p: p.mean(dim=0), view)
    xall = torch.as_tensor(np.concatenate(data.features), device=dev)
    yall = torch.as_tensor(np.concatenate(data.labels), device=dev)
    out = {
        "engine": engine,
        "metrics": m,
        "iterations": int(state.step),
        "bal_acc": float(mlp_balanced_accuracy(consensus, xall, yall)),
        "final_loss": float(m["loss"]),
        "consensus_err": float(m["consensus_err"]),
    }
    for k, vals in seen.items():
        out[f"mean_{k}"] = (float(np.mean(torch.stack(vals).tolist()))
                            if vals else 1.0)
    own, cons = [], []
    for i in range(n):
        x_i = torch.as_tensor(data.features[i], device=dev)
        y_i = torch.as_tensor(data.labels[i], device=dev)
        own.append(float(mlp_balanced_accuracy(tree_map(lambda p, i=i: p[i], view), x_i, y_i)))
        cons.append(float(mlp_balanced_accuracy(consensus, x_i, y_i)))
    out["bal_acc_per_hospital"] = own
    out["bal_acc_consensus_per_hospital"] = cons
    return out
