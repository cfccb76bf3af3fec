"""Node-churn robustness experiment on the PyTorch port (counterpart of
the reference's ``benchmarks/churn_ehr.py``).

What a time-varying graph costs in model quality on the paper's
20-hospital cohort: FD-DSGT on the ``fused`` engine under the
``node_churn`` topology program at several downtime fractions (each
hospital offline with probability ``p_down`` in outages of
``mean_downtime`` rounds, its mixing weight folded into its self-loop
while it keeps taking local steps), against the static graph on an equal
budget, plus an ``edge_failure`` cell at the matched expected edge loss.
On the card every round is one ``fused_round_gt`` launch against that
round's realized W.

  PYTHONPATH=src python -m repro_torch.benchmarks.churn_ehr [--rounds 120] [--q 10] \\
      [--out experiments/churn_ehr_torch.json] [--device cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from repro_torch.benchmarks.ehr_cells import run_ehr_cell

__all__ = ["DOWNTIME_FRACTIONS", "MEAN_DOWNTIME", "SMOKE_ROUNDS", "churn_program",
           "matched_edge_failure", "run_cell", "run", "main"]

#: downtime fractions swept (0.0 == the static graph baseline)
DOWNTIME_FRACTIONS = (0.0, 0.1, 0.25, 0.5)
MEAN_DOWNTIME = 5  # rounds per outage block
#: ``--smoke``: rounds a cell
SMOKE_ROUNDS = 6


def churn_program(p_down: float):
    """The sweep's topology program at ``p_down`` (None: the static
    graph)."""
    if p_down == 0.0:
        return None
    return f"node_churn:p_down={p_down},mean_downtime={MEAN_DOWNTIME},seed=0"


def matched_edge_failure() -> str:
    """The link-flap program at the matched expected edge loss: a
    node-churn fraction p isolates an edge with probability 1-(1-p)^2, at
    the sweep's middle point."""
    p_mid = DOWNTIME_FRACTIONS[2]
    return f"edge_failure:p={round(1.0 - (1.0 - p_mid) ** 2, 4)},seed=0"


def run_cell(program, rounds: int, q: int, seed: int = 0, device=None,
             init_params: Optional[Dict] = None) -> dict:
    """One program cell: FD-DSGT, fused engine, hospital graph."""
    out = run_ehr_cell(q, rounds, topology_program=program, seed=seed,
                       device=device, init_params=init_params)
    return {
        "program": out["engine"].topology_program.spec(),
        "rounds": rounds,
        "q": q,
        "iterations": out["iterations"],
        "bal_acc": out["bal_acc"],
        "final_loss": out["final_loss"],
        "consensus_err": out["consensus_err"],
        "mean_edge_fraction": out["mean_edge_fraction"],
    }


def run(rounds: int = 120, q: int = 10, device=None,
        init_params: Optional[Dict] = None, log: bool = True) -> Dict:
    """The sweep and the matched link-flap cell; returns the record the
    JSON holds."""
    cells = []
    for p_down in DOWNTIME_FRACTIONS:
        cell = run_cell(churn_program(p_down), rounds, q, device=device,
                        init_params=init_params)
        cell["p_down"] = p_down
        cells.append(cell)
        if log:
            print(f"p_down={p_down:4.2f} edges_up~{cell['mean_edge_fraction']:.2f} "
                  f"bal_acc={cell['bal_acc']:.3f} "
                  f"cons_err={cell['consensus_err']:.2e}", flush=True)
    flap = run_cell(matched_edge_failure(), rounds, q, device=device,
                    init_params=init_params)
    flap["p_down"] = None
    flap["matched_to_p_down"] = DOWNTIME_FRACTIONS[2]
    cells.append(flap)
    if log:
        print(f"{flap['program']} (matched to p_down={DOWNTIME_FRACTIONS[2]}) "
              f"bal_acc={flap['bal_acc']:.3f}", flush=True)
    static_acc = cells[0]["bal_acc"]
    return {
        "experiment": "node_churn_ehr",
        "cohort": "hospital20 (2103 AD / 7919 MCI, 42 features)",
        "algorithm": "dsgt (fused engine, int8 wire, class-weighted loss)",
        "alpha": "0.02/sqrt(r)",
        "mean_downtime_rounds": MEAN_DOWNTIME,
        "note": "equal iteration budget per cell; node_churn masks all of a "
                "down hospital's links for persistent blocks, edge_failure "
                "flaps links i.i.d. per round at the matched edge loss",
        "cells": cells,
        "summary": {
            str(c["p_down"]): {"bal_acc": c["bal_acc"],
                               "bal_acc_delta_vs_static": c["bal_acc"] - static_acc}
            for c in cells if c["p_down"] is not None
        },
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=120,
                    help="comm rounds per cell (equal budget everywhere)")
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--out", default="experiments/churn_ehr_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_ROUNDS} rounds a cell: every cell and the "
                         "JSON schema, numbers not representative")
    args = ap.parse_args(argv)
    record = run(SMOKE_ROUNDS if args.smoke else args.rounds, args.q,
                 device=args.device)
    record.update(smoke=bool(args.smoke), device=args.device)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
