"""One-round-staleness convergence experiment on the PyTorch port
(counterpart of the reference's ``benchmarks/staleness_ehr.py``).

What the pipelined schedule's one-round-stale mix costs in model quality
on the paper's 20-hospital cohort: FD-DSGT on the ``fused`` engine,
sequential against pipelined, at Q in {1, 4, 16} local steps per
communication round, on an equal ITERATION budget (every cell takes the
same number of gradient steps). On the card every round is one
``fused_round_gt`` launch (the pipelined one with ``stale_mix``).

  PYTHONPATH=src python -m repro_torch.benchmarks.staleness_ehr [--rounds-at-q1 320] \\
      [--out experiments/staleness_ehr_torch.json] [--device cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from repro_torch.benchmarks.ehr_cells import run_ehr_cell

__all__ = ["Q_VALUES", "SCHEDULES", "SMOKE_ROUNDS_AT_Q1", "run_cell", "run", "main"]

Q_VALUES = (1, 4, 16)
SCHEDULES = ("sequential", "pipelined")
#: ``--smoke``: the iteration budget of a quick check of every cell
SMOKE_ROUNDS_AT_Q1 = 16


def run_cell(q: int, schedule: str, rounds: int, seed: int = 0, device=None,
             init_params: Optional[Dict] = None) -> dict:
    """One (Q, schedule) cell: FD-DSGT, fused engine, hospital graph."""
    out = run_ehr_cell(q, rounds, round_schedule=schedule, seed=seed, device=device,
                       init_params=init_params)
    return {
        "q": q,
        "schedule": schedule,
        "rounds": rounds,
        "iterations": out["iterations"],
        "bal_acc": out["bal_acc"],
        "final_loss": out["final_loss"],
        "consensus_err": out["consensus_err"],
    }


def run(rounds_at_q1: int = 320, device=None, init_params: Optional[Dict] = None,
        log: bool = True) -> Dict:
    """Every cell at ``rounds_at_q1 // Q`` rounds; returns the record the
    JSON holds (cells and per-Q summary)."""
    cells = []
    for q in Q_VALUES:
        rounds = max(1, rounds_at_q1 // q)
        for schedule in SCHEDULES:
            cell = run_cell(q, schedule, rounds, device=device, init_params=init_params)
            cells.append(cell)
            if log:
                print(f"Q={q:2d} {schedule:10s} rounds={rounds:4d} "
                      f"bal_acc={cell['bal_acc']:.3f} "
                      f"cons_err={cell['consensus_err']:.2e}", flush=True)
    by_q = {}
    for q in Q_VALUES:
        seq = next(c for c in cells if c["q"] == q and c["schedule"] == "sequential")
        pipe = next(c for c in cells if c["q"] == q and c["schedule"] == "pipelined")
        by_q[str(q)] = {
            "bal_acc_sequential": seq["bal_acc"],
            "bal_acc_pipelined": pipe["bal_acc"],
            "bal_acc_delta": seq["bal_acc"] - pipe["bal_acc"],
            "consensus_err_ratio": pipe["consensus_err"] / max(seq["consensus_err"], 1e-12),
        }
        if log:
            print(f"Q={q:2d} staleness cost: {by_q[str(q)]['bal_acc_delta']:+.4f} "
                  "balanced accuracy", flush=True)
    return {
        "experiment": "one_round_staleness_ehr",
        "cohort": "hospital20 (2103 AD / 7919 MCI, 42 features)",
        "algorithm": "dsgt (fused engine, int8 wire, class-weighted loss)",
        "alpha": "0.02/sqrt(r)",
        "rounds_at_q1": rounds_at_q1,
        "note": "equal iteration budget per cell; pipelined = "
                "sequential-with-one-round-delay",
        "cells": cells,
        "summary": by_q,
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds-at-q1", type=int, default=320,
                    help="comm rounds at Q=1; Q>1 cells run rounds/Q so "
                         "every cell sees the same iteration budget")
    ap.add_argument("--out", default="experiments/staleness_ehr_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"quick run at --rounds-at-q1 {SMOKE_ROUNDS_AT_Q1}: "
                         "every cell and the JSON schema, numbers not "
                         "representative")
    args = ap.parse_args(argv)
    record = run(SMOKE_ROUNDS_AT_Q1 if args.smoke else args.rounds_at_q1,
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
