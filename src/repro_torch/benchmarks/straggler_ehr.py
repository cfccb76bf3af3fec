"""Straggler-tolerance experiment on the PyTorch port (counterpart of the
reference's ``benchmarks/straggler_ehr.py``).

The staleness-depth x straggler-fraction frontier in model quality on the
paper's 20-hospital cohort: FD-DSGT on the ``fused`` engine under
``bounded_staleness:k=K`` (K payloads in flight, the mix K rounds stale)
with the ``stragglers`` node program (each round a random ``frac`` of
hospitals is slow: it runs half its local steps and its payload misses
the round, the lost mixing weight folded into the self-loops), plus the
step-size controller (``schedules.robust_alpha_scale``) on the harshest
cell. On the card a round is one ``fused_round_gt`` launch at k <= 1 and
one ``wire_stage_gt`` launch (then the PyTorch mix against that round's
W) at k >= 2.

  PYTHONPATH=src python -m repro_torch.benchmarks.straggler_ehr [--rounds 80] [--q 10] \\
      [--out experiments/straggler_ehr_torch.json] [--device cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

from repro_torch.benchmarks.ehr_cells import run_ehr_cell

__all__ = ["STALENESS_DEPTHS", "STRAGGLER_FRACTIONS", "STRAGGLER_RATE", "SMOKE_ROUNDS",
           "run_cell", "run", "main"]

#: staleness depths swept (0 == the sequential baseline; 1 == pipelined)
STALENESS_DEPTHS = (0, 1, 2, 4)
#: straggler fractions swept (0.0 == the homogeneous lockstep baseline)
STRAGGLER_FRACTIONS = (0.0, 0.25, 0.5)
STRAGGLER_RATE = 0.5  # a slow node runs half its local steps
#: ``--smoke``: rounds a cell
SMOKE_ROUNDS = 6


def run_cell(k: int, frac: float, rounds: int, q: int, seed: int = 0,
             robust_alpha: bool = False, alpha0: float = 0.01, device=None,
             init_params: Optional[Dict] = None) -> dict:
    """One (staleness depth, straggler fraction) cell: FD-DSGT, fused
    engine, hospital graph, equal round budget everywhere."""
    node_program = (None if frac == 0.0 else
                    f"stragglers:frac={frac},rate={STRAGGLER_RATE},drop=1,seed=0")
    out = run_ehr_cell(
        q, rounds, round_schedule="sequential" if k == 0 else f"bounded_staleness:k={k}",
        node_program=node_program, alpha0=alpha0, robust_alpha=robust_alpha,
        seed=seed, device=device, init_params=init_params)
    engine = out["engine"]
    return {
        "staleness_depth": k,
        "straggler_fraction": frac,
        "schedule": engine.round_schedule.spec(),
        "node_program": engine.node_program.spec(),
        "robust_alpha": bool(robust_alpha),
        "rounds": rounds,
        "q": q,
        "iterations": out["iterations"],
        "bal_acc": out["bal_acc"],
        "final_loss": out["final_loss"],
        "consensus_err": out["consensus_err"],
        "mean_payload_fraction": out["mean_payload_fraction"],
        "mean_compute_fraction": out["mean_compute_fraction"],
    }


def run(rounds: int = 80, q: int = 10, device=None,
        init_params: Optional[Dict] = None, log: bool = True) -> Dict:
    """The frontier and the controller cell; returns the record the JSON
    holds."""
    cells = []
    for frac in STRAGGLER_FRACTIONS:
        for k in STALENESS_DEPTHS:
            cell = run_cell(k, frac, rounds, q, device=device, init_params=init_params)
            cells.append(cell)
            if log:
                print(f"k={k} frac={frac:4.2f} "
                      f"payload~{cell['mean_payload_fraction']:.2f} "
                      f"compute~{cell['mean_compute_fraction']:.2f} "
                      f"bal_acc={cell['bal_acc']:.3f} "
                      f"cons_err={cell['consensus_err']:.2e}", flush=True)
    k_max, frac_max = STALENESS_DEPTHS[-1], STRAGGLER_FRACTIONS[-1]
    ctrl = run_cell(k_max, frac_max, rounds, q, robust_alpha=True, device=device,
                    init_params=init_params)
    cells.append(ctrl)
    if log:
        print(f"k={k_max} frac={frac_max} + robust_alpha bal_acc={ctrl['bal_acc']:.3f} "
              f"cons_err={ctrl['consensus_err']:.2e}", flush=True)
    baseline = cells[0]["bal_acc"]  # k=0, homogeneous
    summary = {
        f"frac={frac}": {
            f"k={c['staleness_depth']}": {
                "bal_acc": c["bal_acc"],
                "bal_acc_delta_vs_lockstep": c["bal_acc"] - baseline,
            }
            for c in cells if c["straggler_fraction"] == frac and not c["robust_alpha"]
        }
        for frac in STRAGGLER_FRACTIONS
    }
    return {
        "experiment": "straggler_bounded_staleness_ehr",
        "cohort": "hospital20 (2103 AD / 7919 MCI, 42 features)",
        "algorithm": "dsgt (fused engine, int8 wire, class-weighted loss)",
        "alpha": "0.01/sqrt(r)",
        "straggler_rate": STRAGGLER_RATE,
        "note": "equal round budget per cell; bounded_staleness:k keeps k "
                "payloads in flight (wire bytes per round unchanged), "
                "stragglers:frac drops that fraction of payloads per round "
                "and halves their local steps (masked steps of the same round)",
        "cells": cells,
        "summary": summary,
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=80,
                    help="comm rounds per cell (equal budget everywhere)")
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--out", default="experiments/straggler_ehr_torch.json")
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
