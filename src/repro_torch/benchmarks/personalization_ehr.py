"""Personalization against consensus on the PyTorch port (counterpart of
the reference's ``benchmarks/personalization_ehr.py``).

The sixth round axis (``core.scope``) makes gossip partial: under
``backbone`` the hospitals share every column but the classifier head,
each head training on its own gradients alone, bit-untouched by the
wire. This driver measures when that wins, on the HARDENED cohort
(``generate_ehr_cohort`` with ``label_shift`` 1.5,
``minority_concentration`` 1.0, ``conditional_shift`` 4.0): per-hospital
AD prevalence spreads from under 1% to about 90% and the AD cluster
drifts per hospital, so the best classifier differs between hospitals.

Cells (FD-DSGT on the ``fused`` engine, hospital graph, chunk 128, alpha
= 0.01/sqrt(r), equal round budget):

* ``full``            -- full-consensus gossip;
* ``backbone``        -- shared backbone, private per-hospital heads;
* ``layerwise_freq4`` -- the head joins the mix every 4th round (the full
                         wire).

Headline: the mean over hospitals of each hospital's DEPLOYED model (its
own row) on its own patients. Asserted here, as the reference asserts
it: the wire bytes obey ``wire_scoped * total_full == wire_full *
total_scoped`` to the byte (``flat_wire_bytes`` is linear in the
layout's width), ``layerwise`` ships the full wire, ``backbone`` ships
strictly fewer bytes, and (not on a smoke run) ``backbone`` >= ``full``.
Chunk 128 because the backbone slice is 1,376 of the MLP's 1,536
columns: a 512 chunk would pad it back to the full width. On the card a
round is one ``fused_round_gt`` launch.

  PYTHONPATH=src python -m repro_torch.benchmarks.personalization_ehr [--rounds 150] \\
      [--q 10] [--out experiments/personalization_ehr_torch.json] [--device cpu] [--smoke]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from repro_torch.benchmarks.ehr_cells import run_ehr_cell
from repro_torch.data.ehr import generate_ehr_cohort
from repro_torch.data.partition import cohort_label_stats

__all__ = ["LABEL_SHIFT", "MINORITY_CONCENTRATION", "CONDITIONAL_SHIFT", "COHORT",
           "SCALE_CHUNK", "SMOKE_ROUNDS", "CELLS", "run_cell", "run", "main"]

#: the hardened cohort's knobs: prevalence tilt, minority concentration,
#: class-conditional drift
LABEL_SHIFT = 1.5
MINORITY_CONCENTRATION = 1.0
CONDITIONAL_SHIFT = 4.0
COHORT = {"label_shift": LABEL_SHIFT, "minority_concentration": MINORITY_CONCENTRATION,
          "conditional_shift": CONDITIONAL_SHIFT}
SCALE_CHUNK = 128
#: ``--smoke``: rounds a cell
SMOKE_ROUNDS = 6
#: (name, scope spec) of each cell, in order
CELLS = (("full", None), ("backbone", "backbone"), ("layerwise_freq4", "layerwise:freq=4"))


def run_cell(name: str, scope, rounds: int, q: int, seed: int = 0,
             alpha0: float = 0.01, device=None,
             init_params: Optional[Dict] = None) -> dict:
    """One scope cell: FD-DSGT, fused engine, hardened hospital cohort,
    each hospital's own row evaluated on its own patients."""
    out = run_ehr_cell(q, rounds, scope=scope, scale_chunk=SCALE_CHUNK, alpha0=alpha0,
                       cohort=COHORT, seed=seed, device=device,
                       init_params=init_params)
    engine, m = out["engine"], out["metrics"]
    own = out["bal_acc_per_hospital"]
    return {
        "name": name,
        "scope": engine.scope.spec(),
        "n_nodes": 20,
        "q": q,
        "scale_chunk": SCALE_CHUNK,
        "topk": None,
        "rounds": rounds,
        "iterations": out["iterations"],
        "bal_acc_per_hospital_mean": float(np.mean(own)),
        "bal_acc_per_hospital_min": float(np.min(own)),
        "bal_acc_consensus_per_hospital_mean": float(np.mean(
            out["bal_acc_consensus_per_hospital"])),
        "per_hospital_bal_acc": [round(v, 4) for v in own],
        "final_loss": out["final_loss"],
        "consensus_err": out["consensus_err"],
        "wire_bytes_per_round": float(m["wire_bytes"]),
        "wire_total_cols": int(engine.wire_layout.total),
        "layout_total_cols": int(engine.layout.total),
        "shared_fraction": engine.wire_layout.total / engine.layout.total,
    }


def run(rounds: int = 150, q: int = 10, device=None, init_params: Optional[Dict] = None,
        smoke: bool = False, log: bool = True) -> Dict:
    """The three cells and the in-script asserts; returns the record the
    JSON holds."""
    rows = []
    for name, scope in CELLS:
        row = run_cell(name, scope, rounds, q, device=device, init_params=init_params)
        rows.append(row)
        if log:
            print(f"{name:18s} per-hosp bal_acc={row['bal_acc_per_hospital_mean']:.3f} "
                  f"(min {row['bal_acc_per_hospital_min']:.3f}) "
                  f"consensus={row['bal_acc_consensus_per_hospital_mean']:.3f} "
                  f"wire={row['wire_bytes_per_round']:.0f}B "
                  f"({row['shared_fraction']:.2f} of full)", flush=True)
    full, backbone, layerwise = rows
    # the shared-fraction x full-wire identity, to the byte
    if (backbone["wire_bytes_per_round"] * full["layout_total_cols"]
            != full["wire_bytes_per_round"] * backbone["wire_total_cols"]):
        raise AssertionError(f"wire bytes not linear in the width: {backbone} vs {full}")
    if layerwise["wire_bytes_per_round"] != full["wire_bytes_per_round"]:
        raise AssertionError("the layerwise scope must ship the full wire")
    if not backbone["wire_bytes_per_round"] < full["wire_bytes_per_round"]:
        raise AssertionError("the backbone scope must ship fewer bytes")
    if not smoke and backbone["bal_acc_per_hospital_mean"] < full["bal_acc_per_hospital_mean"]:
        raise AssertionError(
            f"backbone per-hospital bal_acc {backbone['bal_acc_per_hospital_mean']} < "
            f"full {full['bal_acc_per_hospital_mean']}")
    return {
        "experiment": "personalization_vs_consensus_ehr",
        "cohort": "hardened hospital20 (2103 AD / 7919 MCI, 42 features; "
                  f"label_shift={LABEL_SHIFT}, "
                  f"minority_concentration={MINORITY_CONCENTRATION}, "
                  f"conditional_shift={CONDITIONAL_SHIFT})",
        "cohort_stats": cohort_label_stats(generate_ehr_cohort(seed=0, **COHORT).labels),
        "algorithm": "dsgt (fused engine, int8 wire, class-weighted loss)",
        "alpha": "0.01/sqrt(r)",
        "smoke": bool(smoke),
        "note": "mean per-hospital balanced accuracy of each hospital's "
                "DEPLOYED model (own row: gossiped backbone + private "
                "head under partial scope). backbone >= full is asserted "
                "in-script (non-smoke) with strictly fewer wire bytes; "
                "the scoped wire obeys wire_scoped * total_full == "
                "wire_full * total_scoped exactly, and layerwise ships "
                "the full wire (the gate changes the mix, not the "
                "collective).",
        "rows": rows,
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=150,
                    help="comm rounds per cell (equal budget everywhere)")
    ap.add_argument("--q", type=int, default=10)
    ap.add_argument("--out", default="experiments/personalization_ehr_torch.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--smoke", action="store_true",
                    help=f"{SMOKE_ROUNDS} rounds a cell: every cell, the wire "
                         "identities and the JSON schema (accuracies not "
                         "representative)")
    args = ap.parse_args(argv)
    record = run(SMOKE_ROUNDS if args.smoke else args.rounds, args.q, device=args.device,
                 smoke=args.smoke)
    record["device"] = args.device
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    print(f"wrote {args.out}")
    return record


if __name__ == "__main__":
    main()
