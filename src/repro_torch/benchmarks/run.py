"""Benchmark harness on the PyTorch port -- one function per paper table or
figure and the system tables (counterpart of the reference's
``benchmarks/run.py``):

  fig2        Fig. 2: convergence against communication rounds (4 algorithms)
  thm1        Theorem 1: linear speedup of DSGT in N
  comm_bytes  communication bytes per iteration (ring FD against baselines)
  kernels     the hand kernels against their twins, bounds and SDPA
              (``kernel_bench``; on the CPU the twins alone)
  ablations   spectral gap and client drift against Q
  roofline    the H100 roofline over the committed dry-run records
              (``experiments/dryrun_torch``, ``roofline.py``)

Each table writes its JSON under ``--out-dir`` (``<table>_torch.json``
names, so no committed record is touched), and the harness prints the
reference's ``name,us_per_call,derived`` CSV lines at the end, one a
table. ``--fast`` cuts the iteration counts as the reference's does (Fig.
2 600 iterations, Theorem 1 T 150 over 2 seeds); ``--smoke`` cuts every
table to seconds on the CPU (the JSONs' schema, numbers not
representative).

  PYTHONPATH=src python -m repro_torch.benchmarks.run [--fast] [--device cpu]
      [--skip fig2,kernels] [--out-dir experiments]
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

from repro_torch.benchmarks import ablations, comm_bytes, fig2_comm_rounds, kernel_bench
from repro_torch.benchmarks import roofline, thm1_speedup
from repro_torch.device import resolve_device

__all__ = ["TABLES", "main"]

TABLES = ("fig2", "thm1", "comm_bytes", "kernels", "ablations", "roofline")
#: the outputs of each table under --out-dir
OUTPUTS = {"fig2": "fig2_results_torch.json", "thm1": "thm1_results_torch.json",
           "comm_bytes": "comm_bytes_torch.json", "kernels": "kernel_bench_torch.json",
           "ablations": "ablations_torch.json"}


def _timed(fn, *args, **kw):
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    return out, (time.perf_counter() - t0) * 1e6


def _sizes(fast: bool, smoke: bool) -> Dict:
    if smoke:
        return dict(iterations=100, t_steps=10, seeds=1, topology_iters=20, drift_iters=60,
                    kernel_shapes={"path decode"})
    return dict(iterations=600 if fast else 3000, t_steps=150 if fast else 400,
                seeds=2 if fast else 3, topology_iters=300, drift_iters=240,
                kernel_shapes=None)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="reduced iteration counts")
    ap.add_argument("--smoke", action="store_true",
                    help="every table at a seconds-scale size")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--skip", default="",
                    help=f"comma-separated tables to leave out ({', '.join(TABLES)})")
    ap.add_argument("--out-dir", default="experiments")
    args = ap.parse_args(argv)
    skip = {s.strip() for s in args.skip.split(",") if s.strip()}
    unknown = skip - set(TABLES)
    if unknown:
        ap.error(f"unknown tables {sorted(unknown)}; have {TABLES}")
    dev = resolve_device(args.device)
    size = _sizes(args.fast, args.smoke)
    os.makedirs(args.out_dir, exist_ok=True)
    results: Dict = {}
    csv: List[Dict] = []

    def write(table: str, record) -> None:
        with open(os.path.join(args.out_dir, OUTPUTS[table]), "w") as f:
            json.dump(record, f, indent=2)

    if "fig2" not in skip:
        print(f"\n=== fig2_comm_rounds (iterations={size['iterations']}) ===")
        fig2, us = _timed(fig2_comm_rounds.run, iterations=size["iterations"], device=dev)
        fig2["_derived"] = fig2_comm_rounds.report(fig2)
        write("fig2", fig2)
        results["fig2"] = fig2
        csv.append({"name": "fig2_comm_rounds", "us_per_call": us,
                    "derived": f"fd_dsgt_comm_saving={fig2['_derived']['fd_dsgt_saving']:.0f}x"})

    if "thm1" not in skip:
        print(f"\n=== thm1_speedup (T={size['t_steps']}) ===")
        thm1, us = _timed(thm1_speedup.run, t_steps=size["t_steps"], seeds=size["seeds"],
                          device=dev)
        write("thm1", thm1)
        results["thm1"] = thm1
        csv.append({"name": "thm1_linear_speedup", "us_per_call": us,
                    "derived": f"ratio_4_8={thm1['ratio_4_8']:.2f};"
                               f"ratio_8_16={thm1['ratio_8_16']:.2f}"})

    if "comm_bytes" not in skip:
        print("\n=== comm_bytes ===")
        cb, us = _timed(comm_bytes.main)
        write("comm_bytes", cb)
        results["comm_bytes"] = cb
        q100 = next(r for r in cb["rows"] if "Q=100 (paper)" in r["strategy"])
        csv.append({"name": "comm_bytes_table", "us_per_call": us,
                    "derived": f"fd_q100_vs_centralized={q100['ratio_vs_centralized']:.5f}x"})

    if "kernels" not in skip:
        print("\n=== kernel_bench ===")
        shapes = size["kernel_shapes"]
        if shapes is None and dev.type != "cuda":  # the large shapes need the card
            shapes = {"main", "path", "path prefill", "path decode", "hd256 path"}
        kb, us = _timed(kernel_bench.run, dev, shapes)
        write("kernels", kb)
        results["kernels"] = kb
        csv.append({"name": "kernel_bench", "us_per_call": us, "derived": f"rows={len(kb)}"})

    if "ablations" not in skip:
        print("\n=== ablations (topology spectral gap, client drift vs Q) ===")
        ab, us = _timed(ablations.run, size["topology_iters"], size["drift_iters"], device=dev)
        write("ablations", ab)
        results["ablations"] = ab
        topo = ab["topology"]
        csv.append({"name": "ablations", "us_per_call": us, "derived": (
            f"dsgd_ring_vs_complete_consensus="
            f"{topo['ring']['dsgd_consensus'] / topo['complete']['dsgd_consensus']:.1f}x;"
            f"q60_drift_penalty_het8={ab['drift']['8.0']['q60_penalty']:.1f}x")})

    if "roofline" not in skip:
        print("\n=== roofline (single-pod dry-run records, H100 prices) ===")
        rows, us = _timed(roofline.rows_for, "single")
        if rows:
            print(roofline.format_table(rows))
            oks = [r for r in rows if r.get("status") == "ok"]
            dom: Dict[str, int] = {}
            for r in oks:
                dom[r["dominant"]] = dom.get(r["dominant"], 0) + 1
            results["roofline"] = rows
            csv.append({"name": "roofline", "us_per_call": us,
                        "derived": f"pairs={len(oks)};dominant="
                                   + "/".join(f"{k}:{v}" for k, v in sorted(dom.items()))})
        else:
            print("  (no dry-run records; run repro_torch.benchmarks.run_dryruns first)")

    print("\nname,us_per_call,derived")
    for r in csv:
        print(f"{r['name']},{r['us_per_call']:.0f},{r['derived']}")
    results["csv"] = csv
    return results


if __name__ == "__main__":
    main()
