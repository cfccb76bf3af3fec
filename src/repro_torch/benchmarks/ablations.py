"""Beyond-paper ablations on the paper's algorithm, on the PyTorch port
(counterpart of the reference's ``benchmarks/ablations.py``).

1. TOPOLOGY: convergence at a fixed communication budget across graphs
   with different spectral gaps (ring < Erdos-Renyi < torus < complete).
   Consensus error contracts at rate |lambda_2(W)|, so at equal comm
   rounds DSGD's consensus error falls as the gap grows; DSGT's tracking
   erases most of the difference.
2. CLIENT DRIFT vs Q: local steps save communication but let nodes drift
   toward their local optima between mixes. Q sweeps {1, 4, 16, 60} under
   heterogeneity {0.5, 2, 8} at a fixed iteration budget; the distance of
   the consensus model from the global optimum is reported.

The problem is the reference's: per-node quadratics with different
curvatures A_i and optima b_i, the same numpy draws, written node-batched
(``r_i^T A_i r_i`` as one ``einsum`` over the nodes) for the port's
``LossFn``; the runs use the exact-wire ``tree`` engine.

  PYTHONPATH=src python -m repro_torch.benchmarks.ablations --device cpu \\
      [--out experiments/ablations_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine import TreeEngine
from repro_torch.core.fl import FLConfig, consensus_params, init_fl_state, make_fl_round
from repro_torch.core.mixing import make_dense_gossip
from repro_torch.core.schedules import constant
from repro_torch.core.topology import mixing_matrix, spectral_gap
from repro_torch.device import resolve_device

__all__ = ["N", "D", "TOPOLOGIES", "HETEROGENEITY", "QS", "_problem", "_run",
           "topology_ablation", "drift_ablation", "run", "main"]

N, D = 16, 12
TOPOLOGIES = ("ring", "erdos_renyi", "torus:4x4", "complete")
HETEROGENEITY = (0.5, 2.0, 8.0)
QS = (1, 4, 16, 60)


def _problem(heterogeneity: float, seed: int = 0):
    """Per-node quadratics with DIFFERENT curvatures A_i and optima b_i
    (identical Hessians would make local SGD commute with averaging: no
    drift). Returns the (N, D) targets, the (N, D, D) Hessians, both fp32,
    and the node-batched loss."""
    rng = np.random.default_rng(seed)
    common = rng.normal(size=(D,))
    local = heterogeneity * rng.normal(size=(N, D))
    targets = (common[None] + local).astype(np.float32)
    hessians = []
    for _ in range(N):
        m = rng.normal(size=(D, D)) * (0.2 + 0.1 * heterogeneity)
        hessians.append(np.eye(D) + m @ m.T / D)
    a = np.stack(hessians).astype(np.float32)

    def loss(params, batch):
        r = params["x"] - batch["t"] - batch["noise"]
        return 0.5 * torch.einsum("ni,nij,nj->n", r, batch["a"], r)

    return targets, a, loss


def _run(topology: str, q: int, heterogeneity: float, iters: int, alpha: float,
         seed: int = 0, algorithm: str = "dsgt", device=None) -> Dict[str, float]:
    """One run of ``iters // q`` rounds: the final consensus error, the
    consensus model's distance to the global optimum, the rounds and the
    spectral gap of W."""
    dev = resolve_device(device)
    targets, a, loss = _problem(heterogeneity, seed)
    w = mixing_matrix(topology, N)
    cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=N)
    rf = make_fl_round(loss, constant(alpha), cfg, TreeEngine(make_dense_gossip(w), device=dev))
    state = init_fl_state(cfg, {"x": torch.zeros((N, D), device=dev)})
    t = torch.as_tensor(targets, device=dev).expand(q, N, D)
    hess = torch.as_tensor(a, device=dev).expand(q, N, D, D)
    rng = np.random.default_rng(seed + 1)
    rounds = iters // q
    m = {}
    for _ in range(rounds):
        noise = (0.3 * rng.normal(size=(q, N, D))).astype(np.float32)
        state, m = rf(state, {"t": t, "a": hess, "noise": noise})
    xbar = consensus_params(state)["x"].double().cpu().numpy()
    # the global optimum of (1/N) sum f_i solves (sum A_i) x = sum A_i b_i
    opt = np.linalg.solve(a.astype(np.float64).sum(0),
                          np.einsum("nij,nj->i", a.astype(np.float64), targets))
    return {
        "consensus_err": float(m["consensus_err"]),
        "dist_to_opt": float(np.linalg.norm(xbar - opt)),
        "comm_rounds": rounds,
        "spectral_gap": spectral_gap(w),
    }


def topology_ablation(iters: int = 300, device=None, log: bool = True) -> Dict:
    """DSGD's steady-state consensus error scales ~alpha*zeta/gap; DSGT's
    does not."""
    if log:
        print(f"topology ablation (Q=1, equal comm budget, N={N}):")
    out = {}
    for topo in TOPOLOGIES:
        r_d = _run(topo, q=1, heterogeneity=2.0, iters=iters, alpha=0.05,
                   algorithm="dsgd", device=device)
        r_t = _run(topo, q=1, heterogeneity=2.0, iters=iters, alpha=0.05, device=device)
        out[topo] = {"spectral_gap": r_d["spectral_gap"],
                     "dsgd_consensus": r_d["consensus_err"],
                     "dsgt_consensus": r_t["consensus_err"],
                     "dsgd_dist": r_d["dist_to_opt"], "dsgt_dist": r_t["dist_to_opt"]}
        if log:
            print(f"  {topo:12s} gap={r_d['spectral_gap']:.3f} "
                  f"DSGD consensus={r_d['consensus_err']:.2e}  "
                  f"DSGT consensus={r_t['consensus_err']:.2e}", flush=True)
    ordered = sorted(out.values(), key=lambda r: r["spectral_gap"])
    mono = all(a["dsgd_consensus"] >= b["dsgd_consensus"] * 0.8
               for a, b in zip(ordered, ordered[1:]))
    if log:
        print(f"  DSGD consensus error decreases with spectral gap: {mono}")
    return out


def drift_ablation(iters: int = 240, device=None, log: bool = True) -> Dict:
    if log:
        print(f"client-drift vs Q (DSGT, fixed iteration budget, N={N} ring):")
    out = {}
    for het in HETEROGENEITY:
        row = {q: _run("ring", q=q, heterogeneity=het, iters=iters, alpha=0.05,
                       device=device)["dist_to_opt"] for q in QS}
        penalty = row[60] / max(row[1], 1e-9)
        out[str(het)] = {"dist_by_q": row, "q60_penalty": penalty}
        if log:
            print(f"  heterogeneity={het:4.1f}: dist(Q=1)={row[1]:.4f} "
                  f"dist(Q=4)={row[4]:.4f} dist(Q=16)={row[16]:.4f} "
                  f"dist(Q=60)={row[60]:.4f}  (Q=60 penalty {penalty:.2f}x)", flush=True)
    return out


def run(topology_iters: int = 300, drift_iters: int = 240, device=None,
        log: bool = True) -> Dict:
    return {"topology": topology_ablation(topology_iters, device, log),
            "drift": drift_ablation(drift_iters, device, log)}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--topology-iters", type=int, default=300)
    ap.add_argument("--drift-iters", type=int, default=240)
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--out", default="experiments/ablations_torch.json")
    args = ap.parse_args(argv)
    res = run(args.topology_iters, args.drift_iters, device=args.device)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=2)
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
