"""Theorem 1 on the PyTorch port: linear speedup of DSGT in the number of
nodes N (counterpart of the reference's ``benchmarks/thm1_speedup.py``).

Theorem 1: with alpha^r ~ O(sqrt(N/r)) and Q = 1,

  (1/T) sum_r [ ||mean_i grad f_i||^2 + (1/N) sum_i ||theta_i - theta_bar||^2 ]
      <= O(sigma^2 / (N sqrt(T)))

DSGT (Q = 1) trains a synthetic non-IID least-squares problem with the
same total data but N in {4, 8, 16} nodes on a ring, for a fixed T, on
the exact-wire ``tree`` engine; the time-averaged stationarity measure
should shrink about linearly as N grows (ratios N4/N8 and N8/N16 near
2). The targets and the gradient noise are the reference's numpy draws,
so both packages train on the same numbers.

``--two-axis`` adds the wall-clock companion table: round time against
node count x model-shard count on the two-axis (gossip_node,
model_shard) layout, one group of ranks per cell
(``benchmarks/two_axis.py``; on CUDA a cell needs a card a rank, so
``--device cpu`` runs the cells on gloo); ``--smoke`` shrinks its cells.

  PYTHONPATH=src python -m repro_torch.benchmarks.thm1_speedup --device cpu \\
      [--t-steps 400] [--seeds 3] [--out experiments/thm1_results_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import numpy as np
import torch

from repro_torch.core.engine import TreeEngine
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
from repro_torch.core.mixing import make_dense_gossip
from repro_torch.core.schedules import theorem1_schedule
from repro_torch.core.topology import mixing_matrix
from repro_torch.device import resolve_device

__all__ = ["D", "NOISE", "NODES", "make_problem", "run_one", "run", "main"]

D = 24
NOISE = 1.0  # gradient noise sigma
NODES = (4, 8, 16)


def make_problem(n_nodes: int, seed: int = 0):
    """Per-node linear regression with heterogeneous optima; the
    stochastic gradients carry iid noise of variance sigma^2 (Assumption
    2). Returns the (n, D) fp32 targets and the node-batched loss."""
    rng = np.random.default_rng(seed)
    targets = rng.normal(size=(n_nodes, D)).astype(np.float32)

    def loss(params, batch):
        # the batch carries the noise sample (an m = 1 stochastic gradient)
        r = params["x"] - batch["target"] - batch["noise"]
        return 0.5 * (r * r).sum(dim=1)

    return targets, loss


def run_one(n_nodes: int, t_steps: int, seed: int = 0, c: float = 0.05,
            device=None) -> float:
    """The time-averaged ``grad_norm_sq + consensus_err`` of one DSGT run
    of ``t_steps`` iterations on ``device`` (``cuda`` unless given)."""
    dev = resolve_device(device)
    targets, loss = make_problem(n_nodes, seed)
    cfg = FLConfig(algorithm="dsgt", q=1, n_nodes=n_nodes)
    engine = TreeEngine(make_dense_gossip(mixing_matrix("ring", n_nodes)), device=dev)
    rf = make_fl_round(loss, theorem1_schedule(n_nodes, c), cfg, engine)
    state = init_fl_state(cfg, {"x": torch.zeros((n_nodes, D), device=dev)})
    target = torch.as_tensor(targets, device=dev)[None]
    rng = np.random.default_rng(seed + 1)
    measure = 0.0
    for _ in range(t_steps):
        noise = (NOISE * rng.normal(size=(1, n_nodes, D)) / np.sqrt(D)).astype(np.float32)
        state, m = rf(state, {"target": target, "noise": noise})
        measure += float(m["grad_norm_sq"]) + float(m["consensus_err"])
    return measure / t_steps


def run(t_steps: int = 400, seeds: int = 3, device=None, log: bool = True) -> Dict:
    """The measure at each N (mean over ``seeds``) and the two ratios."""
    if log:
        print("Theorem 1: time-averaged stationarity+consensus vs N (DSGT, Q=1)")
    out = {}
    for n in NODES:
        out[n] = float(np.mean([run_one(n, t_steps, seed=s, device=device)
                                for s in range(seeds)]))
        if log:
            print(f"  N={n:3d}: measure={out[n]:.5f}", flush=True)
    r48, r816 = out[4] / out[8], out[8] / out[16]
    if log:
        print(f"  ratios: N4/N8={r48:.2f}, N8/N16={r816:.2f}  (linear speedup => ~2.0)")
    return {"measure": out, "ratio_4_8": r48, "ratio_8_16": r816}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--t-steps", type=int, default=400)
    ap.add_argument("--seeds", type=int, default=3)
    ap.add_argument("--two-axis", action="store_true",
                    help="also time full rounds vs node count x shard count on the "
                         "(gossip_node, model_shard) layout")
    ap.add_argument("--smoke", action="store_true",
                    help="shrink the --two-axis cells to seconds-scale")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--out", default="experiments/thm1_results_torch.json")
    args = ap.parse_args(argv)
    res = run(args.t_steps, args.seeds, device=args.device)
    if args.two_axis:
        from repro_torch.benchmarks.two_axis import two_axis_row

        res["two_axis"] = two_axis_row(smoke=args.smoke, device=args.device)
    res["device"] = str(resolve_device(args.device))
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f)
    print(f"wrote {args.out}")
    return res


if __name__ == "__main__":
    main()
