"""Paper Fig. 2 on the PyTorch port: convergence against COMMUNICATION
ROUNDS (counterpart of the reference's ``benchmarks/fig2_comm_rounds.py``).

Trains the paper's shallow NN on the synthetic 20-hospital EHR cohort with
the paper's hyperparameters (m = 20, Q = 100 for the FD variants,
alpha = 0.02/sqrt(r), the hospital graph) on the default ``tree`` engine
(exact fp32 mix-then-adapt), and reports per algorithm the loss /
stationarity / consensus trajectories indexed by communication rounds.

The paper's qualitative claims (:func:`claims` checks 1-2 on a run):
  1. FD-DSGD / FD-DSGT converge ~Q x faster per communication round;
  2. DSGT reaches a smaller optimality gap than DSGD (non-IID data);
  3. all four reach comparable loss at a matched ITERATION budget.

  PYTHONPATH=src python -m repro_torch.benchmarks.fig2_comm_rounds --device cpu --iterations 300
"""

from __future__ import annotations

import argparse
import json
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import FLRunConfig
from repro_torch.core.fl import tree_map
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher
from repro_torch.device import resolve_device
from repro_torch.models.mlp import make_mlp_loss, mlp_accuracy, mlp_init
from repro_torch.training.trainer import train_decentralized

__all__ = ["ALGOS", "run", "comm_rounds_to_loss", "claims", "report", "main"]

ALGOS = {
    "DSGD": ("dsgd", 1),
    "DSGT": ("dsgt", 1),
    "FD-DSGD (Q=100)": ("dsgd", 100),
    "FD-DSGT (Q=100)": ("dsgt", 100),
}


def run(iterations: int = 3000, m: int = 20, seed: int = 0, log: bool = True,
        device=None, init_params: Optional[Dict] = None) -> Dict:
    """The four runs of Fig. 2 at a matched iteration budget, each for
    ``max(1, iterations // Q)`` communication rounds, on ``device``
    (``cuda`` unless given). ``init_params``: one node's starting weights
    (a tree of tensors or arrays), default ``mlp_init(seed)``; tests pass
    the reference's init here. Returns, per algorithm, the per-round
    ``comm_rounds``, ``loss``, ``grad_norm_sq`` and ``consensus_err``,
    and the ``iterations``, ``final_loss`` and ``final_acc`` (accuracy of
    the consensus model on the whole cohort)."""
    dev = resolve_device(device)
    data = generate_ehr_cohort(seed=seed)
    xall = torch.as_tensor(np.concatenate(data.features), device=dev)
    yall = torch.as_tensor(np.concatenate(data.labels), device=dev)
    single = mlp_init(seed, device=dev) if init_params is None else tree_map(
        lambda p: torch.tensor(np.asarray(p), device=dev), init_params)
    results = {}
    for name, (algo, q) in ALGOS.items():
        run_cfg = FLRunConfig(
            algorithm=algo, q=q, topology="hospital20", n_nodes=20,
            batch_per_node=m, alpha0=0.02, schedule="inv_sqrt", seed=seed,
        )
        res = train_decentralized(
            make_mlp_loss(), single, run_cfg,
            make_node_batcher(data, m=m, seed=seed + 1),
            rounds=max(1, iterations // q), device=dev,
        )
        h = res.history
        acc = float(mlp_accuracy(res.consensus, xall, yall))
        results[name] = {
            "comm_rounds": h.column("comm_rounds").tolist(),
            "loss": h.column("loss").tolist(),
            "grad_norm_sq": h.column("grad_norm_sq").tolist(),
            "consensus_err": h.column("consensus_err").tolist(),
            "iterations": int(h.last()["iteration"]),
            "final_loss": h.last()["loss"],
            "final_acc": acc,
        }
        if log:
            print(
                f"  {name:18s} comm_rounds={int(h.last()['comm_rounds']):5d} "
                f"iters={results[name]['iterations']:5d} "
                f"loss={results[name]['final_loss']:.4f} acc={acc:.3f}",
                flush=True,
            )
    return results


def comm_rounds_to_loss(res: Dict, target: float) -> Dict[str, float]:
    """Per algorithm, the first communication round whose loss is at or
    below ``target`` (inf if none is)."""
    out = {}
    for name, r in res.items():
        rounds = np.asarray(r["comm_rounds"])
        losses = np.asarray(r["loss"])
        hit = np.nonzero(losses <= target)[0]
        out[name] = float(rounds[hit[0]]) if len(hit) else float("inf")
    return out


def _target(res: Dict) -> float:
    """The loss target of the comparison: 10% above the worse final loss
    of the two Q = 1 runs."""
    return 1.10 * max(res["DSGT"]["final_loss"], res["DSGD"]["final_loss"])


def claims(res: Dict) -> Dict[str, Dict]:
    """Claims 1-2 of the module docstring on :func:`run`'s results.

    1. Each FD variant reaches the loss target in at least Q/10 times
       fewer communication rounds than its Q = 1 twin (``saving``).
    2. DSGT ends with a smaller optimality gap than DSGD: Theorem 1's
       stationarity terms, ``grad_norm_sq + consensus_err``, averaged
       over the last tenth of the rounds (``gap``).

    Returns ``{"1": {"holds": bool, ...}, "2": {...}}``."""
    to_target = comm_rounds_to_loss(res, _target(res))
    saving = {}
    for fd, base in (("FD-DSGD (Q=100)", "DSGD"), ("FD-DSGT (Q=100)", "DSGT")):
        saving[fd] = to_target[base] / to_target[fd]
    q = ALGOS["FD-DSGT (Q=100)"][1]

    def gap(name: str) -> float:
        r = res[name]
        tail = max(1, len(r["loss"]) // 10)
        return float(np.mean(np.add(r["grad_norm_sq"][-tail:],
                                    r["consensus_err"][-tail:])))

    gaps = {name: gap(name) for name in ("DSGD", "DSGT")}
    return {
        "1": {"holds": all(s >= q / 10 for s in saving.values()), "saving": saving},
        "2": {"holds": gaps["DSGT"] < gaps["DSGD"], "gap": gaps},
    }


def report(res: Dict) -> Dict:
    """Print the comparison of :func:`run`'s results: the communication
    rounds each algorithm needs to reach the loss target, FD-DSGT's
    saving over DSGT, and whether claims 1-2 hold. Returns the derived
    numbers."""
    target = _target(res)
    to_target = comm_rounds_to_loss(res, target)
    print(f"  comm rounds to reach loss<={target:.4f}: "
          + ", ".join(f"{k}={v:.0f}" for k, v in to_target.items()))
    speedup = to_target["DSGT"] / max(to_target["FD-DSGT (Q=100)"], 1.0)
    print(f"  FD-DSGT communication saving vs DSGT: {speedup:.0f}x")
    checked = claims(res)
    print(f"  claim 1 (FD ~Q x fewer rounds): {checked['1']['holds']}, savings "
          + ", ".join(f"{k}={v:.0f}x" for k, v in checked["1"]["saving"].items()))
    print(f"  claim 2 (DSGT smaller gap than DSGD): {checked['2']['holds']}, "
          + ", ".join(f"{k}={v:.4e}" for k, v in checked["2"]["gap"].items()))
    return {"comm_rounds_to_target": to_target, "fd_dsgt_saving": speedup,
            "claims": checked}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=3000,
                    help="iteration budget of each algorithm (paper: 3000)")
    ap.add_argument("--device", default="cuda",
                    help="torch device ('cpu' runs the plain PyTorch path)")
    ap.add_argument("--out", default=None,
                    help="write the results as JSON to this path")
    args = ap.parse_args(argv)
    print("Fig. 2 reproduction (synthetic cohort, paper hyperparameters):")
    res = run(iterations=args.iterations, device=args.device)
    res["_derived"] = report(res)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f)
        print(f"  results -> {args.out}")
    return res


if __name__ == "__main__":
    main()
