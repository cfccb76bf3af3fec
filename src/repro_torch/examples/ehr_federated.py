"""The paper's EHR experiment end to end (counterpart of the reference's
``examples/ehr_federated.py``).

Part 1 -- the reproduction (``--iterations``, 0 skips it): 20 hospitals,
about 500 EHR records each (42 features), the shallow NN per hospital, the
hospital graph, m = 20, alpha = 0.02/sqrt(r). It compares DSGD, DSGT,
FD-DSGD (Q=100) and FD-DSGT (Q=100) on the exact-wire ``tree`` engine
through the Fig. 2 driver (``repro_torch.benchmarks.fig2_comm_rounds``)
and writes the loss-vs-communication-round curves as CSV to ``--out``
when given.

Part 2 -- the same cohort with FD-DSGT on the ``fused`` engine, Q local
steps per round, with the class-weighted loss. The state lives in one packed
``(20, 1536)`` buffer and every communication round is ONE kernel call:
the DSGT round megakernel (local update + int8 quantize + W mix + error
feedback) on the sequential and pipelined schedules, the DSGT wire-stage
kernel plus a stale mix under bounded staleness (``--fl-schedule
bounded_staleness:k=2``). ``--topk`` masks the wire to the k largest
columns per scale chunk, ``--topk-schedule`` adapts k to the error
feedback residual, ``--fl-topology-program`` makes the hospital graph
change from round to round (each round's realized W goes to the same
kernel; an ``edges_up=`` column shows the share of links up). Prints
the per-round comm bytes of the int8 (or top-k) wire against the fp32
wire a plain engine ships.

``run_sharded_engine`` runs part 2's configuration on the
``sharded_fused`` engine instead, for one rank of a process group
(``repro_torch.launch.mesh.start_group``): the 20 hospitals' rows split
over the ranks, one compact top-k (or dense int8) wire-stage launch per
round and rank, and one all-gather per wire buffer.

  PYTHONPATH=src python -m repro_torch.examples.ehr_federated --iterations 3000 --out curves.csv
  PYTHONPATH=src python -m repro_torch.examples.ehr_federated --iterations 0 --rounds 50 --q 10
  PYTHONPATH=src python -m repro_torch.examples.ehr_federated --iterations 0 --topk 64
  PYTHONPATH=src python -m repro_torch.examples.ehr_federated --iterations 0 \
      --fl-topology-program node_churn:p_down=0.25,mean_downtime=2
"""

from __future__ import annotations

import argparse
import csv
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.benchmarks.fig2_comm_rounds import report, run
from repro_torch.configs.ehr_mlp import CLASS_WEIGHT, class_weights, topk_schedule
from repro_torch.core.dynamics import program_names
from repro_torch.core.engine import ShardedFusedEngine, get_engine, resolve_schedule
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round, tree_map
from repro_torch.core.schedules import inv_sqrt
from repro_torch.core.topology import mixing_matrix
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher
from repro_torch.device import resolve_device
from repro_torch.models.mlp import (
    make_mlp_loss,
    mlp_accuracy,
    mlp_balanced_accuracy,
    mlp_init,
)
from repro_torch.training.trainer import AdaptiveTopK, stack_batches, stack_for_nodes


def run_fused_engine(rounds: int, q: int, scale_chunk: int = 512, seed: int = 0,
                     class_weight=CLASS_WEIGHT, fl_schedule="sequential",
                     topk=None, topk_schedule=None, topology_program=None,
                     device=None, init_params: Optional[Dict] = None) -> Dict:
    """FD-DSGT on the ``fused`` engine, one kernel call per comm round.

    ``fl_schedule``: a round-schedule spec ("sequential", "pipelined",
    "bounded_staleness:k=K"). ``topk``: k payload columns per scale
    chunk; ``topk_schedule=(k_sparse, k_dense, high[, low])`` runs the
    adaptive-k wire instead. ``topology_program``: a ``core.dynamics``
    spec (e.g. ``"node_churn:p_down=0.2,mean_downtime=5"``) that gates
    the hospital graph per round. ``init_params``: one node's starting weights
    (a tree of tensors); default ``mlp_init(seed)``. Tests pass the
    reference's init here. Returns final ``acc``, ``bal_acc``,
    ``wire_saving`` (fp32 bytes over the engine's wire bytes in the last
    round), ``wire_bytes`` of the last round, the per-round ``losses``,
    the final node-stacked ``params`` (a tree), and ``dense_rounds``
    (adaptive k only, else None)."""
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    if topk_schedule is not None and topk is not None:
        raise ValueError("pass either topk or topk_schedule, not both")
    dev = resolve_device(device)
    n = 20
    data = generate_ehr_cohort(seed=seed)
    w = mixing_matrix("hospital20", n)
    batcher = make_node_batcher(data, m=20, seed=seed + 1)

    single = mlp_init(seed, device=dev) if init_params is None else tree_map(
        lambda p: torch.as_tensor(p, device=dev), init_params)
    cfg = FLConfig(algorithm="dsgt", q=q, n_nodes=n)
    adaptive = (AdaptiveTopK(topk_schedule, scale_chunk)
                if topk_schedule is not None else None)
    if adaptive is not None:
        topk = adaptive.k_sparse
    stacked = stack_for_nodes(single, n)
    kw = dict(scale_chunk=scale_chunk, round_schedule=resolve_schedule(fl_schedule),
              topology_program=topology_program)
    engine, flat = get_engine("fused").simulated(w, stacked, topk=topk, **kw)
    loss_fn = make_mlp_loss(class_weights(class_weight))
    round_fn = make_fl_round(loss_fn, inv_sqrt(0.02), cfg, engine)
    dense_fn = None
    if adaptive is not None:
        # the densified twin advances the SAME state (comm keys do not
        # depend on k); the controller switches per round
        dense_engine, _ = get_engine("fused").simulated(
            w, stacked, topk=adaptive.dense_topk, **kw)
        dense_fn = make_fl_round(loss_fn, inv_sqrt(0.02), cfg, dense_engine)
    state = init_fl_state(cfg, flat, engine)

    # The int8 wire ships 1 B per padded column (top-k: k values and their
    # positions) plus one fp32 scale per (node, scale_chunk) block; the
    # fp32 wire ships the unpadded parameters. DSGT ships params AND
    # tracker on both.
    n_params = engine.layout.used
    degrees = (w - np.diag(np.diag(w)) > 0).sum(axis=1)
    fp32_bytes = float(2 * degrees.sum() * n_params * 4)
    wire_label = f"top-{topk}" if topk else "int8"
    graph_note = (f"hospital graph x {engine.topology_program.spec()}"
                  if engine.dynamic_topology else "hospital graph")
    print(f"\nfused engine (FD-DSGT, Q={q}, "
          f"schedule={engine.round_schedule.spec()}, {graph_note}, "
          f"class_weight={class_weight}, {n_params} params -> "
          f"{engine.layout.total} padded, chunk={scale_chunk}, topk={topk}, "
          f"wire={engine.wire_bytes(cfg):,.0f} B/round, device={dev}):")
    losses = []
    m = None
    for rnd in range(1, rounds + 1):
        fn = adaptive.pick(round_fn, dense_fn) if adaptive else round_fn
        state, m = fn(state, stack_batches(batcher, q))
        losses.append(m["loss"])
        if rnd % max(1, rounds // 5) == 0 or rnd == 1:
            k_note = (f" k={adaptive.current_k} "
                      f"resid={float(m['ef_residual_rms']):.1e}"
                      if adaptive is not None else "")
            churn_note = (f" edges_up={float(m['edge_fraction']):.0%}"
                          if "edge_fraction" in m else "")
            print(f"  [round {rnd:4d}] loss={float(m['loss']):.4f} "
                  f"consensus_err={float(m['consensus_err']):.2e} "
                  f"comm_bytes/round={m['wire_bytes']:,.0f} ({wire_label} wire) "
                  f"vs {fp32_bytes:,.0f} (fp32 wire){k_note}{churn_note}")
        if adaptive is not None:
            adaptive.update(float(m["ef_residual_rms"]))
    if adaptive is not None:
        print(f"  adaptive k: {adaptive.dense_rounds}/{rounds} rounds "
              f"densified to k={adaptive.k_dense} (EF residual RMS > "
              f"{adaptive.threshold:g}), "
              f"{rounds - adaptive.dense_rounds} stayed at "
              f"k={adaptive.k_sparse}")

    params = engine.params_view(state.params)
    consensus = tree_map(lambda p: p.mean(dim=0), params)
    xall = torch.as_tensor(np.concatenate(data.features), device=dev)
    yall = torch.as_tensor(np.concatenate(data.labels), device=dev)
    acc = float(mlp_accuracy(consensus, xall, yall))
    bal = float(mlp_balanced_accuracy(consensus, xall, yall))
    saving = fp32_bytes / m["wire_bytes"]
    print(f"  final acc={acc:.3f} bal_acc={bal:.3f}  "
          f"wire saving: {saving:.2f}x "
          f"bytes/round on top of the {q}x round saving (Q={q} local steps "
          f"per exchange) => {q * saving:.0f}x fewer bytes "
          f"per iteration than comm-every-step fp32 gossip")
    return {"acc": acc, "bal_acc": bal, "wire_saving": saving,
            "wire_bytes": m["wire_bytes"],
            "losses": torch.stack(losses).tolist(), "params": params,
            "dense_rounds": adaptive.dense_rounds if adaptive else None}


def run_sharded_engine(group, rounds: int, q: int, algorithm: str = "dsgt",
                       scale_chunk: int = 512, seed: int = 0,
                       class_weight=CLASS_WEIGHT, fl_schedule="sequential",
                       topk=None, init_params: Optional[Dict] = None,
                       log: bool = True) -> Dict:
    """Part 2's configuration on the ``sharded_fused`` engine, for this
    rank of ``group`` (every rank of the group calls it with the same
    arguments). ``topk`` ships the compact exact-k wire where it is
    smaller than the dense int8 chunk. Returns the per-round ``losses``
    and last ``metrics`` (over all 20 hospitals), ``wire_bytes`` of the
    last round, the ``engine`` and the final ``state`` (this rank's
    rows)."""
    if rounds < 1:
        raise ValueError("rounds must be >= 1")
    n = 20
    batcher = make_node_batcher(generate_ehr_cohort(seed=seed), m=20, seed=seed + 1)
    single = mlp_init(seed, device=group.device) if init_params is None else tree_map(
        lambda p: torch.as_tensor(p, device=group.device), init_params)
    cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=n)
    engine, rows = ShardedFusedEngine.from_group(
        group, stack_for_nodes(single, n), w=mixing_matrix("hospital20", n),
        scale_chunk=scale_chunk, topk=topk, round_schedule=fl_schedule)
    round_fn = make_fl_round(make_mlp_loss(class_weights(class_weight)), inv_sqrt(0.02),
                             cfg, engine)
    state = init_fl_state(cfg, rows, engine)
    log = log and group.rank == 0
    if log:
        print(f"\nsharded fused engine ({algorithm.upper()}, Q={q}, "
              f"schedule={engine.round_schedule.spec()}, {group.world} rank(s) x "
              f"{len(engine.rows)} hospitals, {engine.wire_encoding} wire, topk={topk}, "
              f"wire={engine.wire_bytes(cfg):,.0f} B/round, device={group.device}):")
    losses = []
    for rnd in range(1, rounds + 1):
        state, m = round_fn(state, stack_batches(batcher, q))
        losses.append(m["loss"])
        if log and (rnd % max(1, rounds // 5) == 0 or rnd == 1):
            print(f"  [round {rnd:4d}] loss={float(m['loss']):.4f} "
                  f"consensus_err={float(m['consensus_err']):.2e} "
                  f"comm_bytes/round={m['wire_bytes']:,.0f}")
    return {"losses": torch.stack(losses).tolist(), "metrics": m,
            "wire_bytes": m["wire_bytes"], "engine": engine, "state": state}


def reproduce(iterations: int, out: Optional[str] = None, device=None) -> Dict:
    """Part 1: the four Fig. 2 runs at ``iterations`` and the driver's
    report; the curves go to the CSV ``out`` when given. Returns the
    driver's results."""
    print(f"Fig. 2 reproduction ({iterations} iterations per algorithm):")
    results = run(iterations=iterations, device=device)
    if out:
        with open(out, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["algorithm", "comm_round", "loss", "grad_norm_sq",
                        "consensus_err"])
            for name, r in results.items():
                for i in range(len(r["comm_rounds"])):
                    w.writerow([name, int(r["comm_rounds"][i]), r["loss"][i],
                                r["grad_norm_sq"][i], r["consensus_err"][i]])
        print(f"curves -> {out}")
    report(results)
    return results


def _parse_topk_schedule(spec: Optional[str]):
    """'config' (``configs.ehr_mlp.TOPK_SCHEDULE``) or
    'k_sparse:k_dense:high[:low]'."""
    if spec is None:
        return None
    if spec == "config":
        return topk_schedule()
    return topk_schedule(tuple(spec.split(":")))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iterations", type=int, default=3000,
                    help="part 1: iteration budget of each of the four "
                         "algorithms (paper: 3000); 0 skips part 1")
    ap.add_argument("--out", default=None,
                    help="part 1: write the loss-vs-round curves as CSV here")
    ap.add_argument("--rounds", type=int, default=50,
                    help="part 2: communication rounds")
    ap.add_argument("--q", type=int, default=10,
                    help="part 2: local steps per communication round")
    ap.add_argument("--scale-chunk", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--class-weight", default=CLASS_WEIGHT,
                    help="'balanced' (inverse frequency) or 'none' for the "
                         "paper-faithful unweighted loss")
    ap.add_argument("--fl-schedule", default="sequential",
                    help="round schedule: 'sequential', 'pipelined' (mix one "
                         "round stale) or 'bounded_staleness:k=K' (K rounds "
                         "stale, K payloads in flight)")
    ap.add_argument("--topk", type=int, default=None,
                    help="k payload columns per scale chunk (top-k wire)")
    ap.add_argument("--topk-schedule", default=None,
                    help="adaptive k as 'k_sparse:k_dense:high[:low]' or "
                         "'config' for configs.ehr_mlp.TOPK_SCHEDULE: "
                         "densify when the EF-residual RMS exceeds high, "
                         "re-sparsify only below low (hysteresis)")
    ap.add_argument("--fl-topology-program", default=None,
                    help="per-round graph dynamics for part 2 "
                         f"(TopologyProgram registry: "
                         f"{', '.join(program_names())}); e.g. "
                         "'node_churn:p_down=0.2,mean_downtime=5' makes "
                         "the hospital graph time-varying")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain PyTorch twins)")
    args = ap.parse_args(argv)
    if args.iterations > 0:
        reproduce(args.iterations, args.out, device=args.device)
    run_fused_engine(rounds=args.rounds, q=args.q, scale_chunk=args.scale_chunk,
                     seed=args.seed,
                     class_weight=None if args.class_weight == "none"
                     else args.class_weight,
                     fl_schedule=args.fl_schedule, topk=args.topk,
                     topk_schedule=_parse_topk_schedule(args.topk_schedule),
                     topology_program=args.fl_topology_program,
                     device=args.device)


if __name__ == "__main__":
    main()
