"""Two-axis (gossip_node, model_shard) round benchmark (counterpart of the
reference's ``benchmarks/two_axis.py``).

Each (nodes, shards) cell starts its own group of ``nodes x shards``
ranks (``launch.mesh.run_group``: one node a node rank, each node's flat
buffer tiled over ``shards`` model shards), runs full ``sharded_fused``
FD-DSGT rounds on the circulant ring over the node axis with the compact
top-k wire, and reports:

  * ``wire_bytes_per_shard_*`` -- the bytes a round moves over one
    shard's node group (``packing.flat_wire_bytes_per_shard``): the
    guarded columns. Per-shard bytes x shards == the single-axis wire
    bytes: sharding tiles the payload, it never grows it;
  * ``us_n{N}_s{S}`` -- the host clock per round (median over trials;
    unguarded: each cell is its own group of processes).

The cells trade the node axis against the model axis at a fixed budget
of 8 ranks: (8, 1), (4, 2), (2, 4). On CUDA a rank takes a card, so a
cell that needs more ranks than the visible cards is refused (NCCL runs
one rank a device); ``--device cpu`` runs every cell on gloo ranks.

  PYTHONPATH=src python -m repro_torch.benchmarks.two_axis --smoke --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import time
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.engine import ShardedFusedEngine
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
from repro_torch.core.schedules import constant
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import run_group

__all__ = ["CELLS", "run_cell", "two_axis_row", "main"]

# (nodes, shards) cells: the same 8-rank budget, the shard axis traded
# against the node axis. The s = 1 cell is the single-axis reference.
CELLS: Tuple[Tuple[int, int], ...] = ((8, 1), (4, 2), (2, 4))

SMOKE = dict(total=1024, chunk=64, topk=8, rounds=5, trials=3)
FULL = dict(total=8192, chunk=256, topk=32, rounds=20, trials=5)


def _cell(group, nodes: int, total: int, chunk: int, topk: int, algorithm: str,
          q: int, rounds: int, trials: int) -> Dict:
    """One rank of a cell: warm-up round, then ``trials`` timings of
    ``rounds`` rounds (every rank times; rank 0's record is kept)."""
    rng = np.random.default_rng(0)
    params = {"w": torch.tensor(rng.normal(size=(nodes, total)), dtype=torch.float32)}
    batches = {"t": rng.normal(size=(q, nodes)).astype(np.float32)}
    shards = group.model_shards

    def loss(p, batch):
        return ((p["w"] - batch["t"][:, None]) ** 2).sum(dim=1) / total

    engine, rows = ShardedFusedEngine.from_group(
        group, params, scale_chunk=chunk, topk=topk,
        model_axis="model" if shards > 1 else None)
    cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=nodes)
    round_fn = make_fl_round(loss, constant(0.01), cfg, engine)
    state = init_fl_state(cfg, rows, engine)
    state, _ = round_fn(state, batches)
    samples = []
    for _ in range(trials):
        if group.device.type == "cuda":
            torch.cuda.synchronize(group.device)
        t0 = time.perf_counter()
        for _ in range(rounds):
            state, m = round_fn(state, batches)
        float(m["loss"])
        samples.append((time.perf_counter() - t0) / rounds * 1e6)
    return {
        "nodes": nodes,
        "shards": int(engine.model_shards),
        "total_params": int(engine.layout.total),
        "shard_width": int(engine.layout.shard_width),
        "us_per_round": float(statistics.median(samples)),
        "wire_bytes_per_shard": float(engine.wire_bytes_per_shard(cfg)),
        "wire_bytes_per_round": float(engine.wire_bytes(cfg)),
    }


def run_cell(nodes: int, shards: int, *, total: int = 8192, chunk: int = 256,
             topk: int = 32, algorithm: str = "dsgt", q: int = 2, rounds: int = 20,
             trials: int = 5, device=None) -> Dict:
    """Run one (nodes, shards) cell as its own group; return its record."""
    return run_group(_cell, nodes * shards, device=device, node_axes={"data": nodes},
                     model_shards=shards,
                     args=(nodes, total, chunk, topk, algorithm, q, rounds, trials))


def two_axis_row(smoke: bool = False, device=None) -> Dict:
    """The reference's BENCH row: one record spanning all cells; each
    cell's per-shard bytes x shards must equal its round's wire bytes."""
    kw = SMOKE if smoke else FULL
    dev = resolve_device(device)
    row: Dict = {
        "name": "two_axis_round_dsgt",
        "total_params": kw["total"],
        "scale_chunk": kw["chunk"],
        "topk": kw["topk"],
        "q": 2,
        "model_shards": max(s for _, s in CELLS),
        "device": str(dev),
        "note": "full sharded_fused DSGT rounds on the circulant ring over "
                "'data', one group of nodes x shards ranks per cell; "
                "wire_bytes_per_shard_* are the bytes a round moves over one "
                "shard's node group (guarded) -- per-shard bytes x shards == "
                "the single-axis wire bytes. us_* are host clock, unguarded.",
    }
    print(f"Two-axis round time vs node count x shard count (DSGT, total="
          f"{kw['total']}, 8 ranks, {dev})")
    for nodes, shards in CELLS:
        rec = run_cell(nodes, shards, algorithm="dsgt", device=dev, **kw)
        tag = f"n{nodes}_s{shards}"
        row[f"us_{tag}"] = rec["us_per_round"]
        row[f"wire_bytes_per_shard_{tag}"] = rec["wire_bytes_per_shard"]
        row[f"wire_bytes_per_round_{tag}"] = rec["wire_bytes_per_round"]
        if abs(rec["wire_bytes_per_shard"] * shards - rec["wire_bytes_per_round"]) > 1e-6:
            raise AssertionError(f"cell {tag}: per-shard bytes x shards != wire bytes: {rec}")
        print(f"  N={nodes:2d} x S={shards:2d}: {rec['us_per_round']:9.1f} us/round, "
              f"{rec['wire_bytes_per_shard']:.0f} wire B/shard "
              f"({rec['wire_bytes_per_round']:.0f} B/round)")
    return row


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="seconds-scale cells (total 1024, chunk 64, top-8, 5 rounds)")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda: one rank a card; 'cpu' runs "
                         "gloo ranks)")
    ap.add_argument("--out", default="experiments/two_axis_torch.json")
    args = ap.parse_args(argv)
    row = two_axis_row(smoke=args.smoke, device=args.device)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(row, f, indent=2)
    print(f"wrote {args.out}")
    return row


if __name__ == "__main__":
    main()
