"""Communication-efficiency table on the PyTorch port: bytes on the wire
per training ITERATION (counterpart of the reference's
``benchmarks/comm_bytes.py``).

Restates the paper's communication-round saving in transport bytes for
a real model, tinyllama-1.1b's full config: per-node egress bytes per
iteration under each strategy -- ring gossip every step, FD's Q-step
amortization, the bf16 wire, the int8 difference-coded flat wire (one
fp32 scale per 512-column chunk) -- and the all-reduce and star
baselines. The parameter shapes come from the ``meta`` device (nothing
is allocated), so the numbers are hardware-independent and equal the
reference's. Its cross-check against the collective bytes of a compiled
round waits for the port of the dry run (ROADMAP.md queue 1, item 18).

  PYTHONPATH=src python -m repro_torch.benchmarks.comm_bytes \\
      [--arch tinyllama-1.1b] [--out experiments/comm_bytes_torch.json]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict

import torch

from repro_torch.configs import get_config
from repro_torch.core.compression import DEFAULT_SCALE_CHUNK
from repro_torch.core.fl import tree_map
from repro_torch.core.packing import flat_wire_bytes, pack_layout
from repro_torch.models import build_model
from repro_torch.training.metrics import allreduce_bytes, comm_bytes_per_gossip, param_bytes

__all__ = ["N_NODES", "main"]

N_NODES = 16  # single-pod FL nodes


def main(arch: str = "tinyllama-1.1b", log: bool = True) -> Dict:
    """The seven rows of the table for ``arch``'s full config."""
    shapes = build_model(get_config(arch)).param_shapes()
    n = N_NODES
    p = param_bytes(shapes)
    ar = allreduce_bytes(shapes, n)
    rows = []

    def row(name, bytes_per_iter):
        rows.append({"strategy": name, "bytes_per_iter_per_node": bytes_per_iter,
                     "ratio_vs_centralized": bytes_per_iter / ar})

    ring = comm_bytes_per_gossip(shapes, "ring", n)
    ring_bf16 = comm_bytes_per_gossip(shapes, "ring", n, wire_dtype="bfloat16")
    star = comm_bytes_per_gossip(shapes, "star", n)
    stacked = tree_map(lambda l: torch.empty((n,) + tuple(l.shape), dtype=l.dtype,
                                             device="meta"), shapes)
    # the flat int8 wire: the payload (chunk padding included) and one
    # fp32 scale per (node, scale chunk)
    layout = pack_layout(stacked, pad_to=DEFAULT_SCALE_CHUNK)
    ring_int8 = flat_wire_bytes(layout, degree=2, scale_chunk=DEFAULT_SCALE_CHUNK)
    row("centralized all-reduce (every step)", ar)
    row("FedAvg star, Q=100", star / 100)
    row("DSGD/DSGT ring gossip (every step)", ring)
    row("FD ring gossip, Q=10", ring / 10)
    row("FD ring gossip, Q=100 (paper)", ring / 100)
    row("FD ring gossip, Q=100 + bf16 wire", ring_bf16 / 100)
    row("FD ring gossip, Q=100 + int8 diff-coded", ring_int8 / 100)
    if log:
        print(f"communication bytes per iteration per node -- {arch} "
              f"({p / 1e9:.2f} GB fp32 params, N={n}):")
        for r in rows:
            print(f"  {r['strategy']:42s} {r['bytes_per_iter_per_node'] / 1e6:12.2f} MB"
                  f"  ({r['ratio_vs_centralized']:.4f}x centralized)")
    return {"arch": arch, "param_bytes": p, "rows": rows}


def _cli(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--out", default="experiments/comm_bytes_torch.json")
    args = ap.parse_args(argv)
    out = main(args.arch)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    _cli()
