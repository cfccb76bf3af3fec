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
reference's. :func:`cross_check` holds the int8 flat-wire row against a
dry-run record of the two-axis round (``launch.dryrun``, the committed
``experiments/dryrun_torch`` record by default): one edge's message bytes
at S model shards, times S, are the whole node's int8 wire for one edge
and one wire at the layout padded to S tiles of whole chunks; the row
(two ring edges, Q = 100) is the same wire padded to one tile.

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

__all__ = ["N_NODES", "main", "cross_check", "RECORD"]

N_NODES = 16  # single-pod FL nodes
#: the dry-run record :func:`cross_check` reads by default
RECORD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..", "..",
                      "experiments", "dryrun_torch",
                      "tinyllama-1.1b_train_4k_single_sharded_fused_shardmodel_q2.json")


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
    # the flat int8 wire: the payload (chunk padding included) and one
    # fp32 scale per (node, scale chunk)
    ring_int8 = 2 * _int8_edge(shapes, n)
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


def cross_check(table: Dict, record: Dict) -> Dict:
    """The int8 flat-wire row against a dry-run record of the same arch:
    the record's ``wire_bytes_per_shard_one_edge`` x S (the S tiles of
    one node's payload) must equal this table's int8 edge on the layout
    padded to S tiles, and the row's edge (2 ring edges, Q = 100) differs
    from it by the padding alone: the columns S tiles add, one int8 byte
    each, and their chunks' fp32 scales. Raises ``AssertionError`` if
    not; returns the three edges' bytes."""
    two = record["two_axis"]
    s = two["model_shards"]
    assert record["arch"] == table["arch"], (record["arch"], table["arch"])
    shapes = build_model(get_config(table["arch"])).param_shapes()
    edge = two["wire_bytes_per_shard_one_edge"] * s
    padded = _int8_edge(shapes, record["n_nodes"], s)
    assert edge == padded, f"dry run {edge} B an edge vs the table's {padded} at {s} tiles"
    row = next(r for r in table["rows"] if "int8" in r["strategy"])
    row_edge = round(row["bytes_per_iter_per_node"] * 100 / 2)
    extra = (_int8_layout(shapes, N_NODES, s).total - _int8_layout(shapes, N_NODES).total)
    assert padded - row_edge == extra + 4 * extra // DEFAULT_SCALE_CHUNK, (padded, row_edge)
    return {"record_edge_bytes": edge, "table_edge_bytes": row_edge,
            "padding_bytes": padded - row_edge}


def _int8_layout(shapes, n: int, shards: int = 1):
    stacked = tree_map(lambda l: torch.empty((n,) + tuple(l.shape), dtype=l.dtype,
                                             device="meta"), shapes)
    return pack_layout(stacked, pad_to=DEFAULT_SCALE_CHUNK, shards=shards)


def _int8_edge(shapes, n: int, shards: int = 1) -> int:
    """One node's int8 wire to one neighbor, on the layout padded to
    ``shards`` tiles of whole scale chunks."""
    return flat_wire_bytes(_int8_layout(shapes, n, shards), degree=1,
                           scale_chunk=DEFAULT_SCALE_CHUNK)


def _cli(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--out", default="experiments/comm_bytes_torch.json")
    ap.add_argument("--record", default=RECORD,
                    help="a dry-run record of the same arch to cross-check against "
                         "('' skips it)")
    args = ap.parse_args(argv)
    out = main(args.arch)
    if args.record:
        with open(args.record) as f:
            out["cross_check"] = cross_check(out, json.load(f))
        cc = out["cross_check"]
        print(f"cross-check: the dry run's edge x shards {cc['record_edge_bytes']:,} B = the "
              f"int8 row's edge {cc['table_edge_bytes']:,.0f} B + {cc['padding_bytes']:,.0f} B "
              "of padding to whole chunks in every tile")
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=2)
    print(f"wrote {args.out}")
    return out


if __name__ == "__main__":
    _cli()
