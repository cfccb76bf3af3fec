"""Roofline over the port's dry-run records, priced for the H100
(counterpart of the reference's ``benchmarks/roofline.py``).

Per (arch x shape) on the single-pod layout, the three roofline terms of
one rank from ``launch.dryrun``'s op-level counts (every record number is
already per rank):

    compute    = flops         / PEAK_FLOPS
    memory     = traffic_bytes / HBM_BYTES_S
    collective = (collective bytes within a host) / NVLINK_BYTES_S
                 + (cross-host bytes)             / IB_BYTES_S

with the H100 SXM's published limits: 989 TFLOP/s dense bf16 on the
tensor cores and 3.35 TB/s of HBM3 (NVIDIA's H100 data sheet, the
figures of ``PERF.md`` section 3 and ``benchmarks/kernel_bench.py``);
NVLink 4 within an 8-GPU HGX host, 900 GB/s a GPU both ways, so 450 GB/s
a direction; across hosts one 400 Gb/s NDR InfiniBand adapter a GPU
(the HGX H100 reference design), applied to ``op_analysis``'s cross-host
bytes. Also MODEL_FLOPS = 6 N D (train; 2 N D serving; N the active
parameters, D the tokens) and the usefulness ratio MODEL_FLOPS / the
counted FLOPs of all ranks, the dominant term and its lever.

  PYTHONPATH=src python -m repro_torch.benchmarks.roofline [--mesh single] [--json]
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional

from repro_torch.benchmarks import kernel_bench as kb
from repro_torch.benchmarks.run_dryruns import ARCHS, SHAPE_NAMES, record_path

#: dense bf16 tensor-core FLOP/s and HBM3 bytes/s of the H100 SXM
PEAK_FLOPS, HBM_BYTES_S = kb.BF16_OPS_S, kb.HBM_BYTES_S
#: NVLink 4 within a host: 900 GB/s a GPU, both directions together
NVLINK_BYTES_S = 900e9 / 2
#: one NDR InfiniBand adapter a GPU across hosts: 400 Gb/s
IB_BYTES_S = 400e9 / 8

SHAPE_TOKENS = {
    "train_4k": (4096, 256),
    "prefill_32k": (32768, 32),
    "decode_32k": (1, 128),  # one new token per request
    "long_500k": (1, 1),
}

LEVERS = {
    "compute": "raise per-chip utilization: the two-axis layout computes each node's "
               "whole step on every model shard (tensor-parallel layers, item 18b)",
    "memory": "cut HBM traffic: fused (flash) attention backward, chunked loss, bf16 "
              "activations",
    "collective": "cut wire bytes: larger Q, the compact top-k wire, hierarchical pod "
                  "gossip; the metrics' full-width all-reduces",
}


def load_records(mesh: str = "single") -> List[Dict]:
    """The sweep's records for ``mesh`` (``run_dryruns``' file names)."""
    recs = []
    for arch in ARCHS:
        for shape in SHAPE_NAMES:
            path = record_path(arch, shape, mesh)
            if os.path.exists(path):
                with open(path) as f:
                    recs.append(json.load(f))
    return recs


def roofline_row(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok":
        return {"arch": rec["arch"], "shape": rec["shape"], "status": rec["status"],
                "reason": rec.get("reason", "")}
    coll = rec["collectives"]
    cross = coll.get("cross_node_bytes", 0.0)
    t_compute = rec["flops"] / PEAK_FLOPS
    t_memory = rec["traffic_bytes"] / HBM_BYTES_S
    t_cross = cross / IB_BYTES_S
    t_coll = (coll["total_bytes"] - cross) / NVLINK_BYTES_S + t_cross
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)

    seq, batch = SHAPE_TOKENS[rec["shape"]]
    tokens_global = seq * batch
    if rec["kind"] == "train" and rec.get("q"):
        tokens_global *= rec["q"]
    if rec["arch"] == "whisper-medium" and rec["kind"] != "train":
        tokens_global = min(seq, 448) * batch  # whisper prompts are capped at 448
    n_active = rec.get("active_params") or rec.get("model_params") or 0
    model_flops = (6.0 if rec["kind"] == "train" else 2.0) * n_active * tokens_global
    counted = rec["flops"] * rec["n_chips"]
    row = {
        "arch": rec["arch"], "shape": rec["shape"], "status": "ok", "kind": rec["kind"],
        "t_compute_s": t_compute, "t_memory_s": t_memory, "t_collective_s": t_coll,
        "t_cross_node_s": t_cross, "dominant": dominant,
        "bound_fraction": terms[dominant] / (sum(terms.values()) + 1e-30),
        "model_flops_global": model_flops, "counted_flops_global": counted,
        "useful_ratio": model_flops / counted if counted else 0.0,
        "lever": LEVERS[dominant],
        "memory_temp_bytes": rec["memory"]["temp_bytes"],
        "memory_arg_bytes": rec["memory"]["argument_bytes"],
    }
    two = rec.get("two_axis")
    if two:
        # one shard's gossip over its node group: every message of this
        # layout crosses hosts (its node group's ranks are 16 apart)
        row["model_shards"] = two["model_shards"]
        row["wire_bytes_per_shard_per_round"] = two["wire_bytes_per_shard_per_round"]
        row["t_wire_per_shard_s"] = two["wire_bytes_per_shard_per_round"] / IB_BYTES_S
    return row


def format_table(rows: List[Dict]) -> str:
    hdr = (f"{'arch':26s} {'shape':12s} {'compute(s)':>11s} {'memory(s)':>11s} "
           f"{'collect(s)':>11s} {'dominant':>10s} {'useful':>7s}")
    lines = [hdr, "-" * len(hdr)]
    for r in rows:
        if r.get("status") != "ok":
            lines.append(f"{r['arch']:26s} {r['shape']:12s} "
                         f"{'SKIP: ' + r.get('reason', '')[:60]}")
            continue
        lines.append(f"{r['arch']:26s} {r['shape']:12s} {r['t_compute_s']:11.4f} "
                     f"{r['t_memory_s']:11.4f} {r['t_collective_s']:11.4f} "
                     f"{r['dominant']:>10s} {r['useful_ratio']:7.3f}")
    return "\n".join(lines)


def rows_for(mesh: str = "single") -> List[Dict]:
    return [r for r in (roofline_row(rec) for rec in load_records(mesh)) if r]


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    rows = rows_for(args.mesh)
    if args.json:
        print(json.dumps(rows, indent=2))
        return rows
    print(f"H100 SXM: {PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16, {HBM_BYTES_S / 1e12:.2f} TB/s "
          f"HBM, NVLink {NVLINK_BYTES_S / 1e9:.0f} GB/s a direction, InfiniBand "
          f"{IB_BYTES_S * 8 / 1e9:.0f} Gb/s a GPU across hosts")
    print(format_table(rows))
    oks = [r for r in rows if r.get("status") == "ok"]
    if oks:
        worst = min(oks, key=lambda r: r["useful_ratio"])
        collbound = max(oks, key=lambda r: r["t_collective_s"])
        print(f"\nworst useful-ratio: {worst['arch']} x {worst['shape']} "
              f"({worst['useful_ratio']:.3f})")
        print(f"most collective-bound: {collbound['arch']} x {collbound['shape']} "
              f"({collbound['t_collective_s']:.3f}s)")
    return rows


if __name__ == "__main__":
    main()
