"""Time the round megakernels, the gossip stage and the DSGT compact wire
stage on one CUDA card.

    PYTHONPATH=<tree>/src python3 tools/round_kernel_times.py --label NAME

Times ``fused_round``, ``fused_round_gt`` and ``gossip_mix`` through their
wrappers in ``repro_torch.kernels.gossip.ops`` at the main path's (20, 1536)
buffer (hospital20 graph, dense and top-64) and at (64, 1,048,576) (8 x 8
torus), and ``wire_stage_gt_compact`` at (20, 1536) on the top-64 bitmap
wire (``main``), at (64, 1,048,576) on the same wire (``large``) and at
(20, 1536) on the top-16 positions wire (``main top-16``), scale chunk 512,
by CUDA events: the median of 60 calls after 5 of warm-up,
a spin kernel ahead of each call holding the stream while the host enqueues
it, as ``chip_smoke.py`` times them. The ``repro_torch`` that runs is the
one PYTHONPATH names, so one call can time two trees in turns (earlier,
present, present, earlier). Prints the card's name and power limit, a line
a case, and one JSON line ``{"label": ..., "card": ..., "us": {...}}``.
Exits 1 without a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from repro_torch.core.topology import mixing_matrix
from repro_torch.kernels.gossip.ops import (
    fused_round,
    fused_round_gt,
    gossip_mix,
    wire_stage_gt_compact,
)

# (label, nodes, flat width, topology, topk)
CASES = [("main", 20, 1536, "hospital20", None), ("large", 64, 1 << 20, "torus:8x8", None),
         ("main top-64", 20, 1536, "hospital20", 64)]
# the DSGT compact wire stage: (label, nodes, flat width, topk, bitmap)
COMPACT_CASES = [("main", 20, 1536, 64, True), ("large", 64, 1 << 20, 64, True),
                 ("main top-16", 20, 1536, 16, False)]
CHUNK = 512
ALPHA = np.float32(0.02)


def device_ms(fn, reps: int = 60, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(max(host_s, 1e-4) * 4e9)
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def record(out: dict, label: str, card: str, key: str, n: int, t: int, ms: float) -> None:
    out[key] = ms * 1e3
    print(f"{label}: {key} ({n}x{t}): {ms * 1e3:.2f} us [{card}]", flush=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--label", default="tree")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("round_kernel_times: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True,
                          timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for label, n, t, topo, topk in CASES:
        w = mixing_matrix(topo, n)
        w_self = torch.tensor(np.diag(w).astype(np.float32), device="cuda")
        w_off = torch.tensor((w - np.diag(np.diag(w))).astype(np.float32), device="cuda")
        for name, kernel, n_bufs, extra in (("fused_round", fused_round, 4, (ALPHA,)),
                                            ("fused_round_gt", fused_round_gt, 8, (ALPHA,)),
                                            ("gossip_mix", gossip_mix, 3, ())):
            bufs = [torch.randn(n, t, generator=gen, device="cuda") for _ in range(n_bufs)]
            ms = device_ms(lambda: kernel(*bufs, w_off, w_self, *extra, scale_chunk=CHUNK,
                                          topk=topk))
            record(out, args.label, card, f"{name} {label}", n, t, ms)
            del bufs
            torch.cuda.empty_cache()
    for label, n, t, topk, bitmap in COMPACT_CASES:
        bufs = [torch.randn(n, t, generator=gen, device="cuda") for _ in range(8)]
        ms = device_ms(lambda: wire_stage_gt_compact(*bufs, ALPHA, scale_chunk=CHUNK,
                                                     topk=topk, bitmap=bitmap))
        record(out, args.label, card, f"wire_stage_gt_compact {label}", n, t, ms)
        del bufs
        torch.cuda.empty_cache()
    print(json.dumps({"label": args.label, "card": card, "us": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
