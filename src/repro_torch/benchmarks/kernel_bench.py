"""Kernel micro-benchmarks on the card: every hand-written kernel of the
port against its plain PyTorch twin, its bound and, for attention,
``scaled_dot_product_attention`` (the port's recast of the reference's
``benchmarks/kernel_bench.py``, which times its jnp formulations on the
host because its container has no TPU).

Each (kernel, shape) case is timed with CUDA events: the median of 60
calls after warm-up, a spin kernel ahead of each call so the events
bracket device work only (:func:`device_ms`). The bound is the least time
the card could take for the same work: the larger of the bytes the
function must move (each input read once, each output written once) over
the HBM rate and its operations -- counted for this run's data where the
work depends on it (the top-k radix select's histogram adds) -- over the
peak of their type (fp32 outside the tensor cores; bf16 on them for
attention). The counters below are the one copy of those counts:
``chip_smoke.py`` phase 4 times its kernel rows through this module.

Shapes (``PERF.md`` section 6): the gossip kernels at the paper's (20,
1536) buffer at chunk 512 (``main``), (64, 1,048,576) (``large``) and
the main shape on the top-64 wire (the compact stages also top-16
positions); the round kernels' two-pass route, its wire stage and its
mix at 1,024 nodes (``federation-1024``, on the card only; the mix also
on a 1,024-node ring and the 512-node complete graph, beside
``torch.sparse.mm``); decode attention at SmolLM-360M's serving path (B 8, 191 of
4,096 slots live), a full 32,768-slot cache and RecurrentGemma-2B's hd
256; flash at the path's prefill (B 8, S 128), S 4096 and hd 256 in a
2048 window; the scans at RWKV6-7B's / RecurrentGemma-2B's prefill (S
128) and decode (S 1) shapes and S 4096. Each writes one JSON row: µs of
the kernel, the twin, the bound and the library call, ``bound_by``, and
the card's name and power limit.

``--device cpu`` times the twins alone (host clock, median) and writes
null in the kernel and library columns: the bound is the H100's, computed
from the counts, not a measurement.

  python3 -m repro_torch.benchmarks.kernel_bench [--device cpu]
      [--shapes main,path] [--out experiments/kernel_bench_torch.json]
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import statistics
import subprocess
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.topology import mixing_matrix
from repro_torch.device import resolve_device
from repro_torch.kernels import build as kbuild
from repro_torch.kernels.decode_attention.ops import (
    combine_partials,
    decode_attention,
    split_plan,
)
from repro_torch.kernels.decode_attention.ref import (
    combine_partials_ref,
    decode_attention_ref,
)
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.gossip.ops import (
    GOSSIP_STAGE,
    compact_gt_plan,
    fused_round,
    fused_round_gt,
    gossip_mix,
    plan_round,
    plan_route,
    round_mix,
    wire_stage,
    wire_stage_compact,
    wire_stage_gossip,
    wire_stage_gt,
    wire_stage_gt_compact,
)
from repro_torch.kernels.gossip.ref import (
    fused_round_gt_ref,
    fused_round_ref,
    gossip_mix_ref,
    round_mix_ref,
    wire_stage_compact_ref,
    wire_stage_gossip_ref,
    wire_stage_gt_compact_ref,
    wire_stage_gt_ref,
    wire_stage_ref,
)
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_ref
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

__all__ = ["HBM_BYTES_S", "FP32_OPS_S", "BF16_OPS_S", "Case", "bound", "device_ms",
           "gossip_cases", "two_pass_cases", "compact_cases", "attention_cases", "scan_cases",
           "decode_case", "flash_case", "combine_case", "time_case", "time_cases",
           "launch_floor", "run", "main"]

# Published peaks of the H100 SXM (NVIDIA data sheet): HBM bytes/s, fp32
# operations/s outside the tensor cores and dense bf16 tensor-core
# operations/s, at its full 700 W limit.
HBM_BYTES_S, FP32_OPS_S, BF16_OPS_S = 3.35e12, 67e12, 989e12

CSRC = "src/repro_torch/kernels/gossip/csrc/"
KERNELS = {
    # name: (wrapper, twin, wires, TPU kernel it replaces, source)
    "fused_round": (fused_round, fused_round_ref, 1,
                    "src/repro/kernels/gossip/gossip.py:421",
                    CSRC + "fused_round_cluster.cu"),
    "fused_round_gt": (fused_round_gt, fused_round_gt_ref, 2,
                       "src/repro/kernels/gossip/gossip.py:476",
                       CSRC + "fused_round_cluster.cu"),
}
WIRE_KERNELS = {
    "wire_stage": (wire_stage, wire_stage_ref, 1,
                   "src/repro/kernels/gossip/gossip.py:631", CSRC + "wire_stage.cu"),
    "wire_stage_gt": (wire_stage_gt, wire_stage_gt_ref, 2,
                      "src/repro/kernels/gossip/gossip.py:679", CSRC + "wire_stage.cu"),
}
GOSSIP_KERNELS = {
    "gossip_mix": (gossip_mix, gossip_mix_ref, GOSSIP_STAGE,
                   "src/repro/kernels/gossip/gossip.py:378",
                   CSRC + "fused_round_cluster.cu"),
}
ALL_KERNELS = {**GOSSIP_KERNELS, **KERNELS, **WIRE_KERNELS}
# the wire stage that is pass 1 of each round's two-pass route (with no
# int8 store), by round: name -> (wire wrapper, its twin, takes alpha)
ROUTE_WIRES = {
    "gossip_mix": (wire_stage_gossip, wire_stage_gossip_ref, False),
    "fused_round": (wire_stage, wire_stage_ref, True),
    "fused_round_gt": (wire_stage_gt, wire_stage_gt_ref, True),
}
COMPACT_KERNELS = {
    "wire_stage_compact": (wire_stage_compact, wire_stage_compact_ref, 1,
                           "src/repro/kernels/gossip/gossip.py:853",
                           CSRC + "wire_stage_compact.cu"),
    "wire_stage_gt_compact": (wire_stage_gt_compact, wire_stage_gt_compact_ref, 2,
                              "src/repro/kernels/gossip/gossip.py:926",
                              CSRC + "wire_stage_compact.cu"),
}
ATTENTION_KERNELS = {
    # name: (TPU kernel it replaces, source)
    "decode_attention": ("src/repro/kernels/decode_attention/decode_attention.py:80",
                         "src/repro_torch/kernels/decode_attention/csrc/decode_attention.cu"),
    # the path runs bf16: the tensor-core kernel (fp32 goes to flash_attention.cu)
    "flash_attention": ("src/repro/kernels/flash_attention/flash_attention.py:113",
                        "src/repro_torch/kernels/flash_attention/csrc/flash_attention_tc.cu"),
}
SCAN_KERNELS = {
    # name: (TPU kernel it replaces, source)
    "wkv6": ("src/repro/kernels/rwkv6_scan/rwkv6_scan.py:78",
             "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu"),
    "rglru_scan": ("src/repro/kernels/rglru_scan/rglru_scan.py:55",
                   "src/repro_torch/kernels/rglru_scan/csrc/rglru_scan.cu"),
}

ALPHA = np.float32(0.02)
TOPK_MAIN = 64  # the reference example's --topk
# (label, nodes, flat width, scale chunk, topology): the paper's buffer
# and a shape that makes the gossip kernels bandwidth-bound
MAIN = ("main", 20, 1536, 512, "hospital20")
LARGE = ("large", 64, 1 << 20, 512, "torus:8x8")
# the first federation whose rounds only the two-pass route serves at
# this width: 1,024 nodes on an Erdos-Renyi graph of about ten neighbours
# a node (p = 0.01), 262,144 columns (1 GB a buffer)
FEDERATION = ("federation-1024", 1024, 262_144, 512, "erdos_renyi")
FEDERATION_P = 0.01
# the mix alone on the extremes of W's sparsity, on DSGD's one wire:
# (label, nodes, flat width, topology) -- two neighbours a node at the
# federation's size, and every node a neighbour at 512
MIX_GRAPHS = [("ring-1024", 1024, 262_144, "ring"), ("complete-512", 512, 65_536, "complete")]
# attention: (label, B, cache slots, live slots, q-heads, kv-heads, hd):
# SmolLM-360M's serving path at its last decode step (128 + 64 tokens),
# a full 32,768-slot cache, RecurrentGemma-2B's at its last (128 + 32,
# a 2048-slot ring)
DECODE_SHAPES = [("path", 8, 4096, 191, 15, 5, 64),
                 ("large", 8, 32768, 32768, 15, 5, 64),
                 ("hd256 path", 8, 2048, 159, 10, 1, 256)]
# (label, B, S, q-heads, kv-heads, hd, window), causal
FLASH_SHAPES = [("path", 8, 128, 15, 5, 64, 0),
                ("large", 2, 4096, 15, 5, 64, 0),
                ("hd256 path", 8, 128, 10, 1, 256, 2048)]
# the scans: (label, S) at B 8, WKV-6's 64 heads and RG-LRU's width 2560
SCAN_SHAPES = [("path prefill", 128), ("path decode", 1), ("large", 4096)]
SCAN_B, WKV_H, LRU_W = 8, 64, 2560
# attention kernel vs twin (and the library yardstick vs the twin): fp32
# within 1e-5; bf16 within 1.6e-2 x (1 + |twin|)
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1.6e-2}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Bytes and operations
# ---------------------------------------------------------------------------


def round_bytes(n: int, t: int, chunk: int, wires: int) -> int:
    """HBM bytes one round kernel must move: each (n, t) input read once
    (DSGD 4, DSGT 8), each output written once (3 / 6), the weights, the
    scales and alpha."""
    bufs = (4 + 3) if wires == 1 else (8 + 6)
    return 4 * (n * t * bufs + n * n + n + wires * n * (t // chunk) + 1)


def stage_ops(n: int, t: int, chunk: int, topk=None) -> int:
    """fp32 operations of the quantize-EF stage of one wire, counted from
    csrc/quantize.cuh with error feedback and difference coding on. Per
    element: payload (sub, add), |payload| and its max, divide, rint,
    clip (min, max), q * scale, recon' (add), res' (sub); with the top-k
    mask also 31 search steps of |payload| and a compare, and the mask's
    own |payload| and compare. Per (row, chunk): max / 127 and the safe
    select."""
    per_element = 11 + (2 * 31 + 2 if topk else 0)
    return n * t * per_element + 2 * n * (t // chunk)


def update_ops(n: int, t: int, wires: int) -> int:
    """The local update, per element once: 2 for DSGD (mul, sub), 4 for
    DSGT (t_half: add, sub; h: mul, sub)."""
    return n * t * 2 * wires


def mix_terms(w_off: torch.Tensor) -> float:
    """The multiply-adds a row of the mix ``W_off @ nbr`` needs, averaged
    over the rows: W_off's nonzeros a row, the function's work on this
    run's W, and the terms the two-pass route's mix kernel runs (its
    lists, ``ops.mix_lists``). (The one-pass round kernels run W_off's
    nonzero 4 x 4 blocks, zeros inside a block included.)"""
    return float(torch.count_nonzero(w_off.detach()).item()) / w_off.shape[0]


def round_ops(n: int, t: int, chunk: int, wires: int, topk=None, terms=None) -> int:
    """Operations of one round kernel (csrc/fused_round_cluster.cu), per
    element and wire: payload (sub, add), |payload| and its max, divide,
    rint, clip (min, max), q * scale, recon' (add), res' (sub); with the
    top-k mask also the mask's |payload| and compare and the radix
    select's 4 passes (a candidate compare and a histogram add each); then
    w_self * src + mix (mul, add) and the multiply-adds of the mix,
    ``terms`` a row (:func:`mix_terms` of this run's W_off; n if dense).
    Per (row, chunk): max / 127 and the safe select. Plus the local
    update."""
    terms = n if terms is None else terms
    per_element = 11 + (2 + 4 * 2 if topk else 0) + 2 + 2 * terms
    per_wire = int(n * t * per_element) + 2 * n * (t // chunk)
    return wires * per_wire + update_ops(n, t, wires)


def gossip_bytes(n: int, t: int, chunk: int) -> int:
    """HBM bytes one gossip-stage kernel must move: x, recon and res read
    once, mixed, recon' and res' written once, the scales and the
    weights."""
    return 4 * (n * t * 6 + n * (t // chunk) + n * n + n)


def radix_adds(payload: torch.Tensor, chunk: int, topk: int) -> int:
    """The histogram adds of the radix select (csrc/select.cuh) over this
    run's payload rows, one select a (row, chunk): the first pass adds
    every element, a later pass those whose bits above its digit equal the
    threshold's (the k-th largest |payload|)."""
    mag = payload.abs().reshape(-1, chunk)
    thr = torch.kthvalue(mag, chunk - topk + 1, dim=1, keepdim=True).values
    bits, tbits = mag.view(torch.int32), thr.view(torch.int32)
    return mag.numel() + sum(int(((bits >> s) == (tbits >> s)).sum()) for s in (24, 16, 8))


def gossip_ops(n: int, t: int, chunk: int, topk=None, terms=None, adds: int = 0) -> int:
    """Operations of one gossip-stage launch (``round_kernel`` with no
    update in csrc/fused_round_cluster.cu), counted for this run's data,
    per element: payload (sub, add), |payload| and its max, divide, rint,
    clip (min, max), q * scale, recon' (add), res' (sub); with the top-k
    mask also the mask's |payload| and compare, the radix select's
    candidate compare in each of its 4 passes and its ``adds``
    (:func:`radix_adds`); then w_self * x + mix (mul, add) and the mix's
    multiply-adds, ``terms`` a row (:func:`mix_terms`). Per (row, chunk):
    max / 127 and the safe select. The bytes bound it several times over."""
    terms = n if terms is None else terms
    per_element = 11 + (2 + 4 if topk else 0) + 2 + 2 * terms
    return int(n * t * per_element) + adds + 2 * n * (t // chunk)


def wire_bytes_moved(n: int, t: int, chunk: int, wires: int, q: bool = True) -> int:
    """HBM bytes one wire-stage kernel must move: each (n, t) fp32 input
    read once (the gossip stage, ``wires`` :data:`GOSSIP_STAGE`, 3; DSGD
    4; DSGT 8), each output written once (recon' and res' a wire, DSGD's
    h, DSGT's h and t_half, and the int8 q a wire unless ``q`` is False,
    as on the two-pass route), the scales and alpha (no update, no
    alpha for the gossip stage)."""
    reads, writes = {GOSSIP_STAGE: (3, 2), 1: (4, 3), 2: (8, 6)}[wires]
    nw = max(wires, 1)
    return (4 * (reads + writes) * n * t + (nw * n * t if q else 0)
            + 4 * nw * n * (t // chunk) + (4 if wires else 0))


def wire_ops(n: int, t: int, chunk: int, wires: int, topk=None) -> int:
    """fp32 operations of one wire-stage kernel (csrc/wire_stage.cu): the
    gossip stage's one wire has no update."""
    return max(wires, 1) * stage_ops(n, t, chunk, topk) + update_ops(n, t, wires)


def mix_bytes(n: int, t: int, wires: int) -> int:
    """HBM bytes the two-pass route's mix kernel (csrc/round_mix.cu) must
    move: each wire's neighbour view and self term read once and its
    mixed written once, W_off and w_self."""
    return 4 * (3 * wires * n * t + n * n + n)


def mix_ops(n: int, t: int, wires: int, terms=None) -> int:
    """fp32 operations of the mix, per element and wire: the
    multiply-adds of W_off's nonzeros, ``terms`` a row (:func:`mix_terms`
    of this run's W_off; n if dense), and w_self * self (mul, add)."""
    terms = n if terms is None else terms
    return int(wires * n * t * (2 + 2 * terms))


def route_ops(n: int, t: int, chunk: int, wires: int, topk=None, terms=None) -> int:
    """Operations of a round on the two-pass route: the wire pass's and
    the mix's."""
    return wire_ops(n, t, chunk, wires, topk) + mix_ops(n, t, max(wires, 1), terms)


def compact_bytes_moved(n: int, t: int, chunk: int, wires: int, topk: int,
                        bitmap: bool) -> int:
    """HBM bytes one compact wire-stage kernel must move: each (n, t) fp32
    input read once (DSGD 4, DSGT 8), h (and t_half) and each wire's
    recon' and res' written once, and each wire's compact payload: k int8
    values and k int16 positions, or the chunk/8-byte bitmap, and one fp32
    scale per (row, chunk); alpha."""
    c = t // chunk
    payload = n * c * (topk + (chunk // 8 if bitmap else 2 * topk) + 4)
    return 4 * ((4 + 3) if wires == 1 else (8 + 6)) * n * t + wires * payload + 4


def compact_ops(n: int, t: int, chunk: int, topk: int, bitmap: bool) -> int:
    """Operations of one DSGD compact wire-stage launch
    (``compact_stage`` in csrc/wire_stage_compact.cu): per element the
    payload (sub, add), |payload| and its max, 31 threshold-search steps
    (|p|, compare), the above/equal counts (3 compares) and the
    recon'/res' pass (select, add, sub); per survivor the quantize twice
    (divide, rint, min, max) and q * scale + 0; with positions also the
    rank over the k survivors (2 compares each); per (row, chunk) the
    scale's divide and select. Plus the local update."""
    c = t // chunk
    return (n * t * (4 + 2 * 31 + 3 + 3) + n * c * topk * (10 + (0 if bitmap else 2 * topk))
            + 2 * n * c + update_ops(n, t, 1))


def compact_gt_payloads(x, t, g, gp, rx, sx, rt, st) -> list:
    """The DSGT compact stage's two payloads with error feedback and
    difference coding (the timed flags)."""
    t_half = (t + g) - gp
    h = x - torch.tensor(ALPHA, device=x.device) * t_half
    return [(t_half - rt) + st, (h - rx) + sx]


def compact_gt_ops(n: int, t: int, chunk: int, topk: int, bitmap: bool, adds: int) -> int:
    """Operations of one DSGT compact wire-stage launch
    (``wire_stage_gt_compact_kernel`` in csrc/wire_stage_compact.cu),
    counted for this run's data, per wire: per element the payload (sub,
    add), |payload| and its max, the radix select's candidate compare in
    each of its 4 passes, the above/at compares and the recon'/res' pass
    (add, sub); the select's histogram ``adds`` (:func:`radix_adds`, both
    wires); per survivor the quantize (divide, rint, min, max) and q *
    scale + 0, with positions the rank (2 compares over the k survivors)
    and the quantize again; per (row, chunk) the scale's divide and
    select. Plus the local update. The bytes bound it several times over."""
    c = t // chunk
    per_wire = (n * t * (4 + 4 + 2 + 2) + n * c * topk * (6 + (0 if bitmap else 2 * topk + 4))
                + 2 * n * c)
    return 2 * per_wire + adds + update_ops(n, t, 2)


def decode_bytes(b: int, live: int, h: int, kv: int, hd: int) -> int:
    """bf16 decode attention: q read and the output written (B, H, hd),
    the live K and V slots read once, the int32 lengths."""
    return 2 * (2 * b * h * hd + 2 * b * live * kv * hd) + 4 * b


def decode_flops(b: int, live: int, h: int, hd: int) -> int:
    """q . k and p v over the live slots: 4 hd a (head, slot)."""
    return 4 * b * h * live * hd


def flash_bytes(b: int, sq: int, sk: int, h: int, kv: int, hd: int) -> int:
    """bf16 prefill attention: q and the output (B, Sq, H, hd), K and V
    (B, Sk, K, hd), each once."""
    return 2 * (2 * b * sq * h * hd + 2 * b * sk * kv * hd)


def flash_flops(b: int, sq: int, sk: int, h: int, hd: int, causal: bool,
                window: int = 0) -> int:
    """The live (query, key) pairs, 4 hd each; a causal ``window`` w > 0
    keeps the w latest keys of each query."""
    pairs = sq * (sq + 1) // 2 if causal else sq * sk  # live pairs per head
    if causal and 0 < window < sq:
        pairs = window * (window + 1) // 2 + (sq - window) * window
    return 4 * b * h * pairs * hd


def combine_bytes(acc_numel: int, ml_numel: int, out_numel: int) -> int:
    """The combine kernel: the fp32 partials read once, the bf16 output
    written once."""
    return 4 * (acc_numel + ml_numel) + 2 * out_numel


def wkv6_bytes(b: int, s: int, h: int) -> int:
    """WKV-6, fp32: r, k, v, log_w and y (B, S, H, 64), u, the state in
    and out (B, H, 64, 64)."""
    return 4 * (5 * b * s * h * 64 + h * 64 + 2 * b * h * 64 * 64)


def wkv6_ops(b: int, s: int, h: int) -> int:
    """Per (b, h, t): r^T S (2 per state element), the decay and k v^T (3
    per state element), exp, u k, the bonus dot and its v (6 a channel)."""
    return b * h * s * (5 * 64 * 64 + 6 * 64)


def rglru_bytes(b: int, s: int, w: int) -> int:
    """RG-LRU, fp32: log_a, x and y (B, S, W), h0 and h_last (B, W)."""
    return 4 * (3 * b * s * w + 2 * b * w)


def rglru_ops(b: int, s: int, w: int) -> int:
    """Per (b, t, channel): exp, multiply, add."""
    return 3 * b * s * w


def bound(nbytes: int, ops: int, ops_s: float = FP32_OPS_S):
    """The least time on the card, ms, and what bounds it: the bytes over
    the HBM rate or the operations over ``ops_s``."""
    bytes_t, ops_t = nbytes / HBM_BYTES_S, ops / ops_s
    return max(bytes_t, ops_t) * 1e3, ("bytes" if bytes_t >= ops_t else "operations")


# ---------------------------------------------------------------------------
# Clocks
# ---------------------------------------------------------------------------


def device_ms(fn, reps: int = 60, warmup: int = 5) -> float:
    """Median device time of one call, from CUDA events. A spin kernel
    ahead of each call holds the stream while the host enqueues the
    call, so the events bracket device work only, not launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(max(host_s, 1e-4) * 4e9)  # ~2x the enqueue time at <= 2 GHz
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(fn, reps: int = 5, warmup: int = 1) -> float:
    """Median host-clock time of one call (the CPU twins)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launch_floor(card: str) -> float:
    """Device time of one launch of an empty kernel
    (``kernels/csrc/launch_floor.cu``, one block), by the clock that times
    the kernels: what a launch costs on its own."""
    lib = kbuild.PROBE.load("launch_floor")
    lib.launch_floor_launch.argtypes = [ctypes.c_void_p]
    lib.launch_floor_launch.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        if lib.launch_floor_launch(stream) != 0:
            raise RuntimeError("the empty kernel did not launch")

    floor_ms = device_ms(launch)
    log(f"  launch floor (an empty kernel, one block): {floor_ms * 1e3:.2f} us [{card}]")
    return floor_ms


# ---------------------------------------------------------------------------
# Inputs
# ---------------------------------------------------------------------------


def make_inputs(n: int, t: int, chunk: int, wires: int, label: str, seed: int,
                ties: bool = False, device="cuda"):
    """The kernel's (n, t) inputs: x, recon, res for the gossip stage
    (``wires`` 0), x, g, recon, res for DSGD (1), x, t, g, g_prev and two
    (recon, res) pairs for DSGT (2)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scales = {0: [1.0, 1.0, 0.1], 1: [1.0, 1.0, 1.0, 0.1],
              2: [1.0, 0.3, 0.5, 0.5, 1.0, 0.1, 1.0, 0.1]}[wires]
    bufs = [s * torch.randn(n, t, generator=gen, device=device) for s in scales]
    if label == "zero-chunk":
        for b in bufs:  # payload of (row 3, chunk 1) is exactly zero
            b[3, chunk:2 * chunk] = 0.0
    if ties:
        # (row 0, chunk 0): every input zero but x (gossip stage, DSGD) or
        # the tracker t (DSGT), which carry magnitudes 3, 2 and 1 with random signs
        # (chunk/8 threes, chunk/4 twos): top-k at k = chunk/4 has its
        # threshold at 2 and must keep all chunk/8 + chunk/4 columns
        mags = torch.ones(chunk, device=device)
        mags[: chunk // 8] = 3.0
        mags[chunk // 8: chunk // 8 + chunk // 4] = 2.0
        signs = torch.randint(0, 2, (chunk,), generator=gen, device=device) * 2.0 - 1.0
        perm = torch.randperm(chunk, generator=gen, device=device)
        for b in bufs:
            b[0, :chunk] = 0.0
        bufs[1 if wires == 2 else 0][0, :chunk] = (mags * signs)[perm]
    return bufs


def weights(topology: str, n: int, device="cuda", **kw):
    w = mixing_matrix(topology, n, **kw)
    w_self = torch.tensor(np.diag(w).astype(np.float32), device=device)
    w_off = torch.tensor((w - np.diag(np.diag(w))).astype(np.float32), device=device)
    return w_off, w_self


def fused_plan(name: str, n: int, t: int, chunk: int, topk):
    """The cluster plan (C, columns a block, shared memory bytes) of a
    round kernel or the gossip stage on this card."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return plan_round(n, t, chunk, topk, {**KERNELS, **GOSSIP_KERNELS}[name][2], sms)


def route_plan(name: str, n: int, t: int, chunk: int, topk):
    """The route (``ops.plan_route``) a round kernel or the gossip stage
    takes on this card: ``(route, plan)``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return plan_route(n, t, chunk, topk, {**KERNELS, **GOSSIP_KERNELS}[name][2], sms)


def combine_inputs(splits: int, b: int, h: int, hd: int, gen, device="cuda"):
    """Partials of a split decode: fp32 acc (S, B, H, hd) and m, l (2, S,
    B, H), the last split of every row and all of row 0 empty (m = -inf,
    l = 0)."""
    acc = torch.randn(splits, b, h, hd, generator=gen, device=device)
    m = torch.randn(splits, b, h, generator=gen, device=device) * 4
    l = torch.rand(splits, b, h, generator=gen, device=device) * 100 + 1
    for sel in ((-1,), (slice(None), 0)):
        acc[sel], m[sel], l[sel] = 0.0, float("-inf"), 0.0
    return acc, torch.stack([m, l]).contiguous()


def wkv_inputs(b: int, s: int, h: int, decay: str, gen, device="cuda"):
    """r, k, v, log_w (B, S, H, 64), u (H, 64), s0 (B, H, 64, 64), drawn
    as the reference suite draws them: r, v ~ N(0, 1), k ~ N(0, 1/4),
    log_w = -exp(N(-1, 1)), u ~ N(0, 0.09), s0 ~ N(0, 0.01)."""
    def rand(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=gen, device=device)

    r, k, v = rand(b, s, h, 64), rand(b, s, h, 64, scale=0.5), rand(b, s, h, 64)
    log_w = -torch.exp(rand(b, s, h, 64) - 1.0)
    if decay == "strong":
        log_w.fill_(-math.exp(10.0))
    elif decay == "none":
        log_w.fill_(-1e-6)
    return r, k, v, log_w, rand(h, 64, scale=0.3), rand(b, h, 64, 64, scale=0.1)


def wkv_twin(r, k, v, log_w, u, s0):
    """The twin in the model layout (it takes the folded one)."""
    b, s, h, hd = r.shape

    def fold(a):
        return a.transpose(1, 2).reshape(b * h, s, hd)

    y, s_fin = wkv6_ref(fold(r), fold(k), fold(v), fold(log_w),
                        u[None].expand(b, h, hd).reshape(b * h, hd), s0.reshape(b * h, hd, hd))
    return y.reshape(b, h, s, hd).transpose(1, 2), s_fin.reshape(b, h, hd, hd)


def lru_inputs(b: int, s: int, w: int, gen, device="cuda"):
    log_a = -torch.exp(torch.randn(b, s, w, generator=gen, device=device))
    return (log_a, torch.randn(b, s, w, generator=gen, device=device),
            torch.randn(b, w, generator=gen, device=device))


def attn_err(name: str, label: str, got, want, dtype) -> float:
    """Max |got - want|, raising where it passes :data:`ATTN_TOL`."""
    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise AssertionError(f"{name} {label} {dtype}: bad output")
    excess = float(((got - want).abs() - ATTN_TOL[dtype] * (1 + want.abs())).max())
    if excess > 0:
        raise AssertionError(f"{name} {label} {dtype}: off the twin by "
                             f"{float((got - want).abs().max())}")
    return float((got - want).abs().max())


def bf16_ulp(m: torch.Tensor) -> torch.Tensor:
    """bf16's spacing at magnitude ``m`` (8 significant bits)."""
    return torch.exp2(torch.floor(torch.log2(torch.clamp(m, min=2.0 ** -126))) - 7)


def bf16_ulp_err(what: str, got, want, operands=None) -> float:
    """The largest |got - want| of two bf16-stored buffers in bf16 ulps at
    each element's operand scale, raising where it passes one. The scale
    of element (i, c) of a node-stacked (n, total) buffer is the largest
    magnitude in column c of either buffer: the values a node mix sums
    into it. ``operands`` (n, total) gives it for a buffer computed from
    one, as the node mean is (a 1-D ``got``). A mixed element that
    nearly cancels is small beside its operands, so a one-ulp difference
    of an operand -- a bf16 rounding that fp32 sums in another order flip
    -- is many ulps of the element's own magnitude (2 to 32 in the
    paper's round) and at most one at its column's."""
    a, b = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    if a.shape != b.shape:
        raise AssertionError(f"{what}: shapes {tuple(a.shape)} and {tuple(b.shape)}")
    mag = torch.maximum(a.abs(), b.abs())
    if mag.ndim > 1:
        mag = mag.amax(dim=0, keepdim=True)
    if operands is not None:
        mag = torch.maximum(mag, torch.as_tensor(operands).double().abs().amax(dim=0))
    ulps = float(((a - b).abs() / bf16_ulp(mag)).max())
    if not ulps <= 1.0:
        raise AssertionError(f"{what}: {ulps:.2f} bf16 ulps at its operands' scale")
    return ulps


# ---------------------------------------------------------------------------
# Cases: one (kernel, shape) each, its calls and its counts
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Case:
    """One timed (kernel, shape): the calls (None when only the counts
    are wanted), the bytes and operations, and how the row prints."""

    kernel: str
    shape: str  # the row's key
    label: str  # as printed
    dims: str
    nbytes: int
    ops: int
    kind: str  # "gossip" | "attention" | "combine" | "scan"
    run: Optional[Callable] = None
    twin: Optional[Callable] = None
    library: Optional[Callable] = None
    twin_reps: Dict = dataclasses.field(default_factory=dict)
    ops_s: float = FP32_OPS_S
    #: text after the kernel's time, given its ms (the cluster size, the
    #: earlier design's time, the distance from the launch floor)
    note: Optional[Callable[[float], str]] = None
    #: raises unless the library call computes the twin's function
    check: Optional[Callable] = None

    @property
    def bound(self):
        return bound(self.nbytes, self.ops, self.ops_s)


def _all(label: str) -> bool:
    return True


def gossip_cases(device="cuda", want=_all, earlier=None, floor_ms=None,
                 counts_only: bool = False) -> Iterator[Case]:
    """The round kernels, the gossip stage and the wire stages at the main
    and the large shape (dense wire) and at the main shape on the top-64
    wire. ``earlier``: {(kernel, shape): µs} of an earlier design, printed
    in brackets with the cluster size and the distance from the launch
    floor ``floor_ms``. ``counts_only``: no inputs (the large shape's
    2 GB), no calls -- the dense cases' bytes and operations depend on no
    data; the top-64 ones are skipped."""
    cases = [(MAIN, None), (LARGE, None), (MAIN, TOPK_MAIN)]
    for name, (kernel, twin, wires, _, _) in ALL_KERNELS.items():
        for (label, n, t, chunk, topo), topk in cases:
            key = label if topk is None else f"{label} top-{topk}"
            if not want(label) or (counts_only and topk):
                continue
            w_off, w_self = weights(topo, n, device)
            bufs = None if counts_only else make_inputs(n, t, chunk, wires, label, seed=0,
                                                        device=device)
            if name in GOSSIP_KERNELS:
                adds = 0
                if topk:
                    x, recon, res = bufs  # the payload with the timed flags (ef, dc)
                    adds = radix_adds((x - recon) + res, chunk, topk)
                args = None if counts_only else (*bufs, w_off, w_self)
                nbytes = gossip_bytes(n, t, chunk)
                ops = gossip_ops(n, t, chunk, topk, mix_terms(w_off), adds)
            elif name in KERNELS:
                args = None if counts_only else (*bufs, w_off, w_self, ALPHA)
                nbytes = round_bytes(n, t, chunk, wires)
                ops = round_ops(n, t, chunk, wires, topk, mix_terms(w_off))
            else:
                args = None if counts_only else (*bufs, ALPHA)
                nbytes, ops = wire_bytes_moved(n, t, chunk, wires), wire_ops(n, t, chunk, wires, topk)
            kw = dict(scale_chunk=chunk, topk=topk)
            note = None
            if earlier and (name, key) in earlier:
                def note(k_ms, name=name, key=key, n=n, t=t, chunk=chunk, topk=topk):
                    return (f" [earlier design {earlier[(name, key)]:.2f} us], clusters "
                            f"of {fused_plan(name, n, t, chunk, topk)[0]}, "
                            f"{(k_ms - floor_ms) * 1e3:.2f} us over the launch floor")
            yield Case(
                name, key, key, f"{n}x{t}", nbytes, ops, "gossip",
                run=None if args is None else (lambda k=kernel, a=args, kw=kw: k(*a, **kw)),
                twin=None if args is None else (lambda k=twin, a=args, kw=kw: k(*a, **kw)),
                note=note)
            del bufs, args


def federation_weights(device="cuda"):
    """W_off and w_self of :data:`FEDERATION`'s graph."""
    return weights(FEDERATION[4], FEDERATION[1], device, p=FEDERATION_P)


def two_pass_cases(device="cuda", counts_only: bool = False) -> Iterator[Case]:
    """The round kernels' two-pass route (``ops.plan_route``) at
    :data:`FEDERATION`, for the gossip stage, DSGD and DSGT: the route
    through the wrapper (two launches), its wire pass alone (the wire
    stage of :data:`ROUTE_WIRES` with no int8 store, twin the wire
    stage's) and its mix alone (``ops.round_mix``, with ``torch.sparse.mm``
    as its library call: :func:`mix_case`); then the mix alone on the
    graphs of :data:`MIX_GRAPHS`. The route's bound is the round's: the
    bytes the function must move once (:func:`round_bytes`,
    :func:`gossip_bytes`) against the operations of both passes for this
    run's W_off. ``counts_only``: no inputs, no calls."""
    label, n, t, chunk, _ = FEDERATION
    w_off, w_self = federation_weights(device)
    for name in ("gossip_mix", "fused_round", "fused_round_gt"):
        kernel, twin, wires, _, _ = {**GOSSIP_KERNELS, **KERNELS}[name]
        wire_kernel, wire_twin, takes_alpha = ROUTE_WIRES[name]
        alpha = (ALPHA,) if takes_alpha else ()
        bufs = None if counts_only else make_inputs(n, t, chunk, wires, label, seed=0,
                                                    device=device)
        round_args = (w_off, w_self) + alpha
        dims = f"{n}x{t}"
        cases = [
            (name, f"{label} route",
             gossip_bytes(n, t, chunk) if name in GOSSIP_KERNELS
             else round_bytes(n, t, chunk, wires),
             route_ops(n, t, chunk, wires, None, mix_terms(w_off)),
             lambda b, k=kernel, a=round_args: k(*b, *a, scale_chunk=chunk),
             lambda b, k=twin, a=round_args: k(*b, *a, scale_chunk=chunk)),
            (wire_kernel.__name__, f"{label} {name}",
             wire_bytes_moved(n, t, chunk, wires, q=False), wire_ops(n, t, chunk, wires),
             lambda b, k=wire_kernel, a=alpha: k(*b, *a, scale_chunk=chunk, store_q=False),
             lambda b, k=wire_twin, a=alpha: k(*b, *a, scale_chunk=chunk)),
        ]
        for kernel_name, key, nbytes, ops, run, twin_run in cases:
            yield Case(kernel_name, key, key, dims, nbytes, ops, "gossip",
                       run=None if bufs is None else (lambda r=run, b=bufs: r(b)),
                       twin=None if bufs is None else (lambda r=twin_run, b=bufs: r(b)),
                       twin_reps={"reps": 10, "warmup": 1})
        # any (n, t) buffers serve the mix: the recons as the neighbour
        # views, x (DSGT: x and t) as the self terms
        yield mix_case(f"{label} {name}", w_off, w_self, None if bufs is None else (
            _mix_nbrs(bufs, wires), tuple(bufs[:max(wires, 1)])), n, t, max(wires, 1))
        del bufs
    for label, n, t, topo in MIX_GRAPHS:
        w_off, w_self = weights(topo, n, device)
        bufs = None
        if not counts_only:
            gen = torch.Generator(device=device).manual_seed(0)
            bufs = ((torch.randn(n, t, generator=gen, device=device),),
                    (torch.randn(n, t, generator=gen, device=device),))
        yield mix_case(f"{label} fused_round", w_off, w_self, bufs, n, t, 1)
        del bufs


def mix_case(key: str, w_off, w_self, bufs, n: int, t: int, wires: int) -> Case:
    """``ops.round_mix`` on ``bufs`` = (neighbour views, self terms), a
    buffer a wire (None: the counts alone), its twin, and its library
    call: ``torch.sparse.mm`` of the CSR matrix ``[W_off | diag(w_self)]``
    (n x 2n) against ``[nbr; src]`` (2n x t, stacked before the timed
    calls), one call a wire. The bound counts W_off's nonzeros
    (:func:`mix_terms`)."""
    case = Case("round_mix", key, key, f"{n}x{t}", mix_bytes(n, t, wires),
                mix_ops(n, t, wires, mix_terms(w_off)), "gossip",
                twin_reps={"reps": 10, "warmup": 1})
    if bufs is None:
        return case
    nbrs, srcs = bufs
    with warnings.catch_warnings():  # "Sparse CSR tensor support is in beta state"
        warnings.simplefilter("ignore", UserWarning)
        csr = torch.cat((w_off, torch.diag(w_self)), dim=1).to_sparse_csr()
    stacked = [torch.cat((a, s)) for a, s in zip(nbrs, srcs)]
    tol = 1e-5 * max(1.0, max(float(b.abs().max()) for b in nbrs + srcs))

    def lib():
        return tuple(torch.sparse.mm(csr, s) for s in stacked)

    def check():
        for got, want in zip(lib(), case.twin()):
            err = float((got - want).abs().max())
            if not err <= tol:
                raise AssertionError(f"torch.sparse.mm {key}: off the twin by {err} > {tol}")

    case.run = lambda: round_mix(w_off, w_self, nbrs, srcs)
    case.twin = lambda: tuple(round_mix_ref(w_off, w_self, a, s) for a, s in zip(nbrs, srcs))
    case.library, case.check = lib, check
    return case


def _mix_nbrs(bufs, wires: int):
    """The recon buffers among a round's inputs (``make_inputs``' order)."""
    return (bufs[wires + 1],) if wires < 2 else (bufs[4], bufs[6])


def compact_cases(device="cuda", want=_all, earlier=None, floor_ms=None,
                  counts_only: bool = False) -> Iterator[Case]:
    """Both compact wire-stage kernels at the main shape on the top-64
    bitmap wire (``main``), the large shape on the same wire, and the main
    shape on the top-16 positions wire -- the DSGT kernel with its layout,
    ``earlier``'s time in brackets and its distance from the launch floor;
    no PyTorch call computes exact-k selection with int8 quantization.
    ``counts_only`` yields the DSGD cases only (the DSGT count depends on
    the data)."""
    cases = [("main", MAIN, TOPK_MAIN, True), ("large", LARGE, TOPK_MAIN, True),
             ("main top-16", MAIN, 16, False)]
    for name, (kernel, twin, wires, _, _) in COMPACT_KERNELS.items():
        for key, (label, n, t, chunk, _), topk, bitmap in cases:
            if not want(label) or (counts_only and wires == 2):
                continue
            bufs = None if counts_only else make_inputs(n, t, chunk, wires, label, seed=0,
                                                        device=device)
            kw = dict(scale_chunk=chunk, topk=topk, bitmap=bitmap)
            note = None
            if wires == 1:
                ops = compact_ops(n, t, chunk, topk, bitmap)
            else:
                adds = sum(radix_adds(p, chunk, topk) for p in compact_gt_payloads(*bufs))
                ops = compact_gt_ops(n, t, chunk, topk, bitmap, adds)
                if earlier and (name, key) in earlier:
                    def note(k_ms, name=name, key=key, chunk=chunk, topk=topk, bitmap=bitmap):
                        together = compact_gt_plan(chunk, topk, bitmap)[0]
                        return (f" [earlier design {earlier[(name, key)]:.2f} us], "
                                f"{'both wires at once' if together else 'a wire at a time'}, "
                                f"{(k_ms - floor_ms) * 1e3:.2f} us over the launch floor")
            args = None if counts_only else (*bufs, ALPHA)
            yield Case(
                name, key, f"{key} ({'bitmap' if bitmap else 'positions'}, k={topk})",
                f"{n}x{t}", compact_bytes_moved(n, t, chunk, wires, topk, bitmap), ops,
                "gossip",
                run=None if args is None else (lambda k=kernel, a=args, kw=kw: k(*a, **kw)),
                twin=None if args is None else (lambda k=twin, a=args, kw=kw: k(*a, **kw)),
                note=note)
            del bufs, args


def decode_case(label: str, b: int, c: int, live: int, h: int, kv: int, hd: int, gen,
                device="cuda", counts_only: bool = False) -> Case:
    """The decode kernel, its twin and ``scaled_dot_product_attention``
    (GQA, a boolean mask of the live slots) at one bf16 shape, every row
    ``live`` slots long."""
    case = Case("decode_attention", label, label,
                f"B {b}, C {c}, {live} live, H {h}, K {kv}, hd {hd}",
                decode_bytes(b, live, h, kv, hd), decode_flops(b, live, h, hd), "attention",
                ops_s=BF16_OPS_S)
    if counts_only:
        return case
    q = torch.randn(b, 1, h, hd, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(b, c, kv, hd, generator=gen, device=device).bfloat16()
            for _ in range(2))
    n_valid = torch.full((b,), live, dtype=torch.int32, device=device)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    mask = (torch.arange(c, device=device) < live)[None, None, None, :]

    def lib():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask, enable_gqa=True)

    case.run = lambda: decode_attention(q, k, v, n_valid)
    case.twin = lambda: decode_attention_ref(q, k, v, n_valid)
    case.library = lib
    case.check = lambda: attn_err("scaled_dot_product_attention", f"decode {label}",
                                  lib().transpose(1, 2), case.twin(), torch.bfloat16)
    return case


def flash_case(label: str, b: int, sq: int, sk: int, h: int, kv: int, hd: int,
               causal: bool, window: int, gen, device="cuda",
               counts_only: bool = False) -> Case:
    """The flash kernel, its twin and ``scaled_dot_product_attention``
    (GQA, ``is_causal`` where causal; a window wider than the sequence
    only) at one bf16 shape."""
    case = Case("flash_attention", label, label,
                f"B {b}, Sq {sq}, Sk {sk}, H {h}, K {kv}, hd {hd}, causal {causal}, "
                f"window {window}", flash_bytes(b, sq, sk, h, kv, hd),
                flash_flops(b, sq, sk, h, hd, causal), "attention", ops_s=BF16_OPS_S)
    if counts_only:
        return case
    q = torch.randn(b, sq, h, hd, generator=gen, device=device).bfloat16()
    k, v = (torch.randn(b, sk, kv, hd, generator=gen, device=device).bfloat16()
            for _ in range(2))
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def lib():  # the window spans the whole sequence where one is set
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, enable_gqa=True)

    case.run = lambda: flash_attention(q, k, v, causal=causal, window=window)
    case.twin = lambda: attention_ref(q, k, v, causal=causal, window=window)
    case.library = lib
    case.check = lambda: attn_err("scaled_dot_product_attention", f"prefill {label}",
                                  lib().transpose(1, 2), case.twin(), torch.bfloat16)
    return case


def combine_case(gen, device="cuda") -> Case:
    """The combine kernel alone on the partials of the large decode shape
    (B 8, 15 q-heads, hd 64, 32,768 slots: the wrapper's split count),
    beside its twin; no PyTorch call computes it. Bound: its bytes; 3
    operations a partial element (a weight, a multiply-add of acc, one of
    l)."""
    b, c, h, kv, hd = 8, 32768, 15, 5, 64
    splits, _ = split_plan(torch.empty(b, 1, h, hd, dtype=torch.bfloat16, device=device),
                           torch.empty(b, c, kv, hd, dtype=torch.bfloat16, device=device))
    acc, ml = combine_inputs(splits, b, h, hd, gen, device)
    out = torch.empty(b, 1, h, hd, dtype=torch.bfloat16, device=device)
    return Case("decode_attention_combine", "large",
                f"large ({splits} splits, B {b}, H {h}, hd {hd})", "",
                combine_bytes(acc.numel(), ml.numel(), out.numel()), 3 * acc.numel(),
                "combine", run=lambda: combine_partials(acc, ml, out),
                twin=lambda: combine_partials_ref(acc, ml[0], ml[1], torch.bfloat16))


def attention_cases(device="cuda", want=_all, counts_only: bool = False) -> Iterator[Case]:
    """Both attention kernels at :data:`DECODE_SHAPES` and
    :data:`FLASH_SHAPES`, and the combine kernel at the large decode
    shape's partials (on the card only)."""
    gen = torch.Generator(device=device).manual_seed(1)
    for label, *shape in DECODE_SHAPES:
        if want(label):
            yield decode_case(label, *shape, gen, device, counts_only)
    if want("large") and not counts_only and torch.device(device).type == "cuda":
        yield combine_case(gen, device)
    for label, b, sq, h, kv, hd, window in FLASH_SHAPES:
        if want(label):
            yield flash_case(label, b, sq, sq, h, kv, hd, True, window, gen, device,
                             counts_only)


def scan_cases(device="cuda", want=_all, counts_only: bool = False) -> Iterator[Case]:
    """WKV-6 at RWKV6-7B's prefill and decode shapes (B 8, H 64, S 128 and
    1) and at S 4096; the RG-LRU scan at RecurrentGemma-2B's (B 8, W 2560,
    S 128 and 1) and at S 4096. The twins loop over S in Python, so at S
    4096 they are timed over 3 calls."""
    gen = torch.Generator(device=device).manual_seed(3)
    b, h, w = SCAN_B, WKV_H, LRU_W
    for label, s in SCAN_SHAPES:
        if not want(label):
            continue
        reps = dict(reps=3, warmup=1) if s > 128 else {}
        case = Case("wkv6", label, label, f"B {b}, S {s}, H {h}", wkv6_bytes(b, s, h),
                    wkv6_ops(b, s, h), "scan", twin_reps=reps)
        if not counts_only:
            args = wkv_inputs(b, s, h, "random", gen, device)
            case.run, case.twin = (lambda a=args: wkv6(*a)), (lambda a=args: wkv_twin(*a))
        yield case
        case = Case("rglru_scan", label, label, f"B {b}, S {s}, W {w}", rglru_bytes(b, s, w),
                    rglru_ops(b, s, w), "scan", twin_reps=reps)
        if not counts_only:
            args = lru_inputs(b, s, w, gen, device)
            case.run = lambda a=args: rglru_scan(*a)
            case.twin = lambda a=args: rglru_ref(*a)
        yield case


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------


def _describe(case: Case, k_ms: float, t_ms: float, l_ms, bound_ms: float, bound_by: str,
              card: str, floor_ms) -> str:
    """The printed line of a timed case on the card."""
    of = f"{bound_ms / k_ms:.1%} of bound"
    if case.kind == "gossip":
        lib = "" if l_ms is None else f", torch.sparse.mm {l_ms * 1e3:.2f} us"
        return (f"  {case.kernel} {case.label} {case.dims}: kernel {k_ms * 1e3:.2f} us"
                f"{case.note(k_ms) if case.note else ''}, twin {t_ms * 1e3:.2f} us{lib}, bound "
                f"{bound_ms * 1e3:.2f} us by {bound_by} ({case.nbytes / 1e6:.3f} MB at "
                f"{HBM_BYTES_S / 1e12:.2f} TB/s, {case.ops / 1e6:.2f} M fp32 ops at "
                f"{FP32_OPS_S / 1e12:.0f} T/s), {of} [{card}]")
    if case.kind == "attention":
        return (f"  {case.kernel} {case.label} ({case.dims}): kernel {k_ms * 1e3:.2f} us, "
                f"twin {t_ms * 1e3:.2f} us, scaled_dot_product_attention "
                f"{l_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
                f"({case.nbytes / 1e6:.3f} MB at {HBM_BYTES_S / 1e12:.2f} TB/s, "
                f"{case.ops / 1e9:.3f} GFLOP at {BF16_OPS_S / 1e12:.0f} TFLOP/s bf16), "
                f"{of} [{card}]")
    if case.kind == "combine":
        return (f"  {case.kernel} {case.label}: kernel {k_ms * 1e3:.2f} us, twin "
                f"{t_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
                f"({case.nbytes / 1e6:.3f} MB), {of} [{card}]")
    return (f"  {case.kernel} {case.label} ({case.dims}): kernel {k_ms * 1e3:.2f} us, twin "
            f"{t_ms * 1e3:.2f} us, bound {bound_ms * 1e3:.2f} us by {bound_by} "
            f"({case.nbytes / 1e6:.3f} MB at {HBM_BYTES_S / 1e12:.2f} TB/s, "
            f"{case.ops / 1e9:.4f} G fp32 ops at {FP32_OPS_S / 1e12:.0f} T/s), {of}, "
            f"{(k_ms - floor_ms) * 1e3:.2f} us over the launch floor [{card}]")


def time_case(case: Case, card: str, floor_ms=None, device="cuda") -> dict:
    """Time one case and print its line. On the card: the kernel, the twin
    and the library call by :func:`device_ms`; on the CPU the twin alone
    by the host clock (kernel and library None). Returns ``{ms, plain_ms,
    library_ms, bound_ms, bound_by}``."""
    bound_ms, bound_by = case.bound
    if torch.device(device).type != "cuda":
        t_ms = host_ms(case.twin, **({"reps": 3} if case.twin_reps else {}))
        log(f"  {case.kernel} {case.label} ({case.dims}): twin {t_ms * 1e3:.2f} us on the "
            f"host CPU; the H100's bound {bound_ms * 1e3:.2f} us by {bound_by} (no card)")
        return dict(ms=None, plain_ms=t_ms, library_ms=None, bound_ms=bound_ms,
                    bound_by=bound_by)
    if case.check is not None:  # the yardstick computes the kernels' function
        case.check()
    k_ms = device_ms(case.run)
    t_ms = device_ms(case.twin, **case.twin_reps)
    l_ms = device_ms(case.library) if case.library is not None else None
    log(_describe(case, k_ms, t_ms, l_ms, bound_ms, bound_by, card, floor_ms))
    return dict(ms=k_ms, plain_ms=t_ms, library_ms=l_ms, bound_ms=bound_ms,
                bound_by=bound_by)


def time_cases(cases: Iterator[Case], card: str, floor_ms=None, device="cuda") -> dict:
    """:func:`time_case` over ``cases``, freeing each case's inputs before
    the next is built: ``{(kernel, shape): row}``."""
    rows = {}
    for case in cases:
        rows[(case.kernel, case.shape)] = time_case(case, card, floor_ms, device)
        del case
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    return rows


def run(device="cuda", shapes=None, card: Optional[str] = None) -> List[dict]:
    """Every case (``shapes``: the labels to keep, None for all) on
    ``device``: the JSON rows, µs."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    card = card or (card_line() if on_card else None)
    want = _all if shapes is None else (lambda label: label in shapes)
    floor_ms = launch_floor(card) if on_card else None
    rows = {}
    for cases in (gossip_cases(dev, want), compact_cases(dev, want),
                  attention_cases(dev, want), scan_cases(dev, want)):
        rows.update(time_cases(cases, card, floor_ms, dev))
    if on_card and want(FEDERATION[0]):  # the two-pass route runs on the card only
        rows.update(time_cases(two_pass_cases(dev), card, floor_ms, dev))

    def us(ms):
        return None if ms is None else ms * 1e3

    return [{"kernel": name, "shape": shape, "kernel_us": us(r["ms"]),
             "twin_us": us(r["plain_ms"]), "bound_us": us(r["bound_ms"]),
             "bound_by": r["bound_by"], "library_us": us(r["library_ms"]),
             "device": dev.type, "card": card,
             "launch_floor_us": us(floor_ms)} for (name, shape), r in rows.items()]


def main(argv=None) -> List[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' times the twins alone (null kernel columns)")
    ap.add_argument("--shapes", default=None,
                    help="comma-separated shape labels to time (main, large, path, "
                         "'path prefill', 'path decode', 'hd256 path', and on the card "
                         "federation-1024, the round kernels' two-pass route); default all "
                         "on the card, all but 'large' on the CPU")
    ap.add_argument("--out", default="experiments/kernel_bench_torch.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    shapes = None
    if args.shapes is not None:
        shapes = {s.strip() for s in args.shapes.split(",")}
    elif dev.type != "cuda":
        shapes = {"main", "path", "path prefill", "path decode", "hd256 path"}
    rows = run(dev, shapes)
    if os.path.dirname(args.out):
        os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(rows, f, indent=2)
    print(f"wrote {args.out} ({len(rows)} rows)")
    return rows


if __name__ == "__main__":
    main()
