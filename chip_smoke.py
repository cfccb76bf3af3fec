#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds the round megakernels from ``src/repro_torch/kernels/gossip/csrc``
(into that package's ``build/``), holds each against its plain PyTorch
twin on the card, drives the port's main path -- the paper's FD-DSGT on
the fused engine, then FD-DSGD -- and times the kernels, their twins and
one whole Q = 10 round. Any failed check raises, so the exit code is
non-zero; without a CUDA card (or without the repository around it) the
script fails before printing any result.

Output: progress lines, then the card's name and power limit as
``nvidia-smi`` reports them, a ``{"kernels": [...]}`` JSON line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import FLRunConfig  # noqa: E402
from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.core.engine import get_engine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.examples.ehr_federated import run_fused_engine  # noqa: E402
from repro_torch.kernels.gossip import build as kbuild  # noqa: E402
from repro_torch.kernels.gossip.ops import fused_round, fused_round_gt  # noqa: E402
from repro_torch.kernels.gossip.ref import fused_round_gt_ref, fused_round_ref  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss, mlp_init  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    stack_batches,
    stack_for_nodes,
    train_decentralized,
)

SOURCE = "src/repro_torch/kernels/gossip/csrc/fused_round.cu"
KERNELS = {
    # name: (wrapper, twin, wires, TPU kernel it replaces)
    "fused_round": (fused_round, fused_round_ref, 1,
                    "src/repro/kernels/gossip/gossip.py:421"),
    "fused_round_gt": (fused_round_gt, fused_round_gt_ref, 2,
                       "src/repro/kernels/gossip/gossip.py:476"),
}
# (label, nodes, flat width, scale chunk, topology): the main path, a
# ragged shape with one all-zero row chunk (exercises safe = 1), and a
# large shape that makes the kernel bandwidth-bound
SHAPES = [
    ("main", 20, 1536, 512, "hospital20"),
    ("zero-chunk", 7, 384, 128, "complete"),
    ("large", 64, 1 << 20, 512, "torus:8x8"),
]
FLAGS = list(itertools.product([True, False], repeat=3))  # ef, dc, stale
ALPHA = np.float32(0.02)
# DSGT wire bytes per round on hospital20 (2 wires x 54 directed edges x
# (1536 int8 + 3 fp32 scales)); DSGD ships one wire
WIRE_DSGT, WIRE_DSGD = 167_184, 83_592

# Published peaks of the H100 SXM (NVIDIA data sheet): HBM bytes/s and
# fp32 operations/s outside the tensor cores, at its full 700 W limit.
HBM_BYTES_S, FP32_OPS_S = 3.35e12, 67e12


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout
    return out.strip().splitlines()[0]


def round_bytes(n: int, t: int, chunk: int, wires: int) -> int:
    """HBM bytes one round kernel must move: each (n, t) input read once
    (DSGD 4, DSGT 8), each output written once (3 / 6), the weights, the
    scales and alpha."""
    bufs = (4 + 3) if wires == 1 else (8 + 6)
    return 4 * (n * t * bufs + n * n + n + wires * n * (t // chunk) + 1)


def round_ops(n: int, t: int, chunk: int, wires: int) -> int:
    """fp32 operations of one round, counted from the kernel body in
    csrc/fused_round.cu with error feedback and difference coding on.
    Per element and wire: payload (sub, add), |payload| and its max,
    divide, rint, clip (min, max), q * scale, recon' (add), res' (sub),
    w_self * src + mix (mul, add), and n multiply-adds of the W_off row
    (2 n). Per element once: the local update, 2 for DSGD (mul, sub) and 4
    for DSGT (t_half: add, sub; h: mul, sub). Per (row, chunk) and wire:
    max / 127 and the safe select."""
    per_wire = n * t * (13 + 2 * n) + 2 * n * (t // chunk)
    return wires * per_wire + n * t * 2 * wires


def make_inputs(n: int, t: int, chunk: int, wires: int, label: str, seed: int):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    count = 4 if wires == 1 else 8
    scales = [1.0, 1.0, 1.0, 0.1] if wires == 1 else [1.0, 0.3, 0.5, 0.5, 1.0, 0.1, 1.0, 0.1]
    bufs = [s * torch.randn(n, t, generator=gen, device="cuda") for s in scales[:count]]
    if label == "zero-chunk":
        for b in bufs:  # payload of (row 3, chunk 1) is exactly zero
            b[3, chunk:2 * chunk] = 0.0
    return bufs


def weights(topology: str, n: int):
    w = mixing_matrix(topology, n)
    w_self = torch.tensor(np.diag(w).astype(np.float32), device="cuda")
    w_off = torch.tensor((w - np.diag(np.diag(w))).astype(np.float32), device="cuda")
    return w_off, w_self


def check_kernels() -> dict:
    """Every kernel against its twin on the card, at every shape and flag
    combination: recon', res' and scales bitwise, mixed within 1e-5 x
    max(1, max|input|) (the n x n sum runs in another order)."""
    max_err = {name: 0.0 for name in KERNELS}
    for (name, (kernel, twin, wires, _)), (label, n, t, chunk, topo) in itertools.product(
            KERNELS.items(), SHAPES):
        w_off, w_self = weights(topo, n)
        for k, (ef, dc, stale) in enumerate(FLAGS):
            bufs = make_inputs(n, t, chunk, wires, label, seed=k)
            kw = dict(scale_chunk=chunk, error_feedback=ef,
                      difference_coding=dc, stale_mix=stale)
            got = kernel(*bufs, w_off, w_self, ALPHA, **kw)
            want = twin(*bufs, w_off, w_self, ALPHA, **kw)
            torch.cuda.synchronize()
            n_mixed = wires
            for i, (a, b) in enumerate(zip(got, want)):
                if not torch.isfinite(a).all() or a.shape != b.shape:
                    raise AssertionError(f"{name} {label} {kw}: output {i} bad")
                if i < n_mixed:
                    err = float((a - b).abs().max())
                    tol = 1e-5 * max(1.0, max(float(x.abs().max()) for x in bufs))
                    if err > tol:
                        raise AssertionError(
                            f"{name} {label} {kw}: mixed off by {err} > {tol}")
                    max_err[name] = max(max_err[name], err)
                elif not torch.equal(a, b):
                    raise AssertionError(
                        f"{name} {label} {kw}: output {i} differs from the twin "
                        f"(max {float((a - b).abs().max())})")
            if label == "zero-chunk":
                sc = got[-1]
                if float(sc[3, 1]) != 0.0:
                    raise AssertionError(f"{name}: all-zero chunk got scale {float(sc[3, 1])}")
            del got, want, bufs
        log(f"  {name} == twin at {label} ({n}x{t}, chunk {chunk}): "
            f"8 flag combinations, recon/res/scales bitwise, mixed max err "
            f"{max_err[name]:.3e}")
        torch.cuda.empty_cache()
    return max_err


def main_path() -> dict:
    """The port's main path through its user entry points; counts are
    zeroed just before each run and read just after."""
    fused_round.launches = fused_round_gt.launches = 0
    out = run_fused_engine(rounds=20, q=10, device="cuda")
    torch.cuda.synchronize()
    gt_launches, dsgd_launches = fused_round_gt.launches, fused_round.launches
    if (gt_launches, dsgd_launches) != (20, 0):
        raise AssertionError(f"FD-DSGT: launches gt={gt_launches} dsgd={dsgd_launches}, want 20/0")
    if out["wire_bytes"] != WIRE_DSGT:
        raise AssertionError(f"FD-DSGT wire bytes {out['wire_bytes']} != {WIRE_DSGT}")
    # each round's loss is one 20-sample batch per hospital, so compare
    # the means of the first and the last five rounds
    losses = out["losses"]
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    if not all(math.isfinite(v) for v in losses) or not last < first:
        raise AssertionError(f"FD-DSGT loss not finite and falling: {losses}")
    log(f"  FD-DSGT 20 rounds x Q=10: {gt_launches} fused_round_gt launches, "
        f"wire {out['wire_bytes']:.0f} B/round, loss (mean of 5 rounds) "
        f"{first:.4f} -> {last:.4f}, final bal_acc={out['bal_acc']:.4f}")

    # the same run on the CPU twins: the kernels must not move the result
    # beyond what fp32 summation order does (an int8 step that flips at a
    # rounding boundary is absorbed by error feedback)
    cpu = run_fused_engine(rounds=20, q=10, device="cpu")
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, cpu["losses"]))
    if rel > 1e-2 or abs(out["bal_acc"] - cpu["bal_acc"]) > 0.02:
        raise AssertionError(
            f"cuda run drifts from the cpu run: loss rel {rel}, bal_acc "
            f"{out['bal_acc']} vs {cpu['bal_acc']}")
    log(f"  FD-DSGT cuda vs cpu twins: max loss rel diff {rel:.2e}, "
        f"bal_acc {out['bal_acc']:.4f} vs {cpu['bal_acc']:.4f}")

    data = generate_ehr_cohort(seed=0)
    run = FLRunConfig(algorithm="dsgd", q=10, topology="hospital20", n_nodes=20,
                      batch_per_node=20, alpha0=0.02)
    fused_round.launches = fused_round_gt.launches = 0
    res = train_decentralized(
        make_mlp_loss(class_weights()), mlp_init(0, device="cuda"), run,
        make_node_batcher(data, m=20, seed=1), rounds=3, device="cuda",
    )
    torch.cuda.synchronize()
    dsgd_runs = fused_round.launches
    if (dsgd_runs, fused_round_gt.launches) != (3, 0):
        raise AssertionError(f"FD-DSGD: launches dsgd={dsgd_runs}, want 3")
    per_round = res.history.column("comm_bytes")[-1] / 3
    loss = res.history.column("loss")
    if per_round != WIRE_DSGD or not np.isfinite(loss).all():
        raise AssertionError(f"FD-DSGD wire {per_round} / losses {loss}")
    log(f"  FD-DSGD 3 rounds x Q=10: {dsgd_runs} fused_round launches, wire "
        f"{per_round:.0f} B/round, losses {np.round(loss, 4).tolist()}")
    return {"fused_round": dsgd_runs, "fused_round_gt": gt_launches}


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


def round_ms(card: str, rounds: int = 50, warmup: int = 5, profiled: int = 5) -> float:
    """Median host-clock time of one whole FD-DSGT Q = 10 round (10
    gradient evaluations + 1 round-kernel launch), synchronized; then
    ``torch.profiler`` over ``profiled`` more rounds for the device's busy
    time and operation count per round and the host's costliest ops."""
    data = generate_ehr_cohort(seed=0)
    batcher = make_node_batcher(data, m=20, seed=1)
    cfg = FLConfig(algorithm="dsgt", q=10, n_nodes=20)
    engine, flat = get_engine("fused").simulated(
        mixing_matrix("hospital20", 20),
        stack_for_nodes(mlp_init(0, device="cuda"), 20), scale_chunk=512)
    round_fn = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02), cfg, engine)
    state = init_fl_state(cfg, flat, engine)
    batches = [stack_batches(batcher, cfg.q) for _ in range(rounds + warmup + profiled)]
    times = []
    for k, b in enumerate(batches[:rounds + warmup]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, _ = round_fn(state, b)
        torch.cuda.synchronize()
        if k >= warmup:
            times.append((time.perf_counter() - t0) * 1e3)
    r_ms = statistics.median(times)
    log(f"  one FD-DSGT Q=10 round (20 hospitals, host clock): {r_ms * 1e3:.1f} us [{card}]")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[rounds + warmup:]:
            state, _ = round_fn(state, b)
        torch.cuda.synchronize()
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("  profiler: no device activity recorded; device busy time not measured")
        return r_ms
    busy, reach = 0.0, -math.inf  # union of the device intervals, in us
    for start, end in spans:
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    busy_ms = busy / profiled / 1e3
    log(f"  profiler over {profiled} rounds: {len(spans) / profiled:.0f} device "
        f"operations and {busy_ms * 1e3:.1f} us of device busy time per round, "
        f"{busy_ms / r_ms:.2%} of the unprofiled round time [{card}]")
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total,
                 reverse=True)[:8]
    log("  host ops by self time per round: " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / profiled:.0f} us x{e.count / profiled:.0f}"
        for e in top))
    return r_ms


def timings(card: str) -> dict:
    rows = {}
    for name, (kernel, twin, wires, _) in KERNELS.items():
        for label, n, t, chunk, topo in (SHAPES[0], SHAPES[2]):
            w_off, w_self = weights(topo, n)
            bufs = make_inputs(n, t, chunk, wires, label, seed=0)
            args = (*bufs, w_off, w_self, ALPHA)
            k_ms = device_ms(lambda: kernel(*args, scale_chunk=chunk))
            t_ms = device_ms(lambda: twin(*args, scale_chunk=chunk))
            nbytes = round_bytes(n, t, chunk, wires)
            ops = round_ops(n, t, chunk, wires)
            bytes_s, ops_s = nbytes / HBM_BYTES_S, ops / FP32_OPS_S
            bound = max(bytes_s, ops_s) * 1e3
            bound_by = "bytes" if bytes_s >= ops_s else "operations"
            log(f"  {name} {label} {n}x{t}: kernel {k_ms * 1e3:.2f} us, twin "
                f"{t_ms * 1e3:.2f} us, bound {bound * 1e3:.2f} us by {bound_by} "
                f"({nbytes / 1e6:.3f} MB at {HBM_BYTES_S / 1e12:.2f} TB/s, "
                f"{ops / 1e6:.2f} M fp32 ops at {FP32_OPS_S / 1e12:.0f} T/s), "
                f"{bound / k_ms:.1%} of bound [{card}]")
            rows[(name, label)] = dict(ms=k_ms, plain_ms=t_ms, bound_ms=bound,
                                       bound_by=bound_by)
            del bufs, args
            torch.cuda.empty_cache()
    round_ms(card)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")

    log("phase 1: build")
    t0 = time.perf_counter()
    libs = kbuild.build()
    log(f"  built {sorted(libs)} in {time.perf_counter() - t0:.1f} s")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"    ptxas: {line.strip()}")

    log("phase 2: kernels vs twins on the card")
    max_err = check_kernels()

    log("phase 3: main path")
    launches = main_path()

    log("phase 4: times (CUDA events, median of 60 after warm-up)")
    rows = timings(card)

    kernels = []
    for name, (_, _, _, replaces) in KERNELS.items():
        row = rows[(name, "main")]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max_err[name], "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": None,
        })
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
