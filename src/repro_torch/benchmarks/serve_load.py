"""Request-replay load generator for the consensus serving path
(counterpart of the reference's ``benchmarks/serve_load.py``: the same
functions, columns and CLI, plus ``--device``).

Replays a deterministic stream of decode requests through a
``ServeEngine`` while a publisher thread keeps landing fresh consensus
snapshots (the hot-swap path), and reports:

* ``tokens_per_s``            -- generated-token throughput;
* ``us_p50_request`` / ``us_p99_request`` -- request latency tail;
* ``us_swap_pause_mean/max``  -- decode-loop pause per hot swap;
* ``staleness_mean/max``      -- rounds the ACTIVE weights lag the
  training frontier at each request completion.

``snapshot_restore`` rows time the mapped snapshot load
(``training.snapshot.load_snapshot``) against the checkpoint restore
(``training.checkpoint.load_fl_state``) of the same consensus payload;
the full run adds the TinyLlama-1.1B-sized buffer row. The host clock
times everything here; a run on the CPU (``--device cpu``) says how fast
this host is, not the card.

  PYTHONPATH=src python -m repro_torch.benchmarks.serve_load --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.serve_load

The record goes to ``experiments/serve_ehr_torch.json`` unless ``--out``
names another file (the reference's ``experiments/serve_ehr.json`` is
its own run).
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core.fl import FLState, tree_map
from repro_torch.core.packing import pack
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.checkpoint import load_fl_state, save_fl_state
from repro_torch.training.snapshot import latest_round, load_snapshot, write_snapshot

__all__ = ["make_requests", "replay", "restore_comparison"]

DEFAULT_OUT = "experiments/serve_ehr_torch.json"


def make_requests(n_requests: int, batch: int, prompt_len: int,
                  vocab: int, seed: int = 0) -> List[np.ndarray]:
    """Deterministic request stream: ``n_requests`` prompt batches of
    shape (batch, P) with P jittered in [prompt_len//2, prompt_len]."""
    rng = np.random.default_rng(seed)
    reqs = []
    for _ in range(n_requests):
        p = int(rng.integers(max(1, prompt_len // 2), prompt_len + 1))
        reqs.append(rng.integers(0, vocab, (batch, p)).astype(np.int32))
    return reqs


def replay(engine: ServeEngine, requests: List[np.ndarray], new_tokens: int,
           frontier_fn: Optional[Callable[[], int]] = None,
           refresh_fn: Optional[Callable[[], None]] = None,
           outputs: Optional[list] = None) -> Dict:
    """Replay ``requests`` through ``engine.generate`` and aggregate the
    serving metrics. ``frontier_fn`` reports the live training frontier
    (for the staleness series); ``refresh_fn``, when given, runs between
    requests (e.g. poll the snapshot directory and ``publish_snapshot``).
    ``outputs``, when given, collects each request's
    ``GenerationResult`` and the snapshot round its weights came from
    after it, as ``(result, snapshot_round)`` pairs.

    Shared by this benchmark (a synthetic publisher) and
    ``examples/serve_consensus.py`` (training publishing concurrently),
    so both report the same columns."""
    swap_base = len(engine.swap_pauses)
    lat_s: List[float] = []
    staleness: List[int] = []
    gen_tokens = 0
    t_start = time.perf_counter()
    for prompts in requests:
        if refresh_fn is not None:
            refresh_fn()
        t0 = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=new_tokens, temperature=0.0)
        lat_s.append(time.perf_counter() - t0)
        if outputs is not None:
            outputs.append((out, engine.snapshot_round))
        gen_tokens += prompts.shape[0] * new_tokens
        if frontier_fn is not None:
            s = engine.staleness(frontier_fn())
            if s is not None:
                staleness.append(s)
    wall = time.perf_counter() - t_start
    pauses = engine.swap_pauses[swap_base:]
    lat_us = np.asarray(lat_s) * 1e6
    row = {
        "n_requests": len(requests),
        "new_tokens": int(new_tokens),
        "gen_tokens": int(gen_tokens),
        "tokens_per_s": float(gen_tokens / wall),
        "us_mean_request": float(lat_us.mean()),
        "us_p50_request": float(np.percentile(lat_us, 50)),
        "us_p99_request": float(np.percentile(lat_us, 99)),
        "n_swaps": len(pauses),
        "us_swap_pause_mean": float(np.mean(pauses) * 1e6) if pauses else 0.0,
        "us_swap_pause_max": float(np.max(pauses) * 1e6) if pauses else 0.0,
    }
    if staleness:
        row["staleness_mean"] = float(np.mean(staleness))
        row["staleness_max"] = int(np.max(staleness))
    return row


def _serve_replay_row(smoke: bool, device, seed: int = 0) -> Dict:
    """Serve the TinyLlama smoke consensus under load while a publisher
    thread advances a synthetic frontier and lands snapshots mid-replay."""
    arch = "tinyllama-1.1b"
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg)
    params = bundle.init_fn(torch.Generator().manual_seed(seed), device="cpu")
    n_nodes = 4
    stacked = tree_map(lambda x: torch.stack([x * (1.0 + 0.01 * i)
                                              for i in range(n_nodes)]), params)
    flat, layout = pack(stacked, pad_to=512)

    batch = 2
    n_requests = 6 if smoke else 24
    prompt_len = 8
    new_tokens = 8 if smoke else 16
    publish_every = 2  # requests between published training rounds

    snap_dir = tempfile.mkdtemp(prefix="serve_load_snap_")
    write_snapshot(snap_dir, flat, layout, round_frontier=1)
    tmpl = bundle.param_shapes()
    engine = ServeEngine.from_snapshot(bundle, load_snapshot(snap_dir, template=tmpl),
                                       max_seq=64, batch=batch, device=device)

    frontier = {"round": 1}
    stop = threading.Event()

    def publisher():
        # a synthetic trainer: advance the frontier steadily and publish a
        # perturbed consensus every few rounds through the snapshot files
        rnd = 1
        while not stop.is_set():
            time.sleep(0.05)
            rnd += 1
            frontier["round"] = rnd
            if rnd % publish_every == 0:
                write_snapshot(snap_dir, flat * (1.0 + 0.001 * rnd), layout,
                               round_frontier=rnd)

    def refresh():
        newest = latest_round(snap_dir)
        if newest is not None and newest != engine.snapshot_round:
            engine.publish_snapshot(load_snapshot(snap_dir, newest, template=tmpl))

    requests = make_requests(n_requests, batch, prompt_len, cfg.vocab_size, seed=seed)
    engine.generate(requests[0], max_new_tokens=2, temperature=0.0)  # warm-up

    th = threading.Thread(target=publisher, daemon=True)
    th.start()
    try:
        row = replay(engine, requests, new_tokens,
                     frontier_fn=lambda: frontier["round"], refresh_fn=refresh)
    finally:
        stop.set()
        th.join(timeout=5)
        shutil.rmtree(snap_dir, ignore_errors=True)
    row.update({
        "name": f"serve_replay__{arch}_smoke",
        "total_params": int(cfg.param_count()),
        "n_nodes": n_nodes,
        "batch": batch,
        "prompt_len": prompt_len,
        "rounds_published": int(frontier["round"]),
    })
    return row


def restore_comparison(name: str, total_params: int, n_leaves: int = 8,
                       n_nodes: int = 1, seed: int = 0, repeats: int = 5) -> Dict:
    """Time the mapped snapshot load against the checkpoint restore of the
    same consensus payload (``total_params`` fp32 weights in ``n_leaves``
    equal leaves), medians over ``repeats``. ``us_snapshot_load_touched``
    also reads the whole mapped blob."""
    rng = np.random.default_rng(seed)
    per = total_params // n_leaves
    params = {
        f"layer{i:02d}": torch.from_numpy(np.stack([
            rng.standard_normal(per, dtype=np.float32) for _ in range(n_nodes)]))
        for i in range(n_leaves)
    }
    flat, layout = pack(params, pad_to=512)

    work = tempfile.mkdtemp(prefix="serve_load_restore_")
    try:
        snap_dir = os.path.join(work, "snap")
        ckpt_dir = os.path.join(work, "ckpt")
        write_snapshot(snap_dir, flat, layout, round_frontier=1)
        consensus = tree_map(lambda x: x.mean(dim=0, keepdim=True), params)
        state = FLState(step=0, params=consensus, tracker=None, prev_grad=None,
                        comm=None)
        save_fl_state(ckpt_dir, state)

        t_snap, t_touch, t_ckpt = [], [], []
        for _ in range(repeats):
            t0 = time.perf_counter()
            snap = load_snapshot(snap_dir)
            t_snap.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            float(snap.flat.double().sum())  # fault every page in
            t_touch.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            load_fl_state(ckpt_dir, state)
            t_ckpt.append(time.perf_counter() - t0)
        us_snap = float(np.median(t_snap) * 1e6)
        us_touch = float(np.median(t_touch) * 1e6)
        us_ckpt = float(np.median(t_ckpt) * 1e6)
        snap_bytes = os.path.getsize(os.path.join(snap_dir, snap.header["blob"]))
        ckpt_bytes = os.path.getsize(os.path.join(ckpt_dir, "state.npz"))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {
        "name": name,
        "total_params": int(layout.total),
        "n_leaves": n_leaves,
        "n_nodes": n_nodes,
        "snapshot_bytes": int(snap_bytes),
        "checkpoint_bytes": int(ckpt_bytes),
        "us_snapshot_load": us_snap,
        "us_snapshot_load_touched": us_touch,
        "us_checkpoint_restore": us_ckpt,
        "speedup_snapshot_load": us_ckpt / us_snap,
    }


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="CI sizes: smoke model replay and a small restore row "
                         "(skips the TinyLlama-1.1B-sized buffer)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    rows: List[Dict] = []
    print("serving replay under load (hot-swap publisher running)...")
    rows.append(_serve_replay_row(smoke=args.smoke, device=dev, seed=args.seed))
    r = rows[-1]
    print(f"  {r['name']}: {r['tokens_per_s']:.1f} tok/s, "
          f"p50={r['us_p50_request']/1e3:.1f}ms p99={r['us_p99_request']/1e3:.1f}ms, "
          f"{r['n_swaps']} swaps (pause mean {r['us_swap_pause_mean']:.1f}us), "
          f"staleness mean={r.get('staleness_mean', 0):.1f} "
          f"max={r.get('staleness_max', 0)}")

    print("restore comparison (smoke-sized consensus buffer)...")
    smoke_total = int(get_config("tinyllama-1.1b", smoke=True).param_count())
    rows.append(restore_comparison("snapshot_restore__smoke", smoke_total, seed=args.seed))
    r = rows[-1]
    print(f"  {r['name']}: mmap {r['us_snapshot_load']:.0f}us vs npz restore "
          f"{r['us_checkpoint_restore']:.0f}us -> {r['speedup_snapshot_load']:.1f}x")

    if not args.smoke:
        full_total = int(get_config("tinyllama-1.1b", smoke=False).param_count())
        print(f"restore comparison (tinyllama-1.1b-sized buffer: "
              f"{full_total/1e9:.2f}B params, {full_total*4/1e9:.1f} GB fp32)...")
        rows.append(restore_comparison("snapshot_restore__tinyllama-1.1b", full_total,
                                       seed=args.seed, repeats=3))
        r = rows[-1]
        print(f"  {r['name']}: mmap {r['us_snapshot_load']:.0f}us vs npz restore "
              f"{r['us_checkpoint_restore']/1e6:.1f}s -> "
              f"{r['speedup_snapshot_load']:.0f}x")
        if r["speedup_snapshot_load"] < 5.0:
            print("  WARNING: below the 5x acceptance threshold")

    record = {
        "bench": "serve_consensus_load",
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "backend": dev.type,
        "smoke": bool(args.smoke),
        "rows": rows,
    }
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(record, f, indent=2)
    print(f"-> {args.out}")
    return record


if __name__ == "__main__":
    main()
