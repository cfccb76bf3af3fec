"""Serve the consensus WHILE it trains: the end-to-end snapshot pipeline
(counterpart of the reference's ``examples/serve_consensus.py``; its
flags, plus ``--device`` and ``--full``).

Two threads over one snapshot directory:

* **trainer** -- decentralized FL (the smollm-360m smoke config by
  default, ``--full`` for the arch's full config; a ring of ``--nodes``,
  FD-DSGT on the fused flat-buffer engine) advancing the round frontier;
  every ``--publish-every`` rounds (and at the last) it publishes the
  consensus, the node mean of the flat ``(nodes, total)`` state, as a
  mappable snapshot (``training.snapshot.write_snapshot``);
* **server** (main thread) -- waits for the first snapshot, maps it into
  a ``ServeEngine`` (``from_snapshot``, staged onto the device), then
  replays a deterministic request stream (``benchmarks.serve_load.replay``),
  polling ``LATEST`` between requests and hot-swapping fresher weights in
  with ``publish_snapshot`` at the next decode step boundary.

Both threads share the device and the kernels' launch counters: the
trainer launches the attention-prefill and round kernels, the server the
decode kernel, so no counter has two writers; read them after
:func:`run` returns (the trainer is joined).

  PYTHONPATH=src python -m repro_torch.examples.serve_consensus --device cpu
  PYTHONPATH=src python -m repro_torch.examples.serve_consensus --rounds 12 \\
      --publish-every 2 --requests 8
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import threading
import time
from typing import Dict

import torch

from repro_torch.benchmarks.serve_load import make_requests, replay
from repro_torch.configs import get_config
from repro_torch.core.engine import get_engine
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round, tree_map
from repro_torch.core.packing import unpack
from repro_torch.core.schedules import inv_sqrt
from repro_torch.core.topology import mixing_matrix
from repro_torch.data.tokens import make_fl_token_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.snapshot import latest_round, load_snapshot, write_snapshot
from repro_torch.training.trainer import stack_for_nodes

DEFAULT_OUT = "experiments/serve_consensus_torch_metrics.json"


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--full", action="store_true",
                    help="the arch's full config instead of its smoke config")
    ap.add_argument("--rounds", type=int, default=10)
    ap.add_argument("--q", type=int, default=2)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch-per-node", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--alpha0", type=float, default=0.02)
    ap.add_argument("--scale-chunk", type=int, default=512)
    ap.add_argument("--publish-every", type=int, default=2,
                    help="rounds between snapshot publishes")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--serve-batch", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--snap-dir", default=None,
                    help="snapshot directory (default: a temp dir)")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    return ap


def run(args, keep_published: bool = False) -> Dict:
    """Train and serve concurrently. Returns ``row`` (the serving metrics
    and the run's facts), ``outputs`` (each request's
    ``GenerationResult`` with the snapshot round that served it),
    ``losses`` (per round) and, with ``keep_published``, ``published``:
    each published round's consensus tree as the trainer held it in
    memory, for holding the served tokens against an in-memory engine."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=not args.full)
    bundle = build_model(cfg)
    params0 = bundle.init_fn(torch.Generator(device=dev).manual_seed(0), device=dev)
    n = args.nodes
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.2f}M params), "
          f"{n}-node ring x Q={args.q}, {args.rounds} rounds, "
          f"publish every {args.publish_every}")

    # the decentralized round on the fused flat-buffer engine
    w = mixing_matrix("ring", n)
    engine, state0 = get_engine("fused").simulated(
        w, stack_for_nodes(params0, n), scale_chunk=args.scale_chunk)
    del params0
    fl_cfg = FLConfig(algorithm="dsgt", q=args.q, n_nodes=n)
    round_fn = make_fl_round(bundle.loss_fn, inv_sqrt(args.alpha0), fl_cfg, engine)
    state = init_fl_state(fl_cfg, state0, engine)
    del state0
    stream = make_fl_token_batches(cfg.vocab_size, n, args.batch_per_node,
                                   args.seq_len, q=args.q, seed=0)

    snap_dir = args.snap_dir or tempfile.mkdtemp(prefix="serve_consensus_")
    frontier = {"round": 0}
    trainer_err = []
    losses = []
    published: Dict[int, Dict] = {}
    one_row = dataclasses.replace(engine.layout, n_nodes=1)

    def trainer():
        nonlocal state
        try:
            for rnd in range(1, args.rounds + 1):
                state, m = round_fn(state, next(stream))
                losses.append(float(m["loss"]))
                frontier["round"] = rnd
                if rnd % args.publish_every == 0 or rnd == args.rounds:
                    # state.params IS the flat (nodes, total) buffer;
                    # write_snapshot takes its node mean, the consensus
                    write_snapshot(snap_dir, state.params, engine.layout,
                                   round_frontier=rnd, engine=engine, step=state.step)
                    if keep_published:  # the snapshot's numbers: the same mean
                        row = state.params.mean(dim=0, keepdim=True)
                        published[rnd] = tree_map(lambda a: a[0], unpack(row, one_row))
                    print(f"  [trainer] round {rnd}: loss={losses[-1]:.3f}, "
                          "published snapshot")
        except Exception as e:  # surfaced in the main thread
            trainer_err.append(e)
            raise

    th = threading.Thread(target=trainer, daemon=True)
    th.start()

    # the serving side: wait for the first publish, then replay
    while latest_round(snap_dir) is None:
        if trainer_err:
            raise trainer_err[0]
        time.sleep(0.05)
    tmpl = bundle.param_shapes()
    snap = load_snapshot(snap_dir, template=tmpl)
    eng = ServeEngine.from_snapshot(bundle, snap,
                                    max_seq=args.prompt_len + args.new_tokens + 8,
                                    batch=args.serve_batch, device=dev)
    print(f"  [server] serving from snapshot round {eng.snapshot_round} "
          f"(mapped {snap.header['blob_bytes']/1e6:.1f} MB, staged onto {dev})")

    def refresh():
        newest = latest_round(snap_dir)
        if newest is not None and newest != eng.snapshot_round:
            eng.publish_snapshot(load_snapshot(snap_dir, newest, template=tmpl))

    requests = make_requests(args.requests, args.serve_batch, args.prompt_len,
                             cfg.vocab_size, seed=1)
    eng.generate(requests[0], max_new_tokens=2, temperature=0.0)  # warm-up
    outputs: list = []
    row = replay(eng, requests, args.new_tokens, frontier_fn=lambda: frontier["round"],
                 refresh_fn=refresh, outputs=outputs)
    th.join()
    if trainer_err:
        raise trainer_err[0]

    row.update({"name": f"serve_consensus__{cfg.name}",
                "total_params": int(cfg.param_count()), "n_nodes": n,
                "q": args.q, "rounds": args.rounds,
                "publish_every": args.publish_every,
                "final_round_served": int(eng.snapshot_round)})
    print(f"\nserved {row['gen_tokens']} tokens at {row['tokens_per_s']:.1f} tok/s; "
          f"p50={row['us_p50_request']/1e3:.1f}ms p99={row['us_p99_request']/1e3:.1f}ms; "
          f"{row['n_swaps']} hot swaps (mean pause {row['us_swap_pause_mean']:.1f}us); "
          f"staleness mean={row.get('staleness_mean', 0):.1f} "
          f"max={row.get('staleness_max', 0)} rounds behind frontier "
          f"{frontier['round']}")
    return {"row": row, "outputs": outputs, "losses": losses, "published": published,
            "requests": requests, "snap_dir": snap_dir}


def main(argv=None) -> Dict:
    args = _parser().parse_args(argv)
    result = run(args)
    row = result["row"]
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(row, f, indent=2)
    print(f"metrics -> {args.out}; snapshots -> {result['snap_dir']}")
    return row


def served_matches_in_memory(bundle, result: Dict, args) -> int:
    """Replay every request on an in-memory ``ServeEngine`` built from the
    consensus the trainer held when it published the round that served
    the request (``run(..., keep_published=True)``); raise unless the
    tokens are equal. Returns the number of requests held."""
    engines: Dict[int, ServeEngine] = {}
    for prompts, (out, rnd) in zip(result["requests"], result["outputs"]):
        if rnd not in engines:
            engines[rnd] = ServeEngine(bundle, result["published"][rnd],
                                       max_seq=args.prompt_len + args.new_tokens + 8,
                                       batch=args.serve_batch)
        want = engines[rnd].generate(prompts, max_new_tokens=args.new_tokens,
                                     temperature=0.0)
        if not (want.tokens == out.tokens).all():
            raise AssertionError(f"served tokens differ from the in-memory engine "
                                 f"on round {rnd}'s consensus")
    return len(result["outputs"])


if __name__ == "__main__":
    main()
