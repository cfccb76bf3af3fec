"""End-to-end driver: train a decoder with FD-DSGT for a few hundred
steps (counterpart of the reference's ``examples/train_100m.py``; its
flags, plus ``--device`` and ``--metrics``).

The default is the reference's 100M-class llama-family config (d 512, 8
layers, 32k vocab) across 4 FL nodes on a ring with Q = 5 local steps a
round, through the simulated ``tree`` engine (one device, dense-W
gossip); ``--arch smollm-360m`` swaps in a registry config (``--smoke``
its smoke variant), and ``--fl-engine flat|fused`` with the other
``--fl-*`` axes ride along. The reference's ``--fl-engine
sharded_fused`` trains on a two-axis ``(gossip_node, model_shard)``
mesh; that layout is not ported yet (ROADMAP.md queue 1, item 15), so it
is refused with ``NotImplementedError``.

  PYTHONPATH=src python -m repro_torch.examples.train_100m --rounds 60
  PYTHONPATH=src python -m repro_torch.examples.train_100m --arch smollm-360m \\
      --smoke --rounds 6 --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; without a card,
``cuda`` raises.
"""

from __future__ import annotations

import argparse
import csv
import os
import time

import torch

from repro_torch.configs import FLRunConfig, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import _not_ported
from repro_torch.data.tokens import make_fl_token_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.checkpoint import save_fl_state
from repro_torch.training.trainer import train_decentralized


def model_100m() -> ModelConfig:
    return ModelConfig(
        name="llama-100m",
        family="dense",
        n_layers=8,
        d_model=512,
        n_heads=8,
        n_kv_heads=4,
        d_ff=1536,
        vocab_size=32000,
        head_dim=64,
        source="100M-class llama-family config (this repo)",
    )


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--q", type=int, default=5)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch-per-node", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--alpha0", type=float, default=0.4)
    ap.add_argument("--ckpt", default="experiments/ckpt_100m_torch")
    ap.add_argument("--metrics", default="experiments/train_100m_torch_metrics.csv",
                    help="CSV of the per-round history")
    ap.add_argument("--arch", default="llama-100m",
                    help="'llama-100m' (built in) or a registry arch like "
                         "'smollm-360m'")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's smoke variant (registry archs only)")
    ap.add_argument("--fl-engine", default="tree",
                    choices=("tree", "flat", "fused", "sharded_fused"),
                    help="'sharded_fused' (the two-axis mesh) is not ported yet")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="size of the mesh's model axis (sharded_fused only)")
    ap.add_argument("--scale-chunk", type=int, default=256)
    ap.add_argument("--topk", type=int, default=None,
                    help="fused engine: ship only the k largest payload columns "
                         "per scale chunk")
    ap.add_argument("--fl-schedule", default=None,
                    help="round time layout, e.g. 'pipelined' or "
                         "'bounded_staleness:k=2'")
    ap.add_argument("--fl-topology-program", default=None,
                    help="per-round graph dynamics, e.g. "
                         "'node_churn:p_down=0.2,mean_downtime=5'")
    ap.add_argument("--fl-node-program", default=None,
                    help="per-node heterogeneity, e.g. "
                         "'stragglers:frac=0.25,rate=0.5'")
    ap.add_argument("--fl-privacy", default=None,
                    help="wire privacy epilogue, e.g. 'dp:sigma=0.5,clip=1.0'")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    args = ap.parse_args(argv)

    if args.fl_engine == "sharded_fused":
        raise _not_ported(
            f"training on the two-axis (gossip_node, model_shard) mesh "
            f"(--fl-engine sharded_fused, --model-shards {args.model_shards})", "15")
    if args.arch == "llama-100m":
        if args.smoke:
            ap.error("--smoke needs a registry arch (e.g. --arch smollm-360m)")
        cfg = model_100m()
    else:
        cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    bundle = build_model(cfg)
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params), "
          f"{args.nodes} nodes x Q={args.q}, {args.rounds} rounds "
          f"= {args.rounds*args.q} training steps, engine={args.fl_engine}")

    run = FLRunConfig(algorithm="dsgt", q=args.q, topology="ring", n_nodes=args.nodes,
                      batch_per_node=args.batch_per_node, alpha0=args.alpha0,
                      schedule="constant")
    stream = make_fl_token_batches(cfg.vocab_size, args.nodes, args.batch_per_node,
                                   args.seq_len, q=1, seed=0)
    step_batches = ({k: v[0] for k, v in b.items()} for b in stream)
    params0 = bundle.init_fn(torch.Generator(device=dev).manual_seed(0), device=dev)
    knobs = dict(engine=args.fl_engine, topk=args.topk, round_schedule=args.fl_schedule,
                 topology_program=args.fl_topology_program,
                 node_program=args.fl_node_program, privacy=args.fl_privacy)
    if args.fl_engine in ("flat", "fused"):
        knobs["scale_chunk"] = args.scale_chunk

    t0 = time.time()
    result = train_decentralized(bundle.loss_fn, params0, run, step_batches,
                                 rounds=args.rounds, log_every=2, device=dev, **knobs)
    dt = time.time() - t0
    rows = result.history.rows()
    os.makedirs(os.path.dirname(args.metrics) or ".", exist_ok=True)
    with open(args.metrics, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=sorted(rows[0]))
        w.writeheader()
        w.writerows(rows)
    # as the reference, which records round axes only for a prebuilt engine
    save_fl_state(args.ckpt, result.state, extra={"arch": cfg.name})
    print(f"\nloss {rows[0]['loss']:.3f} -> {rows[-1]['loss']:.3f} "
          f"({int(rows[-1]['iteration'])} steps, {dt/60:.1f} min, "
          f"{dt/max(1, int(rows[-1]['iteration'])):.1f}s/step, engine={args.fl_engine})")
    print(f"metrics -> {args.metrics}; ckpt -> {args.ckpt}")
    return rows


if __name__ == "__main__":
    main()
