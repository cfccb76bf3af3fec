"""End-to-end driver: train a decoder with FD-DSGT for a few hundred
steps (counterpart of the reference's ``examples/train_100m.py``; its
flags, plus ``--device``, ``--metrics`` and ``--node-ranks``).

The default is the reference's 100M-class llama-family config (d 512, 8
layers, 32k vocab) across 4 FL nodes on a ring with Q = 5 local steps a
round, through the simulated ``tree`` engine (one device, dense-W
gossip); ``--arch smollm-360m`` swaps in a registry config (``--smoke``
its smoke variant), and ``--fl-engine flat|fused`` with the other
``--fl-*`` axes ride along.

``--fl-engine sharded_fused`` trains on the two-axis ``(gossip_node,
model_shard)`` layout, as the reference's does: the ``--nodes`` FL nodes
on a ring over the node axis ``data`` (the circulant wire, ``w=None``)
split over ``--node-ranks`` ranks, each node's flat buffer tiled over
``--model-shards`` (``model_axis="model"`` when above 1). The script
starts the ``node ranks x model shards`` ranks itself
(``launch.mesh.run_group``): one per card on CUDA -- NCCL runs one rank
a device, so a world larger than the visible cards is refused -- or gloo
ranks with ``--device cpu``. Rank 0 writes the metrics and the
checkpoint.

  PYTHONPATH=src python -m repro_torch.examples.train_100m --rounds 60
  PYTHONPATH=src python -m repro_torch.examples.train_100m --arch smollm-360m \\
      --smoke --rounds 6 --device cpu
  PYTHONPATH=src python -m repro_torch.examples.train_100m --arch smollm-360m \\
      --smoke --rounds 3 --fl-engine sharded_fused --nodes 4 --node-ranks 2 \\
      --model-shards 2 --device cpu

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
from repro_torch.core.engine import ShardedFusedEngine
from repro_torch.core.packing import pack_layout
from repro_torch.data.tokens import make_fl_token_batches
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import run_group
from repro_torch.models import build_model
from repro_torch.training.checkpoint import save_fl_state
from repro_torch.training.trainer import stack_for_nodes, train_decentralized


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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=60)
    ap.add_argument("--q", type=int, default=5)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--batch-per-node", type=int, default=1)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--alpha0", type=float, default=0.4)
    ap.add_argument("--ckpt", default="experiments/ckpt_100m_torch",
                    help="checkpoint directory ('' writes none)")
    ap.add_argument("--metrics", default="experiments/train_100m_torch_metrics.csv",
                    help="CSV of the per-round history")
    ap.add_argument("--arch", default="llama-100m",
                    help="'llama-100m' (built in) or a registry arch like "
                         "'smollm-360m'")
    ap.add_argument("--smoke", action="store_true",
                    help="use the arch's smoke variant (registry archs only)")
    ap.add_argument("--fl-engine", default="tree",
                    choices=("tree", "flat", "fused", "sharded_fused"),
                    help="'sharded_fused' trains on the two-axis (gossip_node, "
                         "model_shard) layout over ranks this script starts")
    ap.add_argument("--node-ranks", type=int, default=1,
                    help="ranks along the node axis (sharded_fused only); the "
                         "--nodes split evenly over them")
    ap.add_argument("--model-shards", type=int, default=1,
                    help="size of the model axis (sharded_fused only): each "
                         "node's flat buffer tiles over it")
    ap.add_argument("--scale-chunk", type=int, default=256)
    ap.add_argument("--topk", type=int, default=None,
                    help="fused engines: ship only the k largest payload columns "
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
                    help="wire privacy epilogue, e.g. 'dp:sigma=0.5,clip=1.0' "
                         "(sharded_fused: also 'secure_agg')")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    return ap


def _model(args, ap) -> ModelConfig:
    if args.arch == "llama-100m":
        if args.smoke:
            ap.error("--smoke needs a registry arch (e.g. --arch smollm-360m)")
        return model_100m()
    return get_config(args.arch, smoke=args.smoke)


def _stream(cfg: ModelConfig, args):
    stream = make_fl_token_batches(cfg.vocab_size, args.nodes, args.batch_per_node,
                                   args.seq_len, q=1, seed=0)
    return ({k: v[0] for k, v in b.items()} for b in stream)


def _run(args) -> FLRunConfig:
    return FLRunConfig(algorithm="dsgt", q=args.q, topology="ring", n_nodes=args.nodes,
                       batch_per_node=args.batch_per_node, alpha0=args.alpha0,
                       schedule="constant")


def _finish(args, cfg: ModelConfig, result, dt: float, engine=None, write: bool = True):
    """Write the metrics CSV and the checkpoint (``engine``: every rank
    of a group calls it, rank 0 writes) and print the summary."""
    rows = result.history.rows()
    if write:
        os.makedirs(os.path.dirname(args.metrics) or ".", exist_ok=True)
        with open(args.metrics, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=sorted(rows[0]))
            w.writeheader()
            w.writerows(rows)
    # as the reference, which records round axes only for a prebuilt engine
    if args.ckpt:
        save_fl_state(args.ckpt, result.state, extra={"arch": cfg.name}, engine=engine)
    if write:
        print(f"\nloss {rows[0]['loss']:.3f} -> {rows[-1]['loss']:.3f} "
              f"({int(rows[-1]['iteration'])} steps, {dt/60:.1f} min, "
              f"{dt/max(1, int(rows[-1]['iteration'])):.1f}s/step, engine={args.fl_engine})")
        print(f"metrics -> {args.metrics}; ckpt -> {args.ckpt or '(none)'}")
    return rows


def train_sharded(group, args, after=None):
    """One rank of the ``sharded_fused`` run: the ring of ``--nodes``
    over the node axis, the rank's block of the flat buffer, the trainer
    on the prebuilt engine; rank 0 writes the metrics. ``after(group,
    result)``, when given, runs on the trained state while the group is
    up; returns (rows, its result)."""
    ap = _parser()
    cfg = _model(args, ap)
    dev = group.device
    bundle = build_model(cfg)
    stacked = stack_for_nodes(
        bundle.init_fn(torch.Generator(device=dev).manual_seed(0), device=dev), args.nodes)
    layout = pack_layout(stacked, pad_to=args.scale_chunk, shards=group.model_shards)
    engine = ShardedFusedEngine(
        group, layout, scale_chunk=args.scale_chunk, topk=args.topk,
        model_axis="model" if group.model_shards > 1 else None,
        round_schedule=args.fl_schedule, topology_program=args.fl_topology_program,
        node_program=args.fl_node_program, privacy=args.fl_privacy)
    lead = group.rank == 0
    t0 = time.time()
    result = train_decentralized(bundle.loss_fn, stacked, _run(args), _stream(cfg, args),
                                 rounds=args.rounds, log_every=2 if lead else 0,
                                 engine=engine)
    del stacked
    rows = _finish(args, cfg, result, time.time() - t0, engine=engine, write=lead)
    return rows, (after(group, result) if after is not None else None)


def _sharded_rank(group, args):
    return train_sharded(group, args)[0]


def main(argv=None, after=None) -> list:
    """Parse the flags and train; returns the per-round rows (rank 0's on
    ``sharded_fused``). ``after`` (``sharded_fused`` at one rank only, so
    it need not pickle) runs on the trained state inside the group; the
    return is then (rows, its result)."""
    ap = _parser()
    args = ap.parse_args(argv)
    cfg = _model(args, ap)
    dev = resolve_device(args.device)
    shards = args.model_shards if args.fl_engine == "sharded_fused" else 1
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params), "
          f"{args.nodes} nodes x Q={args.q}, {args.rounds} rounds "
          f"= {args.rounds*args.q} training steps, engine={args.fl_engine}"
          + (f" x {shards} model shards on {args.node_ranks * shards} rank(s)"
             if args.fl_engine == "sharded_fused" else ""))
    if args.fl_engine == "sharded_fused":
        world = args.node_ranks * shards
        if args.nodes % args.node_ranks:
            ap.error(f"--nodes {args.nodes} do not split over --node-ranks {args.node_ranks}")
        if after is not None and world != 1:
            raise ValueError("after= runs in this process: a one-rank world only")
        fn, fargs = (train_sharded, (args, after)) if after is not None else (
            _sharded_rank, (args,))
        return run_group(fn, world, device=dev, node_axes={"data": args.nodes},
                         model_shards=shards, args=fargs)
    bundle = build_model(cfg)
    params0 = bundle.init_fn(torch.Generator(device=dev).manual_seed(0), device=dev)
    knobs = dict(engine=args.fl_engine, topk=args.topk, round_schedule=args.fl_schedule,
                 topology_program=args.fl_topology_program,
                 node_program=args.fl_node_program, privacy=args.fl_privacy)
    if args.fl_engine in ("flat", "fused"):
        knobs["scale_chunk"] = args.scale_chunk

    t0 = time.time()
    result = train_decentralized(bundle.loss_fn, params0, _run(args), _stream(cfg, args),
                                 rounds=args.rounds, log_every=2, device=dev, **knobs)
    return _finish(args, cfg, result, time.time() - t0)


if __name__ == "__main__":
    main()
