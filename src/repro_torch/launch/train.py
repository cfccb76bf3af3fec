"""Training launcher: decentralized FL training of a registry arch's smoke
config (counterpart of ``repro.launch.train``; the reference's flags and
printed JSON, plus ``--device`` and the JSON's ``device``).

Like the reference, it builds ``get_config(arch, smoke=True)`` by
default (the port's ``--no-smoke`` builds the arch's published config
instead, for a card that holds it) and trains it with the simulated node axis through
``training.trainer.train_decentralized``; the ``--fl-*`` flags select
the round axes. ``--fl-engine sharded_fused`` is refused, as the
reference's help says: that round needs a process group, which the
reference lowers with ``launch/dryrun.py`` (item 18 of ROADMAP.md queue
1 in the port); on one process ``fused`` runs the same math.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --rounds 20 --q 4 --algorithm dsgt --nodes 8

Runs on ``cuda`` unless ``--device cpu`` is given (the kernels' plain
PyTorch twins then run instead); without a card, ``cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict

import torch

from repro_torch.configs import FLRunConfig, get_config
from repro_torch.core.dynamics import program_names
from repro_torch.core.engine import engine_names, schedule_names
from repro_torch.core.heterogeneity import node_program_names
from repro_torch.data.tokens import make_fl_token_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training.checkpoint import save_fl_state
from repro_torch.training.trainer import train_decentralized


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="train the arch's smoke config (default); --no-smoke "
                         "trains its full (published) config")
    ap.add_argument("--rounds", type=int, default=20)
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--algorithm", default="dsgt", choices=("dsgd", "dsgt"))
    ap.add_argument("--topology", default="ring")
    ap.add_argument("--nodes", type=int, default=8)
    ap.add_argument("--batch-per-node", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--alpha0", type=float, default=0.5)
    ap.add_argument("--fl-engine", default="tree", choices=engine_names(),
                    help="round engine, resolved through the GossipEngine "
                         "registry (sharded_fused needs a process group and "
                         "is refused here)")
    ap.add_argument("--scale-chunk", type=int, default=512,
                    help="fused engine: int8 scale block width")
    ap.add_argument("--topk", type=int, default=None,
                    help="fused engine: k largest payload columns per scale "
                         "chunk on the wire")
    ap.add_argument("--fl-schedule", default="sequential",
                    help="round time layout (RoundSchedule registry: "
                         f"{', '.join(schedule_names())}); spec syntax "
                         "name:k=v, e.g. 'bounded_staleness:k=3' (fused "
                         "engine only)")
    ap.add_argument("--fl-staleness-depth", type=int, default=None,
                    help="sugar for --fl-schedule bounded_staleness:k=K "
                         "(0 = sequential); mutually exclusive with "
                         "--fl-schedule")
    ap.add_argument("--storage-dtype", default=None,
                    help="flat buffer storage dtype of the flat / fused "
                         "engines: float32 (default) or bfloat16 (fp32 "
                         "arithmetic, the wire state fp32); tree refuses it")
    ap.add_argument("--fl-topology-program", default=None,
                    help="per-round graph dynamics (TopologyProgram registry: "
                         f"{', '.join(program_names())}), e.g. "
                         "'edge_failure:p=0.2,seed=0' -- flat/fused engines")
    ap.add_argument("--fl-node-program", default=None,
                    help="per-node heterogeneity (NodeProgram registry: "
                         f"{', '.join(node_program_names())}), e.g. "
                         "'stragglers:frac=0.25,rate=0.5'")
    ap.add_argument("--fl-privacy", default=None,
                    help="wire privacy epilogue, e.g. 'dp:sigma=0.5,clip=1.0' "
                         "(metrics gain dp_epsilon) or 'secure_agg' -- fused "
                         "engine; tree refuses")
    ap.add_argument("--fl-scope", default=None,
                    help="federation scope: 'full' (default), 'backbone', "
                         "'ranges:a-b,c-d' or 'layerwise:freq=R' -- fused "
                         "engine; tree/flat refuse")
    ap.add_argument("--fl-robust-alpha", action="store_true",
                    help="shrink the step-size schedule by "
                         "robust_alpha_scale(uptime, k)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    return ap


def main(argv=None) -> dict:
    ap = _parser()
    args = ap.parse_args(argv)
    if args.fl_engine == "sharded_fused":
        ap.error("--fl-engine sharded_fused needs a process group -- use "
                 "python -m repro_torch.launch.dryrun --fl-engine sharded_fused for "
                 "that path at the production mesh (on one process, 'fused' runs "
                 "the same math; examples/train_100m.py trains it on a group)")
    fl_schedule = args.fl_schedule
    if args.fl_staleness_depth is not None:
        if fl_schedule != "sequential":
            ap.error("--fl-staleness-depth is sugar for --fl-schedule "
                     "bounded_staleness:k=K; pass one or the other")
        fl_schedule = None  # the trainer derives it from staleness_depth

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    bundle = build_model(cfg)
    run = FLRunConfig(algorithm=args.algorithm, q=args.q, topology=args.topology,
                      n_nodes=args.nodes, batch_per_node=args.batch_per_node,
                      alpha0=args.alpha0, seed=args.seed)
    params = bundle.init_fn(torch.Generator(device=dev).manual_seed(args.seed),
                            device=dev)

    extras: Dict[str, tuple] = {}
    if cfg.family == "vlm":
        extras["prefix_embeds"] = (cfg.frontend_seq, cfg.d_model)
    if cfg.family == "audio":
        extras["frames"] = (cfg.encoder.seq_len, cfg.encoder.d_model)
    fl_rounds = make_fl_token_batches(cfg.vocab_size, args.nodes, args.batch_per_node,
                                      args.seq_len, q=1, seed=args.seed,
                                      extras=extras or None)

    def step_batches():
        while True:
            yield {k: v[0] for k, v in next(fl_rounds).items()}  # (nodes, pnb, ...)

    t0 = time.time()
    result = train_decentralized(
        bundle.loss_fn, params, run, step_batches(), rounds=args.rounds,
        log_every=args.log_every, engine=args.fl_engine,
        scale_chunk=args.scale_chunk, topk=args.topk, round_schedule=fl_schedule,
        storage_dtype=args.storage_dtype,
        topology_program=args.fl_topology_program,
        node_program=args.fl_node_program,
        staleness_depth=args.fl_staleness_depth,
        robust_alpha=args.fl_robust_alpha, privacy=args.fl_privacy,
        scope=args.fl_scope, device=dev,
    )
    hist = result.history
    first, last = hist.rows()[0], hist.last()
    record = {
        "arch": cfg.name,
        "fl_engine": args.fl_engine,
        "fl_schedule": result.engine.round_schedule.spec(),
        "fl_topology_program": args.fl_topology_program,
        "fl_node_program": args.fl_node_program,
        "fl_privacy": result.engine.privacy.spec(),
        "fl_scope": result.engine.scope.spec(),
        "algorithm": args.algorithm,
        "q": args.q,
        "rounds": args.rounds,
        "iterations": int(last["iteration"]),
        "loss_first": first["loss"],
        "loss_last": last["loss"],
        "consensus_err_last": last["consensus_err"],
        "dp_epsilon": last.get("dp_epsilon"),
        "wall_s": round(time.time() - t0, 1),
        "device": str(dev),
    }
    print(json.dumps(record, indent=2))
    if args.checkpoint:
        save_fl_state(args.checkpoint, result.state, extra={"arch": cfg.name},
                      engine=result.engine)
        print(f"checkpoint -> {args.checkpoint}")
    return record


if __name__ == "__main__":
    main()
