"""Quickstart: decentralized federated training in ~40 lines (counterpart
of the reference's ``examples/quickstart.py``, plus ``--device``).

Trains a reduced llama-family model (the TinyLlama-1.1B smoke config)
across 8 simulated FL nodes on a ring graph with FD-DSGT (the paper's
Algorithm 1, Q = 4 local steps a round, 25 rounds), then serves the
consensus model.

  PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; without a card,
``cuda`` raises.
"""

import argparse

import numpy as np
import torch

from repro_torch.configs import FLRunConfig, get_config
from repro_torch.data.tokens import make_fl_token_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine
from repro_torch.training.trainer import train_decentralized


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    ap.add_argument("--rounds", type=int, default=25)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. pick an architecture (any ported id works)
    cfg = get_config("tinyllama-1.1b", smoke=True)
    bundle = build_model(cfg)

    # 2. decentralized FL run config: 8 hospitals on a ring, Q=4 local steps
    run = FLRunConfig(algorithm="dsgt", q=4, topology="ring", n_nodes=8,
                      batch_per_node=2, alpha0=0.5, schedule="constant")

    # 3. per-node non-IID token streams
    stream = make_fl_token_batches(cfg.vocab_size, run.n_nodes, run.batch_per_node,
                                   seq_len=64, q=1, seed=0)
    step_batches = ({k: v[0] for k, v in b.items()} for b in stream)

    # 4. train: Q local steps per node, then one ring-gossip round
    params = bundle.init_fn(torch.Generator(device=dev).manual_seed(0), device=dev)
    result = train_decentralized(bundle.loss_fn, params, run, step_batches,
                                 rounds=args.rounds, log_every=5, device=dev)
    h = result.history
    print(f"\nloss {h.rows()[0]['loss']:.3f} -> {h.last()['loss']:.3f} "
          f"in {int(h.last()['comm_rounds'])} comm rounds "
          f"({int(h.last()['iteration'])} iterations)")
    print(f"consensus error: {h.last()['consensus_err']:.2e}")

    # 5. serve the consensus model
    engine = ServeEngine(bundle, result.consensus, max_seq=96, batch=2)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    out = engine.generate(prompts, max_new_tokens=8, temperature=0.0)
    print("generated:", out.tokens[:, 8:].tolist())
    return {"losses": h.column("loss").tolist(), "tokens": out.tokens,
            "consensus_err": h.last()["consensus_err"]}


if __name__ == "__main__":
    main()
