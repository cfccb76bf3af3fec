"""Serving launcher: batched generation from a smoke-size model with
random weights (counterpart of ``repro.launch.serve``; same flags and
JSON, plus ``--device``).

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \
      --batch 4 --prompt-len 16 --max-new 32 --temperature 0.7

Every arch of the registry serves; the audio family (``whisper-medium``)
gets random encoder frames, drawn as the reference draws them. Runs on ``cuda`` unless ``--device cpu`` is given
(the kernels' plain PyTorch twins then run instead); without a card,
``cuda`` raises.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=True)
    bundle = build_model(cfg)
    params = bundle.init_fn(torch.Generator(device=dev).manual_seed(args.seed), device=dev)
    engine = ServeEngine(bundle, params, max_seq=args.max_seq, batch=args.batch)

    rng = np.random.default_rng(args.seed)
    prompts = rng.integers(0, cfg.vocab_size,
                           size=(args.batch, args.prompt_len)).astype(np.int32)
    frames = None
    if cfg.family == "audio":
        frames = rng.normal(size=(args.batch, cfg.encoder.seq_len,
                                  cfg.encoder.d_model)).astype(np.float32)
    t0 = time.time()
    out = engine.generate(prompts, max_new_tokens=args.max_new,
                          temperature=args.temperature, seed=args.seed, frames=frames)
    dt = time.time() - t0
    record = {
        "arch": cfg.name,
        "device": str(dev),
        "batch": args.batch,
        "steps": out.steps,
        "tokens_generated": int(args.batch * args.max_new),
        "wall_s": round(dt, 2),
        "tok_per_s": round(args.batch * args.max_new / dt, 1),
        "sample_continuation":
            out.tokens[0, args.prompt_len:args.prompt_len + 16].tolist(),
    }
    print(json.dumps(record, indent=2))
    return record


if __name__ == "__main__":
    main()
