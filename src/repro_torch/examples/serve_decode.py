"""Batched serving example: prefill + step-decode across the model
families (counterpart of the reference's ``examples/serve_decode.py``):
dense with a contiguous KV cache and with the sliding-window ring-buffer
cache the reference uses for long-context decoding, RWKV6 with its O(1)
recurrent state, RecurrentGemma's RG-LRU + local-attention hybrid, MoE
routing per decoded token, and the enc-dec family with cross-attention
over random encoder frames.

  PYTHONPATH=src python -m repro_torch.examples.serve_decode --device cpu

Runs on ``cuda`` unless ``--device cpu`` is given; without a card,
``cuda`` raises.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serving.engine import ServeEngine


def demo(arch: str, sliding: bool = False, batch: int = 2, max_new: int = 12,
         device=None) -> np.ndarray:
    """Generate ``max_new`` tokens after an 8-token prompt from the smoke
    config of ``arch`` with random weights; returns the token matrix."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=True)
    bundle = build_model(cfg)
    params = bundle.init_fn(torch.Generator(device=dev).manual_seed(0), device=dev)
    engine = ServeEngine(bundle, params, max_seq=64, batch=batch,
                         sliding_override=sliding)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (batch, 8)).astype(np.int32)
    frames = None
    if cfg.family == "audio":
        frames = rng.normal(size=(batch, cfg.encoder.seq_len,
                                  cfg.encoder.d_model)).astype(np.float32)
    t0 = time.time()
    out = engine.generate(prompts, max_new_tokens=max_new, temperature=0.8, seed=1,
                          frames=frames)
    dt = time.time() - t0
    mode = " (sliding-window cache)" if sliding else ""
    print(f"{arch:24s}{mode}: {batch}x{max_new} tokens in {dt:5.1f}s on {dev} "
          f"-> {out.tokens[0, 8:14].tolist()}...")
    return out.tokens


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain PyTorch twins)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"batched decode across model families (reduced configs, {dev}):")
    demo("tinyllama-1.1b", device=dev)               # dense GQA, contiguous KV cache
    demo("qwen2.5-32b", sliding=True, device=dev)    # dense, ring-buffer window cache
    demo("rwkv6-7b", device=dev)                     # SSM: O(1) decode state
    demo("recurrentgemma-2b", device=dev)            # hybrid RG-LRU + local attention
    demo("dbrx-132b", device=dev)                    # MoE routing per decoded token
    demo("whisper-medium", device=dev)               # enc-dec with cross-attention


if __name__ == "__main__":
    main()
