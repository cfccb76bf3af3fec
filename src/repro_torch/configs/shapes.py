"""The four assigned input shapes and their input builders (counterpart
of ``repro.configs.shapes``).

  train_4k     seq_len=  4,096  global_batch=256   (training, train_step)
  prefill_32k  seq_len= 32,768  global_batch= 32   (inference prefill)
  decode_32k   seq_len= 32,768  global_batch=128   (decode: 1 token vs cache)
  long_500k    seq_len=524,288  global_batch=  1   (long-context decode)

The specs are tensors on ``torch.device("meta")`` -- shapes and dtypes,
nothing allocated -- where the reference builds ``jax.ShapeDtypeStruct``s;
the leaves' shapes and dtypes are the reference's. Training batches
follow the FL layout: every leaf is (Q, nodes, per_node_batch, ...) -- Q
microbatches per communication round.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig

__all__ = ["InputShape", "SHAPES", "train_input_specs", "serve_input_specs",
           "decode_sliding_override", "supports_shape"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    kind: str  # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", "train", 4096, 256),
    "prefill_32k": InputShape("prefill_32k", "prefill", 32768, 32),
    "decode_32k": InputShape("decode_32k", "decode", 32768, 128),
    "long_500k": InputShape("long_500k", "decode", 524288, 1),
}


def _spec(shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _frontend_specs(cfg: ModelConfig, lead: tuple) -> Dict[str, torch.Tensor]:
    """Stubbed modality-frontend embeddings (per task spec)."""
    if cfg.family == "vlm":
        return {"prefix_embeds": _spec(lead + (cfg.frontend_seq, cfg.d_model),
                                       torch.float32)}
    if cfg.family == "audio":
        e = cfg.encoder
        return {"frames": _spec(lead + (e.seq_len, e.d_model), torch.float32)}
    return {}


def train_input_specs(cfg: ModelConfig, shape: InputShape, n_nodes: int,
                      q: int) -> Dict[str, torch.Tensor]:
    """FL round batch: (Q, nodes, per_node_batch, ...)."""
    if shape.global_batch % n_nodes:
        raise ValueError(f"global_batch {shape.global_batch} % nodes {n_nodes} != 0")
    pnb = shape.global_batch // n_nodes
    lead = (q, n_nodes, pnb)
    text_len = shape.seq_len
    if cfg.family == "vlm":
        text_len = shape.seq_len - cfg.frontend_seq  # image patches + text = seq
    specs = {"tokens": _spec(lead + (text_len + 1,), torch.int32)}
    specs.update(_frontend_specs(cfg, lead))
    return specs


def serve_input_specs(cfg: ModelConfig, shape: InputShape) -> Dict[str, torch.Tensor]:
    """Prefill request batch (decode state specs come from the bundle)."""
    b = shape.global_batch
    text_len = shape.seq_len
    if cfg.family == "vlm":
        text_len = shape.seq_len - cfg.frontend_seq
    if cfg.family == "audio":
        text_len = min(text_len, 448)  # whisper prefill prompt is short
    specs = {"tokens": _spec((b, text_len), torch.int32)}
    specs.update(_frontend_specs(cfg, (b,)))
    return specs


def decode_sliding_override(cfg: ModelConfig, shape: InputShape) -> bool:
    """long_500k policy: dense/full-attention archs decode with the
    sliding-window ring-buffer cache; SSM/hybrid run natively."""
    if shape.name != "long_500k":
        return False
    return cfg.family in ("dense", "moe", "vlm")


def supports_shape(cfg: ModelConfig, shape: InputShape) -> bool:
    """whisper x long_500k is the single documented skip."""
    if cfg.family == "audio" and shape.name == "long_500k":
        return False
    return True
