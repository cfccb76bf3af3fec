"""Configurations (counterpart of ``repro.configs``): the run config, the
EHR MLP's constants, the reference's registry of architectures and the
input shapes.

``--arch <id>`` names resolve through :func:`get_config` to the full
``CONFIG`` or the reduced ``smoke_config()``; ``ASSIGNED_ARCHS`` is the
registry less the EHR MLP, as in the reference.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import EncoderConfig, FLRunConfig, ModelConfig
from repro_torch.configs.shapes import (
    SHAPES,
    InputShape,
    decode_sliding_override,
    serve_input_specs,
    supports_shape,
    train_input_specs,
)

__all__ = [
    "ARCH_MODULES",
    "ASSIGNED_ARCHS",
    "EncoderConfig",
    "FLRunConfig",
    "InputShape",
    "ModelConfig",
    "SHAPES",
    "decode_sliding_override",
    "get_config",
    "serve_input_specs",
    "supports_shape",
    "train_input_specs",
]

# arch id -> module name
ARCH_MODULES: Dict[str, str] = {
    "phi3-medium-14b": "phi3_medium_14b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "internvl2-26b": "internvl2_26b",
    "smollm-360m": "smollm_360m",
    "rwkv6-7b": "rwkv6_7b",
    "qwen2.5-32b": "qwen2_5_32b",
    "dbrx-132b": "dbrx_132b",
    "whisper-medium": "whisper_medium",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "ehr-mlp": "ehr_mlp",
}

ASSIGNED_ARCHS = tuple(a for a in ARCH_MODULES if a != "ehr-mlp")


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.smoke_config() if smoke else mod.CONFIG
