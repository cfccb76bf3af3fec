"""Configurations (counterpart of ``repro.configs``): the run config, the
EHR MLP's constants and the architectures the port serves.

``--arch <id>`` names resolve through :func:`get_config` to the full
``CONFIG`` or the reduced ``smoke_config()``. The dense decoder-only
architectures, RWKV6 (``ssm``) and RecurrentGemma (``hybrid``) are
ported so far; every other id of the reference's registry raises
``NotImplementedError``.
"""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.configs.base import FLRunConfig, ModelConfig

__all__ = ["ARCH_MODULES", "UNPORTED_ARCHS", "FLRunConfig", "ModelConfig",
           "get_config"]

# arch id -> module name, for the architectures the port has
ARCH_MODULES: Dict[str, str] = {
    "smollm-360m": "smollm_360m",
    "tinyllama-1.1b": "tinyllama_1_1b",
    "rwkv6-7b": "rwkv6_7b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

# the rest of the reference's registry: MoE, enc-dec, the VLM backbone and
# the larger dense models wait in ROADMAP.md queue 1 item 16
UNPORTED_ARCHS = (
    "phi3-medium-14b", "internvl2-26b", "qwen2.5-32b", "dbrx-132b",
    "whisper-medium", "llama4-scout-17b-a16e",
)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    if arch in UNPORTED_ARCHS:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP.md queue 1 item 16); "
            f"ported: {sorted(ARCH_MODULES)}"
        )
    if arch not in ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCH_MODULES[arch]}")
    return mod.smoke_config() if smoke else mod.CONFIG
