"""Model registry: ModelConfig -> ModelBundle (counterpart of
``repro.models.model``), for the dense, ``ssm`` (RWKV6) and ``hybrid``
(RecurrentGemma) decoder-only families.

The bundle is the integration surface the serving engine consumes. The
reference's ``impl`` argument is gone: the port's attention and
recurrence kernels dispatch by device, so its ``"ref"``, ``"flash"``,
``"blocked"``, ``"decode_kernel"`` and ``"pallas"`` paths are one path
here. ``remat`` and ``loss_fn`` belong to training, which waits for the
port's training slice; the sharding specs wait for the multi-GPU engine.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tfm

__all__ = ["ModelBundle", "build_model"]


@dataclasses.dataclass(frozen=True)
class ModelBundle:
    cfg: ModelConfig
    init_fn: Callable[..., Dict]
    loss_fn: Callable[[Dict, Dict], torch.Tensor]
    prefill_fn: Callable[[Dict, Dict], Tuple[torch.Tensor, torch.Tensor]]
    decode_fn: Callable[..., Tuple[torch.Tensor, Dict]]
    init_decode_state_fn: Callable[..., Dict]

    def param_shapes(self) -> Dict:
        """The parameter tree on the ``meta`` device: shapes and dtypes,
        nothing allocated."""
        return self.init_fn(None, device="meta")


def build_model(cfg: ModelConfig) -> ModelBundle:
    if cfg.family == "audio":
        raise NotImplementedError(
            "the audio (enc-dec) family is not ported yet (ROADMAP.md queue 1 item 16)")
    tfm.check_kinds(cfg)

    def init_fn(generator: Optional[torch.Generator], device=None) -> Dict:
        return tfm.init_params(cfg, generator, device)

    def loss_fn(params, batch):
        raise NotImplementedError(
            "training the transformer (lm_loss) is not ported yet (ROADMAP.md "
            "queue 1 item 16): the port serves its models only")

    def prefill_fn(params, batch):
        return tfm.prefill(params, cfg, batch)

    def decode_fn(params, tokens, caches, sliding_override: bool = False):
        return tfm.decode_step(params, cfg, tokens, caches, sliding_override)

    def init_decode_state_fn(batch: int, max_seq: int, sliding_override: bool = False,
                             device=None) -> Any:
        return tfm.init_decode_state(cfg, batch, max_seq, sliding_override,
                                     device=device)

    return ModelBundle(cfg=cfg, init_fn=init_fn, loss_fn=loss_fn,
                       prefill_fn=prefill_fn, decode_fn=decode_fn,
                       init_decode_state_fn=init_decode_state_fn)
