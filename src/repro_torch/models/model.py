"""Model registry: ModelConfig -> ModelBundle (counterpart of
``repro.models.model``), for every family: the decoder-only ones (dense,
``vlm``, ``moe``, ``ssm``, ``hybrid``; ``models.transformer``) and the
``audio`` encoder-decoder (``models.encdec``).

The bundle is the integration surface the trainer and the serving
engine consume. The reference's ``impl`` argument is gone: the port's
attention and recurrence kernels dispatch by device, so its ``"ref"``,
``"flash"``, ``"blocked"``, ``"decode_kernel"`` and ``"pallas"`` paths
are one path here. ``build_model(cfg, model_group=pg)`` builds any
family's bundle for a rank of a model group: its ``loss_fn`` runs on the
rank's shards (``models.sharding.shard_params``) through the
tensor-parallel layers (``models.tensor_parallel``: attention, the MLPs,
RWKV6's time and channel mix, the RG-LRU block, whisper's
encoder-decoder) and the expert-parallel MoE (``models.moe``).

``loss_fn`` is NODE-BATCHED, the port trainer's ``core.fl.LossFn``:
params with (n, ...) leaves and a batch with (n, ...) leaves in, the n
per-node losses out. It loops over the node axis, running the
single-node loss (``lm_loss``, or ``encdec_loss`` for ``audio``) on
``params[i]`` and ``batch[i]`` (the reference vmaps the single-node
loss), so the kernels launch once per node and autograd of the summed
losses gives each node its own gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fl import tree_map
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.tensor_parallel import tp_group

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


def _node_batched(single_loss: Callable[[Dict, Dict], torch.Tensor]) -> Callable:
    """The per-node losses (n,) of node-stacked params and batch."""

    def loss_fn(params, batch):
        n = next(iter(batch.values())).shape[0]
        return torch.stack([
            single_loss(tree_map(lambda a, i=i: a[i], params),
                        {key: b[i] for key, b in batch.items()})
            for i in range(n)])

    return loss_fn


def build_model(cfg: ModelConfig, remat: bool = True, model_group=None) -> ModelBundle:
    """The bundle of ``cfg``. ``model_group``: a model process group
    (``NodeGroup.model_pg``) whose rank this process is -- the bundle's
    ``loss_fn`` then takes the rank's shards of the parameters;
    ``init_fn`` and the serving functions stay whole."""
    tp = tp_group(model_group)
    if tp is not None:
        tfm.check_tensor_parallel(cfg)
    if cfg.family == "audio":
        return _build_encdec(cfg, remat, tp)
    tfm.check_kinds(cfg)

    def init_fn(generator: Optional[torch.Generator], device=None) -> Dict:
        return tfm.init_params(cfg, generator, device)

    def prefill_fn(params, batch):
        return tfm.prefill(params, cfg, batch)

    def decode_fn(params, tokens, caches, sliding_override: bool = False):
        return tfm.decode_step(params, cfg, tokens, caches, sliding_override)

    def init_decode_state_fn(batch: int, max_seq: int, sliding_override: bool = False,
                             device=None) -> Any:
        return tfm.init_decode_state(cfg, batch, max_seq, sliding_override,
                                     device=device)

    return ModelBundle(
        cfg=cfg, init_fn=init_fn,
        loss_fn=_node_batched(lambda p, b: tfm.lm_loss(p, cfg, b, remat=remat, tp=tp)),
        prefill_fn=prefill_fn, decode_fn=decode_fn,
        init_decode_state_fn=init_decode_state_fn)


def _build_encdec(cfg: ModelConfig, remat: bool, tp=None) -> ModelBundle:
    def init_fn(generator: Optional[torch.Generator], device=None) -> Dict:
        return encdec_mod.encdec_init(cfg, generator, device)

    def prefill_fn(params, batch):
        return encdec_mod.encdec_prefill(params, cfg, batch)

    def decode_fn(params, tokens, caches, sliding_override: bool = False):
        del sliding_override  # whisper decoder: contiguous self-cache only
        return encdec_mod.encdec_decode_step(params, cfg, tokens, caches)

    def init_decode_state_fn(batch: int, max_seq: int, sliding_override: bool = False,
                             device=None) -> Dict:
        del sliding_override
        return encdec_mod.encdec_init_decode_state(cfg, batch, max_seq, device=device)

    return ModelBundle(
        cfg=cfg, init_fn=init_fn,
        loss_fn=_node_batched(lambda p, b: encdec_mod.encdec_loss(p, cfg, b, remat=remat,
                                                                  tp=tp)),
        prefill_fn=prefill_fn, decode_fn=decode_fn,
        init_decode_state_fn=init_decode_state_fn)
