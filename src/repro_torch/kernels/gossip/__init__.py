"""The round megakernels of the fused engine: hand-written CUDA for
Hopper (``csrc/fused_round_cluster.cu``, built by ``build.py``), dispatched by
``ops.py``, each beside its plain PyTorch twin in ``ref.py``."""

from repro_torch.kernels.gossip.ops import fused_round, fused_round_gt
from repro_torch.kernels.gossip.ref import (
    fused_round_gt_ref,
    fused_round_ref,
    gossip_mix_ref,
)

__all__ = ["fused_round", "fused_round_gt", "fused_round_ref",
           "fused_round_gt_ref", "gossip_mix_ref"]
