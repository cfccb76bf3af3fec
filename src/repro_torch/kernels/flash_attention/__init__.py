"""Prefill attention (causal / sliding window, GQA): a hand-written CUDA
kernel for Hopper (``csrc/flash_attention.cu``), dispatched by
``ops.py``, beside its plain PyTorch twin in ``ref.py``."""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
