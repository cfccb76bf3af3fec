"""Prefill attention (causal / sliding window, GQA): hand-written CUDA
kernels for Hopper (bf16 on the tensor cores in
``csrc/flash_attention_tc.cu``, fp32 in ``csrc/flash_attention.cu``),
dispatched by dtype in ``ops.py``, beside their plain PyTorch twin in
``ref.py``."""

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "attention_ref"]
