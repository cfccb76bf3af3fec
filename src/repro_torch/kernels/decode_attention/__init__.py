"""Single-token decode attention over a KV cache: a hand-written CUDA
kernel for Hopper (``csrc/decode_attention.cu``), dispatched by
``ops.py``, beside its plain PyTorch twin in ``ref.py``."""

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref"]
