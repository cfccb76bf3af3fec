"""Single-token decode attention over a KV cache: hand-written CUDA
kernels for Hopper (``csrc/decode_attention.cu``: the split-KV kernel and
its combine), dispatched by ``ops.py``, beside their plain PyTorch twins
in ``ref.py``."""

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_ref

__all__ = ["decode_attention", "decode_attention_ref"]
