"""WKV-6, the RWKV6 time-mix recurrence: a hand-written CUDA kernel for
Hopper (``csrc/rwkv6_scan.cu``), dispatched by ``ops.py``, beside its
plain PyTorch twin in ``ref.py``."""

from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.kernels.rwkv6_scan.ref import wkv6_ref

__all__ = ["wkv6", "wkv6_ref"]
