"""The RG-LRU recurrence h_t = a_t h_{t-1} + b_t: a hand-written CUDA
kernel for Hopper (``csrc/rglru_scan.cu``), dispatched by ``ops.py``,
beside its plain PyTorch twin in ``ref.py``."""

from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rglru_scan.ref import rglru_ref

__all__ = ["rglru_scan", "rglru_ref"]
