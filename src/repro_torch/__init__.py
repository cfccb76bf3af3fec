"""PyTorch / CUDA port of the decentralized-FL engine for NVIDIA Hopper.

The package mirrors ``repro``'s subpackage names so every module has an
obvious counterpart, and it imports only ``torch`` and numpy. What it
needs from ``repro``'s numpy-only modules (the EHR cohort, the graphs)
it carries as its own copies.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :func:`repro_torch.device.resolve_device`); asking for ``cuda``
without a card raises instead of falling back. On a CUDA tensor every
kernel wrapper launches its hand-written kernel; its plain PyTorch twin
runs only for tensors on the CPU.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
