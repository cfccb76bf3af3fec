"""Build the gossip kernels (``csrc/*.cu``) into ``build/`` beside this
file, through the shared build module :mod:`repro_torch.kernels.build`.
Importing this module builds nothing: :func:`build` and :func:`load` do,
and only on a machine with the CUDA toolkit."""

from __future__ import annotations

from pathlib import Path

from repro_torch.kernels.build import BASE_FLAGS, KernelLibraries

__all__ = ["build", "load", "NVCC_FLAGS", "LIBS"]

#: -fmad=false keeps nvcc from contracting a*b+c into an FMA, so the
#: update and error-feedback arithmetic rounds like the PyTorch twin.
NVCC_FLAGS = BASE_FLAGS + ("-fmad=false",)

LIBS = KernelLibraries(Path(__file__).resolve().parent, NVCC_FLAGS)
build, load = LIBS.build, LIBS.load
