"""Launch counting shared by every kernel wrapper.

A wrapper calls :func:`launched` exactly where it launches its hand
kernel on CUDA tensors, and where it stands in for that launch on
``meta`` tensors (the dry run: the kernel's outputs allocated with their
shapes and dtypes, nothing computed). The call adds one to the wrapper's
counter (``<wrapper>.launches``, or the attribute ``counter`` names) and
hands the launch's geometry to every watcher: ``launch.op_analysis``
prices each launch with the counts ``benchmarks/kernel_bench.py`` keeps
for the kernel's bound. A twin call on CPU tensors is not a launch and
calls nothing here.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List

__all__ = ["launched", "watching"]

_WATCHERS: List[Callable[[str, Dict], None]] = []


def launched(wrapper, counter: str = "launches", **geometry) -> None:
    """Count one launch of ``wrapper``'s kernel and tell the watchers
    ``(name, geometry)``; ``name`` is the wrapper's, or
    ``<wrapper>.<counter>`` for a second kernel behind one wrapper."""
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)
    name = wrapper.__name__ if counter == "launches" else f"{wrapper.__name__}.{counter}"
    for watch in tuple(_WATCHERS):
        watch(name, geometry)


@contextlib.contextmanager
def watching(fn: Callable[[str, Dict], None]):
    """Call ``fn(name, geometry)`` at every launch inside the block."""
    _WATCHERS.append(fn)
    try:
        yield fn
    finally:
        _WATCHERS.remove(fn)
