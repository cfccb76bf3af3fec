"""Learning-rate schedules (counterpart of ``repro.core.schedules``).

The paper's experiments use alpha^r = 0.02 / sqrt(r). A schedule maps
the global iteration counter r (1-indexed, a host integer: the port runs
eagerly, so the counter never lives on the device) to a float32 scalar.
The arithmetic is float32 throughout, ``float32(alpha0) /
sqrt(float32(r))`` with IEEE division and square root, as the
reference writes it; a Python double would differ in the last bit.
(The reference evaluates the same expression inside ``jit``, where XLA
on the CPU rewrites it to ``alpha0 * rsqrt(r)``; that can differ from
this value by one ulp.)
"""

from __future__ import annotations

from typing import Callable

import numpy as np

Schedule = Callable[[int], np.float32]

__all__ = ["inv_sqrt", "paper_schedule", "constant"]


def inv_sqrt(alpha0: float) -> Schedule:
    """alpha^r = alpha0 / sqrt(r), r >= 1."""
    a0 = np.float32(alpha0)

    def f(step: int) -> np.float32:
        r = np.float32(max(int(step), 1))
        return np.float32(a0 / np.sqrt(r))

    return f


def paper_schedule() -> Schedule:
    """The paper's exact experimental schedule: 0.02 / sqrt(r)."""
    return inv_sqrt(0.02)


def constant(alpha: float) -> Schedule:
    a = np.float32(alpha)
    return lambda step: a
