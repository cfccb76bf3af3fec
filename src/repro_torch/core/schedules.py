"""Learning-rate schedules (counterpart of ``repro.core.schedules``).

The paper's experiments use alpha^r = 0.02 / sqrt(r) and Theorem 1
assumes alpha^r ~ O(sqrt(N / r)). A schedule maps
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

__all__ = ["inv_sqrt", "paper_schedule", "theorem1_schedule", "constant",
           "scaled", "robust_alpha_scale"]


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


def theorem1_schedule(n_nodes: int, c: float = 0.02) -> Schedule:
    """alpha^r = c * sqrt(N / r) -- the Theorem 1 rate showing linear
    speedup in N."""
    c32, n32 = np.float32(c), np.float32(n_nodes)

    def f(step: int) -> np.float32:
        r = np.float32(max(int(step), 1))
        return np.float32(c32 * np.sqrt(np.float32(n32 / r)))

    return f


def constant(alpha: float) -> Schedule:
    a = np.float32(alpha)
    return lambda step: a


def scaled(schedule: Schedule, factor: float) -> Schedule:
    """Pointwise-scaled schedule: ``factor * schedule(r)`` in fp32. The
    base schedule's shape is preserved, only the level shrinks (the
    robustness controller's combinator)."""
    f32 = np.float32(factor)
    return lambda step: np.float32(f32 * schedule(step))


def robust_alpha_scale(uptime: float = 1.0, staleness_depth: int = 0) -> float:
    """Staleness/churn-aware step-size shrink factor in (0, 1].

    With per-node payload availability ``uptime`` an edge survives with
    probability ~uptime**2, scaling the spectral gap by the same factor;
    depth-k bounded-stale mixing contracts disagreement roughly
    ``(k/2 + 1)``-times slower. Both effects multiply:

        scale = uptime**2 * 2 / (2 + k)

    A heuristic, not a bound: it keeps the fault-free tuning's effective
    ``alpha / gap`` ratio."""
    uptime = float(uptime)
    if not (0.0 < uptime <= 1.0):
        raise ValueError(f"uptime={uptime} not in (0, 1]")
    k = int(staleness_depth)
    if k < 0:
        raise ValueError(f"staleness_depth={staleness_depth} must be >= 0")
    return uptime ** 2 * 2.0 / (2.0 + k)
