"""Run metrics (counterpart of ``repro.training.metrics.MetricHistory``)."""

from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["MetricHistory"]


class MetricHistory:
    """Append-only metric recorder with numpy export."""

    def __init__(self) -> None:
        self._rows: list[Dict[str, float]] = []

    def append(self, **kv: float) -> None:
        self._rows.append({k: float(v) for k, v in kv.items()})

    def __len__(self) -> int:
        return len(self._rows)

    def column(self, key: str) -> np.ndarray:
        return np.array([r[key] for r in self._rows if key in r])

    def last(self) -> Dict[str, float]:
        return dict(self._rows[-1]) if self._rows else {}

    def rows(self) -> list[Dict[str, float]]:
        return [dict(r) for r in self._rows]
