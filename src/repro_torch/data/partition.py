"""Non-IID partitioners and heterogeneity diagnostics (a numpy copy of
``repro.data.partition``).

The paper's datasets are *naturally* partitioned (each hospital's patients
are its own). For ablations on synthetic corpora we also provide the
standard Dirichlet(alpha) label-skew partitioner used across the FL
literature (alpha -> 0: one-class nodes; alpha -> inf: IID).
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

__all__ = ["dirichlet_partition", "label_shift_stats", "cohort_label_stats"]


def dirichlet_partition(
    labels: np.ndarray, n_nodes: int, alpha: float, seed: int = 0
) -> List[np.ndarray]:
    """Index lists per node with Dirichlet(alpha) class proportions."""
    rng = np.random.default_rng(seed)
    classes = np.unique(labels)
    node_indices: List[List[int]] = [[] for _ in range(n_nodes)]
    for c in classes:
        idx = np.nonzero(labels == c)[0]
        rng.shuffle(idx)
        props = rng.dirichlet(np.full(n_nodes, alpha))
        cuts = (np.cumsum(props)[:-1] * len(idx)).astype(int)
        for node, part in enumerate(np.split(idx, cuts)):
            node_indices[node].extend(part.tolist())
    return [np.asarray(sorted(ix), dtype=np.int64) for ix in node_indices]


def label_shift_stats(
    labels: np.ndarray, parts: List[np.ndarray]
) -> Dict[str, float]:
    """Quantify heterogeneity: mean/max total-variation distance between
    per-node label distributions and the global one."""
    classes = np.unique(labels)
    global_p = np.array([(labels == c).mean() for c in classes])
    tvs = []
    for ix in parts:
        if len(ix) == 0:
            continue
        local = labels[ix]
        p = np.array([(local == c).mean() for c in classes])
        tvs.append(0.5 * np.abs(p - global_p).sum())
    return {
        "tv_mean": float(np.mean(tvs)),
        "tv_max": float(np.max(tvs)),
        "nodes": float(len(tvs)),
    }


def cohort_label_stats(labels_per_node) -> Dict[str, float]:
    """Label-shift diagnostics for a NATURALLY partitioned cohort (a
    sequence of per-node label arrays, e.g. ``EHRDataset.labels``):
    the TV-distance stats of :func:`label_shift_stats` plus the spread
    of per-node positive-class prevalence -- the number the harder
    cohort knobs (``label_shift`` / ``minority_concentration``) move."""
    labels_per_node = [np.asarray(l) for l in labels_per_node]
    y = np.concatenate(labels_per_node)
    parts, off = [], 0
    for l in labels_per_node:
        parts.append(np.arange(off, off + len(l), dtype=np.int64))
        off += len(l)
    stats = label_shift_stats(y, parts)
    prev = [float(l.mean()) if len(l) else 0.0 for l in labels_per_node]
    stats["prevalence_min"] = float(min(prev))
    stats["prevalence_max"] = float(max(prev))
    stats["prevalence_mean"] = float(np.mean(prev))
    return stats
