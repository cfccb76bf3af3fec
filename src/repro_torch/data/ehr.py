"""Synthetic EHR cohort matched to the paper's published statistics.

Section 2.1: 2,103 Alzheimer's Disease (AD) + 7,919 mild-cognitive-
impairment (MCI) patients across 20 hospitals (~500 records each),
42 engineered features. The real IQVIA dataset is proprietary; this
generator reproduces the *structure* that drives the paper's algorithmic
claims:

  * non-identical per-hospital distributions (Fig. 1 right: t-SNE clusters
    separate by hospital) -- each hospital gets its own feature-mean offset
    and covariance rotation, so the local optima f_i* genuinely disagree;
  * class imbalance (AD ~21% overall) varying per hospital;
  * a shared global signal (a true separating direction) so the consensus
    model is learnable.

Generation is pure numpy with a fixed seed: deterministic, no I/O. This
module is a copy of ``repro.data.ehr``, so both packages draw the same
cohort and the same batch stream, bit for bit, from the same seeds.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np

__all__ = ["EHRDataset", "generate_ehr_cohort", "make_node_batcher"]

N_HOSPITALS = 20
N_FEATURES = 42
N_AD = 2103
N_MCI = 7919


@dataclasses.dataclass(frozen=True)
class EHRDataset:
    """Per-hospital arrays: features[i] (n_i, 42) float32, labels[i] (n_i,)
    int32 (1 = AD, 0 = MCI)."""

    features: Tuple[np.ndarray, ...]
    labels: Tuple[np.ndarray, ...]

    @property
    def n_nodes(self) -> int:
        return len(self.features)

    def node_sizes(self) -> List[int]:
        return [len(x) for x in self.features]

    def totals(self) -> Dict[str, int]:
        y = np.concatenate(self.labels)
        return {"n": len(y), "ad": int(y.sum()), "mci": int((1 - y).sum())}


def generate_ehr_cohort(
    seed: int = 0,
    n_hospitals: int = N_HOSPITALS,
    n_features: int = N_FEATURES,
    n_ad: int = N_AD,
    n_mci: int = N_MCI,
    heterogeneity: float = 1.5,
    label_shift: float = 0.0,
    minority_concentration: float = 0.0,
    conditional_shift: float = 0.0,
) -> EHRDataset:
    """Build the cohort. ``heterogeneity`` scales the per-hospital
    distribution shift (0 = IID across hospitals).

    The three extra knobs harden the cohort for personalization-vs-
    consensus experiments (all default 0, which reproduces the legacy
    cohort BIT-IDENTICALLY -- their draws come from separate, gated RNG
    streams):

    * ``label_shift``: per-hospital AD-prevalence tilt. Each hospital
      gets a tilt in [-1, 1]; AD mass is reweighted by
      ``exp(label_shift * tilt)`` (MCI by the inverse), so hospitals
      range from AD-poor to AD-rich while the cohort totals stay exact.
    * ``minority_concentration``: concentrates the minority (AD) class
      into few hospitals -- AD mass is further multiplied by a per-
      hospital factor in [0.05, 1] raised to this power, so at 1-2 most
      hospitals see only a handful of AD cases.
    * ``conditional_shift``: per-hospital CLASS-CONDITIONAL drift -- the
      AD cluster's mean moves along a hospital-specific direction
      orthogonal to the global signal, so the Bayes-optimal classifier
      genuinely differs per hospital (a shared head cannot be optimal
      everywhere; a personalized head can).
    """
    rng = np.random.default_rng(seed)

    # global class-separating structure
    w_true = rng.normal(size=(n_features,))
    w_true /= np.linalg.norm(w_true)

    # per-hospital distribution shift: mean offset + random rotation mix
    offsets = heterogeneity * rng.normal(size=(n_hospitals, n_features))
    mixes = []
    for _ in range(n_hospitals):
        a = rng.normal(size=(n_features, n_features)) * 0.15
        mixes.append(np.eye(n_features) + a)

    # allocate patients to hospitals (~500 each, Dirichlet jitter);
    # ``weight`` reweights a hospital's share AFTER the base Dirichlet
    # draw, so the rng stream (and the default cohort) is unchanged
    def alloc(total: int, weight=None) -> np.ndarray:
        p = rng.dirichlet(np.full(n_hospitals, 20.0))
        if weight is not None:
            p = p * weight
            p = p / p.sum()
        counts = np.floor(p * total).astype(int)
        counts[: total - counts.sum()] += 1
        return counts

    ad_w = mci_w = None
    if label_shift or minority_concentration:
        rng_shift = np.random.default_rng((seed, 104729))
        tilt = rng_shift.permutation(np.linspace(-1.0, 1.0, n_hospitals))
        ad_w = np.exp(label_shift * tilt)
        mci_w = np.exp(-label_shift * tilt)
        if minority_concentration:
            conc = rng_shift.permutation(
                np.linspace(1.0, 0.05, n_hospitals))
            ad_w = ad_w * conc ** minority_concentration
    ad_counts = alloc(n_ad, ad_w)
    mci_counts = alloc(n_mci, mci_w)

    cond_dirs = None
    if conditional_shift:
        rng_cond = np.random.default_rng((seed, 1299709))
        cond_dirs = rng_cond.normal(size=(n_hospitals, n_features))
        # orthogonal to the global signal: the drift moves the AD
        # cluster WITHOUT strengthening or weakening the shared
        # separating direction
        cond_dirs -= (cond_dirs @ w_true)[:, None] * w_true
        cond_dirs /= np.linalg.norm(cond_dirs, axis=1, keepdims=True)

    feats, labs = [], []
    for h in range(n_hospitals):
        n_pos, n_neg = int(ad_counts[h]), int(mci_counts[h])
        z_pos = rng.normal(size=(n_pos, n_features)) + 1.2 * w_true
        z_neg = rng.normal(size=(n_neg, n_features)) - 0.3 * w_true
        if cond_dirs is not None:
            z_pos = z_pos + conditional_shift * cond_dirs[h]
        z = np.concatenate([z_pos, z_neg], axis=0)
        y = np.concatenate([np.ones(n_pos), np.zeros(n_neg)]).astype(np.int32)
        x = (z @ mixes[h].T + offsets[h]).astype(np.float32)
        perm = rng.permutation(len(y))
        feats.append(x[perm])
        labs.append(y[perm])

    # standardize with GLOBAL statistics (each hospital could compute these
    # privately via secure aggregation; offsets keep the per-node shift)
    allx = np.concatenate(feats)
    mu, sd = allx.mean(0), allx.std(0) + 1e-6
    feats = [((x - mu) / sd).astype(np.float32) for x in feats]
    return EHRDataset(features=tuple(feats), labels=tuple(labs))


def make_node_batcher(
    data: EHRDataset, m: int, seed: int = 0
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of FL round batches shaped for ``make_fl_round``:
    each call yields {"x": (Q?, nodes, m, 42), ...} -- here per-STEP batches
    (nodes, m, 42); the trainer stacks Q of them.

    Samples WITH replacement per node (the paper's stochastic gradient
    ``m``-sample estimate, m=20).
    """
    rng = np.random.default_rng(seed)
    n = data.n_nodes
    while True:
        xs = np.empty((n, m, data.features[0].shape[1]), np.float32)
        ys = np.empty((n, m), np.int32)
        for i in range(n):
            idx = rng.integers(0, len(data.labels[i]), size=m)
            xs[i] = data.features[i][idx]
            ys[i] = data.labels[i][idx]
        yield {"x": xs, "y": ys}
