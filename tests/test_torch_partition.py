"""The port's non-IID diagnostics (``repro_torch.data.partition``) and the
hardened EHR cohort (``generate_ehr_cohort``'s ``label_shift``,
``minority_concentration`` and ``conditional_shift``) against the JAX
package's, bit for bit.

* At the personalization driver's knobs (1.5 / 1.0 / 4.0), and at each
  knob alone, seeds 0 and 1: every hospital's features and labels
  bitwise the reference's; the default cohort unchanged by the knobs'
  gated streams.
* ``cohort_label_stats`` of the hardened cohort equal to the committed
  ``experiments/personalization_ehr.json``'s ``cohort_stats``.
* ``dirichlet_partition`` and ``label_shift_stats`` equal to the
  reference's on the same labels.
"""

import json
from pathlib import Path

import numpy as np
import pytest

from repro.data import ehr as j_ehr
from repro.data import partition as j_partition
from repro_torch.data import partition
from repro_torch.data.ehr import generate_ehr_cohort

ROOT = Path(__file__).resolve().parents[1]
KNOBS = [dict(label_shift=1.5, minority_concentration=1.0, conditional_shift=4.0),
         dict(label_shift=1.5), dict(minority_concentration=1.0),
         dict(conditional_shift=4.0)]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("knobs", KNOBS, ids=["all", "label_shift", "minority",
                                              "conditional"])
def test_hardened_cohort_is_the_references(knobs, seed):
    mine, theirs = generate_ehr_cohort(seed=seed, **knobs), j_ehr.generate_ehr_cohort(
        seed=seed, **knobs)
    assert len(mine.features) == len(theirs.features) == 20
    for a, b in zip(mine.features, theirs.features):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for a, b in zip(mine.labels, theirs.labels):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    plain = generate_ehr_cohort(seed=seed)
    assert any(not np.array_equal(a, b) for a, b in zip(mine.labels + mine.features,
                                                        plain.labels + plain.features))


def test_cohort_stats_equal_the_committed_json():
    want = json.loads((ROOT / "experiments" / "personalization_ehr.json").read_text())
    data = generate_ehr_cohort(seed=0, label_shift=1.5, minority_concentration=1.0,
                               conditional_shift=4.0)
    assert partition.cohort_label_stats(data.labels) == want["cohort_stats"]
    assert partition.cohort_label_stats(data.labels) == j_partition.cohort_label_stats(
        j_ehr.generate_ehr_cohort(seed=0, label_shift=1.5, minority_concentration=1.0,
                                  conditional_shift=4.0).labels)


@pytest.mark.parametrize("alpha", [0.1, 1.0, 100.0])
def test_dirichlet_partition_and_stats_are_the_references(alpha):
    labels = np.random.default_rng(4).integers(0, 3, size=500)
    parts = partition.dirichlet_partition(labels, 7, alpha, seed=2)
    want = j_partition.dirichlet_partition(labels, 7, alpha, seed=2)
    assert len(parts) == len(want) == 7
    for a, b in zip(parts, want):
        assert a.dtype == np.int64 and np.array_equal(a, b)
    assert sorted(np.concatenate(parts).tolist()) == list(range(500))
    assert partition.label_shift_stats(labels, parts) == j_partition.label_shift_stats(
        labels, want)
