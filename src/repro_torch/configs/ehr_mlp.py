"""The paper's experimental model setup: the class weighting of the
42 -> 32 -> 2 tanh MLP's loss on the imbalanced EHR cohort (counterpart
of ``repro.configs.ehr_mlp``).

``"balanced"`` gives the inverse-frequency weights ``n / (n_classes *
n_c)`` from the published cohort counts, an explicit pair overrides
them, and ``None`` recovers the paper-faithful unweighted loss. Feed the
result to ``models.mlp.make_mlp_loss``. ``TOPK_SCHEDULE`` is the
adaptive top-k wire's default spec (``topk_schedule``).
"""

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.data.ehr import N_AD, N_MCI

# the registry's entry (``get_config("ehr-mlp")``), field for field the
# reference's
CONFIG = ModelConfig(
    name="ehr-mlp",
    family="mlp",
    n_layers=2,
    d_model=42,  # feature dim ("problem dimension of 42")
    n_heads=0,
    n_kv_heads=0,
    d_ff=32,  # hidden width
    vocab_size=2,  # AD vs MCI
    source="this paper, Section 3",
)

# default for the EHR experiments; None = the paper's unweighted loss
CLASS_WEIGHT = "balanced"

# Adaptive top-k wire: (k_sparse, k_dense, densify_high[, resparsify_low]).
# Rounds ship the sparse k until the EF-residual RMS crosses densify_high,
# then k_dense until it drains below resparsify_low (default high / 2):
# a hysteresis band (training.trainer.AdaptiveTopK). k_dense >= the scale
# chunk means the plain dense int8 wire. On the 20-hospital cohort the
# cold-start rounds sit above the high threshold and the steady state
# below the low one, so both widths run.
TOPK_SCHEDULE = (64, 512, 3e-3)


def topk_schedule(spec=TOPK_SCHEDULE):
    """Validate an adaptive-k spec to (k_sparse, k_dense, high[, low]),
    or pass None through (fixed-k wire)."""
    if spec is None:
        return None
    if len(spec) not in (3, 4):
        raise ValueError(
            f"topk_schedule needs (k_sparse, k_dense, high[, low]), got "
            f"{spec!r}"
        )
    k_sparse, k_dense = int(spec[0]), int(spec[1])
    thresholds = tuple(float(v) for v in spec[2:])
    low = thresholds[1] if len(thresholds) == 2 else thresholds[0] / 2.0
    if (not (1 <= k_sparse <= k_dense) or thresholds[0] <= 0
            or not (0 < low <= thresholds[0])):
        raise ValueError(
            f"topk_schedule needs 1 <= k_sparse <= k_dense and a "
            f"positive densify_high >= resparsify_low > 0, got {spec!r}"
        )
    return (k_sparse, k_dense) + thresholds


def class_weights(class_weight=CLASS_WEIGHT):
    """Resolve the ``class_weight`` knob to a float64 (2,) array or None
    (labels: 0 = MCI majority, 1 = AD minority)."""
    if class_weight is None:
        return None
    if class_weight == "balanced":
        counts = np.asarray([N_MCI, N_AD], np.float64)
        return counts.sum() / (len(counts) * counts)
    w = np.asarray(class_weight, np.float64)
    if w.shape != (2,) or (w <= 0).any():
        raise ValueError(
            f"class_weight must be 'balanced', None, or 2 positive "
            f"weights; got {class_weight!r}"
        )
    return w


def smoke_config() -> ModelConfig:
    return CONFIG  # already CPU-scale
