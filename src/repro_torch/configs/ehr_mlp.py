"""The paper's experimental model setup: the class weighting of the
42 -> 32 -> 2 tanh MLP's loss on the imbalanced EHR cohort (counterpart
of ``repro.configs.ehr_mlp``).

``"balanced"`` gives the inverse-frequency weights ``n / (n_classes *
n_c)`` from the published cohort counts, an explicit pair overrides
them, and ``None`` recovers the paper-faithful unweighted loss. Feed the
result to ``models.mlp.make_mlp_loss``.
"""

import numpy as np

from repro_torch.data.ehr import N_AD, N_MCI

# default for the EHR experiments; None = the paper's unweighted loss
CLASS_WEIGHT = "balanced"


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
