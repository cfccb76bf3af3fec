"""Run configuration (counterpart of ``repro.configs.base.FLRunConfig``)."""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["FLRunConfig"]


@dataclasses.dataclass(frozen=True)
class FLRunConfig:
    """One decentralized-FL training run (paper Algorithm 1 hyperparams).
    The reference's fields and defaults, less its multi-pod knob
    (``pod_gossip_every``), which belongs to the multi-GPU engine the
    port does not have yet."""

    algorithm: str = "dsgt"  # dsgd | dsgt
    q: int = 1  # local steps per comm round (paper: 100)
    topology: str = "ring"  # ring | torus | complete | star | hospital20
    n_nodes: int = 16
    batch_per_node: int = 16  # m in the paper (samples per local step)
    alpha0: float = 0.02  # paper: alpha^r = 0.02/sqrt(r)
    schedule: str = "inv_sqrt"  # inv_sqrt | constant | theorem1
    seed: int = 0
    wire_dtype: Optional[str] = None  # e.g. "bfloat16": the exact-wire engines' payload
