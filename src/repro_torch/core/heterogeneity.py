"""Node heterogeneity: per-node compute and communication faults as the
round machinery's fourth axis (counterpart of
``repro.core.heterogeneity``).

A :class:`NodeProgram` maps (round counter, key) to per-node operands of
the same round function:

  * a **compute rate**: which of the round's ``q - 1`` local steps each
    node runs (:meth:`NodeProgram.step_gate`; a masked step moves the
    node by nothing);
  * a **payload gate**: whether each node's payload lands this round
    (:meth:`NodeProgram.wire_gate`; late and dropped payloads are one
    event at round granularity).

A missing payload masks both directions of every edge at the node (the
symmetric outer product ``up_i * up_j``), and the lost weight folds into
the two self-loops (:func:`compose_node_gate`), so every realized W_r
stays symmetric and doubly stochastic. The wire still crosses every
round: the gate only zeroes the mixing contribution, so every receiver
folds every difference-coded payload it is sent.

Registered programs (the ``--fl-node-program`` spec strings):

    homogeneous                the lockstep default (static)
    stragglers:frac=,rate=,drop=,seed=
                               each round, each node is slow with
                               probability ``frac``; a slow node runs
                               ``ceil(rate * (q-1))`` of its local steps
                               and, with ``drop=1`` (default), its
                               payload misses the round
    slow_nodes:frac=,rate=,seed=
                               a FIXED random ``ceil(frac*n)`` nodes run
                               ``ceil(rate * (q-1))`` local steps every
                               round; payloads always arrive
    slow_uplink:frac=,k_scale=,seed=
                               a fixed random subset ships
                               ``k_scale * topk`` wire entries a chunk
                               (needs an engine with per-node wire k)
    payload_drop:p=,seed=      every node's payload lost with probability
                               ``p`` each round; full compute

Randomness is the topology programs' counter hash (streams 11-13), keyed
by ``node_key`` in ``FLState.comm``.
"""

from __future__ import annotations

import abc
import math
from typing import Any, ClassVar, Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.core.dynamics import _as_key, _f32, _parse_value, _u01
from repro_torch.device import resolve_device

__all__ = [
    "NodeProgram",
    "HomogeneousProgram",
    "StragglerProgram",
    "SlowNodesProgram",
    "SlowUplinkProgram",
    "PayloadDropProgram",
    "HOMOGENEOUS",
    "compose_node_gate",
    "register_node_program",
    "get_node_program",
    "node_program_names",
    "parse_node_program",
    "resolve_node_program",
]


def compose_node_gate(w_off_r: torch.Tensor, w_diag_r: torch.Tensor,
                      up: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fold a per-node payload gate ``up (n,) {0, 1}`` into a round's
    mixing matrix: an edge needs BOTH endpoints' payloads, and the dropped
    weight refolds into the self-loops, so a symmetric doubly stochastic
    ``w_off_r + diag(w_diag_r)`` stays so. Composes with the topology gate
    in either order."""
    w_off = w_off_r * (up[:, None] * up[None, :])
    return w_off, 1.0 - w_off.sum(dim=1)


class NodeProgram(abc.ABC):
    """Per-round per-node compute/communication fault program.

    Construct with knobs (or :func:`parse_node_program` a spec); an engine
    ``bind(n_nodes, device)``s it at build time; then :meth:`step_gate`
    and :meth:`wire_gate` are per-round functions of the round counter
    and ``node_key``, on the device."""

    #: registry key; first token of the spec string
    name: ClassVar[str] = "abstract"
    #: True only for :class:`HomogeneousProgram` -- engines keep their
    #: lockstep round (no node_key, no step mask)
    is_static: ClassVar[bool] = False
    #: False when every node always runs all q-1 local steps (the round
    #: then runs unmasked)
    heterogeneous_compute: ClassVar[bool] = True
    #: True when :meth:`wire_k_gate` modulates per-node top-k; engines
    #: without a per-node k refuse such programs when they build a round
    heterogeneous_wire_k: ClassVar[bool] = False

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._n: int = 0
        self._device: Optional[torch.device] = None

    @property
    def bound(self) -> bool:
        return self._n > 0

    def bind(self, n_nodes: int, device=None) -> "NodeProgram":
        """Bind to ``n_nodes`` on ``device`` (``cuda`` unless given);
        binding again to another node count raises."""
        n_nodes = int(n_nodes)
        if n_nodes < 1:
            raise ValueError(f"n_nodes={n_nodes} must be >= 1")
        if self._n and self._n != n_nodes:
            raise ValueError(
                f"node program {self.spec()!r} is already bound to "
                f"{self._n} nodes; build a fresh instance"
            )
        self._n = n_nodes
        self._device = resolve_device(device)
        self._idx = torch.arange(n_nodes, dtype=torch.int64, device=self._device)
        self._bind_aux()
        return self

    def _bind_aux(self) -> None:
        """Subclass hook: precompute static auxiliaries from n_nodes."""

    def _require_bound(self) -> None:
        if not self._n:
            raise ValueError(
                f"node program {self.spec()!r} is unbound; engines bind "
                "it at build time (program.bind(n_nodes, device))"
            )

    @property
    def n_nodes(self) -> int:
        self._require_bound()
        return self._n

    def _ones(self, *shape) -> torch.Tensor:
        return torch.ones(shape, dtype=torch.float32, device=self._device)

    # -- the per-round contract ---------------------------------------------

    def step_gate(self, r, base_key, q: int) -> torch.Tensor:
        """``(max(q - 1, 1), n)`` fp32 {0, 1} mask over the round's local
        steps (row i gates step i for every node). The comm step's own
        update is never masked."""
        self._require_bound()
        return self._ones(max(int(q) - 1, 1), self._n)

    def wire_gate(self, r, base_key) -> torch.Tensor:
        """``(n,)`` fp32 {0, 1}: 1 where the node's payload lands."""
        self._require_bound()
        return self._ones(self._n)

    def wire_k_gate(self, r, base_key) -> torch.Tensor:
        """``(n,)`` fp32 fraction of the base top-k each node ships this
        round; read only when ``heterogeneous_wire_k`` is True."""
        self._require_bound()
        return self._ones(self._n)

    def expected_uptime(self) -> float:
        """Stationary payload-arrival probability in [0, 1] (feeds
        ``schedules.robust_alpha_scale``)."""
        return 1.0

    def init_key(self) -> np.ndarray:
        """The program's base key, carried in ``FLState.comm`` as
        ``node_key``."""
        s = int(self.seed) ^ 0x5EED
        return np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32)

    def _uniform(self, r, base_key, stream: int) -> torch.Tensor:
        return _u01(_as_key(base_key, self._device), r, self._idx, stream)

    # -- spec round trip ----------------------------------------------------

    def params(self) -> Dict[str, Any]:
        return {"seed": self.seed}

    def spec(self) -> str:
        """Canonical ``name:k=v,...`` string; floats at repr precision, so
        ``parse_node_program(spec()).spec() == spec()``."""
        p = self.params()
        if not p:
            return self.name
        return self.name + ":" + ",".join(
            f"{k}={v!r}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(p.items())
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"<NodeProgram {self.spec()}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_NODE_PROGRAMS: Dict[str, Type[NodeProgram]] = {}


def register_node_program(cls: Type[NodeProgram]) -> Type[NodeProgram]:
    if cls.name in _NODE_PROGRAMS:
        raise ValueError(f"duplicate node program name {cls.name!r}")
    _NODE_PROGRAMS[cls.name] = cls
    return cls


def get_node_program(name: str) -> Type[NodeProgram]:
    try:
        return _NODE_PROGRAMS[name]
    except KeyError:
        raise ValueError(
            f"unknown node program {name!r}; registered: "
            f"{node_program_names()}"
        ) from None


def node_program_names() -> Tuple[str, ...]:
    return tuple(sorted(_NODE_PROGRAMS))


def parse_node_program(spec: str) -> NodeProgram:
    """Build a node program from a ``name[:k=v,...]`` spec string."""
    name, _, rest = spec.partition(":")
    cls = get_node_program(name.strip())
    kwargs = {}
    if rest.strip():
        for item in rest.split(","):
            k, eq, v = item.partition("=")
            if not eq:
                raise ValueError(
                    f"bad node program knob {item!r} in {spec!r}; use k=v"
                )
            kwargs[k.strip()] = _parse_value(v.strip())
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise ValueError(f"bad knobs for node program {name!r}: {e}") from None


def resolve_node_program(
    program: Union[None, str, NodeProgram]
) -> NodeProgram:
    """Spec string, instance, or None (the homogeneous default -- a fresh
    instance, since instances bind to one node count)."""
    if program is None:
        return HomogeneousProgram()
    if isinstance(program, NodeProgram):
        return program
    return parse_node_program(program)


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


@register_node_program
class HomogeneousProgram(NodeProgram):
    """The lockstep default: every node runs every local step and every
    payload arrives."""

    name = "homogeneous"
    is_static = True
    heterogeneous_compute = False

    def __init__(self):
        super().__init__(seed=0)

    def bind(self, n_nodes: int, device=None) -> "NodeProgram":
        # no per-binding state: the shared HOMOGENEOUS sentinel may
        # default any number of engines over different node counts
        self._n = 0
        return super().bind(n_nodes, device)

    def params(self) -> Dict[str, Any]:
        return {}


#: shared unbound sentinel for "no heterogeneity" default arguments
HOMOGENEOUS = HomogeneousProgram()


def _slow_steps(rate: float, q: int) -> int:
    """Local steps a slow node completes out of ``q - 1``."""
    return min(max(int(math.ceil(rate * (q - 1))), 0), max(q - 1, 0))


def _runs_mask(slow: torch.Tensor, rate: float, q: int) -> torch.Tensor:
    """``(max(q-1, 1), n)`` step mask: a slow node runs the FIRST
    ``_slow_steps`` iterations, then idles; the others run them all."""
    steps = max(int(q) - 1, 1)
    runs = torch.where(slow > 0.5, float(_slow_steps(rate, int(q))), float(steps))
    i = torch.arange(steps, dtype=torch.float32, device=slow.device)[:, None]
    return (i < runs[None, :]).to(torch.float32)


def _fixed_subset(n: int, frac: float, seed: int) -> np.ndarray:
    """The ``ceil(frac * n)`` nodes drawn once from the seed, as a (n,)
    fp32 {0, 1} mask."""
    rng = np.random.default_rng(seed)
    mask = np.zeros((n,), np.float32)
    mask[rng.permutation(n)[:int(math.ceil(frac * n))]] = 1.0
    return mask


@register_node_program
class StragglerProgram(NodeProgram):
    """Transient stragglers: each round, each node is slow with
    probability ``frac``. A slow node completes ``ceil(rate * (q-1))`` of
    the round's local steps and, with ``drop=1`` (the default), its
    payload misses the round."""

    name = "stragglers"

    def __init__(self, frac: float = 0.25, rate: float = 0.5,
                 drop: int = 1, seed: int = 0):
        super().__init__(seed=seed)
        self.frac = float(frac)
        self.rate = float(rate)
        self.drop = int(bool(drop))
        if not (0.0 <= self.frac <= 1.0):
            raise ValueError(f"straggler fraction frac={frac} not in [0, 1]")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"straggler compute rate={rate} not in [0, 1]")

    def _slow(self, r, base_key) -> torch.Tensor:
        u = self._uniform(r, base_key, stream=11)
        return (u < _f32(self.frac)).to(torch.float32)  # 1 = slow

    def step_gate(self, r, base_key, q):
        self._require_bound()
        return _runs_mask(self._slow(r, base_key), self.rate, q)

    def wire_gate(self, r, base_key):
        self._require_bound()
        if not self.drop:
            return self._ones(self._n)
        return 1.0 - self._slow(r, base_key)

    def expected_uptime(self) -> float:
        return 1.0 - self.frac if self.drop else 1.0

    def params(self) -> Dict[str, Any]:
        return {"drop": self.drop, "frac": self.frac, "rate": self.rate,
                "seed": self.seed}


@register_node_program
class SlowNodesProgram(NodeProgram):
    """Persistent compute heterogeneity: a FIXED random subset of
    ``ceil(frac * n)`` nodes (drawn from the seed at bind) completes
    ``ceil(rate * (q-1))`` local steps every round; payloads always
    arrive."""

    name = "slow_nodes"

    def __init__(self, frac: float = 0.25, rate: float = 0.5, seed: int = 0):
        super().__init__(seed=seed)
        self.frac = float(frac)
        self.rate = float(rate)
        if not (0.0 <= self.frac <= 1.0):
            raise ValueError(f"slow fraction frac={frac} not in [0, 1]")
        if not (0.0 <= self.rate <= 1.0):
            raise ValueError(f"slow compute rate={rate} not in [0, 1]")
        self._slow_mask: Optional[torch.Tensor] = None

    def _bind_aux(self) -> None:
        self._slow_mask = torch.as_tensor(
            _fixed_subset(self._n, self.frac, self.seed), device=self._device)

    def step_gate(self, r, base_key, q):
        self._require_bound()
        return _runs_mask(self._slow_mask, self.rate, q)

    def params(self) -> Dict[str, Any]:
        return {"frac": self.frac, "rate": self.rate, "seed": self.seed}


@register_node_program
class SlowUplinkProgram(NodeProgram):
    """Persistent communication heterogeneity: a fixed random subset of
    ``ceil(frac * n)`` nodes sits behind a slow uplink and ships only
    ``round(k_scale * topk)`` wire entries per chunk every round; compute
    and payload arrival are unaffected. Needs an engine with a per-node
    wire k."""

    name = "slow_uplink"
    heterogeneous_compute = False
    heterogeneous_wire_k = True

    def __init__(self, frac: float = 0.25, k_scale: float = 0.25,
                 seed: int = 0):
        super().__init__(seed=seed)
        self.frac = float(frac)
        self.k_scale = float(k_scale)
        if not (0.0 <= self.frac <= 1.0):
            raise ValueError(f"slow fraction frac={frac} not in [0, 1]")
        if not (0.0 < self.k_scale <= 1.0):
            raise ValueError(
                f"uplink k scale k_scale={k_scale} not in (0, 1]"
            )
        self._slow_mask: Optional[torch.Tensor] = None

    def _bind_aux(self) -> None:
        self._slow_mask = torch.as_tensor(
            _fixed_subset(self._n, self.frac, self.seed), device=self._device)

    def wire_k_gate(self, r, base_key):
        self._require_bound()
        return torch.where(self._slow_mask > 0.5, _f32(self.k_scale), 1.0)

    def params(self) -> Dict[str, Any]:
        return {"frac": self.frac, "k_scale": self.k_scale,
                "seed": self.seed}


@register_node_program
class PayloadDropProgram(NodeProgram):
    """Pure communication faults: every node's payload is lost with
    probability ``p`` each round; compute is unaffected."""

    name = "payload_drop"
    heterogeneous_compute = False

    def __init__(self, p: float = 0.1, seed: int = 0):
        super().__init__(seed=seed)
        self.p = float(p)
        if not (0.0 <= self.p < 1.0):
            raise ValueError(f"payload drop probability p={p} not in [0, 1)")

    def wire_gate(self, r, base_key):
        self._require_bound()
        u = self._uniform(r, base_key, stream=13)
        return (u >= _f32(self.p)).to(torch.float32)

    def expected_uptime(self) -> float:
        return 1.0 - self.p

    def params(self) -> Dict[str, Any]:
        return {"p": self.p, "seed": self.seed}
