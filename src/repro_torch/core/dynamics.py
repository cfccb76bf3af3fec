"""Topology dynamics: time-varying graphs as the round machinery's third
axis (counterpart of ``repro.core.dynamics``).

A :class:`TopologyProgram` maps a round counter and a key to the round's
mixing matrix

    W_r = mask_r (.) W_off + diag(1 - sum_j (mask_r (.) W_off)_ij)

a symmetric {0, 1} edge gate over the BASE matrix's off-diagonal support,
each dropped edge's weight folded back into its two endpoints'
self-loops, so every W_r is symmetric and doubly stochastic by
construction (Assumption 1 minus connectivity, which a churn round may
lack). A fully isolated node's row degenerates to ``e_i``: it self-loops
and keeps taking local steps.

The round counter and the key ride in ``FLState.comm`` (``topo_round``,
``topo_key``) as device tensors, so each round's weights are runtime
operands of the same round function -- the fused engine hands them to
its round kernels -- and no round reads them back to the host.

Registered programs (the ``--fl-topology-program`` spec strings; knobs
after a colon, comma-separated ``k=v``):

    static                     the constant W (the default; engines keep
                               their static round, with no counters)
    edge_failure:p=,seed=      every base edge independently down with
                               probability p, drawn anew each round
    node_churn:p_down=,mean_downtime=,seed=[,switch_groups=]
                               Markov node outages: each node carries an
                               up/down bit (``topo_up`` in
                               ``FLState.comm``); an up node fails with
                               the hazard that makes the stationary
                               downtime fraction ``p_down``, a down node
                               recovers with probability
                               ``1/mean_downtime``; a down node's edges
                               are all masked
    round_robin_subgraphs:n_groups=
                               the base edges split into ``n_groups``
                               groups; round r activates group r mod
                               n_groups
    rgg_rewire:radius=,jitter=,seed=
                               nodes at static random positions, jittered
                               each round; a base edge is up iff its
                               endpoints lie within ``radius``

Every program's randomness is a pure function of (its seed, the round
counter): the counter-based splitmix32 hash :func:`_u01`, bit-identical
to the reference's on every device. The hash is uint32 arithmetic; torch
has no uint32 arithmetic on every device, so it runs in int64 on values
in [0, 2^32), each 32 x 32-bit product split into 16-bit halves of the
constant (no product passes 2^49) and masked to 32 bits.
"""

from __future__ import annotations

import abc
from typing import Any, ClassVar, Dict, Optional, Tuple, Type, Union

import numpy as np
import torch

from repro_torch.core.topology import check_assumption1
from repro_torch.device import resolve_device

__all__ = [
    "TopologyProgram",
    "StaticProgram",
    "EdgeFailureProgram",
    "NodeChurnProgram",
    "RoundRobinSubgraphsProgram",
    "RGGRewireProgram",
    "STATIC",
    "register_program",
    "get_program",
    "program_names",
    "parse_program",
    "resolve_program",
    "validate_program",
]

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``x * c mod 2^32`` for int64 ``x`` in [0, 2^32) and a 32-bit
    constant ``c``: the constant split into 16-bit halves, so each partial
    product stays under 2^48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """splitmix32 finalizer: a uint32 -> uint32 bijection, on int64
    tensors holding values in [0, 2^32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    x = x ^ (x >> 16)
    return x


def _as_key(base_key, device=None) -> torch.Tensor:
    """A (2,) key as the int64 tensor the hash takes (a numpy uint32 key,
    as ``init_key`` returns, or a tensor already)."""
    if isinstance(base_key, torch.Tensor):
        return base_key.to(torch.int64) if device is None else base_key.to(
            device, torch.int64)
    key = np.asarray(base_key, np.uint32).astype(np.int64)
    return torch.as_tensor(key, device=device)


def _u01(base_key: torch.Tensor, r, idx: torch.Tensor, stream: int) -> torch.Tensor:
    """Counter-based uniform(0, 1) draw, a pure function of (the (2,) key,
    the round counter ``r``, the per-element counter ``idx`` and a per-use
    ``stream`` constant); 24-bit mantissa-exact, bitwise the reference's.
    ``r`` is an int or an integer tensor on the key's device; ``r`` is
    read as int32 and reinterpreted as uint32, as the reference does."""
    key = _as_key(base_key)
    r = torch.as_tensor(r, device=key.device).to(torch.int32).to(torch.int64) & _M32
    s = _mix32(key[0] ^ stream)
    t = _mix32(key[1] ^ r)
    h = _mix32(idx.to(torch.int64) ^ s ^ _mul32(t, 0x9E3779B9))
    return (h >> 8).to(torch.float32) * (1.0 / (1 << 24))


def _u01_np(base_key: np.ndarray, r: int, idx: np.ndarray,
            stream: int) -> np.ndarray:
    """Pure-numpy twin of :func:`_u01`, bit-identical by construction
    (init-time draws: the stationary Markov state)."""

    def mix(x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.uint32)
        x = x ^ (x >> np.uint32(16))
        x = x * np.uint32(0x7FEB352D)
        x = x ^ (x >> np.uint32(15))
        x = x * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
        return x

    with np.errstate(over="ignore"):  # uint32 wraparound is the point
        key = np.asarray(base_key, np.uint32)
        s = mix(key[0] ^ np.uint32(stream))
        t = mix(key[1] ^ np.asarray(np.int32(r)).astype(np.uint32))
        h = mix(np.asarray(idx, np.uint32) ^ s ^ (t * np.uint32(0x9E3779B9)))
        return (h >> np.uint32(8)).astype(np.float32) * np.float32(
            1.0 / (1 << 24)
        )


def _frac(count: torch.Tensor, total: int) -> torch.Tensor:
    """``count / total`` in fp32 as the reference's compiled round computes
    it: XLA rewrites a division by a constant into a product with its
    fp32 reciprocal, which can sit an ulp from the quotient."""
    return count * float(np.float32(1.0 / total))


def _f32(v: float) -> float:
    """A threshold rounded to fp32, as the reference compares it."""
    return float(np.float32(v))


class TopologyProgram(abc.ABC):
    """Per-round mixing-matrix program over a fixed BASE matrix's support.

    Construct with knobs (or :func:`parse_program` a spec), then an
    engine ``bind(w, device)``s it to its base W: bind validates the
    knobs against the graph, puts the static auxiliaries (edge
    partitions, node positions, counters) on the device, and checks
    Assumption 1 on a sample of emitted rounds. After bind,
    :meth:`round_weights_state` is the per-round path the engines drive
    and :meth:`weights_np` the numpy view of the same computation.

    Subclasses implement :meth:`gate`: a symmetric ``(n, n)`` fp32
    {0, 1} mask for round ``r`` under ``base_key``, its randomness drawn
    with :func:`_u01`.
    """

    #: registry key; also the first token of the spec string
    name: ClassVar[str] = "abstract"
    #: True only for :class:`StaticProgram` -- engines keep their static
    #: round (no comm counters, no per-round weights)
    is_static: ClassVar[bool] = False

    def __init__(self, seed: int = 0):
        self.seed = int(seed)
        self._w: Optional[np.ndarray] = None
        self._w_off32: Optional[torch.Tensor] = None
        self._base_nnz: int = 0
        self._device: Optional[torch.device] = None

    # -- binding -----------------------------------------------------------

    @property
    def bound(self) -> bool:
        return self._w is not None

    @property
    def device(self) -> torch.device:
        self._require_bound()
        return self._device

    def bind(self, w: np.ndarray, device=None) -> "TopologyProgram":
        """Bind to the base mixing matrix on ``device`` (``cuda`` unless
        given). Binding again to the same matrix moves the program to the
        new device; binding to a DIFFERENT matrix raises (one program
        instance, one graph). Validates Assumption 1 on a sample of
        emitted rounds."""
        w = np.asarray(w, dtype=np.float64)
        n = w.shape[0]
        if w.shape != (n, n):
            raise ValueError(f"base W must be square, got {w.shape}")
        dev = resolve_device(device)
        if self._w is not None:
            if not (self._w.shape == w.shape and np.allclose(self._w, w)):
                raise ValueError(
                    f"program {self.spec()!r} is already bound to a different "
                    f"{self._w.shape} matrix; build a fresh instance"
                )
            if dev == self._device:
                return self
        self._w = w
        self._device = dev
        off = w - np.diag(np.diag(w))
        self._w_off32 = torch.as_tensor(off.astype(np.float32), device=dev)
        self._base_nnz = int((np.abs(off) > 0).sum())
        self._bind_aux(w)
        if not self.is_static:
            validate_program(self, w)
        return self

    def _bind_aux(self, w: np.ndarray) -> None:
        """Subclass hook: precompute static auxiliaries from the base W on
        ``self._device``."""

    def _require_bound(self) -> None:
        if self._w is None:
            raise ValueError(
                f"program {self.spec()!r} is unbound; engines bind it to "
                "their base W at build time (program.bind(w, device))"
            )

    @property
    def n_nodes(self) -> int:
        self._require_bound()
        return self._w.shape[0]

    @property
    def base_edges(self) -> int:
        """Directed edge count of the base off-diagonal support."""
        self._require_bound()
        return self._base_nnz

    def _key(self, base_key) -> torch.Tensor:
        return _as_key(base_key, self._device)

    # -- the per-round contract --------------------------------------------

    @abc.abstractmethod
    def gate(self, r, base_key) -> torch.Tensor:
        """Symmetric (n, n) fp32 {0, 1} edge mask for round ``r``."""

    def round_weights(self, r, base_key) -> Tuple[torch.Tensor, torch.Tensor]:
        """The round's mixing matrix as ``(w_off_r (n, n), w_diag_r
        (n,))``, dropped-edge weight folded into the diagonal."""
        self._require_bound()
        w_off_r = self._w_off32 * self.gate(r, base_key)
        return w_off_r, 1.0 - w_off_r.sum(dim=1)

    # -- optional per-round state (Markov programs) --------------------------

    def state_keys(self) -> Tuple[str, ...]:
        """Names of the program's per-round state buffers, carried in
        ``FLState.comm`` beside the counters. Empty for stateless
        programs."""
        return ()

    @property
    def stateful(self) -> bool:
        return bool(self.state_keys())

    def state_spec(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """``{key: (shape, dtype)}`` of :meth:`state_keys` (bound programs
        only) -- what the engines add to their comm-state contract."""
        return {}

    def init_state(self) -> Dict[str, np.ndarray]:
        """Round-0 state as numpy, a pure function of the seed."""
        return {}

    def gate_state(self, r, base_key, state: Dict[str, torch.Tensor]
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(gate, new_state) for round ``r``: the gate from the state
        ENTERING the round, and the state round ``r + 1`` will see.
        Stateless programs fall through to :meth:`gate`."""
        return self.gate(r, base_key), dict(state)

    def round_weights_state(self, r, base_key, state: Dict[str, torch.Tensor]):
        """Stateful twin of :meth:`round_weights`: ``(w_off_r, w_diag_r,
        new_state)`` -- the path every dynamic engine drives."""
        self._require_bound()
        g, new_state = self.gate_state(r, base_key, state)
        w_off_r = self._w_off32 * g
        return w_off_r, 1.0 - w_off_r.sum(dim=1), new_state

    def expected_uptime(self) -> float:
        """Stationary per-NODE availability equivalent in [0, 1]: the u
        with which an average edge is up with probability ~u**2 (feeds
        ``schedules.robust_alpha_scale``)."""
        return 1.0

    def init_key(self) -> np.ndarray:
        """The program's base key, carried in ``FLState.comm`` as
        ``topo_key``: the seed's two 32-bit words."""
        s = int(self.seed)
        return np.array([(s >> 32) & 0xFFFFFFFF, s & 0xFFFFFFFF], np.uint32)

    def weights_np(self, r: int) -> np.ndarray:
        """The dense W of round ``r`` as float64 numpy: the same
        computation the engines run (stateful programs replay their
        Markov state from round 0)."""
        self._require_bound()
        key = self._key(self.init_key())
        state = {k: torch.as_tensor(v, device=self._device)
                 for k, v in self.init_state().items()}
        for rr in range(int(r)):
            if not self.stateful:
                break
            _, _, state = self.round_weights_state(rr, key, state)
        w_off_r, w_diag_r, _ = self.round_weights_state(int(r), key, state)
        return (w_off_r.cpu().numpy().astype(np.float64)
                + np.diag(w_diag_r.cpu().numpy().astype(np.float64)))

    def edge_fraction(self, w_off_r: torch.Tensor) -> torch.Tensor:
        """Fraction of base edges active in this round's W (the
        ``edge_fraction`` metric), an fp32 tensor on the device."""
        self._require_bound()
        if self._base_nnz == 0:
            return torch.ones((), device=w_off_r.device)
        return _frac((w_off_r.abs() > 0).to(torch.float32).sum(), self._base_nnz)

    # -- spec round trip ----------------------------------------------------

    def params(self) -> Dict[str, Any]:
        """Knobs for the canonical spec string (subclasses extend)."""
        return {"seed": self.seed}

    def spec(self) -> str:
        """Canonical ``name:k=v,...`` string; ``parse_program(spec()).spec()
        == spec()``. Floats print at repr precision, so the spec rebuilds
        the identical graph sequence."""
        p = self.params()
        if not p:
            return self.name
        return self.name + ":" + ",".join(
            f"{k}={v!r}" if isinstance(v, float) else f"{k}={v}"
            for k, v in sorted(p.items())
        )

    def __repr__(self) -> str:  # pragma: no cover - debugging sugar
        return f"<TopologyProgram {self.spec()}>"


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_PROGRAMS: Dict[str, Type[TopologyProgram]] = {}


def register_program(cls: Type[TopologyProgram]) -> Type[TopologyProgram]:
    """Class decorator: make the program resolvable by name."""
    if cls.name in _PROGRAMS:
        raise ValueError(f"duplicate topology program name {cls.name!r}")
    _PROGRAMS[cls.name] = cls
    return cls


def get_program(name: str) -> Type[TopologyProgram]:
    try:
        return _PROGRAMS[name]
    except KeyError:
        raise ValueError(
            f"unknown topology program {name!r}; registered: "
            f"{program_names()}"
        ) from None


def program_names() -> Tuple[str, ...]:
    return tuple(sorted(_PROGRAMS))


def _parse_value(v: str):
    for cast in (int, float):
        try:
            return cast(v)
        except ValueError:
            continue
    return v


def parse_program(spec: str) -> TopologyProgram:
    """Build a program from a ``name[:k=v,...]`` spec string."""
    name, _, rest = spec.partition(":")
    cls = get_program(name.strip())
    kwargs = {}
    if rest.strip():
        for item in rest.split(","):
            k, eq, v = item.partition("=")
            if not eq:
                raise ValueError(
                    f"bad program knob {item!r} in {spec!r}; use k=v"
                )
            kwargs[k.strip()] = _parse_value(v.strip())
    try:
        return cls(**kwargs)
    except TypeError as e:
        raise ValueError(f"bad knobs for program {name!r}: {e}") from None


def resolve_program(
    program: Union[None, str, TopologyProgram]
) -> TopologyProgram:
    """A spec string, a TopologyProgram instance, or None (the static
    default -- a fresh instance each call, since instances bind to one
    base matrix)."""
    if program is None:
        return StaticProgram()
    if isinstance(program, TopologyProgram):
        return program
    return parse_program(program)


def validate_program(
    program: TopologyProgram, w: np.ndarray, rounds: int = 6
) -> None:
    """Assumption 1 on a sample of the rounds a bound program emits:
    every W_r symmetric and doubly stochastic (connectivity is not
    required per round), its active support within the base support."""
    base_support = np.abs(w - np.diag(np.diag(w))) > 0
    for r in range(rounds):
        w_r = program.weights_np(r)
        check_assumption1(w_r, atol=1e-6, require_connected=False)
        active = np.abs(w_r - np.diag(np.diag(w_r))) > 0
        if (active & ~base_support).any():
            raise AssertionError(
                f"program {program.spec()!r} emitted an edge outside the "
                f"base support at round {r}"
            )


# ---------------------------------------------------------------------------
# Programs
# ---------------------------------------------------------------------------


@register_program
class StaticProgram(TopologyProgram):
    """Every round is the base W. Engines detect ``is_static`` and keep
    their static round."""

    name = "static"
    is_static = True

    def __init__(self):
        super().__init__(seed=0)

    def bind(self, w: np.ndarray, device=None) -> "TopologyProgram":
        """Static has no per-graph state, so binding to another base W is
        allowed: the shared ``STATIC`` sentinel may default any number of
        engines."""
        self._w = None
        return super().bind(w, device)

    def gate(self, r, base_key):
        self._require_bound()
        n = self._w.shape[0]
        return torch.ones((n, n), dtype=torch.float32, device=self._device)

    def params(self) -> Dict[str, Any]:
        return {}


#: shared unbound sentinel for "no dynamics" default arguments
STATIC = StaticProgram()


def _sym_edge_index(n: int, device) -> torch.Tensor:
    """(n, n) counter that is SYMMETRIC (one counter per undirected pair),
    so both endpoints of an edge hash the same coin."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    lo = torch.minimum(i[:, None], i[None, :])
    hi = torch.maximum(i[:, None], i[None, :])
    return lo * n + hi


@register_program
class EdgeFailureProgram(TopologyProgram):
    """Every base edge independently fails (for one round) with
    probability ``p``, drawn anew each round -- flaky links."""

    name = "edge_failure"

    def __init__(self, p: float = 0.2, seed: int = 0):
        super().__init__(seed=seed)
        self.p = float(p)
        if not (0.0 <= self.p < 1.0):
            raise ValueError(f"edge failure probability p={p} not in [0, 1)")

    def _bind_aux(self, w: np.ndarray) -> None:
        self._edge_idx = _sym_edge_index(w.shape[0], self._device)

    def gate(self, r, base_key):
        self._require_bound()
        u = _u01(self._key(base_key), r, self._edge_idx, stream=1)
        return (u >= _f32(self.p)).to(torch.float32)

    def expected_uptime(self) -> float:
        # edge survival 1-p corresponds to per-node availability sqrt(1-p)
        return float(np.sqrt(1.0 - self.p))

    def params(self) -> Dict[str, Any]:
        return {"p": self.p, "seed": self.seed}


@register_program
class NodeChurnProgram(TopologyProgram):
    """Markov node outages with geometric durations: each node carries an
    up/down bit (``topo_up`` in ``FLState.comm``). Per round an up node
    fails with probability ``p_fail = p_down / ((1 - p_down) *
    mean_downtime)`` and a down node recovers with probability ``1 /
    mean_downtime``, so outages last ``mean_downtime`` rounds in
    expectation and the stationary downtime fraction is ``p_down``. The
    round-0 state is a stationary draw from the seed. A down node's edges
    are all masked: it self-loops with weight 1 and keeps taking local
    steps.

    The engines drive :meth:`gate_state` (O(1) a round, the state in the
    comm dict); the stateless :meth:`gate` replays the chain from round
    0 and serves as an oracle only.

    ``switch_groups > 0`` splits the nodes into that many contiguous
    racks, and the nodes of a rack share ONE recovery coin per round
    (stream 5): hospitals behind the same failed switch come back
    together. ``switch_groups=0`` keeps the independent chain."""

    name = "node_churn"

    def __init__(self, p_down: float = 0.2, mean_downtime: int = 5,
                 seed: int = 0, switch_groups: int = 0):
        super().__init__(seed=seed)
        self.p_down = float(p_down)
        self.mean_downtime = int(mean_downtime)
        self.switch_groups = int(switch_groups)
        if self.switch_groups < 0:
            raise ValueError(f"switch_groups={switch_groups} must be >= 0")
        if not (0.0 <= self.p_down < 1.0):
            raise ValueError(f"p_down={p_down} not in [0, 1)")
        if self.mean_downtime < 1:
            raise ValueError(f"mean_downtime={mean_downtime} must be >= 1")
        # the up->down hazard that makes p_down the stationary fraction
        self.p_fail = self.p_down / ((1.0 - self.p_down) * self.mean_downtime)
        self.p_recover = 1.0 / self.mean_downtime
        if self.p_fail > 1.0:
            raise ValueError(
                f"node_churn: p_down={p_down} with "
                f"mean_downtime={mean_downtime} needs an up->down hazard "
                f"{self.p_fail:.3f} > 1; increase mean_downtime or lower "
                "p_down (odds p_down/(1-p_down) must be <= mean_downtime)"
            )

    def _bind_aux(self, w: np.ndarray) -> None:
        n = w.shape[0]
        self._idx = torch.arange(n, dtype=torch.int64, device=self._device)
        self._group = self._idx * self.switch_groups // n

    # -- the Markov chain ----------------------------------------------------

    def state_keys(self) -> Tuple[str, ...]:
        return ("topo_up",)

    def state_spec(self):
        self._require_bound()
        return {"topo_up": ((self._w.shape[0],), torch.float32)}

    def init_state(self) -> Dict[str, np.ndarray]:
        self._require_bound()
        n = self._w.shape[0]
        # stationary draw on its own stream (stream 4; transitions use
        # stream 2), so round 0's transition coin is independent of it
        u0 = _u01_np(self.init_key(), 0, np.arange(n, dtype=np.uint32), stream=4)
        return {"topo_up": np.asarray(u0 >= self.p_down, np.float32)}

    def _step_up(self, up, r, key):
        u = _u01(key, r, self._idx, stream=2)
        # one recovery coin per contiguous rack (stream 5) with switches
        u_rec = _u01(key, r, self._group, stream=5) if self.switch_groups > 0 else u
        return torch.where(up > 0.5, u >= _f32(self.p_fail),
                           u_rec < _f32(self.p_recover)).to(torch.float32)

    def gate_state(self, r, base_key, state):
        upf = state["topo_up"]
        new_up = self._step_up(upf, r, self._key(base_key))
        return upf[:, None] * upf[None, :], {"topo_up": new_up}

    def gate(self, r, base_key):
        self._require_bound()
        key = self._key(base_key)
        upf = torch.as_tensor(self.init_state()["topo_up"], device=self._device)
        for i in range(int(r)):  # the replay: O(r), oracles only
            upf = self._step_up(upf, i, key)
        return upf[:, None] * upf[None, :]

    def expected_uptime(self) -> float:
        return 1.0 - self.p_down

    def params(self) -> Dict[str, Any]:
        out = {"p_down": self.p_down, "mean_downtime": self.mean_downtime,
               "seed": self.seed}
        if self.switch_groups:
            out["switch_groups"] = self.switch_groups
        return out


@register_program
class RoundRobinSubgraphsProgram(TopologyProgram):
    """Deterministic cycling subgraphs: the base (undirected) edges are
    dealt round-robin into ``n_groups`` groups; round r activates group
    ``r mod n_groups`` only. Any ``n_groups`` consecutive rounds cover
    the base graph, at 1/n_groups of the edges a round."""

    name = "round_robin_subgraphs"

    def __init__(self, n_groups: int = 2):
        super().__init__(seed=0)
        self.n_groups = int(n_groups)
        if self.n_groups < 1:
            raise ValueError(f"n_groups={n_groups} must be >= 1")
        self._masks: Optional[torch.Tensor] = None

    def _bind_aux(self, w: np.ndarray) -> None:
        n = w.shape[0]
        off = np.abs(w - np.diag(np.diag(w))) > 0
        edges = [(i, j) for i in range(n) for j in range(i + 1, n)
                 if off[i, j]]
        if len(edges) < self.n_groups:
            raise ValueError(
                f"round_robin_subgraphs: n_groups={self.n_groups} exceeds "
                f"the base graph's {len(edges)} edges"
            )
        masks = np.zeros((self.n_groups, n, n), np.float32)
        for e_idx, (i, j) in enumerate(edges):
            g = e_idx % self.n_groups
            masks[g, i, j] = masks[g, j, i] = 1.0
        self._masks = torch.as_tensor(masks, device=self._device)

    def gate(self, r, base_key):
        self._require_bound()
        r = torch.as_tensor(r, device=self._device).to(torch.int64)
        return torch.index_select(self._masks, 0, (r % self.n_groups).reshape(1))[0]

    def expected_uptime(self) -> float:
        return float(np.sqrt(1.0 / self.n_groups))

    def params(self) -> Dict[str, Any]:
        return {"n_groups": self.n_groups}


@register_program
class RGGRewireProgram(TopologyProgram):
    """Geometric link availability: nodes get static random positions in
    the unit square; each round every position jitters uniformly in
    ``[-jitter, jitter]^2`` and a base edge is up iff its endpoints lie
    within ``radius``. Failures are spatially correlated (a drifting node
    loses several links at once).

    ``radius=0`` (the default) calibrates at bind to the median base-edge
    distance, so about half the links are up in a typical round."""

    name = "rgg_rewire"

    def __init__(self, radius: float = 0.0, jitter: float = 0.1,
                 seed: int = 0):
        super().__init__(seed=seed)
        self.radius = float(radius)
        self.jitter = float(jitter)
        if self.radius < 0 or self.jitter < 0:
            raise ValueError("radius and jitter must be >= 0")
        self._pos0: Optional[torch.Tensor] = None
        self._radius_eff: float = self.radius

    def _bind_aux(self, w: np.ndarray) -> None:
        n = w.shape[0]
        rng = np.random.default_rng(self.seed)
        pos0 = rng.uniform(size=(n, 2))
        off = np.abs(w - np.diag(np.diag(w))) > 0
        ii, jj = np.nonzero(np.triu(off, k=1))
        if self.radius == 0.0:
            if len(ii) == 0:
                self._radius_eff = 1.0
            else:
                d = np.linalg.norm(pos0[ii] - pos0[jj], axis=1)
                self._radius_eff = float(np.median(d))
        self._pos0 = torch.as_tensor(pos0.astype(np.float32), device=self._device)
        self._idx = torch.arange(2 * n, dtype=torch.int64,
                                 device=self._device).reshape(n, 2)

    def gate(self, r, base_key):
        self._require_bound()
        u = _u01(self._key(base_key), r, self._idx, stream=3)
        pos = self._pos0 + _f32(self.jitter) * (2.0 * u - 1.0)
        diff = pos[:, None, :] - pos[None, :, :]
        d2 = (diff * diff).sum(dim=-1)
        r2 = np.float32(self._radius_eff) * np.float32(self._radius_eff)
        return (d2 <= float(r2)).to(torch.float32)

    def params(self) -> Dict[str, Any]:
        return {"jitter": self.jitter, "radius": self.radius,
                "seed": self.seed}
