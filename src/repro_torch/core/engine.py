"""GossipEngine protocol, the round schedules and the round engines
(counterpart of the single-device slice of ``repro.core.engine``).

An engine owns the state representation, the wire and the mixing:

    init_comm_state(cfg, params)  extra wire state carried in FLState.comm
    local_step(params, grads, a)  the SGD update in the engine's own
                                  state representation
    make_eval_grads(grad_fn)      per-node losses and gradients in that
                                  representation
    mix(buf)                      the exact-wire W application
    make_comm_step(...)           the whole communication step
    wire_bytes(cfg)               per-round egress accounting (all nodes)

A :class:`RoundSchedule` owns WHEN the mix consumes the payload: in the
round that produced it (``sequential``), one round later (``pipelined``),
or k rounds later (``bounded_staleness:k=K``). Engines and schedules
register by name (:func:`register_engine`, :func:`register_schedule`);
the registries are the one list of names every entry point resolves.

Four engines are ported:

* ``tree`` -- the state is the node-stacked parameter tree, mixed exactly
  (fp32, or a ``wire_dtype``) by the dense-W backend of ``core.mixing``:
  mix-then-adapt, the paper's Eqs. 2/3 (the Fig. 2 runs);
* ``flat`` -- the same exact wire on the packed ``(nodes, total)``
  buffer, one product per round;
* ``fused`` -- the packed buffer with the int8 difference-coded wire with
  error feedback, dense or top-k masked (``topk``), and every
  communication round ONE kernel call (``kernels.gossip``): the round
  megakernel (local update + quantize + W mix) on the sequential and
  pipelined schedules, the wire-stage kernel (local update + quantize)
  followed by a PyTorch mix against the k-round-stale reconstruction at
  depth k >= 2;
* ``sharded_fused`` -- the same wire with the node rows split over the
  ranks of a ``torch.distributed`` group (``launch.mesh``): each rank
  runs ONE wire-stage kernel per round on its rows (the compact exact-k
  top-k wire, ``kernels.gossip.wire_stage[_gt]_compact``, or the dense
  int8 one), all-gathers the wire buffers, and mixes against a running
  neighbor-reconstruction accumulator, on a dense W.

The exact-wire engines are sequential-only and refuse top-k and partial
federation scopes, as the reference's do.

Two more round axes make the graph change from round to round: the
engine's :class:`~repro_torch.core.dynamics.TopologyProgram` (links fail,
hospitals churn offline, subgraphs alternate, radio links rewire) and its
:class:`~repro_torch.core.heterogeneity.NodeProgram` (stragglers run
fewer local steps, payloads are dropped). A dynamic program adds the
counters ``topo_round``, ``topo_key`` (and ``topo_up``, ``node_key``) to
``FLState.comm``; each round's realized W_r is derived from them on the
device (:meth:`GossipEngine._round_gates`) and handed to the same round
kernels as a runtime operand, and stragglers sit out local steps as
masked updates. ``flat`` and ``fused`` run both axes; ``tree`` refuses
them, as the reference's does; ``sharded_fused`` refuses them as the part
not ported yet.

Everything else outside the ported slice -- privacy, federation scopes
on the fused engines, bf16 storage, the sharded engine's dynamic round,
circulant torus wire and two-axis layout -- raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar, Dict, Optional, Sequence, Tuple, Type

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.fl import (
    FLConfig,
    FLState,
    _consensus_error,
    _mean_grad_norm_sq,
    check_node_stacked,
    tree_map,
)
from repro_torch.core.dynamics import STATIC, TopologyProgram, _as_key, _frac, resolve_program
from repro_torch.core.heterogeneity import (
    HOMOGENEOUS,
    NodeProgram,
    compose_node_gate,
    resolve_node_program,
)
from repro_torch.core.mixing import _wire, make_dense_flat_mix, make_dense_gossip
from repro_torch.core.packing import (
    FlatLayout,
    bitmap_bytes_per_chunk,
    compact_index_bytes,
    compact_pos_dtype,
    flat_wire_bytes,
    pack,
    pack_like,
    tree_leaves,
    unpack,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.gossip.ops import (
    fused_round,
    fused_round_gt,
    wire_stage,
    wire_stage_compact,
    wire_stage_gt,
    wire_stage_gt_compact,
)
from repro_torch.kernels.gossip.ref import scatter_bitmap_dq, scatter_compact_dq
from repro_torch.launch.mesh import NodeGroup

__all__ = [
    "GossipEngine",
    "TreeEngine",
    "FlatEngine",
    "FusedEngine",
    "ShardedFusedEngine",
    "RoundSchedule",
    "SequentialSchedule",
    "PipelinedSchedule",
    "BoundedStalenessSchedule",
    "register_engine",
    "get_engine",
    "engine_names",
    "register_schedule",
    "get_schedule",
    "schedule_names",
    "resolve_schedule",
]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item {item})"
    )


def _as_device_batch(batches, device: torch.device) -> Dict[str, torch.Tensor]:
    """One host-to-device copy of a round's batches (numpy or tensors)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batches.items()}


# ---------------------------------------------------------------------------
# Round schedules: how a communication round is laid out in time
# ---------------------------------------------------------------------------


class RoundSchedule(abc.ABC):
    """How one communication round is laid out in time. The engine owns
    WHAT moves; the schedule owns WHEN the mix consumes it. An engine
    carries its schedule as ``engine.round_schedule``, fixed at
    construction (it is part of the comm-state contract), and
    ``make_fl_round`` delegates the round layout here."""

    name: ClassVar[str] = "abstract"
    #: staleness depth of the mixed neighbor information: 0 for the
    #: blocking sequential round, 1 for the pipelined round, k for
    #: :class:`BoundedStalenessSchedule`
    depth: int = 0

    @abc.abstractmethod
    def build_round(self, engine: "GossipEngine", eval_grads, schedule,
                    cfg: FLConfig, local_step):
        """Assemble ``round_fn(state, batches) -> (state, metrics)``."""

    def spec(self) -> str:
        """The round-trippable string form (``resolve_schedule(spec)``
        rebuilds an equivalent schedule)."""
        return self.name


_SCHEDULES: Dict[str, RoundSchedule] = {}


def register_schedule(cls: Type[RoundSchedule]) -> Type[RoundSchedule]:
    """Class decorator: make the schedule resolvable by name. Schedules
    are stateless, so the registry holds one instance of each."""
    if cls.name in _SCHEDULES:
        raise ValueError(f"duplicate schedule name {cls.name!r}")
    _SCHEDULES[cls.name] = cls()
    return cls


def get_schedule(name: str) -> RoundSchedule:
    try:
        return _SCHEDULES[name]
    except KeyError:
        raise ValueError(
            f"unknown round schedule {name!r}; registered: {schedule_names()}"
        ) from None


def schedule_names() -> Tuple[str, ...]:
    return tuple(sorted(_SCHEDULES))


def resolve_schedule(rs) -> RoundSchedule:
    """Accept a registry name, a parameterized spec string
    (``"bounded_staleness:k=4"``), a RoundSchedule instance, or None (the
    sequential default)."""
    if rs is None:
        return _SCHEDULES["sequential"]
    if isinstance(rs, RoundSchedule):
        return rs
    name, _, argstr = str(rs).partition(":")
    base = get_schedule(name)
    if not argstr:
        return base
    kwargs: Dict[str, int] = {}
    for item in argstr.split(","):
        k, sep, v = item.partition("=")
        if not sep:
            raise ValueError(
                f"bad schedule spec {rs!r}: expected name:key=value[,...]"
            )
        try:
            kwargs[k.strip()] = int(v)
        except ValueError:
            raise ValueError(
                f"bad schedule spec {rs!r}: {v!r} is not an integer"
            ) from None
    try:
        return type(base)(**kwargs)
    except TypeError:
        raise ValueError(
            f"schedule {name!r} takes no parameters {tuple(kwargs)!r}"
        ) from None


def _assemble_round(cfg: FLConfig, local_step, comm_call, engine, pre_scan=None,
                    step_mask=None):
    """The round body: the optional pre-scan hook (a schedule's ingest of
    the in-flight payload; the fused engine has none), (Q-1) local steps
    in a Python loop (the reference scans them), then
    ``comm_call(state, batch, aux)`` on the last batch with whatever the
    hook returned. ``local_loss`` is the mean over all nodes
    (``engine.global_mean``).

    ``step_mask(state) -> (q-1, n)`` is the heterogeneous-compute hook
    (:meth:`GossipEngine.make_step_mask`): a node masked in local step k
    sits it out as a masked update, and the round reports the realized
    local-step work, the masked steps plus the comm step's own update
    over ``q * n``, as ``compute_fraction``."""
    def round_fn(state: FLState, batches):
        aux = pre_scan(state) if pre_scan is not None else None
        batches = _as_device_batch(batches, engine.device)
        q = cfg.q
        mask = step_mask(state) if step_mask is not None else None
        local_losses = []
        for k in range(q - 1):
            state, loss = local_step(state, {n: b[k] for n, b in batches.items()},
                                     mask=None if mask is None else mask[k])
            local_losses.append(loss)
        state, metrics = comm_call(state, {n: b[q - 1] for n, b in batches.items()},
                                   aux)
        metrics["local_loss"] = (
            engine.global_mean(torch.stack(local_losses).mean()) if local_losses
            else metrics["loss"]
        )
        if mask is not None:
            metrics["compute_fraction"] = _frac(mask.sum() + cfg.n_nodes,
                                                cfg.q * cfg.n_nodes)
        return state, metrics

    return round_fn


@register_schedule
class SequentialSchedule(RoundSchedule):
    """The paper's round layout: (Q-1) local steps, then ONE comm step in
    which the payload is produced and mixed before the round returns."""

    name = "sequential"
    depth = 0

    def build_round(self, engine, eval_grads, schedule, cfg, local_step):
        comm_step = engine.make_comm_step(eval_grads, schedule, cfg)
        return _assemble_round(cfg, local_step,
                               lambda state, batch, aux: comm_step(state, batch),
                               engine, step_mask=engine.make_step_mask(cfg))


@register_schedule
class PipelinedSchedule(RoundSchedule):
    """Round r's payload is mixed one round late, so its transfer can
    overlap round r+1's local steps:

        sequential round r:   mixed_r = w_self*h_r + S_j W_ij recon_j^(r)
        pipelined  round r:   mixed_r = w_self*h_r + S_j W_ij recon_j^(r-1)

    i.e. sequential with a one-round delay. The fused engine runs it as
    the round kernel's ``stale_mix`` (the W contraction against the INPUT
    recon), with no extra state."""

    name = "pipelined"
    depth = 1

    def build_round(self, engine, eval_grads, schedule, cfg, local_step):
        ingest, comm_step = engine.make_pipelined_round(eval_grads, schedule, cfg)
        return _assemble_round(cfg, local_step, comm_step, engine,
                               pre_scan=ingest, step_mask=engine.make_step_mask(cfg))


@register_schedule
class BoundedStalenessSchedule(PipelinedSchedule):
    """Depth-k generalization of the pipelined round: k payloads ride in
    flight in ``FLState.comm`` (a ring of ``wire_q`` / ``wire_scales``),
    and the mix uses k-round-stale neighbor information:

        round r:   mixed_r = w_self*h_r + S_j W_ij recon_j^(r-k)

    ``k=1`` IS the pipelined schedule (bit-identical trajectories, same
    comm state); the round is built the same way at every depth."""

    name = "bounded_staleness"

    def __init__(self, k: int = 1):
        k = int(k)
        if k < 1:
            raise ValueError(f"bounded staleness depth k={k} must be >= 1")
        self.depth = k

    def spec(self) -> str:
        return f"{self.name}:k={self.depth}"


def _check_flat_params(cfg: FLConfig, params, name: str) -> None:
    """The flat engines' state: ONE node-stacked ``(nodes, total)``
    buffer."""
    check_node_stacked(cfg, params)
    if not isinstance(params, torch.Tensor) or params.ndim != 2:
        raise ValueError(
            f"the {name!r} engine state must be the packed (nodes, total) "
            "flat buffer (core.packing.pack)"
        )


def _make_flat_eval_grads(layout: FlatLayout, grad_fn):
    """The tree-level ``grad_fn`` on the flat buffer: the tree view
    exists only inside the call (``unpack`` gives views of the buffer's
    columns), and the gradient is packed back with zero padding."""

    def eval_grads(params: torch.Tensor, batch):
        losses, grads = grad_fn(unpack(params, layout), batch)
        return losses, pack_like(grads, layout)

    return eval_grads


class GossipEngine(abc.ABC):
    """One round engine: state representation + wire + mixing semantics.
    Subclasses set ``name`` (the registry key), ``layout`` (the
    :class:`FlatLayout` of flat-state engines, None for tree state) and
    ``device``, and either implement :meth:`mix` (exact-wire engines; the
    base :meth:`make_comm_step` then runs the paper's mix-then-adapt Eqs.
    2/3) or override :meth:`make_comm_step` (the fused engine).

    ``topology_program`` and ``node_program`` are the third and fourth
    round axes, fixed at construction like the schedule: a dynamic
    program adds its counters to the comm-state contract and turns the
    mixing weights into per-round operands of the same round function."""

    name: ClassVar[str] = "abstract"
    layout: Optional[FlatLayout] = None
    round_schedule: RoundSchedule = _SCHEDULES["sequential"]
    topology_program: TopologyProgram = STATIC
    node_program: NodeProgram = HOMOGENEOUS
    device: torch.device

    # -- dynamic-round contract (topology + node programs) -----------------

    @property
    def dynamic_topology(self) -> bool:
        return not self.topology_program.is_static

    @property
    def dynamic_nodes(self) -> bool:
        return not self.node_program.is_static

    @property
    def dynamic_round(self) -> bool:
        """True when ANY per-round operand exists (a dynamic graph or
        heterogeneous / faulty nodes)."""
        return self.dynamic_topology or self.dynamic_nodes

    def _bind_programs(self, w: np.ndarray, topology_program, node_program) -> None:
        """Resolve both programs and bind them to the base ``w`` on the
        engine's device (binding validates Assumption 1 on a sample of a
        dynamic program's rounds)."""
        self.topology_program = resolve_program(topology_program).bind(
            w, device=self.device)
        self.node_program = resolve_node_program(node_program)
        if self.dynamic_nodes:
            self.node_program.bind(w.shape[0], device=self.device)

    def _topo_keys(self) -> Tuple[str, ...]:
        """Comm keys the dynamic programs contribute: the round counter
        (the round the NEXT comm step mixes under), the topology
        program's key and Markov state, the node program's key."""
        keys: Tuple[str, ...] = ()
        if self.dynamic_round:
            keys += ("topo_round",)
        if self.dynamic_topology:
            keys += ("topo_key",) + self.topology_program.state_keys()
        if self.dynamic_nodes:
            keys += ("node_key",)
        return keys

    def _topo_spec(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Shapes and dtypes of the counters: the round an int32 scalar,
        each key the (2,) words of a uint32 key held in int64."""
        spec = {"topo_round": ((), torch.int32), "topo_key": ((2,), torch.int64),
                "node_key": ((2,), torch.int64)}
        spec.update(self.topology_program.state_spec())
        return spec

    def _topo_init(self) -> Dict[str, torch.Tensor]:
        init = {
            "topo_round": torch.zeros((), dtype=torch.int32, device=self.device),
            "topo_key": _as_key(self.topology_program.init_key(), self.device),
            "node_key": _as_key(self.node_program.init_key(), self.device),
        }
        init.update({k: torch.as_tensor(v, device=self.device)
                     for k, v in self.topology_program.init_state().items()})
        return init

    def _static_round_w(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The engine's constant ``(w_off, w_diag)`` on its device -- what
        :meth:`_round_gates` starts from when the topology is static but
        a node program gates payloads."""
        raise NotImplementedError(
            f"the {self.name!r} engine does not expose its static W; "
            "node programs are unsupported on this build"
        )

    def _round_gates(self, comm: Dict[str, torch.Tensor]):
        """ONE derivation of the round's realized mixing weights from both
        dynamic axes: the topology program's W_r (Markov churn advances
        its state here), then the node program's payload gate folded in
        by :func:`~repro_torch.core.heterogeneity.compose_node_gate`.
        Returns ``(w_off_r, w_diag_r, new_comm_entries, metrics)``, all on
        the device: the counter and state advance ride in the comm
        entries, the metrics report the realized ``edge_fraction`` /
        ``payload_fraction``. Nothing is read back to the host."""
        r = comm["topo_round"]
        new_comm: Dict[str, torch.Tensor] = {"topo_round": r + 1}
        metrics: Dict[str, torch.Tensor] = {}
        topo = self.topology_program
        if self.dynamic_topology:
            key = comm["topo_key"]
            tstate = {k: comm[k] for k in topo.state_keys()}
            w_off_r, w_diag_r, tnew = topo.round_weights_state(r, key, tstate)
            new_comm["topo_key"] = key
            new_comm.update(tnew)
            metrics["edge_fraction"] = topo.edge_fraction(w_off_r)
        else:
            w_off_r, w_diag_r = self._static_round_w()
        if self.dynamic_nodes:
            nkey = comm["node_key"]
            up = self.node_program.wire_gate(r, nkey)
            w_off_r, w_diag_r = compose_node_gate(w_off_r, w_diag_r, up)
            new_comm["node_key"] = nkey
            metrics["payload_fraction"] = _frac(up.sum(), up.shape[0])
        return w_off_r, w_diag_r, new_comm, metrics

    def make_step_mask(self, cfg: FLConfig):
        """The heterogeneous-compute hook for ``_assemble_round``: None
        for programs that never slow a node (the steps run unmasked),
        else ``step_mask(state) -> (q-1, n)`` from the round counter and
        node key in ``FLState.comm``. A program that changes the wire's
        k per node is refused: no engine of the port has a per-node k."""
        prog = self.node_program
        if prog.heterogeneous_wire_k:
            raise ValueError(
                f"node program {prog.spec()!r} modulates per-node wire k, "
                f"which the {self.name!r} engine does not support -- use "
                "engine='sharded_fused' (top-k wire with an EF residual)"
            )
        if not prog.heterogeneous_compute or cfg.q <= 1:
            return None

        def step_mask(state: FLState) -> torch.Tensor:
            return prog.step_gate(state.comm["topo_round"], state.comm["node_key"],
                                  cfg.q)

        return step_mask

    def mix_dynamic(self, buf, w_off_r: torch.Tensor, w_diag_r: torch.Tensor):
        """Exact-wire mixing against a per-round W (the flat engine's; the
        fused engine hands the per-round W to its kernels instead)."""
        raise NotImplementedError(
            f"the {self.name!r} engine does not support dynamic topology "
            "programs on this build"
        )

    # -- protocol ----------------------------------------------------------

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        """Names of the engine's wire-state buffers in ``FLState.comm``."""
        return self._topo_keys()

    def comm_state_spec(self, cfg: FLConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """``{key: (shape, dtype)}`` of the comm state: the counters'
        own, (n, total) fp32 for every wire buffer."""
        topo = self._topo_spec()
        return {k: topo[k] if k in topo else ((cfg.n_nodes, self.layout.total),
                                              torch.float32)
                for k in self.comm_keys(cfg)}

    def init_comm_state(self, cfg: FLConfig, params) -> Optional[Dict[str, torch.Tensor]]:
        """Zero-initialized wire state (:meth:`comm_state_spec`): zeros
        mean the first round effectively transmits the full parameters
        and the in-flight ring starts empty; a dynamic program's counter
        starts at round 0 with its key. None for a static exact wire."""
        spec = self.comm_state_spec(cfg)
        if not spec:
            return None
        comm = {k: torch.zeros(shape, dtype=dtype, device=self.device)
                for k, (shape, dtype) in spec.items()}
        comm.update({k: v for k, v in self._topo_init().items() if k in comm})
        return comm

    def local_step(self, params, grads, alpha, mask=None):
        """Eq. 4 in the engine's representation: ``p - alpha * g`` as two
        rounded fp32 operations (alpha an fp32 scalar). ``mask`` is the
        node program's (n,) compute gate for this step: a masked node's
        step size is zero, so it sits the step out."""
        a = torch.as_tensor(alpha, dtype=torch.float32)
        if mask is None:
            return tree_map(lambda p, g: p - a * g, params, grads)
        am = a * mask
        return tree_map(lambda p, g: p - am.reshape((-1,) + (1,) * (p.ndim - 1)) * g,
                        params, grads)

    def mix(self, buf):
        """Exact-wire W application (theta <- W theta) on the engine's
        state representation. The fused engine has no standalone mix: its
        W lives inside the comm-step kernel."""
        raise NotImplementedError(
            f"{type(self).__name__} mixes inside its fused comm step"
        )

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every node of a mean over this process's nodes:
        ``x`` itself unless the nodes are split over several processes."""
        return x

    def wire_bytes(self, cfg: FLConfig) -> Optional[float]:
        """Per-round egress summed over all nodes (None: the engine does
        not account it -- the exact wire, whose payload is the unpadded
        tree; see ``training.metrics.comm_bytes_per_gossip``)."""
        return None

    def check_params(self, cfg: FLConfig, params) -> None:
        """Validate the initial state representation: node-stacked."""
        check_node_stacked(cfg, params)

    def make_eval_grads(self, grad_fn):
        """Adapt the node-batched tree ``grad_fn`` (``core.fl.
        value_and_grad``) to the engine's representation: itself for tree
        state, through the layout for the flat buffer."""
        if self.layout is None:
            return grad_fn
        return _make_flat_eval_grads(self.layout, grad_fn)

    def params_view(self, params):
        """The tree view of the engine's parameter state."""
        return params if self.layout is None else unpack(params, self.layout)

    def make_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        """The exact-wire comm step: :meth:`mix` applies W, then the
        optimizer update at fp32 (mix-then-adapt, the paper's Eqs. 2/3).
        Under a dynamic program the round's W comes from the counters in
        ``FLState.comm`` (:meth:`_round_gates`) and is applied through
        :meth:`mix_dynamic`. ``comm_step(state, batch) -> (state,
        metrics)``."""
        wire = self.wire_bytes(cfg)
        dynamic = self.dynamic_round

        def comm_step(state: FLState, batch):
            step = state.step + 1
            alpha = schedule(step)
            a = torch.as_tensor(alpha, dtype=torch.float32)
            losses, grads = eval_grads(state.params, batch)
            gate_metrics: Dict[str, torch.Tensor] = {}
            if not dynamic:
                mix, comm = self.mix, state.comm
            else:
                w_off_r, w_diag_r, new_entries, gate_metrics = self._round_gates(
                    state.comm)
                comm = {**state.comm, **new_entries}

                def mix(buf):
                    return self.mix_dynamic(buf, w_off_r, w_diag_r)

            def adapt(wp, t):
                return wp - a * t

            if cfg.algorithm == "dsgd":
                params = tree_map(adapt, mix(state.params), grads)
                new_state = state._replace(step=step, params=params, comm=comm)
            else:
                tracker = tree_map(lambda wt, gn, gp: wt + gn - gp,
                                   mix(state.tracker), grads, state.prev_grad)
                params = tree_map(adapt, mix(state.params), tracker)
                new_state = state._replace(step=step, params=params,
                                           tracker=tracker, prev_grad=grads,
                                           comm=comm)
            metrics = {
                "loss": losses.mean(),
                "alpha": float(alpha),
                "grad_norm_sq": _mean_grad_norm_sq(grads),
                "consensus_err": _consensus_error(new_state.params),
                "comm_rounds": 1.0,
            }
            if wire is not None:
                metrics["wire_bytes"] = wire
            metrics.update(gate_metrics)
            return new_state, metrics

        return comm_step


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY: Dict[str, Type[GossipEngine]] = {}


def register_engine(cls: Type[GossipEngine]) -> Type[GossipEngine]:
    """Class decorator: make ``cls`` resolvable by ``get_engine(cls.name)``."""
    if cls.name in _REGISTRY:
        raise ValueError(f"duplicate engine name {cls.name!r}")
    _REGISTRY[cls.name] = cls
    return cls


def get_engine(name: str) -> Type[GossipEngine]:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown engine {name!r}; registered: {engine_names()}"
        ) from None


def engine_names() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# Refusals shared by the engines
# ---------------------------------------------------------------------------


def _refuse_unported(privacy, scope, storage_dtype) -> None:
    if privacy not in (None, "none"):
        raise _not_ported(f"privacy spec {privacy!r}", "12")
    if scope not in (None, "full"):
        raise _not_ported(f"federation scope {scope!r}", "13")
    if storage_dtype not in (None, "float32", torch.float32):
        raise _not_ported(f"{storage_dtype} flat storage", "5")


def _reject_dynamic_program(program, name: str, reason: str) -> TopologyProgram:
    """Resolve a topology-program spec and refuse non-static programs on
    builds that cannot take per-round weights, with the reference's
    message; returns the resolved static program otherwise."""
    prog = resolve_program(program)
    if not prog.is_static:
        raise ValueError(
            f"topology program {prog.spec()!r} needs traced per-round "
            f"mixing weights; the {name!r} {reason} -- use the 'fused' "
            "engine (any W) or 'sharded_fused' on the circulant wire"
        )
    return prog


def _reject_node_program(program, name: str, reason: str) -> NodeProgram:
    """Resolve a node-program spec and refuse non-homogeneous programs on
    builds that cannot take per-round gates, with the reference's
    message."""
    prog = resolve_node_program(program)
    if not prog.is_static:
        raise ValueError(
            f"node program {prog.spec()!r} needs traced per-round "
            f"compute/payload gates; the {name!r} {reason} -- use the "
            "'flat' (simulated), 'fused', or 'sharded_fused' engine"
        )
    return prog


def _refuse_exact_wire(name: str, topk, round_schedule, scope) -> None:
    """What the reference's exact-wire engines refuse, with its messages:
    the top-k wire, a schedule other than the blocking one, and a partial
    federation scope."""
    if topk is not None:
        raise ValueError(
            f"topk is a fused-engine knob (sub-int8 sparsified wire); the "
            f"{name!r} engine ships an exact wire -- use 'fused' or "
            "'sharded_fused'"
        )
    rs = resolve_schedule(round_schedule)
    if rs.name != "sequential":
        raise ValueError(
            f"round schedule {rs.name!r} needs the split produce/collective "
            f"comm step of the fused engines; the {name!r} engine is "
            "sequential-only -- use 'fused' or 'sharded_fused'"
        )
    if scope not in (None, "full"):
        raise ValueError(
            f"federation scope {scope!r}: the {name!r} engine ships the "
            "whole state through a baked exact-wire backend (no column "
            "slicing) -- use the 'fused' engine, or 'sharded_fused' for "
            "sub-range scopes on the mesh wire"
        )


# ---------------------------------------------------------------------------
# Exact-wire engines
# ---------------------------------------------------------------------------


@register_engine
class TreeEngine(GossipEngine):
    """Node-stacked tree state, mixed by a tree-level gossip backend
    (``core.mixing.make_dense_gossip``: the dense-W product)."""

    name = "tree"

    def __init__(self, gossip, device=None):
        self._gossip = gossip
        self.device = resolve_device(device)

    def mix(self, tree):
        return self._gossip(tree)

    @classmethod
    def simulated(cls, w: np.ndarray, stacked_params, *, wire_dtype=None,
                  topk=None, round_schedule=None, storage_dtype=None,
                  topology_program=None, node_program=None, privacy=None,
                  scope=None, **_ignored) -> Tuple["TreeEngine", object]:
        """Single-device build on the params' device: the dense-W backend;
        the state stays the input tree. Returns (engine, params)."""
        _refuse_exact_wire(cls.name, topk, round_schedule, scope)
        _refuse_unported(privacy, None, storage_dtype)
        reason = "engine bakes W into its tree-level gossip backend"
        _reject_dynamic_program(topology_program, cls.name, reason)
        _reject_node_program(node_program, cls.name, reason)
        leaf = tree_leaves(stacked_params)[0][1]
        return cls(make_dense_gossip(w, wire_dtype), device=leaf.device), stacked_params


@register_engine
class FlatEngine(GossipEngine):
    """The state is ONE packed ``(nodes, total)`` buffer end to end,
    mixed by a flat-native backend (``core.mixing.make_dense_flat_mix``:
    one product per round, whatever the number of leaves). Under a
    dynamic topology or node program the round's W is a per-round
    operand of the same product (:meth:`mix_dynamic`); that needs the
    dense base ``w``."""

    name = "flat"

    def __init__(self, mix_fn, layout: FlatLayout, device=None, *,
                 topology_program=None, node_program=None, wire_dtype=None,
                 w=None):
        self._mix = mix_fn
        self.layout = layout
        self.device = resolve_device(device)
        self._wire_dtype = wire_dtype
        dynamic = (not resolve_program(topology_program).is_static
                   or not resolve_node_program(node_program).is_static)
        if dynamic and w is None:
            raise ValueError(
                "a FlatEngine under a topology or node program needs the "
                "dense W (use FlatEngine.simulated, which passes it)"
            )
        if w is not None:
            self._bind_programs(np.asarray(w, dtype=np.float64), topology_program,
                                node_program)
            _, w_self, w_off = _split_w_np(w, np.asarray(w).shape[0])
            self._w_static = (torch.as_tensor(w_off, device=self.device),
                              torch.as_tensor(w_self, device=self.device))

    def _static_round_w(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._w_static

    def mix(self, flat: torch.Tensor) -> torch.Tensor:
        return self._mix(flat)

    def mix_dynamic(self, flat: torch.Tensor, w_off_r: torch.Tensor,
                    w_diag_r: torch.Tensor) -> torch.Tensor:
        """The dense flat mix against the per-round W: the same fp32
        product and wire dtype as ``make_dense_flat_mix``, with
        ``(w_off_r, w_diag_r)`` in place of the constant W -- one
        ``torch.matmul`` a round."""
        xf = flat.to(torch.float32)
        sent = _wire(xf, self._wire_dtype)
        return (w_off_r @ sent + w_diag_r[:, None] * xf).to(flat.dtype)

    def check_params(self, cfg: FLConfig, params) -> None:
        _check_flat_params(cfg, params, self.name)

    @classmethod
    def simulated(cls, w: np.ndarray, stacked_params, *, scale_chunk: int = 1,
                  wire_dtype=None, topk=None, round_schedule=None,
                  storage_dtype=None, topology_program=None, node_program=None,
                  privacy=None, scope=None,
                  **_ignored) -> Tuple["FlatEngine", torch.Tensor]:
        """Pack node-stacked params (padded to ``scale_chunk``) and build
        the engine on their device, the programs bound to ``w``. Returns
        (engine, flat buffer)."""
        _refuse_exact_wire(cls.name, topk, round_schedule, scope)
        _refuse_unported(privacy, None, storage_dtype)
        flat, layout = pack(stacked_params, pad_to=scale_chunk)
        return cls(make_dense_flat_mix(w, wire_dtype), layout, device=flat.device,
                   topology_program=topology_program, node_program=node_program,
                   wire_dtype=wire_dtype, w=w), flat


# ---------------------------------------------------------------------------
# The fused engine
# ---------------------------------------------------------------------------


def _split_w_np(w: np.ndarray, n: int):
    """Shape-checked (w, diag, off-diagonal): split in float64, then each
    part rounded once to fp32, as the reference does."""
    w = np.asarray(w, dtype=np.float64)
    if w.shape != (n, n):
        raise ValueError(f"W shape {w.shape} != ({n}, {n})")
    w_self = np.diag(w).astype(np.float32)
    w_off = (w - np.diag(np.diag(w))).astype(np.float32)
    return w, w_self, w_off


def _degrees(w: np.ndarray) -> np.ndarray:
    return (np.abs(w - np.diag(np.diag(w))) > 0).sum(axis=1)


def _dequant(q: torch.Tensor, scales: torch.Tensor, scale_chunk: int) -> torch.Tensor:
    """(n, t) int8 + (n, t // chunk) fp32 scales -> (n, t) fp32."""
    n, t = q.shape
    q3 = q.to(torch.float32).reshape(n, t // scale_chunk, scale_chunk)
    return (q3 * scales[:, :, None]).reshape(n, t)


@register_engine
class FusedEngine(GossipEngine):
    """The CHOCO int8 wire on a dense W, ONE kernel call per comm round:
    the round megakernel (local update + int8 quantize, top-k masked when
    ``topk`` is set, + W-row mix + error feedback; ``kernels.gossip.
    fused_round`` / ``fused_round_gt``) on the sequential and pipelined
    schedules, the wire-stage kernel (``wire_stage`` / ``wire_stage_gt``)
    plus a PyTorch mix at staleness depth k >= 2. On CPU tensors the
    kernel wrappers run their PyTorch twins. The wire is always
    difference-coded with error feedback (the kernels' defaults)."""

    name = "fused"

    def __init__(self, w: np.ndarray, layout: FlatLayout, *,
                 scale_chunk: int = 512, device=None, topk=None,
                 round_schedule=None, wire_dtype=None, topology_program=None,
                 node_program=None, privacy=None, scope=None,
                 storage_dtype=None):
        if wire_dtype is not None:
            raise ValueError(
                "the fused engines' wire is always difference-coded int8; "
                "wire_dtype only applies to the tree/flat exact-wire engines"
            )
        _refuse_unported(privacy, scope, storage_dtype)
        if scale_chunk < 1:
            raise ValueError("scale_chunk must be >= 1")
        if topk is not None and topk < 1:
            raise ValueError("topk must be >= 1 or None")
        if layout.total % scale_chunk:
            raise ValueError(
                f"layout.total {layout.total} not a multiple of scale_chunk "
                f"{scale_chunk}; pack with pad_to={scale_chunk}"
            )
        self.layout = layout
        self.scale_chunk = scale_chunk
        self.topk = topk
        self.round_schedule = resolve_schedule(round_schedule)
        self.device = resolve_device(device)
        self.w, w_self, w_off = _split_w_np(w, layout.n_nodes)
        self.w_self = torch.as_tensor(w_self, device=self.device)
        self.w_off = torch.as_tensor(w_off, device=self.device)
        self._bind_programs(self.w, topology_program, node_program)

    def _static_round_w(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.w_off, self.w_self

    @property
    def pipelined(self) -> bool:
        """True for every non-blocking schedule (depth >= 1)."""
        return self.round_schedule.depth >= 1

    @property
    def staleness_depth(self) -> int:
        return self.round_schedule.depth

    def _ring_depth(self) -> int:
        """In-flight ring slots for depth-k staleness. The recon buffer
        already lags the mix by one round (the ``k=1`` ``stale_mix``
        kernel needs no extra buffer), and with difference coding the
        k-round-stale reconstruction is ``recon^(r-1) - sum of the last
        k-1 payloads``, so the ring holds k-1."""
        k = self.staleness_depth
        return 0 if k <= 1 else k - 1

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        ring = ("wire_q", "wire_scales") if self._ring_depth() else ()
        keys = ("recon", "residual") + ring
        if cfg.algorithm == "dsgt":
            keys += ("recon_t", "residual_t") + tuple(k + "_t" for k in ring)
        return keys + self._topo_keys()

    def comm_state_spec(self, cfg: FLConfig):
        """Wire state: (n, total) fp32 recon / residual, and the ring of
        int8 payloads (n, ring, total) with their fp32 scales
        (n, ring, total // scale_chunk); then a dynamic program's
        counters."""
        n, t, rd = cfg.n_nodes, self.layout.total, self._ring_depth()
        topo = self._topo_spec()

        def spec(key):
            if key in topo:
                return topo[key]
            if key.startswith("wire_q"):
                return (n, rd, t), torch.int8
            if key.startswith("wire_scales"):
                return (n, rd, t // self.scale_chunk), torch.float32
            return (n, t), torch.float32

        return {k: spec(k) for k in self.comm_keys(cfg)}

    def wire_bytes(self, cfg: FLConfig) -> float:
        """One payload per wire and directed edge per round, at every
        staleness depth (the ring holds payloads, it never resends)."""
        wires = 2 if cfg.algorithm == "dsgt" else 1
        edge = flat_wire_bytes(self.layout, 1, self.scale_chunk, self.topk)
        return float(wires * _degrees(self.w).sum() * edge)

    def check_params(self, cfg: FLConfig, params) -> None:
        _check_flat_params(cfg, params, self.name)
        if tuple(params.shape) != (cfg.n_nodes, self.layout.total):
            raise ValueError(
                f"flat buffer {tuple(params.shape)} != "
                f"({cfg.n_nodes}, {self.layout.total})"
            )
        if params.dtype != torch.float32 or params.device != self.device:
            raise ValueError(
                f"flat buffer is {params.dtype} on {params.device}; the "
                f"engine runs float32 on {self.device}"
            )

    def _metrics(self, losses, alpha, grads, new_state: FLState, egress: float):
        res = new_state.comm["residual"]
        return {
            "loss": losses.mean(),
            "alpha": float(alpha),
            "grad_norm_sq": _mean_grad_norm_sq(grads),
            "consensus_err": _consensus_error(new_state.params),
            "comm_rounds": 1.0,
            "wire_bytes": egress,
            "ef_residual_rms": torch.sqrt((res * res).mean()),
        }

    def _round_w(self, comm):
        """The round's ``(w_off_r, w_self_r, counter entries, gate
        metrics)``: the constant W on a static round, else the realized
        W_r of :meth:`_round_gates` -- a runtime operand of the same
        kernels."""
        if not self.dynamic_round:
            return self.w_off, self.w_self, {}, {}
        return self._round_gates(comm)

    def make_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        if self._ring_depth():
            return self._make_bounded_comm_step(eval_grads, schedule, cfg)
        # pipelined: the kernel's stale_mix contracts W against the INPUT
        # recon -- the neighbor reconstruction as of the end of the
        # previous round -- so depth 1 needs no extra buffer
        kw = dict(scale_chunk=self.scale_chunk, topk=self.topk,
                  stale_mix=self.pipelined)
        egress = self.wire_bytes(cfg)

        def comm_step(state: FLState, batch):
            if state.comm is None:
                raise ValueError("fused rounds need init_fl_state(..., engine)")
            step = state.step + 1
            alpha = schedule(step)
            losses, grads = eval_grads(state.params, batch)
            c = state.comm
            w_off_r, w_self_r, topo_comm, gate_metrics = self._round_w(c)
            if cfg.algorithm == "dsgd":
                mixed, recon, res, _ = fused_round(
                    state.params, grads, c["recon"], c["residual"],
                    w_off_r, w_self_r, alpha, **kw,
                )
                new_state = state._replace(
                    step=step, params=mixed,
                    comm={"recon": recon, "residual": res, **topo_comm},
                )
            else:
                mx, mt, nrx, nsx, nrt, nst, _, _ = fused_round_gt(
                    state.params, state.tracker, grads, state.prev_grad,
                    c["recon"], c["residual"], c["recon_t"], c["residual_t"],
                    w_off_r, w_self_r, alpha, **kw,
                )
                new_state = FLState(
                    step=step, params=mx, tracker=mt, prev_grad=grads,
                    comm={"recon": nrx, "residual": nsx,
                          "recon_t": nrt, "residual_t": nst, **topo_comm},
                )
            metrics = self._metrics(losses, alpha, grads, new_state, egress)
            metrics.update(gate_metrics)
            return new_state, metrics

        return comm_step

    def _make_bounded_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        """The depth-k (k >= 2) round: ONE wire-stage kernel call, then the
        mix -- plain PyTorch, fp32, in the reference's order -- of the
        round's W (the realized W_r under a dynamic program) against the
        k-round-STALE reconstruction recovered from the in-flight ring
        (:meth:`_ring_depth`), and this round's payload pushed onto the
        ring (slot 0 is the oldest)."""
        chunk = self.scale_chunk
        kw = dict(scale_chunk=chunk, topk=self.topk)
        egress = self.wire_bytes(cfg)

        def stale_recon(recon, wq, wsc):
            mix = recon
            for j in range(wq.shape[1]):
                mix = mix - _dequant(wq[:, j], wsc[:, j], chunk)
            return mix

        def push(wq, wsc, q, sc):
            return (torch.cat([wq[:, 1:], q[:, None]], dim=1),
                    torch.cat([wsc[:, 1:], sc[:, None]], dim=1))

        def comm_step(state: FLState, batch):
            if state.comm is None:
                raise ValueError("fused rounds need init_fl_state(..., engine)")
            step = state.step + 1
            alpha = schedule(step)
            losses, grads = eval_grads(state.params, batch)
            c = state.comm
            w_off_r, w_self_r, topo_comm, gate_metrics = self._round_w(c)

            def mix(nbr, h):
                return w_off_r @ nbr + w_self_r[:, None] * h

            if cfg.algorithm == "dsgd":
                h, q, sc, nrecon, nres = wire_stage(
                    state.params, grads, c["recon"], c["residual"], alpha, **kw)
                mixed = mix(stale_recon(c["recon"], c["wire_q"], c["wire_scales"]), h)
                nwq, nwsc = push(c["wire_q"], c["wire_scales"], q, sc)
                new_state = state._replace(
                    step=step, params=mixed,
                    comm={"recon": nrecon, "residual": nres,
                          "wire_q": nwq, "wire_scales": nwsc, **topo_comm},
                )
            else:
                (h, t_half, qx, scx, nrx, nsx, qt, sct, nrt, nst) = wire_stage_gt(
                    state.params, state.tracker, grads, state.prev_grad,
                    c["recon"], c["residual"], c["recon_t"], c["residual_t"],
                    alpha, **kw,
                )
                mixed_x = mix(stale_recon(c["recon"], c["wire_q"], c["wire_scales"]), h)
                mixed_t = mix(stale_recon(c["recon_t"], c["wire_q_t"],
                                          c["wire_scales_t"]), t_half)
                nwq, nwsc = push(c["wire_q"], c["wire_scales"], qx, scx)
                nwqt, nwsct = push(c["wire_q_t"], c["wire_scales_t"], qt, sct)
                new_state = FLState(
                    step=step, params=mixed_x, tracker=mixed_t, prev_grad=grads,
                    comm={"recon": nrx, "residual": nsx,
                          "recon_t": nrt, "residual_t": nst,
                          "wire_q": nwq, "wire_scales": nwsc,
                          "wire_q_t": nwqt, "wire_scales_t": nwsct, **topo_comm},
                )
            metrics = self._metrics(losses, alpha, grads, new_state, egress)
            metrics.update(gate_metrics)
            return new_state, metrics

        return comm_step

    def make_pipelined_round(self, eval_grads, schedule, cfg: FLConfig):
        """The dense engine has no separate transfer (its 'wire' is the
        in-kernel W contraction), so the ingest hook is None and the comm
        step ignores its third argument."""
        if not self.pipelined:
            raise ValueError(
                "engine was built with round_schedule='sequential'; build "
                "it with round_schedule='pipelined'"
            )
        comm_step = self.make_comm_step(eval_grads, schedule, cfg)
        return None, lambda state, batch, stale: comm_step(state, batch)

    @classmethod
    def simulated(cls, w: np.ndarray, stacked_params, *, scale_chunk: int = 512,
                  **kw) -> Tuple["FusedEngine", torch.Tensor]:
        """Pack node-stacked params (padded to ``scale_chunk``) and build
        the engine on their device. Returns (engine, flat buffer)."""
        flat, layout = pack(stacked_params, pad_to=scale_chunk)
        return cls(w, layout, scale_chunk=scale_chunk, device=flat.device,
                   **kw), flat


# ---------------------------------------------------------------------------
# The sharded engine: node rows over the ranks of a process group
# ---------------------------------------------------------------------------

#: the all-gather of the installed torch (``all_gather_into_tensor`` was
#: renamed ``all_gather_single``; both take (output, input, group=))
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


@register_engine
class ShardedFusedEngine(GossipEngine):
    """The fused round with the node rows split over the ranks of a
    ``torch.distributed`` group (the reference's ``ShardedFusedEngine`` on
    its all-gather wire: an arbitrary dense W). Rank r holds the node rows
    ``[r * R, (r + 1) * R)`` of every (n, total) buffer. Per round, for
    each wire:

      1. the WIRE STAGE -- local update (DSGD) or tracker arithmetic and
         update (DSGT), difference coding, int8 quantize, error feedback
         -- is ONE kernel launch on the rank's rows (DSGT's two wires
         share it): ``wire_stage[_gt]_compact`` with exact-k top-k when
         ``topk`` is set and the compact encoding is smaller than the
         dense chunk, else ``wire_stage[_gt]`` (dense int8, top-k masked
         when ``topk`` is set);
      2. each wire buffer crosses in ONE ``all_gather`` over the group --
         (k int8 values, k positions or the presence bitmap, fp32 scales)
         on the compact wire, (int8 payload, scales) on the dense one --
         moved as its raw bytes (neither NCCL nor gloo has an int16
         type), so the bytes handed to the collectives are exactly
         ``flat_wire_bytes`` per node and wire;
      3. the receive side rebuilds every node's dense dq and the mix
         finishes against the running neighbor-reconstruction
         accumulator: ``mix_recon' = mix_recon + W_off[rows] @ dq_all``,
         ``mixed = w_self[rows] * h + mix_recon'`` -- equal, up to the
         summation order, to ``FusedEngine`` on the same W.

    Under the pipelined and bounded-staleness schedules the comm step
    stores this round's wire buffers in ``FLState.comm`` (``wire_q``,
    ``wire_pos`` or ``wire_bits``, ``wire_scales``, and ``_t`` twins;
    a ring of k at depth k >= 2), and the next round's ingest gathers the
    oldest before its local steps. Metrics are over all n nodes
    (all-reduced), so every world size reports the same numbers.

    ``collectives`` and ``collective_bytes`` count the wire's all-gathers
    and the bytes this rank hands them (the metrics' all-reduces are not
    wire traffic and do not count).
    """

    name = "sharded_fused"

    def __init__(self, group: NodeGroup, layout: FlatLayout, *, w=None,
                 scale_chunk: int = 512, topk=None, compact=None,
                 round_schedule=None, error_feedback: bool = True,
                 difference_coding: bool = True, wire_dtype=None,
                 model_axis=None, topology_program=None, node_program=None,
                 privacy=None, scope=None, storage_dtype=None):
        if wire_dtype is not None:
            raise ValueError(
                "the fused engines' wire is always difference-coded int8; "
                "wire_dtype only applies to the tree/flat exact-wire engines"
            )
        if w is None:
            raise _not_ported("the circulant torus ppermute wire (w=None)", "15")
        if model_axis is not None:
            raise _not_ported(
                f"the two-axis (node, model_shard) layout (model_axis={model_axis!r})",
                "15")
        if not resolve_program(topology_program).is_static:
            raise _not_ported(
                f"topology program {topology_program!r} on the sharded engine "
                "(the sharded half of the dynamic round)", "10")
        if not resolve_node_program(node_program).is_static:
            raise _not_ported(
                f"node program {node_program!r} on the sharded engine (the "
                "sharded half of the dynamic round)", "11")
        _refuse_unported(privacy, scope, storage_dtype)
        if not (error_feedback and difference_coding):
            raise _not_ported(
                "the sharded engine without difference coding or error feedback",
                "9")
        if scale_chunk < 1 or layout.total % scale_chunk:
            raise ValueError(
                f"layout.total {layout.total} not a multiple of scale_chunk "
                f"{scale_chunk}; pack with pad_to={scale_chunk}"
            )
        if topk is not None and topk < 1:
            raise ValueError("topk must be >= 1 or None")
        self.layout = layout
        self.scale_chunk = scale_chunk
        self.topk = topk
        self.round_schedule = resolve_schedule(round_schedule)
        self.group = group
        self.device = group.device
        self.n_nodes = layout.n_nodes
        self.rows = group.rows(self.n_nodes)
        # unpack / eval on this rank's rows only
        self.local_layout = dataclasses.replace(layout, n_nodes=len(self.rows))
        # The compact wire is the wire only where it is SMALLER than the
        # dense int8 chunk; compact=None takes it exactly there, and an
        # explicitly requested uneconomic one is refused (the accounting
        # would report bytes the collective does not move).
        economic = self._compact_is_economic()
        if compact is None:
            compact = economic
        if compact:
            if topk is None or not 1 <= topk < scale_chunk:
                raise ValueError(
                    "the compact wire needs a sparsified payload: set "
                    f"1 <= topk < scale_chunk (got topk={topk}, "
                    f"scale_chunk={scale_chunk}) or pass compact=False"
                )
            if not economic:
                raise ValueError(
                    f"compact encoding of topk={topk} costs more than the dense "
                    f"int8 chunk ({topk} values + "
                    f"{compact_index_bytes(scale_chunk, topk)} index bytes > "
                    f"{scale_chunk} columns); ship the dense wire "
                    "(compact=False) or lower topk"
                )
        self.compact_wire = bool(compact)
        # the index encoding that crosses: the cheaper of explicit
        # positions and the presence bitmap (compact_index_bytes' boundary)
        self.wire_encoding = "dense"
        if self.compact_wire:
            pos_b = topk * torch.iinfo(compact_pos_dtype(scale_chunk)).bits // 8
            bb = bitmap_bytes_per_chunk(scale_chunk)
            self.wire_encoding = "bitmap" if bb is not None and bb < pos_b else "positions"
        self.w, w_self, w_off = _split_w_np(w, self.n_nodes)
        rows = slice(self.rows.start, self.rows.stop)
        self.w_self = torch.as_tensor(w_self[rows], device=self.device)
        self.w_off = torch.as_tensor(w_off[rows], device=self.device)
        self.collectives = 0
        self.collective_bytes = 0

    @property
    def pipelined(self) -> bool:
        return self.round_schedule.depth >= 1

    @property
    def staleness_depth(self) -> int:
        return self.round_schedule.depth

    def _compact_is_economic(self) -> bool:
        """True when k values + the cheaper index encoding fit in the
        dense int8 chunk (``packing.compact_index_bytes``)."""
        if self.topk is None:
            return False
        return self.topk + compact_index_bytes(self.scale_chunk, self.topk) <= self.scale_chunk

    # -- comm-state contract ----------------------------------------------

    def _wire_key_names(self, suffix: str = "") -> Tuple[str, ...]:
        """One wire's in-flight payload buffers (pipelined only): exactly
        what crosses the collective."""
        if not self.compact_wire:
            names = ("wire_q", "wire_scales")
        elif self.wire_encoding == "bitmap":
            names = ("wire_q", "wire_bits", "wire_scales")
        else:
            names = ("wire_q", "wire_pos", "wire_scales")
        return tuple(n + suffix for n in names)

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        keys = ("recon", "residual", "mix_recon")
        if self.pipelined:
            keys += self._wire_key_names("")
        if cfg.algorithm == "dsgt":
            keys += ("recon_t", "residual_t", "mix_recon_t")
            if self.pipelined:
                keys += self._wire_key_names("_t")
        return keys

    def comm_state_spec(self, cfg: FLConfig):
        """This rank's wire state: (R, total) fp32 recon / residual /
        mix_recon, and the in-flight wire buffers, (R, width) at depth 1
        and a (R, k, width) ring at depth k >= 2."""
        r, t = len(self.rows), self.layout.total
        c, depth = t // self.scale_chunk, self.staleness_depth

        def ring(width, dtype):
            return ((r, width) if depth <= 1 else (r, depth, width)), dtype

        def spec(key):
            if key.startswith("wire_q"):
                return ring(c * self.topk if self.compact_wire else t, torch.int8)
            if key.startswith("wire_pos"):
                return ring(c * self.topk, compact_pos_dtype(self.scale_chunk))
            if key.startswith("wire_bits"):
                return ring(c * (self.scale_chunk // 8), torch.uint8)
            if key.startswith("wire_scales"):
                return ring(c, torch.float32)
            return (r, t), torch.float32

        return {k: spec(k) for k in self.comm_keys(cfg)}

    def dense_equivalent(self) -> np.ndarray:
        """The dense W this engine realizes (the ``FusedEngine`` oracle)."""
        return self.w

    def _edge_bytes(self) -> int:
        """What one neighbor payload costs on this wire: the compact
        encoding, or the dense int8 bytes."""
        return flat_wire_bytes(self.layout, 1, self.scale_chunk,
                               self.topk if self.compact_wire else None)

    def wire_bytes(self, cfg: FLConfig) -> float:
        wires = 2 if cfg.algorithm == "dsgt" else 1
        return float(wires * _degrees(self.w).sum() * self._edge_bytes())

    def check_params(self, cfg: FLConfig, params) -> None:
        if cfg.n_nodes != self.n_nodes:
            raise ValueError(f"cfg.n_nodes {cfg.n_nodes} != the engine's {self.n_nodes} nodes")
        want = (len(self.rows), self.layout.total)
        if not isinstance(params, torch.Tensor) or tuple(params.shape) != want:
            raise ValueError(
                f"the sharded engine's state is this rank's rows of the packed "
                f"buffer, {want} (from_group returns them)"
            )
        if params.dtype != torch.float32 or params.device != self.device:
            raise ValueError(
                f"flat buffer is {params.dtype} on {params.device}; the "
                f"engine runs float32 on {self.device}"
            )

    def make_eval_grads(self, grad_fn):
        """The tree-level ``grad_fn`` on this rank's rows: each round's
        batches carry all n nodes, and the rank evaluates its own."""
        inner = _make_flat_eval_grads(self.local_layout, grad_fn)
        rows = slice(self.rows.start, self.rows.stop)

        def eval_grads(params: torch.Tensor, batch):
            return inner(params, {k: v[rows] for k, v in batch.items()})

        return eval_grads

    def params_view(self, params):
        return unpack(params, self.local_layout)

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, group=self.group.pg)
        return x / self.group.world

    # -- the wire ------------------------------------------------------------

    def _produce(self, x, g, recon, res, alpha):
        """DSGD: ONE wire-stage launch. Returns (h, wire buffers in
        ``_wire_key_names`` order, recon', res')."""
        kw = dict(scale_chunk=self.scale_chunk, topk=self.topk)
        if self.compact_wire:
            h, q, idx, sc, nrecon, nres = wire_stage_compact(
                x, g, recon, res, alpha, bitmap=self.wire_encoding == "bitmap", **kw)
            return h, (q, idx, sc), nrecon, nres
        h, q, sc, nrecon, nres = wire_stage(x, g, recon, res, alpha, **kw)
        return h, (q, sc), nrecon, nres

    def _produce_gt(self, x, t, g, gp, rx, sx, rt, st, alpha):
        """DSGT: ONE wire-stage launch for both wires. Returns (h, t_half,
        wire_x, recon_x', res_x', wire_t, recon_t', res_t')."""
        kw = dict(scale_chunk=self.scale_chunk, topk=self.topk)
        if self.compact_wire:
            (h, th, qx, ix, scx, nrx, nsx, qt, it, sct, nrt, nst) = wire_stage_gt_compact(
                x, t, g, gp, rx, sx, rt, st, alpha,
                bitmap=self.wire_encoding == "bitmap", **kw)
            return h, th, (qx, ix, scx), nrx, nsx, (qt, it, sct), nrt, nst
        (h, th, qx, scx, nrx, nsx, qt, sct, nrt, nst) = wire_stage_gt(
            x, t, g, gp, rx, sx, rt, st, alpha, **kw)
        return h, th, (qx, scx), nrx, nsx, (qt, sct), nrt, nst

    def _all_gather(self, buf: torch.Tensor) -> torch.Tensor:
        """ONE all-gather of a (R, w) wire buffer into (n, w), moved as its
        raw bytes."""
        raw = buf.contiguous().view(torch.uint8)
        out = torch.empty((self.n_nodes, raw.shape[1]), dtype=torch.uint8,
                          device=raw.device)
        _ALL_GATHER(out, raw, group=self.group.pg)
        self.collectives += 1
        self.collective_bytes += raw.numel()
        return out.view(buf.dtype)

    def _dq_full(self, wire: Sequence[torch.Tensor]) -> torch.Tensor:
        """Dense dequant of one wire's payload buffers at any row count;
        the dense width comes from the scales buffer."""
        t = wire[-1].shape[-1] * self.scale_chunk
        if not self.compact_wire:
            q, scales = wire
            return _dequant(q, scales, self.scale_chunk)
        if self.wire_encoding == "bitmap":
            return scatter_bitmap_dq(*wire, self.scale_chunk, t)
        return scatter_compact_dq(*wire, self.scale_chunk, t)

    def _wire_mix(self, wire: Sequence[torch.Tensor]) -> torch.Tensor:
        """Move one wire's buffers over the group (one all-gather each)
        and return ``W_off[rows] @ dq`` for this rank's rows."""
        return self.w_off @ self._dq_full([self._all_gather(b) for b in wire])

    def _ring_slot0(self, comm, keys):
        """The oldest in-flight payload's buffers."""
        if self.staleness_depth <= 1:
            return [comm[k] for k in keys]
        return [comm[k][:, 0] for k in keys]

    def _push_wire(self, old_comm, comm, keys, vals) -> None:
        """Store this round's payload: replace at depth 1, ring push (drop
        slot 0, append at the end) at depth >= 2."""
        if self.staleness_depth <= 1:
            comm.update(zip(keys, vals))
            return
        for k, v in zip(keys, vals):
            comm[k] = torch.cat([old_comm[k][:, 1:], v[:, None]], dim=1)

    # -- the round -----------------------------------------------------------

    def _metrics(self, losses, alpha, grads, new_state: FLState, egress: float):
        """The reference's metrics over all n nodes: one all-reduce of the
        sums, one of the squared deviations from the consensus mean."""
        n, t = self.n_nodes, self.layout.total
        params, res = new_state.params, new_state.comm["residual"]
        sums = torch.cat([losses.sum()[None], (res * res).sum()[None],
                          grads.sum(dim=0), params.sum(dim=0)])
        dist.all_reduce(sums, group=self.group.pg)
        mean_g, mean_p = sums[2:2 + t] / n, sums[2 + t:] / n
        dev = params - mean_p
        sq = (dev * dev).sum()
        dist.all_reduce(sq, group=self.group.pg)
        return {
            "loss": sums[0] / n,
            "alpha": float(alpha),
            "grad_norm_sq": (mean_g * mean_g).sum(),
            "consensus_err": sq / n,
            "comm_rounds": 1.0,
            "wire_bytes": egress,
            "ef_residual_rms": torch.sqrt(sums[1] / (n * t)),
        }

    def _check_cfg(self, cfg: FLConfig) -> None:
        if cfg.n_nodes != self.n_nodes:
            raise ValueError(f"cfg.n_nodes {cfg.n_nodes} != the engine's {self.n_nodes} nodes")

    def _comm_body(self, eval_grads, schedule, cfg: FLConfig, state: FLState, batch,
                   mix_add):
        """The comm step's shared body: this round's gradient, ONE
        wire-stage launch, then the mix against ``mix_recon`` plus
        ``mix_add(wire, wire_t)`` -- this round's gathered payload
        (sequential) or the ingested stale one (pipelined). Returns
        (state, metrics, wire, wire_t)."""
        if state.comm is None:
            raise ValueError("fused rounds need init_fl_state(..., engine)")
        step = state.step + 1
        alpha = schedule(step)
        losses, grads = eval_grads(state.params, batch)
        c = state.comm
        if cfg.algorithm == "dsgd":
            h, wire, nrecon, nres = self._produce(
                state.params, grads, c["recon"], c["residual"], alpha)
            new_mix = c["mix_recon"] + mix_add(wire, None)[0]
            new_state = state._replace(
                step=step, params=self.w_self[:, None] * h + new_mix,
                comm={"recon": nrecon, "residual": nres, "mix_recon": new_mix})
            wire_t = None
        else:
            (h, th, wire, nrx, nsx, wire_t, nrt, nst) = self._produce_gt(
                state.params, state.tracker, grads, state.prev_grad, c["recon"],
                c["residual"], c["recon_t"], c["residual_t"], alpha)
            add_x, add_t = mix_add(wire, wire_t)
            new_mrx, new_mrt = c["mix_recon"] + add_x, c["mix_recon_t"] + add_t
            new_state = FLState(
                step=step, params=self.w_self[:, None] * h + new_mrx,
                tracker=self.w_self[:, None] * th + new_mrt, prev_grad=grads,
                comm={"recon": nrx, "residual": nsx, "mix_recon": new_mrx,
                      "recon_t": nrt, "residual_t": nst, "mix_recon_t": new_mrt})
        return new_state, (losses, alpha, grads), wire, wire_t

    def make_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        """The sequential round: produce, gather, mix in the same step."""
        self._check_cfg(cfg)
        egress = self.wire_bytes(cfg)

        def gathered(wire, wire_t):
            return (self._wire_mix(wire),
                    None if wire_t is None else self._wire_mix(wire_t))

        def comm_step(state: FLState, batch):
            new_state, m, _, _ = self._comm_body(eval_grads, schedule, cfg, state,
                                                 batch, gathered)
            return new_state, self._metrics(*m, new_state, egress)

        return comm_step

    def make_pipelined_round(self, eval_grads, schedule, cfg: FLConfig):
        """The split round: ``ingest`` gathers the OLDEST in-flight payload
        (nothing it reads depends on this round's compute, so it runs
        before the local steps) and returns its neighbor term;
        ``comm_step`` produces this round's payload (stored for a later
        round), folds the ingested term into ``mix_recon`` and mixes --
        k-round-stale neighbor information."""
        if not self.pipelined:
            raise ValueError(
                "engine was built with round_schedule='sequential'; build "
                "it with round_schedule='pipelined'"
            )
        self._check_cfg(cfg)
        egress = self.wire_bytes(cfg)
        keys, keys_t = self._wire_key_names(""), self._wire_key_names("_t")

        def ingest(state: FLState):
            if state.comm is None or keys[0] not in state.comm:
                raise ValueError(
                    "pipelined rounds need init_fl_state(..., engine=...) "
                    "with the pipelined engine (in-flight wire buffers)"
                )
            stale = {"mix": self._wire_mix(self._ring_slot0(state.comm, keys))}
            if cfg.algorithm == "dsgt":
                stale["mix_t"] = self._wire_mix(self._ring_slot0(state.comm, keys_t))
            return stale

        def comm_step(state: FLState, batch, stale):
            new_state, m, wire, wire_t = self._comm_body(
                eval_grads, schedule, cfg, state, batch,
                lambda wire, wire_t: (stale["mix"], stale.get("mix_t")))
            comm = dict(new_state.comm)
            self._push_wire(state.comm, comm, keys, wire)
            if wire_t is not None:
                self._push_wire(state.comm, comm, keys_t, wire_t)
            new_state = new_state._replace(comm=comm)
            return new_state, self._metrics(*m, new_state, egress)

        return ingest, comm_step

    @classmethod
    def simulated(cls, w, stacked_params, **_ignored):
        raise ValueError(
            "sharded_fused needs a process group (use from_group); on a single "
            "process use the 'fused' engine -- identical math, dense W"
        )

    @classmethod
    def from_group(cls, group: NodeGroup, stacked_params, *, scale_chunk: int = 512,
                   **kw) -> Tuple["ShardedFusedEngine", torch.Tensor]:
        """Pack the node-stacked params (all n nodes, padded to
        ``scale_chunk``) and build the engine for this rank of ``group``.
        Returns (engine, this rank's rows of the flat buffer on the
        group's device) -- the state ``init_fl_state`` takes."""
        flat, layout = pack(stacked_params, pad_to=scale_chunk)
        engine = cls(group, layout, scale_chunk=scale_chunk, **kw)
        rows = flat[engine.rows.start:engine.rows.stop]
        return engine, rows.to(group.device, torch.float32).contiguous()
