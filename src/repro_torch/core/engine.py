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
  ranks of a ``torch.distributed`` group (``launch.mesh``), and each row
  optionally tiled over S model shards (the two-axis layout): each rank
  runs ONE wire-stage kernel per round on its tile (the compact exact-k
  top-k wire, ``kernels.gossip.wire_stage[_gt]_compact``, or the dense
  int8 one), moves the wire buffers -- one point-to-point exchange per
  direction of the circulant torus over the group's node axes (the
  default), or one all-gather for a dense W -- and mixes against a
  running neighbor-reconstruction accumulator; under a program, against
  unweighted per-direction (or all-node) reconstructions weighted by the
  round's W_r.

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
masked updates. ``flat``, ``fused`` and ``sharded_fused`` run both axes
(``sharded_fused`` also ``slow_uplink``'s per-node wire k); ``tree``
refuses them, as the reference's does. ``tree`` and ``flat`` also build
on a group's node torus (``from_group``: the mesh backends of
``core.mixing``), and ``fused`` on the torus's dense equivalent
(``from_node_axes``).

The fifth axis is the engine's :class:`~repro_torch.core.privacy.
PrivacySpec`: ``dp`` clips and noises the wire payload in the wire
stage's quantize epilogue (the kernel wrappers' residual substitution:
still one launch a round) on ``fused`` and ``sharded_fused``, drawn from
``priv_key`` and ``topo_round`` in ``FLState.comm``, and reports
``dp_epsilon``; ``secure_agg`` masks every per-edge payload of
``sharded_fused``'s circulant wire and is a no-op on ``fused`` and
``flat`` (no per-edge payload), and ``tree``, ``flat`` and
``sharded_fused`` refuse what the reference's refuse.

The sixth axis is the engine's :class:`~repro_torch.core.scope.
FederationScope`: which columns of the flat buffer federate. On ``fused``
and ``sharded_fused`` a sub-range scope (``backbone``, ``ranges``)
gathers the shared columns into a contiguous wire buffer, runs the
unchanged kernels on it and scatters the mixed result back around the
private columns, which follow the plain local update bit-untouched by
the wire; every wire buffer, the DP noise and the wire bytes shrink to
the scoped width (``wire_layout``). ``layerwise`` keeps the full wire and
selects the local update on its head columns except every freq-th round
(``fused`` only); ``tree`` and ``flat`` refuse partial scopes, as the
reference's do.

Checkpoint restores go through :meth:`GossipEngine.restore_comm`, which
refuses unknown comm keys and rebuilds the derived ones (the sharded
engine's neighbor accumulators, from the restored ``recon``).

Storage: the flat buffer of ``flat``, ``fused`` and ``sharded_fused``
may be stored in bf16 (``storage_dtype``, recorded in the layout), and
the DSGT tracker and ``prev_grad`` share it. The arithmetic stays fp32:
every local step and exact-wire update upcasts, computes and rounds once
back to the storage dtype; the fused engines upcast the buffers at the
kernel boundary and round the mixed outputs back (``_st``), so the int8
wire, the error-feedback recon/residual and the mix accumulation are the
fp32 computation of the rounded buffer, and the kernels stay fp32 (a
kernel wrapper handed a bf16 buffer raises). ``tree`` refuses it, as the
reference's does.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import ClassVar, Dict, List, Optional, Sequence, Tuple, Type

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
from repro_torch.core.mixing import (
    TorusPlan,
    _wire,
    all_gather_rows,
    make_dense_flat_mix,
    make_dense_gossip,
    make_mesh_flat_mix,
    make_mesh_gossip,
    mesh_gossip_dense_equivalent,
)
from repro_torch.core.privacy import (
    NOISE_STREAM,
    PAD_STREAM,
    TRACKER_STREAM_OFFSET,
    PrivacySpec,
    dp_noise,
    epsilon_traced,
    mask_wire,
    resolve_privacy,
)
from repro_torch.core.privacy import NONE as PRIVACY_NONE
from repro_torch.core.packing import (
    FlatLayout,
    as_dtype,
    bitmap_bytes_per_chunk,
    compact_index_bytes,
    compact_pos_dtype,
    flat_wire_bytes,
    flat_wire_bytes_per_shard,
    pack,
    pack_like,
    scoped_layout,
    tree_leaves,
    unpack,
)
from repro_torch.core.scope import FULL as SCOPE_FULL
from repro_torch.core.scope import FederationScope, LayerwiseScope, resolve_scope
from repro_torch.device import resolve_device
from repro_torch.kernels.gossip.ops import (
    fused_round,
    fused_round_gt,
    wire_stage,
    wire_stage_compact,
    wire_stage_gt,
    wire_stage_gt_compact,
)
from repro_torch.kernels.gossip.ref import (
    compact_to_bitmap,
    scatter_bitmap_dq,
    scatter_compact_dq,
)
from repro_torch.launch.mesh import NodeGroup
from repro_torch.models.sharding import is_split, shard_params, spec_dict, stacked_param_specs

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
    #: the fifth round axis: clip and Gaussian noise on the wire payload
    #: (``dp``) and the pairwise pads (``secure_agg``); the engines with
    #: the error-feedback wire realize DP, and secure_agg is a no-op on
    #: every wire of the port (none carries a per-edge payload)
    privacy: PrivacySpec = PRIVACY_NONE
    #: the sixth round axis: which columns federate. The fused engines
    #: realize it (``_bind_scope``); the exact-wire engines carry FULL,
    #: so a checkpoint manifest records every engine's scope
    scope: FederationScope = SCOPE_FULL
    #: True for the engine that can give each node its own wire k
    #: (``slow_uplink``); the others refuse such a node program
    supports_wire_k: ClassVar[bool] = False
    device: torch.device
    #: the process group of an engine built across ranks (``from_group``):
    #: its state is this rank's rows; None in a single process
    group: Optional[NodeGroup] = None
    #: a sub-range scope's wire layout and shared column ranges (per
    #: shard tile: the ranges themselves on a single-axis layout), and the
    #: layerwise scope's (1, total) head-column mask (``_bind_scope``)
    _scoped: bool = False
    _wire_layout: Optional[FlatLayout] = None
    _ranges: Tuple[Tuple[int, int], ...] = ()
    _gate_mask: Optional[torch.Tensor] = None

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

    @property
    def _priv_rng(self) -> bool:
        """True when the engine draws privacy randomness at round time (DP
        noise): it then carries ``priv_key`` and the shared ``topo_round``
        counter in ``FLState.comm``."""
        return self.privacy.dp

    @property
    def _scope_round(self) -> bool:
        """True when the scope gates the mix on the round counter
        (``layerwise``): the engine then carries ``topo_round`` in
        ``FLState.comm`` on a static round too, so a restore replays the
        same gate phase."""
        return self.scope.needs_round

    def _topo_keys(self) -> Tuple[str, ...]:
        """Comm keys the dynamic programs, the privacy axis and a gating
        scope contribute: the round counter (the round the NEXT comm step
        mixes under), the topology program's key and Markov state, the
        node program's key, the privacy key."""
        keys: Tuple[str, ...] = ()
        if self.dynamic_round or self._priv_rng or self._scope_round:
            keys += ("topo_round",)
        if self.dynamic_topology:
            keys += ("topo_key",) + self.topology_program.state_keys()
        if self.dynamic_nodes:
            keys += ("node_key",)
        if self._priv_rng:
            keys += ("priv_key",)
        return keys

    def _topo_spec(self) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """Shapes and dtypes of the counters: the round an int32 scalar,
        each key the (2,) words of a uint32 key held in int64."""
        spec = {"topo_round": ((), torch.int32), "topo_key": ((2,), torch.int64),
                "node_key": ((2,), torch.int64), "priv_key": ((2,), torch.int64)}
        spec.update(self.topology_program.state_spec())
        return spec

    def _topo_init(self) -> Dict[str, torch.Tensor]:
        init = {
            "topo_round": torch.zeros((), dtype=torch.int32, device=self.device),
            "topo_key": _as_key(self.topology_program.init_key(), self.device),
            "node_key": _as_key(self.node_program.init_key(), self.device),
            "priv_key": _as_key(self.privacy.init_key(), self.device),
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
        if self._priv_rng:
            new_comm["priv_key"] = comm["priv_key"]
        return w_off_r, w_diag_r, new_comm, metrics

    def _priv_comm(self, comm: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The advanced privacy and scope counter entries of a STATIC
        round (a dynamic round advances ``topo_round`` in
        :meth:`_round_gates`, which passes ``priv_key`` through)."""
        if self.dynamic_round or not (self._priv_rng or self._scope_round):
            return {}
        out = {"topo_round": comm["topo_round"] + 1}
        if self._priv_rng:
            out["priv_key"] = comm["priv_key"]
        return out

    # -- scope hooks (the fused engines' wire) -------------------------------

    def _bind_scope(self, scope) -> None:
        """Resolve the scope against ``layout`` once, at build: a
        sub-range scope (``backbone``, ``ranges``) gets its wire layout
        (``packing.scoped_layout``, the shared width padded to the scale
        chunk) and shared ranges; ``layerwise`` keeps the full wire and
        gets the mask of its head columns."""
        self.scope = resolve_scope(scope)
        self._scoped = not self.scope.is_full and not self.scope.needs_round
        if self._scoped:
            self._wire_layout, self._ranges = scoped_layout(
                self.layout, self.scope.shared_ranges(self.layout), self.scale_chunk)
        elif isinstance(self.scope, LayerwiseScope):
            gate = torch.zeros((1, self.layout.total), dtype=torch.bool, device=self.device)
            for a, b in self.scope.gate_ranges(self.layout):
                gate[:, a:b] = True
            self._gate_mask = gate

    @property
    def wire_layout(self) -> Optional[FlatLayout]:
        """The layout the WIRE runs at: ``layout`` itself under the full
        and layerwise scopes, the gathered shared columns' layout under a
        sub-range scope. The comm-state widths, the wire bytes and the DP
        noise all derive from it."""
        return self.layout if self._wire_layout is None else self._wire_layout

    def _scope_shards(self, width: int) -> int:
        """How many shard tiles a buffer of trailing ``width`` spans: the
        scoped ranges are per shard, so a full-width row repeats them
        across the layout's shards and one tile (the two-axis engine's
        rank) carries one copy."""
        return 1 if width == self.layout.shard_width else self.layout.shards

    def _gather_cols(self, x: torch.Tensor) -> torch.Tensor:
        """The shared columns of a row block (full width or one shard
        tile), contiguous, each shard's slice zero-padded to the chunk
        multiple (the padding behaves as the layout's own: zero forever,
        no wire mass). ``x`` itself without a sub-range scope."""
        if not self._scoped:
            return x
        sw = self.layout.shard_width
        pad = self._wire_layout.shard_width - sum(b - a for a, b in self._ranges)
        segs = []
        for s in range(self._scope_shards(x.shape[-1])):
            segs.extend(x[..., s * sw + a:s * sw + b] for a, b in self._ranges)
            if pad:
                segs.append(x.new_zeros(x.shape[:-1] + (pad,)))
        return torch.cat(segs, dim=-1)

    def _scatter_cols(self, local_full: torch.Tensor,
                      mixed_scoped: torch.Tensor) -> torch.Tensor:
        """The mixed shared columns put back among the private ones: slices
        and one ``torch.cat``, so the private columns come bit-untouched
        from ``local_full`` (each shard's wire padding is dropped)."""
        sw, pw = self.layout.shard_width, self._wire_layout.shard_width
        segs = []
        for s in range(self._scope_shards(local_full.shape[-1])):
            base, pos, at = s * sw, s * sw, s * pw
            for a, b in self._ranges:
                if base + a > pos:
                    segs.append(local_full[..., pos:base + a])
                segs.append(mixed_scoped[..., at:at + (b - a)])
                at += b - a
                pos = base + b
            if pos < base + sw:
                segs.append(local_full[..., pos:base + sw])
        return torch.cat(segs, dim=-1)

    def _scope_finish(self, mixed_s: torch.Tensor, x: torch.Tensor, g: torch.Tensor,
                      alpha, fire=None) -> torch.Tensor:
        """DSGD round epilogue under a scope: the full-width params from
        the kernel's mixed output. A sub-range scope scatters the mix
        around the private columns' plain local update ``x - alpha g``
        (the local step's arithmetic); ``layerwise`` selects the local
        update on the head columns when the round does not fire (an exact
        ``torch.where``, so a non-firing round leaves them bitwise a
        never-gossiped trajectory). Identity under the full scope."""
        if not self._scoped and fire is None:
            return mixed_s
        local = x.float() - torch.as_tensor(alpha, dtype=torch.float32) * g.float()
        if self._scoped:
            return self._scatter_cols(local, mixed_s)
        return torch.where(self._gate_mask & ~fire, local, mixed_s)

    def _scope_finish_gt(self, mx_s: torch.Tensor, mt_s: torch.Tensor, x, t, g, gp,
                         alpha, fire=None):
        """DSGT twin of :meth:`_scope_finish`: the private columns' tracker
        follows the unmixed recursion ``t + g - g_prev`` and the params
        ``x - alpha * tracker`` -- what the kernel computes on those
        columns, less the W contraction."""
        if not self._scoped and fire is None:
            return mx_s, mt_s
        th = t.float() + g.float() - gp.float()
        xl = x.float() - torch.as_tensor(alpha, dtype=torch.float32) * th
        if self._scoped:
            return self._scatter_cols(xl, mx_s), self._scatter_cols(th, mt_s)
        keep = self._gate_mask & ~fire
        return torch.where(keep, xl, mx_s), torch.where(keep, th, mt_s)

    def _scope_fire(self, comm: Dict[str, torch.Tensor]):
        """The layerwise gate of THIS round from the round counter (None
        when the scope never gates)."""
        if not self._scope_round:
            return None
        return self.scope.fire(comm["topo_round"])

    # -- DP hooks (the engines with the error-feedback wire) ---------------

    def _dp_kwargs(self, noise=None, noise_t=None) -> Dict:
        """The wrappers' DP arguments for this round's noise: none without
        noise (the plain call), the clip and the noise otherwise."""
        if noise is None:
            return {}
        out = {"dp_clip": float(self.privacy.dp_clip), "dp_noise": noise}
        if noise_t is not None:
            out["dp_noise_t"] = noise_t
        return out

    def _dp_noise(self, comm: Dict[str, torch.Tensor], rows: range,
                  tracker: bool = False) -> torch.Tensor:
        """This round's Gaussian draw, std ``sigma * clip``, for the node
        ``rows`` over the wire width (the scoped width under a sub-range
        scope, as the reference draws it), from the round counter and the
        privacy key in ``comm``. The element counter is global, so a
        rank's rows are bitwise the rows of the whole draw."""
        stream = NOISE_STREAM + (TRACKER_STREAM_OFFSET if tracker else 0)
        ids = torch.arange(rows.start, rows.stop, device=self.device)
        return dp_noise(comm["priv_key"], comm["topo_round"], ids, self.wire_layout.total,
                        self.privacy.dp_sigma * self.privacy.dp_clip, stream=stream)

    def _round_noises(self, comm: Dict[str, torch.Tensor], rows: range,
                      wires: int) -> Tuple[torch.Tensor, ...]:
        """The round's noise for each wire (none without DP)."""
        if not self.privacy.dp:
            return ()
        noises = (self._dp_noise(comm, rows),)
        if wires == 2:
            noises += (self._dp_noise(comm, rows, tracker=True),)
        return noises

    def _privacy_metrics(self, cfg: FLConfig, step: int) -> Dict[str, torch.Tensor]:
        """``dp_epsilon``: the (epsilon, delta) moments bound over the wire
        releases so far -- one a comm round (``step // q``), two for DSGT
        (the parameter and the tracker wire)."""
        if not self.privacy.dp:
            return {}
        wires = 2 if cfg.algorithm == "dsgt" else 1
        return {"dp_epsilon": epsilon_traced(self.privacy.dp_sigma,
                                             (step // cfg.q) * wires, self.privacy.delta)}

    def make_step_mask(self, cfg: FLConfig):
        """The heterogeneous-compute hook for ``_assemble_round``: None
        for programs that never slow a node (the steps run unmasked),
        else ``step_mask(state) -> (q-1, n)`` from the round counter and
        node key in ``FLState.comm``. A program that changes the wire's
        k per node is refused unless the engine ``supports_wire_k``."""
        prog = self.node_program
        if prog.heterogeneous_wire_k and not self.supports_wire_k:
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

    # -- checkpoint restore ----------------------------------------------------

    def _known_comm_keys(self) -> frozenset:
        """Every comm key this engine could carry (over both algorithms and
        every schedule depth): what :meth:`restore_comm` holds a restored
        dict to. Engines with wire buffers extend it."""
        return frozenset(("topo_round", "topo_key", "node_key", "priv_key")
                         + tuple(self.topology_program.state_keys()))

    def _check_restored_comm_keys(self, comm: Dict[str, torch.Tensor]) -> None:
        """Refuse a restored comm dict carrying keys this engine does not
        know: state from another wire contract would be dropped, then
        re-initialized inconsistently on the next save."""
        unknown = sorted(set(comm) - self._known_comm_keys())
        if unknown:
            raise ValueError(
                f"restored comm state carries keys {unknown} the "
                f"{self.name!r} engine does not know (known: "
                f"{sorted(self._known_comm_keys())}). The checkpoint was "
                "written under a different wire contract -- rebuild the "
                "engine with the checkpoint manifest's engine/schedule/"
                "topology/node-program/privacy specs (training.checkpoint "
                "restores them verbatim), or migrate the comm dict by "
                "dropping keys the manifest marks as derived."
            )

    def restore_comm(self, comm: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Rebuild the DERIVED wire buffers after a checkpoint restore (the
        identity for engines whose buffers are all independent), after
        refusing unknown keys (:meth:`_check_restored_comm_keys`)."""
        self._check_restored_comm_keys(comm)
        return comm

    def is_derived_comm_key(self, key: str) -> bool:
        """True for comm buffers :meth:`restore_comm` rebuilds from the
        independent ones: a checkpoint's derived keys may be dropped where
        the restore template's contract no longer carries them."""
        return False

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
        rounded fp32 operations (alpha an fp32 scalar) on the upcast
        operands, stored back at the leaf's dtype (bf16 storage rounds
        once). ``mask`` is the node program's (n,) compute gate for this
        step: a masked node's step size is zero, so it sits the step
        out."""
        a = torch.as_tensor(alpha, dtype=torch.float32)
        if mask is None:
            return tree_map(lambda p, g: (p.float() - a * g.float()).to(p.dtype),
                            params, grads)
        am = a * mask
        return tree_map(
            lambda p, g: (p.float() - am.reshape((-1,) + (1,) * (p.ndim - 1))
                          * g.float()).to(p.dtype), params, grads)

    def mix(self, buf):
        """Exact-wire W application (theta <- W theta) on the engine's
        state representation. The fused engine has no standalone mix: its
        W lives inside the comm-step kernel."""
        raise NotImplementedError(
            f"{type(self).__name__} mixes inside its fused comm step"
        )

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over every node of a mean over this process's nodes:
        ``x`` itself unless the nodes are split over several processes.
        The sum runs over the node group (on the ``(node, model)`` layout
        every model rank of a block holds the block's value: a node
        counts once)."""
        if self.group is None:
            return x
        x = x.detach().clone()
        dist.all_reduce(x, group=self.group.wire_pg)
        return x / self.group.node_ranks

    @property
    def storage_dtype(self) -> torch.dtype:
        """The dtype the flat buffer (and DSGT's tracker and
        ``prev_grad``) is stored in; fp32 for tree state."""
        return torch.float32 if self.layout is None else as_dtype(self.layout.storage_dtype)

    def _st(self, x: torch.Tensor) -> torch.Tensor:
        """A mixed fp32 output stored back at the storage dtype."""
        return x.to(self.storage_dtype)

    def wire_bytes(self, cfg: FLConfig) -> Optional[float]:
        """Per-round egress summed over all nodes (None: the engine does
        not account it -- the exact wire, whose payload is the unpadded
        tree; see ``training.metrics.comm_bytes_per_gossip``)."""
        return None

    def check_params(self, cfg: FLConfig, params) -> None:
        """Validate the initial state representation: node-stacked (this
        rank's rows of it on a group build)."""
        if self.group is None:
            check_node_stacked(cfg, params)
            return
        if cfg.n_nodes != self.n_nodes:
            raise ValueError(f"cfg.n_nodes {cfg.n_nodes} != the group's {self.n_nodes} nodes")
        check_node_stacked(dataclasses.replace(cfg, n_nodes=len(self.rows)), params)

    def _bind_group(self, group: NodeGroup, n_nodes: int) -> None:
        """An exact-wire engine built on a group (``from_group``): its
        state is this rank's rows, each round's batches carry all n
        nodes, and the metrics are over all of them."""
        self.group = group
        self.n_nodes = int(n_nodes)
        self.rows = group.rows(self.n_nodes)

    def make_eval_grads(self, grad_fn):
        """Adapt the node-batched tree ``grad_fn`` (``core.fl.
        value_and_grad``) to the engine's representation: itself for tree
        state, through the layout for the flat buffer; on a group build,
        on this rank's rows of the batches."""
        inner = grad_fn if self.layout is None else _make_flat_eval_grads(self.layout,
                                                                           grad_fn)
        if self.group is None:
            return inner
        rows = slice(self.rows.start, self.rows.stop)
        return lambda params, batch: inner(params, {k: v[rows] for k, v in batch.items()})

    def _exact_metrics(self, losses, grads, params) -> Dict[str, torch.Tensor]:
        """The exact-wire round's loss, ``grad_norm_sq`` and
        ``consensus_err``: over this process's nodes, or all-reduced over
        the group on a group build."""
        if self.group is None:
            return {"loss": losses.mean(), "grad_norm_sq": _mean_grad_norm_sq(grads),
                    "consensus_err": _consensus_error(params)}
        if self.group.model_shards > 1:
            return self._model_group_metrics(losses, grads, params)
        g = torch.cat([x.float().reshape(x.shape[0], -1) for _, x in tree_leaves(grads)], 1)
        p = torch.cat([x.float().reshape(x.shape[0], -1) for _, x in tree_leaves(params)], 1)
        t, n = g.shape[1], self.n_nodes
        sums = torch.cat([losses.float().sum()[None], g.sum(0), p.sum(0)])
        dist.all_reduce(sums, group=self.group.pg)
        mean_g = sums[1:1 + t] / n
        dev = p - sums[1 + t:] / n
        sq = (dev * dev).sum()
        dist.all_reduce(sq, group=self.group.pg)
        return {"loss": sums[0] / n, "grad_norm_sq": (mean_g * mean_g).sum(),
                "consensus_err": sq / n}

    def _model_group_metrics(self, losses, grads, params) -> Dict[str, torch.Tensor]:
        """:meth:`_exact_metrics` on the ``(node, model)`` layout, where a
        rank holds its node rows' shard of each split leaf and the whole of
        each replicated one: the column sums run over the node group (the
        same shard of every block), the loss counts once per node, and the
        squared norms add each split leaf's S shards (an all-reduce over
        the model group) and each replicated leaf once."""
        n, specs = self.n_nodes, self._tp_specs
        parts = {True: ([], []), False: ([], [])}
        for (path, g), (_, p) in zip(tree_leaves(grads), tree_leaves(params)):
            split = is_split(specs[path])
            parts[split][0].append(g.float().reshape(g.shape[0], -1))
            parts[split][1].append(p.float().reshape(p.shape[0], -1))
        cols = {k: sum(x.shape[1] for x in v[0]) for k, v in parts.items()}
        g = torch.cat(parts[True][0] + parts[False][0], 1)
        p = torch.cat(parts[True][1] + parts[False][1], 1)
        t = g.shape[1]
        sums = torch.cat([losses.float().sum()[None], g.sum(0), p.sum(0)])
        dist.all_reduce(sums, group=self.group.wire_pg)
        mean_g = sums[1:1 + t] / n
        dev = p - sums[1 + t:] / n
        dev_sq = (dev * dev).sum(0)
        gsq = mean_g * mean_g
        cut = cols[True]
        sq = torch.stack([dev_sq[:cut].sum(), dev_sq[cut:].sum()])
        dist.all_reduce(sq, group=self.group.wire_pg)
        split = torch.stack([gsq[:cut].sum(), sq[0]])
        dist.all_reduce(split, group=self.group.model_pg)
        return {"loss": sums[0] / n, "grad_norm_sq": split[0] + gsq[cut:].sum(),
                "consensus_err": (split[1] + sq[1]) / n}

    def params_view(self, params):
        """The tree view of the engine's parameter state."""
        return params if self.layout is None else unpack(params, self.layout)

    def pack_state(self, stacked_params):
        """The engine's state of node-stacked params (all n nodes): the
        tree itself or packed into the layout, this rank's rows of it on a
        group build, on the engine's device."""
        if self.group is not None:
            rows = slice(self.rows.start, self.rows.stop)
            stacked_params = tree_map(lambda x: x[rows], stacked_params)
        if self.layout is None:
            return tree_map(lambda x: x.to(self.device), stacked_params)
        return pack_like(stacked_params, self.layout).to(self.device)

    def dense_equivalent(self) -> np.ndarray:
        """The dense W the engine mixes with."""
        raise NotImplementedError(f"the {self.name!r} engine does not expose its W")

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

            # adapt at fp32, stored back at the state's dtype (bf16 flat
            # storage narrows what is stored, never the arithmetic)
            def adapt(wp, t):
                return (wp.float() - a * t.float()).to(wp.dtype)

            # the tracker's sum in the state's dtype, rounded op by op, as
            # the reference's (its compiled bf16 adds round each)
            def track(wt, gn, gp):
                return wt + gn.to(wt.dtype) - gp

            if cfg.algorithm == "dsgd":
                params = tree_map(adapt, mix(state.params), grads)
                new_state = state._replace(step=step, params=params, comm=comm)
            else:
                tracker = tree_map(track, mix(state.tracker), grads, state.prev_grad)
                params = tree_map(adapt, mix(state.params), tracker)
                new_state = state._replace(
                    step=step, params=params, tracker=tracker,
                    prev_grad=tree_map(lambda g, p: g.to(p.dtype), grads, state.prev_grad),
                    comm=comm)
            metrics = {
                **self._exact_metrics(losses, grads, new_state.params),
                "alpha": float(alpha),
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


def _reject_storage_dtype(storage_dtype, name: str) -> None:
    """The tree engine has no flat buffer to store narrow: the
    reference's refusal."""
    if storage_dtype is not None and as_dtype(storage_dtype) != torch.float32:
        raise ValueError(
            f"storage_dtype is a flat-buffer knob (bf16 buffer with fp32 "
            f"mix accumulation); the {name!r} engine has no flat buffer "
            "-- use 'flat', 'fused', or 'sharded_fused'"
        )


#: storage dtypes the fused engines accept: the params / tracker buffer
#: may be stored narrow, but the EF recon / residual wire state stays fp32
#: (the residual must not be rounded)
_FUSED_STORAGE_DTYPES = ("float32", "bfloat16")


def _fused_layout(layout: FlatLayout, storage_dtype, name: str) -> FlatLayout:
    """The fused engines' layout: ``storage_dtype`` (when given) replaces
    the layout's, and only :data:`_FUSED_STORAGE_DTYPES` are accepted,
    with the reference's message."""
    if storage_dtype is not None:
        layout = dataclasses.replace(
            layout, storage_dtype=str(as_dtype(storage_dtype)).removeprefix("torch."))
    if layout.storage_dtype not in _FUSED_STORAGE_DTYPES:
        raise ValueError(
            f"the {name!r} engine stores the flat buffer in "
            f"{_FUSED_STORAGE_DTYPES} only (got {layout.storage_dtype!r}); "
            "the wire math and the EF recon/residual state run fp32 either way"
        )
    return layout


def _check_storage(params: torch.Tensor, engine: "GossipEngine") -> None:
    """The fused engines' buffer: the storage dtype, on the engine's
    device."""
    if params.dtype != engine.storage_dtype or params.device != engine.device:
        raise ValueError(
            f"flat buffer is {params.dtype} on {params.device}; the engine "
            f"stores {engine.storage_dtype} on {engine.device}"
        )


def _reject_privacy(privacy, name: str, reason: str) -> PrivacySpec:
    """Resolve a privacy spec and refuse any active one on engines whose
    wire can realize none, with the reference's message."""
    p = resolve_privacy(privacy)
    if p.active:
        raise ValueError(
            f"privacy spec {p.spec()!r}: the {name!r} {reason} -- use "
            "'fused' (dp; secure_agg is vacuously satisfied in-process) "
            "or 'sharded_fused' on the circulant wire (dp + secure_agg)"
        )
    return p


def _reject_dp(privacy, name: str, reason: str) -> PrivacySpec:
    """Resolve a privacy spec, allowing ``secure_agg`` (a no-op where no
    per-edge payload exists) but refusing DP on engines without the
    error-feedback epilogue that absorbs the noise, with the reference's
    message."""
    p = resolve_privacy(privacy)
    if p.dp:
        raise ValueError(
            f"privacy spec {p.spec()!r}: the {name!r} {reason}, so DP "
            "noise would accumulate unabsorbed -- use the 'fused' or "
            "'sharded_fused' engine (error-feedback wire epilogue)"
        )
    return p


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


def _wire_kwargs(engine: "GossipEngine") -> Dict:
    """A fused engine's wire knobs, as the kernel wrappers take them."""
    return dict(scale_chunk=engine.scale_chunk, topk=engine.topk,
                error_feedback=engine.error_feedback,
                difference_coding=engine.difference_coding)


def _require_ef_for_dp(privacy: PrivacySpec, error_feedback: bool) -> None:
    """The fused engines' refusal of ``dp`` without error feedback (the
    reference's message)."""
    if privacy.dp and not error_feedback:
        raise ValueError(
            "dp noise rides the EF residual (res-substitution in the "
            "wire-stage epilogue); build the engine with "
            "error_feedback=True or drop the dp token"
        )


def _refuse_exact_wire(name: str, topk, round_schedule, scope) -> None:
    """What the reference's exact-wire engines refuse, with its messages:
    the top-k wire, a schedule other than the blocking one, and a partial
    federation scope (resolved first, so a ``FullScope`` passes)."""
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
    s = resolve_scope(scope)
    if not s.is_full:
        raise ValueError(
            f"federation scope {s.spec()!r}: the {name!r} engine ships "
            "the whole state through a baked exact-wire backend (no "
            "column slicing) -- use the 'fused' engine, or "
            "'sharded_fused' for sub-range scopes on the mesh wire"
        )


# ---------------------------------------------------------------------------
# Exact-wire engines
# ---------------------------------------------------------------------------


@register_engine
class TreeEngine(GossipEngine):
    """Node-stacked tree state, mixed by a tree-level gossip backend
    (``core.mixing.make_dense_gossip``: the dense-W product)."""

    name = "tree"
    #: the (node, model) layout's spec of each leaf path (None: whole leaves)
    _tp_specs: Optional[Dict] = None

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
        _reject_storage_dtype(storage_dtype, cls.name)
        _reject_privacy(privacy, cls.name, "engine's pytree wire has no quantize "
                        "epilogue to pad or noise")
        reason = "engine bakes W into its tree-level gossip backend"
        _reject_dynamic_program(topology_program, cls.name, reason)
        _reject_node_program(node_program, cls.name, reason)
        leaf = tree_leaves(stacked_params)[0][1]
        return cls(make_dense_gossip(w, wire_dtype), device=leaf.device), stacked_params

    @classmethod
    def from_group(cls, group: NodeGroup, stacked_params, *, wire_dtype=None,
                   self_weight=None, axes_subset=None, topk=None, round_schedule=None,
                   storage_dtype=None, topology_program=None, node_program=None,
                   privacy=None, scope=None,
                   **_ignored) -> Tuple["TreeEngine", object]:
        """The build on a node torus (the reference's ``from_mesh``): this
        rank's rows of the tree, mixed by ``core.mixing.make_mesh_gossip``
        over the group's node axes (one exchange per torus direction).
        Returns (engine, this rank's rows of ``stacked_params`` on the
        group's device).

        On the ``(node, model)`` layout (S = ``group.model_shards`` > 1,
        the reference's Megatron specs on every leaf) the state is this
        rank's rows of its shard of each leaf (``models.sharding.
        shard_params`` of the whole ``stacked_params``): the loss must be
        the tensor-parallel bundle's (``build_model(cfg,
        model_group=group.model_pg)``), the gossip mixes each shard with
        the same shard of the other node blocks (the node group), and the
        metrics count each node and each leaf once."""
        _refuse_exact_wire(cls.name, topk, round_schedule, scope)
        _reject_storage_dtype(storage_dtype, cls.name)
        _reject_privacy(privacy, cls.name, "engine's pytree wire has no quantize "
                        "epilogue to pad or noise")
        reason = "engine bakes W into its tree-level gossip backend"
        _reject_dynamic_program(topology_program, cls.name, reason)
        _reject_node_program(node_program, cls.name, reason)
        eng = cls(make_mesh_gossip(group, self_weight, wire_dtype, axes_subset),
                  device=group.device)
        n = tree_leaves(stacked_params)[0][1].shape[0]
        eng._bind_group(group, n)
        rows = slice(eng.rows.start, eng.rows.stop)
        mine = tree_map(lambda x: x[rows], stacked_params)
        if group.model_shards > 1:
            specs = stacked_param_specs(mine)
            eng._tp_specs = spec_dict(specs)
            mine = shard_params(mine, group.shard, group.model_shards, specs)
        return eng, tree_map(lambda x: x.to(group.device), mine)


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
                 w=None, privacy=None):
        self.privacy = _reject_dp(privacy, self.name, "engine ships an exact "
                                  "un-quantized wire with no error-feedback residual")
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
        if self.group is not None:
            super().check_params(cfg, params)
            cfg = dataclasses.replace(cfg, n_nodes=len(self.rows))
        _check_flat_params(cfg, params, self.name)

    @classmethod
    def simulated(cls, w: np.ndarray, stacked_params, *, scale_chunk: int = 1,
                  wire_dtype=None, topk=None, round_schedule=None,
                  storage_dtype=None, topology_program=None, node_program=None,
                  privacy=None, scope=None,
                  **_ignored) -> Tuple["FlatEngine", torch.Tensor]:
        """Pack node-stacked params (padded to ``scale_chunk``, stored in
        ``storage_dtype``, fp32 by default) and build the engine on their
        device, the programs bound to ``w``. The mix accumulates in fp32
        and rounds back to the storage dtype. Returns (engine, flat
        buffer)."""
        _refuse_exact_wire(cls.name, topk, round_schedule, scope)
        flat, layout = pack(stacked_params, pad_to=scale_chunk,
                            buffer_dtype=storage_dtype or torch.float32)
        return cls(make_dense_flat_mix(w, wire_dtype), layout, device=flat.device,
                   topology_program=topology_program, node_program=node_program,
                   wire_dtype=wire_dtype, w=w, privacy=privacy), flat

    @classmethod
    def from_group(cls, group: NodeGroup, stacked_params, *, scale_chunk: int = 1,
                   wire_dtype=None, self_weight=None, axes_subset=None, topk=None,
                   round_schedule=None, storage_dtype=None, topology_program=None,
                   node_program=None, privacy=None, scope=None,
                   **_ignored) -> Tuple["FlatEngine", torch.Tensor]:
        """The build on a node torus (the reference's ``from_mesh``): this
        rank's rows of the packed buffer, mixed by ``core.mixing.
        make_mesh_flat_mix`` over the group's node axes. Returns (engine,
        this rank's rows of the flat buffer on the group's device)."""
        _refuse_exact_wire(cls.name, topk, round_schedule, scope)
        _reject_privacy(privacy, cls.name, "engine's mesh build ships raw fp32 "
                        "payloads through a baked ppermute backend (no pad/noise "
                        "epilogue)")
        reason = "engine's mesh build mixes through a baked ppermute backend"
        _reject_dynamic_program(topology_program, cls.name, reason)
        _reject_node_program(node_program, cls.name, reason)
        if group.model_shards > 1:
            raise ValueError(
                f"the 'flat' engine on the (node, model) layout ({group.model_shards} model "
                "shards) is ROADMAP.md queue 1, item 18b: its flat buffer is not "
                "Megatron-split -- use 'tree' (dense, VLM, MoE) or 'sharded_fused'")
        flat, layout = pack(stacked_params, pad_to=scale_chunk,
                            buffer_dtype=storage_dtype or torch.float32)
        eng = cls(make_mesh_flat_mix(group, self_weight, wire_dtype, axes_subset),
                  dataclasses.replace(layout, n_nodes=len(group.rows(layout.n_nodes))),
                  device=group.device, wire_dtype=wire_dtype)
        eng._bind_group(group, layout.n_nodes)
        rows = slice(eng.rows.start, eng.rows.stop)
        return eng, flat[rows].to(group.device).contiguous()


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


def _own_block(block: torch.Tensor) -> torch.Tensor:
    """``block`` contiguous in a storage of its own: a view of the packed
    buffer of all n nodes would keep all of it alive on every rank."""
    if block.untyped_storage().nbytes() > block.numel() * block.element_size():
        return block.clone(memory_format=torch.contiguous_format)
    return block.contiguous()


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
    kernel wrappers run their PyTorch twins; on the card a federation
    whose round the one-pass kernel cannot hold in a block's shared
    memory takes the wrappers' two-pass route (``kernels.gossip.
    plan_route``: the wire stage, then the mix kernel), with the same
    outputs.

    ``error_feedback`` / ``difference_coding`` (both on by default) are
    the reference's knobs, handed to the kernels: without error feedback
    the residual stays as it was (zeros), without difference coding each
    payload is the whole vector, so recon is the last payload and the
    depth-k ring holds k payloads, not k-1 (:meth:`_ring_depth`). ``dp``
    needs error feedback.

    ``privacy``: ``dp`` clips and noises each round's payload in the
    kernels' quantize epilogue (the wrappers' residual substitution, still
    one launch a round), the noise drawn from ``priv_key`` and
    ``topo_round`` in ``FLState.comm``, and reports ``dp_epsilon``;
    ``secure_agg`` is a no-op here (no per-edge payload exists), so a
    masked run is bitwise its unmasked twin.

    ``scope``: a sub-range scope's kernels run on the gathered shared
    columns (``_gather_cols``), every wire buffer at ``wire_layout``'s
    width, and the private columns take the plain local update
    (``_scope_finish``); ``layerwise`` gates the head columns' mix on
    ``topo_round``, which the round then carries.

    ``storage_dtype`` (or the layout's): the params / tracker / prev-grad
    buffer is stored in fp32 or bf16; the kernels take it upcast and the
    mixed outputs are stored back rounded, while the wire state stays
    fp32."""

    name = "fused"

    def __init__(self, w: np.ndarray, layout: FlatLayout, *,
                 scale_chunk: int = 512, device=None, topk=None,
                 error_feedback: bool = True, difference_coding: bool = True,
                 round_schedule=None, wire_dtype=None, topology_program=None,
                 node_program=None, privacy=None, scope=None,
                 storage_dtype=None):
        if wire_dtype is not None:
            raise ValueError(
                "the fused engines' wire is always int8; "
                "wire_dtype only applies to the tree/flat exact-wire engines"
            )
        layout = _fused_layout(layout, storage_dtype, self.name)
        self.privacy = resolve_privacy(privacy)
        _require_ef_for_dp(self.privacy, error_feedback)
        self.error_feedback = error_feedback
        self.difference_coding = difference_coding
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
        self._bind_scope(scope)

    def _static_round_w(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.w_off, self.w_self

    def dense_equivalent(self) -> np.ndarray:
        return self.w

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
        k-1 payloads``, so the ring holds k-1; without it recon is the
        last payload, so the ring holds k and the mix reads the oldest."""
        k = self.staleness_depth
        if k <= 1:
            return 0
        return k - 1 if self.difference_coding else k

    def _known_comm_keys(self) -> frozenset:
        return super()._known_comm_keys() | frozenset(
            base + suffix for base in ("recon", "residual", "wire_q", "wire_scales")
            for suffix in ("", "_t"))

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        ring = ("wire_q", "wire_scales") if self._ring_depth() else ()
        keys = ("recon", "residual") + ring
        if cfg.algorithm == "dsgt":
            keys += ("recon_t", "residual_t") + tuple(k + "_t" for k in ring)
        return keys + self._topo_keys()

    def comm_state_spec(self, cfg: FLConfig):
        """Wire state at the wire width (``wire_layout.total``, the scoped
        width under a sub-range scope): (n, t) fp32 recon / residual, and
        the ring of int8 payloads (n, ring, t) with their fp32 scales
        (n, ring, t // scale_chunk); then the counters."""
        n, t, rd = cfg.n_nodes, self.wire_layout.total, self._ring_depth()
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
        staleness depth (the ring holds payloads, it never resends), at
        the wire width."""
        wires = 2 if cfg.algorithm == "dsgt" else 1
        edge = flat_wire_bytes(self.wire_layout, 1, self.scale_chunk, self.topk)
        return float(wires * _degrees(self.w).sum() * edge)

    def check_params(self, cfg: FLConfig, params) -> None:
        _check_flat_params(cfg, params, self.name)
        if tuple(params.shape) != (cfg.n_nodes, self.layout.total):
            raise ValueError(
                f"flat buffer {tuple(params.shape)} != "
                f"({cfg.n_nodes}, {self.layout.total})"
            )
        _check_storage(params, self)

    def _metrics(self, cfg, losses, alpha, grads, new_state: FLState, egress: float):
        res = new_state.comm["residual"]
        return {
            "loss": losses.mean(),
            "alpha": float(alpha),
            "grad_norm_sq": _mean_grad_norm_sq(grads),
            "consensus_err": _consensus_error(new_state.params),
            "comm_rounds": 1.0,
            "wire_bytes": egress,
            "ef_residual_rms": torch.sqrt((res * res).mean()),
            **self._privacy_metrics(cfg, new_state.step),
        }

    def _round_w(self, comm):
        """The round's ``(w_off_r, w_self_r, counter entries, gate
        metrics)``: the constant W on a static round (and the privacy
        counter's advance), else the realized W_r of
        :meth:`_round_gates` -- a runtime operand of the same kernels."""
        if not self.dynamic_round:
            return self.w_off, self.w_self, self._priv_comm(comm), {}
        return self._round_gates(comm)

    def make_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        if self._ring_depth():
            return self._make_bounded_comm_step(eval_grads, schedule, cfg)
        # pipelined: the kernel's stale_mix contracts W against the INPUT
        # recon -- the neighbor reconstruction as of the end of the
        # previous round -- so depth 1 needs no extra buffer
        kw = dict(_wire_kwargs(self), stale_mix=self.pipelined)
        egress = self.wire_bytes(cfg)
        wires = 2 if cfg.algorithm == "dsgt" else 1

        def comm_step(state: FLState, batch):
            if state.comm is None:
                raise ValueError("fused rounds need init_fl_state(..., engine)")
            step = state.step + 1
            alpha = schedule(step)
            losses, grads = eval_grads(state.params, batch)
            grads = grads.float()
            c = state.comm
            w_off_r, w_self_r, topo_comm, gate_metrics = self._round_w(c)
            dpkw = self._dp_kwargs(*self._round_noises(c, range(cfg.n_nodes), wires))
            # the kernel runs unchanged, in fp32, on the gathered shared
            # columns; the private ones never enter it (_scope_finish[_gt])
            fire = self._scope_fire(c)
            gather = self._gather_cols
            if cfg.algorithm == "dsgd":
                mixed, recon, res, _ = fused_round(
                    gather(state.params.float()), gather(grads), c["recon"], c["residual"],
                    w_off_r, w_self_r, alpha, **kw, **dpkw,
                )
                mixed = self._scope_finish(mixed, state.params, grads, alpha, fire)
                new_state = state._replace(
                    step=step, params=self._st(mixed),
                    comm={"recon": recon, "residual": res, **topo_comm},
                )
            else:
                mx, mt, nrx, nsx, nrt, nst, _, _ = fused_round_gt(
                    gather(state.params.float()), gather(state.tracker.float()),
                    gather(grads), gather(state.prev_grad.float()),
                    c["recon"], c["residual"], c["recon_t"], c["residual_t"],
                    w_off_r, w_self_r, alpha, **kw, **dpkw,
                )
                mx, mt = self._scope_finish_gt(mx, mt, state.params, state.tracker, grads,
                                               state.prev_grad, alpha, fire)
                new_state = FLState(
                    step=step, params=self._st(mx), tracker=self._st(mt),
                    prev_grad=self._st(grads),
                    comm={"recon": nrx, "residual": nsx,
                          "recon_t": nrt, "residual_t": nst, **topo_comm},
                )
            metrics = self._metrics(cfg, losses, alpha, grads, new_state, egress)
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
        kw = _wire_kwargs(self)
        egress = self.wire_bytes(cfg)
        wires = 2 if cfg.algorithm == "dsgt" else 1
        dc = self.difference_coding

        def stale_recon(recon, wq, wsc):
            """recon^(r-k): recon less the ring's payloads (difference
            coding), or the oldest payload itself (without it)."""
            if not dc:
                return _dequant(wq[:, 0], wsc[:, 0], chunk)
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
            grads = grads.float()
            c = state.comm
            w_off_r, w_self_r, topo_comm, gate_metrics = self._round_w(c)

            def mix(nbr, h):
                return w_off_r @ nbr + w_self_r[:, None] * h

            dpkw = self._dp_kwargs(*self._round_noises(c, range(cfg.n_nodes), wires))
            fire = self._scope_fire(c)
            gather = self._gather_cols
            if cfg.algorithm == "dsgd":
                h, q, sc, nrecon, nres = wire_stage(
                    gather(state.params.float()), gather(grads), c["recon"], c["residual"],
                    alpha, **kw, **dpkw)
                mixed = self._st(self._scope_finish(
                    mix(stale_recon(c["recon"], c["wire_q"], c["wire_scales"]), h),
                    state.params, grads, alpha, fire))
                nwq, nwsc = push(c["wire_q"], c["wire_scales"], q, sc)
                new_state = state._replace(
                    step=step, params=mixed,
                    comm={"recon": nrecon, "residual": nres,
                          "wire_q": nwq, "wire_scales": nwsc, **topo_comm},
                )
            else:
                (h, t_half, qx, scx, nrx, nsx, qt, sct, nrt, nst) = wire_stage_gt(
                    gather(state.params.float()), gather(state.tracker.float()),
                    gather(grads), gather(state.prev_grad.float()),
                    c["recon"], c["residual"], c["recon_t"], c["residual_t"],
                    alpha, **kw, **dpkw,
                )
                mixed_x, mixed_t = self._scope_finish_gt(
                    mix(stale_recon(c["recon"], c["wire_q"], c["wire_scales"]), h),
                    mix(stale_recon(c["recon_t"], c["wire_q_t"], c["wire_scales_t"]),
                        t_half),
                    state.params, state.tracker, grads, state.prev_grad, alpha, fire)
                nwq, nwsc = push(c["wire_q"], c["wire_scales"], qx, scx)
                nwqt, nwsct = push(c["wire_q_t"], c["wire_scales_t"], qt, sct)
                new_state = FLState(
                    step=step, params=self._st(mixed_x), tracker=self._st(mixed_t),
                    prev_grad=self._st(grads),
                    comm={"recon": nrx, "residual": nsx,
                          "recon_t": nrt, "residual_t": nst,
                          "wire_q": nwq, "wire_scales": nwsc,
                          "wire_q_t": nwqt, "wire_scales_t": nwsct, **topo_comm},
                )
            metrics = self._metrics(cfg, losses, alpha, grads, new_state, egress)
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
        """Pack node-stacked params (padded to ``scale_chunk``, stored in
        ``storage_dtype``, fp32 by default) and build the engine on their
        device. Returns (engine, flat buffer)."""
        storage_dtype = kw.pop("storage_dtype", None)
        flat, layout = pack(stacked_params, pad_to=scale_chunk,
                            buffer_dtype=storage_dtype or torch.float32)
        return cls(w, layout, scale_chunk=scale_chunk, device=flat.device,
                   **kw), flat

    @classmethod
    def from_node_axes(cls, node_axes: Dict[str, int], stacked_params, *,
                       self_weight=None, axes_subset=None, scale_chunk: int = 512,
                       **kw) -> Tuple["FusedEngine", torch.Tensor]:
        """The single-process build over a node torus (the reference's
        ``FusedEngine.from_mesh``): W is the dense equivalent of the
        circulant ring / torus over ``node_axes`` (an ordered ``{name:
        size}``; directions restricted to ``axes_subset``), the W the
        sharded engine's circulant wire realizes -- its oracle. Returns
        (engine, flat buffer), as :meth:`simulated`."""
        w = mesh_gossip_dense_equivalent(dict(node_axes), self_weight=self_weight,
                                         axes_subset=axes_subset)
        return cls.simulated(w, stacked_params, scale_chunk=scale_chunk, **kw)


# ---------------------------------------------------------------------------
# The sharded engine: node rows over the ranks of a process group
# ---------------------------------------------------------------------------


@register_engine
class ShardedFusedEngine(GossipEngine):
    """The fused round with the node rows split over the ranks of a
    ``torch.distributed`` group (the reference's ``ShardedFusedEngine``).
    Rank ``a * S + s`` of the group (``launch.mesh``) holds node block
    ``a`` -- the rows ``[a * R, (a + 1) * R)`` -- and column tile ``s`` of
    every (n, total) buffer (S = 1 unless the engine is built with
    ``model_axis``). Per round, for each wire:

      1. the WIRE STAGE -- local update (DSGD) or tracker arithmetic and
         update (DSGT), difference coding, int8 quantize, error feedback
         -- is ONE kernel launch on the rank's tile (DSGT's two wires
         share it): ``wire_stage[_gt]_compact`` with exact-k top-k when
         ``topk`` is set and the compact encoding is smaller than the
         dense chunk, else ``wire_stage[_gt]`` (dense int8, top-k masked
         when ``topk`` is set);
      2. the wire buffers -- (k int8 values, k positions or the presence
         bitmap, fp32 scales) on the compact wire, (int8 payload,
         scales) on the dense one -- cross as their raw bytes (no
         collective has an int16 type), on the node group of the rank's
         shard:

         * ``w=None``, the CIRCULANT wire (the reference's default): the
           ring / torus W over the group's node axes
           (``core.mixing.mesh_gossip_dense_equivalent``, restricted to
           ``axes_subset``, self weight ``self_weight``), one
           ``dist.batch_isend_irecv`` per direction and buffer with one
           message per peer rank (``core.mixing.TorusPlan``; a neighbor
           row on the same rank is an index copy). At one node a rank
           that is one send per buffer and direction, and the ranks'
           bytes sum to ``wire_bytes``;
         * ``w=`` an arbitrary dense W: ONE all-gather per buffer (every
           payload reaches every rank);

      3. the receive side rebuilds the dense dq and the mix finishes
         against the running neighbor-reconstruction accumulator:
         ``mix_recon' = mix_recon + sum_d weight_d dq_d`` (circulant) or
         ``+ W_off[rows] @ dq_all``, then ``mixed = w_self * h +
         mix_recon'`` -- equal, up to the summation order, to
         ``FusedEngine`` on ``dense_equivalent()``.

    Under the pipelined and bounded-staleness schedules the comm step
    stores this round's wire buffers in ``FLState.comm`` (``wire_q``,
    ``wire_pos`` or ``wire_bits``, ``wire_scales``, and ``_t`` twins; a
    ring of k at depth k >= 2), and the next round's ingest moves the
    oldest before its local steps. Metrics are over all n nodes
    (all-reduced over the whole world), so every (world, S) reports the
    same numbers.

    Under a topology or node program every rank derives the whole
    realized W_r from the replicated counters (``_round_gates``) and
    keeps its rows. The pre-weighted ``mix_recon`` cannot carry a
    per-round W, so the dynamic round keeps one UNWEIGHTED accumulator
    per torus direction on the circulant wire (``nbr_recon_{d}``: that
    neighbor's reconstruction, (R, t) a rank), weighted per round by
    ``W_r[i, src_d(i)]``, or ``nbr_recon_all`` on the all-gather wire (an
    unweighted replica of every node's reconstruction, (R, n, t) a rank)
    contracted with the rank's rows of W_r -- with no transfer beyond the
    static round's. ``slow_uplink`` gives each node its own wire k
    (``supports_wire_k``): a node's payload keeps its k_i largest entries
    a chunk, the rest goes back into its residual, and
    ``wire_bytes_effective`` reports what those k_i would cost.

    ``privacy``: ``dp`` clips and noises each rank's tile in the wire
    stage's epilogue (each rank draws its tile of the global noise);
    ``secure_agg`` masks every payload with its edge's pairwise pad
    (``core.privacy.mask_wire``) just before each send and unmasks it
    just after each receive -- a neighbor row on the same rank too, so
    the arithmetic does not depend on the world -- which needs the
    circulant wire (per-edge payloads) and is refused on the all-gather
    one, as the reference refuses it.

    ``scope``: a sub-range scope's wire stage runs on the shared columns
    of the rank's tile (the per-shard ranges of ``packing.
    scoped_layout``), every wire buffer, transfer and accumulator at the
    scoped width, and the mix is scattered back around the private
    columns' local update; ``layerwise`` is refused, as the reference
    refuses it. ``restore_comm`` rebuilds the neighbor accumulators after
    a checkpoint restore (``gather_rows`` serves a save).

    ``model_axis`` (the two-axis layout): the group's S model shards tile
    every row; the wire stage is one launch per tile and the wire moves
    on the node group of the shard only, so a rank hands over exactly
    ``flat_wire_bytes_per_shard`` per edge and wire (``wire_bytes /
    S`` a round over the shard: ``wire_bytes_per_shard``). The local
    steps need every column: each gradient all-gathers the rank's rows
    over its model group and keeps its tile (``shard_gathers`` counts
    those gathers apart: they are not wire traffic). ``dp`` clips each
    tile's payload on its own (the wire stage sees one tile), as the
    reference's does, so a binding clip at S > 1 is not S = 1's.

    ``storage_dtype``: bf16 storage of the rank's rows as on ``fused``,
    upcast into the wire stage and rounded back after the mix; the wire
    buffers, recon, residual and the neighbor accumulators stay fp32.

    ``error_feedback`` / ``difference_coding``: the reference's knobs, as
    on ``fused``, on both wires. Without difference coding a node's
    reconstruction is its last payload, so the neighbour term is rebuilt
    from the round's wire alone: ``mix_recon'`` is the term itself, and
    the dynamic round keeps no ``nbr_recon_*`` accumulators. ``dp`` and a
    per-node wire k need error feedback.

    ``collectives`` and ``collective_bytes`` count the wire's messages
    (point-to-point sends, or all-gathers) and the bytes this rank hands
    them (the metrics' all-reduces are not wire traffic and do not
    count).
    """

    name = "sharded_fused"
    supports_wire_k = True

    def __init__(self, group: NodeGroup, layout: FlatLayout, *, w=None,
                 self_weight=None, axes_subset=None, scale_chunk: int = 512,
                 topk=None, compact=None, round_schedule=None,
                 error_feedback: bool = True, difference_coding: bool = True,
                 wire_dtype=None, model_axis=None, topology_program=None,
                 node_program=None, privacy=None, scope=None, storage_dtype=None):
        if wire_dtype is not None:
            raise ValueError(
                "the fused engines' wire is always int8; "
                "wire_dtype only applies to the tree/flat exact-wire engines"
            )
        axes = group.axes(layout.n_nodes)
        if model_axis is not None and model_axis in axes:
            raise ValueError(
                f"model_axis {model_axis!r} is also a gossip node "
                "axis; the two-axis round shards parameter columns "
                "over a DIFFERENT axis than the one enumerating nodes"
            )
        if model_axis is None and group.model_shards > 1:
            raise ValueError(
                f"the group tiles every node row over {group.model_shards} "
                "model shards; build the engine with model_axis= (e.g. "
                "'model') to run the two-axis round"
            )
        self.model_axis = model_axis
        self.model_shards = group.model_shards
        if layout.shards != self.model_shards:
            layout = layout.with_shards(self.model_shards)
        layout = _fused_layout(layout, storage_dtype, self.name)
        self.privacy = resolve_privacy(privacy)
        _require_ef_for_dp(self.privacy, error_feedback)
        if self.privacy.secure_agg and w is not None:
            raise ValueError(
                f"privacy spec {self.privacy.spec()!r}: secure_agg needs "
                "the circulant ppermute wire (per-edge payloads to pad); "
                "the dense all-gather wire broadcasts every payload to "
                "every node, so pairwise pads cannot conceal it -- drop "
                "w= (use the mesh torus W) or drop the secure_agg token"
            )
        if resolve_node_program(node_program).heterogeneous_wire_k:
            if topk is None:
                raise ValueError(
                    f"node program {resolve_node_program(node_program).spec()!r} "
                    "modulates per-node wire k; build the engine with topk= so "
                    "there is a k to modulate"
                )
            if not error_feedback:
                raise ValueError(
                    "per-node wire k rides the EF residual (entries a slow "
                    "uplink truncates re-ship later); build with "
                    "error_feedback=True"
                )
            if self.privacy.dp:
                raise ValueError(
                    "per-node wire k truncates the noised payload AFTER "
                    "clipping, which breaks the DP calibration; drop the "
                    "dp token or the wire-k program"
                )
        self.error_feedback = error_feedback
        self.difference_coding = difference_coding
        if scale_chunk < 1 or layout.total % scale_chunk:
            raise ValueError(
                f"layout.total {layout.total} not a multiple of scale_chunk "
                f"{scale_chunk}; pack with pad_to={scale_chunk}"
            )
        if layout.shard_width % scale_chunk:
            raise ValueError(
                f"per-shard width {layout.shard_width} not a multiple "
                f"of scale_chunk {scale_chunk}; pack with "
                f"pad_to={scale_chunk} and shards={self.model_shards} "
                "so every shard tile holds whole quantization chunks"
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
        # unpack / eval on this rank's rows only (full width)
        self.local_layout = dataclasses.replace(layout, n_nodes=len(self.rows))
        self._bind_scope(scope)
        if isinstance(self.scope, LayerwiseScope):
            raise ValueError(
                f"federation scope {self.scope.spec()!r}: the layerwise "
                "round-gated mix needs the dense in-kernel W contraction; "
                "the sharded wire accumulates neighbor terms across "
                "collectives -- use --fl-engine fused, or a static "
                "sub-range scope ('backbone' / 'ranges:') here"
            )
        # this rank's column tile of the params and of the wire
        s = group.shard
        self._tile = slice(s * layout.shard_width, (s + 1) * layout.shard_width)
        ww = self.wire_layout.shard_width
        self._wire_tile = slice(s * ww, (s + 1) * ww)
        # The compact wire is the wire only where it is SMALLER than the
        # dense int8 chunk; compact=None takes it exactly there, and an
        # explicitly requested uneconomic one is refused (the accounting
        # would report bytes the transfer does not move).
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
        self.node_axes = tuple(axes)
        if w is None:
            # the circulant torus over the node axes: the exchange plan
            subset = tuple(axes_subset) if axes_subset else None
            self.torus = TorusPlan(group, self.n_nodes, self_weight, subset)
            self.dirs, self._dir_src = self.torus.dirs, self.torus.src
            w = mesh_gossip_dense_equivalent(axes, self_weight, subset)
            self._pads = tuple(self.torus.pads(d) for d in range(len(self.dirs)))
        else:
            self.torus, self.dirs, self._dir_src = None, None, ()
        self.w, w_self, w_off = _split_w_np(w, self.n_nodes)
        rows = slice(self.rows.start, self.rows.stop)
        self.w_self = torch.as_tensor(w_self[rows], device=self.device)
        self.w_off = torch.as_tensor(w_off[rows], device=self.device)
        self._w_full = (torch.as_tensor(w_off, device=self.device),
                        torch.as_tensor(w_self, device=self.device))
        self._bind_programs(self.w, topology_program, node_program)
        self.collectives = 0
        self.collective_bytes = 0
        self.shard_gathers = 0
        self.shard_gather_bytes = 0

    @property
    def pipelined(self) -> bool:
        return self.round_schedule.depth >= 1

    @property
    def staleness_depth(self) -> int:
        return self.round_schedule.depth

    @property
    def _sa_wire(self) -> bool:
        """The circulant wire is the one place a per-edge payload exists,
        so it is the one place the pairwise pads are real."""
        return self.privacy.secure_agg and self.torus is not None

    @property
    def _priv_rng(self) -> bool:
        return self.privacy.dp or self._sa_wire

    def _compact_is_economic(self) -> bool:
        """True when k values + the cheaper index encoding fit in the
        dense int8 chunk (``packing.compact_index_bytes``)."""
        if self.topk is None:
            return False
        return self.topk + compact_index_bytes(self.scale_chunk, self.topk) <= self.scale_chunk

    # -- comm-state contract ----------------------------------------------

    def _wire_key_names(self, suffix: str = "") -> Tuple[str, ...]:
        """One wire's in-flight payload buffers (pipelined only): exactly
        what crosses the wire."""
        if not self.compact_wire:
            names = ("wire_q", "wire_scales")
        elif self.wire_encoding == "bitmap":
            names = ("wire_q", "wire_bits", "wire_scales")
        else:
            names = ("wire_q", "wire_pos", "wire_scales")
        return tuple(n + suffix for n in names)

    def _nbr_key_names(self, suffix: str = "") -> Tuple[str, ...]:
        """The dynamic round's accumulators: one per torus direction on
        the circulant wire (``nbr_recon_{d}``, that neighbor's
        reconstruction), or the all-node replica ``nbr_recon_all`` on the
        all-gather wire; none on a static round, and none without
        difference coding (the neighbour term is then rebuilt from the
        round's wire alone)."""
        if not (self.dynamic_round and self.difference_coding):
            return ()
        if self.torus is None:
            return ("nbr_recon_all" + suffix,)
        return tuple(f"nbr_recon_{d}{suffix}" for d in range(len(self.dirs)))

    def _known_comm_keys(self) -> frozenset:
        wire = ["recon", "residual", "wire_q", "wire_scales", "mix_recon",
                "nbr_recon_all", "wire_pos", "wire_bits"]
        if self.torus is not None:
            wire += [f"nbr_recon_{d}" for d in range(len(self.dirs))]
        return super()._known_comm_keys() | frozenset(
            base + suffix for base in wire for suffix in ("", "_t"))

    def is_derived_comm_key(self, key: str) -> bool:
        """The neighbor accumulators -- ``mix_recon[_t]`` (static) and
        ``nbr_recon_*[_t]`` (under a program) -- are rebuilt from recon
        by :meth:`restore_comm`, so either contract's checkpoint can seed
        the other."""
        return key.startswith("mix_recon") or key.startswith("nbr_recon_")

    def restore_comm(self, comm: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Rebuild the neighbor accumulators from this rank's restored
        tile (from an all-gather-wire, a circulant or a fused checkpoint
        alike: none is carried over). The neighbor-visible reconstruction
        is ``recon`` less every in-flight payload of the ring (the sender
        advanced recon by payloads its neighbors have not mixed yet); it
        is all-gathered over the node group (not wire traffic:
        ``collectives`` does not count it), then ``mix_recon = W_off[rows]
        @ recon_eff`` on a static round, ``nbr_recon_{d}`` its rows of
        each direction's sources or ``nbr_recon_all`` its replica under a
        program. Sequential: ``W_off @ recon``; pipelined: ``W_off @
        (recon - dq(wire))``."""
        self._check_restored_comm_keys(comm)
        comm = {k: v for k, v in comm.items() if not self.is_derived_comm_key(k)}

        def gathered_recon(suffix: str) -> torch.Tensor:
            recon = comm["recon" + suffix].to(torch.float32)
            names = self._wire_key_names(suffix)
            if self.pipelined and all(k in comm for k in names):
                bufs = [comm[k] for k in names]
                if self.staleness_depth <= 1:
                    recon = recon - self._dq_full(bufs)
                else:
                    for j in range(self.staleness_depth):
                        recon = recon - self._dq_full([b[:, j] for b in bufs])
            return all_gather_rows(recon, self.group.wire_pg, self.n_nodes)

        for suffix in ("", "_t") if "recon_t" in comm else ("",):
            if self.dynamic_round and not self._nbr_key_names(suffix):
                continue  # no accumulators without difference coding
            eff = gathered_recon(suffix)
            if not self.dynamic_round:
                comm["mix_recon" + suffix] = self.w_off @ eff
            elif self.torus is None:
                comm["nbr_recon_all" + suffix] = eff[None].expand(
                    (len(self.rows),) + tuple(eff.shape)).clone()
            else:
                mine = slice(self.rows.start, self.rows.stop)
                for d, name in enumerate(self._nbr_key_names(suffix)):
                    src = torch.as_tensor(self._dir_src[d][mine], device=eff.device)
                    comm[name] = eff[src].clone()
        return comm

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's block of a row-split buffer, (R, ..., w / S) ->
        (n, ..., w): the row blocks in node order and, on the two-axis
        layout, the column tiles side by side along the last axis. One
        all-gather of its raw bytes over the whole world, not wire
        traffic."""
        s = self.model_shards
        if s == 1:
            return all_gather_rows(x, self.group.pg, self.n_nodes)
        raw = x.contiguous().view(torch.uint8)
        mid, wb = tuple(raw.shape[1:-1]), raw.shape[-1]
        got = all_gather_rows(raw, self.group.pg, self.group.world * len(self.rows))
        got = got.reshape((self.group.node_ranks, s, len(self.rows)) + mid + (wb,))
        got = got.movedim(1, -2).reshape((self.n_nodes,) + mid + (s * wb,))
        return got.contiguous().view(x.dtype)

    def local_block(self, arr):
        """This rank's block of a whole (n, ..., w) row-split buffer: its
        rows and, on the two-axis layout, its tile of the last axis (the
        inverse of :meth:`gather_rows`; numpy or torch)."""
        arr = arr[self.rows.start:self.rows.stop]
        s = self.model_shards
        if s > 1:
            w = arr.shape[-1] // s
            arr = arr[..., self.group.shard * w:(self.group.shard + 1) * w]
        return arr

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        """The reference's keys: ``mix_recon`` on a static round, the
        per-direction ``nbr_recon_{d}`` (circulant) or ``nbr_recon_all``
        (all-gather) under a program (none without difference coding);
        then the counters."""
        def nbr(suffix):
            if self.dynamic_round:  # none without difference coding
                return self._nbr_key_names(suffix)
            return ("mix_recon" + suffix,)

        keys = ("recon", "residual") + nbr("")
        if self.pipelined:
            keys += self._wire_key_names("")
        if cfg.algorithm == "dsgt":
            keys += ("recon_t", "residual_t") + nbr("_t")
            if self.pipelined:
                keys += self._wire_key_names("_t")
        return keys + self._topo_keys()

    def comm_state_spec(self, cfg: FLConfig):
        """This rank's wire state: (R, t) fp32 recon / residual /
        mix_recon / ``nbr_recon_{d}``, (R, n, t) fp32 ``nbr_recon_all``,
        the in-flight wire buffers, (R, width) at depth 1 and a (R, k,
        width) ring at depth k >= 2 -- t the rank's tile of the wire
        width (``wire_layout.shard_width``); then the counters, whole on
        every rank."""
        r, t = len(self.rows), self.wire_layout.shard_width
        c, depth = t // self.scale_chunk, self.staleness_depth
        topo = self._topo_spec()

        def ring(width, dtype):
            return ((r, width) if depth <= 1 else (r, depth, width)), dtype

        def spec(key):
            if key in topo:
                return topo[key]
            if key.startswith("nbr_recon_all"):
                return (r, self.n_nodes, t), torch.float32
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
        """The dense W this engine realizes (the ``FusedEngine`` oracle):
        the circulant torus's on the default wire, ``w`` otherwise."""
        return self.w

    def _static_round_w(self) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._w_full

    def _edge_bytes(self) -> int:
        """What one neighbor payload costs on this wire: the compact
        encoding, or the dense int8 bytes."""
        return flat_wire_bytes(self.wire_layout, 1, self.scale_chunk,
                               self.topk if self.compact_wire else None)

    def wire_bytes(self, cfg: FLConfig) -> float:
        wires = 2 if cfg.algorithm == "dsgt" else 1
        return float(wires * _degrees(self.w).sum() * self._edge_bytes())

    def _edge_bytes_per_shard(self) -> int:
        """One neighbor payload's cost per (node, shard) tile: the 1/S
        column slice of :meth:`_edge_bytes`."""
        return flat_wire_bytes_per_shard(self.wire_layout, 1, self.scale_chunk,
                                         self.topk if self.compact_wire else None)

    def wire_bytes_per_shard(self, cfg: FLConfig) -> float:
        """The bytes a round moves over one shard's node group: every
        transfer carries one (node, shard) tile, so this is exactly
        ``wire_bytes / model_shards``."""
        wires = 2 if cfg.algorithm == "dsgt" else 1
        return float(wires * _degrees(self.w).sum() * self._edge_bytes_per_shard())

    def check_params(self, cfg: FLConfig, params) -> None:
        if cfg.n_nodes != self.n_nodes:
            raise ValueError(f"cfg.n_nodes {cfg.n_nodes} != the engine's {self.n_nodes} nodes")
        want = (len(self.rows), self.layout.shard_width)
        if not isinstance(params, torch.Tensor) or tuple(params.shape) != want:
            raise ValueError(
                f"the sharded engine's state is this rank's rows of the packed "
                f"buffer (its column tile on the two-axis layout), {want} "
                "(from_group returns them)"
            )
        _check_storage(params, self)

    def _full_rows(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's rows at full width: its tile at S = 1, else one
        all-gather of the S tiles over the model group (counted in
        ``shard_gathers``, not wire traffic)."""
        s = self.model_shards
        if s == 1:
            return x
        got = all_gather_rows(x, self.group.model_pg, s * x.shape[0])
        self.shard_gathers += 1
        self.shard_gather_bytes += x.numel() * x.element_size()
        return got.reshape((s,) + tuple(x.shape)).movedim(0, 1).reshape(
            x.shape[0], s * x.shape[1])

    def make_eval_grads(self, grad_fn):
        """The tree-level ``grad_fn`` on this rank's rows: each round's
        batches carry all n nodes and the rank evaluates its own, on its
        rows gathered to full width; it keeps its tile of the gradient."""
        inner = _make_flat_eval_grads(self.local_layout, grad_fn)
        rows = slice(self.rows.start, self.rows.stop)

        def eval_grads(params: torch.Tensor, batch):
            losses, grads = inner(self._full_rows(params),
                                  {k: v[rows] for k, v in batch.items()})
            if self.model_shards > 1:
                # a copy: a view would keep the full-width gradient alive
                # in prev_grad
                grads = grads[:, self._tile].clone()
            return losses, grads

        return eval_grads

    def params_view(self, params):
        return unpack(self._full_rows(params), self.local_layout)

    def local_step(self, params, grads, alpha, mask=None):
        """The local step on this rank's tile; a node program's step mask
        covers all n nodes (every rank derives it whole), and the rank
        applies its rows of it."""
        if mask is not None:
            mask = mask[self.rows.start:self.rows.stop]
        return super().local_step(params, grads, alpha, mask)

    def global_mean(self, x: torch.Tensor) -> torch.Tensor:
        x = x.detach().clone()
        dist.all_reduce(x, group=self.group.pg)
        return x / self.group.world

    def _round_noises(self, comm: Dict[str, torch.Tensor], rows: range,
                      wires: int) -> Tuple[torch.Tensor, ...]:
        """This rank's tile of the round's noise rows."""
        noises = super()._round_noises(comm, rows, wires)
        if self.model_shards == 1:
            return noises
        return tuple(z[:, self._wire_tile].contiguous() for z in noises)

    # -- the wire ------------------------------------------------------------

    def _truncated(self, q, idx, sc, nrecon, nres, kvec):
        """One wire under a per-node k: :meth:`_hetero_truncate` on the
        kernel's (values, positions) or dense output, what was dropped
        moved from recon' back into res', then the bitmap re-encode.
        Returns (wire buffers, recon', res')."""
        q, ddq = self._hetero_truncate(q, sc, kvec, pos=idx)
        nrecon, nres = nrecon - ddq, nres + ddq
        if idx is None:
            return (q, sc), nrecon, nres
        if self.wire_encoding == "bitmap":
            q, idx = compact_to_bitmap(q, idx, self.scale_chunk, self.topk)
        return (q, idx, sc), nrecon, nres

    def _produce(self, x, g, recon, res, alpha, noises=(), kvec=None):
        """DSGD: ONE wire-stage launch (with this round's DP noise, and the
        per-node k ``kvec`` (R, 1) of a wire-k program) on the shared
        columns of the rank's tile of x and g. Returns (h, wire buffers in
        ``_wire_key_names`` order, recon', res'), all at the wire width."""
        x, g = self._gather_cols(x), self._gather_cols(g)
        kw = dict(_wire_kwargs(self), **self._dp_kwargs(*noises))
        if self.compact_wire:
            # under a per-node k the kernel emits positions: the truncation
            # runs on them, and the bitmap is encoded after it
            bitmap = self.wire_encoding == "bitmap" and kvec is None
            h, q, idx, sc, nrecon, nres = wire_stage_compact(
                x, g, recon, res, alpha, bitmap=bitmap, **kw)
        else:
            h, q, sc, nrecon, nres = wire_stage(x, g, recon, res, alpha, **kw)
            idx = None
        if kvec is not None:
            return (h, *self._truncated(q, idx, sc, nrecon, nres, kvec))
        return h, (q, sc) if idx is None else (q, idx, sc), nrecon, nres

    def _produce_gt(self, x, t, g, gp, rx, sx, rt, st, alpha, noises=(), kvec=None):
        """DSGT: ONE wire-stage launch for both wires, on the shared columns.
        Returns (h, t_half, wire_x, recon_x', res_x', wire_t, recon_t',
        res_t')."""
        x, t, g, gp = (self._gather_cols(b) for b in (x, t, g, gp))
        kw = dict(_wire_kwargs(self), **self._dp_kwargs(*noises))
        if self.compact_wire:
            bitmap = self.wire_encoding == "bitmap" and kvec is None
            (h, th, qx, ix, scx, nrx, nsx, qt, it, sct, nrt, nst) = wire_stage_gt_compact(
                x, t, g, gp, rx, sx, rt, st, alpha, bitmap=bitmap, **kw)
        else:
            (h, th, qx, scx, nrx, nsx, qt, sct, nrt, nst) = wire_stage_gt(
                x, t, g, gp, rx, sx, rt, st, alpha, **kw)
            ix = it = None
        if kvec is not None:
            wire_x, nrx, nsx = self._truncated(qx, ix, scx, nrx, nsx, kvec)
            wire_t, nrt, nst = self._truncated(qt, it, sct, nrt, nst, kvec)
            return h, th, wire_x, nrx, nsx, wire_t, nrt, nst
        wire_x = (qx, scx) if ix is None else (qx, ix, scx)
        wire_t = (qt, sct) if it is None else (qt, it, sct)
        return h, th, wire_x, nrx, nsx, wire_t, nrt, nst

    # -- heterogeneous wire k ------------------------------------------------

    def _hetero_truncate(self, q, scales, kvec, pos=None):
        """Zero all but each row's k_i largest-|q| wire entries a chunk
        (ties to the lower position: two stable argsorts), returning the
        kept values and the dense dequant of what was dropped, which the
        caller moves from the shipped reconstruction back into the
        residual. Runs on the kernel's (values, positions) output before
        any bitmap encoding; every buffer keeps its shape."""
        width = self.topk if pos is not None else self.scale_chunk
        rows = q.shape[0]
        qc = q.reshape(rows, -1, width)
        mag = qc.to(torch.int32).abs()
        rank = torch.argsort(torch.argsort(-mag, dim=-1, stable=True), dim=-1, stable=True)
        keep = rank < kvec.reshape(rows, 1, 1)
        kept = torch.where(keep, qc, 0).reshape(q.shape)
        dropped = torch.where(keep, 0, qc).reshape(q.shape)
        if pos is not None:
            ddq = scatter_compact_dq(dropped, pos, scales, self.scale_chunk,
                                     scales.shape[-1] * self.scale_chunk)
        else:
            ddq = _dequant(dropped, scales, self.scale_chunk)
        return kept, ddq

    def _wire_k_vec(self, comm: Dict[str, torch.Tensor]) -> torch.Tensor:
        """This round's per-node wire k, (n, 1) int32: the node program's
        fraction times topk in fp32, rounded half to even, clipped to
        [1, topk]."""
        frac = self.node_program.wire_k_gate(comm["topo_round"], comm["node_key"])
        k = torch.clamp(torch.round(frac * float(self.topk)), 1, self.topk)
        return k.to(torch.int32).reshape(self.n_nodes, 1)

    def _wire_k_bytes(self, kvec: torch.Tensor, wires: int) -> torch.Tensor:
        """What each node's egress would cost on a k_i-sized wire (the
        buffers that cross stay topk wide): ``flat_wire_bytes``' per-chunk
        boundary with k_i in place of topk, in fp32, summed over the
        nodes, their degrees and the wires."""
        chunk = self.scale_chunk
        n_chunks = self.wire_layout.total // chunk
        k = kvec.reshape(-1).to(torch.float32)
        idx = k * float(torch.iinfo(compact_pos_dtype(chunk)).bits // 8)
        bb = bitmap_bytes_per_chunk(chunk)
        if bb is not None:
            idx = torch.clamp_max(idx, float(bb))
        per_chunk = torch.clamp_max(k + idx + 4.0, float(chunk + 4))
        deg = torch.as_tensor(_degrees(self.dense_equivalent()), dtype=torch.float32,
                              device=k.device)
        return float(wires) * (deg * n_chunks * per_chunk).sum()

    def _all_gather(self, buf: torch.Tensor) -> torch.Tensor:
        """ONE all-gather of a (R, w) wire buffer into (n, w) over the node
        group, moved as its raw bytes."""
        out = all_gather_rows(buf, self.group.wire_pg, self.n_nodes)
        self.collectives += 1
        self.collective_bytes += buf.numel() * buf.element_size()
        return out

    def _transport(self, wire: Sequence[torch.Tensor], d: int, priv,
                   stream_base: int = PAD_STREAM) -> List[torch.Tensor]:
        """ONE direction's transfer of one wire's buffers on the circulant
        wire: each row's payload to its neighbor (``TorusPlan.exchange``);
        under ``secure_agg`` (``priv`` = (priv_key, round)) every buffer
        masked with its edge's pad just before the send and unmasked
        just after the receive -- the pads are a counter hash of the
        undirected pair, so both endpoints derive the same words and
        mask then unmask is the exact identity."""
        if priv is not None:
            key, r = priv
            (pair, lt), (rpair, rlt) = self._pads[d]
            wire = mask_wire(wire, key, r, pair, lt, stream_base=stream_base)
        recv, msgs, nbytes = self.torus.exchange(wire, d)
        self.collectives += msgs
        self.collective_bytes += nbytes
        if priv is not None:
            recv = list(mask_wire(recv, key, r, rpair, rlt, stream_base=stream_base,
                                  unmask=True))
        return recv

    def _priv(self, comm: Dict[str, torch.Tensor]):
        """The pads' (priv_key, round) of this round, or None."""
        return (comm["priv_key"], comm["topo_round"]) if self._sa_wire else None

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

    def _wire_mix(self, wire: Sequence[torch.Tensor], priv=None,
                  stream_base: int = PAD_STREAM) -> torch.Tensor:
        """Move one wire's buffers and return this rank's neighbor term:
        ``sum_d weight_d * dq(recv_d)`` on the circulant wire, ``W_off[rows]
        @ dq_all`` on the all-gather one."""
        if self.torus is None:
            return self.w_off @ self._dq_full([self._all_gather(b) for b in wire])
        acc = None
        for d, (_, _, weight) in enumerate(self.dirs):
            # weight * dq, then the sum, each rounded once (in place: at
            # the LM's (2, 361.8M) a temporary is 2.9 GB)
            term = self._dq_full(self._transport(wire, d, priv, stream_base)).mul_(
                float(np.float32(weight)))
            acc = term if acc is None else acc.add_(term)
        if acc is None:
            return torch.zeros((wire[0].shape[0], wire[-1].shape[-1] * self.scale_chunk),
                               dtype=torch.float32, device=wire[0].device)
        return acc

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

    def _metrics(self, cfg, losses, alpha, grads, new_state: FLState, egress: float):
        """The reference's metrics over all n nodes: one all-reduce of the
        sums, one of the squared deviations from the consensus mean, over
        the whole world. On the two-axis layout each rank adds its tile's
        columns and shard 0 its block's losses. The residual lives at
        the wire width."""
        n, t = self.n_nodes, self.layout.total
        params, res = new_state.params.float(), new_state.comm["residual"]
        head = torch.stack([losses.sum(), res.flatten().dot(res.flatten())])
        g_sum, p_sum = grads.sum(dim=0), params.sum(dim=0)
        if self.model_shards > 1:
            if self.group.shard:
                head[0] = 0.0
            cols = torch.arange(self._tile.start, self._tile.stop, device=g_sum.device)
            g_sum = torch.zeros(t, device=g_sum.device).index_copy_(0, cols, g_sum)
            p_sum = torch.zeros(t, device=p_sum.device).index_copy_(0, cols, p_sum)
        # three all-reduces, no (2 t)-wide concatenation: at the LM's
        # (2, 361.8M) every full-width temporary is 1.45-2.9 GB
        for buf in (head, g_sum, p_sum):
            dist.all_reduce(buf, group=self.group.pg)
        mean_g = g_sum.div_(n)
        dev = params - p_sum.div_(n)[self._tile]
        sq = dev.mul_(dev).sum()
        dist.all_reduce(sq, group=self.group.pg)
        return {
            "loss": head[0] / n,
            "alpha": float(alpha),
            "grad_norm_sq": mean_g.dot(mean_g),
            "consensus_err": sq / n,
            "comm_rounds": 1.0,
            "wire_bytes": egress,
            "ef_residual_rms": torch.sqrt(head[1] / (n * self.wire_layout.total)),
            **self._privacy_metrics(cfg, new_state.step),
        }

    def _check_cfg(self, cfg: FLConfig) -> None:
        if cfg.n_nodes != self.n_nodes:
            raise ValueError(f"cfg.n_nodes {cfg.n_nodes} != the engine's {self.n_nodes} nodes")

    def _accumulate(self, term: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
        """A neighbour accumulator's next value: ``acc + term`` in the
        term's buffer with difference coding (recon' = recon + dq); the
        term alone without it (recon' = dq)."""
        return term.add_(acc) if self.difference_coding else term

    def _comm_body(self, eval_grads, schedule, cfg: FLConfig, state: FLState, batch,
                   mix_add):
        """The static comm step's shared body: this round's gradient, ONE
        wire-stage launch (with this rank's tile of the round's DP noise),
        then the mix against ``mix_recon`` plus ``mix_add(wire, wire_t,
        comm)`` -- this round's moved payload (sequential) or the
        ingested stale one (pipelined). Returns (state, metrics, wire,
        wire_t)."""
        if state.comm is None:
            raise ValueError("fused rounds need init_fl_state(..., engine)")
        step = state.step + 1
        alpha = schedule(step)
        losses, grads = eval_grads(state.params, batch)
        grads = grads.float()
        c = state.comm
        noises = self._round_noises(c, self.rows, 2 if cfg.algorithm == "dsgt" else 1)
        priv = self._priv_comm(c)
        if cfg.algorithm == "dsgd":
            h, wire, nrecon, nres = self._produce(
                state.params.float(), grads, c["recon"], c["residual"], alpha, noises)
            # mix_recon' = mix_recon + the neighbor term, in the term's
            # buffer (without difference coding the term alone)
            new_mix = self._accumulate(mix_add(wire, None, c)[0], c["mix_recon"])
            # w_self * h + mix_recon', in place on the kernel's output h
            new_state = state._replace(
                step=step, params=self._st(self._scope_finish(
                    h.mul_(self.w_self[:, None]).add_(new_mix), state.params, grads, alpha)),
                comm={"recon": nrecon, "residual": nres, "mix_recon": new_mix, **priv})
            wire_t = None
        else:
            (h, th, wire, nrx, nsx, wire_t, nrt, nst) = self._produce_gt(
                state.params.float(), state.tracker.float(), grads,
                state.prev_grad.float(), c["recon"], c["residual"], c["recon_t"],
                c["residual_t"], alpha, noises)
            add_x, add_t = mix_add(wire, wire_t, c)
            new_mrx = self._accumulate(add_x, c["mix_recon"])
            new_mrt = self._accumulate(add_t, c["mix_recon_t"])
            mixed_x, mixed_t = self._scope_finish_gt(
                h.mul_(self.w_self[:, None]).add_(new_mrx),
                th.mul_(self.w_self[:, None]).add_(new_mrt),
                state.params, state.tracker, grads, state.prev_grad, alpha)
            new_state = FLState(
                step=step, params=self._st(mixed_x), tracker=self._st(mixed_t),
                prev_grad=self._st(grads),
                comm={"recon": nrx, "residual": nsx, "mix_recon": new_mrx,
                      "recon_t": nrt, "residual_t": nst, "mix_recon_t": new_mrt, **priv})
        return new_state, (cfg, losses, alpha, grads), wire, wire_t

    def _make_dynamic_round(self, eval_grads, schedule, cfg: FLConfig):
        """The round under a topology or node program, every schedule
        (the reference's ``_make_dynamic_round`` and
        ``_make_dynamic_round_dense``): the round's realized W_r from the
        counters, ONE wire-stage launch (with the per-node k of a wire-k
        program and the DP noise), the same transfers as the static
        round of this round's payload (sequential) or the ring's oldest
        (pipelined, bounded staleness), folded into the unweighted
        neighbor accumulators, then ``mixed = W_r_diag[rows] * h +
        sum_d W_r[i, src_d(i)] * nbr_recon_{d}`` (circulant) or
        ``W_r_off[rows] @ nbr_recon_all`` (all-gather) -- equal, up to
        summation order, to ``FusedEngine`` under the same programs (its
        ``stale_mix`` on the pipelined schedule). Returns
        ``comm_step(state, batch)``."""
        self._check_cfg(cfg)
        egress = self.wire_bytes(cfg)
        pipelined = self.pipelined
        wires = 2 if cfg.algorithm == "dsgt" else 1
        wk = self.node_program.heterogeneous_wire_k
        keys, keys_t = self._wire_key_names(""), self._wire_key_names("_t")
        nbr_keys, nbr_keys_t = self._nbr_key_names(""), self._nbr_key_names("_t")
        rows = slice(self.rows.start, self.rows.stop)
        t_stream = PAD_STREAM + TRACKER_STREAM_OFFSET
        srcs = tuple(torch.as_tensor(src[rows], device=self.device) for src in self._dir_src)

        def comm_step(state: FLState, batch):
            if state.comm is None:
                raise ValueError("fused rounds need init_fl_state(..., engine)")
            step = state.step + 1
            alpha = schedule(step)
            losses, grads = eval_grads(state.params, batch)
            grads = grads.float()
            c = state.comm
            w_off_r, w_diag_r, topo_comm, gate_metrics = self._round_gates(c)
            w_rows, ddiag = w_off_r[rows], w_diag_r[rows][:, None]
            kvec = self._wire_k_vec(c) if wk else None
            kw = dict(noises=self._round_noises(c, self.rows, wires),
                      kvec=None if kvec is None else kvec[rows])
            priv = self._priv(c)

            def mix_one(wire, wire_keys, nbr_names, stream_base):
                # without difference coding there are no accumulators
                # (nbr_names is empty): each neighbour's recon is its dq
                src = self._ring_slot0(c, wire_keys) if pipelined else wire
                if self.torus is None:
                    dq_all = self._dq_full([self._all_gather(b) for b in src])
                    if not nbr_names:
                        return w_rows @ dq_all, {}
                    new_all = c[nbr_names[0]] + dq_all
                    return (torch.bmm(w_rows[:, None, :], new_all)[:, 0],
                            {nbr_names[0]: new_all})
                mix, new = None, {}
                for d in range(len(self.dirs)):
                    nb = self._dq_full(self._transport(src, d, priv, stream_base))
                    if nbr_names:
                        nb = c[nbr_names[d]] + nb
                        new[nbr_names[d]] = nb
                    # dgate[i, d] = W_r[i, src_d(i)]: zero for a link that is down
                    term = w_rows.gather(1, srcs[d][:, None]) * nb
                    mix = term if mix is None else mix + term
                return mix, new

            if cfg.algorithm == "dsgd":
                h, wire, nrecon, nres = self._produce(
                    state.params.float(), grads, c["recon"], c["residual"], alpha, **kw)
                mix, nbr = mix_one(wire, keys, nbr_keys, PAD_STREAM)
                comm = {"recon": nrecon, "residual": nres, **nbr, **topo_comm}
                new_state = state._replace(
                    step=step, params=self._st(self._scope_finish(
                        ddiag * h + mix, state.params, grads, alpha)), comm=comm)
                pushes = ((keys, wire),)
            else:
                (h, th, wire, nrx, nsx, wire_t, nrt, nst) = self._produce_gt(
                    state.params.float(), state.tracker.float(), grads,
                    state.prev_grad.float(), c["recon"], c["residual"], c["recon_t"],
                    c["residual_t"], alpha, **kw)
                mix_x, nbr_x = mix_one(wire, keys, nbr_keys, PAD_STREAM)
                mix_t, nbr_t = mix_one(wire_t, keys_t, nbr_keys_t, t_stream)
                comm = {"recon": nrx, "residual": nsx, **nbr_x,
                        "recon_t": nrt, "residual_t": nst, **nbr_t, **topo_comm}
                mixed_x, mixed_t = self._scope_finish_gt(
                    ddiag * h + mix_x, ddiag * th + mix_t, state.params, state.tracker,
                    grads, state.prev_grad, alpha)
                new_state = FLState(step=step, params=self._st(mixed_x),
                                    tracker=self._st(mixed_t), prev_grad=self._st(grads),
                                    comm=comm)
                pushes = ((keys, wire), (keys_t, wire_t))
            if pipelined:
                for wire_keys, vals in pushes:
                    self._push_wire(c, comm, wire_keys, vals)
            metrics = self._metrics(cfg, losses, alpha, grads, new_state, egress)
            metrics.update(gate_metrics)
            if wk:
                metrics["wire_bytes_effective"] = self._wire_k_bytes(kvec, wires)
            return new_state, metrics

        return comm_step

    def make_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        """The sequential round: produce, move, mix in the same step."""
        if self.dynamic_round:
            return self._make_dynamic_round(eval_grads, schedule, cfg)
        self._check_cfg(cfg)
        egress = self.wire_bytes(cfg)
        t_stream = PAD_STREAM + TRACKER_STREAM_OFFSET

        def moved(wire, wire_t, comm):
            priv = self._priv(comm)
            return (self._wire_mix(wire, priv),
                    None if wire_t is None else self._wire_mix(wire_t, priv, t_stream))

        def comm_step(state: FLState, batch):
            new_state, m, _, _ = self._comm_body(eval_grads, schedule, cfg, state,
                                                 batch, moved)
            return new_state, self._metrics(*m, new_state, egress)

        return comm_step

    def make_pipelined_round(self, eval_grads, schedule, cfg: FLConfig):
        """The split round: ``ingest`` moves the OLDEST in-flight payload
        (nothing it reads depends on this round's compute, so it runs
        before the local steps; the pads use the round counter both
        endpoints hold) and returns its neighbor term; ``comm_step``
        produces this round's payload (stored for a later round), folds
        the ingested term into ``mix_recon`` and mixes -- k-round-stale
        neighbor information. Under a program the neighbor term is
        weighted by this round's W_r, so the transfer moves into the comm
        step (:meth:`_make_dynamic_round`) and there is no ingest."""
        if not self.pipelined:
            raise ValueError(
                "engine was built with round_schedule='sequential'; build "
                "it with round_schedule='pipelined'"
            )
        if self.dynamic_round:
            comm_step = self._make_dynamic_round(eval_grads, schedule, cfg)
            return None, lambda state, batch, stale: comm_step(state, batch)
        self._check_cfg(cfg)
        egress = self.wire_bytes(cfg)
        keys, keys_t = self._wire_key_names(""), self._wire_key_names("_t")
        t_stream = PAD_STREAM + TRACKER_STREAM_OFFSET

        def ingest(state: FLState):
            if state.comm is None or keys[0] not in state.comm:
                raise ValueError(
                    "pipelined rounds need init_fl_state(..., engine=...) "
                    "with the pipelined engine (in-flight wire buffers)"
                )
            priv = self._priv(state.comm)
            stale = {"mix": self._wire_mix(self._ring_slot0(state.comm, keys), priv)}
            if cfg.algorithm == "dsgt":
                stale["mix_t"] = self._wire_mix(self._ring_slot0(state.comm, keys_t), priv,
                                                t_stream)
            return stale

        def comm_step(state: FLState, batch, stale):
            new_state, m, wire, wire_t = self._comm_body(
                eval_grads, schedule, cfg, state, batch,
                lambda wire, wire_t, comm: (stale["mix"], stale.get("mix_t")))
            comm = dict(new_state.comm)
            self._push_wire(state.comm, comm, keys, wire)
            if wire_t is not None:
                self._push_wire(state.comm, comm, keys_t, wire_t)
            new_state = new_state._replace(comm=comm)
            return new_state, self._metrics(*m, new_state, egress)

        return ingest, comm_step

    def pack_state(self, stacked_params) -> torch.Tensor:
        """This rank's block (rows, and its tile) of the node-stacked
        params packed into the engine's layout, on the group's device:
        the state ``init_fl_state`` takes."""
        flat = pack_like(stacked_params, self.layout)
        return _own_block(self.local_block(flat).to(self.device))

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
        ``scale_chunk`` times the group's model shards, stored in
        ``storage_dtype``, fp32 by default) and build the engine for this
        rank of ``group``: the circulant torus over the group's node axes
        unless ``w=`` names a dense W (``self_weight``, ``axes_subset``
        shape the torus), the two-axis layout with ``model_axis``.
        Returns (engine, this rank's block of the flat buffer on the
        group's device) -- the state ``init_fl_state`` takes.

        The single-process counterparts over the same node torus:
        ``FusedEngine.from_node_axes`` (the torus's dense equivalent, the
        oracle) and ``TreeEngine.from_group`` / ``FlatEngine.from_group``
        (the exact wire through ``core.mixing``'s mesh backends)."""
        storage_dtype = kw.pop("storage_dtype", None)
        flat, layout = pack(stacked_params, pad_to=scale_chunk,
                            buffer_dtype=storage_dtype or torch.float32,
                            shards=group.model_shards)
        engine = cls(group, layout, scale_chunk=scale_chunk, **kw)
        return engine, _own_block(engine.local_block(flat).to(group.device))
