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

Three engines are ported:

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
  depth k >= 2.

The exact-wire engines are sequential-only and refuse top-k and partial
federation scopes, as the reference's do. Everything outside the ported
slice -- topology and node programs, privacy, federation scopes on the
fused engine, bf16 storage, the mesh builds -- raises
``NotImplementedError`` naming its ROADMAP.md item.
"""

from __future__ import annotations

import abc
from typing import ClassVar, Dict, Optional, Tuple, Type

import numpy as np
import torch

from repro_torch.core.fl import (
    FLConfig,
    FLState,
    _consensus_error,
    _mean_grad_norm_sq,
    check_node_stacked,
    tree_map,
)
from repro_torch.core.mixing import make_dense_flat_mix, make_dense_gossip
from repro_torch.core.packing import (
    FlatLayout,
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
    wire_stage_gt,
)

__all__ = [
    "GossipEngine",
    "TreeEngine",
    "FlatEngine",
    "FusedEngine",
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


def _assemble_round(cfg: FLConfig, local_step, comm_call, device, pre_scan=None):
    """The round body: the optional pre-scan hook (a schedule's ingest of
    the in-flight payload; the fused engine has none), (Q-1) local steps
    in a Python loop (the reference scans them), then
    ``comm_call(state, batch, aux)`` on the last batch with whatever the
    hook returned."""

    def round_fn(state: FLState, batches):
        aux = pre_scan(state) if pre_scan is not None else None
        batches = _as_device_batch(batches, device)
        q = cfg.q
        local_losses = []
        for k in range(q - 1):
            state, loss = local_step(state, {n: b[k] for n, b in batches.items()})
            local_losses.append(loss)
        state, metrics = comm_call(state, {n: b[q - 1] for n, b in batches.items()},
                                   aux)
        metrics["local_loss"] = (
            torch.stack(local_losses).mean() if local_losses else metrics["loss"]
        )
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
                               engine.device)


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
        return _assemble_round(cfg, local_step, comm_step, engine.device,
                               pre_scan=ingest)


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
    2/3) or override :meth:`make_comm_step` (the fused engine)."""

    name: ClassVar[str] = "abstract"
    layout: Optional[FlatLayout] = None
    round_schedule: RoundSchedule = _SCHEDULES["sequential"]
    device: torch.device

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        """Names of the engine's wire-state buffers in ``FLState.comm``."""
        return ()

    def comm_state_spec(self, cfg: FLConfig) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
        """``{key: (shape, dtype)}`` of the wire-state buffers: (n, total)
        fp32 unless an engine says otherwise."""
        keys = self.comm_keys(cfg)
        if not keys:
            return {}
        shape = (cfg.n_nodes, self.layout.total)
        return {k: (shape, torch.float32) for k in keys}

    def init_comm_state(self, cfg: FLConfig, params) -> Optional[Dict[str, torch.Tensor]]:
        """Zero-initialized wire state (:meth:`comm_state_spec`): zeros
        mean the first round effectively transmits the full parameters
        and the in-flight ring starts empty; None for an exact wire."""
        spec = self.comm_state_spec(cfg)
        if not spec:
            return None
        return {k: torch.zeros(shape, dtype=dtype, device=self.device)
                for k, (shape, dtype) in spec.items()}

    def local_step(self, params, grads, alpha):
        """Eq. 4 in the engine's representation: ``p - alpha * g`` as two
        rounded fp32 operations (alpha an fp32 scalar)."""
        a = torch.as_tensor(alpha, dtype=torch.float32)
        return tree_map(lambda p, g: p - a * g, params, grads)

    def mix(self, buf):
        """Exact-wire W application (theta <- W theta) on the engine's
        state representation. The fused engine has no standalone mix: its
        W lives inside the comm-step kernel."""
        raise NotImplementedError(
            f"{type(self).__name__} mixes inside its fused comm step"
        )

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
        ``comm_step(state, batch) -> (state, metrics)``."""
        wire = self.wire_bytes(cfg)

        def comm_step(state: FLState, batch):
            step = state.step + 1
            alpha = schedule(step)
            a = torch.as_tensor(alpha, dtype=torch.float32)
            losses, grads = eval_grads(state.params, batch)

            def adapt(wp, t):
                return wp - a * t

            if cfg.algorithm == "dsgd":
                params = tree_map(adapt, self.mix(state.params), grads)
                new_state = state._replace(step=step, params=params)
            else:
                tracker = tree_map(lambda wt, gn, gp: wt + gn - gp,
                                   self.mix(state.tracker), grads, state.prev_grad)
                params = tree_map(adapt, self.mix(state.params), tracker)
                new_state = state._replace(step=step, params=params,
                                           tracker=tracker, prev_grad=grads)
            metrics = {
                "loss": losses.mean(),
                "alpha": float(alpha),
                "grad_norm_sq": _mean_grad_norm_sq(grads),
                "consensus_err": _consensus_error(new_state.params),
                "comm_rounds": 1.0,
            }
            if wire is not None:
                metrics["wire_bytes"] = wire
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


def _refuse_unported(topology_program, node_program, privacy, scope,
                     storage_dtype) -> None:
    if topology_program not in (None, "static"):
        raise _not_ported(f"topology program {topology_program!r}", "10")
    if node_program not in (None, "homogeneous"):
        raise _not_ported(f"node program {node_program!r}", "11")
    if privacy not in (None, "none"):
        raise _not_ported(f"privacy spec {privacy!r}", "12")
    if scope not in (None, "full"):
        raise _not_ported(f"federation scope {scope!r}", "13")
    if storage_dtype not in (None, "float32", torch.float32):
        raise _not_ported(f"{storage_dtype} flat storage", "5")


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
        _refuse_unported(topology_program, node_program, privacy, None,
                         storage_dtype)
        leaf = tree_leaves(stacked_params)[0][1]
        return cls(make_dense_gossip(w, wire_dtype), device=leaf.device), stacked_params


@register_engine
class FlatEngine(GossipEngine):
    """The state is ONE packed ``(nodes, total)`` buffer end to end,
    mixed by a flat-native backend (``core.mixing.make_dense_flat_mix``:
    one product per round, whatever the number of leaves)."""

    name = "flat"

    def __init__(self, mix_fn, layout: FlatLayout, device=None):
        self._mix = mix_fn
        self.layout = layout
        self.device = resolve_device(device)

    def mix(self, flat: torch.Tensor) -> torch.Tensor:
        return self._mix(flat)

    def check_params(self, cfg: FLConfig, params) -> None:
        _check_flat_params(cfg, params, self.name)

    @classmethod
    def simulated(cls, w: np.ndarray, stacked_params, *, scale_chunk: int = 1,
                  wire_dtype=None, topk=None, round_schedule=None,
                  storage_dtype=None, topology_program=None, node_program=None,
                  privacy=None, scope=None,
                  **_ignored) -> Tuple["FlatEngine", torch.Tensor]:
        """Pack node-stacked params (padded to ``scale_chunk``) and build
        the engine on their device. Returns (engine, flat buffer)."""
        _refuse_exact_wire(cls.name, topk, round_schedule, scope)
        _refuse_unported(topology_program, node_program, privacy, None,
                         storage_dtype)
        flat, layout = pack(stacked_params, pad_to=scale_chunk)
        return cls(make_dense_flat_mix(w, wire_dtype), layout,
                   device=flat.device), flat


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
        _refuse_unported(topology_program, node_program, privacy, scope,
                         storage_dtype)
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
        return keys

    def comm_state_spec(self, cfg: FLConfig):
        """Wire state: (n, total) fp32 recon / residual, and the ring of
        int8 payloads (n, ring, total) with their fp32 scales
        (n, ring, total // scale_chunk)."""
        n, t, rd = cfg.n_nodes, self.layout.total, self._ring_depth()

        def spec(key):
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
            if cfg.algorithm == "dsgd":
                mixed, recon, res, _ = fused_round(
                    state.params, grads, c["recon"], c["residual"],
                    self.w_off, self.w_self, alpha, **kw,
                )
                new_state = state._replace(
                    step=step, params=mixed,
                    comm={"recon": recon, "residual": res},
                )
            else:
                mx, mt, nrx, nsx, nrt, nst, _, _ = fused_round_gt(
                    state.params, state.tracker, grads, state.prev_grad,
                    c["recon"], c["residual"], c["recon_t"], c["residual_t"],
                    self.w_off, self.w_self, alpha, **kw,
                )
                new_state = FLState(
                    step=step, params=mx, tracker=mt, prev_grad=grads,
                    comm={"recon": nrx, "residual": nsx,
                          "recon_t": nrt, "residual_t": nst},
                )
            return new_state, self._metrics(losses, alpha, grads, new_state, egress)

        return comm_step

    def _make_bounded_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        """The depth-k (k >= 2) round: ONE wire-stage kernel call, then the
        mix -- plain PyTorch, fp32, in the reference's order -- against
        the k-round-STALE reconstruction recovered from the in-flight ring
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

        def mix(nbr, h):
            return self.w_off @ nbr + self.w_self[:, None] * h

        def comm_step(state: FLState, batch):
            if state.comm is None:
                raise ValueError("fused rounds need init_fl_state(..., engine)")
            step = state.step + 1
            alpha = schedule(step)
            losses, grads = eval_grads(state.params, batch)
            c = state.comm
            if cfg.algorithm == "dsgd":
                h, q, sc, nrecon, nres = wire_stage(
                    state.params, grads, c["recon"], c["residual"], alpha, **kw)
                mixed = mix(stale_recon(c["recon"], c["wire_q"], c["wire_scales"]), h)
                nwq, nwsc = push(c["wire_q"], c["wire_scales"], q, sc)
                new_state = state._replace(
                    step=step, params=mixed,
                    comm={"recon": nrecon, "residual": nres,
                          "wire_q": nwq, "wire_scales": nwsc},
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
                          "wire_q_t": nwqt, "wire_scales_t": nwsct},
                )
            return new_state, self._metrics(losses, alpha, grads, new_state, egress)

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
