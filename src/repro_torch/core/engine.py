"""GossipEngine protocol and the fused round engine (counterpart of the
slice of ``repro.core.engine`` the main path runs).

An engine owns the state representation, the wire and the mixing:

    init_comm_state(cfg, params)  extra wire state carried in FLState.comm
    local_step(params, grads, a)  the SGD update in the engine's own
                                  state representation
    make_eval_grads(loss_fn)      per-node losses and gradients in that
                                  representation
    make_comm_step(...)           the whole communication step
    wire_bytes(cfg)               per-round egress accounting (all nodes)

Engines register by name (:func:`register_engine`); the registry is the
one list of names every entry point resolves. The port has one engine so
far, ``fused``: the state is one packed ``(nodes, total)`` fp32 buffer
and every communication round is ONE call of a round megakernel
(``kernels.gossip``: local update + int8 difference-coded quantize with
error feedback + the W mix), on the sequential round schedule.

Everything outside that slice -- top-k wires, other round schedules,
topology and node programs, privacy, federation scopes, bf16 storage --
raises ``NotImplementedError`` naming its ROADMAP.md item.
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
    tree_map,
)
from repro_torch.core.packing import (
    FlatLayout,
    flat_wire_bytes,
    pack,
    tree_leaves,
    unpack,
)
from repro_torch.device import resolve_device
from repro_torch.kernels.gossip.ops import fused_round, fused_round_gt

__all__ = [
    "GossipEngine",
    "FusedEngine",
    "SequentialSchedule",
    "register_engine",
    "get_engine",
    "engine_names",
]


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue 1, item {item})"
    )


def _as_device_batch(batches, device: torch.device) -> Dict[str, torch.Tensor]:
    """One host-to-device copy of a round's batches (numpy or tensors)."""
    return {k: torch.as_tensor(v, device=device) for k, v in batches.items()}


def _assemble_round(cfg: FLConfig, local_step, comm_step, device):
    """The round body: (Q-1) local steps in a Python loop (the reference
    scans them), then the comm step on the last batch."""

    def round_fn(state: FLState, batches):
        batches = _as_device_batch(batches, device)
        q = cfg.q
        local_losses = []
        for k in range(q - 1):
            state, loss = local_step(state, {n: b[k] for n, b in batches.items()})
            local_losses.append(loss)
        state, metrics = comm_step(state, {n: b[q - 1] for n, b in batches.items()})
        metrics["local_loss"] = (
            torch.stack(local_losses).mean() if local_losses else metrics["loss"]
        )
        return state, metrics

    return round_fn


class SequentialSchedule:
    """The paper's round layout: (Q-1) local steps, then ONE comm step in
    which the payload is produced and mixed before the round returns."""

    name = "sequential"
    depth = 0

    def build_round(self, engine, eval_grads, schedule, cfg, local_step):
        comm_step = engine.make_comm_step(eval_grads, schedule, cfg)
        return _assemble_round(cfg, local_step, comm_step, engine.device)


SEQUENTIAL = SequentialSchedule()


def _flat_value_and_grad(layout: FlatLayout, loss_fn):
    """Per-node losses and the gradient IN the flat layout: autograd
    through ``unpack``'s column slices scatters each leaf's gradient into
    its columns and leaves the padding exactly zero."""

    def eval_grads(params: torch.Tensor, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        flat = params.detach().requires_grad_(True)
        with torch.enable_grad():
            losses = loss_fn(unpack(flat, layout), batch)
            (grad,) = torch.autograd.grad(losses.sum(), flat)
        return losses.detach(), grad.contiguous()

    return eval_grads


class GossipEngine(abc.ABC):
    """One round engine: state representation + wire + mixing semantics.
    Subclasses set ``name`` (the registry key), ``layout`` (the
    :class:`FlatLayout` of flat-state engines), ``device``, and implement
    :meth:`make_comm_step`."""

    name: ClassVar[str] = "abstract"
    layout: Optional[FlatLayout] = None
    round_schedule: SequentialSchedule = SEQUENTIAL
    device: torch.device

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        """Names of the engine's wire-state buffers in ``FLState.comm``."""
        return ()

    def init_comm_state(self, cfg: FLConfig, params) -> Optional[Dict[str, torch.Tensor]]:
        """Zero-initialized (n, total) fp32 wire state: zeros mean the
        first round effectively transmits the full parameters."""
        keys = self.comm_keys(cfg)
        if not keys:
            return None
        shape = (cfg.n_nodes, self.layout.total)
        return {k: torch.zeros(shape, dtype=torch.float32, device=self.device)
                for k in keys}

    def local_step(self, params, grads, alpha):
        """Eq. 4 in the engine's representation: ``p - alpha * g`` as two
        rounded fp32 operations (alpha an fp32 scalar)."""
        a = torch.as_tensor(alpha, dtype=torch.float32)
        return tree_map(lambda p, g: p - a * g, params, grads)

    def wire_bytes(self, cfg: FLConfig) -> Optional[float]:
        """Per-round egress summed over all nodes (None: not accounted)."""
        return None

    def check_params(self, cfg: FLConfig, params) -> None:
        """Validate the initial state representation: node-stacked."""
        for _, leaf in tree_leaves(params):
            if tuple(leaf.shape[:1]) != (cfg.n_nodes,):
                raise ValueError(
                    f"param leaf {tuple(leaf.shape)} is not node-stacked for "
                    f"n={cfg.n_nodes}"
                )

    def make_eval_grads(self, loss_fn):
        """``eval_grads(params, batch) -> (losses (n,), grads)`` in the
        engine's representation."""
        if self.layout is None:
            raise _not_ported("tree-state engines", "3")
        return _flat_value_and_grad(self.layout, loss_fn)

    def params_view(self, params):
        """The tree view of the engine's parameter state."""
        return params if self.layout is None else unpack(params, self.layout)

    @abc.abstractmethod
    def make_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        """``comm_step(state, batch) -> (state, metrics)``."""


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


def _refuse_unported(topk, round_schedule, topology_program, node_program,
                     privacy, scope, storage_dtype) -> None:
    if topk is not None:
        raise _not_ported("the top-k wire", "6")
    if round_schedule not in (None, "sequential", SEQUENTIAL):
        raise _not_ported(f"round schedule {round_schedule!r}", "9")
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


@register_engine
class FusedEngine(GossipEngine):
    """The round megakernel on a dense W: local update + int8 quantize +
    W-row mix + error feedback, ONE kernel call per comm round
    (``kernels.gossip.fused_round`` / ``fused_round_gt``). On CPU tensors
    the kernel wrappers run their PyTorch twins."""

    name = "fused"

    def __init__(self, w: np.ndarray, layout: FlatLayout, *,
                 scale_chunk: int = 512, device=None, topk=None,
                 round_schedule=None, topology_program=None,
                 node_program=None, privacy=None, scope=None,
                 storage_dtype=None):
        _refuse_unported(topk, round_schedule, topology_program, node_program,
                         privacy, scope, storage_dtype)
        if scale_chunk < 1:
            raise ValueError("scale_chunk must be >= 1")
        if layout.total % scale_chunk:
            raise ValueError(
                f"layout.total {layout.total} not a multiple of scale_chunk "
                f"{scale_chunk}; pack with pad_to={scale_chunk}"
            )
        self.layout = layout
        self.scale_chunk = scale_chunk
        self.device = resolve_device(device)
        self.w, w_self, w_off = _split_w_np(w, layout.n_nodes)
        self.w_self = torch.as_tensor(w_self, device=self.device)
        self.w_off = torch.as_tensor(w_off, device=self.device)

    def comm_keys(self, cfg: FLConfig) -> Tuple[str, ...]:
        keys = ("recon", "residual")
        if cfg.algorithm == "dsgt":
            keys += ("recon_t", "residual_t")
        return keys

    def wire_bytes(self, cfg: FLConfig) -> float:
        wires = 2 if cfg.algorithm == "dsgt" else 1
        edge = flat_wire_bytes(self.layout, 1, self.scale_chunk)
        return float(wires * _degrees(self.w).sum() * edge)

    def check_params(self, cfg: FLConfig, params) -> None:
        if not isinstance(params, torch.Tensor) or params.ndim != 2:
            raise ValueError(
                f"the {self.name!r} engine state must be the packed "
                "(nodes, total) flat buffer (core.packing.pack)"
            )
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

    def make_comm_step(self, eval_grads, schedule, cfg: FLConfig):
        # the wire is always difference-coded with error feedback (the
        # kernels' defaults); no caller needs another wire yet
        kw = dict(scale_chunk=self.scale_chunk)
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
            res = new_state.comm["residual"]
            metrics = {
                "loss": losses.mean(),
                "alpha": float(alpha),
                "grad_norm_sq": _mean_grad_norm_sq(grads),
                "consensus_err": _consensus_error(new_state.params),
                "comm_rounds": 1.0,
                "wire_bytes": egress,
                "ef_residual_rms": torch.sqrt((res * res).mean()),
            }
            return new_state, metrics

        return comm_step

    @classmethod
    def simulated(cls, w: np.ndarray, stacked_params, *, scale_chunk: int = 512,
                  **kw) -> Tuple["FusedEngine", torch.Tensor]:
        """Pack node-stacked params (padded to ``scale_chunk``) and build
        the engine on their device. Returns (engine, flat buffer)."""
        flat, layout = pack(stacked_params, pad_to=scale_chunk)
        return cls(w, layout, scale_chunk=scale_chunk, device=flat.device,
                   **kw), flat
