"""End-to-end decentralized-FL training driver (counterpart of
``repro.training.trainer``).

Runs the paper's Algorithm 1 on one device: nodes live on the leading
tensor axis, mixing through the registry engine the caller names. The
default ``tree`` engine gossips the parameter tree exactly through the
dense W (the paper's Fig. 2 runs); ``flat`` does the same on the packed
buffer; on ``fused`` every communication round is one kernel call, on
the sequential, pipelined or bounded-staleness schedule, with the dense
or top-k int8 wire and adaptive k (:class:`AdaptiveTopK`). A topology
program (the graph changing from round to round) and a node program
(stragglers, dropped payloads) run on ``flat`` and ``fused``; a
federation scope (private per-hospital heads) on ``fused``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import FLRunConfig
from repro_torch.core.engine import GossipEngine, get_engine
from repro_torch.core.fl import FLConfig, FLState, init_fl_state, make_fl_round, tree_map
from repro_torch.core.packing import tree_leaves
from repro_torch.core.schedules import (
    constant,
    inv_sqrt,
    robust_alpha_scale,
    scaled,
    theorem1_schedule,
)
from repro_torch.core.topology import check_assumption1, mixing_matrix
from repro_torch.device import resolve_device
from repro_torch.training.metrics import MetricHistory, comm_bytes_per_gossip

Tree = Any

__all__ = ["AdaptiveTopK", "TrainResult", "train_decentralized", "make_schedule",
           "stack_for_nodes", "stack_batches"]


class AdaptiveTopK:
    """Error-triggered wire densification: the one owner of the
    adaptive-k round-to-round logic (the trainer and the EHR example use
    it).

    Spec ``(k_sparse, k_dense, densify_high[, resparsify_low])``: rounds
    run the sparse wire until the ``ef_residual_rms`` metric (the mass
    the wire is deferring) crosses ``densify_high``; then the densified
    twin runs (``dense_topk`` is None -- plain dense int8 -- when k_dense
    covers the whole scale chunk) until the residual drains BELOW
    ``resparsify_low`` (default ``densify_high / 2``). The two thresholds
    are a hysteresis band, so k does not flap around one line.

    Build both round functions up front (the comm state does not depend
    on k, so they advance the same state), then per round:

        fn = ctl.pick(sparse_fn, dense_fn)
        state, m = fn(state, batches)        # ctl.current_k ran this round
        ctl.update(float(m["ef_residual_rms"]))
    """

    def __init__(self, spec, scale_chunk: int):
        if len(spec) == 3:
            k_sparse, k_dense, high = spec
            low = float(high) / 2.0
        else:
            k_sparse, k_dense, high, low = spec
        self.k_sparse = int(k_sparse)
        self.k_dense = int(k_dense)
        self.threshold = float(high)  #: densify when rms exceeds this
        self.low = float(low)  #: re-sparsify only when rms drains below
        if not (0.0 < self.low <= self.threshold):
            raise ValueError(
                f"hysteresis band needs 0 < low <= high, got "
                f"low={self.low}, high={self.threshold}"
            )
        #: topk= for the densified twin engine (None = dense int8)
        self.dense_topk = None if self.k_dense >= scale_chunk else self.k_dense
        self._use_dense = False
        self.rounds = 0
        self.dense_rounds = 0
        self.switches = 0

    @property
    def current_k(self) -> int:
        """The k THIS round ships (valid until :meth:`update` is called)."""
        return self.k_dense if self._use_dense else self.k_sparse

    def pick(self, sparse_fn, dense_fn):
        return dense_fn if self._use_dense else sparse_fn

    def update(self, ef_residual_rms: float) -> None:
        """Account the round just run and arm the next one: densify above
        high, re-sparsify below low, hold the current wire in between."""
        self.rounds += 1
        self.dense_rounds += int(self._use_dense)
        if self._use_dense:
            use_dense = ef_residual_rms >= self.low
        else:
            use_dense = ef_residual_rms > self.threshold
        self.switches += int(use_dense != self._use_dense)
        self._use_dense = use_dense


@dataclasses.dataclass
class TrainResult:
    state: FLState
    history: MetricHistory
    consensus: Tree
    w: np.ndarray
    engine: GossipEngine = None  # the engine the run trained with


def make_schedule(run: FLRunConfig):
    if run.schedule == "inv_sqrt":
        return inv_sqrt(run.alpha0)
    if run.schedule == "constant":
        return constant(run.alpha0)
    if run.schedule == "theorem1":
        return theorem1_schedule(run.n_nodes, run.alpha0)
    raise ValueError(f"unknown schedule {run.schedule!r}")


def stack_for_nodes(params: Tree, n_nodes: int, perturb: float = 0.0,
                    generator: Optional[torch.Generator] = None) -> Tree:
    """Replicate one node's params across the node axis (identical init;
    optional per-node perturbation for consensus-dynamics experiments).

    ``perturb > 0`` adds ``perturb * N(0, 1)`` to every stacked leaf, drawn
    in fp32 from ``generator`` (a fresh one seeded 0 when None; on the
    leaves' device), leaf by leaf in the tree's order, rounded to the
    leaf's dtype before the scale, as the reference does. The reference draws from ``jax.random``, whose bits a
    torch generator cannot give: carry a reference init across with
    ``repro_torch.convert`` where the same numbers are needed."""
    stacked = tree_map(
        lambda p: p.unsqueeze(0).expand((n_nodes,) + tuple(p.shape)).clone(),
        params,
    )
    if perturb > 0.0:
        leaves = [leaf for _, leaf in tree_leaves(stacked)]
        if generator is None and leaves:
            generator = torch.Generator(device=leaves[0].device).manual_seed(0)
        for leaf in leaves:
            noise = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                                device=leaf.device)
            leaf.add_(perturb * noise.to(leaf.dtype))
    return stacked


def stack_batches(step_batches: Iterator[Dict[str, np.ndarray]], q: int
                  ) -> Dict[str, np.ndarray]:
    """Draw Q per-step batches and stack them to one round's (Q, ...)."""
    qs = [next(step_batches) for _ in range(q)]
    return {k: np.stack([b[k] for b in qs]) for k in qs[0]}


def train_decentralized(
    loss_fn: Callable[[Tree, Dict], torch.Tensor],
    params_single: Tree,
    run: FLRunConfig,
    step_batches: Iterator[Dict[str, np.ndarray]],
    rounds: int,
    eval_fn: Optional[Callable[[Tree], Dict[str, float]]] = None,
    eval_every: int = 50,
    log_every: int = 0,
    wire_dtype=None,
    engine="tree",
    scale_chunk: Optional[int] = None,
    topk: Optional[int] = None,
    round_schedule: Optional[str] = None,
    storage_dtype=None,
    topk_schedule: Optional[Tuple[int, ...]] = None,
    staleness_depth: Optional[int] = None,
    robust_alpha: bool = False,
    topology_program: Optional[str] = None,
    node_program: Optional[str] = None,
    privacy: Optional[str] = None,
    scope: Optional[str] = None,
    device=None,
) -> TrainResult:
    """Train for ``rounds`` communication rounds on ``device`` (``cuda``
    unless given; raises without a card).

    ``loss_fn`` is node-batched (``core.fl.LossFn``); ``params_single``
    one node's parameters (replicated to every node) or an already
    node-stacked tree. ``step_batches`` yields PER-STEP node-stacked
    numpy batches; the driver groups Q of them per round (paper: Q local
    updates, then one communication). ``engine`` is a registry name
    (``tree``, ``flat`` or ``fused``), built with its ``simulated``
    constructor against the run topology's W, or a prebuilt engine (the
    reference's prebuilt path: ``sharded_fused`` built on a group, or a
    ``fused`` engine on another W), which trains on its own W and from
    its ``pack_state`` of the params, and refuses every build knob; the flat and fused engines
    pack the state, and the tree view comes back through
    ``engine.params_view``. ``wire_dtype`` (default ``run.wire_dtype``)
    rounds the exact-wire engines' payload, e.g. to bfloat16; the fused
    engines refuse it. ``scale_chunk`` / ``topk`` set the fused engine's
    int8 / top-k wire (``scale_chunk`` also pads the flat buffer).
    Engines that do not account their wire bytes (the exact wire) are
    charged ``comm_bytes_per_gossip`` per round. ``storage_dtype`` is
    handed to the engine: ``"bfloat16"`` stores the flat / fused
    engines' buffer (and DSGT's tracker and previous gradient) in bf16,
    the arithmetic and the wire state staying fp32; ``tree`` refuses it
    with the reference's ``ValueError``.

    ``eval_fn(consensus) -> {name: value}`` runs on the consensus tree at
    every round ``rnd`` with ``rnd % eval_every == 0`` and at the last
    round; its values join that round's row as ``eval_<name>``.
    ``log_every > 0`` prints one line every ``log_every`` rounds.

    ``round_schedule`` is a schedule spec ("sequential", "pipelined",
    "bounded_staleness:k=K"); ``staleness_depth=k`` is sugar for it (0 =
    sequential; passing both is refused).

    ``topology_program`` is a ``core.dynamics`` spec such as
    ``"node_churn:p_down=0.2,mean_downtime=5"``: the run's base W gated
    per round, dropped-edge weight folded into the self-loops (the
    history gains ``edge_fraction``). ``node_program`` is a
    ``core.heterogeneity`` spec such as ``"stragglers:frac=0.25,rate=0.5"``:
    each node's local steps and payload delivery gated per round (the
    history gains ``payload_fraction`` / ``compute_fraction``). None keeps
    the static graph and lockstep nodes. ``robust_alpha=True`` shrinks the
    step-size schedule by ``robust_alpha_scale(uptime, depth)``, the
    uptime the topology program's expected uptime times the node
    program's.

    ``scope`` is a ``core.scope`` spec: which columns of the flat buffer
    gossip touches. ``"backbone"`` shares everything but the classifier
    head (each hospital keeps a head trained on its own gradients alone,
    bit-untouched by the wire), ``"ranges:0-1376"`` explicit columns,
    ``"layerwise:freq=4"`` mixes the head only every 4th round. A
    sub-range scope shrinks the wire (every buffer, scale and byte) to
    the shared columns; pair it with a ``scale_chunk`` that does not pad
    the shared slice back to the full width. ``tree`` and ``flat``
    refuse partial scopes.

    ``privacy`` is a ``core.privacy`` spec such as
    ``"dp:sigma=0.5,clip=1.0"`` (per-node clip and Gaussian noise on the
    wire; the history gains ``dp_epsilon``) or ``"secure_agg"``; the
    engines that cannot apply it refuse it with the reference's message.

    ``topk_schedule = (k_sparse, k_dense, densify_high[, resparsify_low])``
    runs the adaptive-k wire (:class:`AdaptiveTopK`): two round functions,
    sparse and densified, built once and switched per round over ONE
    state; the history then gains ``topk`` and ``ef_residual_rms``.
    """
    prebuilt = isinstance(engine, GossipEngine)
    dev = engine.device if prebuilt else resolve_device(device)
    w = engine.dense_equivalent() if prebuilt else mixing_matrix(run.topology, run.n_nodes)
    check_assumption1(w)
    if staleness_depth is not None:
        if round_schedule is not None:
            raise ValueError(
                "pass either round_schedule or staleness_depth, not both "
                "(staleness_depth=k is sugar for "
                "round_schedule='bounded_staleness:k=k')"
            )
        k = int(staleness_depth)
        round_schedule = "sequential" if k == 0 else f"bounded_staleness:k={k}"
    cfg = FLConfig(algorithm=run.algorithm, q=run.q, n_nodes=run.n_nodes)
    params = tree_map(lambda p: torch.as_tensor(p, device=dev), params_single)
    stacked = params if _is_stacked(params, run.n_nodes) else stack_for_nodes(
        params, run.n_nodes)
    if prebuilt:
        knobs = {"wire_dtype": wire_dtype, "scale_chunk": scale_chunk, "topk": topk,
                 "round_schedule": round_schedule, "storage_dtype": storage_dtype,
                 "topk_schedule": topk_schedule, "topology_program": topology_program,
                 "node_program": node_program, "privacy": privacy, "scope": scope}
        set_knobs = sorted(k for k, v in knobs.items() if v is not None)
        if set_knobs:
            raise ValueError(
                f"{set_knobs} configure an engine BUILD; the prebuilt "
                f"{engine.name!r} engine already fixed its wire -- pass a "
                "registry name instead, or bake the knobs into the engine"
            )
        params0 = engine.pack_state(stacked)
    else:
        if topk_schedule is not None:
            if topk is not None:
                raise ValueError("pass either topk or topk_schedule, not both")
            topk = int(topk_schedule[0])  # start on the sparse wire
        if wire_dtype is None:
            wire_dtype = run.wire_dtype
        build = get_engine(engine).simulated
        kw = dict(wire_dtype=wire_dtype, scale_chunk=512 if scale_chunk is None else scale_chunk,
                  round_schedule=round_schedule, storage_dtype=storage_dtype,
                  topology_program=topology_program, node_program=node_program,
                  privacy=privacy, scope=scope)
        engine, params0 = build(w, stacked, topk=topk, **kw)
    schedule = make_schedule(run)
    if robust_alpha:
        uptime = (engine.topology_program.expected_uptime()
                  * engine.node_program.expected_uptime())
        schedule = scaled(schedule,
                          robust_alpha_scale(uptime, engine.round_schedule.depth))
    round_fn = make_fl_round(loss_fn, schedule, cfg, engine)
    adaptive, dense_fn = None, None
    if topk_schedule is not None:
        adaptive = AdaptiveTopK(topk_schedule, engine.scale_chunk)
        # the densified twin: same comm keys (they do not depend on k), so
        # both round functions advance the SAME state
        dense_engine, _ = build(w, stacked, topk=adaptive.dense_topk, **kw)
        dense_fn = make_fl_round(loss_fn, schedule, cfg, dense_engine)
    state = init_fl_state(cfg, params0, engine)

    fallback_bytes = engine.wire_bytes(cfg)
    if fallback_bytes is None:
        fallback_bytes = comm_bytes_per_gossip(params, run.topology, run.n_nodes,
                                               wire_dtype=wire_dtype or run.wire_dtype)
    history = MetricHistory()
    t0 = time.time()
    cum_bytes = 0.0
    for rnd in range(1, rounds + 1):
        fn = adaptive.pick(round_fn, dense_fn) if adaptive else round_fn
        state, m = fn(state, stack_batches(step_batches, run.q))
        cum_bytes += float(m.get("wire_bytes", fallback_bytes))
        row = dict(
            round=rnd,
            iteration=state.step,
            comm_rounds=rnd,
            comm_bytes=cum_bytes,
            loss=float(m["loss"]),
            local_loss=float(m["local_loss"]),
            grad_norm_sq=float(m["grad_norm_sq"]),
            consensus_err=float(m["consensus_err"]),
            alpha=float(m["alpha"]),
            wall_s=time.time() - t0,
        )
        for k in ("edge_fraction", "payload_fraction", "compute_fraction",
                  "dp_epsilon"):
            if k in m:
                row[k] = float(m[k])
        if adaptive is not None:
            row["topk"] = float(adaptive.current_k)
            row["ef_residual_rms"] = float(m["ef_residual_rms"])
            adaptive.update(row["ef_residual_rms"])
        if eval_fn is not None and (rnd % eval_every == 0 or rnd == rounds):
            row.update({f"eval_{k}": v
                        for k, v in eval_fn(_consensus(engine, state)).items()})
        history.append(**row)
        if log_every and rnd % log_every == 0:
            print(
                f"[round {rnd:5d}] it={row['iteration']:6d} loss={row['loss']:.4f} "
                f"cons={row['consensus_err']:.3e} gnorm2={row['grad_norm_sq']:.3e}"
            )
    return TrainResult(state=state, history=history,
                       consensus=_consensus(engine, state), w=w, engine=engine)


def _consensus(engine: GossipEngine, state: FLState) -> Tree:
    """theta_bar on the TREE view, whatever the engine's representation."""
    return tree_map(lambda p: p.mean(dim=0), engine.params_view(state.params))


def _is_stacked(params: Tree, n_nodes: int) -> bool:
    leaves = [l for _, l in tree_leaves(params)]
    return bool(leaves) and all(l.ndim >= 1 and l.shape[0] == n_nodes for l in leaves)
