"""Dry run of one (arch x shape x mesh) pair at production shapes
(counterpart of ``repro.launch.dryrun``).

The reference lowers and compiles each pair on 512 placeholder devices
and reads XLA's cost and memory analyses. The port runs the pair itself,
on ``meta`` tensors (shapes and dtypes, nothing allocated or computed)
over a fake process group of the production world: this process is rank
0 of 256 ranks (``--mesh single``: 16 data x 16 model) or 512 (``--mesh
multi``: 2 pod x 16 data x 16 model), and every collective it issues is
accepted and counted without moving a byte (torch's own ``fake``
backend, ``torch.testing._internal.distributed.fake_pg``). The hand
kernels' wrappers allocate their outputs on ``meta`` and count a launch
(``kernels.launches``), and ``launch.op_analysis`` counts the call op by
op: FLOPs, bytes, collectives by kind with the bytes that cross an 8-GPU
host or a pod, the peak of live bytes. Every number is rank 0's.

  * train pairs build the round of ``--fl-engine`` on the node-stacked
    meta init and run ONE ``make_fl_round`` call on the batch of
    ``configs.shapes``: ``sharded_fused`` (``ShardedFusedEngine.
    from_group``, the two-axis layout under ``--fl-shard-model``; the
    two-axis record holds the round to its contracts: one wire-stage
    launch per (node, shard) tile, every wire message on node-axis
    groups, one direction's bytes = ``flat_wire_bytes_per_shard``), or
    ``tree`` -- the reference's default, which it dry-runs through GSPMD's
    Megatron partitioning of the model layers -- for every family on the
    ``(node, model)`` layout: ``TreeEngine.from_group`` keeps the rank's
    node rows of its shard of each leaf (``models.sharding``), the loss is
    the tensor-parallel bundle's (``build_model(cfg, model_group=...)``:
    column- and row-parallel layers, the expert-parallel MoE, RWKV6's
    mixes on the rank's heads, the RG-LRU block on its channels,
    whisper's encoder-decoder, the vocab-parallel embedding and loss),
    and the record's ``tensor_parallel`` section gives the per-rank state
    bytes and the model and node groups' collectives; or ``flat`` /
    ``fused``, whose flat buffer the reference places ``P(node axes,
    None)``: a node's model ranks are replicas that each hold the node's
    whole buffer and run the whole model (the record's
    ``model_replicas``), so the fake world is the node ranks alone, as for
    ``sharded_fused`` without ``--fl-shard-model``, and the model axis
    carries nothing (``fused``: ``FusedEngine.from_group``, the torus's
    dense W on the sharded engine's all-gather wire);
  * prefill and decode pairs run rank 0's own call on ``meta``: its
    shards of the tensor-parallel layers (``build_model(cfg,
    model_group=...)``, ``models.sharding.shard_params``), its share of
    the batch (B / nodes where it divides, else B / data, else B, the
    reference's split) and its decode states (the kv heads its q heads
    read, its WKV-6 heads, its RG-LRU channels); the record's FLOPs,
    bytes and live peak are that call's, undivided, and its
    ``tensor_parallel`` section gives the head plan, the per-rank
    parameter and state bytes (beside the reference's cache placement,
    replicated over the model axis) and the model and node groups'
    collectives.

The record keeps the reference's keys; XLA's own fields are replaced:
``temp_bytes`` is the peak of the live bytes the call allocated beyond
its arguments, ``lower_s`` / ``compile_s`` are ``trace_s``, and the
record adds ``kernel_calls`` and ``shard_gathers``.

Usage (one pair a process: the fake group is per process):
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
      --shape train_4k --mesh single --fl-engine sharded_fused --fl-shard-model \\
      --q 2 --out experiments/dryrun_torch
  (every pair: python -m repro_torch.benchmarks.run_dryruns)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist

from repro_torch.configs import (
    SHAPES,
    decode_sliding_override,
    get_config,
    serve_input_specs,
    supports_shape,
    train_input_specs,
)
from repro_torch.configs.shapes import InputShape
from repro_torch.core.dynamics import program_names
from repro_torch.core.engine import engine_names, get_engine, schedule_names
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
from repro_torch.core.packing import flat_wire_bytes_per_shard, tree_bytes
from repro_torch.core.schedules import inv_sqrt
from repro_torch.launch.mesh import (
    MeshLayout,
    NodeGroup,
    make_production_mesh,
    model_axis,
    n_fl_nodes,
    n_model_shards,
    node_axes,
    sub_groups,
)
from repro_torch.launch.op_analysis import op_analysis
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models.sharding import batch_specs, rank_bytes, shard_params
from repro_torch.training.trainer import stack_for_nodes

__all__ = ["start_fake_world", "build_train_round", "two_axis_record",
           "tensor_parallel_record", "run_pair", "record_name", "main"]

META = torch.device("meta")
#: the engines whose flat buffer is placed ``P(node axes, None)``: the
#: model ranks of a node are replicas
REPLICA_ENGINES = ("flat", "fused")
SKIP_REASON = "whisper x long_500k: enc-dec full-attention decoder (DESIGN.md §4)"


def start_fake_world(world: int, model_shards: int = 1) -> Tuple[Any, Any]:
    """Make this process rank 0 of a fake ``world``-rank group (``cpu``
    and ``meta`` tensors on torch's ``fake`` backend) and its node and
    model sub-groups (``launch.mesh.sub_groups``). Returns (node group,
    model group), both None at one shard. One fake world a process."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a process group is already up: one dry run a process")
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=0,
                            world_size=world)
    if model_shards == 1:
        return None, None
    return sub_groups(0, world, model_shards)


def _leaves(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _leaves(v)]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


def _bytes(x) -> int:
    """The bytes of the distinct storages behind ``x``'s tensors."""
    seen, total = set(), 0
    for t in _leaves(x):
        key = t.untyped_storage()._cdata
        if key not in seen:
            seen.add(key)
            total += t.untyped_storage().nbytes()
    return total


def _custom_mesh(nodes: int, node_ranks: int, model_shards: int) -> MeshLayout:
    """A one-node-axis layout: ``nodes`` FL nodes on ``node_ranks`` ranks
    of ``model_shards`` tiles each (the card's check of a prediction)."""
    if nodes % node_ranks:
        raise ValueError(f"{nodes} nodes do not split over {node_ranks} node ranks")
    return MeshLayout(("data", "model"), (node_ranks, model_shards))


def build_train_round(arch: str, shape: InputShape, mesh: MeshLayout, q: int,
                      algorithm: str = "dsgt", wire_dtype=None, pod_gossip_every: int = 1,
                      pad_heads: int = 0, fl_engine: str = "sharded_fused",
                      scale_chunk: int = 512, topk=None, fl_schedule: str = "sequential",
                      fl_topology_program: Optional[str] = None,
                      fl_node_program: Optional[str] = None,
                      fl_privacy: Optional[str] = None, fl_scope: Optional[str] = None,
                      fl_shard_model: bool = False, nodes: Optional[int] = None,
                      smoke: bool = False) -> Dict:
    """Build one FL round (Q local steps + the comm step) of ``arch`` on
    this rank of ``mesh``'s fake world, on ``meta`` tensors. ``nodes``:
    the FL nodes (default: one a node rank of the mesh). Returns the
    round's pieces: ``round_fn``, ``state``, ``batch``, ``engine``,
    ``fl_cfg``, ``cfg``, ``group`` and the batch's per-rank bytes.
    ``smoke``: the architecture's reduced config (the CPU tests' size)."""
    get_engine(fl_engine)  # raises with the registry listing
    if fl_shard_model and fl_engine != "sharded_fused":
        raise ValueError(
            "--fl-shard-model needs the sharded_fused engine (the "
            f"two-axis wire is its contract); got fl_engine={fl_engine!r}"
        )
    cfg = get_config(arch, smoke=smoke)
    if pad_heads:
        cfg = dataclasses.replace(cfg, tp_head_pad=pad_heads)
    tensor_parallel = fl_engine == "tree" and n_model_shards(mesh) > 1
    naxes = node_axes(mesh)
    node_ranks = n_fl_nodes(mesh)
    nodes = node_ranks if nodes is None else nodes
    s = n_model_shards(mesh) if fl_shard_model or tensor_parallel else 1
    if fl_shard_model and model_axis(mesh) is None:
        raise ValueError(
            "--fl-shard-model needs a mesh with a 'model' axis; "
            f"this mesh has {mesh.axis_names!r}"
        )
    # without the model axis (flat, fused, sharded_fused without
    # --fl-shard-model) each node's model-axis ranks are replicas running
    # this same program on the node's whole buffer: the fake world is the
    # node ranks alone
    node_pg, model_pg = start_fake_world(node_ranks * s, s)
    bundle = build_model(cfg, remat=True, model_group=model_pg if tensor_parallel else None)
    axes = tuple((a, mesh.shape[a]) for a in naxes) if nodes == node_ranks else (
        ("data", nodes),)
    group = NodeGroup(dist.group.WORLD, 0, node_ranks * s, META, axes, s, node_pg, model_pg)
    hier = pod_gossip_every > 1 and "pod" in naxes
    stacked = stack_for_nodes(bundle.param_shapes(), nodes)
    engine, flat = get_engine(fl_engine).from_group(
        group, stacked, scale_chunk=scale_chunk, topk=topk, round_schedule=fl_schedule,
        topology_program=fl_topology_program, node_program=fl_node_program,
        privacy=fl_privacy, scope=fl_scope, wire_dtype=wire_dtype,
        axes_subset=("data",) if hier else None,
        model_axis=model_axis(mesh) if fl_shard_model else None)
    del stacked
    fl_cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=nodes)
    state = init_fl_state(fl_cfg, flat, engine)
    round_fn = make_fl_round(bundle.loss_fn, inv_sqrt(0.02), fl_cfg, engine)
    batch = train_input_specs(cfg, shape, nodes, q)
    batch_mesh = {a: mesh.shape[a] for a in naxes}
    return {"round_fn": round_fn, "state": state, "batch": batch, "engine": engine,
            "fl_cfg": fl_cfg, "cfg": cfg, "group": group, "tensor_parallel": tensor_parallel,
            "model_replicas": n_model_shards(mesh) if fl_engine in REPLICA_ENGINES else None,
            "batch_bytes": rank_bytes(batch, batch_specs(batch, naxes), batch_mesh)}


def _node_coords(index: int, axes) -> Tuple[int, ...]:
    out = []
    for _, size in reversed(axes):
        out.append(index % size)
        index //= size
    return tuple(reversed(out))


def two_axis_record(engine, costs, fl_cfg) -> Dict[str, Any]:
    """The two-axis round's obligations, from the port's own counters:

      * ONE wire-stage launch per (node, shard) tile: this rank's round
        launched one (``kernels.launches``);
      * every wire message (point-to-point, or an all-gather of the
        dense W's wire) on this shard's node group, so nothing crosses the
        model group but the local steps' ``shard_gathers``; the axes a
        message moves along are the node axes its peer's coordinates
        differ in;
      * one direction's messages are EXACTLY the per-shard encoding:
        ``flat_wire_bytes_per_shard`` bytes.

    Returns the record fields; raises AssertionError when the round
    breaks a contract (a bug, not an environment problem)."""
    group = engine.group
    stages = {k: v for k, v in costs.kernel_calls.items() if k.startswith("wire_stage")}
    assert sum(stages.values()) == 1, (
        f"two-axis round must stay ONE wire-stage kernel per (node, shard) tile; "
        f"found {stages}")
    node_ranks = set(dist.get_process_group_ranks(group.wire_pg))
    model_ranks = (set(dist.get_process_group_ranks(group.model_pg))
                   if group.model_pg is not None else set())
    axes = tuple(group.axes(engine.n_nodes).items())
    rows = len(engine.rows)
    mine = _node_coords(group.block * rows, axes)
    axes_seen, sends, gathers = set(), [], 0
    for e in costs.events:
        if e["kind"] == "all-reduce":
            continue  # the metrics: not wire traffic
        if e["kind"] == "all-gather" and model_ranks and set(e["ranks"]) == model_ranks:
            gathers += 1
            continue
        assert set(e["ranks"]) == node_ranks, (
            f"a {e['kind']} of {e['bytes']} B on ranks {sorted(e['ranks'])[:8]}... "
            "left this shard's node group")
        if e["kind"] in ("send", "recv"):
            peer = _node_coords((e["peer"] // group.model_shards) * rows, axes)
            axes_seen |= {a for (a, _), x, y in zip(axes, mine, peer) if x != y}
            if e["kind"] == "send":
                sends.append(e["bytes"])
        else:
            axes_seen |= {a for a, _ in axes}
    assert gathers == engine.shard_gathers, (
        f"{gathers} all-gathers on the model group, {engine.shard_gathers} shard gathers")
    n_buffers = 3 if engine.compact_wire else 2
    per_shard = flat_wire_bytes_per_shard(engine.wire_layout, 1, engine.scale_chunk,
                                          engine.topk if engine.compact_wire else None)
    if sends:
        moved = sum(sends[:n_buffers])
        assert moved == per_shard, (
            f"per-shard message bytes {moved} != flat_wire_bytes_per_shard {per_shard}")
    return {
        "model_axis": engine.model_axis,
        "model_shards": int(engine.model_shards),
        "shard_width": int(engine.layout.shard_width),
        "pallas_calls": sum(stages.values()),
        "collective_axes": sorted(axes_seen),
        "wire_bytes_per_shard_one_edge": per_shard if sends else None,
        "wire_bytes_per_shard_per_round": float(engine.wire_bytes_per_shard(fl_cfg)),
    }


def _group_collectives(costs, model_pg, node_pg) -> Tuple[Dict, Dict]:
    """The collectives of the model group and of the node group by kind
    (``op_analysis``'s ``on_group``). Raises AssertionError where a
    collective left both groups or a gossip message left the node group."""
    model_ranks = tuple(dist.get_process_group_ranks(model_pg))
    node_ranks = tuple(dist.get_process_group_ranks(node_pg))
    stray = [e for e in costs.events if tuple(e["ranks"]) not in (model_ranks, node_ranks)]
    assert not stray, f"collectives outside the model and node groups: {stray[:4]}"
    on_model = costs.on_group(model_ranks)
    assert set(on_model) <= {"all-reduce", "all-gather"}, "a gossip message on the model group"
    return on_model, costs.on_group(node_ranks)


def _head_plan(cfg, shard: int, shards: int) -> Optional[Dict]:
    """The rank's head share (a decoder's; None for attention-free RWKV6)."""
    if not cfg.n_heads:
        return None
    return attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
                             shard, shards)._asdict()


def tensor_parallel_record(aux, costs) -> Dict[str, Any]:
    """The ``tree`` round's (node, model) layout: the rank's head share (a
    decoder's; None for attention-free RWKV6), its state bytes leaf by leaf (params, tracker, previous gradient: the
    placed shards), and the collectives of its model group and of its
    node group by kind, with the bytes that cross a host (a 16-rank model
    group spans two 8-GPU hosts). Raises AssertionError where a
    collective left both groups or a gossip message left the node group."""
    group, cfg, state = aux["group"], aux["cfg"], aux["state"]
    on_model, on_node = _group_collectives(costs, group.model_pg, group.wire_pg)
    return {
        "model_axis": "model", "model_shards": int(group.model_shards),
        "heads": _head_plan(cfg, group.shard, group.model_shards),
        "param_bytes": tree_bytes(state.params),
        "tracker_bytes": tree_bytes(state.tracker) if state.tracker is not None else 0,
        "prev_grad_bytes": tree_bytes(state.prev_grad) if state.prev_grad is not None else 0,
        "model_group": on_model,
        "node_group": on_node,
    }


def _cache_specs(tree, batch: int, naxes, divisible: bool):
    """Split the batch dim of every leaf over the node axes (the reference's
    ``_cache_specs``: the first of the two leading dims equal to the
    batch), as spec tuples over ``_leaves``' order."""
    specs = []
    for t in _leaves(tree):
        spec = [None] * t.ndim
        if divisible:
            for i, d in enumerate(t.shape):
                if d == batch and i <= 1:
                    spec[i] = tuple(naxes)
                    break
        specs.append(tuple(spec))
    return specs


def _split_bytes(tree, specs, sizes: Dict[str, int]) -> int:
    return sum(rank_bytes({"x": t}, {"x": s}, sizes) for t, s in zip(_leaves(tree), specs))


def _batch_share(b: int, mesh: MeshLayout) -> int:
    """Rank 0's share of a serving batch of ``b``: split over the node axes
    where it divides, else over ``data``, else whole (the reference's
    batch specs)."""
    for parts in (n_fl_nodes(mesh), mesh.shape["data"]):
        if b % parts == 0:
            return b // parts
    return b


def _serve_call(cfg, shape: InputShape, mesh: MeshLayout):
    """Rank 0's prefill or decode call on meta -- its shards of the
    tensor-parallel layers, its share of the batch and its decode states
    -- in the fake world of the mesh's node and model groups. Returns
    (call, argument bytes, the record's ``tensor_parallel`` section less
    its collectives, the (model, node) process groups)."""
    shards = n_model_shards(mesh)
    node_pg, model_pg = start_fake_world(mesh.world, shards)
    bundle = build_model(cfg, remat=False, model_group=model_pg)
    whole = bundle.param_shapes()
    params = shard_params(whole, 0, shards)
    b = shape.global_batch
    share = _batch_share(b, mesh)
    tp = {"model_axis": "model", "model_shards": shards,
          "heads": _head_plan(cfg, 0, shards), "batch": b, "batch_share": share,
          "param_bytes": tree_bytes(params)}
    if shape.kind == "prefill":
        batch = serve_input_specs(cfg, dataclasses.replace(shape, global_batch=share))
        tp["batch_bytes"] = tree_bytes(batch)

        def call():
            return bundle.prefill_fn(params, batch)
    else:
        sliding = decode_sliding_override(cfg, shape)
        caches = bundle.init_decode_state_fn(share, shape.seq_len, sliding_override=sliding,
                                             device=META)
        tokens = torch.empty((share,), dtype=torch.int32, device=META)
        tp["batch_bytes"] = tree_bytes(tokens)
        tp["state_bytes"] = tree_bytes(caches)
        # the reference's placement: the whole model's caches split by
        # their batch dim over the node axes, replicated over the model axis
        naxes, full = node_axes(mesh), build_model(cfg, remat=False).init_decode_state_fn(
            b, shape.seq_len, sliding_override=sliding, device=META)
        tp["reference_state_bytes"] = _split_bytes(
            full, _cache_specs(full, b, naxes, b % n_fl_nodes(mesh) == 0), dict(mesh.shape))

        def call():
            return bundle.decode_fn(params, tokens, caches, sliding_override=sliding)
    arg_bytes = tp["param_bytes"] + tp["batch_bytes"] + tp.get("state_bytes", 0)
    return call, arg_bytes, tp, (model_pg, node_pg)


def record_name(args) -> str:
    """The record's file name: the reference's suffix rules."""
    suffix = ""
    if args.impl != "ref":
        suffix += f"_{args.impl}"
    if args.fl_engine != "tree":
        suffix += f"_{args.fl_engine}"
    if args.topk:
        suffix += f"_topk{args.topk}"
    if args.fl_shard_model:
        suffix += "_shardmodel"
    if args.fl_schedule != "sequential":
        suffix += "_" + args.fl_schedule.replace(":", "-").replace("=", "")
    if args.fl_topology_program:
        suffix += "_" + args.fl_topology_program.split(":")[0]
    if args.fl_node_program:
        suffix += "_" + args.fl_node_program.split(":")[0]
    if args.fl_privacy:
        suffix += "_" + args.fl_privacy.split(":")[0].replace("+", "-")
    if args.fl_scope:
        suffix += "_scope-" + args.fl_scope.split(":")[0]
    if args.pad_heads:
        suffix += f"_hpad{args.pad_heads}"
    if args.wire_dtype:
        suffix += f"_wire-{args.wire_dtype}"
    if args.pod_gossip_every > 1:
        suffix += f"_podq{args.pod_gossip_every}"
    if args.q != 4 and args.shape in ("train_4k",):
        suffix += f"_q{args.q}"
    if args.algorithm != "dsgt":
        suffix += f"_{args.algorithm}"
    return f"{args.arch}_{args.shape}_{args.mesh}{suffix}.json"


def run_pair(arch: str, shape_name: str, mesh_kind: str, q: int = 4, algorithm: str = "dsgt",
             wire_dtype: Optional[str] = None, pod_gossip_every: int = 1,
             impl: str = "ref", pad_heads: int = 0, fl_engine: str = "tree", topk=None,
             fl_schedule: str = "sequential", fl_topology_program: Optional[str] = None,
             fl_node_program: Optional[str] = None, fl_privacy: Optional[str] = None,
             fl_scope: Optional[str] = None, fl_shard_model: bool = False,
             scale_chunk: int = 512, mesh_layout: Optional[MeshLayout] = None,
             nodes: Optional[int] = None, seq_len: Optional[int] = None,
             global_batch: Optional[int] = None, smoke: bool = False) -> Dict[str, Any]:
    """Run one pair on meta and return the dry-run record. ``mesh_layout``
    replaces the production mesh (e.g. ``launch.mesh.make_test_mesh``, or
    the ``--layout`` of the CLI), ``nodes`` the FL nodes (default one a node
    rank), ``seq_len`` / ``global_batch`` the shape's and ``smoke`` the
    config by its reduced one (the card checks a prediction at its own
    configuration; the CPU tests run small ones)."""
    if impl != "ref":
        raise ValueError(
            f"--impl {impl}: the port's attention dispatches by device (one path: "
            "the hand kernels on the card); there is no blocked implementation")
    shape = SHAPES[shape_name]
    if seq_len is not None or global_batch is not None:
        shape = dataclasses.replace(shape, seq_len=seq_len or shape.seq_len,
                                    global_batch=global_batch or shape.global_batch)
    cfg = get_config(arch, smoke=smoke)
    if not supports_shape(cfg, shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": SKIP_REASON}
    mesh = mesh_layout or make_production_mesh(multi_pod=(mesh_kind == "multi"))
    n_chips = mesh.world
    pod = mesh.world // mesh.shape["pod"] if "pod" in mesh.axis_names else None
    train = shape.kind == "train"
    t0 = time.time()
    aux: Dict[str, Any] = {}
    try:
        if train:
            aux = build_train_round(
                arch, shape, mesh, q, algorithm, wire_dtype, pod_gossip_every, pad_heads,
                fl_engine, scale_chunk, topk, fl_schedule, fl_topology_program,
                fl_node_program, fl_privacy, fl_scope, fl_shard_model, nodes, smoke)
            cfg, state, batch = aux["cfg"], aux["state"], aux["batch"]
            arg_bytes = _bytes(state) + aux["batch_bytes"]
            stride = mesh.world // aux["group"].world
            with op_analysis(pod_ranks=pod, rank_stride=stride) as oa:
                new_state, metrics = aux["round_fn"](state, batch)
            out_bytes = _bytes((new_state, metrics))
            flops_split = "rank 0's round: each rank runs its own rows and tile"
        else:
            call, arg_bytes, serve_tp, pgs = _serve_call(cfg, shape, mesh)
            with op_analysis(pod_ranks=pod) as oa:
                out = call()
            out_bytes = _bytes(out)
            flops_split = (f"rank 0's own call, no division: its shards of the "
                           f"{serve_tp['model_shards']} model ranks' tensor-parallel layers, "
                           f"its {serve_tp['batch_share']} of the batch {shape.global_batch} "
                           "and its decode states")
        if train and aux["model_replicas"]:
            flops_split = (f"rank 0's round: its node's whole model and flat buffer "
                           f"(P(node axes, None)); the node's {aux['model_replicas']} model "
                           "ranks are replicas running the same round, counted in n_chips")
        trace_s = time.time() - t0
        costs = oa.costs()
        record = {
            "arch": arch, "shape": shape_name, "mesh": mesh_kind, "kind": shape.kind,
            "status": "ok", "q": q if train else None,
            "algorithm": algorithm if train else None, "impl": impl,
            "fl_engine": fl_engine if train else None,
            "fl_schedule": fl_schedule if train else None,
            "fl_topology_program": fl_topology_program if train else None,
            "fl_node_program": fl_node_program if train else None,
            "fl_privacy": fl_privacy if train else None,
            "fl_scope": fl_scope if train else None,
            "topk": topk if train else None, "wire_dtype": wire_dtype,
            "pod_gossip_every": pod_gossip_every, "n_chips": n_chips,
            "n_nodes": nodes or n_fl_nodes(mesh),
            "flops": float(costs.flops),
            "traffic_bytes": float(costs.traffic_bytes),
            "flops_split": flops_split,
            "collectives": {
                "per_kind": costs.collectives,
                "total_bytes": float(costs.collective_bytes),
                "cross_node_bytes": float(costs.cross_node_bytes),
                "cross_pod_bytes": float(costs.cross_pod_bytes),
            },
            "memory": {
                "argument_bytes": int(arg_bytes),
                "output_bytes": int(out_bytes),
                "temp_bytes": int(costs.peak_bytes),
            },
            "model_params": cfg.param_count() if cfg.family != "mlp" else None,
            "active_params": cfg.active_param_count() if cfg.family != "mlp" else None,
            "trace_s": round(trace_s, 2),
            "kernel_calls": costs.kernel_calls,
            "kernel_flops": float(costs.kernel_flops),
            "shard_gathers": int(getattr(aux["engine"], "shard_gathers", 0)) if train else 0,
        }
        if mesh_layout is not None:
            record["layout"] = {"mesh": mesh.shape, "seq_len": shape.seq_len,
                                "global_batch": shape.global_batch,
                                "scale_chunk": scale_chunk}
        if train and fl_shard_model:
            record["two_axis"] = two_axis_record(aux["engine"], costs, aux["fl_cfg"])
        if train and aux["tensor_parallel"]:
            record["tensor_parallel"] = tensor_parallel_record(aux, costs)
        if train and aux["model_replicas"]:
            record["model_replicas"] = aux["model_replicas"]
        if not train:
            on_model, on_node = _group_collectives(costs, *pgs)
            record["tensor_parallel"] = {**serve_tp, "model_group": on_model,
                                         "node_group": on_node}
        return record
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=sorted(SHAPES))
    ap.add_argument("--mesh", default="single", choices=("single", "multi"))
    ap.add_argument("--q", type=int, default=4)
    ap.add_argument("--algorithm", default="dsgt", choices=("dsgd", "dsgt"))
    ap.add_argument("--wire-dtype", default=None,
                    help="the reference's exact-wire dtype: the fused engines' wire is "
                         "int8, so sharded_fused refuses it")
    ap.add_argument("--pod-gossip-every", type=int, default=1,
                    help="> 1 on the multi-pod mesh: the common round, whose gossip "
                         "mixes only the intra-pod 'data' axis")
    ap.add_argument("--impl", default="ref", choices=("ref", "blocked"),
                    help="kept for the reference's command lines: 'ref' only")
    ap.add_argument("--fl-engine", default="tree", choices=engine_names(),
                    help="round engine (core.engine's registry): tree on the (node, "
                         "model) layout with tensor-parallel layers; flat and fused with "
                         "a node's model ranks as replicas of its whole flat buffer; "
                         "sharded_fused, with --fl-shard-model on the two-axis layout")
    ap.add_argument("--topk", type=int, default=None,
                    help="ship only the k largest payload columns per scale chunk "
                         "(the compact wire where it is smaller)")
    ap.add_argument("--fl-schedule", default="sequential",
                    help=f"round time layout ({', '.join(schedule_names())}; "
                         "'bounded_staleness:k=3')")
    ap.add_argument("--fl-topology-program", default=None,
                    help=f"per-round graph dynamics ({', '.join(program_names())})")
    ap.add_argument("--fl-node-program", default=None,
                    help="per-node heterogeneity (core.heterogeneity), e.g. "
                         "'stragglers:frac=0.25,rate=0.5'")
    ap.add_argument("--fl-privacy", default=None,
                    help="wire privacy epilogue, e.g. 'secure_agg+dp:sigma=0.5,clip=1.0'")
    ap.add_argument("--fl-scope", default=None,
                    help="federation scope: 'full', 'backbone[:private=PAT]', "
                         "'ranges:a-b,...'")
    ap.add_argument("--fl-shard-model", action="store_true",
                    help="the two-axis (gossip_node, model_shard) round: each node's "
                         "flat buffer tiles over the mesh's 'model' axis (recorded "
                         "under 'two_axis')")
    ap.add_argument("--pad-heads", type=int, default=0,
                    help="pad q heads to a multiple of this (16 = TP degree)")
    ap.add_argument("--scale-chunk", type=int, default=512)
    ap.add_argument("--layout", default=None,
                    help="NODES/NODE_RANKS/MODEL_SHARDS: a one-node-axis layout in "
                         "place of the production mesh, e.g. 2/1/1 (a ring of 2 on one "
                         "rank)")
    ap.add_argument("--seq-len", type=int, default=None, help="override the shape's")
    ap.add_argument("--global-batch", type=int, default=None, help="override the shape's")
    ap.add_argument("--out", default=None, help="directory for the JSON record")
    return ap


def main(argv=None) -> Dict[str, Any]:
    args = _parser().parse_args(argv)
    mesh = nodes = None
    if args.layout:
        nodes, node_ranks, shards = (int(x) for x in args.layout.split("/"))
        mesh = _custom_mesh(nodes, node_ranks, shards)
    rec = run_pair(
        args.arch, args.shape, args.mesh, q=args.q, algorithm=args.algorithm,
        wire_dtype=args.wire_dtype, pod_gossip_every=args.pod_gossip_every,
        impl=args.impl, pad_heads=args.pad_heads, fl_engine=args.fl_engine,
        topk=args.topk, fl_schedule=args.fl_schedule,
        fl_topology_program=args.fl_topology_program,
        fl_node_program=args.fl_node_program, fl_privacy=args.fl_privacy,
        fl_scope=args.fl_scope, fl_shard_model=args.fl_shard_model,
        scale_chunk=args.scale_chunk, mesh_layout=mesh, nodes=nodes, seq_len=args.seq_len,
        global_batch=args.global_batch)
    print(json.dumps(rec, indent=2))
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, record_name(args)), "w") as f:
            json.dump(rec, f, indent=2)
    return rec


if __name__ == "__main__":
    main()
