"""Checkpoints: FLState <-> ``state.npz`` + ``manifest.json``
(counterpart of ``repro.training.checkpoint``).

Plain numpy and JSON: the leaves are flattened by tree path ("/"-joined
keys; a flat buffer is the empty path) into one compressed npz, keys
``params::...``, ``tracker::...``, ``prev_grad::...`` and ``comm::<key>``,
beside a manifest recording the step, the six round axes of the engine
(:func:`engine_manifest`) and the comm keys. The files are the
reference's, key for key, so each package loads the other's
checkpoints: the counters' RNG keys (``topo_key``, ``node_key``,
``priv_key``), which the port holds as int64 words, cross as the
reference's (2,) uint32 arrays. numpy has no bfloat16, so a bf16 leaf
(bf16 flat storage) is saved as its raw 2-byte words, the ``|V2`` entry
the reference writes, and the manifest's ``dtypes`` names it; a restore
views the words back as bf16, bitwise, a reference checkpoint's too.

Restoring needs a template state (``init_fl_state``) of the same
structure; shapes are checked. With ``engine=`` the manifest's axes are
checked against the engine's and a mismatch is refused with the
reference's messages; the engine's ``restore_comm`` then refuses
unknown comm keys and rebuilds the derived ones (the sharded engine's
neighbor accumulators, which a fused checkpoint never had). Wire state
is never dropped silently, and a template with more comm buffers than
the checkpoint saved needs ``engine=``.

On ``sharded_fused`` each rank holds its node rows (and, on the two-axis
layout, its column tile): a save gathers the row blocks and tiles of
every row-split buffer and rank 0 writes the files (every rank calls
it), and a load slices the rank's block out (``local_block``) before
``restore_comm``. So a fused checkpoint restores onto the sharded engine
and back, and a two-axis checkpoint at one shard restores on the
single-axis engine; the manifest records the node axes, the model axis,
``model_shards`` and the world, and a ``model_shards`` mismatch is
refused with the reference's migration hint.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.dynamics import parse_program
from repro_torch.core.engine import (
    GossipEngine,
    engine_names,
    get_engine,
    resolve_schedule,
    schedule_names,
)
from repro_torch.core.fl import FLState
from repro_torch.core.heterogeneity import parse_node_program
from repro_torch.core.packing import tree_leaves, tree_unflatten
from repro_torch.core.privacy import parse_privacy
from repro_torch.core.scope import parse_scope

Tree = Any

__all__ = ["save_fl_state", "load_fl_state", "engine_manifest"]

#: the counters' RNG keys: (2,) uint32 in the files, int64 words in the port
KEY_WORDS = ("topo_key", "node_key", "priv_key")
_TREES = ("params", "tracker", "prev_grad", "comm")


def engine_manifest(engine: GossipEngine) -> dict:
    """The six round axes (engine, schedule, topology program, node
    program, privacy, scope) and, for ``sharded_fused``, the group's
    geometry as a JSON-serializable dict: the one record both durable
    formats carry (checkpoint manifests, snapshot headers)."""
    manifest = {"engine": engine.name,
                "round_schedule": engine.round_schedule.spec(),
                "topology_program": engine.topology_program.spec(),
                "node_program": engine.node_program.spec(),
                "privacy": engine.privacy.spec(),
                "scope": engine.scope.spec()}
    group = getattr(engine, "group", None)
    if group is not None:
        # the node torus and the model axis (the reference's mesh record:
        # a two-axis engine pads the layout per shard, so buffers written
        # under one shard count do not fit another), and the world
        axes = group.axes(engine.n_nodes)
        m_axis = getattr(engine, "model_axis", None)
        shards = int(getattr(engine, "model_shards", 1))
        layout = getattr(engine, "layout", None)
        names, shape = list(axes), [int(v) for v in axes.values()]
        if m_axis is not None:
            names, shape = names + [str(m_axis)], shape + [shards]
        manifest["mesh"] = {"axis_names": names, "shape": shape,
                            "node_axes": list(axes), "model_axis": m_axis,
                            "model_shards": shards,
                            "layout_shards": int(getattr(layout, "shards", 1)),
                            "world": int(group.world)}
    return manifest


def _key(path) -> str:
    return "/".join(map(str, path))


def _counter_keys(engine: Optional[GossipEngine]) -> frozenset:
    """Comm keys every rank holds whole (the counters and the topology
    program's state); the others are split by node rows."""
    keys = ("topo_round",) + KEY_WORDS
    if engine is not None:
        keys += tuple(engine.topology_program.state_keys())
    return frozenset(keys)


def _row_split(name: str, key: str, counters: frozenset) -> bool:
    return name != "comm" or key not in counters


def _host(leaf) -> np.ndarray:
    """A leaf as numpy: a bf16 tensor as its raw 2-byte words (``|V2``,
    as the reference's bf16 arrays land in an npz)."""
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    leaf = leaf.detach().cpu()
    if leaf.dtype == torch.bfloat16:
        return leaf.view(torch.int16).numpy().view("V2")
    return leaf.numpy()


def _arrays(name: str, tree: Tree, gather=None, counters=frozenset()) -> Dict[str, np.ndarray]:
    """``{"name::key": array}`` of one tree; row-split leaves through
    ``gather`` (the sharded engine's ``gather_rows``) when given."""
    out = {}
    for path, leaf in tree_leaves(tree):
        key = _key(path)
        if gather is not None and _row_split(name, key, counters):
            leaf = gather(leaf)
        a = _host(leaf)
        if name == "comm" and key in KEY_WORDS:
            a = a.astype(np.uint32)
        out[f"{name}::{key}"] = a
    return out


def save_fl_state(path: str, state: FLState, extra: Optional[dict] = None,
                  engine: Optional[GossipEngine] = None) -> None:
    """Write ``state`` (and ``engine``'s round axes) to the directory
    ``path``. On ``sharded_fused`` every rank calls it; rank 0 writes."""
    gather = getattr(engine, "gather_rows", None)
    counters = _counter_keys(engine)
    arrays = {}
    for name, tree in zip(_TREES, (state.params, state.tracker, state.prev_grad,
                                    state.comm)):
        if tree is not None:
            arrays.update(_arrays(name, tree, gather, counters))
    if gather is not None and engine.group.rank != 0:
        dist.barrier(group=engine.group.pg)
        return
    manifest = {"step": int(state.step), "has_tracker": state.tracker is not None,
                "has_comm": state.comm is not None}
    if engine is not None:
        manifest.update(engine_manifest(engine))
    if state.comm is not None:
        manifest["comm_keys"] = sorted(state.comm)
    words = sorted(k for k, a in arrays.items() if a.dtype.kind == "V")
    if words:
        manifest["dtypes"] = {k: "bfloat16" for k in words}
    if extra:
        manifest["extra"] = extra
    os.makedirs(path, exist_ok=True)
    np.savez_compressed(os.path.join(path, "state.npz"), **arrays)
    manifest["n_arrays"] = len(arrays)
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    if gather is not None:
        dist.barrier(group=engine.group.pg)


def _check_manifest(manifest: dict, engine: Optional[GossipEngine]) -> None:
    """Every refusal of the reference's restore, with its messages: an
    engine outside the registry, another staleness depth, topology
    program, node program, privacy spec, federation scope or shard
    count."""
    saved_engine = manifest.get("engine")
    if saved_engine is not None:
        if saved_engine not in engine_names():
            raise ValueError(
                f"checkpoint was written by engine {saved_engine!r}, which "
                f"is not in the registry {engine_names()}"
            )
        get_engine(saved_engine)
    saved_schedule = manifest.get("round_schedule")
    if saved_schedule is not None:
        try:
            saved_sched = resolve_schedule(saved_schedule)
        except (ValueError, KeyError):
            raise ValueError(
                f"checkpoint was written under round schedule "
                f"{saved_schedule!r}, which no schedule in the registry "
                f"{schedule_names()} can rebuild"
            ) from None
        if engine is not None and engine.round_schedule.depth != saved_sched.depth:
            eng_sched = engine.round_schedule
            raise ValueError(
                f"checkpoint was written at staleness depth "
                f"{saved_sched.depth} ({saved_schedule!r}) but the "
                f"restore engine runs depth {eng_sched.depth} "
                f"({eng_sched.spec()!r}); the in-flight wire ring is "
                "part of the comm-state contract -- rebuild the "
                f"engine with round_schedule={saved_schedule!r}"
            )
    saved_program = manifest.get("topology_program")
    if saved_program is not None:
        try:
            parse_program(saved_program)
        except ValueError as e:
            raise ValueError(
                f"checkpoint was written under topology program "
                f"{saved_program!r}, which no registered program can "
                f"rebuild: {e}"
            ) from None
        # a STATIC checkpoint may seed a dynamic run (the program starts
        # from round 0); a dynamic one's counters mean nothing elsewhere
        if (engine is not None and saved_program != "static"
                and engine.topology_program.spec() != saved_program):
            raise ValueError(
                f"checkpoint was written under topology program "
                f"{saved_program!r} but the restore engine runs "
                f"{engine.topology_program.spec()!r}; the topo_round/topo_key "
                "counters only replay the identical graph sequence "
                "under the same program -- rebuild the engine with "
                f"topology_program={saved_program!r}"
            )
    saved_privacy = manifest.get("privacy")
    if saved_privacy is not None:
        try:
            parse_privacy(saved_privacy)
        except ValueError as e:
            raise ValueError(
                f"checkpoint was written under privacy spec "
                f"{saved_privacy!r}, which cannot be rebuilt: {e}"
            ) from None
        if (engine is not None and saved_privacy != "none"
                and engine.privacy.spec() != saved_privacy):
            raise ValueError(
                f"checkpoint was written under privacy spec "
                f"{saved_privacy!r} but the restore engine runs "
                f"{engine.privacy.spec()!r}; priv_key and the round "
                "counter only regenerate the identical mask/noise "
                "streams -- and the epsilon accounting is only "
                "truthful -- under the same spec; rebuild the engine "
                f"with privacy={saved_privacy!r}"
            )
    saved_scope = manifest.get("scope")
    if saved_scope is not None:
        try:
            parse_scope(saved_scope)
        except ValueError as e:
            raise ValueError(
                f"checkpoint was written under federation scope "
                f"{saved_scope!r}, which cannot be rebuilt: {e}"
            ) from None
        if (engine is not None and saved_scope != "full"
                and engine.scope.spec() != saved_scope):
            raise ValueError(
                f"checkpoint was written under federation scope "
                f"{saved_scope!r} but the restore engine runs "
                f"{engine.scope.spec()!r}; the private columns carry "
                "per-node state gossip never touched and the wire "
                "buffers are sized to the scoped slice -- both only "
                "stay meaningful under the same scope; rebuild the "
                f"engine with scope={saved_scope!r}"
            )
    saved_node = manifest.get("node_program")
    if saved_node is not None:
        try:
            parse_node_program(saved_node)
        except ValueError as e:
            raise ValueError(
                f"checkpoint was written under node program "
                f"{saved_node!r}, which no registered program can "
                f"rebuild: {e}"
            ) from None
        if (engine is not None and saved_node != "homogeneous"
                and engine.node_program.spec() != saved_node):
            raise ValueError(
                f"checkpoint was written under node program "
                f"{saved_node!r} but the restore engine runs "
                f"{engine.node_program.spec()!r}; node_key only replays the "
                "identical straggler/outage sequence under the same "
                "program -- rebuild the engine with "
                f"node_program={saved_node!r}"
            )
    saved_mesh = manifest.get("mesh")
    if saved_mesh is not None and engine is not None:
        eng_shards = int(getattr(engine, "model_shards", 1))
        ckpt_shards = int(saved_mesh.get("model_shards", 1))
        if eng_shards != ckpt_shards:
            raise ValueError(
                f"checkpoint was written on a mesh with "
                f"model_shards={ckpt_shards} (axes "
                f"{saved_mesh.get('axis_names')!r}, shape "
                f"{saved_mesh.get('shape')!r}, model_axis="
                f"{saved_mesh.get('model_axis')!r}) but the restore engine "
                f"runs model_shards={eng_shards}; the flat layout is padded "
                "per shard, so the saved buffers are not byte-compatible -- "
                "rebuild the engine on a mesh whose model axis has "
                f"{ckpt_shards} devices, or migrate the checkpoint by "
                "unpacking params with the saved layout and repacking with "
                f"pack(..., shards={eng_shards}) before resuming"
            )


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def _restored(key: str, arr: np.ndarray, t: torch.Tensor, saved_dtype) -> torch.Tensor:
    """One saved array as a tensor of the template leaf's dtype: raw
    2-byte words (``|V2``) are bf16, viewed bitwise; anything else is
    converted by value."""
    if arr.dtype.kind == "V":
        if arr.dtype.itemsize != 2 or saved_dtype not in (None, "bfloat16"):
            raise ValueError(
                f"{key}: raw {arr.dtype.itemsize}-byte words saved as "
                f"{saved_dtype!r}; only bfloat16 is stored as raw words")
        words = torch.from_numpy(np.ascontiguousarray(arr).view(np.int16))
        return words.view(torch.bfloat16).to(t.dtype)
    if t.dtype == torch.bfloat16:
        return torch.from_numpy(arr.astype(np.float32)).to(t.dtype)
    return torch.from_numpy(arr.astype(_np_dtype(t.dtype)))


def load_fl_state(path: str, template: FLState,
                  engine: Optional[GossipEngine] = None) -> FLState:
    """Restore the checkpoint in ``path`` onto ``template``'s structure,
    devices and dtypes (the key words back to int64), with ``engine``'s
    refusals and ``restore_comm``. On ``sharded_fused`` every rank loads
    its own rows."""
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    _check_manifest(manifest, engine)
    data = np.load(os.path.join(path, "state.npz"))
    saved_comm_keys = set(manifest.get("comm_keys") or ())
    if not saved_comm_keys:  # a manifest without the list: the npz's keys
        saved_comm_keys = {k.split("::", 1)[1] for k in data.files
                           if k.startswith("comm::")}
    if template.comm is None and saved_comm_keys:
        raise ValueError(
            f"checkpoint carries wire state {sorted(saved_comm_keys)} but "
            "the restore template has none; build the template with the "
            "matching engine (init_fl_state(..., engine=...))"
        )
    local = getattr(engine, "local_block", None)
    counters = _counter_keys(engine)
    saved_dtypes = manifest.get("dtypes") or {}

    def restore(name: str, tree: Tree) -> Tree:
        if tree is None:
            return None
        items = tree_leaves(tree)
        out = []
        for path, t in items:
            key = f"{name}::{_key(path)}"
            if key not in data:
                raise KeyError(f"checkpoint missing {key}")
            arr = data[key]
            if local is not None and _row_split(name, _key(path), counters):
                arr = local(arr)
            if arr.shape != tuple(t.shape):
                raise ValueError(f"{key}: shape {arr.shape} != template {tuple(t.shape)}")
            out.append(_restored(key, arr, t, saved_dtypes.get(key)).to(t.device))
        return tree_unflatten(tuple(p for p, _ in items), out)

    # a checkpoint with FEWER comm buffers than the template (a fused one
    # onto a sharded template) restores what it has; the engine rebuilds
    # the rest. Buffers in both are restored exactly.
    comm = template.comm
    if comm is not None and manifest.get("has_comm", False):
        saved_keys = saved_comm_keys
        extra = saved_keys - set(comm)
        if extra and engine is not None:
            droppable = {k for k in extra if engine.is_derived_comm_key(k)}
            extra -= droppable
            saved_keys = saved_keys - droppable
        if extra:
            raise ValueError(
                f"checkpoint carries wire state {sorted(extra)} that the "
                "restore template does not use; build the template with the "
                "matching engine"
            )
        if saved_keys and saved_keys < set(comm):
            if engine is None:
                raise ValueError(
                    "restore template carries engine-specific wire state "
                    f"{sorted(set(comm) - saved_keys)} the checkpoint did "
                    "not save; pass engine= so it can be rebuilt "
                    "consistently"
                )
            comm = {**comm, **restore("comm", {k: comm[k] for k in sorted(saved_keys)})}
        else:
            comm = restore("comm", comm)
        if engine is not None:
            comm = engine.restore_comm(comm)
    return FLState(
        step=int(manifest["step"]),
        params=restore("params", template.params),
        tracker=restore("tracker", template.tracker),
        prev_grad=restore("prev_grad", template.prev_grad),
        comm=comm,
    )
