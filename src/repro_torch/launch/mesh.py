"""Process groups and layouts for the sharded engine (counterpart of
``repro.launch.mesh``).

The reference lays FL nodes over the node axes of a JAX device mesh and
may tile each node's flat buffer over a ``model`` axis. The port lays
them over the ranks of a ``torch.distributed`` group:

* the NODE AXES are an ordered ``{name: size}`` whose product is the
  number of FL nodes, in row-major order (the reference's
  ``dense_equivalent`` order): they define the node torus the circulant
  wire runs on. A group started without them is one axis, ``nodes``, of
  the federation's size;
* the world is ``node ranks x S``: rank ``a * S + s`` owns node block
  ``a`` (the rows ``[a * R, (a + 1) * R)``, ``R = n / node ranks``) and
  column tile ``s`` of every flat buffer (``S`` = ``model_shards``, 1 on
  the single-axis layout);
* two families of sub-groups: the NODE GROUP of shard ``s`` (ranks ``s,
  S + s, ...``) carries the wire; the MODEL GROUP of block ``a`` (ranks
  ``a * S, ..., a * S + S - 1``) gathers a block's column tiles for the
  local steps -- parameter traffic, never wire traffic.

Nothing here reads the environment or discovers a cluster: the caller
names its rank, the world size and the path of a ``FileStore`` every
rank shares. A CUDA device gets NCCL (one rank a card: NCCL refuses two
ranks on one device); the CPU gets gloo. A caller that puts several
ranks on one card names ``backend="gloo"``: gloo moves CUDA tensors
through the host, and refuses by raising what it does not take.
:func:`run_group` starts the ranks of a group as processes of this
machine.

``make_production_mesh`` / ``make_test_mesh`` and the helpers below build
LAYOUTS (axis names and sizes), not device meshes: they start no process
and touch no device.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import tempfile
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = [
    "NodeGroup",
    "start_group",
    "stop_group",
    "sub_groups",
    "node_rows",
    "run_group",
    "MeshLayout",
    "make_production_mesh",
    "make_test_mesh",
    "node_axes",
    "model_axis",
    "n_fl_nodes",
    "n_model_shards",
]

#: how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)


def node_rows(n_nodes: int, rank: int, world: int) -> range:
    """The node rows node rank ``rank`` of ``world`` owns."""
    if n_nodes % world:
        raise ValueError(f"{n_nodes} nodes do not split evenly over {world} ranks")
    per = n_nodes // world
    return range(rank * per, (rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """One rank's view of the group: the process group the metrics
    all-reduce over (the whole world), the rank, the world size, the
    device its tensors live on, the node axes, the model-shard count
    ``S`` and the two sub-groups of this rank (``node_pg``: the wire's
    transport; ``model_pg``: the block's column gathers, None at S = 1).
    A group built by hand from a process group alone is one node axis
    and one shard, its wire on ``pg``."""

    pg: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device
    #: ((axis name, size), ...) in row-major node order; () = one axis
    #: ``nodes`` of the federation's size
    node_axes: Tuple[Tuple[str, int], ...] = ()
    model_shards: int = 1
    node_pg: Optional[dist.ProcessGroup] = None
    model_pg: Optional[dist.ProcessGroup] = None

    @property
    def node_ranks(self) -> int:
        """Ranks along the node dimension (``world / S``)."""
        return self.world // self.model_shards

    @property
    def block(self) -> int:
        """This rank's node block ``a``."""
        return self.rank // self.model_shards

    @property
    def shard(self) -> int:
        """This rank's column tile ``s``."""
        return self.rank % self.model_shards

    @property
    def wire_pg(self) -> dist.ProcessGroup:
        """The group the wire runs on: the node group of this shard."""
        return self.pg if self.node_pg is None else self.node_pg

    def peer(self, block: int) -> int:
        """The global rank of node block ``block`` in this rank's shard."""
        return block * self.model_shards + self.shard

    def rows(self, n_nodes: int) -> range:
        """This rank's node rows of an ``n_nodes`` federation."""
        return node_rows(n_nodes, self.block, self.node_ranks)

    def axes(self, n_nodes: int) -> Dict[str, int]:
        """The node axes of an ``n_nodes`` federation, in order."""
        if not self.node_axes:
            return {"nodes": int(n_nodes)}
        axes = dict(self.node_axes)
        prod = 1
        for size in axes.values():
            prod *= size
        if prod != n_nodes:
            raise ValueError(
                f"node axes {axes} enumerate {prod} nodes, not the layout's {n_nodes}"
            )
        return axes


def _axes_tuple(node_axes) -> Tuple[Tuple[str, int], ...]:
    if not node_axes:
        return ()
    items = tuple((str(k), int(v)) for k, v in dict(node_axes).items())
    for name, size in items:
        if size < 1:
            raise ValueError(f"node axis {name!r} has size {size}")
        if name == "model":
            raise ValueError(
                "'model' names the column-tile axis; it cannot be a node axis"
            )
    return items


def start_group(rank: int, world: int, store_path: str, device=None, *,
                node_axes=None, model_shards: int = 1,
                backend: Optional[str] = None) -> NodeGroup:
    """Start this process's rank of a ``world``-rank group that meets at
    the ``FileStore`` ``store_path`` (a file every rank can reach and none
    has used before). ``device`` resolves as every entry point's does
    (``cuda`` unless the caller names another): NCCL for a CUDA device,
    gloo for the CPU. ``node_axes`` (an ordered ``{name: size}``) is the
    node torus; ``model_shards`` S splits the world into ``world / S``
    node ranks of S column tiles each, and the node and model sub-groups
    are built here (``dist.new_group`` in the same order on every rank).
    ``backend``: ``"gloo"`` on a CUDA device for ranks that share a card
    (the default there is NCCL). One group per process; :func:`stop_group`
    ends it."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    s = int(model_shards)
    if s < 1 or world % s:
        raise ValueError(f"model_shards={model_shards} does not divide the world {world}")
    axes = _axes_tuple(node_axes)
    dev = resolve_device(device)
    kw = {}
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: the port's groups run 'nccl' or 'gloo'")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
        if backend == "nccl":
            kw["device_id"] = dev
    elif dev.type == "cpu":
        if backend == "nccl":
            raise ValueError("NCCL runs CUDA tensors only; the CPU's groups run gloo")
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=TIMEOUT, **kw)
    node_pg, model_pg = sub_groups(rank, world, s) if s > 1 else (None, None)
    return NodeGroup(dist.group.WORLD, rank, world, dev, axes, s, node_pg, model_pg)


def sub_groups(rank: int, world: int, model_shards: int):
    """This rank's (node group, model group) of a ``world`` whose ranks
    are ``node ranks x model_shards`` (``dist.new_group`` for every group,
    in the same order on every rank)."""
    s, a_n = model_shards, world // model_shards
    node_pg = model_pg = None
    for shard in range(s):
        g = dist.new_group([a * s + shard for a in range(a_n)])
        if rank % s == shard:
            node_pg = g
    for block in range(a_n):
        g = dist.new_group([block * s + shard for shard in range(s)])
        if rank // s == block:
            model_pg = g
    return node_pg, model_pg


def stop_group(group: NodeGroup) -> None:
    """End the group :func:`start_group` started."""
    dist.destroy_process_group(group.pg)


def _check_world(world: int, dev: torch.device, backend: Optional[str] = None) -> None:
    if dev.type == "cuda" and backend != "gloo" and world > torch.cuda.device_count():
        raise ValueError(
            f"a world of {world} ranks needs {world} cards: NCCL runs one rank "
            f"a device and refuses two ranks on one card, and "
            f"{torch.cuda.device_count()} are visible -- lower the node ranks x "
            "model shards, or run the ranks on gloo with --device cpu"
        )


def _rank_main(rank: int, fn, world: int, device: str, store: str, node_axes,
               model_shards: int, args, out_path: str, backend: Optional[str]) -> None:
    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    group = start_group(rank, world, store, dev, node_axes=node_axes,
                        model_shards=model_shards, backend=backend)
    try:
        out = fn(group, *args)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        stop_group(group)


def run_group(fn: Callable, world: int, *, device=None, node_axes=None,
              model_shards: int = 1, args: Sequence = (), backend: Optional[str] = None):
    """Run ``fn(group, *args)`` on every rank of a ``world``-rank group on
    this machine and return rank 0's result. ``world == 1`` runs in this
    process; otherwise each rank is a spawned process (``fn`` and
    ``args`` must pickle). On CUDA rank r takes card r, and a world
    larger than the visible cards is refused (NCCL runs one rank a
    device) -- unless ``backend="gloo"``, whose ranks take the cards in
    turn (r modulo the card count), several to a card; on the CPU the
    ranks run gloo, one intra-op thread each."""
    dev = resolve_device(device)
    _check_world(world, dev, backend)
    with tempfile.TemporaryDirectory() as tmp:
        store = os.path.join(tmp, "store")
        if world == 1:
            group = start_group(0, 1, store, dev, node_axes=node_axes,
                                model_shards=model_shards, backend=backend)
            try:
                return fn(group, *args)
            finally:
                stop_group(group)
        import torch.multiprocessing as mp

        out_path = os.path.join(tmp, "rank0.pt")
        mp.start_processes(_rank_main, nprocs=world, start_method="spawn",
                           args=(fn, world, str(dev.type), store, node_axes,
                                 model_shards, tuple(args), out_path, backend))
        return torch.load(out_path, weights_only=False)


# ---------------------------------------------------------------------------
# Layouts: the reference's production and test meshes as axis names and sizes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MeshLayout:
    """A mesh's axis names and sizes: the node axes and, optionally, the
    ``model`` axis whose size is the model-shard count."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def world(self) -> int:
        out = 1
        for s in self.sizes:
            out *= s
        return out


def make_production_mesh(*, multi_pod: bool = False) -> MeshLayout:
    """The reference's production layouts: single-pod (16 data, 16 model)
    -- 16 FL nodes x 16 column tiles -- or multi-pod (2 pod, 16 data, 16
    model): 32 FL nodes on a 2 x 16 node torus."""
    if multi_pod:
        return MeshLayout(("pod", "data", "model"), (2, 16, 16))
    return MeshLayout(("data", "model"), (16, 16))


def make_test_mesh(shape: Tuple[int, ...] = (2, 2, 2)) -> MeshLayout:
    """A small layout for tests: (pod, data, model) for 3 axes, (data,
    model) for 2, the last ``len(shape)`` of (pod, data, model) else."""
    axes = ("pod", "data", "model")[-len(shape):] if len(shape) < 3 else ("pod", "data", "model")
    if len(shape) == 2:
        axes = ("data", "model")
    return MeshLayout(tuple(axes), tuple(int(s) for s in shape))


def node_axes(mesh: MeshLayout) -> Tuple[str, ...]:
    """The axes enumerating FL nodes (everything except ``model``)."""
    return tuple(a for a in mesh.axis_names if a != "model")


def model_axis(mesh: MeshLayout) -> Optional[str]:
    """The column-tile axis name, or None on node-only layouts. Engines
    built with ``model_axis=`` tile each node's flat buffer across it:
    the wire stays on the node axes, the model axis only tiles the
    columns."""
    return "model" if "model" in mesh.axis_names else None


def n_fl_nodes(mesh: MeshLayout) -> int:
    n = 1
    for a in node_axes(mesh):
        n *= mesh.shape[a]
    return n


def n_model_shards(mesh: MeshLayout) -> int:
    """Size of the ``model`` axis (1 when the layout has none)."""
    return int(mesh.shape["model"]) if "model" in mesh.axis_names else 1

