"""Process groups for the sharded engine (counterpart of
``repro.launch.mesh``).

The reference lays FL nodes over the node axes of a JAX device mesh. The
port lays them over the ranks of a ``torch.distributed`` group: node rows
per rank, each rank owning the contiguous block ``[r * R, (r + 1) * R)``
of the ``n`` node rows, ``R = n / world``. Nothing here reads the
environment or discovers a cluster: the caller names its rank, the world
size and the path of a ``FileStore`` that every rank shares. A CUDA
device gets NCCL; the CPU gets gloo.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["NodeGroup", "start_group", "stop_group", "node_rows"]

#: how long a collective may wait for the other ranks before it raises
TIMEOUT = datetime.timedelta(seconds=300)


def node_rows(n_nodes: int, rank: int, world: int) -> range:
    """The node rows rank ``rank`` of ``world`` owns."""
    if n_nodes % world:
        raise ValueError(f"{n_nodes} nodes do not split evenly over {world} ranks")
    per = n_nodes // world
    return range(rank * per, (rank + 1) * per)


@dataclasses.dataclass(frozen=True)
class NodeGroup:
    """One rank's view of the group: the process group every collective
    of the engine runs on, the rank, the world size and the device its
    tensors live on."""

    pg: dist.ProcessGroup
    rank: int
    world: int
    device: torch.device

    def rows(self, n_nodes: int) -> range:
        """This rank's node rows of an ``n_nodes`` federation."""
        return node_rows(n_nodes, self.rank, self.world)


def start_group(rank: int, world: int, store_path: str, device=None) -> NodeGroup:
    """Start this process's rank of a ``world``-rank group that meets at
    the ``FileStore`` ``store_path`` (a file every rank can reach and none
    has used before). ``device`` resolves as every entry point's does
    (``cuda`` unless the caller names another): NCCL for a CUDA device,
    gloo for the CPU. One group per process; :func:`stop_group` ends it."""
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} is not in a world of {world}")
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        backend, kw["device_id"] = "nccl", dev
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"no process-group backend for {dev}")
    dist.init_process_group(backend, store=dist.FileStore(store_path, world),
                            rank=rank, world_size=world, timeout=TIMEOUT, **kw)
    return NodeGroup(dist.group.WORLD, rank, world, dev)


def stop_group(group: NodeGroup) -> None:
    """End the group :func:`start_group` started."""
    dist.destroy_process_group(group.pg)
