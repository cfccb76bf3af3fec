"""Consensus snapshots: the training -> serving fast path (counterpart of
``repro.training.snapshot``).

A checkpoint (``checkpoint.py``) resumes training. A snapshot serves: the
consensus model (the node-axis mean of the flat ``(nodes, total)``
buffer) written as one raw blob plus a JSON header, so a server maps it
and reads it without a copy:

* the blob is the consensus row in the layout's storage dtype (fp32, or
  bf16 at half the bytes: the node-axis mean accumulated in fp32 and
  rounded once), padded to :data:`BLOB_ALIGN` bytes;
* the header records the layout (each leaf's path, offset, shape and
  dtype, ``total``, ``used``, ``storage_dtype``), the engine's round axes
  (``checkpoint.engine_manifest``) and ``round_frontier``, the training
  rounds that produced it;
* under a partial federation scope the blob also carries every node's
  private columns after the consensus row, so ``load_snapshot(...,
  node=i)`` serves hospital i's personalized model (the consensus
  backbone with its own head);
* :func:`load_snapshot` maps the blob (``np.memmap``, copy-on-write, so
  nothing can write the file) and each leaf is a tensor VIEW of the map:
  no copy, the bytes fault in as the server first reads them. numpy has
  no bfloat16, so a bf16 blob is mapped as 2-byte words and viewed as
  bf16; a leaf whose dtype differs from the storage dtype is the one
  copy.

The files are the reference's (magic, version, header keys, alignment,
the ``LATEST`` pointer), so each package reads the other's snapshots bit
for bit. Publication is atomic: blob, header, then ``LATEST``, each
staged under a temporary name and ``os.replace``d into place, so a
reader following ``LATEST`` never sees a torn snapshot.
"""

from __future__ import annotations

import dataclasses
import json
import os
import zlib
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.packing import (
    FlatLayout,
    as_dtype,
    pack,
    pack_like,
    tree_leaves,
    tree_unflatten,
)

Tree = Any

__all__ = [
    "Snapshot",
    "write_snapshot",
    "load_snapshot",
    "latest_round",
    "snapshot_paths",
]

SNAPSHOT_MAGIC = "repro-consensus-snapshot"
SNAPSHOT_VERSION = 1
#: blob files are padded to this many bytes
BLOB_ALIGN = 64
_LATEST = "LATEST"


def snapshot_paths(dirpath: str, round_frontier: int) -> tuple:
    """(blob, header) file names of a training round's snapshot."""
    stem = f"snapshot-{int(round_frontier):08d}"
    return (os.path.join(dirpath, stem + ".bin"),
            os.path.join(dirpath, stem + ".json"))


def _atomic_write(path: str, data: bytes) -> None:
    tmp = path + f".tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _map_dtype(storage: str) -> np.dtype:
    """The numpy dtype a blob of ``storage`` is mapped as: its own, or
    2-byte words for bf16 (viewed as ``torch.bfloat16``)."""
    return np.dtype(np.int16) if storage == "bfloat16" else np.dtype(storage)


def _host(x, storage: str) -> np.ndarray:
    """``x`` on the host in the storage dtype, as :func:`_map_dtype`."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    x = x.detach().to("cpu", as_dtype(storage))
    return x.view(torch.int16).numpy() if storage == "bfloat16" else x.numpy()


def _pad(blob: bytes) -> bytes:
    if len(blob) % BLOB_ALIGN:
        blob += b"\x00" * (BLOB_ALIGN - len(blob) % BLOB_ALIGN)
    return blob


def write_snapshot(dirpath: str, params, layout: Optional[FlatLayout] = None, *,
                   round_frontier: int, engine=None, step: Optional[int] = None,
                   extra: Optional[dict] = None) -> str:
    """Publish the consensus model as a mappable snapshot.

    ``params``: the node-stacked flat ``(nodes, total)`` buffer or the
    reduced ``(total,)`` consensus row (a tensor or an array; both need
    ``layout``), or a node-stacked tree (packed through ``layout`` when
    given). ``round_frontier``: training rounds completed (a server's
    staleness is ``frontier_now - round_frontier``). ``engine``: records
    its round axes, and its federation scope's private columns get the
    per-node block when ``params`` is node-stacked (captured before the
    mean, which would lose exactly the personalized state). ``step``,
    ``extra``: recorded verbatim.

    Returns the header path."""
    if isinstance(params, (torch.Tensor, np.ndarray)):
        if layout is None:
            raise ValueError("writing from a flat buffer requires layout=")
        flat = params
    elif layout is None:
        flat, layout = pack(params)
    else:
        flat = pack_like(params, layout)
    scope = getattr(engine, "scope", None)
    private_ranges = ()
    if scope is not None and not scope.is_full:
        private_ranges = tuple(scope.private_ranges(layout))
    storage = layout.storage_dtype
    private_block = None
    if flat.ndim == 2:
        if private_ranges:
            stacked = _host(flat, storage)
            private_block = np.concatenate([stacked[:, a:b] for a, b in private_ranges],
                                           axis=1)
        # the consensus: one mean over the node axis of the flat buffer,
        # accumulated in fp32 and rounded once to the storage dtype
        if isinstance(flat, torch.Tensor):
            flat = flat.float().mean(dim=0).to(flat.dtype)
        else:
            flat = flat.mean(axis=0)
    if tuple(flat.shape) != (layout.total,):
        raise ValueError(
            f"flat buffer {tuple(flat.shape)} does not match layout total "
            f"({layout.total},)")
    consensus = _host(flat, storage)
    blob = _pad(consensus.tobytes())
    private_offset = None
    if private_block is not None:
        private_offset = len(blob)
        blob = _pad(blob + private_block.tobytes())

    os.makedirs(dirpath, exist_ok=True)
    blob_path, header_path = snapshot_paths(dirpath, round_frontier)
    header = {
        "magic": SNAPSHOT_MAGIC,
        "version": SNAPSHOT_VERSION,
        "round_frontier": int(round_frontier),
        "blob": os.path.basename(blob_path),
        "blob_bytes": len(blob),
        "payload_bytes": consensus.nbytes,
        "crc32": zlib.crc32(blob) & 0xFFFFFFFF,
        "total": int(layout.total),
        "used": int(layout.used),
        "storage_dtype": storage,
        "source_n_nodes": int(layout.n_nodes),
        "leaves": [
            {"path": "/".join(map(str, p)), "offset": int(s.offset),
             "shape": list(s.shape), "dtype": str(s.dtype)}
            for p, s in zip(layout.paths, layout.leaves)
        ],
    }
    if private_block is not None:
        header["scope"] = {
            "spec": scope.spec(),
            "private_ranges": [[int(a), int(b)] for a, b in private_ranges],
            "private_offset_bytes": int(private_offset),
            "private_bytes": int(private_block.nbytes),
            "n_nodes": int(private_block.shape[0]),
        }
    if step is not None:
        header["step"] = int(step)
    if extra:
        header["extra"] = extra
    if engine is not None:
        from repro_torch.training.checkpoint import engine_manifest

        header["round_spec"] = engine_manifest(engine)
    _atomic_write(blob_path, blob)
    _atomic_write(header_path, json.dumps(header, indent=2).encode("utf-8"))
    _atomic_write(os.path.join(dirpath, _LATEST),
                  f"{int(round_frontier)}\n".encode("ascii"))
    return header_path


def latest_round(dirpath: str) -> Optional[int]:
    """Round of the newest published snapshot, or None before the first
    (follows the atomically replaced ``LATEST`` pointer)."""
    try:
        with open(os.path.join(dirpath, _LATEST)) as f:
            return int(f.read().strip())
    except (FileNotFoundError, ValueError):
        return None


@dataclasses.dataclass(frozen=True)
class Snapshot:
    """A mapped consensus snapshot. ``params`` leaves are CPU tensor views
    of ``flat`` (itself a view of the copy-on-write map of the blob)
    wherever the leaf dtype is the storage dtype; keep the snapshot alive
    while they are in use (``ServeEngine`` keeps it as its keepalive)."""

    params: Tree
    flat: torch.Tensor  # (total,) the consensus row
    round_frontier: int
    header: dict
    path: str  # header path

    @property
    def step(self) -> Optional[int]:
        return self.header.get("step")


def load_snapshot(dirpath: str, round_frontier: Optional[int] = None,
                  template: Optional[Tree] = None, verify: bool = False,
                  node: Optional[int] = None) -> Snapshot:
    """Map a snapshot into its layout without a copy.

    ``round_frontier``: which round (default: ``LATEST``). ``template``:
    a tree (tensors or anything with ``.shape``) giving the container
    structure; leaves are matched by path and their shapes checked.
    Without it the leaves come back as nested dicts keyed by path part.
    ``verify``: recompute the blob's crc32 (reads every byte). ``node``:
    serve hospital ``node``'s personalized model -- the consensus with
    that node's private columns overlaid from the per-node block; needs
    a snapshot written from the node-stacked buffer under a partial
    scope, and makes one writable (total,) copy (the zero-copy path is
    ``node=None``).

    A bf16 blob is mapped as 2-byte words and viewed as bf16 (``flat``
    is then bf16); each leaf comes back in its own dtype."""
    if round_frontier is None:
        round_frontier = latest_round(dirpath)
        if round_frontier is None:
            raise FileNotFoundError(f"no snapshot published in {dirpath!r}")
    blob_path, header_path = snapshot_paths(dirpath, round_frontier)
    with open(header_path) as f:
        header = json.load(f)
    if header.get("magic") != SNAPSHOT_MAGIC:
        raise ValueError(f"{header_path!r} is not a consensus snapshot")
    if header.get("version", 0) > SNAPSHOT_VERSION:
        raise ValueError(
            f"snapshot version {header['version']} is newer than this "
            f"reader ({SNAPSHOT_VERSION})")
    storage_name = header["storage_dtype"]
    storage = _map_dtype(storage_name)
    total = int(header["total"])
    # copy-on-write: the map is writable for torch, and no write reaches
    # the file
    mm = np.memmap(blob_path, dtype=storage, mode="c",
                   shape=(int(header["blob_bytes"]) // storage.itemsize,))
    if verify:
        crc = zlib.crc32(mm.tobytes()) & 0xFFFFFFFF
        if crc != header["crc32"]:
            raise ValueError(f"snapshot {blob_path!r} failed crc32 verification")
    blob = torch.from_numpy(mm)
    if storage_name == "bfloat16":
        blob = blob.view(torch.bfloat16)
    flat = blob[:total]
    if node is not None:
        sec = header.get("scope")
        if sec is None:
            raise ValueError(
                f"snapshot {header_path!r} carries no per-node private "
                "columns (written under scope 'full', or from an "
                "already-reduced consensus row); node= needs a snapshot "
                "written from the node-stacked buffer under a partial "
                "federation scope")
        n = int(sec["n_nodes"])
        node = int(node)
        if not 0 <= node < n:
            raise ValueError(f"node={node} out of range for a {n}-node snapshot")
        off = int(sec["private_offset_bytes"]) // storage.itemsize
        width = sum(b - a for a, b in sec["private_ranges"])
        priv = blob[off:off + n * width].reshape(n, width)
        flat = flat.clone()  # writable: the consensus and this node's head
        pos = 0
        for a, b in sec["private_ranges"]:
            flat[a:b] = priv[node, pos:pos + (b - a)]
            pos += b - a

    leaves = {}
    for spec in header["leaves"]:
        size = int(np.prod(spec["shape"])) if spec["shape"] else 1
        off = int(spec["offset"])
        view = flat[off:off + size].reshape(tuple(spec["shape"]))
        if spec["dtype"] != storage_name:
            view = view.to(getattr(torch, spec["dtype"]))  # the only copying path
        leaves[spec["path"]] = view

    if template is not None:
        items = tree_leaves(template)
        ordered = []
        for path, t in items:
            key = "/".join(map(str, path))
            if key not in leaves:
                raise KeyError(f"snapshot missing leaf {key!r}")
            v = leaves[key]
            if tuple(t.shape) != tuple(v.shape):
                raise ValueError(
                    f"{key}: snapshot shape {tuple(v.shape)} != template "
                    f"{tuple(t.shape)}")
            ordered.append(v)
        params = tree_unflatten(tuple(p for p, _ in items), ordered)
    else:
        params = {}
        for key, v in leaves.items():
            at = params
            parts = key.split("/")
            for p in parts[:-1]:
                at = at.setdefault(p, {})
            at[parts[-1]] = v
    return Snapshot(params=params, flat=flat,
                    round_frontier=int(header["round_frontier"]),
                    header=header, path=header_path)
