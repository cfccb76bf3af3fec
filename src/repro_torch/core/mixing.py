"""Exact-wire gossip: the mixing backends of the tree and flat engines
(counterpart of ``repro.core.mixing``).

The paper's algorithms interleave local steps with a *mixing* step

    theta_i <- sum_j W_ij theta_j

over the node graph. Here it is one ``W_off @ sent + w_self * x`` product
on the packed ``(nodes, total)`` buffer (``core.packing``), accumulated in
fp32, for any mixing matrix, on whatever device the buffer lives.

``wire_dtype`` (e.g. ``torch.bfloat16`` or ``"bfloat16"``) rounds what
crosses the wire -- the off-diagonal contributions -- to that dtype and
back (round to nearest even, as ``jnp.astype`` does); the self term stays
at full precision. ``None`` is the paper's fp32 wire.

Across ranks (``launch.mesh.NodeGroup``: each rank holds its node rows):

* the MESH backends (``make_mesh_gossip``, ``make_mesh_flat_mix``,
  ``make_mesh_gossip_per_leaf``) realize the circulant ring / torus W
  over the group's node axes (:func:`mesh_gossip_dense_equivalent`) with
  one point-to-point exchange per torus direction of the packed
  ``(rows, total)`` buffer (:class:`TorusPlan`: a static per-direction
  plan of the rows to send to and fill from each peer rank; rows whose
  neighbor lives on the same rank are an index copy). With a
  ``wire_dtype`` the whole neighbor path stays in that dtype -- payload,
  transport and ``recv * weight`` -- and only then widens to fp32; the
  self term and the accumulation are fp32;
* the ALL-GATHER backends (``make_allgather_gossip[_per_leaf]``) mix an
  arbitrary dense W: one all-gather of the packed payload, then this
  rank's rows of W against it.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.fl import tree_map
from repro_torch.core.packing import as_dtype, pack, unpack
from repro_torch.core.privacy import pair_index

Tree = Any
GossipFn = Callable[[Tree], Tree]
FlatMixFn = Callable[[torch.Tensor], torch.Tensor]

__all__ = [
    "make_dense_gossip",
    "make_dense_flat_mix",
    "make_dense_gossip_per_leaf",
    "make_mean_consensus",
    "as_dtype",
    "mesh_gossip_directions",
    "mesh_gossip_dense_equivalent",
    "TorusPlan",
    "make_mesh_gossip",
    "make_mesh_flat_mix",
    "make_mesh_gossip_per_leaf",
    "make_allgather_gossip",
    "make_allgather_gossip_per_leaf",
    "all_gather_rows",
]


def _wire(x: torch.Tensor, wire_dtype) -> torch.Tensor:
    """Round a payload to the wire dtype (simulating the comm precision)."""
    if wire_dtype is None:
        return x
    return x.to(as_dtype(wire_dtype)).to(x.dtype)


def _split_w(w: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """(diag, off-diagonal) of W as fp32 tensors: split in float64, then
    each part rounded once to fp32."""
    w = np.asarray(w, dtype=np.float64)
    w_self = torch.tensor(np.diag(w), dtype=torch.float32)
    w_off = torch.tensor(w - np.diag(np.diag(w)), dtype=torch.float32)
    return w_self, w_off


def _weights_on(w: np.ndarray):
    """``on(device) -> (w_self, w_off)``, copied to each device once."""
    host = _split_w(w)
    cache: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}

    def on(device: torch.device):
        if device not in cache:
            cache[device] = tuple(t.to(device) for t in host)
        return cache[device]

    return on


def make_dense_flat_mix(w: np.ndarray, wire_dtype=None) -> FlatMixFn:
    """Flat-native dense mixing: ONE ``W_off @ sent + w_self * x`` product
    on the packed ``(nodes, total)`` buffer, the self term at full
    precision and only the off-diagonal contributions through the wire
    dtype."""
    on = _weights_on(w)
    n = np.asarray(w).shape[0]

    def mix(flat: torch.Tensor) -> torch.Tensor:
        if flat.ndim != 2 or flat.shape[0] != n:
            raise ValueError(f"flat buffer {tuple(flat.shape)} != ({n}, total)")
        w_self, w_off = on(flat.device)
        xf = flat.to(torch.float32)
        sent = _wire(xf, wire_dtype)
        return (w_off @ sent + w_self[:, None] * xf).to(flat.dtype)

    return mix


def make_dense_gossip(w: np.ndarray, wire_dtype=None) -> GossipFn:
    """theta' = W @ Theta over the leading node axis of every leaf: packs
    the tree into one ``(nodes, total)`` buffer, mixes it with one
    product and unpacks."""
    mix = make_dense_flat_mix(w, wire_dtype)

    def gossip(tree: Tree) -> Tree:
        flat, layout = pack(tree)
        return unpack(mix(flat), layout)

    return gossip


def make_dense_gossip_per_leaf(w: np.ndarray, wire_dtype=None) -> GossipFn:
    """Leaf-by-leaf reference: one product per leaf per round (the
    equivalence oracle of the flat path)."""
    on = _weights_on(w)
    n = np.asarray(w).shape[0]

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] != n:
            raise ValueError(f"leaf leading axis {x.shape[0]} != n_nodes {n}")
        w_self, w_off = on(x.device)
        flat = x.reshape(n, -1)
        sent = _wire(flat, wire_dtype).to(torch.float32)
        mixed = w_off @ sent + w_self[:, None] * flat.to(torch.float32)
        return mixed.to(x.dtype).reshape(x.shape)

    return lambda tree: tree_map(mix_leaf, tree)


def make_mean_consensus(n: int) -> GossipFn:
    """W = (1/N) 1 1^T: exact averaging (the fusion center / FedAvg
    server, and the limit of infinitely many gossip rounds)."""
    return make_dense_gossip(np.full((n, n), 1.0 / n))


# ---------------------------------------------------------------------------
# The circulant ring / torus W over the node axes
# ---------------------------------------------------------------------------


def mesh_gossip_directions(
    axis_sizes: Dict[str, int], self_weight: Optional[float] = None
) -> Tuple[float, Tuple[Tuple[str, int, float], ...]]:
    """Directions of the circulant torus W over the given node axes.

    Returns (w_self, ((axis_name, shift, weight), ...)). An axis of size 2
    contributes ONE direction (its +1 and -1 neighbors coincide); size 1
    axes contribute none; larger axes contribute +/-1.
    """
    dirs = []
    for name, size in axis_sizes.items():
        if size == 2:
            dirs.append((name, 1))
        elif size > 2:
            dirs.append((name, 1))
            dirs.append((name, -1))
    if not dirs:
        return 1.0, ()
    w_self = 1.0 / (len(dirs) + 1) if self_weight is None else float(self_weight)
    if not (0.0 < w_self <= 1.0):
        raise ValueError("self_weight must be in (0, 1]")
    share = (1.0 - w_self) / len(dirs)
    return w_self, tuple((name, shift, share) for name, shift in dirs)


def mesh_gossip_dense_equivalent(
    axis_sizes: Dict[str, int],
    self_weight: Optional[float] = None,
    axes_subset: Optional[Sequence[str]] = None,
) -> np.ndarray:
    """The dense W the circulant backends realize (row-major node order):
    the oracle of the sharded-vs-fused equivalence, the W of the fused
    engine's node-axes build, and the matrix Assumption 1 is checked on.
    ``axes_subset`` restricts the mixing directions to those axes
    (hierarchical gossip: the other axes contribute no edges, so e.g.
    ("data",) on a (pod, data) torus yields the intra-pod block-diagonal
    W)."""
    names = list(axis_sizes)
    sizes = [axis_sizes[k] for k in names]
    n = int(np.prod(sizes))
    active = dict(axis_sizes)
    if axes_subset is not None:
        for a in axes_subset:
            if a not in axis_sizes:
                raise ValueError(f"axes_subset {axes_subset} not in {names}")
        active = {a: axis_sizes[a] for a in axes_subset}
    w_self, dirs = mesh_gossip_directions(active, self_weight)
    w = np.eye(n) * w_self if dirs else np.eye(n)
    idx = np.arange(n).reshape(sizes)
    for name, shift, weight in dirs:
        ax = names.index(name)
        # receiving from the node `shift` positions back along axis `ax`
        src = np.roll(idx, shift, axis=ax).reshape(-1)
        for dst_node, src_node in enumerate(src.tolist()):
            w[dst_node, src_node] += weight
    return w


def _mesh_dirs(axis_sizes: Dict[str, int], node_axes: Sequence[str], axes_subset,
               self_weight):
    """(w_self, dirs) over ``axes_subset`` (default: every node axis)."""
    node_axes = tuple(node_axes)
    active = tuple(axes_subset) if axes_subset is not None else node_axes
    for a in active:
        if a not in node_axes:
            raise ValueError(f"axes_subset {active} not within node_axes {node_axes}")
    return mesh_gossip_directions({a: axis_sizes[a] for a in active}, self_weight)


def _direction_tables(axis_sizes: Dict[str, int], dirs) -> Tuple[Tuple[np.ndarray, ...],
                                                                Tuple[np.ndarray, ...]]:
    """Per direction, ``src[d][i]``: the node i receives from, and
    ``dst[d][i]``: the node i ships to (the inverse roll), in row-major
    node order."""
    names = list(axis_sizes)
    idx = np.arange(int(np.prod(list(axis_sizes.values())))).reshape(
        [axis_sizes[a] for a in names])
    src = tuple(np.roll(idx, shift, axis=names.index(a)).reshape(-1) for a, shift, _ in dirs)
    dst = tuple(np.roll(idx, -shift, axis=names.index(a)).reshape(-1) for a, shift, _ in dirs)
    return src, dst


class TorusPlan:
    """One rank's static exchange plan of the circulant wire: for each
    torus direction, the rows it copies locally (neighbor on the same
    rank) and, for each peer node block, the local rows it sends (ordered
    by their destination node) and the local rows it fills (ordered by
    node). A sender's order and its receiver's agree, because a
    direction's shift is a bijection of the nodes.

    ``exchange`` moves one direction's buffers as their raw bytes: one
    ``dist.batch_isend_irecv`` per buffer, one message per peer, on the
    group's node group (``NodeGroup.wire_pg``; the peer is a global
    rank of the rank's own shard). It counts the messages it sends and
    the bytes handed to them."""

    def __init__(self, group, n_nodes: int, self_weight: Optional[float] = None,
                 axes_subset: Optional[Sequence[str]] = None):
        self.group = group
        self.n_nodes = int(n_nodes)
        self.axis_sizes = group.axes(self.n_nodes)
        self.w_self, self.dirs = _mesh_dirs(self.axis_sizes, tuple(self.axis_sizes),
                                            axes_subset, self_weight)
        self.src, self.dst = _direction_tables(self.axis_sizes, self.dirs)
        rows = group.rows(self.n_nodes)
        self.rows = rows
        r, lo, a = len(rows), rows.start, group.block
        dev = group.device

        def ix(v: List[int]) -> torch.Tensor:
            return torch.as_tensor(v, dtype=torch.int64, device=dev)

        self.plans = []
        for src, dst in zip(self.src, self.dst):
            fill, take = [], []
            recv: Dict[int, List[int]] = {}
            send: Dict[int, List[Tuple[int, int]]] = {}
            for i in rows:
                b = int(src[i]) // r
                if b == a:
                    fill.append(i - lo)
                    take.append(int(src[i]) - lo)
                else:
                    recv.setdefault(b, []).append(i - lo)
            for j in rows:
                c = int(dst[j]) // r
                if c != a:
                    send.setdefault(c, []).append((int(dst[j]), j - lo))
            self.plans.append({
                "fill": ix(fill), "take": ix(take), "whole": len(fill) == r,
                "send": [(group.peer(c), ix([j for _, j in sorted(v)]))
                         for c, v in sorted(send.items())],
                "recv": [(group.peer(b), ix(v)) for b, v in sorted(recv.items())],
            })

    def pads(self, d: int):
        """The secure-aggregation edge identities of direction ``d`` for
        this rank's rows: ``(pair, sender_lt)`` at the send (this node to
        its destination) and at the receive (its source to this node)."""
        n = self.n_nodes
        me = torch.arange(self.rows.start, self.rows.stop, dtype=torch.int64)
        dst = torch.as_tensor(self.dst[d][self.rows.start:self.rows.stop], dtype=torch.int64)
        src = torch.as_tensor(self.src[d][self.rows.start:self.rows.stop], dtype=torch.int64)
        dev = self.group.device
        return tuple((pair_index(a, b, n).to(dev), (a < b).to(dev))
                     for a, b in ((me, dst), (src, me)))

    def exchange(self, bufs: Sequence[torch.Tensor], d: int) -> Tuple[List[torch.Tensor], int, int]:
        """Direction ``d``'s transport of ``(rows, width_i)`` buffers:
        every row's neighbor payload, in the buffers' dtypes. Returns
        (received buffers, messages sent, bytes handed to them)."""
        plan = self.plans[d]
        out, msgs, nbytes = [], 0, 0
        for buf in bufs:
            buf = buf.contiguous()
            if plan["whole"]:  # every neighbor on this rank: one gather
                out.append(buf.index_select(0, plan["take"]))
                continue
            got = torch.empty_like(buf)
            if plan["fill"].numel():
                got[plan["fill"]] = buf[plan["take"]]
            raw = buf.view(torch.uint8).reshape(buf.shape[0], -1)
            ops, inbox = [], []
            for peer, rows in plan["send"]:
                msg = raw[rows].contiguous()
                ops.append(dist.P2POp(dist.isend, msg, peer, self.group.wire_pg))
                msgs += 1
                nbytes += msg.numel()
            for peer, rows in plan["recv"]:
                box = torch.empty((rows.numel(), raw.shape[1]), dtype=torch.uint8,
                                  device=raw.device)
                ops.append(dist.P2POp(dist.irecv, box, peer, self.group.wire_pg))
                inbox.append((rows, box))
            if ops:
                for req in dist.batch_isend_irecv(ops):
                    req.wait()
            for rows, box in inbox:
                got[rows] = box.view(buf.dtype).reshape((rows.numel(),) + tuple(buf.shape[1:]))
            out.append(got)
        return out, msgs, nbytes


def _circulant_mix(plan: TorusPlan, x: torch.Tensor, wire_dtype) -> torch.Tensor:
    """``w_self * x + sum_d weight_d * recv_d`` on (rows, width): the
    neighbor path in the wire dtype, the self term and the sum in fp32."""
    wire = x.dtype if wire_dtype is None else as_dtype(wire_dtype)
    payload = x.to(wire)
    acc = x.to(torch.float32) * plan.w_self
    for d, (_, _, weight) in enumerate(plan.dirs):
        (recv,), _, _ = plan.exchange((payload,), d)
        acc = acc + (recv * torch.tensor(weight, dtype=wire, device=recv.device)).to(
            torch.float32)
    return acc


def _plan_for(group, self_weight, axes_subset):
    """``plan(rows) -> TorusPlan`` for a federation of ``rows x node
    ranks`` nodes, built once."""
    cache: Dict[int, TorusPlan] = {}

    def plan(rows: int) -> TorusPlan:
        n = rows * group.node_ranks
        if n not in cache:
            cache[n] = TorusPlan(group, n, self_weight, axes_subset)
        return cache[n]

    return plan


def make_mesh_flat_mix(group, self_weight: Optional[float] = None, wire_dtype=None,
                       axes_subset: Optional[Sequence[str]] = None) -> FlatMixFn:
    """Flat-native ring / torus gossip on this rank's ``(rows, total)``
    rows of the packed buffer: one exchange per torus direction (the
    counterpart of :func:`make_dense_flat_mix` across ranks)."""
    plan = _plan_for(group, self_weight, axes_subset)

    def mix(flat: torch.Tensor) -> torch.Tensor:
        return _circulant_mix(plan(flat.shape[0]), flat, wire_dtype).to(flat.dtype)

    return mix


def make_mesh_gossip(group, self_weight: Optional[float] = None, wire_dtype=None,
                     axes_subset: Optional[Sequence[str]] = None) -> GossipFn:
    """Ring / torus gossip of this rank's rows of a node-stacked tree: the
    leaves packed into ONE ``(rows, total)`` buffer, so a round is one
    exchange per torus direction whatever the number of leaves.
    ``self_weight`` is W_ii (default 1/(directions + 1): 1/3 on a ring,
    1/5 on a torus); ``axes_subset`` gossips along those node axes only
    (hierarchical gossip)."""
    mix = make_mesh_flat_mix(group, self_weight, wire_dtype, axes_subset)

    def gossip(tree: Tree) -> Tree:
        flat, layout = pack(tree)
        return unpack(mix(flat), layout)

    return gossip


def make_mesh_gossip_per_leaf(group, self_weight: Optional[float] = None,
                              wire_dtype=None,
                              axes_subset: Optional[Sequence[str]] = None) -> GossipFn:
    """Leaf-by-leaf mesh gossip reference: one exchange per direction PER
    LEAF (the equivalence oracle of the packed path)."""
    plan = _plan_for(group, self_weight, axes_subset)

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        return _circulant_mix(plan(x.shape[0]), flat, wire_dtype).to(x.dtype).reshape(x.shape)

    return lambda tree: tree_map(mix_leaf, tree)


# ---------------------------------------------------------------------------
# The all-gather backend for arbitrary graphs
# ---------------------------------------------------------------------------


#: the all-gather of a flat tensor (``all_gather_into_tensor``, newer torch
#: renamed ``all_gather_single``; both take (output, input, group=))
_ALL_GATHER = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor


def all_gather_rows(buf: torch.Tensor, pg, n_rows: int) -> torch.Tensor:
    """ONE all-gather of a rank's (R, ...) block into the (n_rows, ...)
    buffer of every rank's blocks in rank order, moved as its raw bytes
    (neither NCCL nor gloo has every dtype, e.g. int16)."""
    raw = buf.contiguous().reshape(buf.shape[0], -1).view(torch.uint8)
    out = torch.empty((n_rows, raw.shape[1]), dtype=torch.uint8, device=raw.device)
    _ALL_GATHER(out, raw, group=pg)
    return out.view(buf.dtype).reshape((n_rows,) + tuple(buf.shape[1:]))


def _allgather_rows_of_w(group, w: np.ndarray):
    w = np.asarray(w, dtype=np.float64)
    n = w.shape[0]
    if w.shape != (n, n):
        raise ValueError(f"W shape {w.shape} is not square")
    rows = group.rows(n)
    return n, torch.as_tensor(w[rows.start:rows.stop], dtype=torch.float32,
                              device=group.device)


def make_allgather_gossip(group, w: np.ndarray, wire_dtype=None) -> GossipFn:
    """Arbitrary-W gossip: ONE all-gather of the packed node payload over
    the node group, then this rank's W rows against it. The bytes grow
    with N (every payload reaches every rank) -- the price of a
    non-torus graph -- but it is one collective whatever the number of
    leaves."""
    n, w_rows = _allgather_rows_of_w(group, w)

    def gossip(tree: Tree) -> Tree:
        flat, layout = pack(tree)
        payload = flat if wire_dtype is None else flat.to(as_dtype(wire_dtype))
        full = all_gather_rows(payload, group.wire_pg, n)
        return unpack((w_rows @ full.to(torch.float32)).to(flat.dtype), layout)

    return gossip


def make_allgather_gossip_per_leaf(group, w: np.ndarray, wire_dtype=None) -> GossipFn:
    """Leaf-by-leaf all-gather gossip reference: one all-gather PER LEAF."""
    n, w_rows = _allgather_rows_of_w(group, w)

    def mix_leaf(x: torch.Tensor) -> torch.Tensor:
        flat = x.reshape(x.shape[0], -1)
        payload = flat if wire_dtype is None else flat.to(as_dtype(wire_dtype))
        full = all_gather_rows(payload, group.wire_pg, n)
        return (w_rows @ full.to(torch.float32)).to(x.dtype).reshape(x.shape)

    return lambda tree: tree_map(mix_leaf, tree)
