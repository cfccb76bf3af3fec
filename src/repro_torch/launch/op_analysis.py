"""Op-level accounting of one call (the counterpart of
``repro.launch.hlo_analysis``).

The reference compiles its round and reads XLA's numbers off the HLO
text: FLOPs, bytes, collectives, with loop bodies multiplied by their
trip counts. PyTorch has no HLO; eager PyTorch runs every loop
iteration, so this module counts while the call runs -- on ``meta``
tensors over a fake process group (``launch.dryrun``: shapes only,
nothing computed) or on real ones (the card's check of the dry run's
prediction) -- and a Q-step loop or an L-layer stack counts Q x L times
because it runs Q x L times:

  * ``flops``         -- ``torch.utils.flop_counter.FlopCounterMode``'s
                         count (matmuls, convolutions, attention ops, their
                         backwards) plus each hand kernel's operations, the
                         counts ``benchmarks/kernel_bench.py`` keeps for its
                         bound (:func:`kernel_cost`), charged at every
                         launch (``kernels.launches``), on the card and on
                         ``meta`` alike -- so the record prices the hand
                         kernel, not its twin;
  * ``traffic_bytes`` -- the operand and result bytes of every aten op
                         that is not a view, plus each hand kernel's bytes
                         moved (an HBM traffic proxy: eager PyTorch writes
                         every intermediate, so this is an upper figure);
  * ``collectives``   -- ``{kind: {count, bytes, cross_bytes}}`` from the
                         ``c10d`` ops as they are issued, with the
                         reference's byte rule (all-gather: the output;
                         reduce-scatter: the input; all-reduce: the buffer;
                         a point-to-point op: the message). ``cross_bytes``
                         are the bytes of the ops whose ranks span more than
                         one host (:data:`RANKS_PER_HOST` GPUs, an HGX H100
                         host's NVLink domain); ``cross_pod_bytes`` those
                         spanning more than one pod (``pod_ranks`` ranks, the
                         ``pod`` axis of the multi-pod layout).
                         ``collective_bytes`` sums every kind but ``recv``
                         (a receive's bytes are its sender's);
  * ``peak_bytes``    -- the peak of the live bytes of the storages the
                         call allocated (the dry run's ``temp_bytes``: the
                         live memory beyond the arguments).

``events`` keeps each collective with its group's global ranks (and a
point-to-point op's peer), so a
caller can hold a round to its layout (``launch.dryrun``'s two-axis
record). Data-dependent kernel work takes its static value: the round
kernels' mix ``n`` terms a row, the radix select's first pass, the decode
kernel the cache's whole capacity.
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.benchmarks import kernel_bench as kb
from repro_torch.kernels.launches import watching

__all__ = ["OpCosts", "op_analysis", "kernel_cost", "RANKS_PER_HOST"]

#: GPUs of one HGX H100 host: the NVLink domain a collective stays inside
#: unless its ranks span hosts
RANKS_PER_HOST = 8

_KIND = {
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_reduce_scatter_base_": "reduce-scatter", "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
    "broadcast_": "broadcast", "send": "send", "recv_": "recv",
}

#: allocations that move no bytes
_NO_TRAFFIC = frozenset({"empty", "empty_like", "empty_strided", "new_empty",
                         "new_empty_strided"})


#: the wire stages' wires, by launch name (``wire_stage_gossip`` is pass
#: 1 of the gossip stage's two-pass route)
_WIRE_STAGES = {"wire_stage_gossip": kb.GOSSIP_STAGE, "wire_stage": 1, "wire_stage_gt": 2}


def kernel_cost(name: str, g: Dict) -> Tuple[float, float]:
    """(operations, bytes moved) of one launch of the hand kernel behind
    wrapper ``name`` at geometry ``g`` (what the wrapper hands
    ``kernels.launches.launched``), from ``benchmarks/kernel_bench.py``'s
    counts. Attention's bytes scale kernel_bench's bf16 counts by the
    operands' width."""
    if name in _WIRE_STAGES:  # without q: pass 1 of a round's two-pass route
        wires = _WIRE_STAGES[name]
        return (kb.wire_ops(g["n"], g["t"], g["chunk"], wires, g["topk"]),
                kb.wire_bytes_moved(g["n"], g["t"], g["chunk"], wires, g.get("q", True)))
    if name == "wire_stage_compact":
        return (kb.compact_ops(g["n"], g["t"], g["chunk"], g["topk"], g["bitmap"]),
                kb.compact_bytes_moved(g["n"], g["t"], g["chunk"], 1, g["topk"], g["bitmap"]))
    if name == "wire_stage_gt_compact":
        first_pass = 2 * g["n"] * g["t"]  # the select's histogram adds, both wires
        return (kb.compact_gt_ops(g["n"], g["t"], g["chunk"], g["topk"], g["bitmap"],
                                  first_pass),
                kb.compact_bytes_moved(g["n"], g["t"], g["chunk"], 2, g["topk"], g["bitmap"]))
    if name in ("fused_round", "fused_round_gt"):
        wires = 1 if name == "fused_round" else 2
        return (kb.round_ops(g["n"], g["t"], g["chunk"], wires, g["topk"]),
                kb.round_bytes(g["n"], g["t"], g["chunk"], wires))
    if name == "gossip_mix":
        return (kb.gossip_ops(g["n"], g["t"], g["chunk"], g["topk"]),
                kb.gossip_bytes(g["n"], g["t"], g["chunk"]))
    if name == "round_mix":  # pass 2: the mix, dense W_off (no data on meta)
        return (kb.mix_ops(g["n"], g["t"], g["wires"]),
                kb.mix_bytes(g["n"], g["t"], g["wires"]))
    if name == "flash_attention":
        return (kb.flash_flops(g["b"], g["sq"], g["sk"], g["h"], g["hd"], g["causal"],
                               g["window"]),
                kb.flash_bytes(g["b"], g["sq"], g["sk"], g["h"], g["kv"], g["hd"])
                * g["itemsize"] // 2)
    if name == "decode_attention":
        return (kb.decode_flops(g["b"], g["c"], g["h"], g["hd"]),
                kb.decode_bytes(g["b"], g["c"], g["h"], g["kv"], g["hd"]) * g["itemsize"] // 2)
    if name == "decode_attention.combine_launches":
        return 3 * g["acc"], 4 * (g["acc"] + g["ml"]) + g["itemsize"] * g["out"]
    if name == "wkv6":
        return kb.wkv6_ops(g["b"], g["s"], g["h"]), kb.wkv6_bytes(g["b"], g["s"], g["h"])
    if name == "rglru_scan":
        return kb.rglru_ops(g["b"], g["s"], g["w"]), kb.rglru_bytes(g["b"], g["s"], g["w"])
    raise KeyError(f"no cost model for kernel {name!r}")


@dataclasses.dataclass
class OpCosts:
    """What one call did, counted op by op (the reference's ``HloCosts``
    fields, plus the hand kernels' launches and the live-memory peak)."""

    flops: float
    traffic_bytes: float
    collective_bytes: float
    collectives: Dict[str, Dict[str, float]]
    cross_node_bytes: float = 0.0
    cross_pod_bytes: float = 0.0
    kernel_calls: Dict[str, int] = dataclasses.field(default_factory=dict)
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    peak_bytes: int = 0
    events: List[Dict] = dataclasses.field(default_factory=list, repr=False)

    def to_json(self) -> Dict:
        out = dataclasses.asdict(self)
        del out["events"]
        return out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for a in x for t in _tensors(a)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _Counter(TorchDispatchMode):
    """Counts every dispatched op's bytes, the collectives and the live
    storages the ops allocate."""

    def __init__(self, host: int, pod: Optional[int], stride: int):
        super().__init__()
        self.host, self.pod, self.stride = host, pod, stride
        self.me = dist.get_rank() if dist.is_initialized() else 0
        self.traffic = 0.0
        self.events: List[Dict] = []
        self.live: Dict[int, int] = {}
        self.cur = self.peak = 0

    def _level(self, ranks) -> int:
        """0 inside one host, 1 across hosts, 2 across pods."""
        ranks = [r * self.stride for r in ranks]
        if self.pod and len({r // self.pod for r in ranks}) > 1:
            return 2
        return 1 if len({r // self.host for r in ranks}) > 1 else 0

    def _collective(self, func, args) -> None:
        kind = _KIND.get(func._opname, func._opname)
        schema = func._schema.arguments
        pg = next(a for a, s in zip(args, schema) if "ProcessGroup" in str(s.type))
        ranks = dist.get_process_group_ranks(dist.ProcessGroup.unbox(pg))
        tensors = [_tensors(a) for a, s in zip(args, schema) if "Tensor" in str(s.type)]
        if kind in ("all-gather", "all-reduce", "broadcast", "send", "recv"):
            nbytes = _nbytes(tensors[0])  # the output (or the buffer, the message)
        elif kind == "reduce-scatter":
            nbytes = _nbytes(tensors[1])  # the input
        else:
            nbytes = max(_nbytes(t) for t in tensors)
        event = {"kind": kind, "bytes": nbytes, "ranks": tuple(ranks)}
        peers = ranks
        if kind in ("send", "recv"):
            peer = next(a for a, s in zip(args, schema) if s.name in ("dst", "src"))
            event["peer"] = ranks[peer]
            peers = [self.me, ranks[peer]]
        event["level"] = self._level(peers)
        self.traffic += nbytes
        self.events.append(event)

    def _track(self, outs, ins) -> None:
        seen = {t.untyped_storage()._cdata for t in ins}
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in seen or key in self.live:
                continue
            seen.add(key)
            self.live[key] = st.nbytes()
            self.cur += st.nbytes()
            self.peak = max(self.peak, self.cur)
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.cur -= self.live.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.namespace == "c10d":
            self._collective(func, args)
            return out
        ins, outs = _tensors(list(args) + list(kwargs.values())), _tensors(out)
        if not func.is_view:
            if func._opname not in _NO_TRAFFIC:
                self.traffic += _nbytes(ins) + _nbytes(outs)
            self._track(outs, ins)
        return out


class op_analysis:
    """``with op_analysis() as oa: fn(...)``, then ``oa.costs()``:
    :class:`OpCosts` of everything the block ran on this rank.
    ``ranks_per_host`` sets the host boundary (``cross_node_bytes``),
    ``pod_ranks`` the pod boundary (None: one pod); ``rank_stride``: rank
    g of the process group stands for rank ``g * rank_stride`` of the
    layout (a world of node ranks whose model-axis replicas are left
    out)."""

    def __init__(self, ranks_per_host: int = RANKS_PER_HOST, pod_ranks: Optional[int] = None,
                 rank_stride: int = 1):
        self._counter = _Counter(ranks_per_host, pod_ranks, rank_stride)
        self._flops = FlopCounterMode(display=False)
        self._calls: Dict[str, int] = {}
        self._kflops = self._kbytes = 0.0
        self._watch = None

    def _launched(self, name: str, geometry: Dict) -> None:
        ops, nbytes = kernel_cost(name, geometry)
        self._calls[name] = self._calls.get(name, 0) + 1
        self._kflops += ops
        self._kbytes += nbytes

    def __enter__(self) -> "op_analysis":
        self._watch = watching(self._launched)
        self._watch.__enter__()
        self._flops.__enter__()
        self._counter.__enter__()
        return self

    def __exit__(self, *exc):
        self._counter.__exit__(*exc)
        self._flops.__exit__(*exc)
        self._watch.__exit__(*exc)
        return False

    def costs(self) -> OpCosts:
        c = self._counter
        per_kind: Dict[str, Dict[str, float]] = {}
        total = cross = pod = 0.0
        for e in c.events:
            d = per_kind.setdefault(e["kind"], {"count": 0.0, "bytes": 0.0, "cross_bytes": 0.0})
            d["count"] += 1
            d["bytes"] += e["bytes"]
            if e["level"] >= 1:
                d["cross_bytes"] += e["bytes"]
            if e["kind"] == "recv":
                continue
            total += e["bytes"]
            cross += e["bytes"] if e["level"] >= 1 else 0
            pod += e["bytes"] if e["level"] >= 2 else 0
        return OpCosts(
            flops=float(self._flops.get_total_flops()) + self._kflops,
            traffic_bytes=c.traffic + self._kbytes,
            collective_bytes=total, collectives=per_kind,
            cross_node_bytes=cross, cross_pod_bytes=pod,
            kernel_calls=dict(self._calls), kernel_flops=self._kflops,
            kernel_bytes=self._kbytes, peak_bytes=c.peak, events=list(c.events))
