"""FederationScope: WHICH parameter columns federate -- the sixth round
axis (counterpart of ``repro.core.scope``).

The paper's gossip ships the whole parameter vector every round, but a
federation with per-hospital label shift does better when each node
keeps a PRIVATE slice -- its classification head -- and gossips only a
shared backbone. A scope maps the model's leaf paths onto contiguous
:class:`~repro_torch.core.packing.FlatLayout` column ranges:

    engine x schedule x topology x node program x privacy x **scope**

Registered scopes (the ``--fl-scope`` spec strings):

* ``full`` -- the whole-buffer round, bitwise a scope-less build (the
  default);
* ``backbone[:private=<substr>]`` -- leaves whose "/"-joined path
  contains the pattern (default ``fc2``, the EHR MLP's head) stay
  PRIVATE: gossip never touches their columns; every other leaf's
  columns form the shared wire. The fused engines gather the shared
  columns into one contiguous buffer, run the unchanged wire stage on it
  and scatter the mixed result back, so the wire bytes shrink by the
  shared fraction and the private columns stay bit-untouched;
* ``ranges:a-b,c-d,...`` -- explicit global column ranges (half-open);
* ``layerwise:freq=R[,head=<substr>]`` -- every column still ships every
  round (the difference-coded recon stream must stay consistent), but
  the head columns take the MIX only every R-th round, gated by the
  round counter ``topo_round``. ``freq=1`` is ``full``.

Scopes are static Python data: the column ranges are resolved against
the layout once, at engine build.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Type

from repro_torch.core.packing import FlatLayout

__all__ = [
    "FederationScope",
    "FullScope",
    "BackboneScope",
    "RangesScope",
    "LayerwiseScope",
    "FULL",
    "register_scope",
    "get_scope",
    "scope_names",
    "parse_scope",
    "resolve_scope",
    "leaf_column_ranges",
    "merge_ranges",
    "complement_ranges",
]

Ranges = Tuple[Tuple[int, int], ...]


# --------------------------------------------------------------- helpers

def leaf_column_ranges(layout: FlatLayout) -> Tuple[Tuple[str, int, int], ...]:
    """``(path, start, stop)`` per leaf, in pack order. Paths are the
    layout's key paths joined with "/" -- the encoding snapshot headers
    use, so a pattern that selects a snapshot leaf selects the scope
    leaf."""
    return tuple(("/".join(map(str, p)), s.offset, s.offset + s.size)
                 for p, s in zip(layout.paths, layout.leaves))


def merge_ranges(ranges) -> Ranges:
    """Sort and coalesce half-open ranges into a canonical disjoint tuple."""
    out = []
    for a, b in sorted((int(a), int(b)) for a, b in ranges):
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return tuple(out)


def complement_ranges(ranges: Ranges, total: int) -> Ranges:
    """The columns of ``[0, total)`` NOT covered by ``ranges`` (merged and
    disjoint)."""
    out = []
    pos = 0
    for a, b in ranges:
        if a > pos:
            out.append((pos, a))
        pos = max(pos, b)
    if pos < total:
        out.append((pos, total))
    return tuple(out)


def _match_leaf_ranges(layout: FlatLayout, pattern: str, where: str):
    """(matching, non_matching) column ranges by path substring; both
    sides must be non-empty or the scope is vacuous or total."""
    hit, miss = [], []
    for path, a, b in leaf_column_ranges(layout):
        (hit if pattern in path else miss).append((a, b))
    if not hit:
        paths = [p for p, _, _ in leaf_column_ranges(layout)]
        raise ValueError(
            f"{where}: pattern {pattern!r} matches no leaf path; "
            f"leaves are {paths!r}"
        )
    if not miss:
        raise ValueError(
            f"{where}: pattern {pattern!r} matches EVERY leaf -- nothing "
            "left to share; widen the pattern or use scope 'full'"
        )
    return merge_ranges(hit), merge_ranges(miss)


def _parse_knobs(body: str, where: str) -> Dict[str, str]:
    knobs: Dict[str, str] = {}
    if not body:
        return knobs
    for item in body.split(","):
        if "=" not in item:
            raise ValueError(
                f"{where}: knob {item!r} is not k=v (spec grammar is "
                "name:k=v,...)"
            )
        k, v = item.split("=", 1)
        knobs[k.strip()] = v.strip()
    return knobs


# ---------------------------------------------------------------- scopes

@dataclasses.dataclass(frozen=True)
class FederationScope:
    """Base contract of the sixth axis: frozen, hashable Python data that
    the engines resolve ONCE at build against their layout
    (``shared_ranges``)."""

    name = "full"

    def spec(self) -> str:
        """Canonical spec string (round-trips through :func:`parse_scope`);
        recorded in checkpoint manifests and snapshot headers."""
        return self.name

    @property
    def is_full(self) -> bool:
        """True when every column federates every round with ungated
        mixing -- the engines' scope-less path."""
        return False

    @property
    def needs_round(self) -> bool:
        """True when the round counter gates the mix (``layerwise``)."""
        return False

    def shared_ranges(self, layout: FlatLayout) -> Ranges:
        """Merged, disjoint global column ranges gossip operates on."""
        raise NotImplementedError

    def private_ranges(self, layout: FlatLayout) -> Ranges:
        """The complement: columns gossip leaves bit-untouched (the
        structural padding included)."""
        return complement_ranges(self.shared_ranges(layout), layout.total)

    @classmethod
    def _parse(cls, body: str) -> "FederationScope":
        if body:
            raise ValueError(f"scope {cls.name!r} takes no knobs, got {body!r}")
        return cls()


_SCOPES: Dict[str, Type[FederationScope]] = {}


def register_scope(cls: Type[FederationScope]) -> Type[FederationScope]:
    """Class decorator: add a scope to the registry."""
    _SCOPES[cls.name] = cls
    return cls


def get_scope(name: str) -> Type[FederationScope]:
    try:
        return _SCOPES[name]
    except KeyError:
        raise ValueError(
            f"unknown federation scope {name!r}; registered scopes: "
            f"{', '.join(scope_names())}"
        ) from None


def scope_names():
    return sorted(_SCOPES)


@register_scope
@dataclasses.dataclass(frozen=True)
class FullScope(FederationScope):
    """The whole-buffer round: every column federates."""

    name = "full"

    @property
    def is_full(self) -> bool:
        return True

    def shared_ranges(self, layout: FlatLayout) -> Ranges:
        return ((0, layout.total),)


@register_scope
@dataclasses.dataclass(frozen=True)
class BackboneScope(FederationScope):
    """Per-node private heads and a gossiped shared backbone: leaves whose
    path contains ``private`` keep their columns off the wire."""

    name = "backbone"
    #: path substring selecting the PRIVATE (head) leaves; "fc2" is the
    #: EHR MLP's classification head
    private: str = "fc2"

    def __post_init__(self):
        if not self.private:
            raise ValueError("backbone scope needs a non-empty private= "
                             "pattern (or use scope 'full')")

    def spec(self) -> str:
        if self.private == "fc2":
            return self.name
        return f"{self.name}:private={self.private}"

    def shared_ranges(self, layout: FlatLayout) -> Ranges:
        _, shared = _match_leaf_ranges(layout, self.private,
                                       f"scope {self.spec()!r}")
        return shared

    @classmethod
    def _parse(cls, body: str) -> "BackboneScope":
        knobs = _parse_knobs(body, "scope 'backbone'")
        private = knobs.pop("private", "fc2")
        if knobs:
            raise ValueError(
                f"scope 'backbone': unknown knobs {sorted(knobs)!r} "
                "(takes private=<path substring>)"
            )
        return cls(private=private)


@register_scope
@dataclasses.dataclass(frozen=True)
class RangesScope(FederationScope):
    """Explicit global column ranges (half-open, flat-buffer
    coordinates), for layouts whose paths carry no layer meaning."""

    name = "ranges"
    ranges: Ranges = ()

    def __post_init__(self):
        if not self.ranges:
            raise ValueError("ranges scope needs at least one a-b range")
        merged = merge_ranges(self.ranges)
        if merged != tuple(self.ranges):
            raise ValueError(
                f"ranges must be sorted, disjoint, non-empty; "
                f"got {self.ranges!r} (canonical: {merged!r})"
            )

    def spec(self) -> str:
        return self.name + ":" + ",".join(f"{a}-{b}" for a, b in self.ranges)

    def shared_ranges(self, layout: FlatLayout) -> Ranges:
        if self.ranges[-1][1] > layout.total:
            raise ValueError(
                f"scope {self.spec()!r} exceeds layout.total="
                f"{layout.total}"
            )
        if self.ranges == ((0, layout.total),):
            raise ValueError(
                f"scope {self.spec()!r} covers the whole buffer; "
                "use scope 'full' (the bit-identical fast path)"
            )
        return self.ranges

    @classmethod
    def _parse(cls, body: str) -> "RangesScope":
        if not body:
            raise ValueError("scope 'ranges' needs a body: ranges:a-b,c-d")
        parsed = []
        for item in body.split(","):
            a, sep, b = item.partition("-")
            if not sep:
                raise ValueError(
                    f"scope 'ranges': {item!r} is not a-b (half-open "
                    "column range)"
                )
            parsed.append((int(a), int(b)))
        return cls(ranges=tuple(parsed))


@register_scope
@dataclasses.dataclass(frozen=True)
class LayerwiseScope(FederationScope):
    """Layer-wise gossip frequency: head-matching columns take the MIX
    only every ``freq``-th round (rounds freq, 2 freq, ...), gated by the
    round counter. Every column still ships every round, so the wire
    bytes are the full wire's; ``freq=1`` is exactly ``full``."""

    name = "layerwise"
    freq: int = 4
    #: path substring selecting the gated (head) leaves
    head: str = "fc2"

    def __post_init__(self):
        if self.freq < 1:
            raise ValueError(f"layerwise freq={self.freq} must be >= 1")
        if not self.head:
            raise ValueError("layerwise scope needs a non-empty head= "
                             "pattern")

    def spec(self) -> str:
        s = f"{self.name}:freq={self.freq}"
        if self.head != "fc2":
            s += f",head={self.head}"
        return s

    @property
    def needs_round(self) -> bool:
        return True

    def shared_ranges(self, layout: FlatLayout) -> Ranges:
        # the WIRE is full width: every column's difference-coded stream
        # must advance every round for the reconstructions to stay exact
        return ((0, layout.total),)

    def gate_ranges(self, layout: FlatLayout) -> Ranges:
        """Columns whose mix fires only every freq-th round."""
        gated, _ = _match_leaf_ranges(layout, self.head,
                                      f"scope {self.spec()!r}")
        return gated

    def fire(self, topo_round):
        """The gate of the round being computed: True on rounds freq, 2
        freq, ... (``topo_round`` counts completed rounds, so the round
        is ``topo_round + 1``). An int gives a bool, the int32 counter
        tensor a bool tensor on its device."""
        return (topo_round + 1) % self.freq == 0

    @classmethod
    def _parse(cls, body: str) -> "LayerwiseScope":
        knobs = _parse_knobs(body, "scope 'layerwise'")
        if "freq" not in knobs:
            raise ValueError("scope 'layerwise' needs freq=R")
        freq = int(knobs.pop("freq"))
        head = knobs.pop("head", "fc2")
        if knobs:
            raise ValueError(
                f"scope 'layerwise': unknown knobs {sorted(knobs)!r} "
                "(takes freq=R, head=<path substring>)"
            )
        return cls(freq=freq, head=head)


#: the default whole-buffer scope every engine starts from
FULL = FullScope()


def parse_scope(spec: str) -> FederationScope:
    """Parse a ``--fl-scope`` spec string through the registry."""
    name, _, body = spec.partition(":")
    return get_scope(name.strip())._parse(body.strip())


def resolve_scope(spec: Optional[object]) -> FederationScope:
    """None -> FULL; a spec string -> the parsed scope; a scope -> itself."""
    if spec is None:
        return FULL
    if isinstance(spec, FederationScope):
        return spec
    if isinstance(spec, str):
        return parse_scope(spec)
    raise TypeError(
        f"fl_scope must be None, a spec string, or a FederationScope; "
        f"got {type(spec).__name__}"
    )
