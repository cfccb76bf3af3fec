"""Communication graphs and mixing matrices for decentralized FL.

Implements the graph substrate of the paper: a multi-agent system
``G = (V, E)`` of N nodes where only neighbors exchange parameters, mixed
through a symmetric doubly-stochastic matrix ``W`` (Assumption 1):

    W = W^T,   W 1 = 1,   |lambda_2(W)| < 1.

Provides the standard graph families (ring, 2-D torus, complete, star,
Erdos--Renyi) plus a 20-node "hospital" graph mimicking the paper's Fig. 1
(left), and two W constructions:

* Metropolis--Hastings weights -- valid for ANY connected graph, the
  default for arbitrary topologies.
* uniform-neighbor (circulant) weights for ring/torus.

and the coefficients of the circulant ring / torus W that the sharded
engine's point-to-point wire realizes (:func:`ring_mixing_coeffs`,
:func:`torus_mixing_coeffs`).

All matrices are plain ``numpy`` float64, and so are the spectral
checks. This module is a copy of ``repro.core.topology`` (which is numpy
too), so both packages build bit-identical W for the same topology; the
fused engine casts W to fp32 only when it splits it for the kernel.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np

__all__ = [
    "Graph",
    "ring_graph",
    "torus_graph",
    "complete_graph",
    "star_graph",
    "erdos_renyi_graph",
    "hospital20_graph",
    "metropolis_weights",
    "uniform_neighbor_weights",
    "mixing_matrix",
    "check_assumption1",
    "spectral_gap",
    "ring_mixing_coeffs",
    "torus_mixing_coeffs",
]


@dataclasses.dataclass(frozen=True)
class Graph:
    """Undirected communication graph over ``n`` FL nodes.

    ``edges`` are canonical (i < j) pairs. ``name`` identifies the family.
    """

    n: int
    edges: Tuple[Tuple[int, int], ...]
    name: str = "custom"

    def __post_init__(self) -> None:
        for i, j in self.edges:
            if not (0 <= i < j < self.n):
                raise ValueError(f"bad edge ({i},{j}) for n={self.n}")

    @property
    def adjacency(self) -> np.ndarray:
        a = np.zeros((self.n, self.n), dtype=bool)
        for i, j in self.edges:
            a[i, j] = a[j, i] = True
        return a

    def neighbors(self, i: int) -> List[int]:
        return sorted(
            ({j for a, j in self.edges if a == i} | {a for a, j in self.edges if j == i})
        )

    @property
    def degrees(self) -> np.ndarray:
        return self.adjacency.sum(axis=1).astype(np.int64)

    def is_connected(self) -> bool:
        if self.n == 1:
            return True
        adj = self.adjacency
        seen = np.zeros(self.n, dtype=bool)
        stack = [0]
        seen[0] = True
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u])[0]:
                if not seen[v]:
                    seen[v] = True
                    stack.append(int(v))
        return bool(seen.all())


def ring_graph(n: int) -> Graph:
    """Cycle C_n: node i <-> (i+1) mod n."""
    if n < 2:
        raise ValueError("ring needs n >= 2")
    edges = {tuple(sorted((i, (i + 1) % n))) for i in range(n)}
    return Graph(n=n, edges=tuple(sorted(edges)), name="ring")


def torus_graph(rows: int, cols: int) -> Graph:
    """2-D torus (rows x cols).

    Node id = r * cols + c. Each node has 4 neighbors (2 if a dim == 2,
    where +1 and -1 coincide).
    """
    n = rows * cols
    edges = set()
    for r in range(rows):
        for c in range(cols):
            u = r * cols + c
            for v in ((r * cols + (c + 1) % cols), (((r + 1) % rows) * cols + c)):
                if u != v:
                    edges.add(tuple(sorted((u, v))))
    return Graph(n=n, edges=tuple(sorted(edges)), name="torus")


def complete_graph(n: int) -> Graph:
    edges = tuple((i, j) for i in range(n) for j in range(i + 1, n))
    return Graph(n=n, edges=edges, name="complete")


def star_graph(n: int) -> Graph:
    """Hub-and-spoke: node 0 is the parameter server. The FedAvg baseline
    topology (the paper argues AGAINST requiring this trusted center)."""
    edges = tuple((0, j) for j in range(1, n))
    return Graph(n=n, edges=edges, name="star")


def erdos_renyi_graph(n: int, p: float, seed: int = 0) -> Graph:
    """G(n, p), resampled until connected (adds a ring if hopeless)."""
    rng = np.random.default_rng(seed)
    for _ in range(64):
        mask = rng.random((n, n)) < p
        edges = tuple(
            (i, j) for i in range(n) for j in range(i + 1, n) if mask[i, j]
        )
        g = Graph(n=n, edges=edges, name="erdos_renyi")
        if g.is_connected():
            return g
    ring = {tuple(sorted((i, (i + 1) % n))) for i in range(n)}
    return Graph(n=n, edges=tuple(sorted(set(edges) | ring)), name="erdos_renyi")


def hospital20_graph() -> Graph:
    """A fixed 20-node sparse connected graph standing in for the paper's
    Fig. 1 (left) hospital network (the exact edge list is not published).

    Construction: a ring backbone (every hospital talks to two regional
    peers) plus a handful of long-range referral links, giving mean degree
    ~3 -- visually consistent with Fig. 1 and a realistic sparse inter-
    hospital agreement network.
    """
    n = 20
    edges = {tuple(sorted((i, (i + 1) % n))) for i in range(n)}
    extra = [(0, 7), (2, 13), (4, 16), (5, 11), (9, 18), (3, 8), (12, 19)]
    edges |= {tuple(sorted(e)) for e in extra}
    return Graph(n=n, edges=tuple(sorted(edges)), name="hospital20")


# ---------------------------------------------------------------------------
# Mixing matrices
# ---------------------------------------------------------------------------


def metropolis_weights(graph: Graph) -> np.ndarray:
    """Metropolis--Hastings weights: W_ij = 1/(1+max(d_i,d_j)) for edges,
    W_ii = 1 - sum_j W_ij. Symmetric, doubly stochastic, and satisfies
    Assumption 1 for any connected non-bipartite-problematic graph.
    """
    n = graph.n
    deg = graph.degrees
    w = np.zeros((n, n), dtype=np.float64)
    for i, j in graph.edges:
        w[i, j] = w[j, i] = 1.0 / (1.0 + max(deg[i], deg[j]))
    np.fill_diagonal(w, 1.0 - w.sum(axis=1))
    return w


def uniform_neighbor_weights(graph: Graph, self_weight: float | None = None) -> np.ndarray:
    """W_ij = (1 - w_self)/d for neighbors on a REGULAR graph.

    For the ring this is the circulant [w_self, (1-w_self)/2, (1-w_self)/2];
    the default w_self = 1/(d+1) gives the classic 1/3-1/3-1/3 ring mixing.
    """
    deg = graph.degrees
    d = int(deg[0])
    if not np.all(deg == d):
        raise ValueError("uniform_neighbor_weights requires a regular graph")
    w_self = 1.0 / (d + 1) if self_weight is None else float(self_weight)
    if not (0.0 < w_self < 1.0):
        raise ValueError("self_weight must be in (0, 1)")
    n = graph.n
    w = np.zeros((n, n), dtype=np.float64)
    share = (1.0 - w_self) / d
    for i, j in graph.edges:
        w[i, j] = w[j, i] = share
    np.fill_diagonal(w, w_self)
    return w


_GRAPHS = {
    "ring": lambda n, **kw: ring_graph(n),
    "complete": lambda n, **kw: complete_graph(n),
    "star": lambda n, **kw: star_graph(n),
    "hospital20": lambda n, **kw: hospital20_graph(),
    "erdos_renyi": lambda n, **kw: erdos_renyi_graph(n, kw.get("p", 0.3), kw.get("seed", 0)),
}


def mixing_matrix(topology: str, n: int, **kwargs) -> np.ndarray:
    """Build W for a named topology. torus takes topology='torus:RxC'."""
    if topology.startswith("torus"):
        if ":" in topology:
            r, c = (int(v) for v in topology.split(":")[1].split("x"))
        else:
            r = int(np.floor(np.sqrt(n)))
            while n % r:
                r -= 1
            c = n // r
        if r * c != n:
            raise ValueError(f"torus {r}x{c} != n={n}")
        g = torus_graph(r, c)
        return uniform_neighbor_weights(g) if r > 2 or c > 2 else metropolis_weights(g)
    if topology not in _GRAPHS:
        raise ValueError(f"unknown topology {topology!r}; have {sorted(_GRAPHS)} + torus")
    g = _GRAPHS[topology](n, **kwargs)
    if g.n != n:
        raise ValueError(f"topology {topology} has fixed n={g.n}, requested {n}")
    try:
        return uniform_neighbor_weights(g)
    except ValueError:
        return metropolis_weights(g)


# ---------------------------------------------------------------------------
# Assumption 1 checks
# ---------------------------------------------------------------------------


def spectral_gap(w: np.ndarray) -> float:
    """1 - |lambda_2|, where lambda_2 is the second-largest-magnitude
    eigenvalue. Governs the consensus contraction rate."""
    eig = np.linalg.eigvalsh(0.5 * (w + w.T))
    mags = np.sort(np.abs(eig))[::-1]
    # the largest must be the trivial eigenvalue 1 (eigenvector 1)
    return float(1.0 - mags[1]) if len(mags) > 1 else 1.0


def check_assumption1(
    w: np.ndarray, atol: float = 1e-10, require_connected: bool = True
) -> Dict[str, float]:
    """Verify the paper's Assumption 1; raises on violation.

    ``require_connected=False`` relaxes ONLY the spectral-gap positivity
    (|lambda_2| < 1): a single round emitted by a dynamic
    :class:`~repro.core.dynamics.TopologyProgram` may legitimately
    disconnect (gap == 0 -- isolated nodes self-loop and mix nothing that
    round), while symmetry, double stochasticity, and |lambda|_max <= 1
    must still hold every round. The time-varying convergence analyses
    need joint connectivity over a window, not per-round connectivity.

    Returns diagnostics {sym_err, row_sum_err, lambda2, spectral_gap}.
    """
    n = w.shape[0]
    if w.shape != (n, n):
        raise ValueError("W must be square")
    sym_err = float(np.abs(w - w.T).max())
    row_err = float(np.abs(w.sum(axis=1) - 1.0).max())
    if sym_err > atol:
        raise AssertionError(f"W not symmetric: err={sym_err}")
    if row_err > atol:
        raise AssertionError(f"W 1 != 1: err={row_err}")
    gap = spectral_gap(w)
    if require_connected and gap <= 0.0:
        raise AssertionError("|lambda_2(W)| >= 1: graph mixes too slowly/not at all")
    if gap < -atol:
        raise AssertionError(f"|lambda_2(W)| > 1: spectral radius exceeded ({gap})")
    return {
        "sym_err": sym_err,
        "row_sum_err": row_err,
        "lambda2": 1.0 - gap,
        "spectral_gap": gap,
    }


# ---------------------------------------------------------------------------
# Coefficients of the circulant wire (one exchange per torus direction)
# ---------------------------------------------------------------------------


def ring_mixing_coeffs(n: int, self_weight: float | None = None) -> Tuple[float, float, float]:
    """(w_self, w_prev, w_next) of the circulant ring W realized by two
    exchanges over a node axis of size n. n == 2 degenerates (prev ==
    next); the two shares are folded together so W stays doubly
    stochastic."""
    if n < 2:
        return (1.0, 0.0, 0.0)
    w_self = 1.0 / 3.0 if self_weight is None else float(self_weight)
    share = (1.0 - w_self) / 2.0
    return (w_self, share, share)


def torus_mixing_coeffs(
    rows: int, cols: int, self_weight: float | None = None
) -> Dict[str, float]:
    """Coefficients of the 2-D-torus W realized by 4 exchanges over two
    node axes (``pod``, ``data``). Degenerate dims (size 2) fold their
    two directions."""
    dirs: Dict[str, float] = {}
    n_dirs = (1 if rows == 2 else 2 if rows > 2 else 0) + (1 if cols == 2 else 2 if cols > 2 else 0)
    if n_dirs == 0:
        return {"self": 1.0}
    w_self = 1.0 / (n_dirs + 1) if self_weight is None else float(self_weight)
    share = (1.0 - w_self) / n_dirs
    dirs["self"] = w_self
    if rows == 2:
        dirs["row+"] = share
    elif rows > 2:
        dirs["row+"] = dirs["row-"] = share
    if cols == 2:
        dirs["col+"] = share
    elif cols > 2:
        dirs["col+"] = dirs["col-"] = share
    return dirs
