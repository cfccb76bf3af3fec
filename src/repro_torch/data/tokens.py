"""Synthetic LM token pipeline for the transformer architectures
(counterpart of ``repro.data.tokens``, copied so the port imports nothing
of the reference; numpy only, so both packages draw bit-identical
streams for every ``(seed, node, step)``).

Deterministic, infinite, per-node sharded streams. The generator is a
node-seeded Markov-ish process over the vocabulary so that (a) streams are
reproducible given (seed, node, step), (b) per-node distributions are
non-identical (each node has its own transition bias -- the FL non-IID
regime the paper targets), and (c) the next-token task is learnable
(loss decreases measurably within a few hundred steps at 100M scale).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

__all__ = ["TokenStream", "make_fl_token_batches"]


@dataclasses.dataclass
class TokenStream:
    """Per-node reproducible token sampler.

    Each node draws from a mixture: with prob ``struct_p`` the next token is
    a deterministic function of the previous one (node-specific affine map
    mod vocab -- the learnable structure), else uniform noise.
    """

    vocab_size: int
    node: int
    seed: int = 0
    struct_p: float = 0.8

    def sample(self, batch: int, seq_len: int, step: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, self.node, step])
        )
        v = self.vocab_size
        a = 3 + 2 * (self.node % 8)  # node-specific affine map (odd => bijective-ish)
        b = 17 * (self.node + 1)
        toks = np.empty((batch, seq_len), np.int64)
        toks[:, 0] = rng.integers(0, v, size=batch)
        structured = rng.random((batch, seq_len)) < self.struct_p
        noise = rng.integers(0, v, size=(batch, seq_len))
        for t in range(1, seq_len):
            nxt = (a * toks[:, t - 1] + b) % v
            toks[:, t] = np.where(structured[:, t], nxt, noise[:, t])
        return toks.astype(np.int32)


def make_fl_token_batches(
    vocab_size: int,
    n_nodes: int,
    per_node_batch: int,
    seq_len: int,
    q: int,
    seed: int = 0,
    extras: Optional[Dict[str, tuple]] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Infinite iterator of FL-round batches {"tokens": (Q, nodes, pnb,
    seq_len+1)} (+1 because the loss shifts labels). ``extras`` maps key ->
    trailing shape for stubbed frontend embeddings, filled with seeded
    gaussians, e.g. {"prefix_embeds": (16, 256)}.
    """
    streams = [TokenStream(vocab_size, node=i, seed=seed) for i in range(n_nodes)]
    step = 0
    while True:
        toks = np.stack(
            [
                np.stack(
                    [s.sample(per_node_batch, seq_len + 1, step * q + j) for s in streams]
                )
                for j in range(q)
            ]
        )
        out: Dict[str, np.ndarray] = {"tokens": toks}
        if extras:
            rng = np.random.default_rng(np.random.SeedSequence([seed + 7, step]))
            for name, trail in extras.items():
                out[name] = rng.normal(
                    size=(q, n_nodes, per_node_batch) + tuple(trail)
                ).astype(np.float32)
        step += 1
        yield out
