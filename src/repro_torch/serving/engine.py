"""Batched serving engine: prefill a prompt batch, then step-decode
(counterpart of ``repro.serving.engine``).

The engine serves the CONSENSUS model produced by FL training. Prefill
populates the per-layer caches by replaying the prompt through the
decode step, token at a time, as the reference does. Decoding is greedy
or temperature sampling from a ``torch.Generator`` on the engine's
device (Gumbel-max, the distribution of ``jax.random.categorical``; the
draws differ from JAX's).

Hot-swap: the engine holds a double-buffered weight slot. A training
loop or snapshot watcher calls :meth:`ServeEngine.publish` from any
thread to stage new weights into the PENDING slot; the decode loop
promotes pending -> active with one reference swap at the next step
boundary (:meth:`decode_step`), so new weights land without draining
in-flight batches -- the KV caches carry over untouched, and every step
runs against exactly one weight set. Staging (the copy to the engine's
device) happens in the PUBLISHER's thread; the decode loop pays only the
swap, timed per swap in ``swap_pauses``. ``snapshot_round`` is the round
frontier of the ACTIVE weights, so ``staleness(frontier)`` is the
serving-side lag in training rounds. Serving from an mmap'd snapshot
(``from_snapshot`` / ``publish_snapshot``, and ``publish``'s
``keepalive`` / ``stage`` arguments that serve it) waits for the port's
snapshot module.

The engine runs on the device its parameters live on; the caches and
sampling follow them there.
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fl import tree_map
from repro_torch.core.packing import tree_leaves
from repro_torch.models.model import ModelBundle

__all__ = ["ServeEngine", "GenerationResult"]


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray  # (B, prompt+generated) int32
    prompt_len: int
    steps: int
    #: absolute step indices (0 = first prefill step) at whose BOUNDARY a
    #: published weight set was swapped in during this call
    swap_steps: Tuple[int, ...] = ()


class ServeEngine:
    def __init__(self, bundle: ModelBundle, params: Dict, max_seq: int, batch: int,
                 sliding_override: bool = False,
                 snapshot_round: Optional[int] = None) -> None:
        self.bundle = bundle
        self.cfg: ModelConfig = bundle.cfg
        self.params = params
        self.device = tree_leaves(params)[0][1].device
        self.max_seq = max_seq
        self.batch = batch
        self.sliding = sliding_override
        self._step = functools.partial(bundle.decode_fn,
                                       sliding_override=sliding_override)
        #: round frontier of the ACTIVE weights (None = unknown/seed)
        self.snapshot_round = snapshot_round
        # pending slot: (params, round) or None. Written by publisher
        # threads, consumed by the decode loop; a single reference
        # assignment either way, atomic under the GIL.
        self._pending: Optional[Tuple[Dict, Optional[int]]] = None
        self.swap_count = 0
        self.swap_pauses: List[float] = []  # seconds per completed swap

    # ---------------------------------------------------------- hot swap

    def publish(self, params: Dict, snapshot_round: Optional[int] = None) -> None:
        """Stage new weights into the pending slot (any thread).

        The decode loop promotes them at its next step boundary. The
        leaves are copied to the engine's device HERE, in the publisher's
        thread, so the decode loop's swap stays a reference assignment."""
        self._pending = (tree_map(lambda a: a.to(self.device), params), snapshot_round)

    def _maybe_swap(self) -> bool:
        """Promote the pending weight slot, if any. Called by the decode
        loop between steps; never blocks on the publisher."""
        pend = self._pending
        if pend is None:
            return False
        t0 = time.perf_counter()
        params, rnd = pend
        self._pending = None
        self.params = params
        self.snapshot_round = rnd
        self.swap_pauses.append(time.perf_counter() - t0)
        self.swap_count += 1
        return True

    def staleness(self, frontier: int) -> Optional[int]:
        """Rounds the ACTIVE weights lag the training frontier, or None
        when the engine was built from raw params with no round."""
        if self.snapshot_round is None:
            return None
        return int(frontier) - int(self.snapshot_round)

    # ------------------------------------------------------------ decode

    def decode_step(self, tokens: torch.Tensor, caches: Any):
        """One decode step at a swap boundary: promote any pending
        weights, then step. Returns (logits, caches, swapped): attention
        caches are updated in place, recurrent states come back new."""
        swapped = self._maybe_swap()
        logits, caches = self._step(self.params, tokens, caches)
        return logits, caches, swapped

    def new_caches(self) -> Any:
        """Zero decode states: a dict of layer-stacked states for a
        homogeneous stack, a list of per-layer states for a patterned one."""
        return self.bundle.init_decode_state_fn(
            self.batch, self.max_seq, sliding_override=self.sliding, device=self.device)

    def _sample(self, logits: torch.Tensor, generator: torch.Generator,
                temperature: float) -> torch.Tensor:
        # mask the padded vocab
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        lf = torch.where(vocab < self.cfg.vocab_size, logits.float(), -1e30)
        if temperature <= 0.0:
            return torch.argmax(lf, dim=-1)
        u = torch.rand(lf.shape, generator=generator, device=lf.device)
        return torch.argmax(lf / temperature - torch.log(-torch.log(u)), dim=-1)

    def generate(self, prompts: np.ndarray, max_new_tokens: int,
                 temperature: float = 0.0, seed: int = 0) -> GenerationResult:
        """prompts: (B, P) integer token ids. Returns the prompts followed
        by ``max_new_tokens`` sampled tokens per row."""
        b, p = prompts.shape
        if b != self.batch:
            raise ValueError(f"engine built for batch {self.batch}, got {b}")
        caches = self.new_caches()
        toks = torch.as_tensor(np.asarray(prompts), dtype=torch.long, device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        swap_steps: List[int] = []

        # prefill by stepping the prompt through the decode path
        logits = None
        for t in range(p):
            logits, caches, swapped = self.decode_step(toks[:, t], caches)
            if swapped:
                swap_steps.append(t)

        cur = self._sample(logits, generator, temperature)
        generated = [cur]
        for i in range(max_new_tokens - 1):
            logits, caches, swapped = self.decode_step(cur, caches)
            if swapped:
                swap_steps.append(p + i)
            cur = self._sample(logits, generator, temperature)
            generated.append(cur)
        # one transfer at the end: the decode loop never waits on the host
        new = torch.stack(generated, dim=1).to(torch.int32).cpu().numpy()
        tokens = np.concatenate([np.asarray(prompts, np.int32), new], axis=1)
        return GenerationResult(tokens=tokens, prompt_len=p, steps=p + max_new_tokens,
                                swap_steps=tuple(swap_steps))
