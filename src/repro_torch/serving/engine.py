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
serving-side lag in training rounds.

Serving from a mapped consensus snapshot (``training.snapshot``):
``from_snapshot`` builds an engine on a snapshot's leaves and
``publish_snapshot`` hot-swaps one in, the snapshot pinned as the
active weights' ``keepalive`` (its map backs the leaves). With
``stage=True`` the leaves are copied to the engine's device in the
publisher's thread; ``stage=False`` serves the host views as they are,
which torch can do only on a CPU engine -- a CUDA engine refuses it
(torch moves no host tensor to the card implicitly).

The engine runs on the device its parameters live on; the caches and
sampling follow them there. For the audio (enc-dec) family,
``generate`` takes the stubbed frontend's ``frames``, encodes them once
with the active weights and fills the decoder's cross-attention caches
before the prompt steps.
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
from repro_torch.device import resolve_device
from repro_torch.models import encdec as encdec_mod
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
        # pending slot: (params, round, keepalive) or None. Written by
        # publisher threads, consumed by the decode loop; a single
        # reference assignment either way, atomic under the GIL.
        self._pending: Optional[Tuple[Dict, Optional[int], Any]] = None
        # keepalive of the active weights (the mapped Snapshot whose
        # views the params are, when served unstaged)
        self._active_ref: Any = None
        self.swap_count = 0
        self.swap_pauses: List[float] = []  # seconds per completed swap

    @classmethod
    def from_snapshot(cls, bundle: ModelBundle, snapshot, max_seq: int, batch: int,
                      sliding_override: bool = False, stage: bool = True,
                      device=None) -> "ServeEngine":
        """Serve straight from a mapped consensus snapshot
        (``training.snapshot.load_snapshot``) on ``device`` (``cuda``
        unless given). ``stage=True`` copies the views to the device once,
        up front (the pages fault in from the blob as they are read);
        ``stage=False`` serves the host views themselves, on a CPU engine
        only."""
        dev = resolve_device(device)
        params = _staged(snapshot.params, dev, stage)
        eng = cls(bundle, params, max_seq, batch, sliding_override=sliding_override,
                  snapshot_round=snapshot.round_frontier)
        eng._active_ref = snapshot
        return eng

    # ---------------------------------------------------------- hot swap

    def publish(self, params: Dict, snapshot_round: Optional[int] = None,
                keepalive: Any = None, stage: bool = True) -> None:
        """Stage new weights into the pending slot (any thread).

        The decode loop promotes them at its next step boundary. With
        ``stage=True`` the leaves (mapped views, say) are copied to the
        engine's device HERE, in the publisher's thread, so the decode
        loop's swap stays a reference assignment; ``stage=False`` takes
        them as they are, which must be on the engine's device.
        ``keepalive`` pins whatever owns the leaves' memory (a Snapshot)
        for as long as they are active."""
        self._pending = (_staged(params, self.device, stage), snapshot_round, keepalive)

    def publish_snapshot(self, snapshot, stage: bool = True) -> None:
        """Publish a mapped consensus snapshot."""
        self.publish(snapshot.params, snapshot.round_frontier, keepalive=snapshot,
                     stage=stage)

    def _maybe_swap(self) -> bool:
        """Promote the pending weight slot, if any. Called by the decode
        loop between steps; never blocks on the publisher."""
        pend = self._pending
        if pend is None:
            return False
        t0 = time.perf_counter()
        params, rnd, keep = pend
        self._pending = None
        self.params = params
        self.snapshot_round = rnd
        self._active_ref = keep
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

    def new_caches(self, frames: Optional[np.ndarray] = None) -> Any:
        """Zero decode states: a dict of layer-stacked states for a
        homogeneous stack, a list of per-layer states for a patterned one.
        For the audio family, ``frames`` (B, T_enc, d) are encoded once
        with the active weights and fill the cross-attention caches."""
        caches = self.bundle.init_decode_state_fn(
            self.batch, self.max_seq, sliding_override=self.sliding, device=self.device)
        if self.cfg.family != "audio":
            return caches
        if frames is None:
            raise ValueError(f"{self.cfg.name} is an enc-dec model: its decode "
                             "state needs the encoder's frames")
        enc_out = encdec_mod.encode(self.params, self.cfg,
                                    torch.as_tensor(frames, device=self.device))
        return encdec_mod.encdec_fill_cross_kv(self.params, self.cfg, enc_out, caches)

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
                 temperature: float = 0.0, seed: int = 0,
                 frames: Optional[np.ndarray] = None) -> GenerationResult:
        """prompts: (B, P) integer token ids. Returns the prompts followed
        by ``max_new_tokens`` sampled tokens per row. For the audio family
        pass ``frames`` (B, T_enc, d) (stub frontend embeddings); the
        engine encodes once and fills the cross-attention caches."""
        b, p = prompts.shape
        if b != self.batch:
            raise ValueError(f"engine built for batch {self.batch}, got {b}")
        caches = self.new_caches(frames)
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


def _staged(params: Dict, device: torch.device, stage: bool) -> Dict:
    """``params`` on ``device``: copied there when ``stage``, else taken
    as they are, which must already be there (no implicit copy)."""
    if stage:
        return tree_map(lambda a: a.to(device), params)
    off = sorted({str(leaf.device) for _, leaf in tree_leaves(params)
                  if leaf.device != device})
    if off:
        raise ValueError(
            f"stage=False serves the leaves where they are ({', '.join(off)}), but "
            f"the engine runs on {device}; torch moves no host tensor to the "
            "card implicitly -- pass stage=True to copy them in the "
            "publisher's thread"
        )
    return params
