"""The decoder stack for every decoder-only family (counterpart of
``repro.models.transformer``): dense and the VLM backbone (pre-norm GQA
attention + SwiGLU blocks; the VLM's stubbed frontend prepends
``prefix_embeds``), MoE (attention + a routed-expert FFN, ``moe``
blocks, :mod:`repro_torch.models.moe`), RWKV6 (``ssm``: a homogeneous
stack of ``rwkv`` blocks) and RecurrentGemma (``hybrid``: a repeating
pattern of ``recurrent`` RG-LRU and ``local_attention`` blocks; a
pattern may hold any kind), with the training loss (:func:`lm_loss`),
forward (prefill) and one-token decode.

Parameters are nested dicts (and lists) with the reference's storage
layouts, so a reference tree converts leaf for leaf
(``repro_torch.convert.model_params_from_numpy``):

* a homogeneous stack keeps its blocks layer-stacked under ``blocks``
  (leading ``n_layers`` axis);
* a patterned stack with at least two periods keeps ``pblocks``, one
  layer-stacked tree per position in the pattern (leading ``n_periods``
  axis), plus a ``tail`` list of per-layer trees for the layers past the
  last whole period; with fewer than two periods, a ``blocks`` list of
  per-layer trees.

The reference scans over the stacked axes; the port loops over layers,
reading each layer's tree through :func:`_layer_params`.

Training: :func:`lm_loss` is the reference's next-token cross-entropy
over the chunked unembedding (``layers.chunked_softmax_xent``) plus
``router_aux_coef`` times the blocks' aux loss (the MoE blocks'
load-balance term; 0 for every other kind). With ``remat`` (the
default) :func:`forward_hidden` runs each layer under
``torch.utils.checkpoint`` (non-reentrant), where the reference wraps
each scanned layer or period in ``jax.checkpoint``: backward keeps each
layer's input and recomputes the layer, so the attention kernel
launches twice a layer and step, once forward and once in the
recompute. The kernels' wrappers are ``torch.autograd.Function``s whose
backward is plain PyTorch, so every parameter reaches its gradient on
the card as on the CPU.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fl import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.layers import (
    chunked_softmax_xent,
    embed_init,
    embed_lookup,
    rmsnorm,
    rmsnorm_init,
    swiglu,
    swiglu_init,
    unembed_logits,
)

__all__ = [
    "init_params",
    "forward_hidden",
    "lm_loss",
    "prefill",
    "decode_step",
    "init_decode_state",
]

KINDS = ("attention", "local_attention", "moe", "rwkv", "recurrent")
# the kinds whose block is attention then an FFN, with a KV cache
_ATTENTION_KINDS = ("attention", "local_attention", "moe")


def _check_kind(kind: str) -> None:
    if kind not in KINDS:
        raise ValueError(f"unknown block kind {kind}")


def check_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The stack's per-layer block kinds, or ``ValueError`` for an
    unknown one."""
    pattern = cfg.effective_pattern
    for kind in pattern:
        _check_kind(kind)
    return pattern


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)




# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def init_block(generator, cfg: ModelConfig, kind: str, device=None, lead=()) -> Dict:
    """One block's parameters; ``lead=(n,)`` draws a layer-stacked tree of
    n blocks at once (the reference vmaps over layer keys)."""
    _check_kind(kind)
    dt, d = _pdtype(cfg), cfg.d_model
    if kind in _ATTENTION_KINDS:
        block = {
            "ln1": rmsnorm_init(d, dt, device, lead),
            "attn": attn.attn_init(
                generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt, cfg.qkv_bias,
                n_heads_layout=attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
                device=device, lead=lead,
            ),
            "ln2": rmsnorm_init(d, dt, device, lead),
        }
        if kind == "moe":
            block["moe"] = moe_mod.moe_init(generator, d, cfg.d_ff, cfg.n_experts, dt,
                                            cfg.shared_expert, device, lead)
        else:
            block["mlp"] = swiglu_init(generator, d, cfg.d_ff, dt, device, lead)
        return block
    if kind == "rwkv":
        return {
            "ln1": rmsnorm_init(d, dt, device, lead),
            "ln2": rmsnorm_init(d, dt, device, lead),
            "rwkv": rwkv_mod.rwkv_block_init(generator, d, cfg.d_ff, dt, device, lead),
        }
    return {  # recurrent
        "ln1": rmsnorm_init(d, dt, device, lead),
        "rglru": rglru_mod.rglru_block_init(generator, d, cfg.rnn_width or d,
                                            cfg.conv_width, dt, device, lead),
        "ln2": rmsnorm_init(d, dt, device, lead),
        "mlp": swiglu_init(generator, d, cfg.d_ff, dt, device, lead),
    }


def apply_block_train(p: Dict, kind: str, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (train / prefill) block from zero recurrent states.
    Returns (x, aux loss), the aux loss 0 for every kind but ``moe``."""
    _check_kind(kind)
    cd, eps = _cdtype(cfg), cfg.norm_eps
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind in _ATTENTION_KINDS:
        h = attn.attn_apply(
            p["attn"], rmsnorm(p["ln1"], x, eps), positions,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, causal=True,
            window=cfg.window if kind == "local_attention" else 0, compute_dtype=cd,
            n_heads_layout=attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
        )
        x = x + h
        m, moe_aux = _ffn(p, kind, cfg, rmsnorm(p["ln2"], x, eps))
        return x + m, aux if moe_aux is None else moe_aux
    b = x.shape[0]
    if kind == "rwkv":
        st = rwkv_mod.rwkv_decode_states(b, cfg.d_model, device=x.device)
        h, _, _ = rwkv_mod.rwkv_time_mix(p["rwkv"]["time"], rmsnorm(p["ln1"], x, eps),
                                         st["tm_prev"], st["s"], cd)
        x = x + h
        c, _ = rwkv_mod.rwkv_channel_mix(p["rwkv"]["channel"], rmsnorm(p["ln2"], x, eps),
                                         st["cm_prev"], cd)
        return x + c, aux
    st = rglru_mod.rglru_decode_state(b, cfg.rnn_width or cfg.d_model, cfg.conv_width,
                                      device=x.device)
    h, _ = rglru_mod.rglru_block_apply(p["rglru"], rmsnorm(p["ln1"], x, eps), st, cd)
    x = x + h
    return x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, eps), cd), aux


def _ffn(p: Dict, kind: str, cfg: ModelConfig,
         h: torch.Tensor) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An attention block's FFN on its normed input: the routed experts
    and their aux loss for ``moe``, else the SwiGLU and None."""
    if kind == "moe":
        return moe_mod.moe_apply(p["moe"], h, n_experts=cfg.n_experts,
                                 k=cfg.experts_per_token,
                                 capacity_factor=cfg.moe_capacity_factor,
                                 compute_dtype=_cdtype(cfg))
    return swiglu(p["mlp"], h, _cdtype(cfg)), None


# ---------------------------------------------------------------------------
# whole-stack init / forward
# ---------------------------------------------------------------------------


def _period_split(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(period, n_periods, n_tail) of a patterned stack: its periods are
    stored layer-stacked when there are at least two; otherwise every
    layer is in the tail."""
    period = len(cfg.block_pattern) or 1
    n_periods = cfg.n_layers // period
    if n_periods < 2:
        return period, 0, cfg.n_layers
    return period, n_periods, cfg.n_layers - n_periods * period


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> Dict:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (``cuda``
    unless given), drawn from ``generator`` on its own device (a CUDA
    generator draws on the card), in the reference's storage layout (see
    the module docstring). On ``device="meta"`` nothing is drawn and
    ``generator`` may be None: the tree of shapes and dtypes."""
    pattern = check_kinds(cfg)
    dev = resolve_device(device)
    dt = _pdtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
    }
    if cfg.is_homogeneous:
        params["blocks"] = init_block(generator, cfg, pattern[0], dev, lead=(cfg.n_layers,))
    else:
        period, n_periods, n_tail = _period_split(cfg)
        if n_periods:
            params["pblocks"] = [init_block(generator, cfg, pattern[pos], dev,
                                            lead=(n_periods,)) for pos in range(period)]
            params["tail"] = [init_block(generator, cfg, pattern[n_periods * period + i], dev)
                              for i in range(n_tail)]
        else:
            params["blocks"] = [init_block(generator, cfg, kind, dev) for kind in pattern]
    if not cfg.tie_embeddings:
        params["head"] = embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, dev)
    return params


def _layer_params(params: Dict, cfg: ModelConfig, i: int) -> Dict:
    """Layer i's parameter tree in any of the three storage layouts:
    views into the stacked leaves, or the per-layer tree itself."""
    if cfg.is_homogeneous:
        return tree_map(lambda a: a[i], params["blocks"])
    if "pblocks" in params:
        period, n_periods, _ = _period_split(cfg)
        if i < n_periods * period:
            p, pos = divmod(i, period)
            return tree_map(lambda a: a[p], params["pblocks"][pos])
        return params["tail"][i - n_periods * period]
    return params["blocks"][i]


def _table(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed" if cfg.tie_embeddings else "head"]["table"]


def forward_hidden(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor,
                   remat: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs (B,S,d) -> final hidden (B,S,d), total aux loss.
    ``remat`` runs each layer under non-reentrant activation
    checkpointing (the layers draw no random numbers, so no RNG state is
    kept)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, kind in enumerate(check_kinds(cfg)):
        args = (_layer_params(params, cfg, i), kind, cfg, x, positions)
        if remat:
            x, a = checkpoint(apply_block_train, *args, use_reentrant=False,
                              preserve_rng_state=False)
        else:
            x, a = apply_block_train(*args)
        aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def _embed_inputs(params: Dict, cfg: ModelConfig,
                  batch: Dict) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(embedded (B,S,d), positions (B,S), labels (B,S)) of a training
    batch: ``tokens`` (B, S+1) split into inputs and next-token labels;
    a stubbed frontend's ``prefix_embeds`` (B, P, d) go first, with -1
    (ignored) labels."""
    cd = _cdtype(cfg)
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:]
    emb = embed_lookup(params["embed"], inputs, cd)
    if cfg.frontend != "none" and "prefix_embeds" in batch:
        pre = batch["prefix_embeds"].to(cd)
        emb = torch.cat([pre, emb], dim=1)
        labels = torch.cat([torch.full(pre.shape[:2], -1, dtype=labels.dtype,
                                       device=labels.device), labels], dim=1)
    b, s, _ = emb.shape
    positions = torch.arange(s, dtype=torch.int32, device=emb.device)[None].expand(b, s)
    return emb, positions, labels


def lm_loss(params: Dict, cfg: ModelConfig, batch: Dict, remat: bool = True,
            loss_chunk: int = 512) -> torch.Tensor:
    """Next-token cross-entropy (mean over the valid tokens) plus the
    blocks' aux loss times ``router_aux_coef``, for one node's params and
    batch (``tokens`` (B, S+1))."""
    emb, positions, labels = _embed_inputs(params, cfg, batch)
    h, aux = forward_hidden(params, cfg, emb, positions, remat)
    loss = chunked_softmax_xent(_table(params, cfg), h, labels, cfg.vocab_size,
                                chunk=loss_chunk, compute_dtype=_cdtype(cfg))
    return loss + cfg.router_aux_coef * aux


def prefill(params: Dict, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over ``batch["tokens"]`` (B, S), returning the
    last position's logits (B, padded_vocab) and hidden state (B, d).
    Like the reference, it writes no cache."""
    cd = _cdtype(cfg)
    tokens = batch["tokens"]
    emb = embed_lookup(params["embed"], tokens, cd)
    if cfg.frontend != "none" and "prefix_embeds" in batch:
        emb = torch.cat([batch["prefix_embeds"].to(cd), emb], dim=1)
    b, s, _ = emb.shape
    positions = torch.arange(s, dtype=torch.int32, device=emb.device)[None].expand(b, s)
    h, _ = forward_hidden(params, cfg, emb, positions, remat=False)
    return unembed_logits(_table(params, cfg), h[:, -1], cd), h[:, -1]


# ---------------------------------------------------------------------------
# decode (serving)
# ---------------------------------------------------------------------------


def _decode_kinds(cfg: ModelConfig, max_seq: int,
                  sliding_override: bool) -> Tuple[Tuple[str, int], ...]:
    """(kind, cache_len) per layer. ``sliding_override`` replaces full
    attention with a window ring buffer (the reference's long-context
    policy for dense archs)."""
    out = []
    for kind in cfg.effective_pattern:
        if kind in ("attention", "moe"):
            if sliding_override:
                out.append((kind, min(cfg.window or 4096, max_seq)))
            else:
                out.append((kind, max_seq))
        elif kind == "local_attention":
            out.append((kind, min(cfg.window or max_seq, max_seq)))
        else:
            out.append((kind, 0))
    return tuple(out)


def init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                      sliding_override: bool = False, cache_dtype=torch.bfloat16,
                      device=None) -> Any:
    """Zero decode states on ``device`` (``cuda`` unless given), in the
    reference's layout: a homogeneous stack gets layer-stacked states
    (leading ``n_layers`` axis), a patterned stack a list of per-layer
    states. An attention layer's state is its KV cache -- k, v (B,
    cache_len, K, hd) in ``cache_dtype`` and pos, an int32 scalar; an
    RWKV layer's the token-shift carries and the WKV state (fp32); an
    RG-LRU layer's the recurrence and the conv's trailing inputs (fp32)."""
    check_kinds(cfg)
    dev = resolve_device(device)

    def one(kind: str, cache_len: int) -> Dict:
        if kind in _ATTENTION_KINDS:
            return attn.init_kv_cache(batch, cache_len, cfg.n_kv_heads, cfg.head_dim,
                                      cache_dtype, dev)
        if kind == "rwkv":
            return rwkv_mod.rwkv_decode_states(batch, cfg.d_model, device=dev)
        return rglru_mod.rglru_decode_state(batch, cfg.rnn_width or cfg.d_model,
                                            cfg.conv_width, device=dev)

    kinds = _decode_kinds(cfg, max_seq, sliding_override)
    if cfg.is_homogeneous:
        return {key: torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype, device=a.device)
                for key, a in one(*kinds[0]).items()}
    return [one(kind, cache_len) for kind, cache_len in kinds]


def apply_block_decode(p: Dict, kind: str, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict, ring: bool) -> Tuple[torch.Tensor, Dict]:
    _check_kind(kind)
    cd, eps = _cdtype(cfg), cfg.norm_eps
    if kind in _ATTENTION_KINDS:
        h, state = attn.attn_decode(
            p["attn"], rmsnorm(p["ln1"], x, eps), state,
            n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
            rope_theta=cfg.rope_theta, ring=ring or kind == "local_attention",
            compute_dtype=cd,
            n_heads_layout=attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
        )
        x = x + h
        m, _ = _ffn(p, kind, cfg, rmsnorm(p["ln2"], x, eps))
        return x + m, state
    if kind == "rwkv":
        h, tm_prev, s_new = rwkv_mod.rwkv_time_mix(
            p["rwkv"]["time"], rmsnorm(p["ln1"], x, eps), state["tm_prev"], state["s"], cd)
        x = x + h
        c, cm_prev = rwkv_mod.rwkv_channel_mix(
            p["rwkv"]["channel"], rmsnorm(p["ln2"], x, eps), state["cm_prev"], cd)
        return x + c, {"tm_prev": tm_prev, "cm_prev": cm_prev, "s": s_new}
    h, state = rglru_mod.rglru_block_apply(p["rglru"], rmsnorm(p["ln1"], x, eps), state, cd)
    x = x + h
    return x + swiglu(p["mlp"], rmsnorm(p["ln2"], x, eps), cd), state


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, caches: Any,
                sliding_override: bool = False) -> Tuple[torch.Tensor, Any]:
    """One decode step: tokens (B,) -> (logits (B, padded_vocab), caches).

    Attention layers write their new K/V row into their cache in place
    and return the same k/v tensors with pos + 1. Recurrent layers return
    new states, which the returned caches hold: restacked for a
    homogeneous stack, so each state keeps the dtype its layer gave it
    (the reference's: the token-shift carries turn from fp32 to the
    residual stream's dtype after the first step)."""
    pattern = check_kinds(cfg)
    cd = _cdtype(cfg)
    x = embed_lookup(params["embed"], tokens[:, None], cd)  # (B,1,d)
    if cfg.is_homogeneous:
        kind = pattern[0]
        new: List[Dict] = []
        for i in range(cfg.n_layers):
            layer_cache = {key: a[i] for key, a in caches.items()}
            x, c = apply_block_decode(_layer_params(params, cfg, i), kind, cfg, x,
                                      layer_cache, ring=sliding_override)
            new.append(c)
        if kind in _ATTENTION_KINDS:
            caches = {"k": caches["k"], "v": caches["v"], "pos": caches["pos"] + 1}
        else:
            caches = {key: torch.stack([c[key] for c in new]) for key in caches}
    else:
        new_caches = []
        for i, kind in enumerate(pattern):
            x, c = apply_block_decode(_layer_params(params, cfg, i), kind, cfg, x,
                                      caches[i], ring=sliding_override)
            new_caches.append(c)
        caches = new_caches
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed_logits(_table(params, cfg), x[:, 0], cd)
    return logits, caches
