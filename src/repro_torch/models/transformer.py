"""The decoder stack for dense decoder-only models (counterpart of
``repro.models.transformer``): pre-norm GQA attention + SwiGLU blocks,
tied or separate embeddings, forward (prefill) and one-token decode.

Parameters are nested dicts with the reference's layout: the homogeneous
stack keeps its blocks layer-stacked under ``blocks`` (leading
``n_layers`` axis), so a reference tree converts leaf for leaf
(``repro_torch.convert.model_params_from_numpy``). The reference scans
over that axis; the port loops over layers. Only the dense
("attention") block kind is ported: MoE, RWKV6, RG-LRU and local
attention raise ``NotImplementedError`` naming their ROADMAP.md item.
Training (``lm_loss``, remat) waits for the port's training slice.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fl import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.layers import (
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
    "prefill",
    "decode_step",
    "init_decode_state",
]

# block kinds of the reference that the port does not have yet
_UNPORTED_KINDS = {
    "moe": "MoE blocks (ROADMAP.md queue 1 item 16)",
    "rwkv": "RWKV6 blocks and their scan kernel (ROADMAP.md queue 1 item 16, "
            "queue 2 item 10)",
    "recurrent": "RG-LRU blocks and their scan kernel (ROADMAP.md queue 1 item 16, "
                 "queue 2 item 11)",
    "local_attention": "local-attention blocks of the hybrid family (ROADMAP.md "
                       "queue 1 item 16)",
}


def _check_kind(kind: str) -> None:
    if kind in _UNPORTED_KINDS:
        raise NotImplementedError(f"{_UNPORTED_KINDS[kind]} are not ported yet")
    if kind != "attention":
        raise ValueError(f"unknown block kind {kind}")


def check_dense(cfg: ModelConfig) -> str:
    """The one block kind of a stack the port can run ("attention"), or
    ``NotImplementedError`` for any other kind."""
    for kind in cfg.effective_pattern:
        _check_kind(kind)
    return "attention"


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _pdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


# ---------------------------------------------------------------------------
# per-block init / apply
# ---------------------------------------------------------------------------


def init_block(generator, cfg: ModelConfig, kind: str, device=None, lead=()) -> Dict:
    """One block's parameters; ``lead=(n_layers,)`` draws the whole
    layer-stacked tree at once (the reference vmaps over layer keys)."""
    _check_kind(kind)
    dt, d = _pdtype(cfg), cfg.d_model
    return {
        "ln1": rmsnorm_init(d, dt, device, lead),
        "attn": attn.attn_init(
            generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, dt, cfg.qkv_bias,
            n_heads_layout=attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
            device=device, lead=lead,
        ),
        "ln2": rmsnorm_init(d, dt, device, lead),
        "mlp": swiglu_init(generator, d, cfg.d_ff, dt, device, lead),
    }


def apply_block_train(p: Dict, kind: str, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence (prefill) block, forward only. Returns (x, aux loss),
    the aux loss 0 for the dense block."""
    _check_kind(kind)
    cd, eps = _cdtype(cfg), cfg.norm_eps
    h = attn.attn_apply(
        p["attn"], rmsnorm(p["ln1"], x, eps), positions,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, causal=True, window=0, compute_dtype=cd,
        n_heads_layout=attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
    )
    x = x + h
    m = swiglu(p["mlp"], rmsnorm(p["ln2"], x, eps), cd)
    return x + m, torch.zeros((), dtype=torch.float32, device=x.device)


# ---------------------------------------------------------------------------
# whole-stack init / forward
# ---------------------------------------------------------------------------


def init_params(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> Dict:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (``cuda``
    unless given), drawn from ``generator`` on its own device (a CUDA
    generator draws on the card). On ``device="meta"`` nothing is drawn
    and ``generator`` may be None: the tree of shapes and dtypes."""
    kind = check_dense(cfg)
    dev = resolve_device(device)
    dt = _pdtype(cfg)
    params: Dict[str, Any] = {
        "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, dev),
        "final_norm": rmsnorm_init(cfg.d_model, dt, dev),
        "blocks": init_block(generator, cfg, kind, dev, lead=(cfg.n_layers,)),
    }
    if not cfg.tie_embeddings:
        params["head"] = embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, dev)
    return params


def _layer_params(params: Dict, cfg: ModelConfig, i: int) -> Dict:
    """Layer i's parameter tree: views into the layer-stacked leaves."""
    return tree_map(lambda a: a[i], params["blocks"])


def _table(params: Dict, cfg: ModelConfig) -> torch.Tensor:
    return params["embed" if cfg.tie_embeddings else "head"]["table"]


def forward_hidden(params: Dict, cfg: ModelConfig, x: torch.Tensor,
                   positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Embedded inputs (B,S,d) -> final hidden (B,S,d), total aux loss."""
    kind = check_dense(cfg)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, a = apply_block_train(_layer_params(params, cfg, i), kind, cfg, x, positions)
        aux = aux + a
    return rmsnorm(params["final_norm"], x, cfg.norm_eps), aux


def prefill(params: Dict, cfg: ModelConfig, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward over ``batch["tokens"]`` (B, S), returning the
    last position's logits (B, padded_vocab) and hidden state (B, d).
    Like the reference, it writes no KV cache."""
    cd = _cdtype(cfg)
    tokens = batch["tokens"]
    emb = embed_lookup(params["embed"], tokens, cd)
    if cfg.frontend != "none" and "prefix_embeds" in batch:
        emb = torch.cat([batch["prefix_embeds"].to(cd), emb], dim=1)
    b, s, _ = emb.shape
    positions = torch.arange(s, dtype=torch.int32, device=emb.device)[None].expand(b, s)
    h, _ = forward_hidden(params, cfg, emb, positions)
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
                      device=None) -> Dict:
    """Layer-stacked KV caches, zeros on ``device`` (``cuda`` unless
    given): k, v (n_layers, B, cache_len, K, hd) in ``cache_dtype`` and
    pos (n_layers,) int32, the reference's layout for a homogeneous
    stack."""
    check_dense(cfg)
    _, cache_len = _decode_kinds(cfg, max_seq, sliding_override)[0]
    one = attn.init_kv_cache(batch, cache_len, cfg.n_kv_heads, cfg.head_dim,
                             cache_dtype, device)
    return {key: torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype, device=a.device)
            for key, a in one.items()}


def apply_block_decode(p: Dict, kind: str, cfg: ModelConfig, x: torch.Tensor,
                       state: Dict, ring: bool) -> Tuple[torch.Tensor, Dict]:
    _check_kind(kind)
    cd, eps = _cdtype(cfg), cfg.norm_eps
    h, state = attn.attn_decode(
        p["attn"], rmsnorm(p["ln1"], x, eps), state,
        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
        rope_theta=cfg.rope_theta, ring=ring, compute_dtype=cd,
        n_heads_layout=attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
    )
    x = x + h
    m = swiglu(p["mlp"], rmsnorm(p["ln2"], x, eps), cd)
    return x + m, state


def decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, caches: Dict,
                sliding_override: bool = False) -> Tuple[torch.Tensor, Dict]:
    """One decode step: tokens (B,) -> (logits (B, padded_vocab), caches).
    Each layer writes its new K/V row into its slice of the stacked
    caches in place; the returned caches hold the same k/v and pos + 1."""
    kind = check_dense(cfg)
    cd = _cdtype(cfg)
    x = embed_lookup(params["embed"], tokens[:, None], cd)  # (B,1,d)
    for i in range(cfg.n_layers):
        layer_cache = {key: a[i] for key, a in caches.items()}
        x, _ = apply_block_decode(_layer_params(params, cfg, i), kind, cfg, x,
                                  layer_cache, ring=sliding_override)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    logits = unembed_logits(_table(params, cfg), x[:, 0], cd)
    return logits, {"k": caches["k"], "v": caches["v"], "pos": caches["pos"] + 1}
