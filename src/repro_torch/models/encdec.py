"""Whisper-style encoder--decoder backbone [arXiv:2212.04356]
(counterpart of ``repro.models.encdec``).

The mel-spectrogram + conv feature extractor is a STUB, as in the
reference: callers supply precomputed frame embeddings (B, T_enc,
d_model) and this module runs the transformer that consumes them.

Encoder: learned positions, bidirectional attention (one non-causal
flash call a layer on the card), GELU MLP, pre-LN. Decoder: token +
learned positional embeddings (no RoPE), causal self-attention,
cross-attention over the encoder output (flash at prefill and in the
loss, the decode kernel over the whole cross cache at a decode step),
GELU MLP. Whisper's published decoder context is 448; the position table
holds ``DEC_POS_LEN`` rows, the reference's decode_32k stress shape.

Parameters keep the reference's layout: ``enc`` {``pos``, layer-stacked
``blocks``, ``final_ln``} and ``dec`` {``embed``, ``pos``, layer-stacked
``blocks``, ``final_ln``}; the port loops over the stacked layers where
the reference scans. The decode state is the reference's: the
layer-stacked self-attention caches under ``self`` and the per-layer
cross K/V ``cross_k`` / ``cross_v`` (n_layers, B, T_enc, H, hd), filled
by :func:`encdec_fill_cross_kv` after :func:`encode`.

On a model group (``tp``, ``models.tensor_parallel``) :func:`encdec_loss`
runs on a rank's shards (``models.sharding.shard_params``): the
encoder's self-attention and GELU MLP, the decoder's self-attention,
cross-attention and MLP column- then row-parallel on the rank's heads
and columns (``models.attention``, ``models.layers``); the decoder's
embedding lookup and the tied loss vocab-parallel; the frames, both
position tables and the layernorms replicated. The encoder output, a
replicated input that every decoder layer's cross K/V reads, passes
``copy_to_model`` once, before the decoder: its gradient sums every
layer's on each rank, then one all-reduce sums the ranks'.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.fl import tree_map
from repro_torch.device import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models.tensor_parallel import TPGroup, copy_to_model
from repro_torch.models.layers import (
    chunked_softmax_xent,
    embed_init,
    embed_lookup,
    gelu_mlp,
    gelu_mlp_init,
    layernorm,
    layernorm_init,
    normal_init,
    unembed_logits,
)

__all__ = [
    "encdec_init",
    "encode",
    "encdec_loss",
    "encdec_prefill",
    "encdec_decode_step",
    "encdec_init_decode_state",
    "encdec_fill_cross_kv",
    "DEC_POS_LEN",
]

DEC_POS_LEN = 32768  # decode_32k stress shape (whisper native: 448)


def _cdtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.compute_dtype)


def _enc_block_init(generator, d: int, n_heads: int, d_ff: int, dt, device, lead) -> Dict:
    hd = d // n_heads
    return {
        "ln1": layernorm_init(d, dt, device, lead),
        "attn": attn.attn_init(generator, d, n_heads, n_heads, hd, dt, qkv_bias=True,
                               device=device, lead=lead),
        "ln2": layernorm_init(d, dt, device, lead),
        "mlp": gelu_mlp_init(generator, d, d_ff, dt, device, lead),
    }


def _dec_block_init(generator, cfg: ModelConfig, dt, device, lead) -> Dict:
    d = cfg.d_model
    return {
        "ln1": layernorm_init(d, dt, device, lead),
        "self_attn": attn.attn_init(generator, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                    dt, qkv_bias=True, device=device, lead=lead),
        "ln2": layernorm_init(d, dt, device, lead),
        "cross_attn": attn.cross_attn_init(generator, d, cfg.n_heads, cfg.head_dim, dt,
                                           device, lead),
        "ln3": layernorm_init(d, dt, device, lead),
        "mlp": gelu_mlp_init(generator, d, cfg.d_ff, dt, device, lead),
    }


def encdec_init(cfg: ModelConfig, generator: Optional[torch.Generator],
                device=None) -> Dict:
    """Random parameters in ``cfg.param_dtype`` on ``device`` (``cuda``
    unless given), drawn from ``generator``; on ``meta`` only the tree of
    shapes and dtypes (``generator`` may be None)."""
    if cfg.encoder is None:
        raise ValueError(f"{cfg.name}: the enc-dec family needs cfg.encoder")
    dev = resolve_device(device)
    dt = getattr(torch, cfg.param_dtype)
    e = cfg.encoder
    return {
        "enc": {
            "pos": normal_init(generator, (e.seq_len, e.d_model), 0.02, dt, dev),
            "blocks": _enc_block_init(generator, e.d_model, e.n_heads, e.d_ff, dt, dev,
                                      (e.n_layers,)),
            "final_ln": layernorm_init(e.d_model, dt, dev),
        },
        "dec": {
            "embed": embed_init(generator, cfg.padded_vocab, cfg.d_model, dt, dev),
            "pos": normal_init(generator, (DEC_POS_LEN, cfg.d_model), 0.02, dt, dev),
            "blocks": _dec_block_init(generator, cfg, dt, dev, (cfg.n_layers,)),
            "final_ln": layernorm_init(cfg.d_model, dt, dev),
        },
    }


def _layer(blocks: Dict, i: int) -> Dict:
    return tree_map(lambda a: a[i], blocks)


def encode(params: Dict, cfg: ModelConfig, frames: torch.Tensor,
           tp: Optional[TPGroup] = None) -> torch.Tensor:
    """frames: the stubbed conv frontend's embeddings (B, T_enc, d) ->
    the encoder output (B, T_enc, d) in the compute dtype. ``tp``: the
    rank's shards of a model group (the output replicated)."""
    cd = _cdtype(cfg)
    e = cfg.encoder
    t = frames.shape[1]
    x = frames.to(cd) + params["enc"]["pos"][:t].to(cd)[None]
    for i in range(e.n_layers):
        blk = _layer(params["enc"]["blocks"], i)
        a = attn.attn_apply(blk["attn"], layernorm(blk["ln1"], x, cfg.norm_eps), None,
                            n_heads=e.n_heads, n_kv_heads=e.n_heads,
                            head_dim=e.d_model // e.n_heads, rope_theta=None,
                            causal=False, compute_dtype=cd, tp=tp)
        x = x + a
        x = x + gelu_mlp(blk["mlp"], layernorm(blk["ln2"], x, cfg.norm_eps), cd, tp)
    return layernorm(params["enc"]["final_ln"], x, cfg.norm_eps)


def _dec_layer(blk: Dict, cfg: ModelConfig, h: torch.Tensor, enc_out: torch.Tensor,
               tp: Optional[TPGroup] = None) -> torch.Tensor:
    """One decoder layer over a full token sequence h (B, S, d)."""
    cd, eps = _cdtype(cfg), cfg.norm_eps
    a = attn.attn_apply(blk["self_attn"], layernorm(blk["ln1"], h, eps), None,
                        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, rope_theta=None, causal=True,
                        compute_dtype=cd, tp=tp)
    h = h + a
    kv = attn.precompute_cross_kv(blk["cross_attn"], enc_out, cfg.n_heads, cfg.head_dim, cd,
                                  tp)
    h = h + attn.cross_attn_apply(blk["cross_attn"], layernorm(blk["ln2"], h, eps), kv,
                                  n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                  compute_dtype=cd, tp=tp)
    return h + gelu_mlp(blk["mlp"], layernorm(blk["ln3"], h, eps), cd, tp)


def _decode_hidden(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                   enc_out: torch.Tensor, remat: bool,
                   tp: Optional[TPGroup] = None) -> torch.Tensor:
    """The decoder's final hidden states (B, S, d) over ``tokens`` (B, S).
    ``remat`` runs each layer under non-reentrant activation
    checkpointing, where the reference wraps its scanned layer in
    ``jax.checkpoint``. ``tp``: the rank's shards, ``enc_out`` passed
    through ``copy_to_model``."""
    cd = _cdtype(cfg)
    s = tokens.shape[1]
    x = embed_lookup(params["dec"]["embed"], tokens, cd, tp)
    x = x + params["dec"]["pos"][:s].to(cd)[None]
    for i in range(cfg.n_layers):
        blk = _layer(params["dec"]["blocks"], i)
        if remat:
            x = checkpoint(_dec_layer, blk, cfg, x, enc_out, tp, use_reentrant=False,
                           preserve_rng_state=False)
        else:
            x = _dec_layer(blk, cfg, x, enc_out, tp)
    return layernorm(params["dec"]["final_ln"], x, cfg.norm_eps)


def encdec_loss(params: Dict, cfg: ModelConfig, batch: Dict, remat: bool = True,
                loss_chunk: int = 512, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Next-token cross-entropy of one node's batch: {"frames": (B, T_enc,
    d_enc), "tokens": (B, S+1)}. ``tp``: the rank's shards of a model
    group (every rank returns the whole loss)."""
    enc_out = copy_to_model(encode(params, cfg, batch["frames"], tp), tp)
    tokens = batch["tokens"]
    h = _decode_hidden(params, cfg, tokens[:, :-1], enc_out, remat, tp)
    return chunked_softmax_xent(params["dec"]["embed"]["table"], h, tokens[:, 1:],
                                cfg.vocab_size, chunk=loss_chunk,
                                compute_dtype=_cdtype(cfg), tp=tp)


def encdec_prefill(params: Dict, cfg: ModelConfig,
                   batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode ``batch["frames"]`` and run the decoder over
    ``batch["tokens"]`` (B, S): the last position's logits (B,
    padded_vocab) and the encoder output. Like the reference, it writes
    no cache."""
    enc_out = encode(params, cfg, batch["frames"])
    h = _decode_hidden(params, cfg, batch["tokens"], enc_out, remat=False)
    logits = unembed_logits(params["dec"]["embed"]["table"], h[:, -1], _cdtype(cfg))
    return logits, enc_out


def encdec_init_decode_state(cfg: ModelConfig, batch: int, max_seq: int,
                             cache_dtype=torch.bfloat16, device=None) -> Dict:
    """Zero decode state on ``device`` (``cuda`` unless given): the
    layer-stacked self-attention KV caches and the per-layer cross K/V,
    which the engine fills after :func:`encode`."""
    e = cfg.encoder
    dev = resolve_device(device)
    kv = attn.init_kv_cache(batch, max_seq, cfg.n_kv_heads, cfg.head_dim, cache_dtype, dev)
    stacked = {key: torch.zeros((cfg.n_layers, *a.shape), dtype=a.dtype, device=dev)
               for key, a in kv.items()}
    shape = (cfg.n_layers, batch, e.seq_len, cfg.n_heads, cfg.head_dim)
    return {"self": stacked,
            "cross_k": torch.zeros(shape, dtype=cache_dtype, device=dev),
            "cross_v": torch.zeros(shape, dtype=cache_dtype, device=dev)}


def encdec_fill_cross_kv(params: Dict, cfg: ModelConfig, enc_out: torch.Tensor,
                         state: Dict) -> Dict:
    """The state with every layer's cross K/V of ``enc_out``, in the
    state's cache dtype."""
    cd = _cdtype(cfg)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        blk = _layer(params["dec"]["blocks"]["cross_attn"], i)
        k, v = attn.precompute_cross_kv(blk, enc_out, cfg.n_heads, cfg.head_dim, cd)
        ks.append(k.to(state["cross_k"].dtype))
        vs.append(v.to(state["cross_v"].dtype))
    return {**state, "cross_k": torch.stack(ks), "cross_v": torch.stack(vs)}


def encdec_decode_step(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
                       state: Dict) -> Tuple[torch.Tensor, Dict]:
    """One decoder token against the self caches and the cross K/V:
    tokens (B,) -> (logits (B, padded_vocab), state). The self caches are
    written in place, as :func:`repro_torch.models.attention.attn_decode`
    writes them; the returned state holds them with pos + 1."""
    cd, eps = _cdtype(cfg), cfg.norm_eps
    self_c = state["self"]
    pos = self_c["pos"][0]
    x = embed_lookup(params["dec"]["embed"], tokens[:, None], cd)
    x = x + params["dec"]["pos"].index_select(0, pos.reshape(1).long()).to(cd)[None]
    for i in range(cfg.n_layers):
        blk = _layer(params["dec"]["blocks"], i)
        cache = {key: a[i] for key, a in self_c.items()}
        a, _ = attn.attn_decode(blk["self_attn"], layernorm(blk["ln1"], x, eps), cache,
                                n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                                head_dim=cfg.head_dim, rope_theta=None, compute_dtype=cd)
        x = x + a
        kv = (state["cross_k"][i].to(cd), state["cross_v"][i].to(cd))
        x = x + attn.cross_attn_decode(blk["cross_attn"], layernorm(blk["ln2"], x, eps), kv,
                                       n_heads=cfg.n_heads, head_dim=cfg.head_dim,
                                       compute_dtype=cd)
        x = x + gelu_mlp(blk["mlp"], layernorm(blk["ln3"], x, eps), cd)
    x = layernorm(params["dec"]["final_ln"], x, eps)
    logits = unembed_logits(params["dec"]["embed"]["table"], x[:, 0], cd)
    new_self = {"k": self_c["k"], "v": self_c["v"], "pos": self_c["pos"] + 1}
    return logits, {**state, "self": new_self}
