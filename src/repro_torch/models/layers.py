"""Primitive layers (counterpart of ``repro.models.layers``): inits,
``linear``, RMSNorm and LayerNorm, the SwiGLU and GELU MLPs, RoPE and
the embedding lookups. Parameters are nested dicts of tensors, like the
reference's pytrees, so packing and conversion see the same leaves.

Matmul operands are cast to ``compute_dtype`` (bf16 for the transformer)
while parameters stay in their storage dtype (fp32); norm statistics and
the rotation run in fp32 and cast back, as in the reference. The
training loss (:func:`chunked_softmax_xent`) never holds more than one
sequence chunk's logits: each chunk is recomputed in the backward pass
(``torch.utils.checkpoint``), as the reference's scan keeps one chunk's.

Tensor parallelism (``tp``, a ``models.tensor_parallel.TPGroup``; None
runs the whole layer, as before): a column-parallel product is
:func:`linear` on the rank's column shard of an input passed through
``copy_to_model``; :func:`row_parallel_linear` all-reduces the partial
products of the rank's row shard and adds the bias once, after the
reduce; :func:`swiglu` and :func:`gelu_mlp` are both; :func:`embed_lookup` and
:func:`chunked_softmax_xent` are vocab-parallel on the rank's rows
``[s V/S, (s+1) V/S)`` of the table.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models.tensor_parallel import (
    TPGroup,
    all_reduce_max,
    copy_to_model,
    reduce_from_model,
)

__all__ = [
    "uniform_init",
    "normal_init",
    "dense_init",
    "linear",
    "row_parallel_linear",
    "rmsnorm_init",
    "rmsnorm",
    "layernorm_init",
    "layernorm",
    "swiglu_init",
    "swiglu",
    "gelu_mlp_init",
    "gelu_mlp",
    "rope_freqs",
    "apply_rope",
    "embed_init",
    "embed_lookup",
    "unembed_logits",
    "softmax_xent",
    "chunked_softmax_xent",
]


def normal_init(generator: Optional[torch.Generator], shape: Sequence[int],
                scale: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """``scale * N(0, 1)`` drawn in fp32 on the generator's device, then
    moved to ``device`` (default: the generator's) and cast to ``dtype``.
    On the ``meta`` device nothing is drawn (shapes only). The draws
    differ from ``jax.random``'s for the same seed; tests feed the
    reference's init through ``repro_torch.convert``."""
    dev = torch.device(device) if device is not None else generator.device
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=dev)
    w = torch.randn(tuple(shape), generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * scale).to(device=dev, dtype=dtype)


def uniform_init(generator: Optional[torch.Generator], shape: Sequence[int],
                 scale: float, dtype=torch.float32, device=None) -> torch.Tensor:
    """``U(-scale, scale)`` drawn in fp32 on the generator's device, then
    moved to ``device`` and cast to ``dtype``, as :func:`normal_init`."""
    dev = torch.device(device) if device is not None else generator.device
    if dev.type == "meta":
        return torch.empty(tuple(shape), dtype=dtype, device=dev)
    w = torch.rand(tuple(shape), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return (w * (2 * scale) - scale).to(device=dev, dtype=dtype)


def dense_init(generator: Optional[torch.Generator], d_in: int, d_out: int,
               device, bias: bool = False, dtype=torch.float32,
               lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    """Fan-in scaled normal init (std 1/sqrt(d_in)), the llama convention.
    ``lead`` prepends stacking axes (``(n_layers,)`` for a layer-stacked
    block, as the reference's ``vmap`` over layer keys)."""
    p = {"w": normal_init(generator, (*lead, d_in, d_out), d_in ** -0.5, dtype, device)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype, device=device)
    return p


def linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
           compute_dtype=torch.float32) -> torch.Tensor:
    """``x @ w + b`` with both operands cast to ``compute_dtype`` first.
    The default fp32 is the EHR MLP's (no cast: bit for bit its old
    path); the transformer passes its config's compute dtype. Works for
    one weight (``w`` (d_in, d_out), ``x`` (..., d_in)) and for a node
    stack (``w`` (n, d_in, d_out), ``x`` (n, m, d_in)): the bias
    broadcasts over the sample axis either way."""
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype).unsqueeze(-2)
    return y


def row_parallel_linear(p: Dict[str, torch.Tensor], x: torch.Tensor,
                        compute_dtype=torch.float32,
                        tp: Optional[TPGroup] = None) -> torch.Tensor:
    """:func:`linear` on the rank's row shard of ``w`` (its slice of
    ``x``'s features): the partial products all-reduced over the model
    group, the (replicated) bias added once, after the reduce."""
    if tp is None:
        return linear(p, x, compute_dtype)
    y = reduce_from_model(torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype)), tp)
    if "b" in p:
        y = y + p["b"].to(compute_dtype).unsqueeze(-2)
    return y


def rmsnorm_init(d: int, dtype=torch.float32, device=None,
                 lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` in fp32, cast back to x's dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * p["scale"].float()
    return out.to(x.dtype)


def layernorm_init(d: int, dtype=torch.float32, device=None,
                   lead: Sequence[int] = ()) -> Dict[str, torch.Tensor]:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(p: Dict[str, torch.Tensor], x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """``(x - mean) * rsqrt(var + eps) * scale + bias`` in fp32 (the
    population variance, as ``jnp.var``), cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * p["scale"].float() + p["bias"].float()
    return out.to(x.dtype)


def swiglu_init(generator, d: int, d_ff: int, dtype=torch.float32, device=None,
                lead: Sequence[int] = ()) -> Dict:
    return {
        "gate": dense_init(generator, d, d_ff, device, dtype=dtype, lead=lead),
        "up": dense_init(generator, d, d_ff, device, dtype=dtype, lead=lead),
        "down": dense_init(generator, d_ff, d, device, dtype=dtype, lead=lead),
    }


def swiglu(p: Dict, x: torch.Tensor, compute_dtype=torch.bfloat16,
           tp: Optional[TPGroup] = None) -> torch.Tensor:
    """``down(silu(gate(x)) * up(x))``; on a model group ``gate`` / ``up``
    column-parallel and ``down`` row-parallel (one all-reduce forward,
    one backward)."""
    x = copy_to_model(x, tp)
    g = linear(p["gate"], x, compute_dtype)
    u = linear(p["up"], x, compute_dtype)
    return row_parallel_linear(p["down"], F.silu(g) * u, compute_dtype, tp)


def gelu_mlp_init(generator, d: int, d_ff: int, dtype=torch.float32, device=None,
                  lead: Sequence[int] = ()) -> Dict:
    return {
        "up": dense_init(generator, d, d_ff, device, True, dtype, lead),
        "down": dense_init(generator, d_ff, d, device, True, dtype, lead),
    }


def gelu_mlp(p: Dict, x: torch.Tensor, compute_dtype=torch.bfloat16,
             tp: Optional[TPGroup] = None) -> torch.Tensor:
    """``down(gelu(up(x)))`` with the tanh-approximate GELU, the default of
    the reference's ``jax.nn.gelu``; on a model group ``up`` (``w`` and
    ``b``) column-parallel and ``down`` row-parallel, its bias added once
    (one all-reduce forward, one backward)."""
    h = F.gelu(linear(p["up"], copy_to_model(x, tp), compute_dtype), approximate="tanh")
    return row_parallel_linear(p["down"], h, compute_dtype, tp)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """Inverse frequencies (head_dim/2,), fp32."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate (..., seq, heads, head_dim) by per-position angles, in fp32,
    cast back to x's dtype. ``positions``: (..., seq) integer absolute
    positions (decode passes the absolute write position)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)  # (hd/2,)
    ang = positions.float()[..., None] * inv  # (..., seq, hd/2)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def embed_init(generator, vocab: int, d: int, dtype=torch.float32, device=None,
               scale: float = 0.02) -> Dict[str, torch.Tensor]:
    return {"table": normal_init(generator, (vocab, d), scale, dtype, device)}


def embed_lookup(p: Dict[str, torch.Tensor], tokens: torch.Tensor,
                 compute_dtype=torch.bfloat16, tp: Optional[TPGroup] = None) -> torch.Tensor:
    """The rows of ``table`` at ``tokens``, in ``compute_dtype``. The
    reference casts the whole table and then gathers; gathering first
    gives the same values and casts only the rows it needs. On a model
    group the table is the rank's rows ``[lo, lo + V/S)``: the tokens
    outside them look up zeros, and the all-reduce sums each token's one
    owner's row."""
    table = p["table"]
    if tp is None:
        return table[tokens].to(compute_dtype)
    lo = tp.rank * table.shape[0]
    local = tokens.long() - lo
    outside = (local < 0) | (local >= table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)].to(compute_dtype)
    return reduce_from_model(rows.masked_fill(outside[..., None], 0), tp)


def unembed_logits(table: torch.Tensor, h: torch.Tensor,
                   compute_dtype=torch.bfloat16) -> torch.Tensor:
    """h (..., d) @ table^T (v, d) -> (..., v)."""
    return torch.matmul(h.to(compute_dtype), table.to(compute_dtype).T)


def _mask_padded_vocab(logits: torch.Tensor, valid_vocab: int, lo: int = 0) -> torch.Tensor:
    """fp32 logits with the padded vocab ids (>= ``valid_vocab``) at -1e30;
    ``lo`` is the global id of the first column (a vocab shard's)."""
    vocab = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
    return torch.where(vocab < valid_vocab, logits, -1e30)


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 valid_vocab: Optional[int] = None) -> torch.Tensor:
    """Mean token cross-entropy in fp32; padded vocab ids are masked out."""
    lf = logits.float()
    if valid_vocab is not None and valid_vocab < lf.shape[-1]:
        lf = _mask_padded_vocab(lf, valid_vocab)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def _xent_chunk(table: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
                valid_vocab: int, compute_dtype) -> torch.Tensor:
    """The summed cross-entropy of one (B, chunk) slice over its valid
    labels (>= 0). The gold logit is a masked sum over the vocab, as the
    reference's (a gather there would all-gather vocab-sharded logits)."""
    logits = _mask_padded_vocab(unembed_logits(table, h, compute_dtype).float(),
                                valid_vocab)
    logz = torch.logsumexp(logits, dim=-1)
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(vocab == labels[..., None], logits, 0.0), dim=-1)
    valid = (labels >= 0).float()
    return torch.sum((logz - gold) * valid)


def _xent_chunk_tp(table: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
                   valid_vocab: int, compute_dtype, tp: TPGroup) -> torch.Tensor:
    """:func:`_xent_chunk` on the rank's vocab rows ``[lo, lo + V/S)``: the
    local logits (B, chunk, V/S), padded ids masked by their global id;
    logz from the all-reduced max (detached) and the all-reduced sum of
    exponentials; the gold logit a masked sum, all-reduced with them (one
    all-reduce for both)."""
    lo = tp.rank * table.shape[0]
    logits = _mask_padded_vocab(unembed_logits(table, h, compute_dtype).float(),
                                valid_vocab, lo)
    m = all_reduce_max(logits.max(dim=-1).values, tp)
    vocab = torch.arange(lo, lo + logits.shape[-1], device=logits.device)
    gold = torch.sum(torch.where(vocab == labels[..., None], logits, 0.0), dim=-1)
    sums = reduce_from_model(
        torch.stack([torch.exp(logits - m[..., None]).sum(dim=-1), gold]), tp)
    logz = torch.log(sums[0]) + m
    valid = (labels >= 0).float()
    return torch.sum((logz - sums[1]) * valid)


def chunked_softmax_xent(table: torch.Tensor, h: torch.Tensor, labels: torch.Tensor,
                         valid_vocab: int, chunk: int = 512,
                         compute_dtype=torch.bfloat16,
                         tp: Optional[TPGroup] = None) -> torch.Tensor:
    """Mean cross-entropy of ``h (B, S, d) @ table^T`` against ``labels
    (B, S)`` over the labels >= 0, without (B, S, V) logits.

    The sequence is padded to a multiple of ``chunk`` (pad labels -1), as
    the reference pads before its scan, and each chunk's loss runs under
    ``torch.utils.checkpoint``: autograd keeps a chunk's inputs, and the
    backward pass recomputes its (B, chunk, V) logits, so the peak holds
    one chunk's logits at a time.

    On a model group ``table`` is the rank's vocab rows (vocab-parallel,
    :func:`_xent_chunk_tp`): ``h`` passes ``copy_to_model`` once, so its
    gradient sums every shard's; each chunk's all-reduces are issued
    again by its recompute in backward."""
    h = copy_to_model(h, tp)
    b, s, _ = h.shape
    if s % chunk:
        pad = chunk - s % chunk
        h = F.pad(h, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad), value=-1)
        s += pad
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(0, s, chunk):
        hc, lc = h[:, c:c + chunk], labels[:, c:c + chunk]
        if tp is None:
            part = checkpoint(_xent_chunk, table, hc, lc, valid_vocab, compute_dtype,
                              use_reentrant=False)
        else:
            part = checkpoint(_xent_chunk_tp, table, hc, lc, valid_vocab, compute_dtype, tp,
                              use_reentrant=False)
        loss_sum = loss_sum + part
        count = count + (lc >= 0).float().sum()
    return loss_sum / torch.clamp(count, min=1.0)
