"""The tensor-parallel layers of every family on a model group, held to
the whole model (ROADMAP.md queue 1, item 18b slices (i)-(iii): the
dense, VLM and MoE families, RWKV6 and RecurrentGemma, whisper's
encoder-decoder; and ``tree`` on the ``(node, model)`` layout).

Each check runs as one group of ranks (``launch.mesh.run_group``); every
rank draws the same whole parameters from a seed (or takes a given
tree), keeps its shard (``models.sharding.shard_params``) and runs the
tensor-parallel path; rank 0 also runs the whole model and compares:

  * :func:`layer_cases` -- each layer alone (column- and row-parallel
    ``linear``, the vocab-parallel embedding, attention, the SwiGLU, an
    MoE arch's expert-parallel MoE, RWKV6's time and channel mix, the
    RG-LRU block, whisper's encoder attention, cross-attention and GELU
    MLP, the chunked loss, and for a VLM a chunk of prefix positions
    only) against the same layer run whole on the same inputs, forward
    and gradients (every rank compares its own shard; the worst over the
    ranks is kept), the replicated leaves' gradients compared across the
    ranks;
  * :func:`lm_case` -- ``lm_loss`` (``encdec_loss`` for whisper) forward
    and backward of the stack: the loss and the gradients reassembled
    from the shards against the whole model's, the replicated leaves'
    gradients compared across the ranks, an MoE's routing compared
    across the ranks and with the whole model's, the model group's
    collectives counted (``launch.op_analysis``) and the kernels'
    launches (flash, WKV-6, the RG-LRU scan);
  * :func:`round_case` -- an FD-DSGT round of the ``tree`` engine on the
    ``(node, model)`` layout (``TreeEngine.from_group``) against the same
    round of the whole model on one device (``TreeEngine.simulated`` on
    the group's mixing matrix): the reassembled parameters and the
    metrics;
  * :func:`engine_case` -- the engine's rows and its mixing of the shards.

The group runs first and its results wait on the host while the whole
model runs alone (the card holds the group's shards and one whole model
in turn): in ``lm_case`` on each rank in turn, each comparing its own
shard; in ``round_case`` on rank 0, the shards coming back to it a leaf
at a time (:func:`collect_tiles`). The command line runs, for each ``--arch``,
:func:`lm_case` and then one :func:`round_case` at Q = 1 on 2 nodes, or
for an ``ARCH:DEPTH[:DTYPE]``, :func:`lm_case` alone at DEPTH layers of
the arch's full width (whisper: DEPTH encoder and DEPTH decoder layers),
at DTYPE compute if given (the card's check; one JSON line).

Numbers are max |tp - whole| over the leaf's (or the output's) max
|whole| (a key projection's bias without RoPE: over its block's value
bias's, :func:`_key_bias_scale`). On the card a model group of two
processes shares the one card over gloo (``backend="gloo"``: NCCL
refuses two ranks on a device).

  PYTHONPATH=src python -m repro_torch.benchmarks.tensor_parallel --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.benchmarks.tensor_parallel --backend gloo \\
      --arch smollm-360m llama4-scout-17b-a16e:1 internvl2-26b:1 rwkv6-7b:2:float32 \\
      recurrentgemma-2b:3 whisper-medium:2
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy, params_from_numpy
from repro_torch.core.engine import TreeEngine
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round, tree_map
from repro_torch.core.mixing import mesh_gossip_dense_equivalent
from repro_torch.core.packing import tree_leaves, tree_unflatten
from repro_torch.core.schedules import inv_sqrt
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rglru_scan.ops import rglru_scan
from repro_torch.kernels.rwkv6_scan.ops import wkv6
from repro_torch.launch.mesh import run_group
from repro_torch.launch.op_analysis import op_analysis
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import layers
from repro_torch.models import moe as moe_mod
from repro_torch.models import rglru as rglru_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import (
    cut_leaf,
    join_leaf,
    model_param_specs,
    shard_params,
    spec_dict,
    split_dim,
    stacked_param_specs,
)
from repro_torch.models.tensor_parallel import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    tp_group,
)
from repro_torch.training.trainer import stack_for_nodes

__all__ = ["layer_cases", "lm_case", "round_case", "engine_case", "cases", "CASES",
           "model_group_counts", "expected_collectives", "expected_launches", "collect_tiles",
           "replicated_equal", "RouteLog", "routing_summary", "main"]


#: the seed every rank draws the whole parameters and the batches from
SEED = 0
#: the rounds' step size ``ALPHA0 / sqrt(r)``
ALPHA0 = 0.05


def _cfg(arch: str, compute_dtype: str, smoke: bool = False, depth: Optional[int] = None):
    """The arch's config (or its reduced one) at ``compute_dtype`` and, with
    ``depth``, that many layers (an encoder's too) at its full width."""
    cfg = dataclasses.replace(get_config(arch, smoke=smoke), compute_dtype=compute_dtype)
    if depth is None:
        return cfg
    encoder = cfg.encoder and dataclasses.replace(cfg.encoder, n_layers=depth)
    return dataclasses.replace(cfg, n_layers=depth, encoder=encoder)


def _whole(cfg, device, params_np=None) -> Dict:
    """The whole parameters: ``params_np`` (a reference tree) carried over,
    or drawn from :data:`SEED` on the device (every rank draws the same)."""
    if params_np is not None:
        return model_params_from_numpy(params_np, cfg, device)
    return build_model(cfg).init_fn(torch.Generator(device=device).manual_seed(SEED), device)


def _rel(got: torch.Tensor, want: torch.Tensor, scale_of: Optional[torch.Tensor] = None
         ) -> float:
    """max |got - want| over max |want| (or max |``scale_of``|)."""
    scale = float((want if scale_of is None else scale_of).detach().float().abs().max())
    return float((got.detach().float() - want.detach().float()).abs().max()) / max(scale, 1e-30)


def _key_bias_scale(path) -> Optional[tuple]:
    """A key projection's bias without RoPE has a zero gradient in exact
    arithmetic (every score of a query gains the same q . b_k, which the
    softmax drops), so its rounding noise has no scale of its own: it is
    held to its block's value-bias gradient's. Returns that leaf's path,
    or None."""
    return path[:-2] + ("wv", "b") if tuple(path[-2:]) == ("wk", "b") else None


def _per_rank(value: int, pg) -> List[int]:
    """Every rank's ``value``, in rank order."""
    t = torch.tensor([value], dtype=torch.int64)
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group=pg))]
    dist.all_gather(parts, t, group=pg)
    return [int(p) for p in parts]


def _worst(errs: Dict[str, float], pg) -> Dict[str, float]:
    """Each error's max over the ranks of ``pg``."""
    keys = sorted(errs)
    t = torch.tensor([errs[k] for k in keys], dtype=torch.float64)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=pg)
    return dict(zip(keys, t.tolist()))


def collect_tiles(tree, split: Dict, group, on_leaf: Callable, rows: bool = False) -> None:
    """Every rank's tile of each leaf of ``tree`` -- its shard (``split``:
    path -> spec) and, with ``rows``, its block of node rows -- gathered to
    rank 0 on the host, a leaf at a time (no rank ever holds the whole
    tree); rank 0 calls ``on_leaf(path, whole leaf)`` on each leaf put
    back together (a replicated leaf: its first shard's)."""
    size = group.model_shards
    for path, leaf in tree_leaves(tree):
        tile = leaf.detach().contiguous().cpu()
        parts = [torch.empty_like(tile) for _ in range(group.world)] if group.rank == 0 \
            else None
        dist.gather(tile, parts, dst=0, group=group.pg)
        if group.rank != 0:
            continue
        dim = split_dim(split[path])
        blocks = [tiles[0] if dim is None else join_leaf(path, tiles, dim)
                  for tiles in (parts[b * size:(b + 1) * size]  # rank = block * S + shard
                                for b in range(group.world // size))]
        del parts
        on_leaf(path, torch.cat(blocks, 0) if rows else blocks[0])


def replicated_equal(tree, split: Dict, group) -> bool:
    """Whether every replicated leaf of ``tree`` (``split``: path -> spec)
    is bitwise the same on every rank of each model group."""
    tp = tp_group(group.model_pg)
    same = True
    for path, leaf in tree_leaves(tree):
        if split_dim(split[path]) is None:
            got = [torch.empty_like(leaf) for _ in range(tp.size)]
            dist.all_gather(got, leaf.contiguous(), group=tp.pg)
            same = same and all(torch.equal(g, leaf) for g in got)
    return not _worst({"differs": float(not same)}, group.pg)["differs"]


def model_group_counts(costs, group) -> Dict[str, int]:
    """The collectives ``op_analysis`` saw on the model group, by kind."""
    on = costs.on_group(dist.get_process_group_ranks(group.model_pg))
    return {kind: int(d["count"]) for kind, d in on.items()}


def _cut_heads(n_heads: int, n_kv_heads: int, head_dim: int, n_layout: int,
               size: int) -> int:
    """1 where the group gathers cut heads (:func:`attn.tp_head_plan`), else 0."""
    plan = attn.tp_head_plan(n_heads, n_kv_heads, head_dim, n_layout, 0, size)
    return int(plan.gather_q or plan.gather_kv)


def expected_collectives(cfg, size: int, seq_len: int,
                         loss_chunk: int = 512) -> Dict[str, int]:
    """The collectives of one forward and backward of ``lm_loss`` (of
    ``encdec_loss`` for whisper) under remat on a model group of ``size``
    (the same on every rank; ``seq_len`` the positions of the loss, a
    VLM's prefix included, whisper's decoder tokens).

    The rule of the recompute: it issues a layer's forward collectives
    again up to the last one whose output the backward needs, and stops
    there (``torch.utils.checkpoint``'s early stop) -- so a layer's last
    row-parallel all-reduce, whose output only joins the residual stream,
    is not issued again. A block, forward + recompute + backward:

      * attention: ``wo``'s all-reduce twice and its column-parallel
        input's gradient (3); where the group gathers cut heads, one
        all-gather forward and again in the recompute, one all-reduce of
        its gradient (+1 all-reduce, 2 all-gathers);
      * the FFN that ends a block: the SwiGLU's ``down`` all-reduce and
        its input's gradient (2), or an MoE layer's all-reduce of the
        partial outputs and two backward (3);
      * ``rwkv``: the time mix's ``wo`` twice and its four lerped inputs'
        gradient (one stacked all-reduce), the channel mix's ``wv`` and
        its input's gradient (5 all-reduces); the all-gathers of the
        scattered decay, ``u`` and ``ln_scale`` gradients (3);
      * ``recurrent``: the RG-LRU block's gather of u forward and in the
        recompute and its gradient's all-reduce, ``out_proj`` twice, the
        input's gradient, the all-gathers of the scattered ``lam`` and
        ``conv_b`` gradients (4 all-reduces, 4 all-gathers), then the
        SwiGLU (2);
      * whisper (no remat in the encoder): an encoder layer's attention
        (``wo`` and its input's gradient, 2; +1 all-reduce and 1
        all-gather where heads are cut) and GELU MLP (2); a decoder layer's
        self-attention (3), cross-attention (``wo`` twice and q's input
        gradient, 3; where heads are cut the q and the k/v gathers, each
        forward and in the recompute, and their gradients: +2
        all-reduces, 4 all-gathers) and GELU MLP (2); the encoder
        output's one ``copy_to_model`` (1).

    Then the embedding's all-reduce, the loss's all-reduce of the hidden
    state's gradient and, a sequence chunk, two forward all-reduces (the
    max; the sum of exponentials with the gold logit), both issued again
    by the chunk's recompute."""
    chunks = -(-seq_len // loss_chunk)
    ar, ag = 1 + 1 + 4 * chunks, 0
    if cfg.family == "audio":
        e = cfg.encoder
        enc_cut = _cut_heads(e.n_heads, e.n_heads, e.d_model // e.n_heads, e.n_heads, size)
        self_cut = _cut_heads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, size)
        cross_cut = _cut_heads(cfg.n_heads, cfg.n_heads, cfg.head_dim, cfg.n_heads, size)
        ar += e.n_layers * (4 + enc_cut) + 1
        ar += cfg.n_layers * (3 + self_cut + 3 + 2 * cross_cut + 2)
        ag += e.n_layers * enc_cut + cfg.n_layers * (2 * self_cut + 4 * cross_cut)
        return {"all-reduce": ar, "all-gather": ag}
    cut = _cut_heads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                     attn.layout_heads(cfg.n_heads, cfg.tp_head_pad),
                     size) if cfg.n_heads else 0
    for kind in cfg.effective_pattern:
        if kind == "rwkv":
            ar, ag = ar + 5, ag + 3
        elif kind == "recurrent":
            ar, ag = ar + 4 + 2, ag + 4
        else:
            ar += 3 + cut + (3 if kind == "moe" else 2)
            ag += 2 * cut
    return {"all-reduce": ar, "all-gather": ag}


def expected_launches(cfg) -> Dict[str, int]:
    """Each hand kernel's launches a rank in one forward and backward of
    the loss under remat (a decoder layer's kernel forward and in its
    recompute; whisper's encoder, which has no remat, once): flash for an
    attention layer (whisper's decoder: self- and cross-attention), WKV-6
    for an RWKV6 layer, the RG-LRU scan for a recurrent one."""
    if cfg.family == "audio":
        return {"flash_attention": cfg.encoder.n_layers + 4 * cfg.n_layers, "wkv6": 0,
                "rglru_scan": 0}
    kinds = cfg.effective_pattern
    return {"flash_attention": 2 * sum(k not in ("rwkv", "recurrent") for k in kinds),
            "wkv6": 2 * kinds.count("rwkv"), "rglru_scan": 2 * kinds.count("recurrent")}


# ---------------------------------------------------------------------------
# the layers alone
# ---------------------------------------------------------------------------


def _cot(shape, device) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.linspace(-1.0, 1.0, n, device=device).reshape(shape)


def _vg(fn, inputs: List[torch.Tensor], cot: Optional[torch.Tensor] = None):
    """(output, gradients of sum(output * cot)), ``cot`` a fixed ramp by
    default."""
    leaves = [x.detach().requires_grad_(True) for x in inputs]
    out = fn(*leaves)
    cot = _cot(out.shape, out.device) if cot is None else cot
    grads = torch.autograd.grad((out * cot.to(out.dtype)).sum(), leaves)
    return out.detach(), grads


def _all_used(cot: torch.Tensor, size: int) -> torch.Tensor:
    """The gradient of the gathered columns when rank r uses columns
    ``[8 r, 8 r + 8)``: the cotangent there, zero elsewhere."""
    out = torch.zeros_like(cot)
    for r in range(size):
        out[..., r * 8:(r + 1) * 8] = cot[..., r * 8:(r + 1) * 8]
    return out


def _cut(x: torch.Tensor, dim: int, tp) -> torch.Tensor:
    w = x.shape[dim] // tp.size
    return x.narrow(dim, tp.rank * w, w)


def _same_on_ranks(t: torch.Tensor, tp) -> bool:
    """Whether ``t`` is bitwise the same on every rank of the model group."""
    got = [torch.empty_like(t) for _ in range(tp.size)]
    dist.all_gather(got, t.contiguous(), group=tp.pg)
    return all(torch.equal(x, t) for x in got)


def _constant(a: torch.Tensor) -> bool:
    return a.numel() > 1 and bool((a == a.reshape(-1)[0]).all())


def layer_cases(group, arch: str) -> Dict[str, float]:
    """Every tensor-parallel layer of ``arch``'s smoke config at fp32
    against the same layer whole, on this rank's shard (the worst rank's
    errors are returned; ``<layer>/replicated_differs`` is 1 where a
    replicated leaf's gradient is not bitwise the same on every rank)."""
    tp = tp_group(group.model_pg)
    dev = group.device
    cfg = _cfg(arch, "float32", smoke=True)
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, b, s, cd = cfg.d_model, 2, 12, torch.float32

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    errs: Dict[str, float] = {}
    rope_free = cfg.family == "audio"

    def record(name, tp_out, whole_out, grad_pairs):
        errs[name] = _rel(tp_out, whole_out)
        for i, (got, want, *scale_of) in enumerate(grad_pairs):
            errs[f"{name}/grad{i}"] = _rel(got, want, *scale_of)

    def tree_case(name, tree, fn, inputs):
        """``fn(tp_, tree, *inputs)`` whole and on the rank's shard of
        ``tree`` (a constant leaf -- a norm's ones, a bias's zeros, RWKV's
        lerps -- moved off its init first, so a misplaced slice shows):
        the output, the inputs' gradients and every leaf's (a split leaf's
        against the rank's slice of the whole's); the replicated leaves'
        gradients bitwise the same on every rank."""
        tree = tree_map(lambda a: a + 0.1 * torch.randn(a.shape, generator=g, device=dev)
                        if _constant(a) else a, tree)
        paths = tuple(p for p, _ in tree_leaves(tree))
        specs = spec_dict(model_param_specs(tree))
        n = len(inputs)

        def run(tp_):
            return lambda *ls: fn(tp_, tree_unflatten(paths, list(ls[n:])), *ls[:n])

        whole, gw = _vg(run(None), list(inputs) + [leaf for _, leaf in tree_leaves(tree)])
        shards = [leaf for _, leaf in tree_leaves(shard_params(tree, tp.rank, tp.size))]
        out, gt = _vg(run(tp), list(inputs) + shards)
        pairs, same = list(zip(gt[:n], gw[:n])), True
        mine = {}  # path -> the rank's slice of the whole gradient
        for path, got, want in zip(paths, gt[n:], gw[n:]):
            dim = split_dim(specs[path])
            if dim is None:
                same = _same_on_ranks(got, tp) and same
            mine[path] = want if dim is None else cut_leaf(path, want, dim, tp.rank, tp.size)
        for path, got in zip(paths, gt[n:]):
            key_bias = rope_free and _key_bias_scale(path)
            pairs.append((got, mine[path]) + ((mine[key_bias],) if key_bias else ()))
        record(name, out, whole, pairs)
        errs[f"{name}/replicated_differs"] = float(not same)

    x = rnd(b, s, d)
    # column-parallel linear (bias split with its columns): the rank's
    # columns of the output, the input's gradient summed by copy_to_model
    w, bias = rnd(d, 4 * tp.size * 8, scale=d ** -0.5), rnd(4 * tp.size * 8)
    cot = _cot((b, s, w.shape[1]), dev)
    whole, (gx, gw, gb) = _vg(lambda x, w, bb: layers.linear({"w": w, "b": bb}, x, cd),
                              [x, w, bias], cot)
    out, (tx, tw, tb) = _vg(lambda x, w, bb: layers.linear(
        {"w": w, "b": bb}, copy_to_model(x, tp), cd), [x, _cut(w, 1, tp), _cut(bias, 0, tp)],
        _cut(cot, 2, tp))
    record("column_linear", out, _cut(whole, 2, tp),
           [(tx, gx), (tw, _cut(gw, 1, tp)), (tb, _cut(gb, 0, tp))])
    # the all-gather of column shards that each rank uses in part: each
    # rank weighs its own columns of the whole, the gradient of a shard is
    # the sum of every rank's use of it
    mask = torch.zeros(w.shape[1], device=dev)
    mask[tp.rank * 8:(tp.rank + 1) * 8] = 1.0
    y = rnd(b, s, w.shape[1])
    whole, (gy,) = _vg(lambda y: y, [y], cot)
    out, (ty,) = _vg(lambda y: gather_from_model(y, tp) * mask, [_cut(y, 2, tp)], cot)
    from_all = torch.zeros_like(out)
    for r in range(tp.size):
        from_all[..., r * 8:(r + 1) * 8] = whole[..., r * 8:(r + 1) * 8]
    record("all_gather", reduce_from_model(out, tp), from_all,
           [(ty, _cut(_all_used(cot, tp.size), 2, tp))])
    # row-parallel linear: the bias once, after the reduce
    h = rnd(b, s, 4 * tp.size * 8)
    w2, b2 = rnd(h.shape[-1], d, scale=h.shape[-1] ** -0.5), rnd(d)
    whole, (gh, gw, gb) = _vg(lambda h, w, bb: layers.linear({"w": w, "b": bb}, h, cd),
                              [h, w2, b2])
    out, (th, tw, tb) = _vg(lambda h, w, bb: layers.row_parallel_linear(
        {"w": w, "b": bb}, h, cd, tp), [_cut(h, 2, tp), _cut(w2, 0, tp), b2])
    record("row_linear", out, whole, [(th, _cut(gh, 2, tp)), (tw, _cut(gw, 0, tp)),
                                      (tb, gb)])
    # the vocab-parallel embedding
    table = rnd(cfg.padded_vocab, d, scale=0.02)
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
    whole, (gt,) = _vg(lambda t: layers.embed_lookup({"table": t}, tokens, cd), [table])
    out, (tt,) = _vg(lambda t: layers.embed_lookup({"table": t}, tokens, cd, tp),
                     [_cut(table, 0, tp)])
    record("embedding", out, whole, [(tt, _cut(gt, 0, tp))])
    # attention on the rank's heads, every leaf of the block's attn
    pos = torch.arange(s, device=dev)[None].expand(b, s)

    def attention(name, pa, hl, **kw):
        kw = dict(dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                       head_dim=cfg.head_dim, rope_theta=cfg.rope_theta), **kw)
        tree_case(name, pa, lambda tp_, p, x: attn.attn_apply(
            p, x, pos, compute_dtype=cd, n_heads_layout=hl, tp=tp_, **kw), [x])

    def mlp(name, pm, fn):
        tree_case(name, pm, lambda tp_, p, x: fn(p, x, cd, tp_), [x])

    if cfg.family == "audio":
        _audio_layer_cases(cfg, encdec_mod.encdec_init(cfg, g, dev), tree_case, attention,
                           mlp, x, rnd, g, dev)
    elif cfg.family == "ssm":
        # the mixes under their own keys: the specs read the channel mix's
        # ``wv`` as row-parallel by its parent
        block = tree_map(lambda a: a[0], tfm.init_params(cfg, g, dev)["blocks"])["rwkv"]
        zeros = torch.zeros((b, d), device=dev)

        def time_mix(tp_, p, x):
            st = rwkv_mod.rwkv_decode_states(b, d, dev, 1 if tp_ is None else tp_.size)
            return rwkv_mod.rwkv_time_mix(p["time"], x, zeros, st["s"], cd, tp_)[0]

        tree_case("rwkv_time_mix", {"time": block["time"]}, time_mix, [x])
        tree_case("rwkv_channel_mix", {"channel": block["channel"]}, lambda tp_, p, x:
                  rwkv_mod.rwkv_channel_mix(p["channel"], x, zeros, cd, tp_)[0], [x])
    else:
        params = tfm.init_params(cfg, g, dev)
        kinds = cfg.effective_pattern
        block = tfm._layer_params(params, cfg, next(i for i, k in enumerate(kinds)
                                                    if k != "recurrent"))
        window = min(cfg.window, 5) if "local_attention" in kinds else 0
        attention("attention", block["attn"], cfg.n_heads, window=window)
        # two pad heads: the ranks' own plans differ (at S = 2, 4 / 2 heads
        # padded to 6 leave one rank's kv columns exact and not the other's),
        # and at S = 4 the last rank holds pad heads only
        hl = cfg.n_heads + 2
        attention("attention_padded", attn.attn_init(
            g, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, qkv_bias=cfg.qkv_bias,
            n_heads_layout=hl, device=dev), hl, window=window)
        # the SwiGLU, column then row (an MoE block's FFN is the routed
        # experts: its SwiGLU is drawn alone)
        mlp("swiglu", block["mlp"] if "mlp" in block else layers.swiglu_init(
            g, d, cfg.d_ff, device=dev), layers.swiglu)
        if "moe" in block:
            # the routed experts on the rank's E/S (and the shared expert's
            # columns and rows), the router whole: the output and the aux
            # loss (its last element, weighed 1 by the ramp)
            kw = dict(n_experts=cfg.n_experts, k=cfg.experts_per_token,
                      capacity_factor=cfg.moe_capacity_factor, compute_dtype=cd)

            def moe_fn(tp_, tree, x):
                y, aux = moe_mod.moe_apply(tree["moe"], x, tp=tp_, **kw)
                return torch.cat([y.reshape(-1), aux.reshape(1)])

            tree_case("moe", {"moe": block["moe"]}, moe_fn, [x])
        if "recurrent" in kinds:
            # the RG-LRU block on the rank's channels (the paired in_proj cut)
            pr = tfm._layer_params(params, cfg, kinds.index("recurrent"))["rglru"]

            def rglru(tp_, p, x):
                st = rglru_mod.rglru_decode_state(b, p["in_proj"]["w"].shape[-1] // 2,
                                                  cfg.conv_width, dev)
                return rglru_mod.rglru_block_apply(p, x, st, cd, tp_)[0]

            tree_case("rglru", pr, rglru, [x])
    if cfg.family == "vlm":
        # a chunk of prefix positions only (every label -1), then one of
        # text: the loss on the rank's vocab rows still equals the whole's
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=g, device=dev)
        labels[:, :5] = -1
        out, (tt, th) = _vg(lambda t, hh: layers.chunked_softmax_xent(
            t, hh, labels, cfg.vocab_size, chunk=5, compute_dtype=cd, tp=tp),
            [_cut(table, 0, tp), x])
        whole, (gt, gh) = _vg(lambda t, hh: layers.chunked_softmax_xent(
            t, hh, labels, cfg.vocab_size, chunk=5, compute_dtype=cd), [table, x])
        record("chunked_loss_prefix", out, whole, [(tt, _cut(gt, 0, tp)), (th, gh)])
    # the chunked loss: padded vocab ids (the last 3 of a shard past the
    # valid vocab), -1 labels, a sequence not a multiple of the chunk
    valid = cfg.padded_vocab - 3
    labels = torch.randint(0, valid, (b, s), generator=g, device=dev)
    labels[0, :2] = -1

    def xent(tp_):
        return lambda t, hh: layers.chunked_softmax_xent(t, hh, labels, valid, chunk=5,
                                                         compute_dtype=cd, tp=tp_)

    whole, (gt, gh) = _vg(xent(None), [table, x])
    out, (tt, th) = _vg(xent(tp), [_cut(table, 0, tp), x])
    record("chunked_loss", out, whole, [(tt, _cut(gt, 0, tp)), (th, gh)])
    return _worst(errs, tp.pg)


def _audio_layer_cases(cfg, params, tree_case, attention, mlp, x, rnd, g, dev) -> None:
    """whisper's layers: the encoder's non-causal attention, the decoder's
    causal self-attention, cross-attention (over an encoder output that
    passes ``copy_to_model`` first; also on 3 heads, which every rank's
    columns cut) and the GELU MLP."""
    e, cd = cfg.encoder, torch.float32
    enc = tree_map(lambda a: a[0], params["enc"]["blocks"])
    dec = tree_map(lambda a: a[0], params["dec"]["blocks"])
    attention("encoder_attention", enc["attn"], e.n_heads, n_heads=e.n_heads,
              n_kv_heads=e.n_heads, head_dim=e.d_model // e.n_heads, rope_theta=None,
              causal=False)
    attention("attention", dec["self_attn"], cfg.n_heads, rope_theta=None)
    frames = rnd(x.shape[0], 10, cfg.d_model)

    def cross(n_heads):
        def fn(tp_, p, x, enc_out):
            kv = attn.precompute_cross_kv(p, copy_to_model(enc_out, tp_), n_heads,
                                          cfg.head_dim, cd, tp_)
            return attn.cross_attn_apply(p, x, kv, n_heads=n_heads, head_dim=cfg.head_dim,
                                         compute_dtype=cd, tp=tp_)
        return fn

    tree_case("cross_attention", dec["cross_attn"], cross(cfg.n_heads), [x, frames])
    tree_case("cross_attention_cut", attn.cross_attn_init(g, cfg.d_model, 3, cfg.head_dim,
                                                          device=dev), cross(3), [x, frames])
    mlp("gelu_mlp", dec["mlp"], layers.gelu_mlp)


# ---------------------------------------------------------------------------
# lm_loss of the stack
# ---------------------------------------------------------------------------


#: the kernels whose launches the cases count, a rank each
KERNELS = {"flash_attention": flash_attention, "wkv6": wkv6, "rglru_scan": rglru_scan}


def _zero_launches() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _launches(pg) -> Dict[str, List[int]]:
    """Each kernel's launches on every rank of ``pg``, in rank order."""
    return {name: _per_rank(fn.launches, pg) for name, fn in KERNELS.items()}


def _loss(params, cfg, batch, tp, loss_chunk):
    """One node's training loss: ``encdec_loss`` for whisper, else ``lm_loss``."""
    if cfg.family == "audio":
        return encdec_mod.encdec_loss(params, cfg, batch, loss_chunk=loss_chunk, tp=tp)
    return tfm.lm_loss(params, cfg, batch, loss_chunk=loss_chunk, tp=tp)


def _value_and_grad(params, cfg, batch, tp, loss_chunk):
    items = tree_leaves(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
    loss = _loss(tree_unflatten(tuple(p for p, _ in items), leaves), cfg, batch, tp,
                 loss_chunk)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(tuple(p for p, _ in items), list(grads))


class RouteLog:
    """Records each ``moe_route`` call's choices -- ``top_e`` (N, k), ``keep``
    (N*k) -- and router probabilities on the host, in call order (remat:
    the forward's, then the recompute's, which runs in autograd's thread
    on the card), while active; one log at a time. ``replay``: the calls
    of another run's log, whose choices this run then takes in the same
    order (with its own router probabilities as the combine weights),
    recording its own choices."""

    def __init__(self, replay: Optional[List] = None):
        self.replay = replay

    def __enter__(self):
        self.calls, self._route = [], moe_mod.moe_route

        def route(router_w, xf, n_experts, k, cap):
            r = self._route(router_w, xf, n_experts, k, cap)
            self.calls.append((r.top_e.cpu(), r.keep.cpu(), r.probs.detach().float().cpu()))
            if self.replay is None:
                return r
            top_e = self.replay[len(self.calls) - 1][0].to(r.top_e.device)
            return moe_mod.routing_of(r.probs, r.probs.gather(-1, top_e), top_e,
                                      n_experts, cap)

        moe_mod.moe_route = route
        return self

    def __exit__(self, *exc):
        moe_mod.moe_route = self._route
        return False


def routing_summary(mine: "RouteLog", whole: Optional["RouteLog"], group) -> Dict:
    """The ranks' routing against rank 0's (choice by choice) and, on rank 0,
    against the whole model's: the token-expert choices, how many match,
    and each token whose choices or keeps differ with its top-k margin
    (the k-th largest whole-model probability less the next)."""
    ranks_equal = True
    for te, keep, _ in mine.calls:
        both = torch.cat([te.reshape(-1), keep.reshape(-1).long()])
        got = [torch.empty_like(both) for _ in range(group.world)]
        dist.all_gather(got, both, group=group.pg)
        ranks_equal = ranks_equal and all(torch.equal(g, got[0]) for g in got)
    if group.rank != 0:
        return {}
    total = same = 0
    flips = []
    for (te, tk, _), (we, wk, wp) in zip(mine.calls, whole.calls, strict=True):
        n, k = te.shape
        chosen = te.sort(-1).values == we.sort(-1).values
        same += int(chosen.sum())
        total += chosen.numel()
        ok = chosen.all(-1) & (tk == wk).reshape(n, k).all(-1)
        top = wp.sort(-1, descending=True).values
        flips += [float(top[t, k - 1] - top[t, k]) for t in torch.nonzero(~ok).flatten()]
    return {"calls": len(mine.calls), "ranks_equal": ranks_equal, "choices": total,
            "matching": same, "flip_margins": flips}


def _lm_batch(cfg, dev, tokens, extra, batch: int, seq_len: int) -> Dict:
    """``tokens`` (batch, seq_len + 1) and, for a VLM, ``prefix_embeds``
    (batch, frontend_seq, d), for whisper ``frames`` (batch, T_enc, d):
    the given arrays, or drawn from the seed."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    if tokens is None:
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len + 1), generator=g,
                               device=dev)
    out = {"tokens": torch.as_tensor(tokens, device=dev)}
    key, rows = _extra(cfg)
    if key is not None:
        if extra is None:
            extra = torch.randn((out["tokens"].shape[0], rows, cfg.d_model), generator=g,
                                device=dev)
        out[key] = torch.as_tensor(extra, device=dev)
    return out


def _extra(cfg):
    """The batch's input beside the tokens and its rows: a VLM's prefix
    embeddings, whisper's frames, or (None, 0)."""
    if cfg.family == "vlm":
        return "prefix_embeds", cfg.frontend_seq
    if cfg.family == "audio":
        return "frames", cfg.encoder.seq_len
    return None, 0


def _positions(cfg, batch: Dict) -> int:
    return batch["tokens"].shape[-1] - 1 + (cfg.frontend_seq if cfg.family == "vlm" else 0)


def _peak(dev) -> int:
    """This rank's peak allocated bytes on the card since the last reset."""
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def lm_case(group, arch: str, compute_dtype: str = "float32", *, smoke: bool = True,
            depth: Optional[int] = None, params_np=None, tokens=None, prefix=None,
            frames=None, batch: int = 2, seq_len: int = 16, loss_chunk: int = 512,
            return_grads: bool = False, ulp: bool = False) -> Dict:
    """``lm_loss`` (whisper: ``encdec_loss``) forward and backward of
    ``arch`` (``depth`` layers -- whisper's encoder and decoder each -- or
    its config's) on this rank's shards -- tokens ``(batch, seq_len + 1)``
    and a VLM's prefix embeddings or whisper's frames drawn from a seed,
    or given -- and then
    the whole model's on the same inputs, on each rank in turn once the
    group's gradients wait on the host (the card holds the group's shards
    and one whole model at a time; on the host every rank at once), each
    rank comparing its shard with its slice of the whole. Returns (rank 0): the two losses, each leaf's
    gradient error (the worst rank's), whether the replicated leaves' gradients are bitwise
    equal on every rank, the model group's collectives (counted) and
    their expected counts, each rank's launches of each kernel in the
    tensor-parallel call, an MoE's routing (``routing_summary``: the
    whole model runs on the group's expert choices, its own compared), the
    seconds of both calls, each rank's peak bytes on the card, with
    ``return_grads`` the reassembled gradients as numpy, and with ``ulp``
    the whole model's own sensitivity: the largest change of a leaf's
    gradient (over its scale) when the embedding table moves by one ulp
    (times 1 + 2^-23), beside which the group's rounding is read."""
    dev = group.device
    cfg = _cfg(arch, compute_dtype, smoke, depth)
    tp = tp_group(group.model_pg)
    batch_ = _lm_batch(cfg, dev, tokens, prefix if frames is None else frames, batch,
                       seq_len)
    mine = shard_params(_whole(cfg, dev, params_np), tp.rank, tp.size)
    _free(dev)
    specs = model_param_specs(mine)
    _zero_launches()
    _sync(dev)
    t0 = time.perf_counter()
    with RouteLog() as log, op_analysis() as oa:
        loss, grads = _value_and_grad(mine, cfg, batch_, tp, loss_chunk)
        _sync(dev)
    tp_s = time.perf_counter() - t0
    del mine
    launches = _launches(group.pg)
    counts = model_group_counts(oa.costs(), group)
    grads = tree_map(lambda a: a.cpu(), grads)
    _free(dev)
    split = spec_dict(specs)
    errs, whole_log = {}, None
    # on the card the ranks run the whole model in turn (one whole model on
    # the card at a time); on the host all at once
    for turn in range(group.world) if dev.type == "cuda" else [group.rank]:
        if group.rank == turn:
            whole = _whole(cfg, dev, params_np)
            _sync(dev)
            t0 = time.perf_counter()
            # the group's routing: a near-tie the two route apart would move a
            # token between experts (counted by ``routing_summary``), not test
            # the layers
            with RouteLog(replay=log.calls) as whole_log:
                wloss, wgrads = _value_and_grad(whole, cfg, batch_, None, loss_chunk)
                _sync(dev)
            whole_s = time.perf_counter() - t0
            if ulp and group.rank == 0:
                whole = tree_unflatten(*zip(*[
                    (path, leaf * (1 + 2 ** -23) if path[-1] == "table" else leaf)
                    for path, leaf in tree_leaves(whole)]))
                moved = _value_and_grad(whole, cfg, batch_, None, loss_chunk)[1]
                ulp_response = max(_rel(m, w) for (_, m), (_, w) in zip(
                    tree_leaves(moved), tree_leaves(wgrads)))
                del moved
            del whole
            mine = {}  # path -> this rank's shard of the whole gradient
            for path, w in tree_leaves(wgrads):
                dim = split_dim(split[path])
                mine[path] = w if dim is None else cut_leaf(path, w, dim, tp.rank, tp.size)
            for path, g in tree_leaves(grads):
                key_bias = cfg.family == "audio" and _key_bias_scale(path)
                errs["/".join(map(str, path))] = _rel(
                    g.to(dev), mine[path], mine[key_bias] if key_bias else None)
            del wgrads
            _free(dev)
        dist.barrier(group=group.pg)
    errs = _worst(errs, group.pg)
    peaks = _per_rank(_peak(dev), group.pg)
    routing = routing_summary(log, whole_log, group) if log.calls else None
    same = replicated_equal(grads, split, group)
    got = {}
    if return_grads:
        collect_tiles(grads, split, group, lambda path, leaf: got.update(
            {path: leaf.float().numpy()}))
    del grads
    if group.rank != 0:
        return {}
    out = {"loss": float(loss), "whole_loss": float(wloss), "grad_errs": errs,
           "replicated_equal": same, "counts": counts,
           "expected": expected_collectives(cfg, tp.size, _positions(cfg, batch_),
                                            loss_chunk),
           "expected_launches": expected_launches(cfg),
           "launches": launches, "layers": cfg.n_layers, "routing": routing,
           "tp_s": tp_s, "whole_s": whole_s, "peak_bytes": peaks}
    if ulp:
        out["ulp_response"] = ulp_response
    if return_grads:
        out["grads"] = tree_unflatten(tuple(got), list(got.values()))
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# tree rounds on the (node, model) layout
# ---------------------------------------------------------------------------


def _round_batches(cfg, dev, batches, q: int, nodes: int, batch: int, seq_len: int) -> Dict:
    """The round's batches ``(Q, nodes, batch, ...)``: the given arrays, or
    tokens (and a VLM's prefix embeddings) drawn from the seed."""
    if batches is not None:
        return {k: torch.as_tensor(v, device=dev) for k, v in batches.items()}
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    out = {"tokens": torch.randint(0, cfg.vocab_size, (q, nodes, batch, seq_len + 1),
                                   generator=g, device=dev)}
    key, rows = _extra(cfg)
    if key is not None:
        out[key] = torch.randn((q, nodes, batch, rows, cfg.d_model), generator=g,
                               device=dev)
    return out


def _stacked(cfg, dev, stacked_np, perturb: float) -> Dict:
    if stacked_np is not None:
        return params_from_numpy(stacked_np, dev)
    return stack_for_nodes(_whole(cfg, dev), 2, perturb=perturb,
                           generator=torch.Generator(device=dev).manual_seed(SEED + 2)
                           if perturb else None)


def round_case(group, arch: str, compute_dtype: str = "float32", *, smoke: bool = True,
               stacked_np=None, batches=None, q: int = 2, batch: int = 1,
               seq_len: int = 16, perturb: float = 0.0,
               return_params: bool = False) -> Dict:
    """One FD-DSGT round of the ``tree`` engine on this rank's node rows and
    shards (the tensor-parallel bundle), and then, on rank 0, the same
    round of the whole model on one device (``TreeEngine.simulated`` on
    the group's mixing matrix), once the group's parameters wait on the
    host. The init: ``stacked_np`` (a node-stacked reference tree), or the
    seed's drawn on each of 2 nodes plus ``perturb`` times a normal draw.
    ``batches``: ``{"tokens": (Q, nodes, batch, seq_len + 1)}`` (and a
    VLM's ``prefix_embeds``), drawn from the seed when None; the step size
    ``ALPHA0 / sqrt(r)``. Returns (rank 0) the metrics of both, each
    leaf's parameter error (and of its update, against the whole
    round's), each rank's flash launches, the seconds of both rounds, each
    rank's peak bytes on the card; ``return_params`` adds the reassembled
    parameters as numpy."""
    dev = group.device
    cfg = _cfg(arch, compute_dtype, smoke)
    stacked = _stacked(cfg, dev, stacked_np, perturb)
    nodes = tree_leaves(stacked)[0][1].shape[0]
    batches = _round_batches(cfg, dev, batches, q, nodes, batch, seq_len)
    fl = FLConfig(algorithm="dsgt", q=q, n_nodes=nodes)
    split = spec_dict(stacked_param_specs(stacked))
    bundle = build_model(cfg, remat=True, model_group=group.model_pg)
    eng, rows = TreeEngine.from_group(group, stacked)
    if group.rank != 0:
        del stacked
    state = init_fl_state(fl, rows, eng)
    del rows
    round_fn = make_fl_round(bundle.loss_fn, inv_sqrt(ALPHA0), fl, eng)
    _zero_launches()
    _sync(dev)
    t0 = time.perf_counter()
    state, m = round_fn(state, batches)
    metrics = {k: float(v) for k, v in m.items()}
    _sync(dev)
    tp_s = time.perf_counter() - t0
    launches = _launches(group.pg)
    params = tree_map(lambda a: a.cpu(), state.params)
    del state
    _free(dev)
    dist.barrier(group=group.pg)  # rank 0's whole round once the group's state is gone
    whole = {}
    if group.rank == 0:
        w = mesh_gossip_dense_equivalent(group.axes(nodes))
        weng, wparams = TreeEngine.simulated(w, stacked)
        wround = make_fl_round(build_model(cfg, remat=True).loss_fn, inv_sqrt(ALPHA0), fl,
                               weng)
        wstate = init_fl_state(fl, wparams, weng)
        t0 = time.perf_counter()
        wstate, m = wround(wstate, batches)
        whole["metrics"] = {k: float(v) for k, v in m.items()}
        _sync(dev)
        whole["s"] = time.perf_counter() - t0
        whole["params"], whole["init"] = dict(tree_leaves(wstate.params)), dict(
            tree_leaves(stacked))
        del wstate
    peaks = _per_rank(_peak(dev), group.pg)
    param_errs, update_errs, got = {}, {}, {}

    def on_leaf(path, leaf):
        key = "/".join(map(str, path))
        leaf, want, init = leaf.to(dev), whole["params"].pop(path), whole["init"].pop(path)
        param_errs[key] = _rel(leaf, want)
        update_errs[key] = _rel(leaf - init, want - init)
        if return_params:
            got[path] = leaf.float().cpu().numpy()

    same = replicated_equal(params, split, group)
    collect_tiles(params, split, group, on_leaf, rows=True)
    if group.rank != 0:
        return {}
    out = {"metrics": metrics, "whole_metrics": whole["metrics"],
           "replicated_equal": bool(same), "tp_s": tp_s, "whole_s": whole["s"],
           "launches": launches, "rows": list(eng.rows), "layers": cfg.n_layers,
           "param_errs": param_errs, "update_errs": update_errs, "peak_bytes": peaks}
    if return_params:
        out["params"] = tree_unflatten(tuple(got), list(got.values()))
    return out


def engine_case(group, arch: str) -> Dict:
    """The ``tree`` engine's build on the ``(node, model)`` layout: this
    rank's node rows, and its mixing of its shards against the shard of
    the whole tree mixed by the dense W (``mesh_gossip_dense_equivalent``
    of the group's node axes). Returns the worst rank's mixing error
    (relative, as the module's) and each rank's rows."""
    dev = group.device
    cfg = _cfg(arch, "float32", smoke=True)
    g = torch.Generator(device=dev).manual_seed(SEED)
    nodes = 2
    stacked = stack_for_nodes(_whole(cfg, dev), nodes, perturb=0.1, generator=g)
    eng, mine = TreeEngine.from_group(group, stacked)
    w = torch.as_tensor(mesh_gossip_dense_equivalent(group.axes(nodes)), dtype=torch.float32,
                        device=dev)
    want = tree_map(lambda x: torch.tensordot(w, x, dims=1), stacked)
    rows = slice(eng.rows.start, eng.rows.stop)
    want = shard_params(tree_map(lambda x: x[rows], want), group.shard,
                        group.model_shards, stacked_param_specs(stacked))
    err = max(_rel(a, b) for (_, a), (_, b) in zip(tree_leaves(eng.mix(mine)),
                                                    tree_leaves(want)))
    placed = all(tuple(a.shape) == tuple(b.shape)
                 for (_, a), (_, b) in zip(tree_leaves(mine), tree_leaves(want)))
    rows_of = [torch.empty(2, dtype=torch.int64) for _ in range(group.world)]
    dist.all_gather(rows_of, torch.tensor([eng.rows.start, eng.rows.stop]), group=group.pg)
    worst = _worst({"mix": err, "misplaced": float(not placed)}, group.pg)
    return {**worst, "rows": [tuple(r.tolist()) for r in rows_of]}


#: the checks :func:`cases` runs by name
CASES = {"layers": layer_cases, "lm": lm_case, "round": round_case, "engine": engine_case}


def cases(group, todo) -> List:
    """Run ``todo`` -- ``(name, kwargs)`` pairs of :data:`CASES` -- in order
    on this rank; rank 0's results, in order."""
    return [CASES[name](group, **kw) for name, kw in todo]


def _free(dev: torch.device) -> None:
    """Hand this rank's cached card memory back, for the group's other
    processes on the card."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def _card_cases(group, archs: List[str], compute_dtype: str, smoke: bool, batch: int,
                seq_len: int) -> Dict:
    """What the card's check runs on one group, for each
    ``ARCH[:DEPTH[:DTYPE]]`` of ``archs``: :func:`lm_case` (at DEPTH
    layers, at DTYPE compute or ``compute_dtype``), then, at the config's
    depth, one :func:`round_case` at Q = 1 on 2 nodes; the card's memory
    handed back between them."""
    out, dev = {}, group.device
    for spec in archs:
        arch, depth, dtype = (spec.split(":") + ["", ""])[:3]
        # an fp32 cell also reads the whole model's one-ulp response
        cases = [("lm", lm_case, dict(depth=int(depth) if depth else None,
                                      ulp=(dtype or compute_dtype) == "float32"))]
        if not depth:
            cases.append(("round", round_case, dict(q=1, perturb=1e-3)))
        out[arch] = {}
        for name, case, kw in cases:
            _free(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            out[arch][name] = case(group, arch, dtype or compute_dtype, smoke=smoke,
                                   batch=batch, seq_len=seq_len, **kw)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", nargs="+", default=["smollm-360m"],
                    help="ARCH, or ARCH:DEPTH[:DTYPE] for lm_case alone at DEPTH layers "
                         "of the arch's full width (at DTYPE compute)")
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--smoke", action="store_true", help="the arch's reduced config")
    ap.add_argument("--compute-dtype", default="bfloat16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--device", default=None)
    ap.add_argument("--backend", default=None,
                    help="'gloo' to put the model group's ranks on one card")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    if resolve_device(args.device).type == "cuda":
        # the ranks share the build directories: build the kernels here,
        # once, one nvcc a source, all together
        from repro_torch.kernels.build import build_all
        from repro_torch.kernels.flash_attention import ops as flash_ops
        from repro_torch.kernels.rglru_scan import ops as rglru_ops
        from repro_torch.kernels.rwkv6_scan import ops as rwkv_ops

        build_all(flash_ops.LIBS, rwkv_ops.LIBS, rglru_ops.LIBS)
    res = run_group(_card_cases, args.shards, device=args.device, model_shards=args.shards,
                    backend=args.backend,
                    args=(args.arch, args.compute_dtype, args.smoke, args.batch,
                          args.seq_len))
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res, default=float))
    return res


if __name__ == "__main__":
    main()
