"""The dense family's tensor-parallel layers on a model group, held to
the whole model (ROADMAP.md queue 1, item 18b slice (i) and ``tree`` on
the ``(node, model)`` layout).

Each check runs as one group of ranks (``launch.mesh.run_group``); every
rank draws the same whole parameters from a seed (or takes a given
tree), keeps its shard (``models.sharding.shard_params``) and runs the
tensor-parallel path; rank 0 also runs the whole model and compares:

  * :func:`layer_cases` -- each layer alone (column- and row-parallel
    ``linear``, the vocab-parallel embedding, attention, the SwiGLU and
    the chunked loss) against the same layer run whole on the same
    inputs, forward and gradients (every rank compares its own shard; the
    worst over the ranks is kept);
  * :func:`lm_case` -- ``lm_loss`` forward and backward of the stack: the
    loss and the gradients reassembled from the shards against the whole
    model's, the replicated leaves' gradients compared across the ranks,
    the model group's collectives counted (``launch.op_analysis``) and
    the flash kernel's launches;
  * :func:`round_case` -- an FD-DSGT round of the ``tree`` engine on the
    ``(node, model)`` layout (``TreeEngine.from_group``) against the same
    round of the whole model on one device (``TreeEngine.simulated`` on
    the group's mixing matrix): the reassembled parameters and the
    metrics;
  * :func:`engine_case` -- the engine's rows and its mixing of the shards.

The command line runs :func:`lm_case` and then one :func:`round_case` at
Q = 1 on 2 nodes (the card's check; one JSON line).

Numbers are max |tp - whole| over the leaf's (or the output's) max
|whole|. On the card a model group of two processes shares the one card
over gloo (``backend="gloo"``: NCCL refuses two ranks on a device).

  PYTHONPATH=src python -m repro_torch.benchmarks.tensor_parallel --smoke --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Dict, List, Optional

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
from repro_torch.launch.mesh import run_group
from repro_torch.launch.op_analysis import op_analysis
from repro_torch.models import attention as attn
from repro_torch.models import build_model
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.models.sharding import (
    is_split,
    model_param_specs,
    shard_params,
    spec_dict,
    stacked_param_specs,
    unshard_params,
)
from repro_torch.models.tensor_parallel import (
    copy_to_model,
    gather_from_model,
    reduce_from_model,
    tp_group,
)
from repro_torch.training.trainer import stack_for_nodes

__all__ = ["layer_cases", "lm_case", "round_case", "engine_case", "cases", "CASES",
           "model_group_counts", "expected_collectives", "gather_whole", "main"]


#: the seed every rank draws the whole parameters and the batches from
SEED = 0
#: the rounds' step size ``ALPHA0 / sqrt(r)``
ALPHA0 = 0.05


def _cfg(arch: str, compute_dtype: str, smoke: bool = False):
    return dataclasses.replace(get_config(arch, smoke=smoke), compute_dtype=compute_dtype)


def _whole(cfg, device, params_np=None) -> Dict:
    """The whole parameters: ``params_np`` (a reference tree) carried over,
    or drawn from :data:`SEED` on the device (every rank draws the same)."""
    if params_np is not None:
        return model_params_from_numpy(params_np, cfg, device)
    return tfm.init_params(cfg, torch.Generator(device=device).manual_seed(SEED), device)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    scale = float(want.detach().float().abs().max())
    return float((got.detach().float() - want.detach().float()).abs().max()) / max(scale, 1e-30)


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


def gather_whole(tree, specs, group) -> tuple:
    """The whole tree of a model group's shards (``unshard_params`` of every
    rank's, ``specs`` the spec tree) and whether every replicated leaf is
    bitwise the same on every rank of the group."""
    tp = tp_group(group.model_pg)
    split = spec_dict(specs)
    items = tree_leaves(tree)
    parts, same = [], True
    for path, leaf in items:
        leaf = leaf.detach().contiguous()
        got = [torch.empty_like(leaf) for _ in range(tp.size)]
        dist.all_gather(got, leaf, group=tp.pg)
        if not is_split(split[path]):
            same = same and all(torch.equal(g, leaf) for g in got)
        parts.append(got)
    paths = tuple(p for p, _ in items)
    shards = [tree_unflatten(paths, [got[r] for got in parts]) for r in range(tp.size)]
    return unshard_params(shards, specs), same


def _rows_whole(tree, group) -> Dict:
    """Every node block's rows of a node-stacked tree, in node order."""
    if group.node_ranks == 1:
        return tree

    def cat(x):
        parts = [torch.empty_like(x) for _ in range(group.node_ranks)]
        dist.all_gather(parts, x.contiguous(), group=group.wire_pg)
        return torch.cat(parts, dim=0)

    return tree_map(cat, tree)


def model_group_counts(costs, group) -> Dict[str, int]:
    """The collectives ``op_analysis`` saw on the model group, by kind."""
    on = costs.on_group(dist.get_process_group_ranks(group.model_pg))
    return {kind: int(d["count"]) for kind, d in on.items()}


def expected_collectives(cfg, size: int, seq_len: int,
                         loss_chunk: int = 512) -> Dict[str, int]:
    """The collectives of one ``lm_loss`` forward and backward of a dense
    stack under remat on a model group of ``size`` (the same on every
    rank): the embedding's all-reduce; a layer's two forward all-reduces
    (attention's ``wo``, the SwiGLU's ``down``) and two backward
    all-reduces (the gradients of the inputs of its column-parallel
    products), plus, where the group gathers cut heads, one all-gather
    forward and one all-reduce backward; the recompute issues the
    all-gather and ``wo``'s all-reduce again, but not ``down``'s: it is
    the layer's last operation, whose output the backward does not need,
    and the recompute stops once it has every tensor the backward does
    (``torch.utils.checkpoint``'s early stop). Then the loss's all-reduce
    of the hidden state's gradient and, a sequence chunk, two forward
    all-reduces (the max; the sum of exponentials with the gold logit),
    both issued again by the chunk's recompute."""
    plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                             attn.layout_heads(cfg.n_heads, cfg.tp_head_pad), 0, size)
    gather = int(plan.gather_q or plan.gather_kv)
    chunks = -(-seq_len // loss_chunk)
    return {"all-reduce": 1 + cfg.n_layers * (5 + gather) + 1 + 4 * chunks,
            "all-gather": cfg.n_layers * gather * 2}


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


def layer_cases(group, arch: str) -> Dict[str, float]:
    """Every tensor-parallel layer of ``arch``'s smoke config at fp32
    against the same layer whole, on this rank's shard (the worst rank's
    errors are returned)."""
    tp = tp_group(group.model_pg)
    dev = group.device
    cfg = _cfg(arch, "float32", smoke=True)
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, b, s, cd = cfg.d_model, 2, 12, torch.float32

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    errs: Dict[str, float] = {}

    def record(name, tp_out, whole_out, grad_pairs):
        errs[name] = _rel(tp_out, whole_out)
        for i, (got, want) in enumerate(grad_pairs):
            errs[f"{name}/grad{i}"] = _rel(got, want)

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

    def attention(name, pa, hl):
        if cfg.qkv_bias:  # the init's zeros would hide a misplaced bias
            pa = tree_map(lambda a: a + 0.1 * torch.randn(a.shape, generator=g, device=dev)
                          if a.ndim == 1 else a, pa)
        paths = tuple(p for p, _ in tree_leaves(pa))
        specs = spec_dict(model_param_specs(pa))
        kw = dict(n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads, head_dim=cfg.head_dim,
                  rope_theta=cfg.rope_theta, compute_dtype=cd, n_heads_layout=hl)

        def attn_fn(tp_):
            return lambda x, *ls: attn.attn_apply(tree_unflatten(paths, list(ls)), x, pos,
                                                  tp=tp_, **kw)

        whole, gw_all = _vg(attn_fn(None), [x] + [leaf for _, leaf in tree_leaves(pa)])
        shards = [leaf for _, leaf in tree_leaves(shard_params(pa, tp.rank, tp.size))]
        out, gt_all = _vg(attn_fn(tp), [x] + shards)
        pairs = [(gt_all[0], gw_all[0])]
        for path, got, want in zip(paths, gt_all[1:], gw_all[1:]):
            dim = next((i for i, e in enumerate(specs[path]) if e == "model"), None)
            pairs.append((got, want if dim is None else _cut(want, dim, tp)))
        record(name, out, whole, pairs)

    params = tfm.init_params(cfg, g, dev)
    attention("attention", tree_map(lambda a: a[0], params["blocks"])["attn"], cfg.n_heads)
    # two pad heads: the ranks' own plans differ (at S = 2, 4 / 2 heads
    # padded to 6 leave one rank's kv columns exact and not the other's),
    # and at S = 4 the last rank holds pad heads only
    hl = cfg.n_heads + 2
    attention("attention_padded", attn.attn_init(
        g, d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, qkv_bias=cfg.qkv_bias,
        n_heads_layout=hl, device=dev), hl)
    # the SwiGLU, column then row
    pm = tree_map(lambda a: a[0], params["blocks"])["mlp"]
    mpaths = tuple(p for p, _ in tree_leaves(pm))
    mspecs = spec_dict(model_param_specs(pm))

    def mlp_fn(tp_):
        return lambda x, *ls: layers.swiglu(tree_unflatten(mpaths, list(ls)), x, cd, tp_)

    whole, gw_all = _vg(mlp_fn(None), [x] + [leaf for _, leaf in tree_leaves(pm)])
    out, gt_all = _vg(mlp_fn(tp), [x] + [leaf for _, leaf in tree_leaves(
        shard_params(pm, tp.rank, tp.size))])
    pairs = [(gt_all[0], gw_all[0])]
    for path, got, want in zip(mpaths, gt_all[1:], gw_all[1:]):
        dim = next(i for i, e in enumerate(mspecs[path]) if e == "model")
        pairs.append((got, _cut(want, dim, tp)))
    record("swiglu", out, whole, pairs)
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


# ---------------------------------------------------------------------------
# lm_loss of the stack
# ---------------------------------------------------------------------------


def _value_and_grad(params, cfg, batch, tp, loss_chunk):
    items = tree_leaves(params)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
    loss = tfm.lm_loss(tree_unflatten(tuple(p for p, _ in items), leaves), cfg, batch,
                       loss_chunk=loss_chunk, tp=tp)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree_unflatten(tuple(p for p, _ in items), list(grads))


def lm_case(group, arch: str, compute_dtype: str = "float32", *, smoke: bool = True,
            params_np=None, tokens=None,
            batch: int = 2, seq_len: int = 16, loss_chunk: int = 512,
            return_grads: bool = False) -> Dict:
    """``lm_loss`` forward and backward of ``arch`` on this rank's shards
    (tokens ``(batch, seq_len + 1)`` drawn from a seed, or given), and on
    rank 0 the whole model's on the same inputs. Returns (rank 0): the
    two losses, each leaf's gradient error, whether the replicated
    leaves' gradients are bitwise equal on every rank, the model group's
    collectives (counted) and their expected counts, each rank's flash
    launches in the tensor-parallel call, the seconds of both calls, and with
    ``return_grads`` the reassembled gradients as numpy."""
    dev = group.device
    cfg = _cfg(arch, compute_dtype, smoke)
    tp = tp_group(group.model_pg)
    whole = _whole(cfg, dev, params_np)
    specs = model_param_specs(whole)
    if tokens is None:
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        tokens = torch.randint(0, cfg.vocab_size, (batch, seq_len + 1), generator=g,
                               device=dev)
    batch_ = {"tokens": torch.as_tensor(tokens, device=dev)}
    mine = shard_params(whole, tp.rank, tp.size)
    flash_attention.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    with op_analysis() as oa:
        loss, grads = _value_and_grad(mine, cfg, batch_, tp, loss_chunk)
        _sync(dev)
    tp_s = time.perf_counter() - t0
    launches = _per_rank(flash_attention.launches, group.pg)
    counts = model_group_counts(oa.costs(), group)
    del mine
    got, same = gather_whole(grads, specs, group)
    del grads
    if group.rank != 0:
        return {}
    t0 = time.perf_counter()
    wloss, wgrads = _value_and_grad(whole, cfg, batch_, None, loss_chunk)
    _sync(dev)
    whole_s = time.perf_counter() - t0
    errs = {"/".join(map(str, p)): _rel(a, b)
            for (p, a), (_, b) in zip(tree_leaves(got), tree_leaves(wgrads))}
    out = {"loss": float(loss), "whole_loss": float(wloss), "grad_errs": errs,
           "replicated_equal": bool(same), "counts": counts,
           "expected": expected_collectives(cfg, tp.size,
                                            batch_["tokens"].shape[1] - 1, loss_chunk),
           "flash_launches": launches, "layers": cfg.n_layers,
           "tp_s": tp_s, "whole_s": whole_s}
    if return_grads:
        out["grads"] = tree_map(lambda a: a.detach().float().cpu().numpy(), got)
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


# ---------------------------------------------------------------------------
# tree rounds on the (node, model) layout
# ---------------------------------------------------------------------------


def round_case(group, arch: str, compute_dtype: str = "float32", *, smoke: bool = True,
               stacked_np=None, batches=None, q: int = 2, batch: int = 1,
               seq_len: int = 16, perturb: float = 0.0,
               return_params: bool = False) -> Dict:
    """One FD-DSGT round of the ``tree`` engine on this rank's node rows and
    shards (the tensor-parallel bundle), and on rank 0 the same round of
    the whole model on one device. The init: ``stacked_np`` (a
    node-stacked reference tree), or the seed's drawn on each of 2 nodes
    plus ``perturb`` times a normal draw. ``batches``:
    ``{"tokens": (Q, nodes, batch, seq_len + 1)}``, drawn from the seed
    when None; the step size ``ALPHA0 / sqrt(r)``. Returns (rank 0) the
    metrics of both, each leaf's parameter error (and of its update,
    against the whole round's), each rank's flash launches and the
    seconds of the tensor-parallel round; ``return_params`` adds the
    reassembled parameters as numpy."""
    dev = group.device
    cfg = _cfg(arch, compute_dtype, smoke)
    if stacked_np is not None:
        stacked = params_from_numpy(stacked_np, dev)
    else:
        stacked = stack_for_nodes(_whole(cfg, dev), 2, perturb=perturb,
                                  generator=torch.Generator(device=dev).manual_seed(SEED + 2)
                                  if perturb else None)
    nodes = tree_leaves(stacked)[0][1].shape[0]
    if batches is not None:
        batches = {k: torch.as_tensor(v, device=dev) for k, v in batches.items()}
    else:
        g = torch.Generator(device=dev).manual_seed(SEED + 1)
        batches = {"tokens": torch.randint(0, cfg.vocab_size,
                                           (q, nodes, batch, seq_len + 1),
                                           generator=g, device=dev)}
    fl = FLConfig(algorithm="dsgt", q=q, n_nodes=nodes)
    bundle = build_model(cfg, remat=True, model_group=group.model_pg)
    eng, rows = TreeEngine.from_group(group, stacked)
    state = init_fl_state(fl, rows, eng)
    round_fn = make_fl_round(bundle.loss_fn, inv_sqrt(ALPHA0), fl, eng)
    flash_attention.launches = 0
    _sync(dev)
    t0 = time.perf_counter()
    state, m = round_fn(state, batches)
    metrics = {k: float(v) for k, v in m.items()}
    _sync(dev)
    tp_s = time.perf_counter() - t0
    launches = _per_rank(flash_attention.launches, group.pg)
    got, same = gather_whole(_rows_whole(state.params, group), stacked_param_specs(stacked),
                             group)
    del state, rows
    if group.rank != 0:
        return {}
    out = {"metrics": metrics, "replicated_equal": bool(same), "tp_s": tp_s,
           "flash_launches": launches, "rows": list(eng.rows), "layers": cfg.n_layers}
    w = mesh_gossip_dense_equivalent(group.axes(nodes))
    weng, wparams = TreeEngine.simulated(w, stacked)
    wstate = init_fl_state(fl, wparams, weng)
    wround = make_fl_round(build_model(cfg, remat=True).loss_fn, inv_sqrt(ALPHA0), fl, weng)
    t0 = time.perf_counter()
    wstate, m = wround(wstate, batches)
    wmetrics = {k: float(v) for k, v in m.items()}
    _sync(dev)
    pairs = list(zip(tree_leaves(got), tree_leaves(wstate.params), tree_leaves(stacked)))
    out.update(whole_metrics=wmetrics, whole_s=time.perf_counter() - t0,
               param_errs={"/".join(map(str, p)): _rel(a, b) for (p, a), (_, b), _ in pairs},
               update_errs={"/".join(map(str, p)): _rel(a - s0, b - s0)
                            for (p, a), (_, b), (_, s0) in pairs})
    if return_params:
        out["params"] = tree_map(lambda a: a.detach().float().cpu().numpy(), got)
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


def _card_cases(group, arch: str, compute_dtype: str, smoke: bool, batch: int,
                seq_len: int) -> Dict:
    """What the card's check runs on one group: :func:`lm_case`, then one
    :func:`round_case` at Q = 1 on 2 nodes."""
    lm = lm_case(group, arch, compute_dtype, smoke=smoke, batch=batch, seq_len=seq_len)
    rnd = round_case(group, arch, compute_dtype, smoke=smoke, q=1, batch=batch,
                     seq_len=seq_len, perturb=1e-3)
    return {"lm": lm, "round": rnd}


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="smollm-360m")
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
        # the ranks share the build directory: build the kernel here, once
        from repro_torch.kernels.flash_attention import ops as flash_ops

        flash_ops.LIBS.build([flash_ops.SOURCES[getattr(torch, args.compute_dtype)]])
    res = run_group(_card_cases, args.shards, device=args.device, model_shards=args.shards,
                    backend=args.backend,
                    args=(args.arch, args.compute_dtype, args.smoke, args.batch,
                          args.seq_len))
    res["seconds"] = time.perf_counter() - t0
    print(json.dumps(res, default=float))
    return res


if __name__ == "__main__":
    main()
