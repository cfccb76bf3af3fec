"""Megatron tensor parallelism for the dense family on gloo model groups
(``repro_torch.models.tensor_parallel``, the ``tp`` paths of
``models.layers`` / ``attention`` / ``transformer``, ``models.sharding``'s
placement and the ``tree`` engine on the ``(node, model)`` layout),
through ``launch.mesh.run_group`` and the checks of
``repro_torch.benchmarks.tensor_parallel``:

* three groups, started together: S = 2 (a 1 x 2 group: one node rank,
  two model ranks), S = 4, and 2 node ranks x 2 shards;
* on the smoke configs of tinyllama-1.1b (4 q / 2 kv heads: whole heads
  at S = 2, half a kv head a rank at S = 4), smollm-360m (3 / 1 heads and
  tied tables: cut q heads at S = 2 and 4) and qwen2.5-32b (QKV bias,
  perturbed off the init's zeros), fp32 compute: every tensor-parallel
  layer (column- and row-parallel linear, the all-gather of cut heads,
  the vocab-parallel embedding, attention on the logical heads and on a
  layout of two pad heads, the SwiGLU, the chunked loss
  over two chunks with padded vocab ids) and the whole stack's
  ``lm_loss``, loss and gradients reassembled from the shards, equal the
  whole layer within 1e-5 of their scale; the replicated leaves'
  gradients are bitwise equal on every rank; the model group issues
  exactly ``expected_collectives``;
* the tensor-parallel ``lm_loss`` and gradients against the reference's
  (``jax.value_and_grad`` of its bundle's ``loss_fn``) on the same numpy
  init: ``tests/test_torch_lm_loss.py``'s tolerances (fp32: loss rtol
  1e-5, gradients 1e-4 of each leaf's scale); bf16 compute (smollm, S =
  2): loss rtol 1e-3, gradients within 5e-2 of their scale;
* one FD-DSGT ``tree`` round at Q = 2 on 2 node ranks x 2 shards (smollm,
  a perturbed node-stacked init) against the reference's single-device
  ``TreeEngine`` round on the group's mixing matrix and the same batches:
  the reassembled params within 1e-5 of their scale, ``loss`` /
  ``grad_norm_sq`` / ``consensus_err`` / ``local_loss`` within rtol 1e-5;
  and against the port's whole-model round;
* the 1 x 2 group on 2 nodes: the engine holds both node rows on each
  rank, its shards, and mixes them as the dense W mixes the whole tree;
* ``shard_params`` / ``unshard_params`` round trips and ``rank_bytes``
  leaf for leaf at the production widths (meta), the head plan of each
  production arch at 16 model ranks, the same gathers on every rank of a
  group (padded layouts too), the refusals.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import tensor_parallel as tpc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.engine import get_engine  # noqa: E402
from repro_torch.core.mixing import mesh_gossip_dense_equivalent  # noqa: E402
from repro_torch.core.packing import tree_leaves  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import tensor_parallel as tp_mod  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.sharding import (  # noqa: E402
    model_param_specs,
    rank_bytes,
    shard_params,
    spec_dict,
    unshard_params,
)

ARCHS = ["tinyllama-1.1b", "smollm-360m", "qwen2.5-32b"]
SHARDS = [2, 4]
B, S, CHUNK = 2, 24, 16  # two loss chunks, the second padded
TP_TOL = 1e-5  # the tensor-parallel layer against the whole layer
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}  # tests/test_torch_lm_loss.py's
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
ROUND_ARCH, ROUND_Q, ROUND_NODES, ROUND_SEQ = "smollm-360m", 2, 2, 16


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _tokens(vocab, shape, seed):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(np.int32)


def _reference_init(arch, dtype):
    """The reference's smoke init (numpy), biases moved off their zeros."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_get_config
    from repro.models import transformer as jt

    jc = dataclasses.replace(j_get_config(arch, smoke=True), compute_dtype=dtype)
    tree = jax.tree_util.tree_map(np.asarray, jt.init_params(jc, jax.random.key(0)))
    rng = np.random.default_rng(5)

    def move(path, x):
        last = path[-1]
        return (x + 0.1 * rng.normal(size=x.shape).astype(x.dtype)
                if getattr(last, "key", None) == "b" else x)

    return jc, jax.tree_util.tree_map_with_path(move, tree)


@pytest.fixture(scope="module")
def runs():
    """The three groups' results (started together in threads), and the
    reference's inits, losses, gradients and tree round computed here
    meanwhile."""
    inits = {(arch, "float32"): _reference_init(arch, "float32") for arch in ARCHS}
    inits[("smollm-360m", "bfloat16")] = _reference_init("smollm-360m", "bfloat16")
    toks = {arch: _tokens(inits[(arch, "float32")][0].vocab_size, (B, S + 1), 1)
            for arch in ARCHS}
    rng = np.random.default_rng(7)
    _, one = inits[(ROUND_ARCH, "float32")]
    import jax

    stacked = jax.tree_util.tree_map(
        lambda x: np.stack([x + 1e-2 * rng.normal(size=x.shape).astype(x.dtype)
                            for _ in range(ROUND_NODES)]), one)
    round_toks = _tokens(inits[(ROUND_ARCH, "float32")][0].vocab_size,
                         (ROUND_Q, ROUND_NODES, 1, ROUND_SEQ + 1), 3)

    def lm(arch, dtype="float32"):
        return ("lm", dict(arch=arch, compute_dtype=dtype, params_np=inits[(arch, dtype)][1],
                           tokens=toks[arch], loss_chunk=CHUNK, return_grads=True))

    per_shards = {s: [("layers", dict(arch=a)) for a in ARCHS] + [lm(a) for a in ARCHS]
                  for s in SHARDS}
    per_shards[2] += [lm("smollm-360m", "bfloat16"), ("engine", dict(arch="smollm-360m"))]
    jobs = {s: (s, s, per_shards[s]) for s in SHARDS}
    jobs["round"] = (4, 2, [("round", dict(
        arch=ROUND_ARCH, stacked_np=stacked, batches={"tokens": round_toks}, q=ROUND_Q,
        return_params=True))])
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        futures = {k: pool.submit(mesh.run_group, tpc.cases, world, device="cpu",
                                  model_shards=shards, args=(todo,))
                   for k, (world, shards, todo) in jobs.items()}
        reference = _reference_results(inits, toks, stacked, round_toks)
        got = {k: f.result() for k, f in futures.items()}
    out = {s: dict(zip([f"layers/{a}" for a in ARCHS] + [f"lm/{a}" for a in ARCHS]
                       + (["lm/smollm-360m/bfloat16", "engine"] if s == 2 else []), got[s]))
           for s in SHARDS}
    out["round"] = got["round"][0]
    return out, reference


def _reference_results(inits, toks, stacked, round_toks):
    import jax
    import jax.numpy as jnp
    from repro.core import engine as j_engine
    from repro.core import fl as j_fl
    from repro.core.schedules import inv_sqrt as j_inv_sqrt
    from repro.models import build_model as j_build_model

    out = {}
    for (arch, dtype), (jc, tree) in inits.items():
        loss, grads = jax.jit(jax.value_and_grad(j_build_model(jc).loss_fn))(
            jax.tree_util.tree_map(jnp.asarray, tree), {"tokens": jnp.asarray(toks[arch])})
        out[(arch, dtype)] = (float(loss), jax.tree_util.tree_map(np.asarray, grads))
    jc, _ = inits[(ROUND_ARCH, "float32")]
    cfg = j_fl.FLConfig(algorithm="dsgt", q=ROUND_Q, n_nodes=ROUND_NODES)
    w = mesh_gossip_dense_equivalent({"nodes": ROUND_NODES})
    eng, params = j_engine.TreeEngine.simulated(w, jax.tree_util.tree_map(jnp.asarray,
                                                                          stacked))
    round_fn = jax.jit(j_fl.make_fl_round(j_build_model(jc).loss_fn, None,
                                          j_inv_sqrt(tpc.ALPHA0), cfg, engine=eng))
    state, metrics = round_fn(j_fl.init_fl_state(cfg, params, engine=eng),
                              {"tokens": jnp.asarray(round_toks)})
    out["round"] = (jax.tree_util.tree_map(np.asarray, state.params),
                    {k: float(v) for k, v in metrics.items()})
    return out


def _tc(arch, dtype="float32"):
    return dataclasses.replace(get_config(arch, smoke=True), compute_dtype=dtype)


def _close_to_scale(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = float(np.abs(want).max())
    assert scale > 0 and float(np.abs(got).max()) > 0, what
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, (what, err)


# ---------------------------------------------------------------------------
# the layers and the stack against the whole port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_layer_equals_the_whole_layer(runs, arch, shards):
    errs = runs[0][shards][f"layers/{arch}"]
    names = {k.split("/")[0] for k in errs}
    assert names == {"column_linear", "row_linear", "all_gather", "embedding", "attention",
                     "attention_padded", "swiglu", "chunked_loss"}
    for name in ("attention", "attention_padded"):
        assert len([k for k in errs if k.startswith(f"{name}/grad")]) == (
            5 if arch != "qwen2.5-32b" else 8)  # x and wq wk wv wo (+ three biases)
    bad = {k: v for k, v in errs.items() if not v <= TP_TOL}
    assert not bad, bad


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_equal_the_whole_model(runs, arch, shards):
    res = runs[0][shards][f"lm/{arch}"]
    assert abs(res["loss"] - res["whole_loss"]) <= TP_TOL * abs(res["whole_loss"])
    assert len(res["grad_errs"]) == len(tree_leaves(build_model(_tc(arch)).param_shapes()))
    bad = {k: v for k, v in res["grad_errs"].items() if not v <= TP_TOL}
    assert not bad, bad
    assert res["replicated_equal"]


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_group_issues_the_counted_collectives(runs, arch, shards):
    """One forward and backward, remat on, L layers and C loss chunks: an
    all-reduce for the embedding, 5 a layer (wo and down forward, wo
    again in the recompute, the two column-parallel inputs backward) and
    one more with one all-gather forward and one in the recompute where
    the rank's columns cut a head, one for the loss's hidden state and 4
    a chunk."""
    res = runs[0][shards][f"lm/{arch}"]
    cfg = _tc(arch)
    plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads, 0,
                             shards)
    cut = int(plan.gather_q or plan.gather_kv)
    layers, chunks = cfg.n_layers, -(-S // CHUNK)
    want = {"all-reduce": 1 + layers * (5 + cut) + 1 + 4 * chunks}
    if cut:
        want["all-gather"] = 2 * layers
    assert res["counts"] == want
    assert res["expected"] == {"all-reduce": want["all-reduce"],
                               "all-gather": want.get("all-gather", 0)}
    # whole heads at S = 2 for tinyllama (and qwen's smoke, the same
    # heads), half a kv head at S = 4; smollm's 3 heads always cut
    assert cut == (arch == "smollm-360m" or shards == 4)


# ---------------------------------------------------------------------------
# against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_matches_the_reference(runs, arch, shards):
    res = runs[0][shards][f"lm/{arch}"]
    want_loss, want_grads = runs[1][(arch, "float32")]
    assert abs(res["loss"] - want_loss) <= LOSS_RTOL["float32"] * abs(want_loss)
    want = model_params_from_numpy(want_grads, _tc(arch), "cpu")
    got = dict(tree_leaves(params_from_numpy(res["grads"], "cpu")))
    for path, w in tree_leaves(want):
        _close_to_scale(got[path].numpy(), w.numpy(), GRAD_TOL["float32"], path)


def test_bf16_lm_loss_matches_the_reference(runs):
    res = runs[0][2]["lm/smollm-360m/bfloat16"]
    want_loss, want_grads = runs[1][("smollm-360m", "bfloat16")]
    assert abs(res["loss"] - want_loss) <= LOSS_RTOL["bfloat16"] * abs(want_loss)
    want = model_params_from_numpy(want_grads, _tc("smollm-360m", "bfloat16"), "cpu")
    got = dict(tree_leaves(params_from_numpy(res["grads"], "cpu")))
    for path, w in tree_leaves(want):
        _close_to_scale(got[path].numpy(), w.float().numpy(), GRAD_TOL["bfloat16"], path)
    assert res["replicated_equal"]


def test_tree_round_on_two_by_two_matches_the_reference(runs):
    res = runs[0]["round"]
    want_params, want_m = runs[1]["round"]
    cfg = _tc(ROUND_ARCH)
    got = dict(tree_leaves(params_from_numpy(res["params"], "cpu")))
    nodes = [model_params_from_numpy({k: v for k, v in _index(want_params, i).items()}, cfg,
                                     "cpu") for i in range(ROUND_NODES)]
    for i, node in enumerate(nodes):
        for path, w in tree_leaves(node):
            _close_to_scale(got[path][i].numpy(), w.numpy(), 1e-5, (i, path))
    m = res["metrics"]
    for key in ("loss", "grad_norm_sq", "consensus_err", "local_loss", "alpha"):
        np.testing.assert_allclose(m[key], want_m[key], rtol=1e-5, err_msg=key)
    assert res["replicated_equal"] and res["rows"] == [0]


def _index(tree, i):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_index(v, i) for v in tree]
    return tree[i]


def test_tree_round_on_two_by_two_matches_the_whole_port(runs):
    res = runs[0]["round"]
    m, w = res["metrics"], res["whole_metrics"]
    for key in ("loss", "grad_norm_sq", "consensus_err", "local_loss"):
        np.testing.assert_allclose(m[key], w[key], rtol=1e-5, err_msg=key)
    bad = {k: v for k, v in res["param_errs"].items() if not v <= 1e-5}
    assert not bad, bad


def test_one_by_two_group_holds_both_rows_and_mixes_its_shards(runs):
    res = runs[0][2]["engine"]
    assert res["rows"] == [(0, 2), (0, 2)]
    assert res["misplaced"] == 0.0 and res["mix"] <= 1e-6


# ---------------------------------------------------------------------------
# placement, plans and refusals (no group)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["smollm-360m", "tinyllama-1.1b", "phi3-medium-14b",
                                  "qwen2.5-32b"])
def test_shards_round_trip_and_rank_bytes_leaf_for_leaf(arch):
    """At the production widths on meta, 16 shards: each placed leaf's
    bytes are ``rank_bytes`` of that leaf; on a smoke init, the shards
    put back together are the whole tree bitwise."""
    params = build_model(get_config(arch)).param_shapes()
    specs = spec_dict(model_param_specs(params))
    for shard in (0, 15):
        placed = shard_params(params, shard, 16)
        for (path, leaf), (_, whole) in zip(tree_leaves(placed), tree_leaves(params)):
            assert leaf.numel() * leaf.element_size() == rank_bytes(
                {"x": whole}, {"x": specs[path]}, {"model": 16}), path
    cfg = get_config(arch, smoke=True)
    small = build_model(cfg).init_fn(torch.Generator().manual_seed(0), device="cpu")
    back = unshard_params([shard_params(small, s, 4) for s in range(4)],
                          model_param_specs(small))
    for (path, a), (_, b) in zip(tree_leaves(back), tree_leaves(small)):
        assert torch.equal(a, b), path


def test_head_plans_at_sixteen_model_ranks():
    """The production archs' heads over 16 ranks: TinyLlama's 2 q heads a
    rank are whole but its 4 kv heads are a quarter each (k/v gathered,
    expanded where a rank's q heads are not whole GQA groups); SmolLM's 15
    heads, phi3's and qwen's 40 cut q heads too."""
    want = {"tinyllama-1.1b": (False, True), "smollm-360m": (True, True),
            "phi3-medium-14b": (True, True), "qwen2.5-32b": (True, True)}
    for arch, (gq, gkv) in want.items():
        cfg = get_config(arch)
        for rank in range(16):
            plan = attn.tp_head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_heads,
                                     rank, 16)
            assert (plan.gather_q, plan.gather_kv) == (gq, gkv), (arch, rank)
            assert plan.q_hi - plan.q_lo == cfg.n_heads * cfg.head_dim // 16
            assert plan.h_lo * cfg.head_dim <= plan.q_lo < plan.q_hi <= plan.h_hi * cfg.head_dim
    plan = attn.tp_head_plan(4, 2, 64, 4, 1, 2)  # whole heads and groups: nothing gathered
    assert plan == attn.TPHeads(128, 256, 2, 4, 4, 1, 2, False, False, False)
    # 4 / 2 heads padded to 6 on 2 ranks: rank 1's kv columns are exactly
    # the kv head it reads, rank 0's are not; both gather k/v
    plans = [attn.tp_head_plan(4, 2, 64, 6, r, 2) for r in range(2)]
    assert [(p.gather_q, p.gather_kv) for p in plans] == [(False, True)] * 2
    assert [(p.kv_lo, p.kv_hi) for p in plans] == [(0, 2), (1, 2)]


@pytest.mark.parametrize("heads,kv", [(4, 2), (3, 1), (15, 5), (32, 4), (40, 8), (40, 10)])
def test_every_rank_of_a_group_gathers_alike(heads, kv):
    """The gathers are the group's choice, the same on every rank (or the
    ranks' collectives would not pair), with or without pad heads."""
    for hl in range(heads, heads + 5):
        for size in (2, 4, 8, 16):
            if (hl * 64) % size or (kv * 64) % size:
                continue
            got = {(p.gather_q, p.gather_kv)
                   for p in (attn.tp_head_plan(heads, kv, 64, hl, r, size)
                             for r in range(size))}
            assert len(got) == 1, (heads, kv, hl, size, got)
    with pytest.raises(ValueError, match="do not split evenly"):
        attn.tp_head_plan(3, 1, 64, 3, 0, 5)


def test_the_whole_layer_is_untouched_and_other_families_refuse():
    x = torch.randn(3, 4)
    for fn in (tp_mod.copy_to_model, tp_mod.reduce_from_model, tp_mod.gather_from_model):
        assert fn(x, None) is x
    assert tp_mod.tp_group(None) is None
    # every family of the registry has tensor-parallel layers; flat / fused
    # keep a node's whole flat buffer, so on a group of model shards (not
    # the node ranks alone, as the dry run builds them) both refuse
    for arch in ("rwkv6-7b", "recurrentgemma-2b", "whisper-medium"):
        tt.check_tensor_parallel(get_config(arch, smoke=True))
    shards = mesh.NodeGroup(None, 0, 2, torch.device("cpu"), (), 2)
    for engine in ("flat", "fused"):
        with pytest.raises(ValueError, match="replicas"):
            get_engine(engine).from_group(shards, {"w": torch.zeros(2, 4, 8)})
    # the EHR MLP has no tensor-parallel layers
    other = dataclasses.replace(get_config("rwkv6-7b", smoke=True), family="mlp")
    with pytest.raises(ValueError, match="tensor-parallel layers exist for the dense"):
        tt.lm_loss({}, other, {"tokens": torch.zeros(1, 5, dtype=torch.int64)},
                   tp=tp_mod.TPGroup(None, 0, 2))
    with pytest.raises(ValueError, match="does not split evenly"):
        shard_params({"w": torch.zeros(2, 6)}, 0, 4, {"w": (None, "model")})


def test_start_group_backends(tmp_path):
    with pytest.raises(ValueError, match="NCCL runs CUDA tensors only"):
        mesh.start_group(0, 1, str(tmp_path / "a"), device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="'nccl' or 'gloo'"):
        mesh.start_group(0, 1, str(tmp_path / "b"), device="cpu", backend="mpi")
    # gloo ranks may share a card: the NCCL world rule does not apply
    mesh._check_world(8, torch.device("cuda", 0), backend="gloo")
