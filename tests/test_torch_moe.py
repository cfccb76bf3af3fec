"""The MoE FFN of the PyTorch port (``repro_torch.models.moe``) and the
MoE decoder stacks (``moe`` blocks in ``models.transformer``) against
``repro.models.moe`` and ``repro.models.transformer`` on the same numpy
inputs, from the reference's init carried over by ``repro_torch.convert``.

Tolerances, each relative to the reference output's max |value|:
* routing at fp32 (``top_e``, the renormalized ``top_p``'s choices,
  ``rank``, ``keep``, ``slot``): exactly equal. The router's product
  and softmax run in fp32 on both sides and no two probabilities sit
  within a rounding of each other on these draws; exact ties go to the
  lower expert index on both sides (``test_ties_go_to_the_lower_expert``).
* ``moe_apply`` at fp32 compute: output 1e-5 (the expert products and
  the combine summed in another order; ``index_add_`` adds a token's k
  contributions in an order of its own, a rounding-level difference),
  aux loss 1e-5; at bf16 compute: output 4e-2 (every expert product
  and the combine's cast rounded to bf16, in another order), aux 1e-5
  (the router runs in fp32 on bf16 inputs rounded identically).
* ``lm_loss`` and every leaf's gradient of the MoE smoke configs:
  ``LOSS_RTOL`` / ``GRAD_TOL`` of ``tests/test_torch_lm_loss.py``. At
  bf16 the reference runs eagerly (``jax.disable_jit``), each op rounded
  to bf16 as written, as the port rounds it: compiled, XLA keeps some
  fused bf16 intermediates in fp32 (excess precision), and on the
  llama4 smoke config that alone flips one token's top-1 expert in layer
  1 (a probability margin of 1.0e-3), which moves that token's hidden
  state by 1.67 and the reference's own gradients by up to 32% of their
  scale. Routing is discontinuous: wherever a bf16 rounding flips a
  near-tie, a token changes expert (and, past the capacity, which later
  tokens drop), so no bf16 tolerance holds across all draws. On the
  draw below every choice agrees; at ``jax.random.key(2)`` one flips and
  the gradients differ by 40% of their scale (the reference's own
  gradients move 33% when its parameters are scaled by 1 + 2^-20).
* the prefill / replay gap: the capacity depends on the token count, so
  a prefill (N = B*S tokens) and a step-by-step replay (N = B) can drop
  different assignments. The reference has the same gap; the port's gap
  equals the reference's within 1e-4 of the logits' scale at fp32.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import moe as j_moe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.packing import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.models import moe as t_moe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

MOE_ARCHS = ["dbrx-132b", "llama4-scout-17b-a16e"]
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
OUT_TOL = {"float32": 1e-5, "bfloat16": 4e-2}
D, F_, E = 32, 48, 4


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def _ref_routing(w, xf, n_experts, k, cap):
    """The reference's routing, the lines of ``repro.models.moe.moe_apply``
    from the router's product to the slots, run in JAX."""
    n = xf.shape[0]
    probs = jax.nn.softmax(xf.astype(jnp.float32) @ w, axis=-1)
    top_p, top_e = jax.lax.top_k(probs, k)
    top_p = top_p / jnp.sum(top_p, axis=-1, keepdims=True)
    flat_e = top_e.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(sorted_e, length=n_experts)
    starts = jnp.concatenate([jnp.zeros((1,), counts.dtype), jnp.cumsum(counts)[:-1]])
    rank_sorted = jnp.arange(n * k) - starts[sorted_e]
    rank = jnp.zeros((n * k,), jnp.int32).at[order].set(rank_sorted.astype(jnp.int32))
    keep = rank < cap
    slot = jnp.where(keep, flat_e * cap + rank, n_experts * cap)
    return top_p, top_e, rank, keep, slot


def _moe_params(shared, seed=0):
    jp = j_moe.moe_init(jax.random.key(seed), D, F_, E, jnp.float32, shared_expert=shared)
    return jp, params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _x(b=4, s=32, seed=1):
    return np.random.default_rng(seed).normal(size=(b, s, D)).astype(np.float32)


@pytest.mark.parametrize("n,k,factor", [(n, k, f) for n in (1, 8, 16, 37, 1024)
                                        for k in (1, 2, 4) for f in (0.5, 1.0, 1.25, 2.0)])
def test_moe_capacity_matches_reference(n, k, factor):
    for n_experts in (4, 16):
        assert t_moe.moe_capacity(n, n_experts, k, factor) == j_moe.moe_capacity(
            n, n_experts, k, factor)


def test_moe_init_tree_matches_reference():
    for shared in (False, True):
        jp, _ = _moe_params(shared)
        got = t_moe.moe_init(None, D, F_, E, shared_expert=shared, device="meta")
        want = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
                for k, v in jax.tree_util.tree_leaves_with_path(jp)}
        have = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
                for k, v in jax.tree_util.tree_leaves_with_path(got)}
        assert have == want


@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("shared,k", [(False, 2), (True, 1)])
def test_routing_is_the_references_exactly(shared, k, factor):
    """top_e, rank, keep and slot equal the reference's at fp32; at a
    capacity factor of 0.5 some assignments are dropped."""
    jp, tp = _moe_params(shared)
    xf = _x().reshape(-1, D)
    cap = j_moe.moe_capacity(xf.shape[0], E, k, factor)
    want = _ref_routing(jp["router"]["w"], jnp.asarray(xf), E, k, cap)
    got = t_moe.moe_route(tp["router"]["w"], torch.from_numpy(xf), E, k, cap)
    for name, g, w in zip(("top_e", "rank", "keep", "slot"),
                          (got.top_e, got.rank, got.keep, got.slot), want[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    np.testing.assert_allclose(got.top_p.numpy(), np.asarray(want[0]), rtol=0, atol=1e-6)
    if factor < 1:
        assert not bool(got.keep.all())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [1.25, 0.5])
@pytest.mark.parametrize("shared,k", [(False, 2), (True, 1)])
def test_moe_apply_matches_reference(shared, k, factor, dtype):
    jp, tp = _moe_params(shared)
    x = _x()
    jx = jnp.asarray(x).astype(dtype)
    want, want_aux = j_moe.moe_apply(jp, jx, n_experts=E, k=k, capacity_factor=factor,
                                     compute_dtype=jnp.dtype(dtype))
    tx = torch.tensor(np.asarray(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got, aux = t_moe.moe_apply(tp, tx, n_experts=E, k=k, capacity_factor=factor,
                               compute_dtype=getattr(torch, dtype))
    assert got.dtype == getattr(torch, dtype) and aux.dtype == torch.float32
    _close(got, want, OUT_TOL[dtype])
    assert abs(float(aux) - float(want_aux)) <= 1e-5 * abs(float(want_aux))


def test_ties_go_to_the_lower_expert():
    """Experts 1 and 3 share a router column, so every token's
    probabilities for them are exactly equal; a zero router ties all
    four. ``jax.lax.top_k`` takes the lower index first, and so does the
    port; the outputs follow."""
    jp, _ = _moe_params(False)
    w = np.asarray(jp["router"]["w"]).copy()
    w[:, 3] = w[:, 1]
    w[:, 0] = w[:, 2] = -10.0  # make 1 and 3 the top two for most tokens
    for router in (w, np.zeros_like(w)):
        jq = {**jp, "router": {"w": jnp.asarray(router)}}
        tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq), "cpu")
        xf = np.abs(_x(seed=3)).reshape(-1, D)
        for k in (1, 2):
            cap = j_moe.moe_capacity(xf.shape[0], E, k, 1.25)
            want = _ref_routing(jq["router"]["w"], jnp.asarray(xf), E, k, cap)
            got = t_moe.moe_route(tq["router"]["w"], torch.from_numpy(xf), E, k, cap)
            np.testing.assert_array_equal(got.top_e.numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(got.slot.numpy(), np.asarray(want[4]))
            first = got.top_e[:, 0].numpy()
            if router is w:  # the tied pair: expert 1 always before expert 3
                assert (first != 3).all()
            else:
                assert (got.top_e.numpy() == np.arange(k)).all()
        want_out, _ = j_moe.moe_apply(jq, jnp.asarray(xf[None]), n_experts=E, k=2,
                                      compute_dtype=jnp.float32)
        got_out, _ = t_moe.moe_apply(tq, torch.from_numpy(xf[None]), n_experts=E, k=2,
                                     compute_dtype=torch.float32)
        _close(got_out, want_out, OUT_TOL["float32"])


def _models(arch, dtype):
    jc = dataclasses.replace(j_get_config(arch, smoke=True), compute_dtype=dtype)
    tc = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=dtype)
    jp = jt.init_params(jc, jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_lm_loss_value_and_grads_match_reference(arch, dtype):
    """``lm_loss`` with the aux term (``router_aux_coef`` x the blocks'
    load-balance loss) and every leaf's gradient, the router's included."""
    jc, tc, jp, tp = _models(arch, dtype)
    toks = np.random.default_rng(1).integers(0, jc.vocab_size, (2, 25)).astype(np.int32)
    ref = jax.value_and_grad(j_build_model(jc).loss_fn)
    if dtype == "float32":
        want, want_g = jax.jit(ref)(jp, {"tokens": jnp.asarray(toks)})
    else:  # each op rounded as written: see the module docstring
        with jax.disable_jit():
            want, want_g = ref(jp, {"tokens": jnp.asarray(toks)})
    items = tree_leaves(tp)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
    loss = tt.lm_loss(tree_unflatten(tuple(p for p, _ in items), leaves), tc,
                      {"tokens": torch.from_numpy(toks)})
    grads = torch.autograd.grad(loss, leaves)
    got = loss.detach()
    assert abs(float(got) - float(want)) <= LOSS_RTOL[dtype] * abs(float(want))
    want_t = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, want_g), tc, "cpu")
    for (path, w), g in zip(tree_leaves(want_t), grads):
        g, w = g.float().numpy(), w.float().numpy()
        scale = float(np.abs(w).max())
        assert scale > 0 and float(np.abs(g).max()) > 0, path
        assert float(np.abs(g - w).max()) <= GRAD_TOL[dtype] * scale, (
            path, np.abs(g - w).max() / scale)


def test_moe_aux_loss_enters_lm_loss():
    """The blocks' aux loss times ``router_aux_coef``: doubling the
    coefficient moves the loss by exactly the reference's aux term."""
    jc, tc, jp, tp = _models("dbrx-132b", "float32")
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, (1, 17)).astype(np.int32)
    emb, positions, _ = jt._embed_inputs(jp, jc, {"tokens": jnp.asarray(toks)})
    _, want_aux = jt.forward_hidden(jp, jc, emb, positions, remat=False)
    batch = {"tokens": torch.from_numpy(toks)}
    base = tt.lm_loss(tp, tc, batch, remat=False)
    twice = tt.lm_loss(tp, dataclasses.replace(tc, router_aux_coef=2 * tc.router_aux_coef),
                       batch, remat=False)
    assert float(want_aux) > 0
    assert abs(float(twice - base) - tc.router_aux_coef * float(want_aux)) <= 1e-6


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_prefill_replay_gap_is_the_references(arch):
    """Capacity follows the token count: a prefill of B*S tokens and a
    replay of B tokens a step route through different capacities, so
    they can drop different assignments. The gap between the last
    prefill logits and the replay's is the reference's own; the port's
    gap equals it (fp32 compute, fp32 KV caches on both sides)."""
    jc, tc, jp, tp = _models(arch, "float32")
    # a capacity factor that drops at prefill: the gap is not zero
    jc = dataclasses.replace(jc, moe_capacity_factor=0.5)
    tc = dataclasses.replace(tc, moe_capacity_factor=0.5)
    b, s = 2, 32
    toks = np.random.default_rng(5).integers(0, jc.vocab_size, (b, s)).astype(np.int32)
    want_pre, _ = jt.prefill(jp, jc, {"tokens": jnp.asarray(toks)})
    got_pre, _ = tt.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    jcache = jt.init_decode_state(jc, b, s, cache_dtype=jnp.float32)
    tcache = tt.init_decode_state(tc, b, s, cache_dtype=torch.float32, device="cpu")
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c))
    for t in range(s):
        want_rep, jcache = step(jp, jnp.asarray(toks[:, t]), jcache)
        got_rep, tcache = tt.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long(), tcache)
    want_gap = np.asarray(want_pre) - np.asarray(want_rep)
    got_gap = got_pre.numpy() - got_rep.numpy()
    scale = float(np.abs(np.asarray(want_pre)).max())
    assert float(np.abs(want_gap).max()) > 1e-3 * scale  # the reference's own gap
    np.testing.assert_allclose(got_gap, want_gap, rtol=0, atol=1e-4 * scale)


def test_moe_layers_in_a_hybrid_pattern_match_reference():
    """A ``moe`` kind inside a repeating pattern (the reference allows
    any kind there): 5 layers of (recurrent, moe) -- two layer-stacked
    periods and a tail -- prefill and 4 decode steps at fp32 compute,
    fp32 caches, within 1e-4 of the logits' scale."""
    jc, tc = (dataclasses.replace(get(arch, smoke=True), family="hybrid", n_layers=5,
                                  block_pattern=("recurrent", "moe"), compute_dtype="float32")
              for get, arch in ((j_get_config, "dbrx-132b"), (get_config, "dbrx-132b")))
    jp = jt.init_params(jc, jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    assert "pblocks" in tp and len(tp["tail"]) == 1
    toks = np.random.default_rng(6).integers(0, jc.vocab_size, (2, 6)).astype(np.int32)
    want, _ = jt.prefill(jp, jc, {"tokens": jnp.asarray(toks)})
    got, _ = tt.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4)
    jcache = jt.init_decode_state(jc, 2, 8, cache_dtype=jnp.float32)
    tcache = tt.init_decode_state(tc, 2, 8, cache_dtype=torch.float32, device="cpu")
    for t in range(4):
        want, jcache = jt.decode_step(jp, jc, jnp.asarray(toks[:, t]), jcache)
        got, tcache = tt.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long(), tcache)
        _close(got, want, 1e-4)
