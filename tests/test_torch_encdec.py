"""The enc-dec family of the PyTorch port (``repro_torch.models.encdec``,
the audio bundle of ``models.model``, ``ServeEngine.generate(frames=)``)
against ``repro.models.encdec`` and the reference's engine on the smoke
whisper-medium config (2 + 2 layers, width 256, 32 encoder frames),
from the reference's init carried over by ``repro_torch.convert`` and
the same numpy frames and tokens.

Tolerances, each relative to max(1, max |reference|), as in
``tests/test_torch_transformer.py``: fp32 compute 1e-4 (the same
function summed in another order; the decode runs keep fp32 self and
cross caches on both sides at fp32 compute, so that no cache entry sits
on a bf16 rounding boundary -- with the default bf16 caches one cross
K/V entry an ulp apart rounds to a neighbouring bf16 and moves a logit
by 1.5e-4), bf16 compute 4e-2 (every product
rounded to bf16 in another order, and the reference's plain attention
rounds its probabilities to bf16 where the port's kernels keep them in
fp32). ``encdec_loss`` and its gradients: ``LOSS_RTOL`` / ``GRAD_TOL``
of ``tests/test_torch_lm_loss.py`` (the loss within rtol 1e-5 / 1e-3,
every leaf's gradient within 1e-4 / 5e-2 of the leaf's max |gradient|;
the key projections' biases, whose exact gradient is zero -- a softmax
over keys does not move when every score gains the same q . b_k -- are
held to the tolerance times their block's value-bias gradient, as their
rounding noise has no scale of its own). Greedy tokens at fp32: exactly
the reference engine's.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import encdec as je  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.fl import tree_map, value_and_grad  # noqa: E402
from repro_torch.core.packing import tree_leaves, tree_unflatten  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as te  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCH = "whisper-medium"
TOL = {"float32": 1e-4, "bfloat16": 4e-2}
LOSS_RTOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
B, P, MAX_SEQ = 2, 6, 16


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _models(dtype):
    jc = dataclasses.replace(j_get_config(ARCH, smoke=True), compute_dtype=dtype)
    tc = dataclasses.replace(get_config(ARCH, smoke=True), compute_dtype=dtype)
    jp = je.encdec_init(jc, jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _frames(cfg, b=B, seed=2):
    e = cfg.encoder
    return np.random.default_rng(seed).normal(size=(b, e.seq_len, e.d_model)).astype(np.float32)


def _tokens(cfg, s, b=B, seed=1):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(1.0, float(np.abs(want).max())))


def test_encdec_param_tree_matches_reference():
    jc = j_get_config(ARCH, smoke=True)
    want = jax.eval_shape(lambda k: je.encdec_init(jc, k), jax.random.key(0))
    got = build_model(get_config(ARCH, smoke=True)).param_shapes()
    flat_w = {jax.tree_util.keystr(k): (v.shape, str(v.dtype))
              for k, v in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
              for k, v in jax.tree_util.tree_leaves_with_path(got)}
    assert flat_g == flat_w


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_prefill_match_reference(dtype):
    jc, tc, jp, tp = _models(dtype)
    frames, toks = _frames(jc), _tokens(jc, P)
    want_enc = jax.jit(lambda p, f: je.encode(p, jc, f))(jp, jnp.asarray(frames))
    got_enc = te.encode(tp, tc, torch.from_numpy(frames))
    assert got_enc.dtype == getattr(torch, dtype)
    _close(got_enc, want_enc, TOL[dtype])
    batch = {"frames": frames, "tokens": toks}
    want, want_enc2 = jax.jit(lambda p, b: je.encdec_prefill(p, jc, b))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got, got_enc2 = build_model(tc).prefill_fn(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert got.shape == (B, tc.padded_vocab)
    _close(got, want, TOL[dtype])
    _close(got_enc2, want_enc2, TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_kv_and_decode_steps_match_reference(dtype):
    """``encdec_fill_cross_kv`` and ``encdec_decode_step`` over several
    steps: logits each step, the self caches and the cross K/V (bf16 on
    both sides), and the port's replay against its own prefill."""
    jc, tc, jp, tp = _models(dtype)
    frames, toks = _frames(jc), _tokens(jc, P)
    cache = getattr(torch, dtype)  # fp32 caches at fp32 compute: see the docstring
    enc = jax.jit(lambda p, f: je.encode(p, jc, f))(jp, jnp.asarray(frames))
    jstate = je.encdec_fill_cross_kv(jp, jc, enc, je.encdec_init_decode_state(
        jc, B, MAX_SEQ, cache_dtype=jnp.dtype(dtype)))
    tenc = te.encode(tp, tc, torch.from_numpy(frames))
    bundle = build_model(tc)
    tstate = te.encdec_fill_cross_kv(tp, tc, tenc, te.encdec_init_decode_state(
        tc, B, MAX_SEQ, cache_dtype=cache, device="cpu"))
    assert tstate["cross_k"].shape == (tc.n_layers, B, tc.encoder.seq_len, tc.n_heads,
                                       tc.head_dim)
    assert tstate["cross_k"].dtype == tstate["self"]["k"].dtype == cache
    assert bundle.init_decode_state_fn(B, MAX_SEQ, device="cpu")["cross_v"].dtype == \
        torch.bfloat16  # the default, as the reference's
    for key in ("cross_k", "cross_v"):
        _close(tstate[key], jstate[key], TOL[dtype])
    step = jax.jit(lambda p, t, s: je.encdec_decode_step(p, jc, t, s))
    for t in range(P):
        want, jstate = step(jp, jnp.asarray(toks[:, t]), jstate)
        got, tstate = bundle.decode_fn(tp, torch.from_numpy(toks[:, t]).long(), tstate)
        _close(got, want, TOL[dtype])
    np.testing.assert_array_equal(tstate["self"]["pos"].numpy(),
                                  np.asarray(jstate["self"]["pos"]))
    _close(tstate["self"]["k"], jstate["self"]["k"], TOL[dtype])
    pre, _ = bundle.prefill_fn(tp, {"frames": torch.from_numpy(frames),
                                    "tokens": torch.from_numpy(toks)})
    _close(got, pre, 1e-2 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encdec_loss_value_and_grads_match_reference(dtype):
    jc, tc, jp, tp = _models(dtype)
    batch = {"frames": _frames(jc), "tokens": _tokens(jc, 13)}
    want, want_g = jax.jit(jax.value_and_grad(j_build_model(jc).loss_fn))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    items = tree_leaves(tp)
    leaves = [leaf.detach().requires_grad_(True) for _, leaf in items]
    loss = te.encdec_loss(tree_unflatten(tuple(p for p, _ in items), leaves), tc,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert abs(float(loss.detach()) - float(want)) <= LOSS_RTOL[dtype] * abs(float(want))
    want_t = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, want_g), tc, "cpu")
    want_leaves = dict(tree_leaves(want_t))
    for (path, w), g in zip(tree_leaves(want_t), grads):
        g, w = g.float().numpy(), w.float().numpy()
        scale = float(np.abs(w).max())
        if path[-2:] == ("wk", "b"):  # zero in exact arithmetic: see the docstring
            scale = float(want_leaves[path[:-2] + ("wv", "b")].abs().max())
        assert float(np.abs(g).max()) > 0, path
        assert float(np.abs(g - w).max()) <= GRAD_TOL[dtype] * scale, (
            path, np.abs(g - w).max(), scale)


def test_node_batched_loss_fn_and_remat():
    """The bundle's ``loss_fn`` gives each node its loss (the reference
    vmaps its single-node loss); remat on and off agree bitwise."""
    jc, tc, jp, tp = _models("float32")
    jp2 = jax.tree_util.tree_map(lambda a: jnp.stack([a, a * 1.01]), jp)
    frames = np.stack([_frames(jc, seed=3), _frames(jc, seed=4)])
    toks = np.stack([_tokens(jc, 9, seed=5), _tokens(jc, 9, seed=6)])
    want = jax.vmap(j_build_model(jc).loss_fn)(
        jp2, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)})
    tp2 = tree_map(lambda *a: torch.stack(a), *[
        model_params_from_numpy(jax.tree_util.tree_map(lambda a, i=i: np.asarray(a[i]), jp2),
                                tc, "cpu") for i in range(2)])
    batch = {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(toks)}
    got, grads = value_and_grad(build_model(tc).loss_fn)(tp2, batch)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    off, grads_off = value_and_grad(build_model(tc, remat=False).loss_fn)(tp2, batch)
    assert torch.equal(got, off)
    for (path, a), (_, b) in zip(tree_leaves(grads), tree_leaves(grads_off)):
        assert torch.equal(a, b), path


def test_greedy_generation_with_frames_matches_reference():
    """``generate(frames=)`` encodes once, fills the cross caches and
    decodes: greedy tokens equal the reference engine's at fp32."""
    jc, tc, jp, tp = _models("float32")
    frames, prompts = _frames(jc), _tokens(jc, P)
    want = JServeEngine(j_build_model(jc), jp, max_seq=MAX_SEQ, batch=B).generate(
        prompts, max_new_tokens=8, frames=frames)
    engine = ServeEngine(build_model(tc), tp, max_seq=MAX_SEQ, batch=B)
    got = engine.generate(prompts, max_new_tokens=8, frames=frames)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.steps == want.steps == P + 8
    with pytest.raises(ValueError, match="frames"):
        engine.generate(prompts, max_new_tokens=2)
