"""The rest of the reference's model zoo on the PyTorch port: the config
registry (every architecture's ``CONFIG`` and ``smoke_config()`` field for
field the reference's, with their parameter counts), the parameter trees
on the meta device against the reference's ``param_shapes()``, the input
specs of ``configs/shapes.py``, prefill and decode of the new smoke
architectures (phi3-medium-14b, qwen2.5-32b with its qkv bias, the MoE
dbrx-132b and llama4-scout-17b-a16e, the InternVL2-26B backbone with its
``prefix_embeds``) against ``repro.models.transformer`` from the
reference's init carried over by ``repro_torch.convert``, and the
serving and training launchers on the CPU for an MoE and the enc-dec
architecture (the enc-dec numerics are in ``tests/test_torch_encdec.py``,
the MoE ones in ``tests/test_torch_moe.py``).

Tolerances on the logits, each relative to max(1, max |logit|), the
``TOL`` of ``tests/test_torch_transformer.py``: 1e-4 at fp32 compute
(the decode runs keep fp32 KV caches at fp32 compute, so that no cache
entry sits on a bf16 rounding boundary), 4e-2 at bf16 compute. The MoE
configs run their bf16 reference eagerly (``jax.disable_jit``), each op
rounded to bf16 as written, as the port rounds it: compiled, XLA keeps
some fused bf16 intermediates in fp32, which can flip a near-tied
routing choice (``tests/test_torch_moe.py``).
"""

import contextlib
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro import configs as j_configs  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs as t_configs  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

NEW_ARCHS = ["phi3-medium-14b", "qwen2.5-32b", "dbrx-132b", "llama4-scout-17b-a16e",
             "internvl2-26b", "whisper-medium"]
DECODER_ARCHS = [a for a in NEW_ARCHS if a != "whisper-medium"]
TOL = {"float32": 1e-4, "bfloat16": 4e-2}
B, P = 2, 10


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


def _models(arch, dtype):
    jc = dataclasses.replace(j_configs.get_config(arch, smoke=True), compute_dtype=dtype)
    tc = dataclasses.replace(t_configs.get_config(arch, smoke=True), compute_dtype=dtype)
    jp = jt.init_params(jc, jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return jc, tc, jp, tp


def _eager(cfg, dtype):
    """The reference op by op (MoE at bf16, see the module docstring)."""
    if cfg.family == "moe" and dtype == "bfloat16":
        return jax.disable_jit()
    return contextlib.nullcontext()


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", list(j_configs.ARCH_MODULES))
def test_registry_configs_are_the_references(arch, smoke):
    want = j_configs.get_config(arch, smoke=smoke)
    got = t_configs.get_config(arch, smoke=smoke)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert type(got).__name__ == type(want).__name__
    if want.family != "mlp":
        assert got.param_count() == want.param_count()
        assert got.active_param_count() == want.active_param_count()
    if want.encoder is not None:
        assert type(got.encoder).__name__ == "EncoderConfig"


def test_registry_lists_and_refusal():
    assert dict(t_configs.ARCH_MODULES) == dict(j_configs.ARCH_MODULES)
    assert t_configs.ASSIGNED_ARCHS == j_configs.ASSIGNED_ARCHS
    assert len(t_configs.ASSIGNED_ARCHS) == 10
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get_config("gpt-5")


def _tree(shapes) -> dict:
    return {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in jax.tree_util.tree_leaves_with_path(shapes)}


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_meta_param_tree_is_the_references(arch, smoke):
    """Full configs too: the meta device allocates nothing (dbrx-132b's
    full tree is 132B parameters)."""
    want = j_build_model(j_configs.get_config(arch, smoke=smoke)).param_shapes()
    got = build_model(t_configs.get_config(arch, smoke=smoke)).param_shapes()
    assert all(leaf.device.type == "meta" for leaf in jax.tree_util.tree_leaves(got))
    assert _tree(got) == _tree(want)


@pytest.mark.parametrize("shape", list(j_configs.SHAPES))
@pytest.mark.parametrize("arch", NEW_ARCHS + ["smollm-360m", "rwkv6-7b"])
def test_input_specs_are_the_references(arch, shape):
    jc, tc = j_configs.get_config(arch), t_configs.get_config(arch)
    js, ts = j_configs.SHAPES[shape], t_configs.SHAPES[shape]
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert t_configs.supports_shape(tc, ts) == j_configs.supports_shape(jc, js)
    assert t_configs.decode_sliding_override(tc, ts) == j_configs.decode_sliding_override(jc, js)
    pairs = [(t_configs.serve_input_specs(tc, ts), j_configs.serve_input_specs(jc, js))]
    if js.global_batch % 8 == 0:
        pairs.append((t_configs.train_input_specs(tc, ts, 8, 2),
                      j_configs.train_input_specs(jc, js, 8, 2)))
    for got, want in pairs:
        assert set(got) == set(want)
        for key in want:
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == want[key].shape, key
            assert str(got[key].dtype).split(".")[-1] == str(want[key].dtype), key
    with pytest.raises(ValueError, match="global_batch"):
        t_configs.train_input_specs(tc, t_configs.SHAPES["long_500k"], 3, 1)


def _batch(cfg, prefix: bool):
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int32)}
    if prefix:
        batch["prefix_embeds"] = rng.normal(
            size=(B, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    return batch


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill (the VLM with and without its prefix) and a decode replay
    of the prompt: logits each step, and the port's replay against its
    own prefill."""
    jc, tc, jp, tp = _models(arch, dtype)
    prefixes = (False, True) if jc.frontend != "none" else (False,)
    for prefix in prefixes:
        batch = _batch(jc, prefix)
        with _eager(jc, dtype):
            want, want_h = jt.prefill(jp, jc, {k: jnp.asarray(v) for k, v in batch.items()})
        got, got_h = tt.prefill(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
        assert got.shape == (B, tc.padded_vocab) and got.dtype == getattr(torch, dtype)
        _close(got, want, TOL[dtype])
        _close(got_h, want_h, TOL[dtype])
    toks = _batch(jc, False)["tokens"]
    cache = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
    jcache = jt.init_decode_state(jc, B, 16, cache_dtype=cache[dtype][0])
    tcache = tt.init_decode_state(tc, B, 16, cache_dtype=cache[dtype][1], device="cpu")
    step = (lambda p, t, c: jt.decode_step(p, jc, t, c))
    if not (jc.family == "moe" and dtype == "bfloat16"):
        step = jax.jit(step)
    for t in range(P):
        with _eager(jc, dtype):
            want, jcache = step(jp, jnp.asarray(toks[:, t]), jcache)
        got, tcache = tt.decode_step(tp, tc, torch.from_numpy(toks[:, t]).long(), tcache)
        _close(got, want, TOL[dtype])
    np.testing.assert_array_equal(tcache["pos"].numpy(), np.asarray(jcache["pos"]))
    pre, _ = tt.prefill(tp, tc, {"tokens": torch.from_numpy(toks)})
    _close(got, pre, 1e-2 if dtype == "float32" else 5e-2)


@pytest.mark.parametrize("arch", ["phi3-medium-14b", "dbrx-132b", "internvl2-26b"])
def test_sliding_override_matches_reference(arch):
    """The long-context policy (dense, MoE and VLM): every layer a ring
    buffer of min(window, max_seq) slots; a 70-step run wraps the smoke
    configs' 64-slot window. fp32 compute and fp32 caches."""
    jc, tc, jp, tp = _models(arch, "float32")
    assert j_configs.decode_sliding_override(jc, j_configs.SHAPES["long_500k"])
    caches = tt.init_decode_state(tc, 1, 128, sliding_override=True,
                                  cache_dtype=torch.float32, device="cpu")
    assert caches["k"].shape[2] == 64
    jcache = jt.init_decode_state(jc, 1, 128, sliding_override=True, cache_dtype=jnp.float32)
    step = jax.jit(lambda p, t, c: jt.decode_step(p, jc, t, c, sliding_override=True))
    toks = np.random.default_rng(2).integers(0, jc.vocab_size, size=(1, 70)).astype(np.int32)
    for t in range(70):
        got, caches = tt.decode_step(tp, tc, torch.tensor(toks[:, t], dtype=torch.long),
                                     caches, sliding_override=True)
        want, jcache = step(jp, jnp.asarray(toks[:, t]), jcache)
        if t % 23 == 0 or t == 69:
            _close(got, want, TOL["float32"])


def test_vlm_loss_with_prefix_matches_reference():
    """``lm_loss`` of the VLM backbone with its 16 prefix embeddings (their
    labels ignored) against the reference's, fp32."""
    jc, tc, jp, tp = _models("internvl2-26b", "float32")
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, jc.vocab_size, size=(B, 9)).astype(np.int32),
             "prefix_embeds": rng.normal(size=(B, jc.frontend_seq, jc.d_model)).astype(
                 np.float32)}
    want = jax.jit(j_build_model(jc).loss_fn)(jp, {k: jnp.asarray(v) for k, v in batch.items()})
    got = tt.lm_loss(tp, tc, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))


@pytest.mark.parametrize("arch", ["dbrx-132b", "whisper-medium"])
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    record = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "4",
                         "--max-new", "5", "--max-seq", "32", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == record
    assert record["arch"] == t_configs.get_config(arch, smoke=True).name
    assert record["steps"] == 9 and len(record["sample_continuation"]) == 5


@pytest.mark.parametrize("arch", ["dbrx-132b", "whisper-medium"])
def test_train_launcher_runs_on_the_cpu(arch):
    """``launch/train.py --smoke`` trains the arch's smoke config on the
    simulated node axis; whisper's batches carry the ``frames`` extra."""
    from repro_torch.launch import train

    got = train.main(["--arch", arch, "--smoke", "--rounds", "2", "--q", "2", "--nodes",
                      "2", "--seq-len", "16", "--log-every", "0", "--device", "cpu"])
    assert got["arch"] == t_configs.get_config(arch, smoke=True).name
    assert got["iterations"] == 4 and got["device"] == "cpu"
    assert np.isfinite([got["loss_first"], got["loss_last"]]).all()



@pytest.mark.parametrize("arch", ["llama4-scout-17b-a16e", "whisper-medium"])
def test_serving_the_new_trees_from_a_snapshot(arch, tmp_path):
    """``from_snapshot`` (staged and unstaged) and ``publish_snapshot``
    take the MoE and enc-dec trees: tokens equal to an in-memory engine's
    on the same weights and with the same weights published, whisper's
    with its frames. (A set published before ``generate`` is swapped in
    at the first step, as in the reference: whisper's cross caches, like
    any cache, come from the weights active when they were filled.)"""
    from repro_torch.core.fl import tree_map
    from repro_torch.core.packing import pack
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.training.snapshot import load_snapshot, write_snapshot

    cfg = dataclasses.replace(t_configs.get_config(arch, smoke=True), compute_dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init_fn(torch.Generator().manual_seed(0), device="cpu")
    params_b = bundle.init_fn(torch.Generator().manual_seed(1), device="cpu")
    for rnd, p in ((1, params), (2, params_b)):
        flat, layout = pack(tree_map(lambda a: a[None], p))
        write_snapshot(str(tmp_path), flat, layout, round_frontier=rnd)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    frames = None
    if cfg.encoder is not None:
        frames = rng.normal(size=(2, cfg.encoder.seq_len, cfg.encoder.d_model)).astype(
            np.float32)
    want = ServeEngine(bundle, params, max_seq=16, batch=2).generate(prompts, 4, frames=frames)
    for stage in (True, False):
        eng = ServeEngine.from_snapshot(bundle, load_snapshot(str(tmp_path), 1,
                                                              template=params),
                                        max_seq=16, batch=2, stage=stage, device="cpu")
        np.testing.assert_array_equal(eng.generate(prompts, 4, frames=frames).tokens,
                                      want.tokens)
    eng.publish_snapshot(load_snapshot(str(tmp_path), template=params))
    mem = ServeEngine(bundle, params, max_seq=16, batch=2)
    mem.publish(params_b, snapshot_round=2)
    want_b = mem.generate(prompts, 4, frames=frames)
    got_b = eng.generate(prompts, 4, frames=frames)
    np.testing.assert_array_equal(got_b.tokens, want_b.tokens)
    assert got_b.swap_steps == want_b.swap_steps == (0,)
    assert eng.snapshot_round == 2 and eng.swap_count == 1
