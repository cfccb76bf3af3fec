"""The serving path of the PyTorch port (``repro_torch.serving.engine``,
``repro_torch.launch.serve``, ``repro_torch.examples.serve_decode``)
against ``repro.serving.engine`` on the smoke TinyLlama-1.1B,
SmolLM-360M, RWKV6-7B and RecurrentGemma-2B, and a narrow patterned
hybrid, from the reference's own weights carried over by
``repro_torch.convert``.

At fp32 compute, greedy generation must give exactly the reference
engine's tokens (the logits agree to ~1e-5, far inside the gaps between
the top two logits of these prompts), before and after a hot swap.
Temperature sampling draws from a ``torch.Generator`` (other numbers
than ``jax.random``), so it is held to the vocabulary, not to the
reference's tokens.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.models import build_model as j_build_model  # noqa: E402
from repro.serving.engine import ServeEngine as JServeEngine  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.fl import tree_map  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402

MAX_SEQ = 64


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _engines(arch, batch, dtype="float32", **kw):
    jc = dataclasses.replace(j_get_config(arch, smoke=True), compute_dtype=dtype)
    tc = dataclasses.replace(get_config(arch, smoke=True), compute_dtype=dtype)
    jb, tb = j_build_model(jc), build_model(tc)
    jp = jb.init_fn(jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    return (JServeEngine(jb, jp, max_seq=MAX_SEQ, batch=batch, **kw),
            ServeEngine(tb, tp, max_seq=MAX_SEQ, batch=batch, **kw))


def _patterned(get):
    """A narrow hybrid with two whole periods and a tail (``pblocks`` and
    ``tail``): 8 layers of (recurrent, recurrent, local_attention),
    window 8, so the local caches wrap."""
    return dataclasses.replace(get("recurrentgemma-2b", smoke=True), n_layers=8,
                               block_pattern=("recurrent", "recurrent", "local_attention"),
                               window=8)


RECURRENT = {
    "rwkv6-7b": lambda get: get("rwkv6-7b", smoke=True),
    "recurrentgemma-2b": lambda get: get("recurrentgemma-2b", smoke=True),
    "patterned": _patterned,
}


def _prompts(cfg, batch, length, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, size=(batch, length)).astype(np.int32)


@pytest.mark.parametrize("arch,sliding", [("tinyllama-1.1b", False),
                                          ("smollm-360m", True)])
def test_greedy_generation_matches_reference_tokens(arch, sliding):
    jeng, teng = _engines(arch, batch=2, sliding_override=sliding)
    prompts = _prompts(teng.cfg, 2, 8)
    want = jeng.generate(prompts, max_new_tokens=10, temperature=0.0)
    got = teng.generate(prompts, max_new_tokens=10, temperature=0.0)
    assert got.tokens.dtype == np.int32 and got.tokens.shape == (2, 18)
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert (got.prompt_len, got.steps, got.swap_steps) == (8, 18, ())
    again = teng.generate(prompts, max_new_tokens=10, temperature=0.0)
    np.testing.assert_array_equal(again.tokens, got.tokens)


@pytest.mark.parametrize("name", list(RECURRENT))
def test_recurrent_greedy_generation_matches_reference_tokens(name):
    """RWKV6 (layer-stacked states in a dict) and the hybrids (a list of
    per-layer states) through the same engine: at fp32, exactly the
    reference engine's greedy tokens."""
    jc = dataclasses.replace(RECURRENT[name](j_get_config), compute_dtype="float32")
    tc = dataclasses.replace(RECURRENT[name](get_config), compute_dtype="float32")
    jb, tb = j_build_model(jc), build_model(tc)
    jp = jb.init_fn(jax.random.key(0))
    tp = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), tc, "cpu")
    jeng = JServeEngine(jb, jp, max_seq=MAX_SEQ, batch=2)
    teng = ServeEngine(tb, tp, max_seq=MAX_SEQ, batch=2)
    caches = teng.new_caches()
    assert isinstance(caches, dict if name == "rwkv6-7b" else list)
    prompts = _prompts(tc, 2, 8)
    want = jeng.generate(prompts, max_new_tokens=10, temperature=0.0)
    got = teng.generate(prompts, max_new_tokens=10, temperature=0.0)
    assert got.tokens.shape == (2, 18) and (got.prompt_len, got.steps) == (8, 18)
    np.testing.assert_array_equal(got.tokens, want.tokens)


def _hook_publish(engine, params_b, at_call, snapshot_round):
    """Publish ``params_b`` from outside right after the engine's
    ``at_call``-th decode step (the reference suite's hook)."""
    orig = engine.decode_step
    calls = {"n": 0}

    def hooked(tokens, caches):
        out = orig(tokens, caches)
        calls["n"] += 1
        if calls["n"] == at_call:
            engine.publish(params_b, snapshot_round=snapshot_round)
        return out

    engine.decode_step = hooked


def test_publish_mid_run_swaps_at_the_next_step_boundary():
    """A publish after step 4 lands at the boundary of step 5, as in the
    reference: the same swap_steps, swap_count, snapshot_round and
    staleness, and the same tokens on both sides of the swap."""
    jeng, teng = _engines("tinyllama-1.1b", batch=1, snapshot_round=1)
    prompts = _prompts(teng.cfg, 1, 3)
    _hook_publish(jeng, jax.tree_util.tree_map(lambda x: x * 0.95, jeng.params), 5, 9)
    _hook_publish(teng, tree_map(lambda x: x * 0.95, teng.params), 5, 9)
    assert teng.staleness(12) == jeng.staleness(12) == 11
    want = jeng.generate(prompts, max_new_tokens=8, temperature=0.0)
    got = teng.generate(prompts, max_new_tokens=8, temperature=0.0)
    assert got.swap_steps == want.swap_steps == (5,)
    assert teng.swap_count == jeng.swap_count == 1
    assert len(teng.swap_pauses) == 1
    assert teng.snapshot_round == jeng.snapshot_round == 9
    assert teng.staleness(12) == jeng.staleness(12) == 3
    np.testing.assert_array_equal(got.tokens, want.tokens)
    assert got.tokens.shape == (1, 11) and got.steps == 11


def test_pending_weights_do_not_change_staleness_before_the_swap():
    _, teng = _engines("smollm-360m", batch=1, snapshot_round=7)
    assert teng.staleness(12) == 5
    teng.publish(teng.params, snapshot_round=9)
    assert teng.staleness(12) == 5
    assert teng._maybe_swap() and teng.staleness(12) == 3
    assert not teng._maybe_swap()
    _, raw = _engines("smollm-360m", batch=1)
    assert raw.staleness(5) is None


def test_temperature_sampling_stays_in_the_vocab():
    _, teng = _engines("tinyllama-1.1b", batch=2, dtype="bfloat16")
    prompts = np.zeros((2, 4), np.int32)
    out = teng.generate(prompts, max_new_tokens=16, temperature=1.5, seed=7)
    assert out.tokens.shape == (2, 20)
    assert (out.tokens >= 0).all() and (out.tokens < teng.cfg.vocab_size).all()
    again = teng.generate(prompts, max_new_tokens=16, temperature=1.5, seed=7)
    np.testing.assert_array_equal(again.tokens, out.tokens)  # seeded
    other = teng.generate(prompts, max_new_tokens=16, temperature=1.5, seed=8)
    assert not np.array_equal(other.tokens, out.tokens)
    with pytest.raises(ValueError, match="batch 2"):
        teng.generate(np.zeros((3, 4), np.int32), max_new_tokens=1)


def test_padded_vocab_is_never_sampled():
    """Logits that favour a padded id: greedy and sampled tokens stay
    below vocab_size (the engine masks the pad to -1e30)."""
    _, teng = _engines("smollm-360m", batch=2)
    logits = torch.zeros(2, teng.cfg.padded_vocab)
    logits[:, teng.cfg.vocab_size:] = 100.0
    gen = torch.Generator().manual_seed(0)
    assert (teng._sample(logits, gen, 0.0) < teng.cfg.vocab_size).all()
    assert (teng._sample(logits, gen, 1.0) < teng.cfg.vocab_size).all()


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    record = serve.main(["--arch", "tinyllama-1.1b", "--batch", "2", "--prompt-len", "4",
                         "--max-new", "5", "--max-seq", "32", "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert printed == record
    assert record["arch"] == "tinyllama-1.1b-smoke" and record["device"] == "cpu"
    assert record["steps"] == 9 and record["tokens_generated"] == 10
    assert len(record["sample_continuation"]) == 5


def test_serve_example_runs_on_the_cpu(capsys):
    from repro_torch.examples import serve_decode

    tokens = serve_decode.demo("smollm-360m", sliding=True, batch=2, max_new=4,
                               device="cpu")
    assert tokens.shape == (2, 12)
    serve_decode.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "tinyllama-1.1b" in out and "sliding-window cache" in out
    assert "rwkv6-7b" in out and "recurrentgemma-2b" in out


@pytest.mark.parametrize("arch", ["rwkv6-7b", "recurrentgemma-2b"])
def test_serve_launcher_serves_the_recurrent_families_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve

    record = serve.main(["--arch", arch, "--batch", "2", "--prompt-len", "4",
                         "--max-new", "5", "--max-seq", "32", "--device", "cpu"])
    assert json.loads(capsys.readouterr().out) == record
    assert record["arch"] == f"{arch}-smoke" and record["steps"] == 9
    assert len(record["sample_continuation"]) == 5
