"""Prefill and decode on a model group's tensor-parallel layers (the
serving paths of ``models.transformer``, ``models.encdec``,
``models.attention``'s ``attn_decode`` / ``cross_attn_decode`` and the
vocab-parallel ``layers.unembed_logits``), through
``launch.mesh.run_group`` and ``repro_torch.benchmarks.tensor_parallel``'s
``serve_case``:

* gloo groups of 2 and 4 model ranks, started together, on the smoke
  configs of every family -- dense (smollm-360m: 3 q heads / 1 kv head,
  cut at both sizes; qwen2.5-32b: 4 / 2, cut at S = 4), MoE
  (llama4-scout-17b-a16e: the
  expert-parallel FFN at a decode step's token count), VLM (internvl2-26b
  with its prefix embeddings), rwkv6-7b (the WKV-6 state of the rank's
  heads), recurrentgemma-2b (the RG-LRU state of the rank's channels, a
  local-attention cache) and whisper-medium (self and cross caches of the
  rank's heads) -- at fp32 with fp32 caches, from the reference's init
  (``repro_torch.convert``): the prefill logits and 4 decode steps from an
  empty cache equal the whole model's within 1e-5 of their scale, the
  logits come back whole (B, padded_vocab) on every rank;
* the whole model and the group's logits equal the reference's
  ``prefill`` / ``decode_step`` (``encdec_*`` for whisper) within
  ``tests/test_torch_model_zoo.py``'s fp32 tolerance, 1e-4;
* the model group issues exactly ``expected_collectives`` of a prefill
  and of a decode step (``launch.op_analysis``), the hand counts of a
  few; each rank's parameter and decode-state bytes are its shards' and
  its states' (``init_decode_state(tp=)`` on every rank);
* ``attn_decode`` alone on the arch's head layout and on two pad heads
  more (at S = 4 one rank holds pad heads only: no cache, no launch, the
  group's collectives all the same) against the whole layer.
"""

import concurrent.futures
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import tensor_parallel as tpc  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.packing import tree_bytes  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import encdec as encdec_mod  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.sharding import shard_params  # noqa: E402
from repro_torch.models.tensor_parallel import TPGroup  # noqa: E402

ARCHS = ["smollm-360m", "qwen2.5-32b", "llama4-scout-17b-a16e", "internvl2-26b", "rwkv6-7b",
         "recurrentgemma-2b", "whisper-medium"]
SHARDS = [2, 4]
B, P, STEPS = 2, 8, 4
TP_TOL = 1e-5  # the group against the whole model, fp32
REF_TOL = 1e-4  # tests/test_torch_model_zoo.py's fp32 tolerance
DECODE_LAYER_ARCHS = ["smollm-360m", "qwen2.5-32b", "recurrentgemma-2b"]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _tc(arch):
    return dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")


def _reference(arch):
    """The reference's smoke config at fp32 compute and its init (numpy)."""
    jax = pytest.importorskip("jax")
    from repro.configs import get_config as j_get_config
    from repro.models import build_model as j_build_model

    jc = dataclasses.replace(j_get_config(arch, smoke=True), compute_dtype="float32")
    return jc, jax.tree_util.tree_map(np.asarray, j_build_model(jc).init_fn(
        jax.random.key(0)))


def _batch(cfg, seed):
    """Prompt tokens (B, P) and a VLM's prefix embeddings or whisper's
    frames."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, P)).astype(np.int32)}
    if cfg.family == "vlm":
        out["prefix_embeds"] = rng.normal(size=(B, cfg.frontend_seq, cfg.d_model)).astype(
            np.float32)
    if cfg.family == "audio":
        e = cfg.encoder
        out["frames"] = rng.normal(size=(B, e.seq_len, e.d_model)).astype(np.float32)
    return out


def _reference_logits(jc, params, batch):
    """The reference's prefill logits and STEPS decode steps' (fp32 caches)
    replaying the prompt's first tokens."""
    import jax
    import jax.numpy as jnp
    from repro.models import encdec as je
    from repro.models import transformer as jt

    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    toks = batch["tokens"]
    if jc.family == "audio":
        logits, enc = jax.jit(lambda p, b: je.encdec_prefill(p, jc, b))(jp, jb)
        state = je.encdec_fill_cross_kv(jp, jc, enc, je.encdec_init_decode_state(
            jc, B, STEPS, cache_dtype=jnp.float32))
        step = jax.jit(lambda p, t, s: je.encdec_decode_step(p, jc, t, s))
    else:
        logits, _ = jax.jit(lambda p, b: jt.prefill(p, jc, b))(jp, jb)
        state = jt.init_decode_state(jc, B, STEPS, cache_dtype=jnp.float32)
        step = jax.jit(lambda p, t, s: jt.decode_step(p, jc, t, s))
    out = [np.asarray(logits)]
    for t in range(STEPS):
        got, state = step(jp, jnp.asarray(toks[:, t]), state)
        out.append(np.asarray(got))
    return out


@pytest.fixture(scope="module")
def runs():
    """The groups of 2 and 4 (started together in threads), and the
    reference's logits computed here meanwhile."""
    inits = {arch: _reference(arch) for arch in ARCHS}
    batches = {arch: _batch(inits[arch][0], seed=3) for arch in ARCHS}

    def serve(arch):
        b = batches[arch]
        extra = b.get("prefix_embeds", b.get("frames"))
        return ("serve", dict(arch=arch, params_np=inits[arch][1], tokens=b["tokens"],
                              extra=extra, batch=B, prompt=P, steps=STEPS,
                              return_logits=True))

    todo = [serve(a) for a in ARCHS] + [("decode_layer", dict(arch=a))
                                        for a in DECODE_LAYER_ARCHS]
    with concurrent.futures.ThreadPoolExecutor(len(SHARDS)) as pool:
        futures = {s: pool.submit(mesh.run_group, tpc.cases, s, device="cpu", model_shards=s,
                                  args=(todo,)) for s in SHARDS}
        reference = {arch: _reference_logits(inits[arch][0], inits[arch][1], batches[arch])
                     for arch in ARCHS}
        got = {s: f.result() for s, f in futures.items()}
    names = [f"serve/{a}" for a in ARCHS] + [f"decode_layer/{a}" for a in DECODE_LAYER_ARCHS]
    return {s: dict(zip(names, got[s])) for s in SHARDS}, reference


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_equal_the_whole_model(runs, arch, shards):
    """The prefill logits and each decode step's, on the rank's shards and
    states, within 1e-5 of the whole model's scale; no argmax differs; the
    logits are the whole vocabulary."""
    res = runs[0][shards][f"serve/{arch}"]
    assert res["logits_shape"] == [B, _tc(arch).padded_vocab]
    assert res["prefill_err"] <= TP_TOL, res["prefill_err"]
    assert len(res["decode_errs"]) == STEPS and max(res["decode_errs"]) <= TP_TOL
    assert res["flips"] == []


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_group_and_the_whole_model_equal_the_reference(runs, arch, shards):
    """Across packages on the same numpy init and inputs: the whole model's
    logits (prefill, each decode step) and the group's within 1e-4 of
    their scale."""
    res, want = runs[0][shards][f"serve/{arch}"], runs[1][arch]
    for name in ("whole_logits", "logits"):
        for i, (got, ref) in enumerate(zip(res[name], want, strict=True)):
            scale = max(1.0, float(np.abs(ref).max()))
            err = float(np.abs(got - ref).max()) / scale
            assert err <= REF_TOL, (name, i, err)


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_the_model_groups_collectives(runs, arch, shards):
    """The model group's collectives, counted by ``op_analysis``: exactly
    ``expected_collectives`` of a prefill and of a decode step (the
    first); on the CPU the kernels' twins run, so no rank counts a
    launch."""
    res = runs[0][shards][f"serve/{arch}"]
    for kind in ("prefill", "decode"):
        want = {k: v for k, v in res["expected"][kind].items() if v}
        assert res["counts"][kind] == want, kind
        assert all(v == [0] * shards for v in res["launches"][kind].values())
    cfg = _tc(arch)
    for kind in ("prefill", "decode"):
        assert res["expected"][kind] == tpc.expected_collectives(cfg, shards, kind=kind)
    assert res["expected_launches"]["decode"] == {
        k: STEPS * v for k, v in tpc.expected_launches(cfg, "decode").items()}


def test_hand_counts_of_a_step():
    """``expected_collectives`` of the serving kinds by hand: SmolLM-360M at
    16 ranks (15 q heads cut: a gather a layer) and TinyLlama (a quarter kv
    head a rank: a gather a layer), RWKV6 (2 all-reduces a layer, no
    gather), RecurrentGemma (the gather of u a recurrent block, the cut
    heads' a local-attention one), whisper (prefill: the encoder's 2 a
    layer and the decoder's 3; 16 heads over 16 ranks cut none)."""
    def counts(arch, kind):
        return tpc.expected_collectives(get_config(arch), 16, kind=kind)

    for kind in ("prefill", "decode"):
        assert counts("smollm-360m", kind) == {"all-reduce": 65, "all-gather": 33}
        assert counts("tinyllama-1.1b", kind) == {"all-reduce": 45, "all-gather": 23}
        assert counts("rwkv6-7b", kind) == {"all-reduce": 65, "all-gather": 1}
        assert counts("recurrentgemma-2b", kind) == {"all-reduce": 53, "all-gather": 27}
    assert counts("whisper-medium", "prefill") == {"all-reduce": 1 + 48 + 72, "all-gather": 1}
    assert counts("whisper-medium", "decode") == {"all-reduce": 73, "all-gather": 1}
    assert tpc.expected_launches(get_config("whisper-medium"), "prefill")[
        "flash_attention"] == 24 + 48
    assert tpc.expected_launches(get_config("recurrentgemma-2b"), "decode") == {
        "flash_attention": 0, "decode_attention": 8, "wkv6": 0, "rglru_scan": 18}


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_each_rank_holds_its_shards_and_states(runs, arch, shards):
    """Each rank's parameter bytes are its ``shard_params`` shard's, and its
    decode state's bytes ``init_decode_state(tp=)``'s for its rank: the kv
    heads its q heads read, its WKV-6 heads, its RG-LRU channels, its
    cross K/V -- the whole model's states split, not replicated."""
    res = runs[0][shards][f"serve/{arch}"]
    cfg = _tc(arch)
    whole = build_model(cfg).param_shapes()

    def state(tp):
        if cfg.family == "audio":
            return encdec_mod.encdec_init_decode_state(cfg, B, STEPS, torch.float32,
                                                       device="meta", tp=tp)
        return tfm.init_decode_state(cfg, B, STEPS, cache_dtype=torch.float32, device="meta",
                                     tp=tp)

    for rank in range(shards):
        tp = TPGroup(None, rank, shards)
        assert res["param_bytes"][rank] == tree_bytes(shard_params(whole, rank, shards))
        assert res["state_bytes"][rank] == tree_bytes(state(tp))
    # split, not replicated: the group's states sum to no more than S whole
    # ones (equal only where every rank reads the same one kv head)
    whole_state = tree_bytes(state(None))
    assert sum(res["state_bytes"]) <= shards * whole_state
    if cfg.n_kv_heads != 1:
        assert sum(res["state_bytes"]) < shards * whole_state


@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("arch", DECODE_LAYER_ARCHS)
def test_attn_decode_on_the_ranks_heads(runs, arch, shards):
    """``attn_decode`` alone, 3 steps: the rank's heads within 1e-5 of the
    whole layer, on the arch's layout and on two pad heads more; a step's
    collectives ``wo``'s all-reduce and, where the group gathers cut
    heads, one all-gather -- issued by a rank of pad heads only too (at S
    = 4, the last rank: no kv head cached)."""
    res = runs[0][shards][f"decode_layer/{arch}"]
    cfg = _tc(arch)
    for name, hl in (("attention", cfg.n_heads), ("attention_padded", cfg.n_heads + 2)):
        r = res[name]
        assert r["err"] <= TP_TOL, (name, r["err"])
        cut = tpc._cut_heads(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, hl, shards)
        assert r["counts"] == {k: v for k, v in (("all-reduce", 3), ("all-gather", 3 * cut))
                               if v}, name
    if shards == 4:
        assert res["attention_padded"]["kv_heads"][-1] == 0
