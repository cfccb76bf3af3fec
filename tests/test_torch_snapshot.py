"""The PyTorch port's consensus snapshots (``repro_torch.training.snapshot``)
and serving from them (``ServeEngine.from_snapshot``,
``publish_snapshot``) against the JAX package's
(``repro.training.snapshot``).

* Write and load: the header's keys and the blob's bytes, ``LATEST``, the
  crc check, the leaf views; a load makes no copy (every leaf shares the
  map's storage) and nothing written through a view reaches the file.
* The per-node private block under a partial scope: ``node=i`` overlays
  hospital i's private columns bitwise, refused on an unscoped snapshot
  and out of range; a bf16-storage snapshot written at half the bytes and
  read back in bf16 (``tests/test_torch_bf16_storage.py`` holds it to the
  reference's).
* Cross-package reads both ways, bitwise: the port reads the reference's
  snapshots (consensus, private block, leaf views) and the reference the
  port's; on the same consensus row both write the same bytes.
* Serving on the CPU: a smoke SmolLM-360M's snapshot served by
  ``from_snapshot`` (staged and unstaged) gives the in-memory engine's
  greedy tokens; ``publish_snapshot`` swaps one in mid-generation with
  its keepalive; ``stage=False`` onto another device refused; the blob's
  bytes unchanged after serving. On the card (``cuda`` marker):
  ``stage=True`` places every leaf there, ``stage=False`` is refused.
"""

import dataclasses
import json
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import model_params_from_numpy  # noqa: E402
from repro_torch.core.engine import FusedEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round, tree_map  # noqa: E402
from repro_torch.core.packing import pack, tree_leaves  # noqa: E402
from repro_torch.core.schedules import constant  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.training.snapshot import (  # noqa: E402
    BLOB_ALIGN,
    latest_round,
    load_snapshot,
    snapshot_paths,
    write_snapshot,
)

N, CHUNK, Q = 4, 16, 2
SCOPE = "backbone:private=head"


@pytest.fixture(scope="module")
def ref():
    """The reference's modules, for the cross-package tests (imported
    here: the card's machine, which runs the ``cuda`` case, has no JAX)."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import engine
    from repro.core.packing import pack
    from repro.models import build_model
    from repro.serving.engine import ServeEngine as JServeEngine
    from repro.training import snapshot

    return types.SimpleNamespace(jax=jax, jnp=jnp, get_config=get_config, engine=engine,
                                 pack=pack, build_model=build_model, snap=snapshot,
                                 ServeEngine=JServeEngine)


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _arrays():
    rng = np.random.default_rng(0)
    return {"head": rng.normal(size=(N, 3)).astype(np.float32),
            "trunk": rng.normal(size=(N, 6, 5)).astype(np.float32)}


def _zero_loss(p, batch):
    return 0.0 * (p["head"].sum(dim=1) + p["trunk"].sum(dim=(1, 2)))


def _trained(scope=SCOPE, rounds=2):
    """A scoped fused run with a zero-gradient loss: the private heads
    stay the distinct per-node inits, the trunk mixes."""
    engine, flat0 = FusedEngine.simulated(mixing_matrix("ring", N),
                                          {k: torch.tensor(v) for k, v in _arrays().items()},
                                          scale_chunk=CHUNK, scope=scope)
    cfg = FLConfig(algorithm="dsgt", q=Q, n_nodes=N)
    rf = make_fl_round(_zero_loss, constant(0.05), cfg, engine)
    state = init_fl_state(cfg, flat0, engine)
    for _ in range(rounds):
        state, _ = rf(state, {"t": np.zeros((Q, N, 6, 5), np.float32)})
    return engine, flat0.clone(), state


def _j_engine(ref, scope=SCOPE):
    return ref.engine.FusedEngine.simulated(
        mixing_matrix("ring", N), {k: ref.jnp.asarray(v) for k, v in _arrays().items()},
        scale_chunk=CHUNK, impl="jnp", scope=scope)


def _blob(d, rnd):
    with open(snapshot_paths(d, rnd)[0], "rb") as f:
        return f.read()


def test_write_load_latest_and_zero_copy(tmp_path):
    engine, flat0, state = _trained()
    d = str(tmp_path)
    assert latest_round(d) is None
    with pytest.raises(FileNotFoundError):
        load_snapshot(d)
    write_snapshot(d, state.params, engine.layout, round_frontier=2, engine=engine, step=7,
                   extra={"run": "x"})
    write_snapshot(d, state.params, engine.layout, round_frontier=5, engine=engine)
    assert latest_round(d) == 5
    snap = load_snapshot(d, round_frontier=2, verify=True)
    assert snap.round_frontier == 2 and snap.step == 7 and snap.header["extra"] == {"run": "x"}
    assert snap.header["round_spec"]["scope"] == SCOPE
    assert snap.header["blob_bytes"] % BLOB_ALIGN == 0
    assert torch.equal(snap.flat, state.params.mean(dim=0))
    assert torch.equal(snap.params["trunk"], snap.flat[3:33].reshape(6, 5))
    # no copy: every leaf is a view of the one map
    mm = snap.flat.numpy()
    base = mm.ctypes.data
    for _, leaf in tree_leaves(snap.params):
        assert base <= leaf.data_ptr() < base + mm.nbytes
        assert np.shares_memory(leaf.numpy(), mm)
    # copy-on-write: a write through a view never reaches the file
    before = _blob(d, 2)
    snap.params["head"] += 1.0
    assert _blob(d, 2) == before
    assert torch.equal(load_snapshot(d, 2).flat, state.params.mean(dim=0))
    # the template gives the container and checks the shapes
    tmpl = {"head": torch.zeros(3), "trunk": torch.zeros(6, 5)}
    assert set(load_snapshot(d, template=tmpl).params) == {"head", "trunk"}
    with pytest.raises(ValueError, match="template"):
        load_snapshot(d, template={"head": torch.zeros(4), "trunk": torch.zeros(6, 5)})
    with pytest.raises(KeyError):
        load_snapshot(d, template={"nothead": torch.zeros(3)})


def test_private_heads_overlay(tmp_path):
    engine, flat0, state = _trained()
    d = str(tmp_path / "scoped")
    write_snapshot(d, state.params, engine.layout, round_frontier=2, engine=engine)
    snap = load_snapshot(d)
    assert snap.header["scope"]["spec"] == SCOPE
    assert snap.header["scope"]["private_ranges"] == [[0, 3], [33, 48]]
    cons = snap.flat
    for i in range(N):
        pers = load_snapshot(d, node=i).flat
        for a, b in ((0, 3), (33, 48)):
            assert torch.equal(pers[a:b], state.params[i, a:b])
            assert torch.equal(pers[a:b], flat0[i, a:b])
        assert torch.equal(pers[3:33], cons[3:33])
    with pytest.raises(ValueError, match="out of range"):
        load_snapshot(d, node=N)
    full_engine, _, full_state = _trained(scope=None, rounds=1)
    d2 = str(tmp_path / "full")
    write_snapshot(d2, full_state.params, full_engine.layout, round_frontier=1,
                   engine=full_engine)
    with pytest.raises(ValueError, match="no per-node private"):
        load_snapshot(d2, node=0)


def test_bf16_storage_is_refused(tmp_path):
    """bf16 storage is no longer refused: the buffer's bf16 words are the
    blob (half the fp32 bytes), the header names it, and the leaves come
    back in their own dtype from the bf16 consensus."""
    engine, _, state = _trained(scope=None, rounds=1)
    d32, d16 = str(tmp_path / "fp32"), str(tmp_path / "bf16")
    write_snapshot(d32, state.params, engine.layout, round_frontier=1)
    flat16 = state.params.to(torch.bfloat16)
    layout16 = dataclasses.replace(engine.layout, storage_dtype="bfloat16")
    header = write_snapshot(d16, flat16, layout16, round_frontier=1)
    with open(header) as f:
        h = json.load(f)
    assert h["storage_dtype"] == "bfloat16"
    assert h["payload_bytes"] * 2 == load_snapshot(d32).header["payload_bytes"]
    snap = load_snapshot(d16, verify=True)
    want = flat16.float().mean(dim=0).to(torch.bfloat16)
    assert snap.flat.dtype == torch.bfloat16 and torch.equal(snap.flat, want)
    for path, leaf in tree_leaves(snap.params):
        assert leaf.dtype == torch.float32, path


def test_the_reference_reads_the_ports_snapshots(tmp_path, ref):
    engine, _, state = _trained()
    d = str(tmp_path)
    write_snapshot(d, state.params, engine.layout, round_frontier=3, engine=engine)
    theirs = ref.snap.load_snapshot(d, verify=True)
    assert np.array_equal(np.asarray(theirs.flat), _np(state.params.mean(dim=0)))
    for i in range(N):
        assert np.array_equal(np.asarray(ref.snap.load_snapshot(d, node=i).flat),
                              _np(load_snapshot(d, node=i).flat))
    assert np.array_equal(np.asarray(theirs.params["trunk"]), _np(state.params[:, 3:33]
                                                                  .mean(dim=0)).reshape(6, 5))


def test_the_port_reads_the_references_snapshots(tmp_path, ref):
    j_eng, j_flat = _j_engine(ref)
    stacked = np.asarray(j_flat) + np.arange(N, dtype=np.float32)[:, None]
    d = str(tmp_path)
    ref.snap.write_snapshot(d, ref.jnp.asarray(stacked), j_eng.layout, round_frontier=4,
                            engine=j_eng, step=11)
    mine = load_snapshot(d, verify=True)
    theirs = ref.snap.load_snapshot(d)
    assert mine.header == theirs.header and mine.step == 11
    assert np.array_equal(_np(mine.flat), np.asarray(theirs.flat))
    for k in ("head", "trunk"):
        assert np.array_equal(_np(mine.params[k]), np.asarray(theirs.params[k]))
    for i in range(N):
        assert np.array_equal(_np(load_snapshot(d, node=i).flat),
                              np.asarray(ref.snap.load_snapshot(d, node=i).flat))


def test_both_packages_write_the_same_bytes(tmp_path, ref):
    """From the same consensus row both write the same blob; from the same
    node-stacked buffer the same header and private block (the node-axis
    means within one ulp of each other)."""
    engine, _, state = _trained()
    j_eng, _ = _j_engine(ref)
    row = _np(state.params.mean(dim=0))
    write_snapshot(str(tmp_path / "a"), torch.tensor(row), engine.layout, round_frontier=1)
    ref.snap.write_snapshot(str(tmp_path / "b"), ref.jnp.asarray(row), j_eng.layout,
                            round_frontier=1)
    assert _blob(str(tmp_path / "a"), 1) == _blob(str(tmp_path / "b"), 1)
    stacked = _np(state.params)
    write_snapshot(str(tmp_path / "c"), torch.tensor(stacked), engine.layout,
                   round_frontier=1, engine=engine)
    ref.snap.write_snapshot(str(tmp_path / "e"), ref.jnp.asarray(stacked), j_eng.layout,
                            round_frontier=1, engine=j_eng)
    mine, theirs = load_snapshot(str(tmp_path / "c")), ref.snap.load_snapshot(str(tmp_path / "e"))
    for h in (mine.header, theirs.header):
        h.pop("crc32")
    assert mine.header == theirs.header
    off = mine.header["scope"]["private_offset_bytes"]
    assert _blob(str(tmp_path / "c"), 1)[off:] == _blob(str(tmp_path / "e"), 1)[off:]
    np.testing.assert_array_max_ulp(_np(mine.flat), np.asarray(theirs.flat), maxulp=1)


# ------------------------------------------------------------ serving


def _model(seed=0):
    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True), compute_dtype="float32")
    bundle = build_model(cfg)
    return cfg, bundle, bundle.init_fn(torch.Generator().manual_seed(seed), device="cpu")


def _model_snapshot(d, params, rnd):
    """One model's weights as a one-row consensus snapshot."""
    flat, layout = pack(tree_map(lambda p: p[None], params))
    return write_snapshot(d, flat, layout, round_frontier=rnd)


def test_serving_from_a_snapshot(tmp_path):
    cfg, bundle, params = _model(0)
    _, _, params_b = _model(1)
    d = str(tmp_path)
    _model_snapshot(d, params, 1)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = ServeEngine(bundle, params, max_seq=32, batch=2).generate(prompts, 8).tokens
    before = _blob(d, 1)
    for stage in (True, False):
        snap = load_snapshot(d, template=params)
        eng = ServeEngine.from_snapshot(bundle, snap, max_seq=32, batch=2, stage=stage,
                                        device="cpu")
        assert eng.snapshot_round == 1 and eng._active_ref is snap
        if not stage:  # the engine serves the mapped views themselves
            leaf = tree_leaves(eng.params)[0][1]
            assert np.shares_memory(leaf.numpy(), snap.flat.numpy())
        assert np.array_equal(eng.generate(prompts, 8).tokens, want)
    assert _blob(d, 1) == before
    # a hot swap of the next snapshot mid-generation, its keepalive active
    _model_snapshot(d, params_b, 2)
    want_b = ServeEngine(bundle, params_b, max_seq=32, batch=2).generate(prompts, 8).tokens
    eng = ServeEngine.from_snapshot(bundle, load_snapshot(d, 1, template=params), max_seq=32,
                                    batch=2, device="cpu")
    step = eng.decode_step
    calls = {"n": 0}
    snap2 = load_snapshot(d, template=params)

    def publishing_step(tokens, caches):
        out = step(tokens, caches)
        calls["n"] += 1
        if calls["n"] == 3:
            eng.publish_snapshot(snap2)
        return out

    eng.decode_step = publishing_step
    out = eng.generate(prompts, 8)
    assert out.swap_steps == (3,) and eng.swap_count == 1 and len(eng.swap_pauses) == 1
    assert eng.snapshot_round == 2 and eng._active_ref is snap2 and eng.staleness(5) == 3
    assert not np.array_equal(out.tokens, want) or not np.array_equal(out.tokens, want_b)


def test_stage_false_onto_another_device_is_refused():
    """torch moves no host tensor implicitly: an engine on another device
    refuses unstaged host leaves (the meta device stands in for the card
    here; the ``cuda`` case below is the card's)."""
    cfg, bundle, params = _model(0)
    meta = tree_map(lambda p: p.to("meta"), params)
    eng = ServeEngine(bundle, meta, max_seq=32, batch=2)
    with pytest.raises(ValueError, match="stage=True"):
        eng.publish(params, 1, stage=False)
    eng.publish(params, 1, stage=True)  # staging copies them over
    assert all(leaf.device.type == "meta" for _, leaf in tree_leaves(eng._pending[0]))


def test_the_references_model_snapshot_serves_its_tokens(tmp_path, ref):
    """The reference writes a smoke SmolLM-360M's weights; the port serves
    that snapshot and gives the reference engine's greedy tokens."""
    jax = ref.jax
    jc = dataclasses.replace(ref.get_config("smollm-360m", smoke=True), compute_dtype="float32")
    jb = ref.build_model(jc)
    jp = jb.init_fn(jax.random.key(0))
    flat, layout = ref.pack(jax.tree_util.tree_map(lambda p: p[None], jp))
    ref.snap.write_snapshot(str(tmp_path), flat, layout, round_frontier=9)
    cfg, bundle, _ = _model(0)
    tmpl = model_params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), cfg, "cpu")
    snap = load_snapshot(str(tmp_path), template=tmpl)
    for (_, a), (_, b) in zip(tree_leaves(snap.params), tree_leaves(tmpl)):
        assert torch.equal(a, b)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 5)).astype(np.int32)
    want = ref.ServeEngine(jb, jp, max_seq=32, batch=2).generate(prompts, 6).tokens
    eng = ServeEngine.from_snapshot(bundle, snap, max_seq=32, batch=2, stage=False,
                                    device="cpu")
    assert np.array_equal(eng.generate(prompts, 6).tokens, np.asarray(want))


# ------------------------------------------------------------ on the card


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_from_snapshot_stages_every_leaf_on_the_card(tmp_path, cuda):
    cfg, bundle, params = _model(0)
    _model_snapshot(str(tmp_path), params, 1)
    snap = load_snapshot(str(tmp_path), template=params)
    eng = ServeEngine.from_snapshot(bundle, snap, max_seq=32, batch=2, stage=True)
    assert all(leaf.device.type == "cuda" for _, leaf in tree_leaves(eng.params))
    for (_, a), (_, b) in zip(tree_leaves(eng.params), tree_leaves(params)):
        assert torch.equal(a.cpu(), b)
    with pytest.raises(ValueError, match="stage=True"):
        ServeEngine.from_snapshot(bundle, snap, max_seq=32, batch=2, stage=False)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    assert eng.generate(prompts, 4).tokens.shape == (2, 10)
