"""bf16 flat storage (ROADMAP.md item 5) on the PyTorch port against the
JAX package's, on the CPU.

* Packing: ``pack`` / ``pack_like`` / ``unpack`` in bf16 and fp32, the
  layout's fields and the buffers equal the reference's.
* Rounds: the paper's problem (the EHR cohort, the 42 -> 32 -> 2 MLP in a
  (20, 1536) buffer at chunk 512, hospital20, alpha = 0.02/sqrt(r), Q =
  10) on ``flat`` and ``fused`` (DSGD and DSGT; sequential,
  ``bounded_staleness:k=2``, pipelined and top-64), bf16 against the
  reference's bf16 engines (``FusedEngine(impl="jnp")``, jitted, as its
  own bf16 tests build them), from the reference's init and one numpy
  batcher. After one round every element agrees within one bf16 ulp at
  the scale of its operands, the largest magnitude in its column
  (``kernel_bench.bf16_ulp_err``). One ulp of each element's own
  magnitude fails on this seed at small results of a mix that nearly
  cancels, each off by 2^-17, one ulp of its column's operands (in
  [2^-10, 2^-9)): on ``flat`` (DSGD and DSGT alike) params (node 3,
  column 1171), -4.506e-05 in the port against -5.269e-05 (fp32
  -5.172e-05), 32 ulps of its own magnitude, and (7, 1171), (9, 1171),
  2 ulps; on ``fused`` params (8, 1171), 2 ulps, and the DSGT tracker's
  (6, 628), 4.807e-04 against 4.730e-04, 4 ulps. After three rounds
  within the
  reference's own 5e-2 (``tests/test_schedule.py``), and within 5e-2 of
  the port's fp32 run -- on the top-64 wire, whose selection a bf16
  rounding flips (moving an element by up to 0.18 in both packages), the
  port's bf16-minus-fp32 gap within 5e-2 of the reference's. The buffers
  stay bf16 and the wire state fp32.
* ``sharded_fused`` on gloo worlds 2 and 4 (subprocesses) against the
  port's bf16 ``fused``: one ulp after one round as above, the loss within
  rtol 1e-3 over five rounds.
* Refusals: ``tree`` raises the reference's ``ValueError``; ``fused`` and
  ``sharded_fused`` refuse float16, naming the allowed pair; a kernel
  wrapper handed a bf16 buffer raises.
* Checkpoints: a bf16 state restores bitwise (its npz entries are raw
  2-byte words, named in the manifest), and a reference bf16 checkpoint
  restores into a bf16 template bitwise.
* Snapshots: a bf16 blob within one bf16 ulp of the reference's blob of
  the same state (at its node columns' scale), at half the fp32 bytes;
  a smoke SmolLM-360M served from one gives the greedy tokens of serving its weights rounded to bf16.
* The trainer and ``launch/train.py --storage-dtype bfloat16`` on the CPU.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ehr_mlp import class_weights as j_class_weights  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core import packing as j_packing  # noqa: E402
from repro.core.schedules import inv_sqrt as j_inv_sqrt  # noqa: E402
from repro.models.mlp import make_mlp_loss as j_make_mlp_loss  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro.training import checkpoint as j_checkpoint  # noqa: E402
from repro.training import snapshot as j_snapshot  # noqa: E402
from repro.training.trainer import stack_for_nodes as j_stack_for_nodes  # noqa: E402
from repro_torch.benchmarks.kernel_bench import bf16_ulp_err  # noqa: E402
from repro_torch.configs import FLRunConfig, get_config  # noqa: E402
from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FusedEngine,
    ShardedFusedEngine,
    TreeEngine,
    get_engine,
)
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round, tree_map  # noqa: E402
from repro_torch.core.packing import pack, pack_like, tree_leaves, unpack  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.kernels.gossip.ops import fused_round  # noqa: E402
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss, mlp_init  # noqa: E402
from repro_torch.serving import ServeEngine  # noqa: E402
from repro_torch.training.checkpoint import load_fl_state, save_fl_state  # noqa: E402
from repro_torch.training.snapshot import load_snapshot, snapshot_paths, write_snapshot  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    stack_batches,
    stack_for_nodes,
    train_decentralized,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CHUNK, Q = 20, 512, 10
BF16 = torch.bfloat16
#: the reference's bf16-vs-fp32 tolerance over a few rounds
MULTI_ROUND_TOL = 5e-2


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _assert_one_ulp(got, want, what: str, operands=None) -> None:
    """Every element within one bf16 ulp at its operands' scale
    (``bf16_ulp_err``), from either package's tensors."""
    bf16_ulp_err(what, torch.tensor(_np(got)), torch.tensor(_np(want)),
                 None if operands is None else torch.tensor(_np(operands)))


class _Pair:
    """One run in both packages on bf16 storage (and the port's fp32 twin):
    engines, round functions, states, one batcher."""

    def __init__(self, engine: str, algorithm: str, schedule=None, topk=None):
        w = mixing_matrix("hospital20", N)
        init = j_mlp_init(jax.random.key(0))
        jkw = dict(scale_chunk=CHUNK, storage_dtype=jnp.bfloat16)
        kw = dict(scale_chunk=CHUNK)
        if engine == "fused":
            jkw.update(impl="jnp", round_schedule=schedule, topk=topk)
            kw.update(round_schedule=schedule, topk=topk)
        j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
        self.j_engine, j_flat = j_engine.get_engine(engine).simulated(
            w, j_stack_for_nodes(init, N), **jkw)
        self.j_round = jax.jit(j_fl.make_fl_round(
            j_make_mlp_loss(j_class_weights()), None, j_inv_sqrt(0.02), j_cfg,
            engine=self.j_engine))
        self.j_state = j_fl.init_fl_state(j_cfg, j_flat, engine=self.j_engine)
        self.j_round32 = None
        if topk is not None:  # the reference's fp32 twin: the top-k gap
            jkw.pop("storage_dtype")
            j_e32, j_f32 = j_engine.get_engine(engine).simulated(
                w, j_stack_for_nodes(init, N), **jkw)
            self.j_round32 = jax.jit(j_fl.make_fl_round(
                j_make_mlp_loss(j_class_weights()), None, j_inv_sqrt(0.02), j_cfg,
                engine=j_e32))
            self.j_state32 = j_fl.init_fl_state(j_cfg, j_f32, engine=j_e32)

        single = params_from_numpy(jax.tree_util.tree_map(np.asarray, init), device="cpu")
        stacked = stack_for_nodes(single, N)
        self.cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
        loss = make_mlp_loss(class_weights())
        self.engine, flat = get_engine(engine).simulated(w, stacked, storage_dtype=BF16, **kw)
        assert flat.dtype == BF16 and np.array_equal(_np(flat), _np(j_flat))
        self.round = make_fl_round(loss, inv_sqrt(0.02), self.cfg, self.engine)
        self.state = init_fl_state(self.cfg, flat, self.engine)
        e32, f32 = get_engine(engine).simulated(w, stacked, **kw)
        self.round32 = make_fl_round(loss, inv_sqrt(0.02), self.cfg, e32)
        self.state32 = init_fl_state(self.cfg, f32, e32)
        self.batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)

    def step(self):
        batches = stack_batches(self.batcher, self.cfg.q)
        self.state, m = self.round(self.state, batches)
        self.state32, _ = self.round32(self.state32, batches)
        self.j_state, jm = self.j_round(self.j_state, batches)
        if self.j_round32 is not None:
            self.j_state32, _ = self.j_round32(self.j_state32, batches)
        return m, jm


RUNS = [("flat", "dsgd", None, None), ("flat", "dsgt", None, None),
        ("fused", "dsgd", None, None), ("fused", "dsgt", None, None),
        ("fused", "dsgd", "bounded_staleness:k=2", None),
        ("fused", "dsgt", "bounded_staleness:k=2", None),
        ("fused", "dsgd", "pipelined", None), ("fused", "dsgt", None, 64)]


@pytest.mark.parametrize("engine, algorithm, schedule, topk", RUNS)
def test_rounds_match_reference_bf16(engine, algorithm, schedule, topk):
    pair = _Pair(engine, algorithm, schedule, topk)
    m, jm = pair.step()
    st, jst = pair.state, pair.j_state
    what = f"{engine} {algorithm} {schedule} top-{topk}"
    _assert_one_ulp(st.params, jst.params, what + " params, round 1")
    if algorithm == "dsgt":
        _assert_one_ulp(st.tracker, jst.tracker, what + " tracker, round 1")
        _assert_one_ulp(st.prev_grad, jst.prev_grad, what + " prev_grad, round 1")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    for _ in range(2):
        m, jm = pair.step()
    st, jst = pair.state, pair.j_state
    np.testing.assert_allclose(_np(st.params), _np(jst.params), atol=MULTI_ROUND_TOL,
                               rtol=MULTI_ROUND_TOL, err_msg=f"{what} params")
    if topk is None:
        np.testing.assert_allclose(_np(st.params), _np(pair.state32.params),
                                   atol=MULTI_ROUND_TOL, rtol=MULTI_ROUND_TOL,
                                   err_msg=f"{what} params vs fp32")
    else:
        gap = _np(st.params) - _np(pair.state32.params)
        j_gap = _np(jst.params) - _np(pair.j_state32.params)
        assert np.abs(gap).max() > MULTI_ROUND_TOL  # the selection flips
        np.testing.assert_allclose(gap, j_gap, atol=MULTI_ROUND_TOL, rtol=0,
                                   err_msg=f"{what} bf16 - fp32 gap vs the reference's")
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
    assert st.params.dtype == BF16 and pair.state32.params.dtype == torch.float32
    if algorithm == "dsgt":
        assert st.tracker.dtype == st.prev_grad.dtype == BF16
    for key, buf in (st.comm or {}).items():
        if key.startswith(("recon", "residual")):
            assert buf.dtype == torch.float32, key


@pytest.mark.parametrize("storage", ["float32", "bfloat16"])
def test_pack_roundtrip_and_layout_match_reference(storage):
    rng = np.random.default_rng(3)
    arrays = {"w": rng.normal(size=(4, 3, 5)).astype(np.float32),
              "b": rng.normal(size=(4, 7)).astype(np.float32),
              "h": {"z": rng.normal(size=(4, 2)).astype(np.float32)}}
    tree = tree_map(torch.tensor, arrays)
    flat, layout = pack(tree, pad_to=8, buffer_dtype=getattr(torch, storage))
    j_flat, j_layout = j_packing.pack(jax.tree_util.tree_map(jnp.asarray, arrays), pad_to=8,
                                      buffer_dtype=jnp.dtype(storage))
    assert layout.storage_dtype == j_layout.storage_dtype == storage
    assert (layout.total, layout.used, layout.n_nodes) == (
        j_layout.total, j_layout.used, j_layout.n_nodes)
    assert [(s.offset, s.shape, s.dtype) for s in layout.leaves] == [
        (s.offset, s.shape, s.dtype) for s in j_layout.leaves]
    assert str(flat.dtype) == f"torch.{storage}"
    assert np.array_equal(_np(flat), _np(j_flat))
    back = unpack(flat, layout)
    j_back = j_packing.unpack(j_flat, j_layout)
    for (path, leaf), j_leaf in zip(tree_leaves(back), jax.tree_util.tree_leaves(j_back)):
        assert leaf.dtype == torch.float32, path
        assert np.array_equal(_np(leaf), _np(j_leaf)), path
    again = pack_like(back, layout)
    assert again.dtype == flat.dtype and torch.equal(again, flat)
    assert pack_like(back, layout, buffer_dtype=torch.float32).dtype == torch.float32
    np.testing.assert_array_equal(
        _np(pack_like(back, layout)),
        _np(j_packing.pack_like(j_back, j_layout)))


def test_refusals_and_wrapper_dtype():
    w = mixing_matrix("ring", 4)
    stacked = {"p": torch.zeros(4, 6)}
    with pytest.raises(ValueError, match="storage_dtype is a flat-buffer knob"):
        TreeEngine.simulated(w, stacked, storage_dtype="bfloat16")
    with pytest.raises(ValueError) as j_err:
        j_engine.get_engine("tree").simulated(w, {"p": jnp.zeros((4, 6))},
                                              storage_dtype=jnp.bfloat16)
    with pytest.raises(ValueError) as err:
        TreeEngine.simulated(w, stacked, storage_dtype=torch.bfloat16)
    assert str(err.value) == str(j_err.value)
    for dtype in ("float16", torch.float16):
        with pytest.raises(ValueError, match=r"in \('float32', 'bfloat16'\) only"):
            FusedEngine.simulated(w, stacked, scale_chunk=2, storage_dtype=dtype)
    assert TreeEngine.simulated(w, stacked, storage_dtype="float32")[0].storage_dtype == (
        torch.float32)
    x = torch.zeros(4, 8, dtype=BF16)
    z = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="bfloat16, expected float32"):
        fused_round(x, z, z, z, torch.zeros(4, 4), torch.ones(4), 0.1, scale_chunk=8)


_SHARDED_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core.engine import ShardedFusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.schedules import inv_sqrt
    from repro_torch.core.topology import mixing_matrix
    from repro_torch.launch.mesh import start_group, stop_group

    rank, world, store, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    g = start_group(rank, world, store, device="cpu")
    spec = np.load(os.path.join(os.path.dirname(out), "problem.npz"))
    params = {"w": torch.tensor(spec["w"]), "b": torch.tensor(spec["b"])}
    batches = {"t": torch.tensor(spec["t"])}

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    res = {}
    for alg, topk, sched in CASES:
        cfg = FLConfig(algorithm=alg, q=Q, n_nodes=N)
        eng, rows = ShardedFusedEngine.from_group(
            g, params, w=mixing_matrix("hospital20", N), scale_chunk=CHUNK, topk=topk,
            round_schedule=sched, storage_dtype=torch.bfloat16)
        assert rows.dtype == torch.bfloat16
        rf = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
        st = init_fl_state(cfg, rows, eng)
        key = f"{alg}-{topk}-{sched}"
        losses = []
        for r in range(ROUNDS):
            st, m = rf(st, batches)
            losses.append(float(m["loss"]))
            if r == 0:
                res[key + "/params1"] = eng.gather_rows(st.params).float().numpy()
        assert st.params.dtype == torch.bfloat16
        res[key + "/losses"] = np.asarray(losses)
    if rank == 0:
        np.savez(out, **res)
    stop_group(g)
    sys.stdout.flush()
    os._exit(0)
    """
)
SHARDED_N, SHARDED_Q, SHARDED_CHUNK, SHARDED_ROUNDS = 20, 2, 16, 5
SHARDED_CASES = [("dsgt", None, "sequential"), ("dsgd", None, "pipelined"),
                 ("dsgt", 4, "sequential"), ("dsgt", 2, "bounded_staleness:k=2")]


def _sharded_problem():
    rng = np.random.default_rng(7)
    n = SHARDED_N
    return {"w": rng.normal(size=(n, 4, 5)).astype(np.float32),
            "b": rng.normal(size=(n, 3)).astype(np.float32),
            "t": rng.normal(size=(SHARDED_Q, n, 4, 5)).astype(np.float32)}


@pytest.fixture(scope="module")
def sharded_worlds(tmp_path_factory):
    """Worlds 2 and 4 of gloo ranks, all started together: each rank's
    first-round params (gathered) and the five rounds' losses."""
    d = tmp_path_factory.mktemp("bf16_sharded")
    np.savez(d / "problem.npz", **_sharded_problem())
    header = (f"N, Q, CHUNK, ROUNDS = {SHARDED_N}, {SHARDED_Q}, {SHARDED_CHUNK}, "
              f"{SHARDED_ROUNDS}\nCASES = {SHARDED_CASES!r}\n")
    script = _SHARDED_WORKER.replace("res = {}", header + "res = {}")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for world in (2, 4):
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", script, str(rank), str(world),
                 str(d / f"store{world}"), str(d / f"world{world}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-4000:]
    return {world: np.load(d / f"world{world}.npz") for world in (2, 4)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("algorithm, topk, schedule", SHARDED_CASES)
def test_sharded_bf16_tracks_fused_bf16(sharded_worlds, world, algorithm, topk, schedule):
    spec = _sharded_problem()
    params = {"w": torch.tensor(spec["w"]), "b": torch.tensor(spec["b"])}
    batches = {"t": torch.tensor(spec["t"])}

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    cfg = FLConfig(algorithm=algorithm, q=SHARDED_Q, n_nodes=SHARDED_N)
    eng, flat = FusedEngine.simulated(mixing_matrix("hospital20", SHARDED_N), params,
                                      scale_chunk=SHARDED_CHUNK, topk=topk,
                                      round_schedule=schedule, storage_dtype=BF16)
    rf = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
    st = init_fl_state(cfg, flat, eng)
    losses = []
    got = sharded_worlds[world]
    key = f"{algorithm}-{topk}-{schedule}"
    for r in range(SHARDED_ROUNDS):
        st, m = rf(st, batches)
        losses.append(float(m["loss"]))
        if r == 0:
            _assert_one_ulp(got[key + "/params1"], st.params, f"world {world} {key}")
    assert st.params.dtype == BF16
    np.testing.assert_allclose(got[key + "/losses"], losses, rtol=1e-3)


@pytest.fixture()
def group(tmp_path):
    g = start_group(0, 1, str(tmp_path / "store"), device="cpu")
    yield g
    stop_group(g)


def test_sharded_bf16_checks_its_buffer(group):
    params = {"p": torch.zeros(SHARDED_N, 30)}
    eng, rows = ShardedFusedEngine.from_group(
        group, params, w=mixing_matrix("hospital20", SHARDED_N), scale_chunk=SHARDED_CHUNK,
        storage_dtype="bfloat16")
    assert rows.dtype == BF16 and eng.storage_dtype == BF16
    cfg = FLConfig(algorithm="dsgt", q=1, n_nodes=SHARDED_N)
    state = init_fl_state(cfg, rows, eng)
    assert state.tracker.dtype == state.prev_grad.dtype == BF16
    assert all(v.dtype == torch.float32 for k, v in state.comm.items())
    with pytest.raises(ValueError, match="stores torch.bfloat16"):
        init_fl_state(cfg, rows.float(), eng)
    with pytest.raises(ValueError, match=r"in \('float32', 'bfloat16'\) only"):
        ShardedFusedEngine.from_group(group, params, w=mixing_matrix("hospital20", SHARDED_N),
                                      scale_chunk=SHARDED_CHUNK, storage_dtype="float16")


# ------------------------------------------------------------ checkpoints


@pytest.mark.parametrize("schedule", ["sequential", "bounded_staleness:k=2"])
def test_checkpoint_bf16_roundtrip_is_bitwise(tmp_path, schedule):
    pair = _Pair("fused", "dsgt", schedule)
    pair.step()
    state = pair.state
    save_fl_state(str(tmp_path), state, engine=pair.engine)
    with open(tmp_path / "manifest.json") as f:
        manifest = json.load(f)
    assert manifest["dtypes"] == {k: "bfloat16" for k in
                                  ("params::", "prev_grad::", "tracker::")}
    data = np.load(tmp_path / "state.npz")
    assert data["params::"].dtype.str == "|V2"
    template = init_fl_state(pair.cfg, torch.zeros_like(state.params), pair.engine)
    back = load_fl_state(str(tmp_path), template, engine=pair.engine)
    assert back.step == state.step
    for name in ("params", "tracker", "prev_grad"):
        got, want = getattr(back, name), getattr(state, name)
        assert got.dtype == BF16 and torch.equal(got, want), name
    for key in state.comm:
        assert torch.equal(back.comm[key], state.comm[key]), key


def test_reference_bf16_checkpoint_restores_bitwise(tmp_path):
    pair = _Pair("fused", "dsgt")
    pair.step()
    j_checkpoint.save_fl_state(str(tmp_path), pair.j_state, engine=pair.j_engine)
    template = init_fl_state(pair.cfg, torch.zeros_like(pair.state.params), pair.engine)
    back = load_fl_state(str(tmp_path), template, engine=pair.engine)
    for name in ("params", "tracker", "prev_grad"):
        got, want = getattr(back, name), getattr(pair.j_state, name)
        assert got.dtype == BF16, name
        assert np.array_equal(_np(got), _np(want)), name
    for key in pair.state.comm:
        assert np.array_equal(_np(back.comm[key]), _np(pair.j_state.comm[key])), key


# ------------------------------------------------------------ snapshots


def test_snapshot_blob_matches_reference(tmp_path):
    pair = _Pair("fused", "dsgd")
    pair.step()
    mine = write_snapshot(str(tmp_path / "port"), pair.state.params, pair.engine.layout,
                          round_frontier=1)
    j_snapshot.write_snapshot(str(tmp_path / "ref"), pair.j_state.params,
                              pair.j_engine.layout, round_frontier=1)
    with open(mine) as f:
        header = json.load(f)
    assert header["storage_dtype"] == "bfloat16"
    assert header["payload_bytes"] == 2 * pair.engine.layout.total

    def words(d):
        with open(snapshot_paths(d, 1)[0], "rb") as f:
            raw = np.frombuffer(f.read(), dtype=np.int16).copy()
        return torch.from_numpy(raw).view(BF16)[:pair.engine.layout.total]

    _assert_one_ulp(words(str(tmp_path / "port")), words(str(tmp_path / "ref")), "blob",
                    operands=pair.state.params)
    snap = load_snapshot(str(tmp_path / "port"))
    assert snap.flat.dtype == BF16 and torch.equal(snap.flat, words(str(tmp_path / "port")))
    theirs = j_snapshot.load_snapshot(str(tmp_path / "port"), verify=True)
    assert np.array_equal(np.asarray(theirs.flat).astype(np.float32), _np(snap.flat))


def test_serving_from_a_bf16_snapshot(tmp_path):
    import dataclasses

    cfg = dataclasses.replace(get_config("smollm-360m", smoke=True), compute_dtype="float32")
    bundle = build_model(cfg)
    params = bundle.init_fn(torch.Generator().manual_seed(0), device="cpu")
    flat, layout = pack(tree_map(lambda p: torch.stack([p, p]), params),
                        buffer_dtype=BF16)
    write_snapshot(str(tmp_path), flat, layout, round_frontier=1)
    snap = load_snapshot(str(tmp_path), template=params)
    rounded = tree_map(lambda p: p.to(BF16).to(p.dtype), params)
    for (path, got), (_, want) in zip(tree_leaves(snap.params), tree_leaves(rounded)):
        assert got.dtype == want.dtype and torch.equal(got, want), path
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    want = ServeEngine(bundle, rounded, max_seq=32, batch=2).generate(prompts, 8).tokens
    eng = ServeEngine.from_snapshot(bundle, snap, max_seq=32, batch=2, device="cpu")
    assert np.array_equal(eng.generate(prompts, 8).tokens, want)
    eng2 = ServeEngine(bundle, params, max_seq=32, batch=2)
    eng2.publish_snapshot(snap)
    assert np.array_equal(eng2.generate(prompts, 8).tokens, want)


# ------------------------------------------------------------ entry points


def test_trainer_bf16_storage_tracks_fp32():
    data = generate_ehr_cohort(seed=0)
    run = FLRunConfig(algorithm="dsgt", q=5, topology="hospital20", n_nodes=N,
                      batch_per_node=20, alpha0=0.02)
    out = {}
    for storage in (None, "bfloat16"):
        res = train_decentralized(make_mlp_loss(class_weights()), mlp_init(0, device="cpu"),
                                  run, make_node_batcher(data, m=20, seed=1), rounds=4,
                                  engine="fused", storage_dtype=storage, device="cpu")
        out[storage] = res
    res = out["bfloat16"]
    assert res.state.params.dtype == res.state.tracker.dtype == BF16
    assert res.engine.layout.storage_dtype == "bfloat16"
    for (path, leaf), (_, ref_leaf) in zip(tree_leaves(res.consensus),
                                           tree_leaves(out[None].consensus)):
        assert leaf.dtype == torch.float32, path
        np.testing.assert_allclose(_np(leaf), _np(ref_leaf), atol=MULTI_ROUND_TOL,
                                   rtol=MULTI_ROUND_TOL, err_msg=str(path))
    np.testing.assert_allclose(res.history.column("loss"), out[None].history.column("loss"),
                               rtol=1e-2)
    for storage, engine in (("bfloat16", "tree"), ("float16", "fused")):
        with pytest.raises(ValueError):
            train_decentralized(make_mlp_loss(class_weights()), mlp_init(0, device="cpu"),
                                run, make_node_batcher(data, m=20, seed=1), rounds=1,
                                engine=engine, storage_dtype=storage, device="cpu")


@pytest.mark.parametrize("engine", ["fused", "flat"])
def test_launcher_bf16_storage(tmp_path, engine, capsys):
    ck = tmp_path / "ck"
    rec = train_launcher.main([
        "--arch", "tinyllama-1.1b", "--rounds", "2", "--q", "2", "--nodes", "2",
        "--seq-len", "16", "--log-every", "0", "--device", "cpu", "--fl-engine", engine,
        "--storage-dtype", "bfloat16", "--checkpoint", str(ck)])
    assert rec["fl_engine"] == engine and np.isfinite(rec["loss_last"])
    with open(ck / "manifest.json") as f:
        assert json.load(f)["dtypes"]["params::"] == "bfloat16"
    assert "checkpoint ->" in capsys.readouterr().out
