"""The PyTorch port's checkpoints (``repro_torch.training.checkpoint`` and
the engines' ``restore_comm``) against the JAX package's
(``repro.training.checkpoint``), on the reference scope suite's quadratic
problem (4 nodes, a private ``head`` and a ``trunk``, chunk 16).

* Round trips on ``fused`` (every schedule, both algorithms, scoped and
  not, under a topology program and dp): the restored state bitwise the
  saved one, and resuming bitwise the uninterrupted run.
* ``engine_manifest``: the six axes, as the reference records them.
* Every refusal of the reference's restore, each with the reference's
  message on the same checkpoint: an unknown engine, another staleness
  depth, topology program, node program, privacy spec, scope or shard
  count; wire state the template lacks or drops; unknown comm keys.
* Cross-loading: a reference checkpoint of a scoped FD-DSGT k = 2 run
  (and of a dp run under node churn, whose uint32 keys the port holds as
  int64 words) loads into the port bitwise, the port's into the
  reference bitwise; one more round on both within 1e-5.
* ``sharded_fused``: a fused checkpoint restored onto the sharded engine
  rebuilds ``mix_recon`` (``W_off @ recon``; pipelined ``W_off @ (recon -
  dq(wire))``) and ``nbr_recon_all`` under a program, and resumes within
  1e-5 of the fused run; on 2 gloo ranks a save gathers the rows and a
  load slices each rank's, equal to world 1.
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

from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core.schedules import constant as j_constant  # noqa: E402
from repro.training import checkpoint as j_ckpt  # noqa: E402
from repro_torch.core.engine import FusedEngine, ShardedFusedEngine, _dequant  # noqa: E402
from repro_torch.core.fl import FLConfig, FLState, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.schedules import constant  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402
from repro_torch.training.checkpoint import (  # noqa: E402
    engine_manifest,
    load_fl_state,
    save_fl_state,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, CHUNK, Q = 4, 16, 2
SCOPE = "backbone:private=head"
DP = "dp:sigma=0.5,clip=1.0"
CHURN = "node_churn:p_down=0.3,mean_downtime=2,seed=1"


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


def _loss(p, batch):
    return ((p["trunk"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["head"] ** 2).sum(dim=1)


def _j_loss(p, batch):
    return jnp.sum((p["trunk"] - batch["t"]) ** 2) + jnp.sum(p["head"] ** 2)


def _batches(seed=1):
    return {"t": np.random.default_rng(seed).normal(size=(Q, N, 6, 5)).astype(np.float32)}


def _engine(algorithm="dsgt", w=None, **kw):
    kw.setdefault("scale_chunk", CHUNK)
    engine, flat = FusedEngine.simulated(mixing_matrix("ring", N) if w is None else w,
                                         {k: torch.tensor(v) for k, v in _arrays().items()},
                                         **kw)
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    return engine, cfg, make_fl_round(_loss, constant(0.05), cfg, engine), \
        init_fl_state(cfg, flat, engine)


def _rounds(rf, state, n, seed=1):
    for r in range(n):
        state, _ = rf(state, _batches(seed + r))
    return state


def _same_state(a: FLState, b: FLState) -> None:
    assert a.step == b.step
    for x, y in ((a.params, b.params), (a.tracker, b.tracker), (a.prev_grad, b.prev_grad)):
        assert (x is None) == (y is None)
        if x is not None:
            assert torch.equal(x, y)
    assert set(a.comm or {}) == set(b.comm or {})
    for k in a.comm or {}:
        assert a.comm[k].dtype == b.comm[k].dtype and torch.equal(a.comm[k], b.comm[k]), k


CASES = [dict(), dict(scope=SCOPE), dict(round_schedule="pipelined", scope=SCOPE),
         dict(round_schedule="bounded_staleness:k=2", scope=SCOPE),
         dict(round_schedule="bounded_staleness:k=3"), dict(topology_program=CHURN),
         dict(privacy=DP, scope=SCOPE), dict(scope="layerwise:freq=2,head=head"),
         dict(node_program="stragglers:frac=0.5,rate=0.5,drop=1"), dict(topk=4, scope=SCOPE)]


@pytest.mark.parametrize("kw", CASES, ids=[",".join(f"{k}={v}" for k, v in c.items()) or
                                           "plain" for c in CASES])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_fused_round_trip_and_resume(tmp_path, algorithm, kw):
    """Save after 3 rounds, restore onto a fresh template: bitwise the
    saved state (the keys back as int64 words); 2 more rounds from it
    bitwise the uninterrupted run's."""
    engine, cfg, rf, st0 = _engine(algorithm, **kw)
    st3 = _rounds(rf, st0, 3)
    save_fl_state(str(tmp_path), st3, extra={"note": "x"}, engine=engine)
    manifest = json.loads((tmp_path / "manifest.json").read_text())
    assert manifest["comm_keys"] == sorted(st3.comm) and manifest["extra"] == {"note": "x"}
    back = load_fl_state(str(tmp_path), st0, engine=engine)
    _same_state(back, st3)
    _same_state(_rounds(rf, back, 2, seed=4), _rounds(rf, st3, 2, seed=4))


def test_engine_manifest_records_the_six_axes():
    kw = dict(round_schedule="bounded_staleness:k=2", topology_program=CHURN,
              node_program="stragglers:frac=0.5,rate=0.5,drop=1", privacy=DP, scope=SCOPE)
    engine = _engine(**kw)[0]
    j_eng, _ = j_engine.FusedEngine.simulated(
        mixing_matrix("ring", N), {k: jnp.asarray(v) for k, v in _arrays().items()},
        scale_chunk=CHUNK, impl="jnp", **kw)
    assert engine_manifest(engine) == j_ckpt.engine_manifest(j_eng)
    assert engine_manifest(engine)["scope"] == SCOPE


# ---------------------------------------------------------------- refusals


def _message(fn, exc=ValueError):
    try:
        fn()
    except exc as e:
        return str(e)
    raise AssertionError(f"no {exc.__name__}")


def _j_pair(algorithm="dsgt", **kw):
    """The reference's engine and template for the same configuration."""
    j_eng, j_flat = j_engine.FusedEngine.simulated(
        mixing_matrix("ring", N), {k: jnp.asarray(v) for k, v in _arrays().items()},
        scale_chunk=CHUNK, impl="jnp", **kw)
    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    return j_eng, j_fl.init_fl_state(j_cfg, j_flat, engine=j_eng)


MISMATCHES = {
    "schedule depth": dict(round_schedule="bounded_staleness:k=3"),
    "topology program": dict(topology_program="edge_failure:p=0.2"),
    "node program": dict(node_program="payload_drop:p=0.2"),
    "privacy": dict(privacy="dp:sigma=1.0,clip=1.0"),
    "scope": dict(scope="ranges:0-8,16-40"),
}


@pytest.mark.parametrize("what", MISMATCHES)
def test_mismatched_axis_is_refused_with_the_references_message(tmp_path, what):
    """A checkpoint written under k = 2, node churn, stragglers, dp and
    the backbone scope, restored onto an engine that differs in one axis:
    refused by both packages with the same message."""
    base = dict(round_schedule="bounded_staleness:k=2", topology_program=CHURN,
                node_program="stragglers:frac=0.5,rate=0.5,drop=1", privacy=DP, scope=SCOPE)
    engine, _, rf, st0 = _engine(**base)
    save_fl_state(str(tmp_path), _rounds(rf, st0, 1), engine=engine)
    other = {**base, **MISMATCHES[what]}
    eng2, _, _, tmpl = _engine(**other)
    j_eng2, j_tmpl = _j_pair(**other)
    mine = _message(lambda: load_fl_state(str(tmp_path), tmpl, engine=eng2))
    assert mine == _message(lambda: j_ckpt.load_fl_state(str(tmp_path), j_tmpl,
                                                         engine=j_eng2))
    assert {"schedule depth": "staleness depth", "topology program": "topology program",
            "node program": "node program", "privacy": "privacy spec",
            "scope": "federation scope"}[what] in mine


def _edit_manifest(path, **changes):
    p = os.path.join(path, "manifest.json")
    with open(p) as f:
        manifest = json.load(f)
    manifest.update(changes)
    with open(p, "w") as f:
        json.dump(manifest, f)


@pytest.mark.parametrize("changes", [
    dict(engine="no_such_engine"), dict(round_schedule="warp:k=1"),
    dict(topology_program="no_such_program"), dict(node_program="no_such_program"),
    dict(privacy="dp:sigma=-1"), dict(scope="backbone:bogus=1"),
    dict(mesh={"axis_names": ["data", "model"], "shape": [2, 2], "model_axis": "model",
               "model_shards": 2}),
], ids=["engine", "schedule", "topology", "node", "privacy", "scope", "shards"])
def test_unrebuildable_manifests_are_refused_with_the_references_message(tmp_path, changes):
    engine, _, rf, st0 = _engine()
    save_fl_state(str(tmp_path), _rounds(rf, st0, 1), engine=engine)
    _edit_manifest(str(tmp_path), **changes)
    j_eng, j_tmpl = _j_pair()
    mine = _message(lambda: load_fl_state(str(tmp_path), st0, engine=engine))
    assert mine == _message(lambda: j_ckpt.load_fl_state(str(tmp_path), j_tmpl,
                                                         engine=j_eng))


def test_wire_state_is_never_dropped_silently(tmp_path):
    """A comm-carrying checkpoint onto a comm-less template; a template
    without buffers the checkpoint saved; a richer template without
    ``engine=``; an unknown comm key through ``restore_comm``."""
    engine, cfg, rf, st0 = _engine("dsgt", round_schedule="bounded_staleness:k=2")
    save_fl_state(str(tmp_path / "k2"), _rounds(rf, st0, 1), engine=engine)
    with pytest.raises(ValueError, match="the restore template has none"):
        load_fl_state(str(tmp_path / "k2"), st0._replace(comm=None))
    plain, _, _, st_plain = _engine("dsgt")
    with pytest.raises(ValueError, match="does not use"):
        load_fl_state(str(tmp_path / "k2"), st_plain)
    save_fl_state(str(tmp_path / "seq"), _rounds(rf, st_plain, 0), engine=plain)
    with pytest.raises(ValueError, match="pass engine="):
        load_fl_state(str(tmp_path / "seq"), st0)
    with pytest.raises(ValueError, match="does not know"):
        engine.restore_comm({**st0.comm, "mix_recon": st0.comm["recon"]})
    assert not engine.is_derived_comm_key("recon")


# ------------------------------------------------------------ cross-loading


def _j_run(algorithm, rounds, **kw):
    j_eng, j_state = _j_pair(algorithm, **kw)
    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    rf = jax.jit(j_fl.make_fl_round(_j_loss, None, j_constant(0.05), j_cfg, engine=j_eng))
    for r in range(rounds):
        j_state, _ = rf(j_state, _batches(1 + r))
    return j_eng, j_state, rf


def _same_as_reference(mine: FLState, theirs) -> None:
    assert int(mine.step) == int(theirs.step)
    for x, y in ((mine.params, theirs.params), (mine.tracker, theirs.tracker),
                 (mine.prev_grad, theirs.prev_grad)):
        if y is not None:
            assert np.array_equal(_np(x), np.asarray(y))
    assert set(mine.comm) == set(theirs.comm)
    for k, v in theirs.comm.items():
        assert np.array_equal(_np(mine.comm[k]).astype(np.int64) if v.dtype == jnp.uint32
                              else _np(mine.comm[k]), np.asarray(v)), k


XLOAD = [("dsgt", dict(round_schedule="bounded_staleness:k=2", scope=SCOPE)),
         ("dsgd", dict(topology_program=CHURN, privacy=DP))]


@pytest.mark.parametrize("algorithm, kw", XLOAD, ids=["dsgt-k2-backbone", "dsgd-churn-dp"])
def test_reference_checkpoint_loads_into_the_port(tmp_path, algorithm, kw):
    j_eng, j_state, j_rf = _j_run(algorithm, 3, **kw)
    j_ckpt.save_fl_state(str(tmp_path), j_state, engine=j_eng)
    engine, cfg, rf, st0 = _engine(algorithm, **kw)
    back = load_fl_state(str(tmp_path), st0, engine=engine)
    _same_as_reference(back, j_state)
    for k in ("topo_key", "priv_key"):
        if k in back.comm:
            assert back.comm[k].dtype == torch.int64
    mine, _ = rf(back, _batches(9))
    theirs, _ = j_rf(j_state, _batches(9))
    np.testing.assert_allclose(_np(mine.params), np.asarray(theirs.params), rtol=0, atol=1e-5)


@pytest.mark.parametrize("algorithm, kw", XLOAD, ids=["dsgt-k2-backbone", "dsgd-churn-dp"])
def test_port_checkpoint_loads_into_the_reference(tmp_path, algorithm, kw):
    engine, cfg, rf, st0 = _engine(algorithm, **kw)
    state = _rounds(rf, st0, 3)
    save_fl_state(str(tmp_path), state, engine=engine)
    data = np.load(tmp_path / "state.npz")
    for k in ("topo_key", "priv_key"):
        if f"comm::{k}" in data.files:
            assert data[f"comm::{k}"].dtype == np.uint32
    j_eng, j_tmpl, j_rf = _j_run(algorithm, 0, **kw)
    back = j_ckpt.load_fl_state(str(tmp_path), j_tmpl, engine=j_eng)
    _same_as_reference(state, back)
    mine, _ = rf(state, _batches(9))
    theirs, _ = j_rf(back, _batches(9))
    np.testing.assert_allclose(_np(mine.params), np.asarray(theirs.params), rtol=0, atol=1e-5)


# ------------------------------------------------------------ sharded


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """A one-rank gloo group for this module's in-process tests."""
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu")
    yield g
    stop_group(g)


def _sharded(group, algorithm="dsgt", **kw):
    w = mixing_matrix("ring", N)
    sh, rows = ShardedFusedEngine.from_group(
        group, {k: torch.tensor(v) for k, v in _arrays().items()}, w=w, scale_chunk=CHUNK,
        **kw)
    cfg = FLConfig(algorithm=algorithm, q=Q, n_nodes=N)
    return sh, make_fl_round(_loss, constant(0.05), cfg, sh), init_fl_state(cfg, rows, sh)


@pytest.mark.parametrize("kw", [dict(scope=SCOPE), dict(round_schedule="pipelined"),
                                dict(round_schedule="bounded_staleness:k=2", scope=SCOPE),
                                dict(topology_program=CHURN)],
                         ids=["sequential", "pipelined", "k2", "churn"])
def test_fused_checkpoint_restores_onto_sharded(tmp_path, group, kw):
    """The reference's cross-engine case: the fused engine's checkpoint
    onto ``sharded_fused`` rebuilds the neighbor accumulators from the
    restored recon, then resumes within 1e-5 of the fused engine (at k =
    2 the rings differ and the fused checkpoint is refused; a sharded
    one with the recon replaced is rebuilt less its k in-flight
    payloads); a sharded checkpoint round-trips bitwise."""
    engine, cfg, rf, st0 = _engine("dsgt", **kw)
    st3 = _rounds(rf, st0, 3)
    save_fl_state(str(tmp_path / "fused"), st3, engine=engine)
    sh, sh_rf, sh0 = _sharded(group, "dsgt", **kw)
    if sh.staleness_depth >= 2:
        # the rings differ (the fused engine keeps k - 1 payloads, the
        # sharded wire k): refused on shape, as the reference refuses it
        with pytest.raises(ValueError, match="wire_q: shape"):
            load_fl_state(str(tmp_path / "fused"), sh0, engine=sh)
        st3 = sh0._replace(comm={**sh0.comm, **{k: st3.comm[k] for k in ("recon",
                                                                         "recon_t")}})
        save_fl_state(str(tmp_path / "fused"), st3, engine=sh)
    back = load_fl_state(str(tmp_path / "fused"), sh0, engine=sh)
    w_off = sh.w_off
    for suffix in ("", "_t"):
        eff = st3.comm["recon" + suffix]
        names = sh._wire_key_names(suffix)
        if sh.staleness_depth >= 2:  # the sharded ring: k in-flight payloads
            for j in range(sh.staleness_depth):
                eff = eff - _dequant(st3.comm[names[0]][:, j], st3.comm[names[-1]][:, j],
                                     CHUNK)
        if sh.dynamic_round:
            assert torch.equal(back.comm["nbr_recon_all" + suffix],
                               eff[None].expand(N, N, -1))
        else:
            np.testing.assert_allclose(_np(back.comm["mix_recon" + suffix]),
                                       _np(w_off @ eff), rtol=0, atol=1e-6)
    if not sh.pipelined:  # the fused ring is not the sharded wire's in-flight buffers
        a, b = _rounds(sh_rf, back, 2, seed=4), _rounds(rf, st3, 2, seed=4)
        np.testing.assert_allclose(_np(a.params), _np(b.params), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(a.tracker), _np(b.tracker), rtol=0, atol=1e-5)
    sh3 = _rounds(sh_rf, sh0, 3)
    save_fl_state(str(tmp_path / "sharded"), sh3, engine=sh)
    manifest = json.loads((tmp_path / "sharded" / "manifest.json").read_text())
    assert manifest["mesh"]["model_shards"] == 1 and manifest["engine"] == "sharded_fused"
    again = load_fl_state(str(tmp_path / "sharded"), sh0, engine=sh)
    for k in sh3.comm:
        if not sh.is_derived_comm_key(k):
            assert torch.equal(again.comm[k], sh3.comm[k]), k
        else:  # rebuilt from recon: the accumulated sums, in another order
            np.testing.assert_allclose(_np(again.comm[k]), _np(sh3.comm[k]), rtol=0,
                                       atol=1e-5)
    assert torch.equal(again.params, sh3.params)


_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np, torch
    torch.set_num_threads(1)
    from repro_torch.core.engine import FusedEngine, ShardedFusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.schedules import constant
    from repro_torch.core.topology import mixing_matrix
    from repro_torch.launch.mesh import start_group, stop_group
    from repro_torch.training.checkpoint import load_fl_state, save_fl_state

    rank, world, store, ckpt, out = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                                     sys.argv[4], sys.argv[5])
    g = start_group(rank, world, store, device="cpu")
    n, q, chunk = 8, 2, 16
    rng = np.random.default_rng(3)
    params = {"head": torch.tensor(rng.normal(size=(n, 3)), dtype=torch.float32),
              "trunk": torch.tensor(rng.normal(size=(n, 6, 5)), dtype=torch.float32)}
    batches = {"t": torch.tensor(rng.normal(size=(q, n, 6, 5)), dtype=torch.float32)}

    def loss(p, b):
        return ((p["trunk"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["head"] ** 2).sum(dim=1)

    w = mixing_matrix("erdos_renyi", n, p=0.5, seed=2)
    cfg = FLConfig(algorithm="dsgt", q=q, n_nodes=n)
    kw = dict(scale_chunk=chunk, round_schedule="pipelined", scope="backbone:private=head")
    res = {}
    # a fused checkpoint onto every rank, then the sharded save / load
    fe, flat = FusedEngine.simulated(w, params, **kw)
    frf = make_fl_round(loss, constant(0.05), cfg, fe)
    fst = init_fl_state(cfg, flat, fe)
    for _ in range(2):
        fst, _ = frf(fst, batches)
    if rank == 0:
        save_fl_state(os.path.join(ckpt, "fused"), fst, engine=fe)
    torch.distributed.barrier()
    eng, rows = ShardedFusedEngine.from_group(g, params, w=w, **kw)
    rf = make_fl_round(loss, constant(0.05), cfg, eng)
    st = load_fl_state(os.path.join(ckpt, "fused"), init_fl_state(cfg, rows, eng), engine=eng)
    res["mix_recon"] = eng.gather_rows(st.comm["mix_recon"]).numpy()
    for _ in range(2):
        st, m = rf(st, batches)
    save_fl_state(os.path.join(ckpt, f"sharded{world}"), st, engine=eng)
    back = load_fl_state(os.path.join(ckpt, f"sharded{world}"),
                         init_fl_state(cfg, rows, eng), engine=eng)
    assert torch.equal(back.params, st.params) and torch.equal(back.comm["wire_q"],
                                                               st.comm["wire_q"])
    st, m = rf(back, batches)
    res["params"] = eng.gather_rows(st.params).numpy()
    res["loss"] = np.float64(float(m["loss"]))
    if rank == 0:
        np.savez(out, **res)
    stop_group(g)
    sys.stdout.flush()
    # leave without interpreter teardown: gloo's threads have been seen
    # to abort a process at exit after the group was destroyed
    os._exit(0)
    """
)


def test_restore_comm_on_two_gloo_ranks(tmp_path):
    """A fused pipelined checkpoint under the backbone scope restored
    onto 2 gloo ranks: each rank's ``mix_recon`` rows rebuilt from the
    gathered recon, equal to world 1's; then 2 rounds, a gathered save,
    a sliced load (bitwise) and one more round, equal to world 1 within
    1e-6."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for world in (1, 2):
        ckpt = tmp_path / f"ckpt{world}"
        ckpt.mkdir()
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(rank), str(world),
                 str(tmp_path / f"store{world}"), str(ckpt), str(tmp_path / f"w{world}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-4000:]
    one, two = np.load(tmp_path / "w1.npz"), np.load(tmp_path / "w2.npz")
    for key in one.files:
        np.testing.assert_allclose(two[key], one[key], rtol=1e-6, atol=1e-6, err_msg=key)
    saved = np.load(tmp_path / "ckpt2" / "sharded2" / "state.npz")
    assert saved["params::"].shape == (8, 48) and saved["comm::mix_recon"].shape == (8, 32)
