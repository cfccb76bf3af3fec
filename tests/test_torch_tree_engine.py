"""The exact-wire engines of the PyTorch port (``tree`` and ``flat``) and
the trainer's tree path, against the JAX package's ``TreeEngine`` /
``FlatEngine`` and ``train_decentralized`` from identical numpy inputs:

* the reference suite's exact-gradient quadratic problem
  (tests/test_megakernel.py), DSGD and DSGT at Q in {1, 5}, on both
  engines;
* the paper's EHR MLP on the 20-hospital graph, from the reference's
  init carried over by ``repro_torch.convert``;
* the DSGT tracking invariant ``mean tracker == mean grad``
  (``repro/core/fl.py:42``);
* the registry, the trainer's defaults and the engines' refusals.

Tolerances: both packages mix in fp32 with no quantization, so the
trajectories differ only by summation order (the n x n product, the MLP's
matmuls) and by alpha, which the reference evaluates inside ``jit`` one
ulp off for some r (ROADMAP.md queue 3). State agrees within ``ATOL`` =
1e-5 (the reference suite's) after one round and after ``ROUNDS``
rounds; the metrics within rtol 1e-5. The tracking invariant holds
within 1e-6: it is exact up to fp32 rounding on the exact wire.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLRunConfig as JFLRunConfig  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core.schedules import inv_sqrt as j_inv_sqrt  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro.models.mlp import mlp_loss as j_mlp_loss  # noqa: E402
from repro.training.trainer import train_decentralized as j_train  # noqa: E402
from repro_torch.configs.base import FLRunConfig  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FlatEngine,
    TreeEngine,
    engine_names,
    get_engine,
)
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss, mlp_init  # noqa: E402
from repro_torch.training.metrics import comm_bytes_per_gossip  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    stack_batches,
    stack_for_nodes,
    train_decentralized,
)

ATOL = 1e-5
ROUNDS = 4
METRICS = ("loss", "local_loss", "alpha", "grad_norm_sq", "consensus_err")


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def _close(mine, ref, atol=ATOL, what=""):
    got, want = list(_leaves(mine)), list(_leaves(ref))
    assert len(got) == len(want), what
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), _np(b), rtol=0, atol=atol, err_msg=what)


# ---------------------------------------------------------------------------
# the two problems, in both packages
# ---------------------------------------------------------------------------


def _quad_loss(p, batch):
    """Node-batched twin of tests/test_megakernel.py's per-node loss."""
    return ((p["w"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)


def _j_quad_loss(p, batch):
    return jnp.sum((p["w"] - batch["t"]) ** 2) + jnp.sum(p["b"] ** 2)


class _QuadProblem:
    """The exact-gradient quadratic: fresh numpy targets every round."""

    topo, n, alpha0, chunk = "ring", 8, 0.05, 8

    def __init__(self, q, seed=0):
        self.q = q
        self.rng = np.random.default_rng(seed)
        self.stacked = {
            "w": np.asarray(self.rng.normal(size=(self.n, 4, 3)), np.float32),
            "b": np.asarray(self.rng.normal(size=(self.n, 3)), np.float32),
        }
        self.loss, self.j_loss = _quad_loss, _j_quad_loss

    def batches(self):
        return {"t": np.asarray(self.rng.normal(size=(self.q, self.n, 4, 3)), np.float32)}


class _EHRProblem:
    """The paper's cohort and MLP (unweighted loss, as in Fig. 2), from
    the reference's init."""

    topo, n, alpha0, chunk = "hospital20", 20, 0.02, 512

    def __init__(self, q, seed=0):
        self.q = q
        init = jax.tree_util.tree_map(np.asarray, j_mlp_init(jax.random.key(seed)))
        self.stacked = jax.tree_util.tree_map(
            lambda p: np.broadcast_to(p, (self.n,) + p.shape).copy(), init)
        self.batcher = make_node_batcher(generate_ehr_cohort(seed=seed), m=20,
                                         seed=seed + 1)
        self.loss, self.j_loss = make_mlp_loss(), j_mlp_loss

    def batches(self):
        return stack_batches(self.batcher, self.q)


class _Pair:
    """The same run on the port's engine and the reference's."""

    def __init__(self, engine: str, algorithm: str, problem):
        self.problem = problem
        self.cfg = FLConfig(algorithm=algorithm, q=problem.q, n_nodes=problem.n)
        j_cfg = j_fl.FLConfig(algorithm=algorithm, q=problem.q, n_nodes=problem.n)
        w = mixing_matrix(problem.topo, problem.n)
        j_stacked = jax.tree_util.tree_map(jnp.asarray, problem.stacked)
        self.j_engine, j_params = j_engine.get_engine(engine).simulated(
            w, j_stacked, scale_chunk=problem.chunk)
        self.j_round = jax.jit(j_fl.make_fl_round(
            problem.j_loss, None, j_inv_sqrt(problem.alpha0), j_cfg,
            engine=self.j_engine))
        self.j_state = j_fl.init_fl_state(j_cfg, j_params, engine=self.j_engine)

        stacked = params_from_numpy(problem.stacked, device="cpu")
        self.engine, params = get_engine(engine).simulated(
            w, stacked, scale_chunk=problem.chunk)
        self.round = make_fl_round(problem.loss, inv_sqrt(problem.alpha0), self.cfg,
                                   self.engine)
        self.state = init_fl_state(self.cfg, params, self.engine)

    def step(self):
        batches = self.problem.batches()
        self.state, m = self.round(self.state, batches)
        self.j_state, jm = self.j_round(self.j_state, batches)
        return m, jm

    def compare(self, m, jm):
        st, jst = self.state, self.j_state
        assert st.step == int(jst.step)
        assert st.comm is None and jst.comm is None
        _close(st.params, jst.params, what="params")
        if self.cfg.algorithm == "dsgt":
            _close(st.tracker, jst.tracker, what="tracker")
            _close(st.prev_grad, jst.prev_grad, what="prev_grad")
        else:
            assert st.tracker is None and st.prev_grad is None
        assert set(m) == set(jm)
        for k in METRICS:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-8,
                                       err_msg=k)
        assert "wire_bytes" not in m and float(m["comm_rounds"]) == 1.0


@pytest.mark.parametrize("q", [1, 5])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_quadratic_rounds_match_reference(engine, algorithm, q):
    """One round, then ``ROUNDS`` rounds, on the exact-gradient problem."""
    pair = _Pair(engine, algorithm, _QuadProblem(q, seed=q))
    for _ in range(ROUNDS):
        pair.compare(*pair.step())
    if engine == "flat":
        assert pair.state.params.shape == (8, 16) and pair.engine.layout.used == 15


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_ehr_rounds_match_reference(engine, algorithm):
    """The paper's problem at Q = 5 from the reference's init: one round,
    then ``ROUNDS`` rounds."""
    pair = _Pair(engine, algorithm, _EHRProblem(q=5))
    for _ in range(ROUNDS):
        pair.compare(*pair.step())
    view = pair.engine.params_view(pair.state.params)
    assert view["fc1"]["w"].shape == (20, 42, 32)


@pytest.mark.parametrize("engine", ["tree", "flat"])
def test_dsgt_tracking_invariant(engine):
    """mean_i tracker == mean_i prev_grad after every comm round: any
    doubly-stochastic W preserves the tracker's mean, and the update adds
    exactly the change of the mean gradient."""
    pair = _Pair(engine, "dsgt", _EHRProblem(q=2))
    for _ in range(6):
        pair.step()
        tracker = list(_leaves(pair.engine.params_view(pair.state.tracker)))
        grads = list(_leaves(pair.engine.params_view(pair.state.prev_grad)))
        for t, g in zip(tracker, grads):
            drift = float((t.mean(dim=0) - g.mean(dim=0)).abs().max())
            assert drift < 1e-6, drift


def test_bf16_wire_matches_reference():
    """``wire_dtype`` on both exact-wire engines: the payload through
    bf16, the self term exact."""
    for engine in ("tree", "flat"):
        problem = _QuadProblem(q=2, seed=11)
        w = mixing_matrix(problem.topo, problem.n)
        cfg = FLConfig(algorithm="dsgt", q=2, n_nodes=problem.n)
        j_cfg = j_fl.FLConfig(algorithm="dsgt", q=2, n_nodes=problem.n)
        je, jp = j_engine.get_engine(engine).simulated(
            w, jax.tree_util.tree_map(jnp.asarray, problem.stacked),
            wire_dtype=jnp.bfloat16)
        mine, p = get_engine(engine).simulated(
            w, params_from_numpy(problem.stacked, device="cpu"), wire_dtype="bfloat16")
        j_round = jax.jit(j_fl.make_fl_round(_j_quad_loss, None, j_inv_sqrt(0.05),
                                             j_cfg, engine=je))
        round_fn = make_fl_round(_quad_loss, inv_sqrt(0.05), cfg, mine)
        st, jst = init_fl_state(cfg, p, mine), j_fl.init_fl_state(j_cfg, jp, engine=je)
        for _ in range(3):
            b = problem.batches()
            st, _ = round_fn(st, b)
            jst, _ = j_round(jst, b)
        _close(st.params, jst.params, what=engine)
        _close(st.tracker, jst.tracker, what=engine)


# ---------------------------------------------------------------------------
# the trainer's tree path
# ---------------------------------------------------------------------------


def test_trainer_defaults_to_the_tree_engine_and_matches_reference():
    """``train_decentralized`` builds the ``tree`` engine unless told
    otherwise, charges the exact wire ``comm_bytes_per_gossip`` per round
    (as the reference's does) and tracks the reference trainer."""
    init = jax.tree_util.tree_map(np.asarray, j_mlp_init(jax.random.key(0)))
    data = generate_ehr_cohort(seed=0)
    kw = dict(algorithm="dsgt", q=3, topology="hospital20", n_nodes=20,
              batch_per_node=20, alpha0=0.02)
    res = train_decentralized(make_mlp_loss(), params_from_numpy(init, device="cpu"),
                              FLRunConfig(**kw), make_node_batcher(data, m=20, seed=1),
                              rounds=3, device="cpu")
    ref = j_train(j_mlp_loss, jax.tree_util.tree_map(jnp.asarray, init),
                  JFLRunConfig(**kw), make_node_batcher(data, m=20, seed=1), rounds=3)
    assert isinstance(res.engine, TreeEngine) and ref.engine.name == "tree"
    per_round = comm_bytes_per_gossip(params_from_numpy(init, device="cpu"),
                                      "hospital20", 20)
    np.testing.assert_array_equal(res.history.column("comm_bytes"),
                                  ref.history.column("comm_bytes"))
    assert res.history.column("comm_bytes")[-1] == 3 * per_round
    for k in ("loss", "grad_norm_sq", "consensus_err", "iteration"):
        np.testing.assert_allclose(res.history.column(k), ref.history.column(k),
                                   rtol=1e-5, err_msg=k)
    _close(res.consensus, ref.consensus, what="consensus")


def test_trainer_wire_dtype_and_flat_engine():
    """``wire_dtype`` (from the argument or ``run.wire_dtype``) reaches
    the exact-wire engine build and halves the accounted bytes; the flat
    engine charges the same exact wire; the fused engine refuses it."""
    data = generate_ehr_cohort(seed=0)
    init = mlp_init(0, device="cpu")
    run = FLRunConfig(algorithm="dsgd", q=2, topology="hospital20", n_nodes=20,
                      batch_per_node=8, wire_dtype="bfloat16")
    res = train_decentralized(make_mlp_loss(), init, run,
                              make_node_batcher(data, m=8, seed=1), rounds=2,
                              device="cpu")
    bf16 = comm_bytes_per_gossip(init, "hospital20", 20, wire_dtype="bfloat16")
    assert bf16 == comm_bytes_per_gossip(init, "hospital20", 20) // 2
    assert res.history.column("comm_bytes")[-1] == 2 * bf16
    flat = train_decentralized(make_mlp_loss(), init, run,
                               make_node_batcher(data, m=8, seed=1), rounds=2,
                               engine="flat", device="cpu")
    assert isinstance(flat.engine, FlatEngine) and flat.state.params.shape == (20, 1536)
    _close(flat.consensus, res.consensus, atol=1e-6, what="flat vs tree")
    with pytest.raises(ValueError, match="wire_dtype"):
        train_decentralized(make_mlp_loss(), init, run,
                            make_node_batcher(data, m=8, seed=1), rounds=1,
                            engine="fused", device="cpu")


def test_registry_and_refusals():
    """``tree`` and ``flat`` sit in the registry beside ``fused``; both
    refuse what the reference's refuse (ValueError: top-k, a schedule
    other than sequential, a partial scope, dp; ``tree`` also topology
    and node programs and ``secure_agg``, which ``flat`` runs) and raise
    NotImplementedError naming the ROADMAP item for what is not
    ported."""
    assert {"tree", "flat", "fused"} <= set(engine_names())
    assert get_engine("tree") is TreeEngine and get_engine("flat") is FlatEngine
    w = mixing_matrix("ring", 4)
    stacked = {"p": torch.zeros(4, 6)}
    for cls in (TreeEngine, FlatEngine):
        for kw, match in [(dict(topk=8), "topk"),
                          (dict(round_schedule="pipelined"), "sequential-only"),
                          (dict(round_schedule="bounded_staleness:k=2"), "sequential-only"),
                          (dict(scope="backbone"), "federation scope")]:
            with pytest.raises(ValueError, match=match):
                cls.simulated(w, stacked, **kw)
        for kw, match in [(dict(topology_program="node_churn:p_down=0.1"),
                           "needs traced per-round mixing weights"),
                          (dict(node_program="stragglers:frac=0.25"),
                           "needs traced per-round compute/payload gates")]:
            if cls is TreeEngine:
                with pytest.raises(ValueError, match=match):
                    cls.simulated(w, stacked, **kw)
            else:
                assert cls.simulated(w, stacked, **kw)[0].dynamic_round
        with pytest.raises(ValueError, match="DP noise would accumulate|privacy spec"):
            cls.simulated(w, stacked, privacy="dp:sigma=0.5,clip=1.0")
        if cls is TreeEngine:
            with pytest.raises(ValueError, match="no quantize epilogue"):
                cls.simulated(w, stacked, privacy="secure_agg")
        else:
            assert cls.simulated(w, stacked, privacy="secure_agg")[0].privacy.secure_agg
        if cls is TreeEngine:
            with pytest.raises(ValueError, match="storage_dtype is a flat-buffer knob"):
                cls.simulated(w, stacked, storage_dtype=torch.bfloat16)
        else:
            bf16_engine, bf16_flat = cls.simulated(w, stacked, storage_dtype=torch.bfloat16)
            assert bf16_flat.dtype == bf16_engine.storage_dtype == torch.bfloat16
        engine, _ = cls.simulated(w, stacked)
        assert engine.device == torch.device("cpu") and engine.wire_bytes(None) is None
    cfg = FLConfig(algorithm="dsgd", q=1, n_nodes=4)
    flat_engine, flat = FlatEngine.simulated(w, stacked)
    with pytest.raises(ValueError, match="flat buffer"):
        init_fl_state(cfg, stacked, flat_engine)
    with pytest.raises(ValueError, match="node-stacked"):
        init_fl_state(cfg, {"p": torch.zeros(3, 6)})
    with pytest.raises(NotImplementedError, match="fused comm step"):
        get_engine("fused").simulated(w, stacked, scale_chunk=2)[0].mix(flat)
    assert init_fl_state(cfg, flat, flat_engine).comm is None


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device is usable")


def test_engines_default_to_the_card(no_card):
    w = mixing_matrix("ring", 4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TreeEngine(lambda t: t)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FlatEngine(lambda f: f, None)
    assert TreeEngine.simulated(w, stack_for_nodes(mlp_init(0, device="cpu"), 4))[
        0].device.type == "cpu"
