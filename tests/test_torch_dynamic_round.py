"""The PyTorch port's dynamic rounds against the JAX package's
``FusedEngine(impl="jnp")`` on the paper's problem (the 20-hospital EHR
cohort, the 42 -> 32 -> 2 MLP in a (20, 1536) buffer, alpha =
0.02/sqrt(r)): FD-DSGD and FD-DSGT on the sequential, pipelined and
``bounded_staleness:k=2`` schedules under a topology program, a node
program and both. Both packages start from the reference's init and draw
the same batches.

Tolerances (the port's policy, ``tests/test_torch_fused_round.py``): one
round within 1e-5; five rounds of loss within rtol 1e-3 (an ulp of
gradient can move an int8 step, which error feedback absorbs); the
realized ``edge_fraction`` / ``payload_fraction`` / ``compute_fraction``
and the counters in the comm state equal.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.ehr_mlp import class_weights as j_class_weights  # noqa: E402
from repro.configs.base import FLRunConfig as JFLRunConfig  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core.packing import pack as j_pack  # noqa: E402
from repro.core.schedules import inv_sqrt as j_inv_sqrt  # noqa: E402
from repro.core.schedules import robust_alpha_scale as j_robust_alpha_scale  # noqa: E402
from repro.models.mlp import make_mlp_loss as j_make_mlp_loss  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro.training.trainer import stack_for_nodes as j_stack_for_nodes  # noqa: E402
from repro.training.trainer import train_decentralized as j_train  # noqa: E402
from repro_torch.configs.base import FLRunConfig  # noqa: E402
from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.engine import FlatEngine, FusedEngine  # noqa: E402
from repro_torch.core.fl import (  # noqa: E402
    FLConfig,
    init_fl_state,
    make_fl_round,
    value_and_grad,
)
from repro_torch.core.packing import pack_like, unpack  # noqa: E402
from repro_torch.core.schedules import constant, inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    stack_batches,
    stack_for_nodes,
    train_decentralized,
)

N, CHUNK = 20, 512
AXES = {
    "topology": dict(topology_program="node_churn:p_down=0.25,mean_downtime=5"),
    "node": dict(node_program="stragglers:frac=0.5,rate=0.5,drop=1"),
    "both": dict(topology_program="edge_failure:p=0.3,seed=2",
                 node_program="payload_drop:p=0.2,seed=1"),
}
FRACTIONS = ("edge_fraction", "payload_fraction", "compute_fraction")
WIRE_BYTES = {"dsgt": 167_184, "dsgd": 83_592}


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class _Pair:
    """The same dynamic run in both packages."""

    def __init__(self, algorithm: str, schedule: str, q: int = 10, **programs):
        self.cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=N)
        j_cfg = j_fl.FLConfig(algorithm=algorithm, q=q, n_nodes=N)
        w = mixing_matrix("hospital20", N)
        init = j_mlp_init(jax.random.key(0))
        j_flat, j_layout = j_pack(j_stack_for_nodes(init, N), pad_to=CHUNK)
        self.j_engine = j_engine.FusedEngine(w, j_layout, scale_chunk=CHUNK, impl="jnp",
                                             round_schedule=schedule, **programs)
        self.j_round = jax.jit(j_fl.make_fl_round(
            j_make_mlp_loss(j_class_weights()), None, j_inv_sqrt(0.02), j_cfg,
            engine=self.j_engine))
        self.j_state = j_fl.init_fl_state(j_cfg, j_flat, engine=self.j_engine)
        single = params_from_numpy(jax.tree_util.tree_map(np.asarray, init), device="cpu")
        self.engine, flat = FusedEngine.simulated(w, stack_for_nodes(single, N),
                                                  scale_chunk=CHUNK,
                                                  round_schedule=schedule, **programs)
        self.round = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02),
                                   self.cfg, self.engine)
        self.state = init_fl_state(self.cfg, flat, self.engine)
        self.batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)

    def step(self):
        batches = stack_batches(self.batcher, self.cfg.q)
        self.state, m = self.round(self.state, batches)
        self.j_state, jm = self.j_round(self.j_state, batches)
        return m, jm


@pytest.mark.parametrize("axes", AXES)
@pytest.mark.parametrize("schedule", ["sequential", "pipelined", "bounded_staleness:k=2"])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_dynamic_round_matches_reference(algorithm, schedule, axes):
    pair = _Pair(algorithm, schedule, **AXES[axes])
    cfg = pair.cfg
    assert set(pair.engine.comm_keys(cfg)) == set(pair.j_engine.comm_keys(cfg))
    for rnd in range(5):
        m, jm = pair.step()
        st, jst = pair.state, pair.j_state
        if rnd == 0:
            np.testing.assert_allclose(_np(st.params), _np(jst.params), rtol=0, atol=1e-5)
            for k in st.comm:
                np.testing.assert_allclose(_np(st.comm[k]).astype(np.float64),
                                           _np(jst.comm[k]).astype(np.float64),
                                           rtol=0, atol=1e-5, err_msg=k)
            if algorithm == "dsgt":
                np.testing.assert_allclose(_np(st.tracker), _np(jst.tracker), rtol=0,
                                           atol=1e-5)
        for k in ("topo_round", "topo_key", "topo_up", "node_key"):
            if k in jst.comm:
                assert (_np(st.comm[k]).astype(np.int64)
                        == _np(jst.comm[k]).astype(np.int64)).all(), k
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
        assert m["wire_bytes"] == float(jm["wire_bytes"]) == WIRE_BYTES[algorithm]
        assert {k for k in FRACTIONS if k in m} == {k for k in FRACTIONS if k in jm}
        for k in FRACTIONS:
            if k in m:
                assert float(m[k]) == float(jm[k]), (rnd, k)
    assert int(st.comm["topo_round"]) == 5


@pytest.mark.parametrize("schedule", ["sequential", "bounded_staleness:k=2"])
def test_static_programs_build_the_static_round(schedule):
    """``static`` and ``homogeneous`` build exactly the round with no
    program: no counters in the comm state, no step mask, the same bits."""
    w = mixing_matrix("hospital20", N)
    single = stack_for_nodes(params_from_numpy(jax.tree_util.tree_map(
        np.asarray, j_mlp_init(jax.random.key(0))), device="cpu"), N)
    cfg = FLConfig(algorithm="dsgt", q=4, n_nodes=N)
    runs = []
    for programs in ({}, dict(topology_program="static", node_program="homogeneous")):
        eng, flat = FusedEngine.simulated(w, single, scale_chunk=CHUNK,
                                          round_schedule=schedule, **programs)
        assert not eng.dynamic_round and eng.make_step_mask(cfg) is None
        rf = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02), cfg, eng)
        state = init_fl_state(cfg, flat, eng)
        assert not {"topo_round", "topo_key", "node_key"} & set(state.comm)
        batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
        for _ in range(3):
            state, m = rf(state, stack_batches(batcher, cfg.q))
        assert not set(FRACTIONS) & set(m)
        runs.append(state)
    assert torch.equal(runs[0].params, runs[1].params)
    assert all(torch.equal(runs[0].comm[k], runs[1].comm[k]) for k in runs[0].comm)


def test_masked_local_step_sits_the_node_out():
    """A node masked in a local step keeps its parameters; the others
    take the unmasked step bit for bit."""
    w = mixing_matrix("ring", 4)
    eng, flat = FlatEngine.simulated(w, {"p": torch.arange(24.0).reshape(4, 6)})
    g = torch.ones_like(flat)
    mask = torch.tensor([1.0, 0.0, 1.0, 0.0])
    out = eng.local_step(flat, g, np.float32(0.1), mask)
    assert torch.equal(out[1], flat[1]) and torch.equal(out[3], flat[3])
    assert torch.equal(out[[0, 2]], eng.local_step(flat, g, np.float32(0.1))[[0, 2]])


@pytest.mark.parametrize("spec", ["edge_failure:p=0.3,seed=3",
                                  "node_churn:mean_downtime=3,p_down=0.25,seed=1",
                                  "round_robin_subgraphs:n_groups=3",
                                  "rgg_rewire:jitter=0.15,radius=0,seed=5"])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_flat_dynamic_mix_matches_the_per_round_w_oracle(spec, algorithm):
    """``FlatEngine``'s exact wire against the program's per-round W:
    mix-then-adapt by hand with ``weights_np(r)``, and the reference's
    flat engine on the same program."""
    n, q, rounds = 8, 2, 4
    rng = np.random.default_rng(0)
    w = mixing_matrix("ring", n)
    params = {"w": rng.normal(size=(n, 4, 5)).astype(np.float32),
              "b": rng.normal(size=(n, 3)).astype(np.float32)}
    targets = rng.normal(size=(q, n, 4, 5)).astype(np.float32)

    def loss(p, batch):
        return ((p["w"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=n)
    eng, flat = FlatEngine.simulated(w, {k: torch.as_tensor(v) for k, v in params.items()},
                                     topology_program=spec)
    rf = make_fl_round(loss, constant(0.05), cfg, eng)
    state = init_fl_state(cfg, flat, eng)
    for _ in range(rounds):
        state, m = rf(state, {"t": targets})
    assert 0.0 <= float(m["edge_fraction"]) <= 1.0

    # the oracle: mix-then-adapt with the dense W_r of each round
    layout = eng.layout
    x = flat.clone().double()
    tr, gp = torch.zeros_like(x), torch.zeros_like(x)

    def grads(xf, i):
        _, g = value_and_grad(loss)(unpack(xf.float(), layout),
                                    {"t": torch.as_tensor(targets[i])})
        return pack_like(g, layout).double()

    for r in range(rounds):
        for i in range(q - 1):
            x = x - 0.05 * grads(x, i)
        g = grads(x, q - 1)
        w_r = torch.as_tensor(eng.topology_program.weights_np(r))
        if algorithm == "dsgd":
            x = w_r @ x - 0.05 * g
        else:
            tr = w_r @ tr + g - gp
            x = w_r @ x - 0.05 * tr
            gp = g
    np.testing.assert_allclose(_np(state.params), _np(x), rtol=0, atol=1e-5)

    j_eng, j_flat = j_engine.FlatEngine.simulated(
        w, {k: jnp.asarray(v) for k, v in params.items()}, topology_program=spec)
    j_round = jax.jit(j_fl.make_fl_round(
        lambda p, b: jnp.sum((p["w"] - b["t"]) ** 2) + jnp.sum(p["b"] ** 2), None,
        lambda step: jnp.float32(0.05), j_fl.FLConfig(algorithm=algorithm, q=q, n_nodes=n),
        engine=j_eng))
    j_state = j_fl.init_fl_state(j_fl.FLConfig(algorithm=algorithm, q=q, n_nodes=n),
                                 j_flat, engine=j_eng)
    for _ in range(rounds):
        j_state, jm = j_round(j_state, {"t": jnp.asarray(targets)})
    np.testing.assert_allclose(_np(state.params), _np(j_state.params), rtol=0, atol=1e-5)
    assert float(m["edge_fraction"]) == float(jm["edge_fraction"])


def test_comm_state_contract_matches_the_reference():
    """The counters' shapes equal the reference's; each uint32 key is held
    as int64 words (torch has no uint32 arithmetic on every device)."""
    w = mixing_matrix("hospital20", N)
    j_flat, j_layout = j_pack({"p": jnp.zeros((N, 1442))}, pad_to=CHUNK)
    programs = dict(topology_program="node_churn:p_down=0.25",
                    node_program="stragglers:frac=0.25")
    j_eng = j_engine.FusedEngine(w, j_layout, impl="jnp", **programs)
    eng, _ = FusedEngine.simulated(w, {"p": torch.zeros(N, 1442)}, **programs)
    cfg = FLConfig(algorithm="dsgt", q=3, n_nodes=N)
    spec, sds = eng.comm_state_spec(cfg), j_eng.comm_state_sds(cfg)
    assert list(spec) == list(sds)
    for key, (shape, dtype) in spec.items():
        assert shape == sds[key].shape, key
        want = torch.int64 if sds[key].dtype == np.uint32 else getattr(
            torch, sds[key].dtype.name)
        assert dtype == want, key
    comm = eng.init_comm_state(cfg, None)
    j_comm = j_eng.init_comm_state(cfg, j_flat)
    for key in ("topo_round", "topo_key", "topo_up", "node_key"):
        assert (_np(comm[key]).astype(np.int64) == _np(j_comm[key]).astype(np.int64)).all()


def test_robust_alpha_uses_both_uptimes():
    """``robust_alpha`` scales alpha by ``robust_alpha_scale(topology
    uptime * node uptime, depth)``, as the reference's trainer does:
    here 0.8 * 0.5, so neither uptime alone gives the trainer's alpha."""
    programs = dict(topology_program="edge_failure:p=0.36,seed=1",
                    node_program="payload_drop:p=0.5,seed=2")
    run = FLRunConfig(algorithm="dsgd", q=2, topology="hospital20", n_nodes=N,
                      batch_per_node=8, alpha0=0.02)
    j_run = JFLRunConfig(algorithm="dsgd", q=2, topology="hospital20", n_nodes=N,
                         batch_per_node=8, alpha0=0.02)
    init = j_mlp_init(jax.random.key(0))
    single = params_from_numpy(jax.tree_util.tree_map(np.asarray, init), device="cpu")
    res = train_decentralized(make_mlp_loss(class_weights()), single, run,
                              make_node_batcher(generate_ehr_cohort(seed=0), m=8, seed=1),
                              rounds=3, engine="flat", robust_alpha=True, device="cpu",
                              **programs)
    j_res = j_train(j_make_mlp_loss(j_class_weights()), init, j_run,
                    make_node_batcher(generate_ehr_cohort(seed=0), m=8, seed=1),
                    rounds=3, engine="flat", robust_alpha=True, **programs)
    alphas = res.history.column("alpha")
    # one ulp apart at most: XLA may evaluate the reference's schedule as
    # alpha0 * rsqrt(r) (tests/test_torch_fused_round.py)
    np.testing.assert_allclose(alphas, j_res.history.column("alpha"), rtol=2.5e-7)
    scale = j_robust_alpha_scale(0.8 * 0.5, 0)
    assert scale == pytest.approx(0.16)
    for k, a in enumerate(alphas):
        assert a == np.float32(np.float32(scale) * inv_sqrt(0.02)(2 * (k + 1)))
        for one in (0.8, 0.5):  # either uptime alone
            assert a != np.float32(np.float32(j_robust_alpha_scale(one, 0))
                                   * inv_sqrt(0.02)(2 * (k + 1)))
    for k in ("edge_fraction", "payload_fraction"):
        np.testing.assert_array_equal(res.history.column(k), j_res.history.column(k))
