"""The port's round schedules and top-k wire against the JAX package.

* ``FusedEngine`` rounds under the pipelined and bounded-staleness
  (k = 2, 4) schedules, for FD-DSGD and FD-DSGT, with the dense and the
  top-k (k = 4) wire, against ``repro.core.engine.FusedEngine(impl="jnp")``
  from the same init (through ``convert.py``) and the same batches: on
  the paper's problem (the 20-hospital EHR cohort, the 42 -> 32 -> 2 MLP
  in a (20, 1536) buffer, alpha = 0.02/sqrt(r)), and for the top-k wire
  also on the reference suite's exact-gradient quadratic problem.
* Within the port: ``bounded_staleness:k=1`` is bit-identical to
  ``pipelined``; the ring state has the reference's keys, shapes and
  dtypes; the wire bytes do not depend on k and equal the reference's.
* The schedule registry, the learning-rate schedules, the top-k byte
  accounting, ``AdaptiveTopK`` and the trainer's knobs against the
  reference's.

Tolerances (ROADMAP.md queue 3): one round agrees within 1e-5. The two
packages' gradients differ by an ulp here and there, and a one-ulp
change of a payload on an int8 rounding boundary moves that column by a
quantization step that error feedback absorbs; so five rounds agree on
the loss within rtol 1e-3 and on the consensus parameters within atol
1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import ehr_mlp as j_ehr_mlp  # noqa: E402
from repro.configs.base import FLRunConfig as JFLRunConfig  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core import packing as j_packing  # noqa: E402
from repro.core import schedules as j_schedules  # noqa: E402
from repro.core.packing import pack as j_pack  # noqa: E402
from repro.data.ehr import generate_ehr_cohort as j_cohort  # noqa: E402
from repro.data.ehr import make_node_batcher as j_batcher  # noqa: E402
from repro.models.mlp import make_mlp_loss as j_make_mlp_loss  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro.training import trainer as j_trainer  # noqa: E402
from repro_torch.configs import ehr_mlp  # noqa: E402
from repro_torch.configs.base import FLRunConfig  # noqa: E402
from repro_torch.convert import flat_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core import packing, schedules  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FusedEngine,
    resolve_schedule,
    schedule_names,
)
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.packing import pack_layout, unpack  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.examples.ehr_federated import run_fused_engine  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss  # noqa: E402
from repro_torch.training.trainer import (  # noqa: E402
    AdaptiveTopK,
    make_schedule,
    stack_batches,
    stack_for_nodes,
    train_decentralized,
)

N, CHUNK = 20, 512
STALE_SCHEDULES = ["pipelined", "bounded_staleness:k=2", "bounded_staleness:k=4"]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _init():
    return j_mlp_init(jax.random.key(0))


def _quadratic(n, q, seed):
    """The reference suite's exact-gradient problem
    (tests/test_bounded_staleness.py): per node ``sum((w - t)^2) +
    sum(b^2)``, whose gradients ``2 (w - t)`` and ``2 b`` both packages
    compute bit for bit. Returns (port loss, reference loss, node-stacked
    numpy params, one round's numpy batches)."""
    import jax.numpy as jnp

    rng = np.random.default_rng(seed)
    params = {"w": rng.normal(size=(n, 4, 5)).astype(np.float32),
              "b": rng.normal(size=(n, 3)).astype(np.float32)}
    batches = {"t": rng.normal(size=(q, n, 4, 5)).astype(np.float32)}

    def loss(p, batch):
        return ((p["w"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    def j_loss(p, batch):
        return jnp.sum((p["w"] - batch["t"]) ** 2) + jnp.sum(p["b"] ** 2)

    return loss, j_loss, params, batches


class _Pair:
    """The same run in both packages: engines, round functions, states.
    ``problem="ehr"``: the paper's EHR setup; ``"quadratic"``: 8 nodes on
    a ring, chunk 16, the exact-gradient problem of :func:`_quadratic`."""

    def __init__(self, algorithm, q, schedule, topk=None, reference=True,
                 problem="ehr"):
        if problem == "ehr":
            n, chunk, alpha0 = N, CHUNK, 0.02
            w = mixing_matrix("hospital20", N)
            init = _init()
            single = params_from_numpy(jax.tree_util.tree_map(np.asarray, init),
                                       device="cpu")
            stacked, j_stacked = stack_for_nodes(single, n), j_trainer.stack_for_nodes(init, n)
            loss, j_loss = (make_mlp_loss(ehr_mlp.class_weights()),
                            j_make_mlp_loss(j_ehr_mlp.class_weights()))
            batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
            self.batches = lambda: stack_batches(batcher, q)
        else:
            n, chunk, alpha0 = 8, 16, 0.05
            w = mixing_matrix("ring", n)
            loss, j_loss, j_stacked, fixed = _quadratic(n, q, seed=3)
            stacked = params_from_numpy(j_stacked, device="cpu")
            self.batches = lambda: fixed
        self.cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=n)
        self.engine, flat = FusedEngine.simulated(
            w, stacked, scale_chunk=chunk, topk=topk, round_schedule=schedule)
        self.round = make_fl_round(loss, schedules.inv_sqrt(alpha0), self.cfg,
                                   self.engine)
        self.state = init_fl_state(self.cfg, flat, self.engine)
        self.reference = reference
        if reference:
            j_cfg = j_fl.FLConfig(algorithm=algorithm, q=q, n_nodes=n)
            j_flat, j_layout = j_pack(j_stacked, pad_to=chunk)
            assert torch.equal(flat, flat_from_numpy(np.asarray(j_flat), self.engine.layout,
                                                     device="cpu"))
            self.j_engine = j_engine.FusedEngine(
                w, j_layout, scale_chunk=chunk, topk=topk, impl="jnp",
                round_schedule=schedule)
            self.j_round = jax.jit(j_fl.make_fl_round(
                j_loss, None, j_schedules.inv_sqrt(alpha0), j_cfg, engine=self.j_engine))
            self.j_state = j_fl.init_fl_state(j_cfg, j_flat, engine=self.j_engine)

    def step(self):
        batches = self.batches()
        self.state, m = self.round(self.state, batches)
        if not self.reference:
            return m, None
        self.j_state, jm = self.j_round(self.j_state, batches)
        return m, jm


def _assert_states_close(st, jst, atol):
    np.testing.assert_allclose(_np(st.params), _np(jst.params), rtol=0, atol=atol)
    if st.tracker is not None:
        np.testing.assert_allclose(_np(st.tracker), _np(jst.tracker), rtol=0, atol=atol)
        np.testing.assert_allclose(_np(st.prev_grad), _np(jst.prev_grad), rtol=0, atol=atol)
    assert set(st.comm) == set(jst.comm)
    for k in st.comm:
        a, b = _np(st.comm[k]), _np(jst.comm[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if a.dtype == np.int8:  # int8 payloads: equal integers
            np.testing.assert_array_equal(a, b, err_msg=k)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


def _five_rounds(pair):
    """One round within 1e-5 on every state (the in-flight ring's int8
    payloads exactly) and metric; then four more rounds within the
    multi-round tolerances. Returns the last metrics."""
    assert pair.engine.comm_keys(pair.cfg) == pair.j_engine.comm_keys(pair.cfg)
    m, jm = pair.step()
    assert pair.state.step == int(pair.j_state.step) == pair.cfg.q
    _assert_states_close(pair.state, pair.j_state, 1e-5)
    for k in ("loss", "local_loss", "alpha", "grad_norm_sq", "consensus_err",
              "ef_residual_rms"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    for _ in range(4):
        m, jm = pair.step()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
        assert m["wire_bytes"] == float(jm["wire_bytes"])
    return m, jm


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("schedule", STALE_SCHEDULES)
def test_stale_rounds_match_reference_on_ehr(schedule, algorithm):
    """The EHR problem on the dense int8 wire: one round within 1e-5, five
    rounds at Q = 10 within rtol 1e-3 on the loss and atol 1e-3 on the
    consensus parameters."""
    pair = _Pair(algorithm, 10, schedule)
    _five_rounds(pair)
    mine = unpack(pair.state.params, pair.engine.layout)
    ref = pair.j_engine.params_view(pair.j_state.params)
    for layer in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(_np(mine[layer][leaf].mean(dim=0)),
                                       _np(ref[layer][leaf]).mean(axis=0), rtol=0,
                                       atol=1e-3, err_msg=f"{layer}.{leaf}")


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("schedule", ["sequential"] + STALE_SCHEDULES)
def test_topk_rounds_match_reference(schedule, algorithm):
    """The top-k (k = 4) wire on the exact-gradient problem: one round
    within 1e-5, five rounds within 1e-5 on the parameters too. (On the
    EHR MLP the two output columns' gradients are equal and opposite, so
    their magnitudes tie up to an ulp; the packages' gradients differ by
    an ulp, and the mask may then keep the other one of the pair. Those
    runs are held in :func:`test_topk_ehr_tracks_reference`.)"""
    pair = _Pair(algorithm, 3, schedule, topk=4, problem="quadratic")
    _five_rounds(pair)
    np.testing.assert_allclose(_np(pair.state.params), _np(pair.j_state.params),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("schedule", ["sequential", "bounded_staleness:k=2"])
def test_topk_ehr_tracks_reference(schedule, algorithm):
    """The top-k (k = 4) wire on the EHR problem: five rounds at Q = 10
    agree on the loss within rtol 1e-3 and on the consensus parameters
    within atol 1e-3, and ship the same bytes."""
    pair = _Pair(algorithm, 10, schedule, topk=4)
    for _ in range(5):
        m, jm = pair.step()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
        assert m["wire_bytes"] == float(jm["wire_bytes"])
    mine = unpack(pair.state.params, pair.engine.layout)
    ref = pair.j_engine.params_view(pair.j_state.params)
    for layer in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(_np(mine[layer][leaf].mean(dim=0)),
                                       _np(ref[layer][leaf]).mean(axis=0), rtol=0,
                                       atol=1e-3, err_msg=f"{layer}.{leaf}")


def test_topk64_wire_matches_reference_example_numbers():
    """The reference example's ``--topk 64`` FD-DSGT wire: 42,768 B per
    round (132 B per chunk: 64 values + a 64 B bitmap + the scale), the
    same in both packages, 14.57x under the fp32 wire."""
    pair = _Pair("dsgt", 2, "sequential", topk=64)
    for _ in range(3):
        m, jm = pair.step()
        assert m["wire_bytes"] == float(jm["wire_bytes"]) == 42_768
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
    assert pair.engine.wire_bytes(pair.cfg) == pair.j_engine.wire_bytes(pair.cfg)


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_bounded_k1_is_bit_identical_to_pipelined(algorithm):
    """``bounded_staleness:k=1`` IS the pipelined round: same comm state,
    bit-identical trajectories."""
    runs = [_Pair(algorithm, 3, spec, topk=4, reference=False)
            for spec in ("pipelined", "bounded_staleness:k=1")]
    p, one = runs
    assert p.engine.comm_state_spec(p.cfg) == one.engine.comm_state_spec(one.cfg)
    for _ in range(4):
        mp, _ = p.step()
        m1, _ = one.step()
        assert float(mp["loss"]) == float(m1["loss"])
    assert torch.equal(p.state.params, one.state.params)
    for key in p.state.comm:
        assert torch.equal(p.state.comm[key], one.state.comm[key]), key


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
@pytest.mark.parametrize("schedule", ["sequential"] + STALE_SCHEDULES)
def test_ring_state_has_reference_keys_shapes_dtypes(schedule, algorithm):
    """``comm_state_spec`` == the reference's ``comm_state_sds``, key for
    key (int8 ``wire_q`` (n, k-1, t), fp32 ``wire_scales``
    (n, k-1, t/chunk)), and ``init_fl_state`` builds exactly that."""
    cfg = FLConfig(algorithm=algorithm, q=1, n_nodes=N)
    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=1, n_nodes=N)
    w = mixing_matrix("hospital20", N)
    layout = pack_layout({"p": torch.zeros(N, 1442)}, pad_to=CHUNK)
    _, j_layout = j_pack({"p": np.zeros((N, 1442), np.float32)}, pad_to=CHUNK)
    mine = FusedEngine(w, layout, device="cpu", round_schedule=schedule)
    theirs = j_engine.FusedEngine(w, j_layout, impl="jnp", round_schedule=schedule)
    assert mine.comm_keys(cfg) == theirs.comm_keys(j_cfg)
    spec = mine.comm_state_spec(cfg)
    sds = theirs.comm_state_sds(j_cfg)
    assert list(spec) == list(sds)
    for key, (shape, dtype) in spec.items():
        assert shape == sds[key].shape, key
        assert str(dtype).removeprefix("torch.") == sds[key].dtype.name, key
    state = init_fl_state(cfg, torch.zeros(N, layout.total), mine)
    for key, (shape, dtype) in spec.items():
        assert tuple(state.comm[key].shape) == shape and state.comm[key].dtype == dtype
        assert not torch.any(state.comm[key])
    assert mine.staleness_depth == theirs.staleness_depth
    assert mine.pipelined == theirs.pipelined


@pytest.mark.parametrize("topk", [None, 4, 64, 512])
def test_wire_bytes_equal_across_depths_and_to_reference(topk):
    """The ring holds payloads, it never resends them: one payload per
    wire and edge per round at every depth, to the byte the reference's."""
    w = mixing_matrix("hospital20", N)
    layout = pack_layout({"p": torch.zeros(N, 1442)}, pad_to=CHUNK)
    _, j_layout = j_pack({"p": np.zeros((N, 1442), np.float32)}, pad_to=CHUNK)
    for algorithm in ("dsgd", "dsgt"):
        cfg = FLConfig(algorithm=algorithm, q=1, n_nodes=N)
        j_cfg = j_fl.FLConfig(algorithm=algorithm, q=1, n_nodes=N)
        got = {spec: FusedEngine(w, layout, device="cpu", topk=topk,
                                 round_schedule=spec).wire_bytes(cfg)
               for spec in ["sequential"] + STALE_SCHEDULES}
        assert len(set(got.values())) == 1, got
        want = j_engine.FusedEngine(w, j_layout, topk=topk, impl="jnp").wire_bytes(j_cfg)
        assert got["sequential"] == want
    expected = {None: 167_184, 4: 2 * 54 * 3 * (4 + 8 + 4), 64: 42_768, 512: 167_184}
    assert got["sequential"] == expected[topk]


def test_topk_accounting_matches_reference():
    """``compact_pos_dtype`` / ``bitmap_bytes_per_chunk`` /
    ``compact_index_bytes`` / ``flat_wire_bytes`` == the reference's over
    chunks with and without a byte-aligned bitmap and on both sides of
    the position/bitmap boundary."""
    layout = pack_layout({"p": torch.zeros(4, 1000)}, pad_to=8)
    _, j_layout = j_pack({"p": np.zeros((4, 1000), np.float32)}, pad_to=8)
    for chunk in (8, 12, 100, 512, 40_000):
        assert (torch.iinfo(packing.compact_pos_dtype(chunk)).bits
                == np.dtype(j_packing.compact_pos_dtype(chunk)).itemsize * 8)
        assert packing.bitmap_bytes_per_chunk(chunk) == j_packing.bitmap_bytes_per_chunk(chunk)
        for k in (1, 2, 4, 31, 32, 33, 64, 511, 512, 600):
            assert packing.compact_index_bytes(chunk, k) == \
                j_packing.compact_index_bytes(chunk, k), (chunk, k)
            for degree in (1, 3):
                assert packing.flat_wire_bytes(layout, degree, chunk, k) == \
                    j_packing.flat_wire_bytes(j_layout, degree, chunk, k), (chunk, k)
        assert packing.flat_wire_bytes(layout, 2, chunk) == \
            j_packing.flat_wire_bytes(j_layout, 2, chunk)


def test_schedule_registry_matches_reference():
    """Names, specs and depths as the reference's; bad specs refused with
    the reference's message."""
    assert schedule_names() == j_engine.schedule_names()
    for spec in (None, "sequential", "pipelined", "bounded_staleness",
                 "bounded_staleness:k=1", "bounded_staleness:k=3",
                 "bounded_staleness: k=4"):
        mine, theirs = resolve_schedule(spec), j_engine.resolve_schedule(spec)
        assert (mine.name, mine.depth, mine.spec()) == \
            (theirs.name, theirs.depth, theirs.spec()), spec
        assert resolve_schedule(mine.spec()).spec() == mine.spec()
    assert resolve_schedule(resolve_schedule("pipelined")).name == "pipelined"
    for bad in ("bounded_staleness:k=0", "bounded_staleness:k=-1",
                "bounded_staleness:k=x", "bounded_staleness:k", "pipelined:k=2",
                "bounded_staleness:depth=2", "nope", "nope:k=1"):
        with pytest.raises(ValueError) as theirs:
            j_engine.resolve_schedule(bad)
        with pytest.raises(ValueError) as mine:
            resolve_schedule(bad)
        assert str(mine.value) == str(theirs.value), bad


def test_learning_rate_schedules_match_reference():
    """``theorem1_schedule`` and ``scaled`` to the reference's fp32 value
    (outside ``jit``, both IEEE), ``robust_alpha_scale`` exactly, and the
    trainer's ``"theorem1"`` branch."""
    for n, c in ((20, 0.02), (7, 0.5)):
        mine, theirs = schedules.theorem1_schedule(n, c), j_schedules.theorem1_schedule(n, c)
        base = schedules.inv_sqrt(0.02)
        half, j_half = schedules.scaled(base, 0.5), j_schedules.scaled(
            j_schedules.inv_sqrt(0.02), 0.5)
        for r in (0, 1, 2, 3, 10, 99, 1000):
            assert mine(r) == np.float32(theirs(np.int32(r))), (n, c, r)
            assert half(r) == np.float32(j_half(np.int32(r))), r
            assert isinstance(mine(r), np.float32) and isinstance(half(r), np.float32)
    for uptime in (1.0, 0.9, 0.5):
        for k in (0, 1, 2, 4):
            assert schedules.robust_alpha_scale(uptime, k) == \
                j_schedules.robust_alpha_scale(uptime, k)
    for bad in (dict(uptime=0.0), dict(uptime=1.5), dict(staleness_depth=-1)):
        with pytest.raises(ValueError):
            j_schedules.robust_alpha_scale(**bad)
        with pytest.raises(ValueError):
            schedules.robust_alpha_scale(**bad)
    run = FLRunConfig(schedule="theorem1", n_nodes=20, alpha0=0.02)
    j_run = JFLRunConfig(schedule="theorem1", n_nodes=20, alpha0=0.02)
    assert make_schedule(run)(5) == np.float32(j_trainer.make_schedule(j_run)(np.int32(5)))


def test_adaptive_topk_matches_reference():
    """On one residual trace that hovers around the densify threshold,
    the port's ``AdaptiveTopK`` gives the reference's k per round, switch
    count and dense-round count; spec validation matches too."""
    high, low = 3e-3, 1.5e-3
    trace = [9e-3, 3.2e-3, 2.9e-3, 3.1e-3, 2.8e-3, 3.05e-3, 2.6e-3,
             2.2e-3, 1.8e-3, 1.4e-3, 9e-4, 8e-4, 7e-4, 4e-3, 2e-3]
    for spec in ((64, 512, high, low), (64, 512, high), (8, 32, 2e-3, 1e-3)):
        mine, theirs = AdaptiveTopK(spec, 512), j_trainer.AdaptiveTopK(spec, 512)
        ks, j_ks = [], []
        for rms in trace:
            ks.append(mine.current_k)
            j_ks.append(theirs.current_k)
            mine.update(rms)
            theirs.update(rms)
        assert ks == j_ks, spec
        assert (mine.switches, mine.dense_rounds, mine.rounds, mine.dense_topk) == \
            (theirs.switches, theirs.dense_rounds, theirs.rounds, theirs.dense_topk)
    assert AdaptiveTopK((64, 512, high, low), 512).switches == 0
    with pytest.raises(ValueError, match="low <= high"):
        AdaptiveTopK((64, 512, 1e-3, 2e-3), scale_chunk=512)
    for spec in (None, ehr_mlp.TOPK_SCHEDULE, (8, 32, 0.5, 0.2), ("8", "32", "0.5")):
        assert ehr_mlp.topk_schedule(spec) == j_ehr_mlp.topk_schedule(spec)
    assert ehr_mlp.TOPK_SCHEDULE == j_ehr_mlp.TOPK_SCHEDULE
    for bad in ((64, 512), (0, 512, 1e-3), (64, 32, 1e-3), (64, 512, 1e-3, 2e-3)):
        with pytest.raises(ValueError):
            j_ehr_mlp.topk_schedule(bad)
        with pytest.raises(ValueError):
            ehr_mlp.topk_schedule(bad)


def _ehr_run(algorithm="dsgt", q=2):
    return FLRunConfig(algorithm=algorithm, q=q, topology="hospital20", n_nodes=N,
                       batch_per_node=20, alpha0=0.02)


def test_trainer_refusals_and_sugar():
    """``staleness_depth`` with ``round_schedule`` is refused, as is
    ``topk`` with ``topk_schedule``; ``staleness_depth=k`` builds the
    bounded schedule (0: sequential); ``robust_alpha`` shrinks alpha by
    2 / (2 + k)."""
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, _init()), device="cpu")
    loss = make_mlp_loss(ehr_mlp.class_weights())

    def train(rounds=1, **kw):
        batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
        return train_decentralized(loss, init, _ehr_run(), batcher, rounds=rounds,
                                   engine="fused", device="cpu", **kw)

    with pytest.raises(ValueError, match="not both"):
        train(round_schedule="pipelined", staleness_depth=2)
    with pytest.raises(ValueError, match="not both"):
        train(topk=4, topk_schedule=(4, 512, 1e-3))
    with pytest.raises(ValueError, match="k=0 must be >= 1"):
        train(round_schedule="bounded_staleness:k=0")
    assert train(staleness_depth=0).engine.round_schedule.spec() == "sequential"
    plain = train(rounds=2, staleness_depth=3)
    assert plain.engine.round_schedule.spec() == "bounded_staleness:k=3"
    robust = train(rounds=2, staleness_depth=3, robust_alpha=True)
    np.testing.assert_allclose(robust.history.column("alpha"),
                               plain.history.column("alpha") * 2 / 5, rtol=1e-6)
    assert set(plain.state.comm) == {"recon", "residual", "recon_t", "residual_t",
                                     "wire_q", "wire_scales", "wire_q_t",
                                     "wire_scales_t"}


def test_adaptive_topk_trainer_matches_reference():
    """``train_decentralized(topk_schedule=...)`` on the EHR problem: the
    same k per round and wire bytes as the reference trainer, the two
    round functions sharing one state, and the ``topk`` /
    ``ef_residual_rms`` history columns."""
    rounds, spec = 6, (64, 512, 3e-3)
    init = _init()
    data = j_cohort(seed=0)
    ref = j_trainer.train_decentralized(
        j_make_mlp_loss(j_ehr_mlp.class_weights()), init, JFLRunConfig(
            algorithm="dsgt", q=2, topology="hospital20", n_nodes=N,
            batch_per_node=20, alpha0=0.02),
        j_batcher(data, m=20, seed=1), rounds=rounds, engine="fused",
        scale_chunk=CHUNK, topk_schedule=spec)
    mine = train_decentralized(
        make_mlp_loss(ehr_mlp.class_weights()),
        params_from_numpy(jax.tree_util.tree_map(np.asarray, init), device="cpu"),
        _ehr_run(), make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1),
        rounds=rounds, engine="fused", topk_schedule=spec, device="cpu")
    ks = mine.history.column("topk")
    np.testing.assert_array_equal(ks, ref.history.column("topk"))
    assert 64 in ks and 512 in ks  # both wires ran
    np.testing.assert_array_equal(mine.history.column("comm_bytes"),
                                  ref.history.column("comm_bytes"))
    np.testing.assert_allclose(mine.history.column("ef_residual_rms"),
                               ref.history.column("ef_residual_rms"), rtol=1e-3)
    np.testing.assert_allclose(mine.history.column("loss"),
                               ref.history.column("loss"), rtol=1e-3)


def test_example_prints_the_schedule_and_topk_wire(capsys):
    """The example's banner names the schedule and the wire bytes; with
    ``topk=64`` it reports the reference's 42,768 B and 14.57x, under
    bounded staleness the dense 167,184 B."""
    out = run_fused_engine(rounds=2, q=2, topk=64, device="cpu")
    printed = capsys.readouterr().out
    assert "schedule=sequential" in printed and "wire=42,768 B/round" in printed
    assert "comm_bytes/round=42,768 (top-64 wire) vs 622,944 (fp32 wire)" in printed
    assert "wire saving: 14.57x" in printed
    assert out["wire_bytes"] == 42_768 and out["dense_rounds"] is None
    out = run_fused_engine(rounds=3, q=2, fl_schedule="bounded_staleness:k=2",
                           device="cpu")
    printed = capsys.readouterr().out
    assert "schedule=bounded_staleness:k=2" in printed
    assert "comm_bytes/round=167,184 (int8 wire)" in printed
    assert np.isfinite(out["losses"]).all()
    out = run_fused_engine(rounds=4, q=2, topk_schedule=ehr_mlp.topk_schedule(),
                           device="cpu")
    printed = capsys.readouterr().out
    assert "densified to k=512" in printed and out["dense_rounds"] >= 1
