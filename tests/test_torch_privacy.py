"""The PyTorch port's privacy axis (``repro_torch.core.privacy``, the DP
epilogue of the gossip wrappers and twins, the engines' hooks, the
privacy driver) against the JAX package's.

* The spec grammar: round trip, canonical strings and ``init_key`` equal
  to the reference's; the reference's validation errors.
* The bit arithmetic: ``pair_index``, ``pad_bits``, ``mask_buffer`` and
  ``mask_wire`` bitwise the reference's on every wire dtype; mask then
  unmask the identity; the pads antisymmetric.
* ``dp_noise``: its hashed uniforms bitwise the reference's; the Gaussian
  within 1e-5 at scale 1 (log, cos and sqrt are the only inexact steps);
  rows drawn per rank bitwise the whole draw.
* The accountants: ``rdp_epsilon`` and ``analytic_epsilon`` equal to the
  reference's; ``epsilon_traced`` within fp32 rounding.
* The DP twins and wrappers against the reference's twins and Pallas
  kernels (interpret mode), the DP fused round against the reference's
  ``FusedEngine`` after one round within 1e-5 (DSGD and DSGT),
  ``secure_agg`` bitwise the unmasked run, the sharded DP round equal to
  the fused one within 1e-5.
* The refusals, with the reference's messages.
* ``privacy_ehr.run`` against the reference driver from the same init,
  and against the committed ``experiments/privacy_ehr.json``.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.privacy_ehr as j_privacy_ehr  # noqa: E402
from repro.configs.ehr_mlp import class_weights as j_class_weights  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core import privacy as jp  # noqa: E402
from repro.core.packing import pack as j_pack  # noqa: E402
from repro.core.schedules import inv_sqrt as j_inv_sqrt  # noqa: E402
from repro.kernels.gossip import ops as j_ops  # noqa: E402
from repro.kernels.gossip import ref as j_ref  # noqa: E402
from repro.models.mlp import make_mlp_loss as j_make_mlp_loss  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro.training.trainer import stack_for_nodes as j_stack_for_nodes  # noqa: E402
from repro_torch.benchmarks import privacy_ehr  # noqa: E402
from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core import privacy as tp  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FlatEngine,
    FusedEngine,
    ShardedFusedEngine,
    TreeEngine,
)
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.kernels.gossip import ops, ref  # noqa: E402
from repro_torch.launch.mesh import start_group, stop_group  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss  # noqa: E402
from repro_torch.training.trainer import stack_batches, stack_for_nodes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
N, CHUNK = 20, 512
DP = "dp:sigma=0.5,clip=1.0"


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _u32(x):
    """A uint32 word array from either package (the port holds it in
    int64)."""
    return np.asarray(_np(x)).astype(np.int64) & 0xFFFFFFFF


# ---------------------------------------------------------------------------
# the spec
# ---------------------------------------------------------------------------

SPECS = ["none", "secure_agg", "secure_agg:seed=7", "dp:sigma=0.5,clip=1.0",
         "dp:sigma=0.5,clip=1.0,delta=1e-6", "dp:sigma=0.5,clip=1.0,seed=3",
         "secure_agg+dp:sigma=0.25,clip=2.0"]


@pytest.mark.parametrize("spec", SPECS)
def test_spec_roundtrip(spec):
    """``parse_privacy(p.spec()) == p``, the canonical string and the base
    key equal to the reference's."""
    p, jspec = tp.parse_privacy(spec), jp.parse_privacy(spec)
    assert tp.parse_privacy(p.spec()) == p
    assert p.spec() == jspec.spec()
    assert (p.secure_agg, p.dp_sigma, p.dp_clip, p.delta, p.seed) == (
        jspec.secure_agg, jspec.dp_sigma, jspec.dp_clip, jspec.delta, jspec.seed)
    assert np.array_equal(p.init_key(), jspec.init_key())
    assert p.init_key().dtype == np.uint32


@pytest.mark.parametrize("spec", [
    "bogus", "secure_agg:p=2", "dp:clip=1.0", "dp:sigma=0.5", "dp:sigma=-1,clip=1.0",
    "dp:sigma=0.5,clip=1.0,delta=2", "dp:sigma=0.5,clip=1.0,rho=3",
])
def test_spec_validation_errors(spec):
    with pytest.raises(ValueError):
        jp.parse_privacy(spec)
    with pytest.raises(ValueError):
        tp.parse_privacy(spec)


def test_resolve_privacy():
    assert tp.resolve_privacy(None) is tp.NONE
    p = tp.PrivacySpec(secure_agg=True)
    assert tp.resolve_privacy(p) is p
    assert tp.resolve_privacy("secure_agg") == p
    with pytest.raises(TypeError):
        tp.resolve_privacy(3)
    assert not tp.NONE.active and not tp.NONE.needs_rng
    assert tp.parse_privacy(DP).dp and tp.parse_privacy(DP).needs_rng
    assert (tp.PAD_STREAM, tp.NOISE_STREAM, tp.TRACKER_STREAM_OFFSET) == (
        jp.PAD_STREAM, jp.NOISE_STREAM, jp.TRACKER_STREAM_OFFSET)


# ---------------------------------------------------------------------------
# the bit arithmetic
# ---------------------------------------------------------------------------

KEYS = [tp.PrivacySpec(seed=s).init_key() for s in (0, 1, 12345)] + [
    np.array([0xFFFFFFFF, 0x80000000], np.uint32)]


@pytest.mark.parametrize("key", KEYS, ids=range(len(KEYS)))
def test_pad_bits_and_pair_index_bitwise(key):
    rng = np.random.default_rng(1)
    a = rng.integers(0, 64, size=(40,))
    b = rng.integers(0, 64, size=(40,))
    assert np.array_equal(_np(tp.pair_index(torch.as_tensor(a), torch.as_tensor(b), 64)),
                          np.asarray(jp.pair_index(jnp.asarray(a), jnp.asarray(b), 64)))
    pair = rng.integers(0, 4096, size=(40, 1)).astype(np.int32)
    idx = np.concatenate([np.arange(100), [2**31 - 1, 2**31, 2**32 - 1]]).astype(np.uint32)
    for r in (0, 7, 2**31 - 1, -3):
        for stream in (jp.PAD_STREAM, jp.PAD_STREAM + 2, jp.NOISE_STREAM + 9):
            got = tp.pad_bits(torch.as_tensor(key.astype(np.int64)), r,
                              torch.as_tensor(pair), torch.as_tensor(idx.astype(np.int64))[None],
                              stream)
            want = jp.pad_bits(jnp.asarray(key), jnp.int32(r), jnp.asarray(pair),
                               jnp.asarray(idx)[None], stream)
            assert np.array_equal(_u32(got), _u32(want)), (r, stream)


_WIRE_DTYPES = (np.int8, np.int16, np.int32, np.float32, np.uint8)


def _wire(rng, rows, width):
    """One buffer per maskable wire dtype (q, pos, scales, bitmap)."""
    out = []
    for dt in _WIRE_DTYPES:
        if dt == np.float32:
            a = rng.normal(size=(rows, width)).astype(np.float32)
        elif dt == np.uint8:
            a = rng.integers(0, 256, size=(rows, width)).astype(np.uint8)
        else:
            info = np.iinfo(dt)
            a = rng.integers(info.min, info.max, size=(rows, width), endpoint=True).astype(dt)
        out.append(a)
    return out


def _bits(a):
    a = np.ascontiguousarray(_np(a))
    return a.view(np.uint8)


@pytest.mark.parametrize("unmask", [False, True])
def test_mask_wire_bitwise_and_exact_inverse(unmask):
    """Every buffer of a wire masked (or unmasked) bitwise as the
    reference does; mask then unmask is the identity; the two directions
    of an edge carry opposite pads (their masks cancel)."""
    rng = np.random.default_rng(2)
    rows, width, n = 6, 37, 9
    wire = _wire(rng, rows, width)
    key = tp.PrivacySpec(seed=5).init_key()
    src, dst = rng.integers(0, n, size=rows), rng.integers(0, n, size=rows)
    pair, lt = (src * n + dst) % (n * n), src < dst
    got = tp.mask_wire([torch.as_tensor(b) for b in wire], torch.as_tensor(key.astype(np.int64)),
                       3, torch.as_tensor(pair), torch.as_tensor(lt), unmask=unmask)
    want = jp.mask_wire(tuple(jnp.asarray(b) for b in wire), jnp.asarray(key), jnp.int32(3),
                        jnp.asarray(pair), jnp.asarray(lt), unmask=unmask)
    for g, w_, b in zip(got, want, wire):
        assert g.dtype == torch.from_numpy(b).dtype
        assert np.array_equal(_bits(g), _bits(w_)), b.dtype
    back = tp.mask_wire(got, torch.as_tensor(key.astype(np.int64)), 3, torch.as_tensor(pair),
                        torch.as_tensor(lt), unmask=not unmask)
    for g, b in zip(back, wire):
        assert np.array_equal(_bits(g), _bits(b)), b.dtype
    # the other direction of each edge: its mask is the inverse pad
    other = tp.mask_wire([torch.as_tensor(b) for b in wire], torch.as_tensor(key.astype(np.int64)),
                         3, torch.as_tensor(pair), torch.as_tensor(~lt), unmask=not unmask)
    for g, o, b in zip(got, other, wire):
        if b.dtype != np.uint8:
            assert np.array_equal(_bits(g), _bits(o)), b.dtype
    with pytest.raises(ValueError, match="no mask rule"):
        tp.mask_buffer(torch.zeros(2, 2, dtype=torch.float64), torch.zeros(2, 2,
                       dtype=torch.int64), True)


# ---------------------------------------------------------------------------
# DP noise and the accountants
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("r", [0, 1, 77])
def test_dp_noise_matches_the_reference(r):
    """The hashed uniforms bitwise; the Gaussian within 1e-5 at scale 1;
    a rank's rows of the draw bitwise the whole draw's."""
    key = tp.PrivacySpec(seed=3).init_key()
    tkey = torch.as_tensor(key.astype(np.int64))
    width, n = 1536, N
    ids = torch.arange(n)
    idx = (ids[:, None] * width + torch.arange(width)[None]) & 0xFFFFFFFF
    for stream in (tp.NOISE_STREAM, tp.NOISE_STREAM + 1,
                   tp.NOISE_STREAM + tp.TRACKER_STREAM_OFFSET):
        got = tp._u01_bits(tkey, r, idx, stream)
        want = jp._u01_bits(jnp.asarray(key), jnp.int32(r),
                            jnp.asarray(_np(idx).astype(np.uint32)), stream)
        assert np.array_equal(_np(got).view(np.int32), np.asarray(want).view(np.int32))
    z = tp.dp_noise(tkey, r, ids, width, 1.0)
    jz = jp.dp_noise(jnp.asarray(key), jnp.int32(r), jnp.arange(n), width, 1.0)
    assert z.dtype == torch.float32 and z.shape == (n, width)
    np.testing.assert_allclose(_np(z), np.asarray(jz), rtol=0, atol=1e-5)
    whole = tp.dp_noise(tkey, r, ids, width, 0.5)
    parts = torch.cat([tp.dp_noise(tkey, r, torch.arange(a, a + 5), width, 0.5)
                       for a in range(0, n, 5)])
    assert torch.equal(parts, whole)
    assert abs(float(whole.std()) - 0.5) < 0.01 and abs(float(whole.mean())) < 0.01


@pytest.mark.parametrize("sigma, steps, delta", [(0.25, 12, 1e-5), (0.5, 12, 1e-5),
                                                 (1.0, 160, 1e-6), (2.0, 1, 1e-5),
                                                 (0.0, 3, 1e-5), (0.5, 0, 1e-5)])
def test_accountants_equal_the_references(sigma, steps, delta):
    assert tp.rdp_epsilon(sigma, steps, delta) == jp.rdp_epsilon(sigma, steps, delta)
    assert tp.analytic_epsilon(sigma, steps, delta) == jp.analytic_epsilon(sigma, steps,
                                                                             delta)
    if sigma > 0:
        got = float(tp.epsilon_traced(sigma, steps, delta))
        assert got == float(jp.epsilon_traced(sigma, steps, delta))
        want = tp.analytic_epsilon(sigma, steps, delta)
        assert abs(got - want) <= 4 * np.finfo(np.float32).eps * max(want, 1.0)


# ---------------------------------------------------------------------------
# the DP twins and wrappers
# ---------------------------------------------------------------------------


def _dp_inputs(n, t, wires, seed):
    rng = np.random.default_rng(seed)
    mults = [1.0, 1.0, 1.0, 0.1] if wires == 1 else [1.0, 0.3, 0.5, 0.5, 1.0, 0.1, 1.0, 0.1]
    bufs = [np.asarray(m * rng.normal(size=(n, t)), np.float32) for m in mults]
    noises = [np.asarray(0.05 * rng.normal(size=(n, t)), np.float32) for _ in range(wires)]
    return bufs, noises


# (port wrapper, port twin, reference wrapper, reference twin, wires, topk, extra)
WRAPPERS = [
    ("fused_round", 1, None, {}), ("fused_round", 1, 4, {}),
    ("fused_round_gt", 2, None, {}), ("fused_round_gt", 2, 4, {}),
    ("wire_stage", 1, None, {}), ("wire_stage_gt", 2, 4, {}),
    ("wire_stage_compact", 1, 4, {}), ("wire_stage_compact", 1, 4, {"bitmap": True}),
    ("wire_stage_gt_compact", 2, 4, {}), ("wire_stage_gt_compact", 2, 6, {"bitmap": True}),
]


def _weights(n):
    w = mixing_matrix("ring", n)
    return (np.asarray(w - np.diag(np.diag(w)), np.float32),
            np.asarray(np.diag(w), np.float32))


@pytest.mark.parametrize("name, wires, topk, extra", WRAPPERS,
                         ids=[f"{w[0]}-k{w[2]}{'-bitmap' if w[3] else ''}" for w in WRAPPERS])
def test_dp_wrappers_and_twins_match_the_reference(name, wires, topk, extra):
    """On (8, 48) at chunk 16 with clip 1.0 (it binds: the payload's norm
    is about 7): the port's twin with the DP arguments against the
    reference's twin, and the port's wrapper (residual substitution on
    the twin) against the reference's wrapper (residual substitution on
    the Pallas kernel, interpret mode) -- every output within 1e-5, the
    int8 payloads and the index buffers equal."""
    n, t = 8, 48
    bufs, noises = _dp_inputs(n, t, wires, seed=3)
    kw = dict(scale_chunk=16, topk=topk, dp_clip=1.0, **extra)
    args = list(bufs)
    if name.startswith("fused"):
        args += list(_weights(n))
    alpha = np.float32(0.1)
    dp = dict(dp_noise=noises[0]) if wires == 1 else dict(dp_noise=noises[0],
                                                            dp_noise_t=noises[1])
    targs = [torch.as_tensor(a) for a in args] + [alpha]
    jargs = [jnp.asarray(a) for a in args] + [jnp.float32(alpha)]
    tdp = {k: torch.as_tensor(v) for k, v in dp.items()}
    jdp = {k: jnp.asarray(v) for k, v in dp.items()}
    outs = {
        "port twin": getattr(ref, name + "_ref")(*targs, **kw, **tdp),
        "port wrapper": getattr(ops, name)(*targs, **kw, **tdp),
    }
    ref_kw = {k: v for k, v in kw.items() if k != "bitmap"}
    twin = list(getattr(j_ref, name + "_ref")(*jargs, **ref_kw, **jdp))
    if extra.get("bitmap"):  # the reference's twin emits positions
        starts = (1,) if wires == 1 else (2, 7)
        for i in starts:
            twin[i], twin[i + 1] = j_ref.compact_to_bitmap(twin[i], twin[i + 1], 16, topk)
    wants = {"port twin": twin,
             "port wrapper": getattr(j_ops, name)(*jargs, **kw, **jdp)}
    for what, got in outs.items():
        want = wants[what]
        assert len(got) == len(want)
        for i, (g, w_) in enumerate(zip(got, want)):
            g, w_ = _np(g), np.asarray(w_)
            if g.dtype.kind in "iu":
                assert np.array_equal(g.astype(np.int64), w_.astype(np.int64)), (what, i)
            else:
                np.testing.assert_allclose(g, w_, rtol=0, atol=1e-5, err_msg=f"{what} {i}")
    # the wrapper's substitution equals the direct epilogue within rounding
    for g, w_ in zip(outs["port wrapper"], outs["port twin"]):
        if g.dtype.is_floating_point:
            np.testing.assert_allclose(_np(g), _np(w_), rtol=0, atol=1e-5)


def test_dp_wrapper_arguments_are_validated():
    x, g, recon, res = (torch.as_tensor(b) for b in _dp_inputs(8, 48, 1, seed=0)[0])
    z = torch.zeros_like(x)
    with pytest.raises(ValueError, match="error_feedback=True"):
        ops.wire_stage(x, g, recon, res, 0.1, scale_chunk=16, error_feedback=False,
                       dp_clip=1.0, dp_noise=z)
    with pytest.raises(ValueError, match="error_feedback=True"):
        ref.wire_stage_ref(x, g, recon, res, 0.1, scale_chunk=16, error_feedback=False,
                           dp_clip=1.0, dp_noise=z)
    with pytest.raises(ValueError, match="needs dp_clip"):
        ops.wire_stage(x, g, recon, res, 0.1, scale_chunk=16, dp_noise=z)
    with pytest.raises(ValueError, match="expected"):
        ops.wire_stage(x, g, recon, res, 0.1, scale_chunk=16, dp_clip=1.0,
                       dp_noise=z[:, :16].contiguous())


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------


def _reference_init():
    return j_mlp_init(jax.random.key(0))


def _port_round(algorithm, privacy, schedule="sequential", q=10, topk=None):
    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, _reference_init()),
                             device="cpu")
    cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=N)
    eng, flat = FusedEngine.simulated(mixing_matrix("hospital20", N),
                                      stack_for_nodes(init, N), scale_chunk=CHUNK,
                                      privacy=privacy, round_schedule=schedule, topk=topk)
    rf = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02), cfg, eng)
    return eng, rf, init_fl_state(cfg, flat, eng)


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_dp_fused_round_matches_the_reference_engine(algorithm):
    """The paper's problem under ``dp:sigma=0.5,clip=1.0``: one round on
    the port's ``FusedEngine`` against the reference's (Pallas, interpret
    mode) within 1e-5 on params, tracker and wire state; the counters
    (``topo_round``, ``priv_key``) equal; ``dp_epsilon`` equal."""
    j_cfg = j_fl.FLConfig(algorithm=algorithm, q=10, n_nodes=N)
    j_flat, j_layout = j_pack(j_stack_for_nodes(_reference_init(), N), pad_to=CHUNK)
    j_eng = j_engine.FusedEngine(mixing_matrix("hospital20", N), j_layout, scale_chunk=CHUNK,
                                 impl="pallas", privacy=DP)
    j_round = jax.jit(j_fl.make_fl_round(j_make_mlp_loss(j_class_weights()), None,
                                         j_inv_sqrt(0.02), j_cfg, engine=j_eng))
    j_state = j_fl.init_fl_state(j_cfg, j_flat, engine=j_eng)
    eng, rf, state = _port_round(algorithm, DP)
    assert list(eng.comm_keys(FLConfig(algorithm=algorithm, q=10, n_nodes=N))) == list(
        j_eng.comm_keys(j_cfg))
    batches = stack_batches(make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1), 10)
    state, m = rf(state, batches)
    j_state, jm = j_round(j_state, batches)
    np.testing.assert_allclose(_np(state.params), np.asarray(j_state.params), rtol=0,
                               atol=1e-5)
    if algorithm == "dsgt":
        np.testing.assert_allclose(_np(state.tracker), np.asarray(j_state.tracker), rtol=0,
                                   atol=1e-5)
    for k in state.comm:
        if k in ("topo_round", "priv_key"):
            assert np.array_equal(_u32(state.comm[k]), _u32(j_state.comm[k])), k
        else:
            np.testing.assert_allclose(_np(state.comm[k]), np.asarray(j_state.comm[k]),
                                       rtol=0, atol=1e-5, err_msg=k)
    assert float(m["dp_epsilon"]) == float(jm["dp_epsilon"])
    wires = 2 if algorithm == "dsgt" else 1
    assert abs(float(m["dp_epsilon"]) - tp.analytic_epsilon(0.5, wires, 1e-5)) < 1e-5


@pytest.mark.parametrize("schedule", ["sequential", "bounded_staleness:k=2"])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_secure_agg_is_bitwise_the_unmasked_run(algorithm, schedule):
    """On the fused engine the pads are a no-op: three rounds under
    ``secure_agg`` (and ``secure_agg+dp``) are bitwise the runs without
    it, with the same comm state; the DP run's noise moves the state."""
    finals = {}
    for spec in (None, "secure_agg", DP, "secure_agg+" + DP):
        eng, rf, state = _port_round(algorithm, spec, schedule, q=3)
        batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
        for _ in range(3):
            state, m = rf(state, stack_batches(batcher, 3))
        finals[spec] = (state, m)
    for masked, plain in (("secure_agg", None), ("secure_agg+" + DP, DP)):
        (s1, m1), (s0, m0) = finals[masked], finals[plain]
        assert torch.equal(s1.params, s0.params)
        assert set(s1.comm) == set(s0.comm)
        assert all(torch.equal(s1.comm[k], s0.comm[k]) for k in s0.comm)
        assert {k: float(v) for k, v in m1.items()} == {k: float(v) for k, v in m0.items()}
    assert "priv_key" not in finals["secure_agg"][0].comm
    assert not torch.equal(finals[DP][0].params, finals[None][0].params)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    g = start_group(0, 1, str(tmp_path_factory.mktemp("store") / "store"), device="cpu")
    yield g
    stop_group(g)


@pytest.mark.parametrize("topk", [None, 64, 16])
@pytest.mark.parametrize("schedule", ["sequential", "pipelined"])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_sharded_dp_round_equals_the_fused_round(group, algorithm, schedule, topk):
    """``sharded_fused`` under dp (each rank draws its rows of the noise)
    on one gloo rank: after one round within 1e-5 of ``FusedEngine`` on
    the dense int8 wire; on the compact wire (top-64 bitmap, top-16
    positions) the loss of three rounds within the compact wire's
    multi-round tolerance (rtol 1e-3, ROADMAP.md queue 3) and
    ``dp_epsilon`` equal."""
    from repro_torch.examples.ehr_federated import run_sharded_engine

    init = params_from_numpy(jax.tree_util.tree_map(np.asarray, _reference_init()),
                             device="cpu")
    rounds = 1 if topk is None else 3
    sh = run_sharded_engine(group, rounds=rounds, q=10, algorithm=algorithm, topk=topk,
                            fl_schedule=schedule, privacy=DP, init_params=init, log=False)
    eng, rf, state = _port_round(algorithm, DP, schedule, topk=topk)
    batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=20, seed=1)
    losses = []
    for _ in range(rounds):
        state, m = rf(state, stack_batches(batcher, 10))
        losses.append(float(m["loss"]))
    assert "priv_key" in sh["state"].comm
    assert float(sh["metrics"]["dp_epsilon"]) == float(m["dp_epsilon"])
    np.testing.assert_allclose(sh["losses"], losses, rtol=1e-3)
    if topk is None:
        np.testing.assert_allclose(_np(sh["state"].params), _np(state.params), rtol=0,
                                   atol=1e-5)
        if algorithm == "dsgt":
            np.testing.assert_allclose(_np(sh["state"].tracker), _np(state.tracker), rtol=0,
                                       atol=1e-5)


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    raise AssertionError("no ValueError")


def test_refusals_carry_the_references_messages(group):
    """dp on ``tree`` and ``flat``; any active spec on ``tree``;
    ``secure_agg`` on ``sharded_fused``'s dense all-gather wire; dp with
    a per-node wire k; dp without error feedback -- each the reference's
    ValueError and message. ``secure_agg`` on ``flat`` builds."""
    w = mixing_matrix("ring", 4)
    stacked = {"p": torch.zeros(4, 6)}
    jstacked = {"p": jnp.zeros((4, 6))}
    for spec in (DP, "secure_agg"):
        assert _message(lambda: TreeEngine.simulated(w, stacked, privacy=spec)) == _message(
            lambda: j_engine.TreeEngine.simulated(w, jstacked, privacy=spec))
    assert _message(lambda: FlatEngine.simulated(w, stacked, privacy=DP)) == _message(
        lambda: j_engine.FlatEngine.simulated(w, jstacked, privacy=DP))
    assert FlatEngine.simulated(w, stacked, privacy="secure_agg")[0].privacy.secure_agg

    params = {"p": torch.zeros(8, 40)}
    mesh = jax.make_mesh((1,), ("data",))
    cases = [dict(privacy="secure_agg"),
             dict(privacy=DP, node_program="slow_uplink", topk=4),
             dict(privacy=DP, error_feedback=False),
             dict(node_program="slow_uplink"),
             dict(node_program="slow_uplink", topk=4, error_feedback=False)]
    for kw in cases:
        mine = _message(lambda: ShardedFusedEngine.from_group(
            group, params, w=np.eye(8), scale_chunk=16, **kw))
        theirs = _message(lambda: j_engine.ShardedFusedEngine.from_mesh(
            mesh, ("data",), {"p": jnp.zeros((1, 40))}, w=np.eye(1), scale_chunk=16,
            impl="jnp", **kw))
        assert mine == theirs, kw


# ---------------------------------------------------------------------------
# the privacy driver
# ---------------------------------------------------------------------------


class _JnpFused:
    """``get_engine("fused")`` for the reference's driver, on the jnp
    oracle."""

    @staticmethod
    def simulated(*args, **kw):
        kw["impl"] = "jnp"
        return j_engine.FusedEngine.simulated(*args, **kw)


def _init(partitionable: bool):
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        return params_from_numpy(jax.tree_util.tree_map(
            np.asarray, j_mlp_init(jax.random.key(0))), device="cpu")
    finally:
        jax.config.update("jax_threefry_partitionable", before)


def _same_row(mine, want, what):
    assert mine["name"] == want["name"] and mine["privacy"] == want["privacy"], what
    for k in ("iterations", "rounds", "q", "wire_bytes_per_round"):
        assert mine[k] == want[k], (what, k)
    assert abs(mine["bal_acc"] - want["bal_acc"]) <= 0.02, (what, mine["bal_acc"],
                                                            want["bal_acc"])
    for k in ("epsilon_rdp", "dp_sigma", "dp_clip", "delta"):
        assert mine.get(k) == want.get(k), (what, k)
    if "epsilon" in want:
        assert abs(mine["epsilon"] - want["epsilon"]) <= 1e-3 * want["epsilon"], what


def test_privacy_driver_matches_the_reference_driver(monkeypatch):
    """The six rows of both drivers' smoke runs from the reference's init
    under the installed jax: iterations, wire bytes and the accountants
    equal, ``bal_acc`` within 0.02; the secure_agg rows equal their
    twins."""
    monkeypatch.setattr(j_privacy_ehr, "get_engine", lambda name: _JnpFused)
    init = _init(jax.config.jax_threefry_partitionable)
    rec = privacy_ehr.run(privacy_ehr.SMOKE_ROUNDS, 10, device="cpu", init_params=init,
                          log=False)
    assert len(rec["rows"]) == 6
    for row in rec["rows"]:
        priv = None if row["privacy"] == "none" else row["privacy"]
        want = j_privacy_ehr.run_cell(row["name"], priv, privacy_ehr.SMOKE_ROUNDS, 10)
        _same_row(row, want, row["name"])


def test_privacy_driver_against_the_committed_json():
    """The committed smoke record (jax 0.4's threefry init): 167,184 wire
    bytes on every row, the secure_agg rows equal to their twins,
    ``epsilon_rdp`` equal, ``bal_acc`` within 0.02 on every row."""
    rec = privacy_ehr.run(privacy_ehr.SMOKE_ROUNDS, 10, device="cpu",
                          init_params=_init(False), log=False)
    want = json.loads((ROOT / "experiments" / "privacy_ehr.json").read_text())
    assert want["smoke"] and len(want["rows"]) == len(rec["rows"]) == 6
    rows = {r["name"]: r for r in rec["rows"]}
    for w_ in want["rows"]:
        _same_row(rows[w_["name"]], w_, w_["name"])
        assert rows[w_["name"]]["wire_bytes_per_round"] == 167_184
    for masked, plain in (("secure_agg", "baseline"), ("dp_sigma=0.5+secure_agg",
                                                       "dp_sigma=0.5")):
        assert rows[masked]["bal_acc"] == rows[plain]["bal_acc"]
        assert rows[masked]["final_loss"] == rows[plain]["final_loss"]


def test_privacy_cli_writes_the_json(tmp_path):
    out = tmp_path / "privacy.json"
    rec = privacy_ehr.main(["--smoke", "--device", "cpu", "--q", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["smoke"] is True and saved["device"] == "cpu"
    assert [r["name"] for r in saved["rows"]] == [r["name"] for r in rec["rows"]]
    want = json.loads((ROOT / "experiments" / "privacy_ehr.json").read_text())
    assert set(saved) - {"device"} == set(want)
    for mine, theirs in zip(saved["rows"], want["rows"]):
        assert set(mine) == set(theirs), mine["name"]
