"""Compressed gossip on the PyTorch port (``repro_torch.core.compression``
and its kernel wrapper ``kernels.gossip.ops.gossip_mix``).

* ``quantize_int8`` / ``dequantize_int8`` and the flat, tree and per-leaf
  compressed gossips against the JAX package's ``repro.core.compression``
  (``impl="jnp"``), from identical numpy inputs.
* ``gossip_mix`` on CPU tensors (its twin) against the reference's Pallas
  kernel ``gossip_mix_pallas`` in interpret mode, as the JAX suite runs it.
* The properties of tests/test_gossip_flat.py: the node mean is preserved
  and difference coding reaches the exact-gossip consensus floor.
* The composition oracle of tests/test_megakernel.py: the flat engine
  with an identity mix, then ``make_compressed_flat_gossip`` on each
  wire, equals the port's ``FusedEngine`` round.
* The CUDA kernel against its twin on the card (``cuda`` marker: these
  skip without one).

Tolerances: ``recon'``, ``res'`` and ``scales`` are chains of rounded fp32
operations in the same order as the jnp oracle's: bitwise against it.
Against interpret-mode Pallas (which contracts ``base + q * scale`` into
an FMA and divides by 127 through a reciprocal, ROADMAP.md queue 3) they
agree within ``STATE_ATOL`` = 1e-6, as in tests/test_torch_wire_stage.py.
``mixed`` holds the n x n contraction, summed in another order: within
``ATOL`` = 1e-5 (the reference suite's). Over several rounds the gossips
are compared one round at a time from the reference's state, because one
ulp of ``mixed`` can move a payload across an int8 rounding boundary. The
composition equals the fused round within ``ATOL`` after one round and
after several (on the CPU both run the same twin arithmetic). On the card
the kernel equals its twin bitwise on everything but ``mixed``, which is
held to ``ATOL``.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.core.compression import (  # noqa: E402
    DEFAULT_SCALE_CHUNK,
    compressed_wire_bytes,
    dequantize_int8,
    init_compression_state,
    init_flat_compression_state,
    make_compressed_dense_gossip,
    make_compressed_dense_gossip_per_leaf,
    make_compressed_flat_gossip,
    quantize_int8,
    zeros_like_residual,
)
from repro_torch.core.engine import FlatEngine, FusedEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.mixing import make_dense_flat_mix  # noqa: E402
from repro_torch.core.packing import pack  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.kernels.gossip import ops, ref  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss, mlp_init  # noqa: E402
from repro_torch.training.trainer import stack_batches, stack_for_nodes  # noqa: E402

ATOL = 1e-5
STATE_ATOL = 1e-6
FLAGS = list(itertools.product([True, False], repeat=3))  # ef, dc, stale
NAMES = ("mixed", "recon", "res", "scales")


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def jax_ref():
    """The JAX package's compression module and Pallas dispatch (imported
    here, so the card-only tests run where JAX is absent)."""
    pytest.importorskip("jax")
    from repro.core import compression as j_comp
    from repro.kernels.gossip import ops as j_ops

    return j_comp, j_ops


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _normal(rng, *shape, scale=1.0):
    return np.asarray(scale * rng.normal(size=shape), np.float32)


def _weights(n, topo="ring", device="cpu"):
    w = mixing_matrix(topo, n)
    return (torch.tensor(np.diag(w), dtype=torch.float32, device=device),
            torch.tensor(w - np.diag(np.diag(w)), dtype=torch.float32, device=device))


def _tie_rows(bufs, chunk, seed):
    """Exact ties at the top-k threshold in (row 0, chunk 0): recon and
    res zero there and x magnitudes 3, 2, 1 (chunk/8 threes, chunk/4
    twos), so top-k at k = chunk/4 keeps chunk/8 + chunk/4 columns."""
    rng = np.random.default_rng(seed)
    mags = np.ones(chunk, np.float32)
    mags[: chunk // 8] = 3.0
    mags[chunk // 8: chunk // 8 + chunk // 4] = 2.0
    pattern = rng.permutation(mags * rng.choice([-1.0, 1.0], size=chunk))
    for b in bufs:
        b[0, :chunk] = 0.0
    bufs[0][0, :chunk] = torch.as_tensor(pattern, dtype=torch.float32)
    return bufs


# ---------------------------------------------------------------------------
# against the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1e-3, 1.0, 30.0])
def test_quantize_int8_matches_reference(jax_ref, scale):
    j_comp, _ = jax_ref
    import jax.numpy as jnp

    rng = np.random.default_rng(int(scale * 1000))
    x = _normal(rng, 6, 3, 5, scale=scale)
    x[2] = 0.0  # an all-zero node: scale 0, safe 1
    q, s = quantize_int8(torch.tensor(x))
    jq, js = j_comp.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8 and q.shape == x.shape
    np.testing.assert_array_equal(_np(q), np.asarray(jq))
    np.testing.assert_array_equal(_np(s), np.asarray(js))
    assert float(s[2]) == 0.0 and torch.all(q[2] == 0)
    np.testing.assert_array_equal(_np(dequantize_int8(q, s)),
                                  np.asarray(j_comp.dequantize_int8(jq, js)))


@pytest.mark.parametrize("topk", [None, 16])
@pytest.mark.parametrize("ef,dc", list(itertools.product([True, False], repeat=2)))
def test_flat_gossip_matches_reference_jnp(jax_ref, ef, dc, topk):
    """Four rounds, each from the reference's state: recon', res' bitwise,
    mixed within ATOL."""
    j_comp, _ = jax_ref
    import jax.numpy as jnp

    n, t, chunk = 16, 256, 64
    w = mixing_matrix("torus:4x4", n)
    rng = np.random.default_rng(10 * ef + dc + (topk or 0))
    x = _normal(rng, n, t)
    kw = dict(error_feedback=ef, difference_coding=dc, scale_chunk=chunk, topk=topk)
    mine = make_compressed_flat_gossip(w, **kw)
    theirs = j_comp.make_compressed_flat_gossip(w, impl="jnp", **kw)
    state = {k: np.zeros((n, t), np.float32) for k in ("recon", "residual")}
    assert all(torch.equal(v, torch.zeros(n, t))
               for v in init_flat_compression_state(torch.tensor(x)).values())
    for _ in range(4):
        got, got_state = mine(torch.tensor(x), {k: torch.tensor(v) for k, v in state.items()})
        want, want_state = theirs(jnp.asarray(x), {k: jnp.asarray(v) for k, v in state.items()})
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0, atol=ATOL)
        for k in ("recon", "residual"):
            np.testing.assert_array_equal(_np(got_state[k]), np.asarray(want_state[k]),
                                          err_msg=k)
        x = np.asarray(want)
        state = {k: np.asarray(v) for k, v in want_state.items()}


def test_tree_and_per_leaf_gossip_match_reference(jax_ref):
    """The tree wrapper of the flat gossip and the per-leaf gossip (per-
    node-per-leaf scales), and the per-leaf wire bytes."""
    j_comp, _ = jax_ref
    import jax.numpy as jnp

    n = 16
    w = mixing_matrix("ring", n)
    rng = np.random.default_rng(4)
    tree = {"a": _normal(rng, n, 40), "b": _normal(rng, n, 3, 7)}
    t_tree = {k: torch.tensor(v) for k, v in tree.items()}
    j_tree = {k: jnp.asarray(v) for k, v in tree.items()}
    for mine, theirs in ((make_compressed_dense_gossip(w, scale_chunk=32),
                          j_comp.make_compressed_dense_gossip(w, scale_chunk=32)),
                         (make_compressed_dense_gossip_per_leaf(w),
                          j_comp.make_compressed_dense_gossip_per_leaf(w))):
        got, got_state = mine(t_tree, init_compression_state(t_tree))
        want, want_state = theirs(j_tree, j_comp.init_compression_state(j_tree))
        for k in tree:
            assert got[k].shape == tree[k].shape
            np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), rtol=0, atol=ATOL)
            for part in ("recon", "residual"):
                np.testing.assert_array_equal(_np(got_state[part][k]),
                                              np.asarray(want_state[part][k]))
    assert compressed_wire_bytes(t_tree, 2) == j_comp.compressed_wire_bytes(j_tree, 2)
    z = zeros_like_residual(t_tree)
    assert all(v.dtype == torch.float32 and not v.any() for v in z.values())
    assert DEFAULT_SCALE_CHUNK == j_comp.DEFAULT_SCALE_CHUNK


# (n, t, chunk, ef, dc, stale, topk): the grid of tests/test_megakernel.py
# plus the main path's (20, 1536, 512), a stale mix and the top-64 wire
PALLAS_CASES = [
    (16, 256, 64, True, True, False, None),
    (8, 512, 128, True, False, False, None),
    (8, 96, 32, False, True, False, None),
    (20, 1536, 512, True, True, False, None),
    (20, 1024, 512, True, True, True, None),
    (20, 1536, 512, True, True, False, 64),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_gossip_mix_twin_matches_pallas(jax_ref, case):
    """``ops.gossip_mix`` on CPU tensors (the twin) == the reference's
    ``gossip_mix`` through Pallas in interpret mode."""
    _, j_ops = jax_ref
    import jax.numpy as jnp

    n, t, chunk, ef, dc, stale, topk = case
    rng = np.random.default_rng(n + chunk)
    x, recon, res = _normal(rng, n, t), _normal(rng, n, t), _normal(rng, n, t, scale=0.1)
    w_self, w_off = _weights(n, "hospital20" if n == 20 else "ring")
    kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
              stale_mix=stale, topk=topk)
    before = ops.gossip_mix.launches
    got = ops.gossip_mix(torch.tensor(x), torch.tensor(recon), torch.tensor(res),
                         w_off, w_self, **kw)
    assert ops.gossip_mix.launches == before  # the twin ran: no launch counted
    want = j_ops.gossip_mix(jnp.asarray(x), jnp.asarray(recon), jnp.asarray(res),
                            jnp.asarray(_np(w_off)), jnp.asarray(_np(w_self)), **kw)
    for i, (name, a, b) in enumerate(zip(NAMES, got, want)):
        assert tuple(a.shape) == tuple(b.shape), name
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0,
                                   atol=ATOL if i == 0 else STATE_ATOL, err_msg=name)


def test_gossip_mix_refusals():
    n, t = 8, 64
    w_self, w_off = _weights(n)
    x = torch.zeros(n, t)
    with pytest.raises(ValueError, match="topk must be >= 1"):
        ops.gossip_mix(x, x, x, w_off, w_self, scale_chunk=32, topk=0)
    with pytest.raises(ValueError, match="multiple of scale_chunk"):
        ops.gossip_mix(x, x, x, w_off, w_self, scale_chunk=48)
    with pytest.raises(TypeError, match="float32"):
        ops.gossip_mix(x.double(), x, x, w_off, w_self, scale_chunk=32)
    with pytest.raises(ValueError, match="do not match"):
        ops.gossip_mix(x, x, x, w_off[:4, :4].contiguous(), w_self, scale_chunk=32)


# ---------------------------------------------------------------------------
# properties (tests/test_gossip_flat.py)
# ---------------------------------------------------------------------------


def test_flat_gossip_mean_preserving():
    """1^T W = 1^T: mixing moves the node average only by the (vanishing)
    quantization drift."""
    n = 16
    w = mixing_matrix("torus:4x4", n)
    flat, _ = pack({"x": torch.tensor(_normal(np.random.default_rng(0), n, 100))},
                   pad_to=64)
    g = make_compressed_flat_gossip(w, scale_chunk=64)
    state = init_flat_compression_state(flat)
    mean0 = flat.mean(0)
    for _ in range(5):
        flat, state = g(flat, state)
    drift = float((flat.mean(0) - mean0).abs().max())
    q_step = float(flat.abs().max()) / 127.0
    assert drift < 5 * q_step


def test_flat_gossip_converges_to_exact_floor():
    """Difference coding reaches the exact-gossip consensus floor (the
    payload's scale vanishes with consensus)."""
    n = 16
    w = mixing_matrix("torus:4x4", n)
    x0 = torch.tensor(_normal(np.random.default_rng(1), n, 64))
    exact = make_dense_flat_mix(w)
    g = make_compressed_flat_gossip(w, scale_chunk=64)
    f_ex, f_df, st = x0, x0, init_flat_compression_state(x0)
    for _ in range(120):
        f_ex = exact(f_ex)
        f_df, st = g(f_df, st)

    def dev(f):
        return float(torch.linalg.norm(f - f.mean(0)))

    assert dev(f_df) < 10 * max(dev(f_ex), 1e-6)


# ---------------------------------------------------------------------------
# the composition == the fused round
# ---------------------------------------------------------------------------


def _quad_loss(p, batch):
    return ((p["w"] - batch["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)


def run_composition(loss, flat, layout, batches, cfg, w, chunk, sched, device):
    """Local steps then compressed gossip: the flat engine with an
    identity mix runs the Q-1 local steps and the bare update / tracker
    arithmetic (an identity-W comm step IS the local update), then each
    wire goes through one ``make_compressed_flat_gossip`` round."""
    rf = make_fl_round(loss, sched, cfg, FlatEngine(lambda f: f, layout, device=device))
    gossip = make_compressed_flat_gossip(w, scale_chunk=chunk)
    st = init_fl_state(cfg, flat)
    comp_x, comp_t = init_flat_compression_state(flat), init_flat_compression_state(flat)
    for b in batches:
        st, _ = rf(st, b)
        px, comp_x = gossip(st.params, comp_x)
        if cfg.algorithm == "dsgt":
            pt, comp_t = gossip(st.tracker, comp_t)
            st = st._replace(params=px, tracker=pt)
        else:
            st = st._replace(params=px)
    return st


def run_fused(loss, flat, layout, batches, cfg, w, chunk, sched, device):
    engine = FusedEngine(w, layout, scale_chunk=chunk, device=device)
    rf = make_fl_round(loss, sched, cfg, engine)
    st = init_fl_state(cfg, flat, engine)
    for b in batches:
        st, _ = rf(st, b)
    return st


def _quad(n, q, rounds, seed, device):
    rng = np.random.default_rng(seed)
    params = {"w": torch.tensor(_normal(rng, n, 4, 3), device=device),
              "b": torch.tensor(_normal(rng, n, 3), device=device)}
    batches = [{"t": _normal(rng, q, n, 4, 3)} for _ in range(rounds)]
    return _quad_loss, params, batches


def _ehr(q, rounds, device):
    data = generate_ehr_cohort(seed=0)
    batcher = make_node_batcher(data, m=20, seed=1)
    params = stack_for_nodes(mlp_init(0, device=device), 20)
    batches = [stack_batches(batcher, q) for _ in range(rounds)]
    return make_mlp_loss(class_weights()), params, batches


def _check_composition(algorithm, problem, device):
    if problem == "ehr":
        n, topo, chunk, q = 20, "hospital20", 512, 10
        loss, params, batches = _ehr(q, 3, device)
    else:
        n, topo, chunk, q = 16, "torus:4x4", 8, 3
        loss, params, batches = _quad(n, q, 4, seed=n + chunk, device=device)
    w = mixing_matrix(topo, n)
    cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=n)
    flat, layout = pack(params, pad_to=chunk)
    sched = inv_sqrt(0.05)
    for rounds in (1, len(batches)):
        st_c = run_composition(loss, flat, layout, batches[:rounds], cfg, w, chunk,
                               sched, device)
        st_f = run_fused(loss, flat, layout, batches[:rounds], cfg, w, chunk, sched,
                         device)
        assert st_c.step == st_f.step == rounds * q
        for part in ("params", "tracker", "prev_grad") if algorithm == "dsgt" else ("params",):
            np.testing.assert_allclose(_np(getattr(st_c, part)), _np(getattr(st_f, part)),
                                       rtol=0, atol=ATOL, err_msg=f"{part} {rounds}")


@pytest.mark.parametrize("problem", ["quadratic", "ehr"])
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_composition_equals_fused_round(algorithm, problem):
    _check_composition(algorithm, problem, "cpu")


# ---------------------------------------------------------------------------
# the kernel on the card
# ---------------------------------------------------------------------------

# (n, t, chunk, topology): the main path, a small ragged shape, n = 64
CUDA_SHAPES = [(20, 1536, 512, "hospital20"), (7, 384, 128, "complete"),
               (64, 4096, 512, "torus:8x8")]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (python3 chip_smoke.py runs the same checks there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
def test_gossip_mix_kernel_matches_twin_on_card(cuda, shape):
    """recon', res' and scales bitwise, mixed within ATOL, for the 8 (ef,
    dc, stale) combinations x topk in {None, chunk/4 with exact ties at
    the threshold, chunk}; one launch counted per call."""
    n, t, chunk, topo = shape
    w_self, w_off = _weights(n, topo, cuda)
    for k, ((ef, dc, stale), topk) in enumerate(
            itertools.product(FLAGS, [None, chunk // 4, chunk])):
        rng = np.random.default_rng(k)
        bufs = [torch.tensor(_normal(rng, n, t, scale=s), device=cuda)
                for s in (1.0, 1.0, 0.1)]
        if topk == chunk // 4:
            bufs = _tie_rows(bufs, chunk, seed=k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        before = ops.gossip_mix.launches
        got = ops.gossip_mix(*bufs, w_off, w_self, **kw)
        want = ref.gossip_mix_ref(*bufs, w_off, w_self, **kw)
        torch.cuda.synchronize()
        assert ops.gossip_mix.launches == before + 1
        assert float((got[0] - want[0]).abs().max()) <= ATOL
        for i in (1, 2, 3):
            assert torch.equal(got[i], want[i]), (NAMES[i], kw)


def _assert_gossip(got, want, bufs, what):
    """recon', res' and scales bitwise; mixed within ATOL x max(1,
    max|input|) (the n x n sum runs in another order)."""
    tol = ATOL * max(1.0, max(float(b.abs().max()) for b in bufs))
    for i, (name, a, b) in enumerate(zip(NAMES, got, want)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), (what, name)
        if i == 0:
            assert float((a - b).abs().max()) <= tol, (what, name)
        else:
            assert torch.equal(a, b), (what, name)


def _card_inputs(n, t, seed, cuda):
    rng = np.random.default_rng(seed)
    return [torch.tensor(_normal(rng, n, t, scale=s), device=cuda) for s in (1.0, 1.0, 0.1)]


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS)
def test_gossip_mix_keeps_every_tie_on_card(cuda, flags):
    """The main shape, top-k at chunk/4 with the tie inputs in (row 0,
    chunk 0): the ties are spread over every cluster block's columns, the
    threshold (2) is found exactly and every tie at it is kept."""
    n, t, chunk = 20, 1536, 512
    ef, dc, stale = flags
    w_self, w_off = _weights(n, "hospital20", cuda)
    bufs = _tie_rows(_card_inputs(n, t, 60, cuda), chunk, seed=1)
    kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
              stale_mix=stale, topk=chunk // 4)
    got = ops.gossip_mix(*bufs, w_off, w_self, **kw)
    want = ref.gossip_mix_ref(*bufs, w_off, w_self, **kw)
    torch.cuda.synchronize()
    _assert_gossip(got, want, bufs, kw)
    # recon and res are zero on (row 0, chunk 0): recon' there is 0 + dq,
    # nonzero exactly on the kept columns
    assert int(torch.count_nonzero(got[1][0, :chunk])) == chunk // 8 + chunk // 4


@pytest.mark.cuda
@pytest.mark.parametrize("flags", FLAGS)
def test_gossip_mix_zero_slice_and_zero_chunk_on_card(cuda, flags):
    """At the main shape every input zero in (row 3, chunk 1) on one
    cluster block's columns only (the row's scale comes from the other
    blocks), and in the whole of (row 5, chunk 2) (scale 0, no step),
    dense and top-64."""
    n, t, chunk = 20, 1536, 512
    c, cols, _ = ops.plan_round(n, t, chunk, None, ops.GOSSIP_STAGE)
    assert c > 1
    ef, dc, stale = flags
    w_self, w_off = _weights(n, "hospital20", cuda)
    for topk in (None, 64):
        bufs = _card_inputs(n, t, 40, cuda)
        for b in bufs:
            b[3, chunk + cols: chunk + 2 * cols] = 0.0
            b[5, 2 * chunk: 3 * chunk] = 0.0
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        got = ops.gossip_mix(*bufs, w_off, w_self, **kw)
        want = ref.gossip_mix_ref(*bufs, w_off, w_self, **kw)
        torch.cuda.synchronize()
        _assert_gossip(got, want, bufs, kw)
        assert float(got[3][5, 2]) == 0.0 and float(got[3][3, 1]) > 0.0


@pytest.mark.cuda
def test_gossip_mix_ragged_unaligned_on_card(cuda):
    """n = 5, t = 90, chunk 30: rows start off 16-byte boundaries (scalar
    copies) and the block's tile is wider than its chunk; every flag
    combination, dense and top-3."""
    n, t, chunk = 5, 90, 30
    w_self, w_off = _weights(n, "complete", cuda)
    for k, ((ef, dc, stale), topk) in enumerate(itertools.product(FLAGS, [None, 3])):
        bufs = _card_inputs(n, t, 80 + k, cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        got = ops.gossip_mix(*bufs, w_off, w_self, **kw)
        want = ref.gossip_mix_ref(*bufs, w_off, w_self, **kw)
        torch.cuda.synchronize()
        _assert_gossip(got, want, bufs, kw)


@pytest.mark.cuda
def test_gossip_mix_128_nodes_on_card(cuda):
    """n = 128 at chunk 512, which the one-block-a-chunk design refused
    (a 256 KB tile), runs and equals the twin, dense and top-64."""
    n, t, chunk = 128, 1024, 512
    w_self, w_off = _weights(n, "ring", cuda)
    for k, ((ef, dc, stale), topk) in enumerate(itertools.product(FLAGS[:4], [None, 64])):
        bufs = _card_inputs(n, t, 100 + k, cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        got = ops.gossip_mix(*bufs, w_off, w_self, **kw)
        want = ref.gossip_mix_ref(*bufs, w_off, w_self, **kw)
        torch.cuda.synchronize()
        _assert_gossip(got, want, bufs, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("topk", [None, 64])
def test_gossip_mix_stale_mix_on_card(cuda, topk):
    """With stale_mix the neighbour terms are the INPUT recon: mixed ==
    W_off @ recon + w_self * x, whatever the wire sent, and recon', res'
    and the scales are the fresh round's."""
    n, t, chunk = 20, 1536, 512
    w_self, w_off = _weights(n, "hospital20", cuda)
    bufs = _card_inputs(n, t, 7, cuda)
    x, recon, _ = bufs
    kw = dict(scale_chunk=chunk, topk=topk)
    stale = ops.gossip_mix(*bufs, w_off, w_self, stale_mix=True, **kw)
    fresh = ops.gossip_mix(*bufs, w_off, w_self, **kw)
    torch.cuda.synchronize()
    _assert_gossip(stale, ref.gossip_mix_ref(*bufs, w_off, w_self, stale_mix=True, **kw),
                   bufs, "stale")
    tol = ATOL * max(1.0, max(float(b.abs().max()) for b in bufs))
    want = w_off @ recon + w_self[:, None] * x
    assert float((stale[0] - want).abs().max()) <= tol
    for i in (1, 2, 3):
        assert torch.equal(stale[i], fresh[i])


@pytest.mark.cuda
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_composition_on_card(cuda, algorithm):
    """The composition launches gossip_mix once per wire per round and
    equals the fused round (one round-kernel launch per round)."""
    before = (ops.gossip_mix.launches, ops.fused_round.launches,
              ops.fused_round_gt.launches)
    _check_composition(algorithm, "ehr", cuda)
    torch.cuda.synchronize()
    wires = 2 if algorithm == "dsgt" else 1
    # rounds 1 and 3 for each path: 4 rounds each
    assert ops.gossip_mix.launches - before[0] == 4 * wires
    fused = (ops.fused_round_gt if wires == 2 else ops.fused_round).launches
    assert fused - before[2 if wires == 2 else 1] == 4
