"""The wire-stage kernels and the top-k wire of the PyTorch port
(``repro_torch.kernels.gossip``).

* The twins ``wire_stage_ref`` / ``wire_stage_gt_ref`` against the JAX
  package's jnp oracles and its Pallas kernels ``wire_stage_pallas`` /
  ``wire_stage_gt_pallas`` (interpret mode on the CPU, as the JAX suite
  runs them), from identical numpy inputs.
* The top-k round twins ``fused_round_ref`` / ``fused_round_gt_ref``
  against the same two references.
* The wrappers' top-k validation and launch counters on the CPU.

Tolerances: every output but ``mixed`` is a chain of rounded fp32
operations in the same order in the twin and in the jnp oracle, so
against the oracle ``h``, ``t_half``, ``q``, ``scales``, ``recon'`` and
``res'`` are compared bitwise. In interpret mode XLA compiles the Pallas
kernel body as one fused computation and contracts ``x - alpha * g`` and
``base + q * scale`` into FMAs and ``max / 127`` into a multiply by the
reciprocal, so the Pallas outputs differ from the jnp oracle's in the
last bit: against Pallas the int8 ``q`` and ``t_half`` (additions only)
are bitwise and the other states within ``STATE_ATOL`` = 1e-6, as in
tests/test_torch_gossip_kernels.py. ``mixed`` holds the n x n
contraction, which sums in another order: it gets the reference suite's
``ATOL`` = 1e-5 (tests/test_megakernel.py).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.kernels.gossip import ops, ref  # noqa: E402

ATOL = 1e-5
STATE_ATOL = 1e-6
#: outputs made without a multiply: bitwise even against interpret mode
EXACT = ("q", "q_x", "q_t", "t_half")
EF_DC = list(itertools.product([True, False], repeat=2))
WS_NAMES = ("h", "q", "scales", "recon", "res")
WS_GT_NAMES = ("h", "t_half", "q_x", "scales_x", "recon_x", "res_x", "q_t",
               "scales_t", "recon_t", "res_t")
DSGD_NAMES = ("mixed", "recon", "res", "scales")
DSGT_NAMES = ("mixed_x", "mixed_t", "recon_x", "res_x", "recon_t", "res_t",
              "scales_x", "scales_t")


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def jax_gossip():
    """The JAX package's oracles and Pallas dispatch."""
    pytest.importorskip("jax")
    from repro.kernels.gossip import ops as j_ops
    from repro.kernels.gossip import ref as j_ref

    return j_ref, j_ops


def _inputs(n, t, wires, seed, chunk=None, ties=False):
    """The kernel's (n, t) fp32 inputs from a numpy seed. ``ties`` makes
    the payload of (row 0, chunk 0) exactly a pattern of repeated
    magnitudes on every wire: all inputs there are zero except x (DSGD)
    or the tracker t (DSGT), which carry the pattern."""
    rng = np.random.default_rng(seed)
    mults = [1.0, 1.0, 1.0, 0.1] if wires == 1 else [1.0, 0.3, 0.5, 0.5, 1.0, 0.1, 1.0, 0.1]
    bufs = [np.asarray(m * rng.normal(size=(n, t)), np.float32) for m in mults]
    if ties:
        for b in bufs:
            b[0, :chunk] = 0.0
        bufs[0 if wires == 1 else 1][0, :chunk] = _tie_pattern(chunk, rng)
    return bufs


def _tie_pattern(chunk, rng):
    """Magnitudes 3, 2 and 1 with random signs: chunk/8 threes, chunk/4
    twos, the rest ones -- so top-k at k = chunk/4 has its threshold at 2
    with chunk/8 extra ties at it."""
    mags = np.ones(chunk, np.float32)
    mags[: chunk // 8] = 3.0
    mags[chunk // 8: chunk // 8 + chunk // 4] = 2.0
    return rng.permutation(mags * rng.choice([-1.0, 1.0], size=chunk)).astype(np.float32)


def _weights(n, topo="ring"):
    w = mixing_matrix(topo, n)
    return (np.asarray(w - np.diag(np.diag(w)), np.float32),
            np.asarray(np.diag(w), np.float32))


def _t(arrays):
    return [torch.as_tensor(a) for a in arrays]


def _jnp(arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, want, names, n_mixed=0, state_atol=0.0):
    """``mixed`` within ATOL, the rest within ``state_atol`` (0: bitwise),
    ``EXACT`` outputs always bitwise."""
    assert len(got) == len(want) == len(names)
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if i < n_mixed:
            np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=name)
        elif state_atol and name not in EXACT:
            np.testing.assert_allclose(a, b, rtol=0, atol=state_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


# (n, t, chunk): ragged chunks below a warp, the main path, wide nodes
SHAPES = [(8, 48, 16), (20, 1536, 512), (64, 512, 128)]


def _topk_cases(chunk):
    return [None, 1, 4, chunk]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wires", [1, 2])
def test_wire_stage_twin_matches_jnp_oracle(jax_gossip, shape, wires):
    """``wire_stage_ref`` / ``wire_stage_gt_ref`` == the reference's jnp
    oracles bitwise, for every (ef, dc) and topk in {None, 1, 4, chunk}."""
    j_ref, _ = jax_gossip
    n, t, chunk = shape
    twin, oracle, names = ((ref.wire_stage_ref, j_ref.wire_stage_ref, WS_NAMES)
                           if wires == 1 else
                           (ref.wire_stage_gt_ref, j_ref.wire_stage_gt_ref,
                            WS_GT_NAMES))
    alpha = np.float32(0.03)
    for k, ((ef, dc), topk) in enumerate(itertools.product(EF_DC, _topk_cases(chunk))):
        bufs = _inputs(n, t, wires, seed=31 * n + k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  topk=topk)
        _compare(twin(*_t(bufs), alpha, **kw), oracle(*_jnp(bufs), alpha, **kw),
                 names)


@pytest.mark.parametrize("wires", [1, 2])
def test_wire_stage_twin_matches_pallas(jax_gossip, wires):
    """The twins == the Pallas kernels ``wire_stage_pallas`` /
    ``wire_stage_gt_pallas`` (through ``repro.kernels.gossip.ops``,
    interpret mode) at the main path's shape, dense and top-k: q and
    t_half bitwise, the other states within STATE_ATOL."""
    _, j_ops = jax_gossip
    n, t, chunk = 20, 1536, 512
    mine, theirs, names = ((ops.wire_stage, j_ops.wire_stage, WS_NAMES)
                           if wires == 1 else
                           (ops.wire_stage_gt, j_ops.wire_stage_gt, WS_GT_NAMES))
    alpha = np.float32(0.02)
    for k, (topk, ef, dc) in enumerate([(None, True, True), (64, True, True),
                                        (4, False, True), (1, True, False)]):
        bufs = _inputs(n, t, wires, seed=k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  topk=topk)
        _compare(mine(*_t(bufs), alpha, **kw), theirs(*_jnp(bufs), alpha, **kw),
                 names, state_atol=STATE_ATOL)


@pytest.mark.parametrize("wires", [1, 2])
def test_topk_keeps_every_tie_at_the_threshold(jax_gossip, wires):
    """A (row, chunk) with exact ties at the threshold keeps all of them,
    in the twin, the jnp oracle and the Pallas kernel alike."""
    j_ref, j_ops = jax_gossip
    n, t, chunk = 4, 256, 128
    k = chunk // 4  # threshold 2: chunk/8 threes + chunk/4 twos kept
    bufs = _inputs(n, t, wires, seed=7, chunk=chunk, ties=True)
    kw = dict(scale_chunk=chunk, topk=k)
    alpha = np.float32(0.02)
    twin = ref.wire_stage_ref if wires == 1 else ref.wire_stage_gt_ref
    got = twin(*_t(bufs), alpha, **kw)
    oracle = j_ref.wire_stage_ref if wires == 1 else j_ref.wire_stage_gt_ref
    pallas = j_ops.wire_stage if wires == 1 else j_ops.wire_stage_gt
    names = WS_NAMES if wires == 1 else WS_GT_NAMES
    _compare(got, oracle(*_jnp(bufs), alpha, **kw), names)
    _compare(got, pallas(*_jnp(bufs), alpha, **kw), names, state_atol=STATE_ATOL)
    q_slots = [1] if wires == 1 else [2, 6]
    for i in q_slots:
        kept = int(torch.count_nonzero(got[i][0, :chunk]))
        assert kept == chunk // 8 + chunk // 4 > k, kept


@pytest.mark.parametrize("chunk", [16, 128, 512])
def test_topk_fused_round_twins_match_jnp_oracle(jax_gossip, chunk):
    """Top-k ``fused_round_ref`` / ``fused_round_gt_ref`` == the jnp
    oracles: recon', res', scales bitwise, mixed within ATOL, for every
    (ef, dc, stale) at topk in {1, 4, chunk}."""
    j_ref, _ = jax_gossip
    n, t = 20, 3 * chunk
    w = _weights(n)
    alpha = np.float32(0.05)
    flags = list(itertools.product([True, False], repeat=3))
    for k, ((ef, dc, stale), topk) in enumerate(itertools.product(flags, [1, 4, chunk])):
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        for wires, twin, oracle, names in (
                (1, ref.fused_round_ref, j_ref.fused_round_ref, DSGD_NAMES),
                (2, ref.fused_round_gt_ref, j_ref.fused_round_gt_ref, DSGT_NAMES)):
            bufs = _inputs(n, t, wires, seed=chunk + k) + list(w)
            _compare(twin(*_t(bufs), alpha, **kw), oracle(*_jnp(bufs), alpha, **kw),
                     names, n_mixed=wires)


# (n, t, chunk, topk, ef, dc, stale): the main path at the reference
# example's k, small k, ties, and a chunk under a warp
TOPK_PALLAS_CASES = [
    (20, 1536, 512, 64, True, True, False),
    (20, 1536, 512, 64, True, True, True),
    (16, 256, 64, 4, True, False, False),
    (8, 96, 32, 1, False, True, False),
    (8, 64, 16, 4, True, True, True),
]


@pytest.mark.parametrize("case", TOPK_PALLAS_CASES)
def test_topk_fused_round_twins_match_pallas(jax_gossip, case):
    """Top-k round twins == ``fused_round_pallas`` / ``fused_round_gt_pallas``
    in interpret mode, through both packages' dispatch."""
    _, j_ops = jax_gossip
    n, t, chunk, topk, ef, dc, stale = case
    w = _weights(n)
    kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
              stale_mix=stale, topk=topk)
    alpha = np.float32(0.02)
    for wires, mine, theirs, names in ((1, ops.fused_round, j_ops.fused_round, DSGD_NAMES),
                                       (2, ops.fused_round_gt, j_ops.fused_round_gt,
                                        DSGT_NAMES)):
        bufs = _inputs(n, t, wires, seed=n + chunk) + list(w)
        _compare(mine(*_t(bufs), alpha, **kw), theirs(*_jnp(bufs), alpha, **kw),
                 names, n_mixed=wires, state_atol=STATE_ATOL)


def test_topk_at_or_over_the_chunk_is_the_dense_wire():
    """``topk >= scale_chunk`` keeps every column: bitwise the dense wire."""
    bufs = _t(_inputs(8, 256, 2, seed=3))
    dense = ops.wire_stage_gt(*bufs, 0.02, scale_chunk=64)
    for topk in (64, 65, 10_000):
        _compare(ops.wire_stage_gt(*bufs, 0.02, scale_chunk=64, topk=topk), dense,
                 WS_GT_NAMES)


def test_wrappers_validate_topk_and_count_only_launches():
    """``topk < 1`` is refused (as ``gossip.py:_check_topk``) by every
    wrapper and twin; CPU calls run the twins, so no launch is counted."""
    x, t, g, gp, rx, sx, rt, st = _t(_inputs(8, 64, 2, seed=0))
    w = _t(_weights(8))
    calls = [
        (ops.wire_stage, (x, g, rx, sx, 0.1)),
        (ops.wire_stage_gt, (x, t, g, gp, rx, sx, rt, st, 0.1)),
        (ops.fused_round, (x, g, rx, sx, *w, 0.1)),
        (ops.fused_round_gt, (x, t, g, gp, rx, sx, rt, st, *w, 0.1)),
        (ref.wire_stage_ref, (x, g, rx, sx, 0.1)),
        (ref.fused_round_gt_ref, (x, t, g, gp, rx, sx, rt, st, *w, 0.1)),
    ]
    for fn, args in calls:
        for bad in (0, -3):
            with pytest.raises(ValueError, match="topk must be >= 1"):
                fn(*args, scale_chunk=32, topk=bad)
    before = [fn.launches for fn in (ops.wire_stage, ops.wire_stage_gt,
                                     ops.fused_round, ops.fused_round_gt)]
    for fn, args in calls[:4]:
        fn(*args, scale_chunk=32, topk=4)
    assert before == [fn.launches for fn in (ops.wire_stage, ops.wire_stage_gt,
                                             ops.fused_round, ops.fused_round_gt)]


def test_wire_stage_refuses_dp_and_bad_operands():
    x, g, recon, res = _t(_inputs(8, 64, 1, seed=1))
    with pytest.raises(NotImplementedError, match="privacy"):
        ops.wire_stage(x, g, recon, res, 0.1, scale_chunk=32, dp_clip=1.0,
                       dp_noise=torch.zeros(8, 64))
    with pytest.raises(ValueError, match="multiple of scale_chunk"):
        ops.wire_stage(x, g, recon, res, 0.1, scale_chunk=48)
    with pytest.raises(TypeError, match="float32"):
        ops.wire_stage(x.double(), g, recon, res, 0.1, scale_chunk=32)
    with pytest.raises(ValueError, match="expected"):
        ops.wire_stage(x, g[:, :32].contiguous(), recon, res, 0.1, scale_chunk=32)
