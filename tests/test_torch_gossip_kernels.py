"""The round megakernels of the PyTorch port (``repro_torch.kernels.gossip``).

* Their plain PyTorch twins against the JAX package's jnp oracles and its
  Pallas kernels (interpret mode on the CPU, as the JAX suite runs them),
  from identical numpy inputs.
* The CUDA kernels against the twins on the card (``cuda`` marker: they
  skip without one; ``python -m pytest -q -m cuda tests/test_torch_gossip_kernels.py``
  runs them there, where JAX is not needed).
* The wrappers' refusals, and the round kernels' cluster plan
  (``plan_round``, pure Python).

The wire-stage kernels and the top-k wire have their CPU tests in
tests/test_torch_wire_stage.py; their card-only cases are here.

Tolerances: ``scales``, ``recon'`` and ``res'`` are elementwise chains of
rounded fp32 operations in the same order on both sides, held to 1e-6
(bitwise on the card). ``mixed`` holds the n x n contraction, which
sums in another order: it gets the reference suite's own ``ATOL`` =
1e-5 x max(scale, 1) (tests/test_megakernel.py).
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.kernels.gossip import ops, ref  # noqa: E402

ATOL = 1e-5
STATE_ATOL = 1e-6
FLAGS = list(itertools.product([True, False], repeat=3))  # ef, dc, stale
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
    """The JAX package's oracles and Pallas dispatch (imported here, not
    at module level, so the card-only tests run where JAX is absent)."""
    pytest.importorskip("jax")
    from repro.kernels.gossip import ops as j_ops
    from repro.kernels.gossip import ref as j_ref

    return j_ref, j_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (python3 chip_smoke.py runs the same checks there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(n, topo="ring"):
    w = mixing_matrix(topo, n)
    return (np.asarray(w - np.diag(np.diag(w)), np.float32),
            np.asarray(np.diag(w), np.float32))


def _inputs(n, t, wires, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    mults = [1.0, 1.0, 1.0, 0.1] if wires == 1 else [1.0, 0.3, 0.5, 0.5, 1.0, 0.1, 1.0, 0.1]
    return [np.asarray(scale * m * rng.normal(size=(n, t)), np.float32) for m in mults]


def _t(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _compare(got, want, names, mixed_tol, n_mixed):
    for i, (name, a, b) in enumerate(zip(names, got, want)):
        a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.detach().cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.shape == b.shape, name
        tol = mixed_tol if i < n_mixed else STATE_ATOL
        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=name)


def _jnp(arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# twins vs the JAX package (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 20, 64])
@pytest.mark.parametrize("chunk", [32, 128, 512])
def test_fused_round_twin_matches_jnp_oracle(jax_gossip, n, chunk):
    """DSGD twin == ``repro.kernels.gossip.ref.fused_round_ref`` for every
    flag combination (error feedback, difference coding, stale mix)."""
    j_ref, _ = jax_gossip
    t = 3 * chunk
    w_off, w_self = _weights(n)
    alpha = np.float32(0.05)
    for k, (ef, dc, stale) in enumerate(FLAGS):
        scale = 10.0 ** (k % 3 - 1)
        bufs = _inputs(n, t, 1, seed=100 * n + chunk + k, scale=scale)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale)
        got = ref.fused_round_ref(*_t(bufs + [w_off, w_self]), alpha, **kw)
        want = j_ref.fused_round_ref(*_jnp(bufs + [w_off, w_self]), alpha, **kw)
        _compare(got, want, DSGD_NAMES, ATOL * max(scale, 1.0), 1)


@pytest.mark.parametrize("n", [8, 20, 64])
@pytest.mark.parametrize("chunk", [32, 128, 512])
def test_fused_round_gt_twin_matches_jnp_oracle(jax_gossip, n, chunk):
    """DSGT twin == ``repro.kernels.gossip.ref.fused_round_gt_ref`` on all
    eight outputs for every flag combination."""
    j_ref, _ = jax_gossip
    t = 2 * chunk
    w_off, w_self = _weights(n)
    alpha = np.float32(0.02)
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _inputs(n, t, 2, seed=7 * n + chunk + k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale)
        got = ref.fused_round_gt_ref(*_t(bufs + [w_off, w_self]), alpha, **kw)
        want = j_ref.fused_round_gt_ref(*_jnp(bufs + [w_off, w_self]), alpha, **kw)
        _compare(got, want, DSGT_NAMES, ATOL, 2)


# (n, t, chunk, ef, dc, stale): the grid of tests/test_megakernel.py
# plus the main path's (20, 1536, 512) and the stale-mix variant
PALLAS_CASES = [
    (16, 256, 64, True, True, False),
    (8, 512, 128, True, False, False),
    (64, 1024, 256, True, True, False),
    (8, 96, 32, False, True, False),
    (20, 1536, 512, True, True, False),
    (20, 1024, 512, True, True, True),
]


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_fused_round_twin_matches_pallas(jax_gossip, case):
    """DSGD twin == the Pallas kernel ``fused_round_pallas`` (through
    ``repro.kernels.gossip.ops``, interpret mode on the CPU)."""
    _, j_ops = jax_gossip
    n, t, chunk, ef, dc, stale = case
    w_off, w_self = _weights(n)
    bufs = _inputs(n, t, 1, seed=n + chunk)
    kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
              stale_mix=stale)
    alpha = np.float32(0.05)
    got = ops.fused_round(*_t(bufs + [w_off, w_self]), alpha, **kw)
    want = j_ops.fused_round(*_jnp(bufs + [w_off, w_self]), alpha, **kw)
    _compare(got, want, DSGD_NAMES, ATOL, 1)


@pytest.mark.parametrize("case", PALLAS_CASES)
def test_fused_round_gt_twin_matches_pallas(jax_gossip, case):
    """DSGT twin == the Pallas kernel ``fused_round_gt_pallas``."""
    _, j_ops = jax_gossip
    n, t, chunk, ef, dc, stale = case
    w_off, w_self = _weights(n)
    bufs = _inputs(n, t, 2, seed=3 * n + chunk)
    kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
              stale_mix=stale)
    alpha = np.float32(0.02)
    got = ops.fused_round_gt(*_t(bufs + [w_off, w_self]), alpha, **kw)
    want = j_ops.fused_round_gt(*_jnp(bufs + [w_off, w_self]), alpha, **kw)
    _compare(got, want, DSGT_NAMES, ATOL, 2)


def test_all_zero_chunk_gets_zero_scale_and_no_step():
    """A (row, chunk) whose payload is exactly zero takes ``safe = 1``:
    scale 0, q 0, recon and residual unchanged."""
    n, t, chunk = 7, 384, 128
    w_off, w_self = _weights(n, "complete")
    x, g, recon, res = _t(_inputs(n, t, 1, seed=5))
    for b in (x, g, recon, res):
        b[3, chunk:2 * chunk] = 0.0
    mixed, nrecon, nres, scales = ops.fused_round(
        x, g, recon, res, *_t([w_off, w_self]), np.float32(0.02), scale_chunk=chunk)
    assert float(scales[3, 1]) == 0.0
    assert torch.all(nrecon[3, chunk:2 * chunk] == 0)
    assert torch.all(nres[3, chunk:2 * chunk] == 0)
    assert torch.all(scales.flatten()[torch.arange(scales.numel()) != 3 * 3 + 1] > 0)


def test_wrappers_count_only_kernel_launches():
    """CPU tensors run the twin; the launch counters count kernel
    launches only, so they stay put."""
    n, t = 8, 64
    bufs = _t(_inputs(n, t, 2, seed=0))
    w = _t(_weights(n))
    before = (ops.fused_round.launches, ops.fused_round_gt.launches)
    ops.fused_round(*bufs[:4], *w, 0.1, scale_chunk=32)
    ops.fused_round_gt(*bufs, *w, 0.1, scale_chunk=32)
    assert (ops.fused_round.launches, ops.fused_round_gt.launches) == before


# ---------------------------------------------------------------------------
# refusals
# ---------------------------------------------------------------------------


def _dsgd_args(n=8, t=64):
    return _t(_inputs(n, t, 1, seed=1)) + _t(_weights(n)) + [np.float32(0.1)]


def test_refuses_topk_and_dp():
    """``topk < 1`` is refused as the reference refuses it
    (``gossip.py:_check_topk``); the DP wire is not ported and raises."""
    args = _dsgd_args()
    for fn in (ops.fused_round, ref.fused_round_ref):
        with pytest.raises(ValueError, match="topk must be >= 1"):
            fn(*args, scale_chunk=32, topk=0)
    with pytest.raises(NotImplementedError, match="privacy"):
        ops.fused_round(*args, scale_chunk=32, dp_clip=1.0,
                        dp_noise=torch.zeros(8, 64))
    gt = _t(_inputs(8, 64, 2, seed=2)) + _t(_weights(8)) + [np.float32(0.1)]
    for fn in (ops.fused_round_gt, ref.fused_round_gt_ref):
        with pytest.raises(ValueError, match="topk must be >= 1"):
            fn(*gt, scale_chunk=32, topk=0)
    with pytest.raises(NotImplementedError, match="privacy"):
        ops.fused_round_gt(*gt, scale_chunk=32, dp_noise_t=torch.zeros(8, 64))


def test_refuses_wrong_dtype_layout_and_chunk():
    x, g, recon, res, w_off, w_self, a = _dsgd_args()
    with pytest.raises(TypeError, match="float32"):
        ops.fused_round(x.double(), g, recon, res, w_off, w_self, a, scale_chunk=32)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_round(x.t().contiguous().t(), g, recon, res, w_off, w_self, a,
                        scale_chunk=32)
    with pytest.raises(ValueError, match="multiple of scale_chunk"):
        ops.fused_round(x, g, recon, res, w_off, w_self, a, scale_chunk=48)
    with pytest.raises(ValueError, match="expected"):
        ops.fused_round(x, g[:, :32].contiguous(), recon, res, w_off, w_self, a,
                        scale_chunk=32)
    with pytest.raises(ValueError, match="do not match"):
        ops.fused_round(x, g, recon, res, w_off[:4, :4].contiguous(), w_self, a,
                        scale_chunk=32)


# ---------------------------------------------------------------------------
# kernels vs twins on the card
# ---------------------------------------------------------------------------

# (n, t, chunk, topology): the main path, a small ragged shape, n = 64
CUDA_SHAPES = [(20, 1536, 512, "hospital20"), (7, 384, 128, "complete"),
               (64, 4096, 512, "torus:8x8")]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("wires", [1, 2])
def test_kernel_matches_twin_on_card(cuda, shape, wires):
    """recon', res' and scales bitwise; mixed within the reference's
    ATOL; one launch counted per call."""
    n, t, chunk, topo = shape
    w = _t(_weights(n, topo), cuda)
    kernel, twin = ((ops.fused_round, ref.fused_round_ref) if wires == 1 else
                    (ops.fused_round_gt, ref.fused_round_gt_ref))
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _t(_inputs(n, t, wires, seed=k), cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale)
        before = kernel.launches
        got = kernel(*bufs, *w, np.float32(0.02), **kw)
        want = twin(*bufs, *w, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for i, (a, b) in enumerate(zip(got, want)):
            if i < wires:
                assert float((a - b).abs().max()) <= ATOL
            else:
                assert torch.equal(a, b), (i, kw)


@pytest.mark.cuda
def test_kernel_refuses_tile_over_shared_memory(cuda):
    # W_off alone is 144 KB at n = 192; with the smallest (192, 32) tiles
    # a block needs 247 KB at every cluster size
    n, chunk = 192, 512
    bufs = _t(_inputs(n, chunk, 1, seed=0), cuda)
    w = _t(_weights(n), cuda)
    with pytest.raises(ValueError, match="shared"):
        ops.fused_round(*bufs, *w, np.float32(0.1), scale_chunk=chunk)


def _tie_inputs(bufs, chunk, wires, seed):
    """Exact ties at the top-k threshold in (row 0, chunk 0): every input
    there zero but x (DSGD) or the tracker t (DSGT), which carry
    magnitudes 3, 2, 1 (chunk/8 threes, chunk/4 twos), so top-k at
    k = chunk/4 keeps chunk/8 + chunk/4 columns."""
    rng = np.random.default_rng(seed)
    mags = np.ones(chunk, np.float32)
    mags[: chunk // 8] = 3.0
    mags[chunk // 8: chunk // 8 + chunk // 4] = 2.0
    pattern = rng.permutation(mags * rng.choice([-1.0, 1.0], size=chunk))
    for b in bufs:
        b[0, :chunk] = 0.0
    bufs[0 if wires == 1 else 1][0, :chunk] = torch.as_tensor(pattern, dtype=torch.float32)
    return bufs


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("wires", [1, 2])
def test_wire_stage_kernel_matches_twin_on_card(cuda, shape, wires):
    """Every output bitwise (h, t_half, q, scales, recon', res'), for the
    4 (ef, dc) combinations x topk in {None, chunk/4 with exact ties at
    the threshold, chunk}; one launch counted per call."""
    n, t, chunk, _ = shape
    kernel, twin = ((ops.wire_stage, ref.wire_stage_ref) if wires == 1 else
                    (ops.wire_stage_gt, ref.wire_stage_gt_ref))
    for k, ((ef, dc), topk) in enumerate(itertools.product(
            itertools.product([True, False], repeat=2), [None, chunk // 4, chunk])):
        bufs = _t(_inputs(n, t, wires, seed=k), cuda)
        if topk == chunk // 4:
            bufs = _tie_inputs(bufs, chunk, wires, seed=k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  topk=topk)
        before = kernel.launches
        got = kernel(*bufs, np.float32(0.02), **kw)
        want = twin(*bufs, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (i, kw)
        if topk == chunk // 4:
            for i in ([1] if wires == 1 else [2, 6]):
                kept = int(torch.count_nonzero(got[i][0, :chunk]))
                assert kept == chunk // 8 + chunk // 4, (i, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CUDA_SHAPES)
@pytest.mark.parametrize("wires", [1, 2])
def test_topk_round_kernel_matches_twin_on_card(cuda, shape, wires):
    """The round kernels with the top-k mask: recon', res' and scales
    bitwise, mixed within ATOL, for every (ef, dc, stale) at topk in
    {1, chunk/8}."""
    n, t, chunk, topo = shape
    w = _t(_weights(n, topo), cuda)
    kernel, twin = ((ops.fused_round, ref.fused_round_ref) if wires == 1 else
                    (ops.fused_round_gt, ref.fused_round_gt_ref))
    for k, ((ef, dc, stale), topk) in enumerate(itertools.product(FLAGS, [1, chunk // 8])):
        bufs = _t(_inputs(n, t, wires, seed=k), cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        got = kernel(*bufs, *w, np.float32(0.02), **kw)
        want = twin(*bufs, *w, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        for i, (a, b) in enumerate(zip(got, want)):
            if i < wires:
                assert float((a - b).abs().max()) <= ATOL
            else:
                assert torch.equal(a, b), (i, kw)


def _round_pair(wires):
    return ((ops.fused_round, ref.fused_round_ref) if wires == 1 else
            (ops.fused_round_gt, ref.fused_round_gt_ref))


def _assert_round(got, want, wires, bufs, what):
    """recon', res' and scales bitwise; mixed within 1e-5 x max(1,
    max|input|) (the n x n sum runs in another order)."""
    tol = ATOL * max(1.0, max(float(b.abs().max()) for b in bufs))
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()), (what, i)
        if i < wires:
            assert float((a - b).abs().max()) <= tol, (what, i)
        else:
            assert torch.equal(a, b), (what, i)


@pytest.mark.cuda
@pytest.mark.parametrize("wires", [1, 2])
def test_round_kernel_zero_slice_and_zero_chunk_on_card(cuda, wires):
    """At the main shape, every input zero in (row 3, chunk 1) on one
    cluster block's columns only (the row's scale comes from the other
    blocks), and in the whole of (row 5, chunk 2) (scale 0, no step)."""
    n, t, chunk = 20, 1536, 512
    c, cols, _ = ops.plan_round(n, t, chunk, None, wires)
    assert c > 1
    kernel, twin = _round_pair(wires)
    w = _t(_weights(n, "hospital20"), cuda)
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _t(_inputs(n, t, wires, seed=40 + k), cuda)
        for b in bufs:
            b[3, chunk + cols: chunk + 2 * cols] = 0.0
            b[5, 2 * chunk: 3 * chunk] = 0.0
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale)
        got = kernel(*bufs, *w, np.float32(0.02), **kw)
        want = twin(*bufs, *w, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        _assert_round(got, want, wires, bufs, kw)
        for sc in got[-wires:]:
            assert float(sc[5, 2]) == 0.0 and float(sc[3, 1]) > 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("wires", [1, 2])
def test_round_kernel_keeps_every_tie_on_card(cuda, wires):
    """The tie inputs at the main shape, top-k at chunk/4: the ties are
    spread over every cluster block's columns, the threshold (2) is found
    exactly and every tie at it is kept on each wire."""
    n, t, chunk = 20, 1536, 512
    kernel, twin = _round_pair(wires)
    w = _t(_weights(n, "hospital20"), cuda)
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _tie_inputs(_t(_inputs(n, t, wires, seed=60 + k), cuda), chunk,
                           wires, seed=k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=chunk // 4)
        got = kernel(*bufs, *w, np.float32(0.02), **kw)
        want = twin(*bufs, *w, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        _assert_round(got, want, wires, bufs, kw)
        # recon' on (row 0, chunk 0) is 0 + dq there: nonzero exactly on
        # the kept columns
        for i in range(wires):
            kept = int(torch.count_nonzero(got[wires + 2 * i][0, :chunk]))
            assert kept == chunk // 8 + chunk // 4, (kw, i, kept)


@pytest.mark.cuda
@pytest.mark.parametrize("wires", [1, 2])
def test_round_kernel_ragged_unaligned_on_card(cuda, wires):
    """n = 5, t = 90, chunk 30: rows start off 16-byte boundaries (scalar
    copies) and the block's tile is wider than its chunk; every flag
    combination, dense and top-3."""
    n, t, chunk = 5, 90, 30
    kernel, twin = _round_pair(wires)
    w = _t(_weights(n, "complete"), cuda)
    for k, ((ef, dc, stale), topk) in enumerate(itertools.product(FLAGS, [None, 3])):
        bufs = _t(_inputs(n, t, wires, seed=80 + k), cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        got = kernel(*bufs, *w, np.float32(0.02), **kw)
        want = twin(*bufs, *w, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        _assert_round(got, want, wires, bufs, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("wires", [1, 2])
def test_round_kernel_128_nodes_on_card(cuda, wires):
    """n = 128 at chunk 512, which the one-block-a-chunk design refused,
    runs and equals the twin (dense wire; DSGD also at top-64)."""
    n, t, chunk = 128, 1024, 512
    kernel, twin = _round_pair(wires)
    w = _t(_weights(n, "ring"), cuda)
    topks = [None, 64] if wires == 1 else [None]
    for k, ((ef, dc, stale), topk) in enumerate(itertools.product(FLAGS[:4], topks)):
        bufs = _t(_inputs(n, t, wires, seed=100 + k), cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        got = kernel(*bufs, *w, np.float32(0.02), **kw)
        want = twin(*bufs, *w, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        _assert_round(got, want, wires, bufs, kw)


# ---------------------------------------------------------------------------
# the round kernels' cluster plan (pure Python, CPU)
# ---------------------------------------------------------------------------


def _block_cols(chunk, c):
    cols = -(-chunk // c)
    return cols + -cols % 4


# the round kernels' wire counts: the gossip stage (one wire, no update), DSGD, DSGT
WIRES = [ops.GOSSIP_STAGE, 1, 2]


@pytest.mark.parametrize("n", [5, 7, 20, 64, 128])
@pytest.mark.parametrize("chunk", [30, 32, 128, 512])
@pytest.mark.parametrize("topk", [None, 8])
@pytest.mark.parametrize("wires", WIRES)
def test_plan_round_covers_the_chunk_within_shared_memory(n, chunk, topk, wires):
    """Every block of a cluster owns columns, the cluster covers the
    chunk (the last block the ragged rest), rows stay 16-byte multiples,
    and a block's shared memory is the kernel's layout and within 227 KB;
    a refusal only where no cluster size fits."""
    try:
        c, cols, smem = ops.plan_round(n, 4 * chunk, chunk, topk, wires)
    except ValueError:
        sizes = [c for c in ops.CLUSTER_SIZES if c == 1 or (
            _block_cols(chunk, c) >= ops.MIN_BLOCK_COLS
            and (c - 1) * _block_cols(chunk, c) < chunk)]
        assert all(ops.round_smem_bytes(n, chunk, c, _block_cols(chunk, c), wires,
                                        topk) > ops.SMEM_LIMIT_BYTES for c in sizes)
        return
    assert c in ops.CLUSTER_SIZES and cols % 4 == 0
    assert c * cols >= chunk and (c - 1) * cols < chunk
    assert c == 1 or cols >= ops.MIN_BLOCK_COLS
    assert smem == ops.round_smem_bytes(n, chunk, c, cols, wires, topk)
    assert smem <= ops.SMEM_LIMIT_BYTES


@pytest.mark.parametrize("n", [5, 20, 64, 128])
@pytest.mark.parametrize("chunk", [30, 512])
@pytest.mark.parametrize("topk", [None, 8])
def test_plan_round_lays_the_gossip_stage_out_as_dsgd(n, chunk, topk):
    """The gossip stage is the DSGD round without its update: the same
    plan and the same shared-memory layout (x's tile is the self term,
    the payload goes to the tile DSGD loads g into)."""
    t = 3 * chunk
    assert (ops.plan_round(n, t, chunk, topk, ops.GOSSIP_STAGE)
            == ops.plan_round(n, t, chunk, topk, 1))
    for c in (1, 2, 8):
        cols = _block_cols(chunk, c)
        assert (ops.round_smem_bytes(n, chunk, c, cols, ops.GOSSIP_STAGE, topk)
                == ops.round_smem_bytes(n, chunk, c, cols, 1, topk))


@pytest.mark.parametrize("wires", WIRES)
@pytest.mark.parametrize("topk", [None, 64])
def test_plan_round_fits_two_blocks_an_sm_at_64_nodes(wires, topk):
    """The large shape (64, 1,048,576) at chunk 512: a block's loads can
    overlap another's mix."""
    _, _, smem = ops.plan_round(64, 1 << 20, 512, topk, wires)
    assert 2 * (smem + ops.BLOCK_RESERVED_BYTES) <= ops.SM_SMEM_BYTES


@pytest.mark.parametrize("wires", WIRES)
@pytest.mark.parametrize("topk", [None, 64])
def test_plan_round_spreads_the_main_shape(wires, topk):
    """The paper's (20, 1536) buffer at chunk 512 is 3 chunks: clusters of
    at least 8 blocks put it on at least 24 SMs."""
    c, cols, _ = ops.plan_round(20, 1536, 512, topk, wires)
    assert c >= 8 and c * cols == 512
    # a small chunk is one block, the same kernel
    assert ops.plan_round(20, 640, 32, topk, wires)[0] == 1


def test_plan_round_refuses_past_the_limit():
    with pytest.raises(ValueError, match="shared memory"):
        ops.plan_round(192, 512, 512, None, 1)
    with pytest.raises(ValueError, match="gossip stage.*shared memory"):
        ops.plan_round(192, 512, 512, None, ops.GOSSIP_STAGE)
    with pytest.raises(ValueError, match="shared memory"):
        ops.plan_round(128, 512, 512, 64, 2)
    with pytest.raises(ValueError, match="wires"):
        ops.plan_round(20, 1536, 512, None, 3)
