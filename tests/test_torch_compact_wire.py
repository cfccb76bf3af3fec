"""The compact top-k wire of the PyTorch port
(``repro_torch.kernels.gossip``): the exact-k wire stages and their
receive side.

* The twins ``wire_stage_compact_ref`` / ``wire_stage_gt_compact_ref``
  against the JAX package's jnp oracles and its Pallas kernels
  ``wire_stage_compact_pallas`` / ``wire_stage_gt_compact_pallas``
  (interpret mode on the CPU, as the JAX suite runs them), from identical
  numpy inputs, with explicit positions and with the presence bitmap.
* Forced ties: equal |payload| of both signs and chunks with fewer than k
  non-zeros -- exact-k keeps the lower index.
* The receive side (``scatter_compact_dq``, ``compact_to_bitmap``,
  ``scatter_bitmap_dq``) against the reference's, and the round trip.
* The wrappers' rules, and (``cuda`` marker, skipped without a card) the
  CUDA kernels against the twins on the card.
* The top-k divergence of ROADMAP.md queue 3, pinned in both packages.

Tolerances: against the jnp oracle every output is bitwise -- each fp32
state is the same chain of rounded operations in the same order (the
dense dq is added into zeros in both). Against Pallas the integer
outputs (q, positions, bitmap) and ``t_half`` are bitwise and the other
states within ``STATE_ATOL`` = 1e-6: interpret mode contracts
``x - alpha * g`` into an FMA and divides by 127 through a reciprocal
(ROADMAP.md queue 3), as in tests/test_torch_wire_stage.py.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.kernels.gossip import ops, ref  # noqa: E402

STATE_ATOL = 1e-6
#: outputs the Pallas kernel computes without a multiply: bitwise there too
EXACT = ("q", "pos", "q_x", "pos_x", "q_t", "pos_t", "t_half")
NAMES = ("h", "q", "pos", "scales", "recon", "res")
GT_NAMES = ("h", "t_half", "q_x", "pos_x", "scales_x", "recon_x", "res_x",
            "q_t", "pos_t", "scales_t", "recon_t", "res_t")
EF_DC = list(itertools.product([True, False], repeat=2))
# (n, t, chunk): a chunk under a warp, and the main path's buffer
SHAPES = [(4, 64, 16), (20, 1536, 512)]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def jax_gossip():
    """The JAX package's oracles and Pallas kernels."""
    pytest.importorskip("jax")
    from repro.kernels.gossip import gossip as j_gossip
    from repro.kernels.gossip import ref as j_ref

    return j_ref, j_gossip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernel has no CPU "
                    "mode (python3 chip_smoke.py runs the same checks there)")
    return torch.device("cuda")


def _topks(chunk):
    return [k for k in (1, 4, 16, 64, chunk - 1) if k < chunk]


def _inputs(n, t, wires, seed, chunk=None, ties=None):
    """The kernel's (n, t) fp32 inputs from a numpy seed. ``ties`` puts a
    pattern into the payload of (row 0, chunk 0): all inputs there are zero
    except x (DSGD) or the tracker t (DSGT), which carry it."""
    rng = np.random.default_rng(seed)
    mults = [1.0, 1.0, 1.0, 0.1] if wires == 1 else [1.0, 0.3, 0.5, 0.5, 1.0, 0.1, 1.0, 0.1]
    bufs = [np.asarray(m * rng.normal(size=(n, t)), np.float32) for m in mults]
    if ties is not None:
        for b in bufs:
            b[0, :chunk] = 0.0
        bufs[0 if wires == 1 else 1][0, :chunk] = ties
    return bufs


def _tie_pattern(chunk, rng):
    """Magnitudes 3, 2 and 1 with random signs: chunk/8 threes, chunk/4
    twos, the rest ones -- at k = chunk/4 the k-th largest is a 2 with
    chunk/8 more 2s beside it."""
    mags = np.ones(chunk, np.float32)
    mags[: chunk // 8] = 3.0
    mags[chunk // 8: chunk // 8 + chunk // 4] = 2.0
    return rng.permutation(mags * rng.choice([-1.0, 1.0], size=chunk)).astype(np.float32)


def _sparse_pattern(chunk, nonzeros, rng):
    """``nonzeros`` equal magnitudes of both signs, the rest exact zeros."""
    out = np.zeros(chunk, np.float32)
    cols = rng.choice(chunk, size=nonzeros, replace=False)
    out[cols] = rng.choice([-1.5, 1.5], size=nonzeros)
    return out


def _t(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _jnp(arrays):
    import jax.numpy as jnp

    return [jnp.asarray(a) for a in arrays]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _compare(got, want, names, state_atol=0.0):
    """Every output bitwise (dtype and shape too), or the float states
    within ``state_atol`` where it is set; ``EXACT`` outputs always
    bitwise."""
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        a, b = _np(a), _np(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (name, a.dtype, b.dtype)
        if state_atol and a.dtype == np.float32 and name not in EXACT:
            np.testing.assert_allclose(a, b, rtol=0, atol=state_atol, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def _to_bitmap(j_ref, out, wires, chunk, topk):
    """The reference's explicit-position output with each wire re-encoded
    by its ``compact_to_bitmap``: what ``bitmap=True`` must emit."""
    out = list(out)
    for qi in ([1] if wires == 1 else [2, 7]):
        out[qi], out[qi + 1] = j_ref.compact_to_bitmap(out[qi], out[qi + 1], chunk, topk)
    return out


def _oracle(j_ref, wires, bufs, alpha, bitmap, **kw):
    fn = j_ref.wire_stage_compact_ref if wires == 1 else j_ref.wire_stage_gt_compact_ref
    out = fn(*_jnp(bufs), alpha, **kw)
    return _to_bitmap(j_ref, out, wires, kw["scale_chunk"], kw["topk"]) if bitmap else out


def _twin(wires):
    return ref.wire_stage_compact_ref if wires == 1 else ref.wire_stage_gt_compact_ref


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("wires", [1, 2])
@pytest.mark.parametrize("bitmap", [False, True])
def test_compact_twin_matches_jnp_oracle(jax_gossip, shape, wires, bitmap):
    """The twins == the reference's jnp oracles bitwise on every output,
    for k in {1, 4, 16, 64, chunk - 1} below the chunk; (ef, dc) all four
    combinations at the small shape, the engine's (on, on) at the main."""
    j_ref, _ = jax_gossip
    n, t, chunk = shape
    names = NAMES if wires == 1 else GT_NAMES
    flags = EF_DC if chunk == 16 else [(True, True)]
    alpha = np.float32(0.03)
    for k, ((ef, dc), topk) in enumerate(itertools.product(flags, _topks(chunk))):
        bufs = _inputs(n, t, wires, seed=97 * n + k)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc, topk=topk)
        _compare(_twin(wires)(*_t(bufs), alpha, bitmap=bitmap, **kw),
                 _oracle(j_ref, wires, bufs, alpha, bitmap, **kw), names)


# (n, t, chunk, topk, bitmap): the main path's top-16 (positions) and
# top-64 (bitmap) wires, and the small shape both ways
PALLAS_CASES = [(20, 1536, 512, 16, False), (20, 1536, 512, 64, True),
                (4, 64, 16, 4, False), (4, 64, 16, 4, True)]


@pytest.mark.parametrize("case", PALLAS_CASES)
@pytest.mark.parametrize("wires", [1, 2])
def test_compact_twin_matches_pallas(jax_gossip, case, wires):
    """The twins == ``wire_stage_compact_pallas`` /
    ``wire_stage_gt_compact_pallas`` in interpret mode: q, positions or
    bitmap and t_half bitwise, the float states within STATE_ATOL."""
    _, j_gossip = jax_gossip
    n, t, chunk, topk, bitmap = case
    pallas = (j_gossip.wire_stage_compact_pallas if wires == 1
              else j_gossip.wire_stage_gt_compact_pallas)
    bufs = _inputs(n, t, wires, seed=n + topk)
    kw = dict(scale_chunk=chunk, topk=topk, bitmap=bitmap)
    alpha = np.float32(0.02)
    _compare(_twin(wires)(*_t(bufs), alpha, **kw),
             pallas(*_jnp(bufs), alpha, interpret=True, **kw),
             NAMES if wires == 1 else GT_NAMES, state_atol=STATE_ATOL)


def _expected_positions(payload, topk):
    """Exact-k by hand: descending |payload|, ties by ascending index."""
    order = sorted(range(len(payload)), key=lambda c: (-abs(float(payload[c])), c))
    return order[:topk]


@pytest.mark.parametrize("wires", [1, 2])
@pytest.mark.parametrize("pattern", ["ties", "sparse"])
def test_exact_k_breaks_ties_toward_the_lower_index(jax_gossip, wires, pattern):
    """(row 0, chunk 0) holds equal magnitudes of both signs: the tie
    pattern (the k-th largest has chunk/8 equal neighbours), or 3
    non-zeros under k = 8 (zeros fill the rest). Exactly k columns cross,
    the lower index first among equals -- in the twin, the jnp oracle and
    the Pallas kernel alike -- on every wire."""
    j_ref, j_gossip = jax_gossip
    n, t, chunk = 4, 256, 128
    rng = np.random.default_rng(5)
    topk = chunk // 4 if pattern == "ties" else 8
    fill = _tie_pattern(chunk, rng) if pattern == "ties" else _sparse_pattern(chunk, 3, rng)
    bufs = _inputs(n, t, wires, seed=11, chunk=chunk, ties=fill)
    alpha = np.float32(0.02)
    names = NAMES if wires == 1 else GT_NAMES
    kw = dict(scale_chunk=chunk, topk=topk)
    got = _twin(wires)(*_t(bufs), alpha, **kw)
    _compare(got, _oracle(j_ref, wires, bufs, alpha, False, **kw), names)
    pallas = (j_gossip.wire_stage_compact_pallas if wires == 1
              else j_gossip.wire_stage_gt_compact_pallas)
    _compare(got, pallas(*_jnp(bufs), alpha, interpret=True, **kw), names,
             state_atol=STATE_ATOL)
    # the tracker wire's payload is the pattern itself, the parameter
    # wire's -alpha times it: the same order either way
    for pi in ([2] if wires == 1 else [3, 8]):
        assert _np(got[pi][0, :topk]).tolist() == _expected_positions(fill, topk)
    bm = _twin(wires)(*_t(bufs), alpha, bitmap=True, **kw)
    _compare(bm, _oracle(j_ref, wires, bufs, alpha, True, **kw), names)


def test_receive_side_matches_reference_and_round_trips(jax_gossip):
    """``scatter_compact_dq``, ``compact_to_bitmap`` and
    ``scatter_bitmap_dq`` == the reference's bitwise on a compact payload
    with ties and zero chunks; positions -> bitmap -> dense equals
    positions -> dense (up to the sign of zero), and both equal the
    sender's dense dq."""
    j_ref, _ = jax_gossip
    n, t, chunk, topk = 6, 3 * 64, 64, 12
    rng = np.random.default_rng(2)
    bufs = _inputs(n, t, 1, seed=4, chunk=chunk, ties=_sparse_pattern(chunk, 5, rng))
    h, q, pos, scales, recon2, _ = ref.wire_stage_compact_ref(
        *_t(bufs), 0.05, scale_chunk=chunk, topk=topk)
    jq, jpos, jsc = (np.asarray(_np(a)) for a in (q, pos, scales))
    dense = ref.scatter_compact_dq(q, pos, scales, chunk, t)
    _compare([dense], [j_ref.scatter_compact_dq(jq, jpos, jsc, chunk, t)], ["dq"])
    vals, bits = ref.compact_to_bitmap(q, pos, chunk, topk)
    jvals, jbits = j_ref.compact_to_bitmap(jq, jpos, chunk, topk)
    _compare([vals, bits], [jvals, jbits], ["vals", "bits"])
    from_bits = ref.scatter_bitmap_dq(vals, bits, scales, chunk, t)
    _compare([from_bits], [j_ref.scatter_bitmap_dq(np.asarray(jvals), np.asarray(jbits),
                                                   jsc, chunk, t)], ["dq"])
    np.testing.assert_array_equal(_np(from_bits), _np(dense))
    # the sender's recon' is base + this dq (difference coding on)
    np.testing.assert_array_equal(_np(torch.as_tensor(bufs[2]) + dense), _np(recon2))
    assert sum(bin(b).count("1") for b in _np(bits).ravel().tolist()) == n * (t // chunk) * topk


def test_compact_wrappers_validate_and_count_only_launches():
    """``topk`` outside [1, chunk), a bitmap on a chunk that is not
    byte-aligned and the DP arguments raise, in the wrappers and the
    twins; CPU calls run the twins and count no launch."""
    x, t, g, gp, rx, sx, rt, st = _t(_inputs(8, 48, 2, seed=0))
    calls = [(ops.wire_stage_compact, (x, g, rx, sx, 0.1)),
             (ops.wire_stage_gt_compact, (x, t, g, gp, rx, sx, rt, st, 0.1)),
             (ref.wire_stage_compact_ref, (x, g, rx, sx, 0.1)),
             (ref.wire_stage_gt_compact_ref, (x, t, g, gp, rx, sx, rt, st, 0.1))]
    for fn, args in calls:
        for bad in (None, 0, -1, 16, 17):
            with pytest.raises(ValueError, match="1 <= topk < scale_chunk"):
                fn(*args, scale_chunk=16, topk=bad)
        with pytest.raises(ValueError, match="byte-aligned"):
            fn(*args, scale_chunk=12, topk=4, bitmap=True)
    with pytest.raises(NotImplementedError, match="item 12"):
        ops.wire_stage_compact(x, g, rx, sx, 0.1, scale_chunk=16, topk=4, dp_clip=1.0,
                               dp_noise=torch.zeros_like(x))
    with pytest.raises(NotImplementedError, match="item 12"):
        ops.wire_stage_gt_compact(x, t, g, gp, rx, sx, rt, st, 0.1, scale_chunk=16,
                                  topk=4, dp_noise_t=torch.zeros_like(x))
    with pytest.raises(ValueError, match="multiple of scale_chunk"):
        ops.wire_stage_compact(x, g, rx, sx, 0.1, scale_chunk=32, topk=4)
    before = (ops.wire_stage_compact.launches, ops.wire_stage_gt_compact.launches)
    for fn, args in calls[:2]:
        for bitmap in (False, True):
            out = fn(*args, scale_chunk=16, topk=4, bitmap=bitmap)
            assert out[0].device.type == "cpu"
    assert (ops.wire_stage_compact.launches, ops.wire_stage_gt_compact.launches) == before


def test_compact_positions_dtype_follows_the_chunk():
    """Positions are int16 up to a 32768-column chunk, int32 beyond it
    (``packing.compact_pos_dtype``), as in the reference."""
    for chunk, dtype in ((16, torch.int16), (32768, torch.int16), (32776, torch.int32)):
        x, g, r, s = _t(_inputs(1, chunk, 1, seed=chunk))
        out = ref.wire_stage_compact_ref(x, g, r, s, 0.1, scale_chunk=chunk, topk=3)
        assert out[2].dtype == dtype and out[2].shape == (1, 3)


# --- on the card --------------------------------------------------------

# (n, t, chunk, topk): small k under a warp's chunk, the main path's
# top-16 and top-64, k = chunk - 1, and int32 positions (chunk > 32768)
CUDA_CASES = [(4, 64, 16, 4), (20, 1536, 512, 16), (20, 1536, 512, 64),
              (8, 512, 128, 127), (2, 2 * 32776, 32776, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", CUDA_CASES)
@pytest.mark.parametrize("wires", [1, 2])
def test_compact_kernel_matches_twin_on_card(cuda, case, wires):
    """Every output bitwise (h, t_half, q, positions or bitmap, scales,
    recon', res'), for the 4 (ef, dc) combinations, positions and bitmap
    (byte-aligned chunks), with ties in (row 0, chunk 0); one launch
    counted per call."""
    n, t, chunk, topk = case
    kernel = ops.wire_stage_compact if wires == 1 else ops.wire_stage_gt_compact
    rng = np.random.default_rng(topk)
    fill = _tie_pattern(chunk, rng) if chunk % 8 == 0 else None
    for k, ((ef, dc), bitmap) in enumerate(itertools.product(EF_DC, [False, True])):
        bufs = _t(_inputs(n, t, wires, seed=k, chunk=chunk, ties=fill), cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  topk=topk, bitmap=bitmap)
        before = kernel.launches
        got = kernel(*bufs, np.float32(0.02), **kw)
        want = _twin(wires)(*bufs, np.float32(0.02), **kw)
        torch.cuda.synchronize()
        assert kernel.launches == before + 1
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.dtype == b.dtype and torch.equal(a, b), (i, kw)


def _gt_on_card(cuda, n, t, chunk, topk, bitmap, ef=True, dc=True, seed=0, fill=None,
                zero=None):
    """The DSGT compact kernel against its twin: every output bitwise, one
    launch counted. ``fill`` is a tie pattern for (row 0, chunk 0),
    ``zero`` a (row, chunk) whose inputs are all zero."""
    bufs = _t(_inputs(n, t, 2, seed=seed, chunk=chunk, ties=fill), cuda)
    if zero is not None:
        i, ci = zero
        for b in bufs:
            b[i, ci * chunk:(ci + 1) * chunk] = 0.0
    kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc, topk=topk,
              bitmap=bitmap)
    before = ops.wire_stage_gt_compact.launches
    got = ops.wire_stage_gt_compact(*bufs, np.float32(0.02), **kw)
    want = ref.wire_stage_gt_compact_ref(*bufs, np.float32(0.02), **kw)
    torch.cuda.synchronize()
    assert ops.wire_stage_gt_compact.launches == before + 1
    for name, a, b in zip(GT_NAMES, got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), (name, kw)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", [False, True])
def test_gt_compact_ties_across_the_threshold_on_card(cuda, bitmap):
    """(20, 1536) at chunk 512, top-64, (row 0, chunk 0) holding 40
    threes, 100 twos and ones of both signs on both wires: the threshold
    is 2 and the 24 lowest-index twos fill the k; on the positions wire
    they follow the threes, in ascending position."""
    chunk, k = 512, 64
    rng = np.random.default_rng(5)
    mags = np.ones(chunk, np.float32)
    mags[:40], mags[40:140] = 3.0, 2.0
    fill = rng.permutation(mags * rng.choice([-1.0, 1.0], size=chunk)).astype(np.float32)
    threes = np.flatnonzero(np.abs(fill) == 3.0)
    twos = np.flatnonzero(np.abs(fill) == 2.0)[:24]
    for ef, dc in EF_DC:
        got = _gt_on_card(cuda, 20, 1536, chunk, k, bitmap, ef, dc, seed=1, fill=fill)
        for qi in (2, 7):  # both wires
            if bitmap:
                bits = np.unpackbits(_np(got[qi + 1][0, :chunk // 8]), bitorder="little")
                assert set(np.flatnonzero(bits)) == set(threes) | set(twos)
            else:
                pos = _np(got[qi + 1][0, :k]).tolist()
                assert pos == sorted(threes.tolist()) + twos.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("topk", [1, 511])
@pytest.mark.parametrize("bitmap", [False, True])
def test_gt_compact_extreme_k_on_card(cuda, topk, bitmap):
    """k = 1 (the max alone) and k = chunk - 1 (all but the smallest) at
    the main shape, the 4 (ef, dc) combinations."""
    for k, (ef, dc) in enumerate(EF_DC):
        _gt_on_card(cuda, 20, 1536, 512, topk, bitmap, ef, dc, seed=10 + k)


@pytest.mark.cuda
@pytest.mark.parametrize("bitmap", [False, True])
def test_gt_compact_zero_chunk_on_card(cuda, bitmap):
    """(row 3, chunk 1) all zero on every input: both wires' scale is 0,
    q is 0 and the k kept columns are the k lowest indices."""
    k = 16
    for ef, dc in EF_DC:
        got = _gt_on_card(cuda, 20, 1536, 512, k, bitmap, ef, dc, seed=20, zero=(3, 1))
        for qi in (2, 7):
            assert float(got[qi + 2][3, 1]) == 0.0
            assert not bool(got[qi][3, k:2 * k].any())
            idx = _np(got[qi + 1][3])
            if bitmap:
                bits = np.unpackbits(idx[64:128], bitorder="little")
                assert np.flatnonzero(bits).tolist() == list(range(k))
            else:
                assert idx[k:2 * k].tolist() == list(range(k))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [30, 40, 100])
def test_gt_compact_unaligned_chunk_on_card(cuda, chunk):
    """Chunks that are not a multiple of 32: 30 and 100 (not byte-aligned:
    positions only; 30 also off 16-byte rows) and 40 (both encodings);
    k in {1, 7, chunk - 1}, ties in (row 0, chunk 0) where the chunk is a
    multiple of 8."""
    fill = _tie_pattern(chunk, np.random.default_rng(chunk)) if chunk % 8 == 0 else None
    for k, (topk, bitmap) in enumerate(itertools.product(
            (1, 7, chunk - 1), [False, True] if chunk % 8 == 0 else [False])):
        _gt_on_card(cuda, 5, 3 * chunk, chunk, topk, bitmap, seed=30 + k, fill=fill)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [1024, 4096])
def test_gt_compact_wide_chunks_on_card(cuda, chunk):
    """Chunks wider than the block's 512-column step (the counts carried
    from step to step), k in {16, 64, chunk / 3}, both encodings, ties in
    (row 0, chunk 0)."""
    fill = _tie_pattern(chunk, np.random.default_rng(chunk))
    for k, (topk, bitmap) in enumerate(itertools.product((16, 64, chunk // 3),
                                                         [False, True])):
        _gt_on_card(cuda, 4, 2 * chunk, chunk, topk, bitmap, seed=40 + k, fill=fill)


# --- the DSGT compact kernel's layout (pure Python) -------------------------

@pytest.mark.parametrize("chunk", [16, 512, 4096, 32768, 32776])
@pytest.mark.parametrize("bitmap", [False, True])
def test_compact_gt_plan_fits_shared_memory(chunk, bitmap):
    """Every plan fits a block's 227 KB and holds the rows it names (both
    wires' at once, or one); positions add the survivors' lists, the
    bitmap does not; a refusal only where one row and its lists do not
    fit."""
    for topk in (1, 16, 64, chunk // 3, chunk - 1):
        try:
            together, smem = ops.compact_gt_plan(chunk, topk, bitmap)
        except ValueError as err:
            assert "shared memory" in str(err)
            assert 4 * (chunk + (0 if bitmap else 2 * topk)) > ops.SMEM_LIMIT_BYTES - 4096
            continue
        rows = 2 if together else 1
        assert rows * 4 * (chunk + (0 if bitmap else 2 * topk)) < smem <= ops.SMEM_LIMIT_BYTES
        if not bitmap:
            assert smem - ops.compact_gt_plan(chunk, topk, True)[1] == 4 * 2 * rows * topk


def test_compact_gt_plan_layouts():
    """The paths' shapes run both wires at once; the 32,776-column chunk
    runs them one after the other; a chunk too wide for one row raises."""
    for topk, bitmap in ((64, True), (16, False)):
        assert ops.compact_gt_plan(512, topk, bitmap)[0]
    assert not ops.compact_gt_plan(32776, 16, False)[0]
    assert not ops.compact_gt_plan(32776, 16, True)[0]
    with pytest.raises(ValueError, match="shared memory"):
        ops.compact_gt_plan(65536, 16, True)


# --- the top-k divergence of ROADMAP.md queue 3 --------------------------

def test_topk_gossip_divergence_is_the_references():
    """The queue's standalone case: ``make_compressed_flat_gossip`` at
    chunk 16, k = 4, 60 rounds on the ring, from the same (8, 64) normal
    data. The spread ||x - mean x|| grows (the top-k wire diverges at small
    k) -- by the same factor in both packages, within rtol 1e-3: parity,
    not convergence, is the contract."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    from repro.core import compression as j_comp
    from repro_torch.core import compression

    n, t, chunk, topk, rounds = 8, 64, 16, 4, 60
    w = mixing_matrix("ring", n)
    x0 = np.random.default_rng(0).normal(size=(n, t)).astype(np.float32)

    def spread(x):
        x = np.asarray(x, np.float64)
        return float(np.linalg.norm(x - x.mean(axis=0)))

    gossip = compression.make_compressed_flat_gossip(w, scale_chunk=chunk, topk=topk)
    x, st = torch.as_tensor(x0), compression.init_flat_compression_state(torch.as_tensor(x0))
    j_gossip = j_comp.make_compressed_flat_gossip(w, scale_chunk=chunk, topk=topk)
    jx = jnp.asarray(x0)
    jst = j_comp.init_flat_compression_state(jx)
    for _ in range(rounds):
        x, st = gossip(x, st)
        jx, jst = j_gossip(jx, jst)
    mine, theirs = spread(_np(x)) / spread(x0), spread(jx) / spread(x0)
    assert mine > 5.0, mine  # diverges
    np.testing.assert_allclose(mine, theirs, rtol=1e-3)
