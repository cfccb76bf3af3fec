"""Fused rounds at every federation size the reference runs.

The round kernels of the port hold W_off whole in each block's shared
memory beside a tile of every input, so past about 130-170 nodes their
one-pass plan (``ops.plan_round``) refuses the round. The wrappers then
take the two-pass route (``ops.plan_route``): the wire stage
(``csrc/wire_stage.cu``), then the mix kernel (``csrc/round_mix.cu``).

* The wrappers (their CPU twins) against the reference's Pallas kernels
  ``fused_round_pallas``, ``fused_round_gt_pallas`` and
  ``gossip_mix_pallas`` in interpret mode, at 192 and 512 nodes dense and
  128 at top-64, on a ring, an Erdos-Renyi graph and the complete graph,
  over every (ef, dc, stale).
* The two-pass composition of the twins (the wire-stage twin, then the
  mix twin) against the one-pass twin, bitwise.
* The route planner and the mix's plan (pure Python): every shape the
  one-pass kernel served keeps its plan; every shape it refuses takes two
  passes; the mix's lists are each row's nonzeros for every W the
  topology programs realize; on ``meta`` tensors the route counts its two
  launches.
* ``train_decentralized(engine="fused")`` at 192 nodes against the
  reference's.
* On the card (``cuda`` marker, skipped here): the route against the
  twins (2,101 nodes under the stale mix too), the mix kernel alone at
  ragged shapes, on a ring, the complete graph and random graphs up to
  16,000 nodes (its band path), and the route equal to the one-pass
  kernel bitwise where both run.

Tolerances: as tests/test_torch_gossip_kernels.py -- recon', res' and the
scales within 1e-6 of Pallas (bitwise on the card), ``mixed`` within the
reference suite's 1e-5 x max(1, max|input|) (the n x n sum runs in
another order); against Pallas also the rare int8 step that its own
rounding moves (``_compare_pallas``). Three training rounds: the loss within rtol 1e-5 and the
consensus parameters within 1e-5 (an ulp of gradient can move an int8
step, not seen at this size).
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
ALPHA = np.float32(0.02)
# the reference's shapes the one-pass plan refuses: (n, t, topk)
PALLAS_SHAPES = [(192, 1024, None), (512, 1024, None), (128, 1024, 64)]
TOPOLOGIES = {"ring": {}, "erdos_renyi": {"p": 0.05, "seed": 1}, "complete": {}}
# the round kernels: name -> wires (ops.plan_route's count)
KERNELS = {"gossip_mix": ops.GOSSIP_STAGE, "fused_round": 1, "fused_round_gt": 2}
# the wire stage that is pass 1 of each round's two-pass route
ROUTE_WIRE = {"gossip_mix": ops.wire_stage_gossip, "fused_round": ops.wire_stage,
              "fused_round_gt": ops.wire_stage_gt}
CHUNK = 512


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def jax_gossip():
    """The reference's Pallas dispatch (imported here, not at module
    level, so the card-only tests run where JAX is absent)."""
    pytest.importorskip("jax")
    from repro.kernels.gossip import ops as j_ops

    return j_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode "
                    "(python3 chip_smoke.py runs the same checks there)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _weights(n, topo="ring"):
    w = mixing_matrix(topo, n, **TOPOLOGIES.get(topo, {}))
    return (np.asarray(w - np.diag(np.diag(w)), np.float32),
            np.asarray(np.diag(w), np.float32))


def _inputs(n, t, wires, seed):
    """The round's (n, t) inputs: the gossip stage's x, recon, res; DSGD's
    x, g, recon, res; DSGT's x, t, g, g_prev and two (recon, res)."""
    rng = np.random.default_rng(seed)
    mults = {ops.GOSSIP_STAGE: [1.0, 1.0, 0.1], 1: [1.0, 1.0, 1.0, 0.1],
             2: [1.0, 0.3, 0.5, 0.5, 1.0, 0.1, 1.0, 0.1]}[wires]
    return [np.asarray(m * rng.normal(size=(n, t)), np.float32) for m in mults]


def _t(arrays, device="cpu"):
    return [torch.as_tensor(a, device=device) for a in arrays]


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _call(kernel_name, mod, bufs, w_off, w_self, **kw):
    """One round of ``kernel_name`` through ``mod`` (the port's ops or the
    reference's)."""
    fn = getattr(mod, kernel_name)
    if kernel_name == "gossip_mix":
        return fn(*bufs, w_off, w_self, **kw)
    return fn(*bufs, w_off, w_self, ALPHA, **kw)


def _n_mixed(wires):
    return max(wires, 1)


def _split(outs, wires):
    """(mixed, recon', res', scales), a list a wire each, from a round's
    outputs (DSGT's: mixed_x, mixed_t, recon_x, res_x, recon_t, res_t,
    scales_x, scales_t)."""
    outs = [_np(o) for o in outs]
    if wires != 2:
        return [[o] for o in outs]
    return [outs[0:2], outs[2:6:2], outs[3:6:2], outs[6:8]]


def _compare_pallas(got, want, wires, w_off, stale, scale, what):
    """The port's round against the reference's Pallas kernel (interpret
    mode). The reference's Pallas update can round an ulp away from its
    own jnp twin (which the port equals bitwise), and where that ulp puts
    a payload on the other side of an int8 rounding boundary, recon'
    moves by one quantization step. So: the scales within 1e-6; recon'
    and res' within 1e-6 but at such flips, where they differ by exactly
    one step of their (row, chunk) and which are rare (at most 1e-4 of
    the elements); mixed within 1e-5 x max(1, max|input|) once the
    flipped steps are mixed in (``W_off @ d``, for the mix against the new
    recon')."""
    (gm, gr, gs, gsc), (wm, wr, ws, wsc) = _split(got, wires), _split(want, wires)
    for i in range(len(gm)):
        np.testing.assert_allclose(gsc[i], wsc[i], rtol=0, atol=STATE_ATOL,
                                   err_msg=f"{what} scales {i}")
        step = np.repeat(wsc[i], CHUNK, axis=1)
        d = wr[i] - gr[i]
        flips = np.abs(d) > STATE_ATOL
        assert flips.sum() <= max(4, 1e-4 * d.size), (what, int(flips.sum()))
        np.testing.assert_allclose(np.abs(d[flips]), step[flips], rtol=0, atol=STATE_ATOL,
                                   err_msg=f"{what} recon {i}")
        e = ws[i] - gs[i]
        np.testing.assert_allclose(e[~flips], 0.0, rtol=0, atol=STATE_ATOL,
                                   err_msg=f"{what} res {i}")
        assert (np.abs(e[flips]) <= step[flips] + STATE_ATOL).all(), what
        shift = 0.0 if stale else w_off @ np.where(flips, d, 0.0).astype(np.float32)
        np.testing.assert_allclose(gm[i] + shift, wm[i], rtol=0,
                                   atol=ATOL * max(1.0, scale), err_msg=f"{what} mixed {i}")


# ---------------------------------------------------------------------------
# the wrappers against the reference's Pallas kernels (interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("topo", list(TOPOLOGIES))
@pytest.mark.parametrize("shape", PALLAS_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}-top{s[2]}")
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_wrappers_match_pallas_past_the_one_pass_plan(jax_gossip, kernel, shape, topo):
    """At every (ef, dc, stale): the port's wrapper on the CPU equals the
    reference's Pallas kernel in interpret mode at a federation the
    one-pass plan refuses."""
    import jax.numpy as jnp

    n, t, topk = shape
    wires = KERNELS[kernel]
    # DSGD and the gossip stage still fit one pass at 128 nodes, top-64
    two = n > 128 or wires == 2
    assert ops.plan_route(n, t, CHUNK, topk, wires)[0] == (ops.TWO_PASS if two
                                                            else ops.ONE_PASS)
    w_off, w_self = _weights(n, topo)
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _inputs(n, t, wires, seed=10 * k + n)
        kw = dict(scale_chunk=CHUNK, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        got = _call(kernel, ops, _t(bufs), *_t([w_off, w_self]), **kw)
        want = _call(kernel, jax_gossip, [jnp.asarray(b) for b in bufs],
                     jnp.asarray(w_off), jnp.asarray(w_self), **kw)
        scale = max(float(np.abs(b).max()) for b in bufs)
        _compare_pallas(got, want, wires, w_off, stale, scale, f"{kernel} {topo} {kw}")


# ---------------------------------------------------------------------------
# the two-pass composition of the twins
# ---------------------------------------------------------------------------


def _two_pass_twin(wires, bufs, w_off, w_self, kw):
    """The wire-stage twin, then the mix twin: the two-pass route's
    arithmetic, in the route's output order."""
    stale = kw.pop("stale_mix")
    if wires == ops.GOSSIP_STAGE:  # no update: x itself is the self term
        x, recon, res = bufs
        q, sc, nr, ns = ref.wire_stage_gossip_ref(x, recon, res, **kw)
        # the DSGD stage with a zero update is the same arithmetic
        h, *dsgd = ref.wire_stage_ref(x, torch.zeros_like(x), recon, res, np.float32(0.0), **kw)
        assert torch.equal(h, x) and all(torch.equal(a, b) for a, b in zip((q, sc, nr, ns), dsgd))
        return ref.round_mix_ref(w_off, w_self, recon if stale else nr, x), nr, ns, sc
    if wires == 1:
        x, g, recon, res = bufs
        h, _, sc, nr, ns = ref.wire_stage_ref(x, g, recon, res, ALPHA, **kw)
        return ref.round_mix_ref(w_off, w_self, recon if stale else nr, h), nr, ns, sc
    (h, th, _, scx, nrx, nsx, _, sct, nrt, nst) = ref.wire_stage_gt_ref(*bufs, ALPHA, **kw)
    rx, rt = bufs[4], bufs[6]
    return (ref.round_mix_ref(w_off, w_self, rx if stale else nrx, h),
            ref.round_mix_ref(w_off, w_self, rt if stale else nrt, th),
            nrx, nsx, nrt, nst, scx, sct)


@pytest.mark.parametrize("topk", [None, 16])
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_two_pass_twins_compose_to_the_one_pass_twin(kernel, topk):
    """recon', res' and the scales bitwise at every (ef, dc, stale); the
    mix is the one-pass twin's own expression, so mixed is bitwise too."""
    wires = KERNELS[kernel]
    n, t, chunk = 36, 256, 64
    w_off, w_self = _t(_weights(n, "erdos_renyi"))
    twin = {"gossip_mix": ref.gossip_mix_ref, "fused_round": ref.fused_round_ref,
            "fused_round_gt": ref.fused_round_gt_ref}[kernel]
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _t(_inputs(n, t, wires, seed=k))
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        want = (twin(*bufs, w_off, w_self, **kw) if wires == ops.GOSSIP_STAGE
                else twin(*bufs, w_off, w_self, ALPHA, **kw))
        got = _two_pass_twin(wires, bufs, w_off, w_self, dict(kw))
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert torch.equal(a, b), (kernel, kw, i)


# ---------------------------------------------------------------------------
# the route planner
# ---------------------------------------------------------------------------

# (n, t, chunk, topks) of every shape the one-pass kernel serves in the
# port's checks, paths and drivers: the paper's buffer (main, its top-64
# and tie cases), the ragged zero-chunk shape, the large shape, the
# backbone scope's wire at chunk 128, the language model's 2-node round,
# the card tests' shapes (128 nodes among them)
ONE_PASS_SHAPES = [
    (20, 1536, 512, (None, 64, 128, 512)), (7, 384, 128, (None, 16, 32, 128)),
    (64, 1 << 20, 512, (None, 64)), (20, 1408, 128, (None, 16, 32, 128)),
    (2, 361_821_184, 512, (None,)), (16, 256, 64, (None, 8)), (8, 512, 128, (None, 16)),
    (64, 1024, 256, (None, 32)), (8, 96, 32, (None, 4)), (21, 1000, 40, (None,)),
]


@pytest.mark.parametrize("shape", ONE_PASS_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_served_shape_keeps_its_one_pass_plan(shape):
    n, t, chunk, topks = shape
    for wires, topk in itertools.product(KERNELS.values(), topks):
        if n == 128 and wires == 2 and topk:
            continue  # not served before: DSGT top-k at 128 nodes is the first refusal
        route, plan = ops.plan_route(n, t, chunk, topk, wires)
        assert route == ops.ONE_PASS, (shape, wires, topk)
        assert plan == ops.plan_round(n, t, chunk, topk, wires)
    # the 128-node card tests: dense for both rounds, DSGD also at top-64
    for wires, topk in ((1, None), (1, 64), (2, None)):
        assert ops.plan_route(128, 1024, 512, topk, wires)[0] == ops.ONE_PASS


@pytest.mark.parametrize("chunk", [32, 128, 512, 1024])
@pytest.mark.parametrize("topk", [None, 64])
@pytest.mark.parametrize("wires", list(KERNELS.values()))
def test_every_refused_shape_takes_two_passes(wires, topk, chunk):
    """Over node counts up to 4,096: a shape is two-pass exactly where
    ``plan_round`` raises its shared-memory refusal (which stays as it
    is), else the one-pass plan; the route never refuses."""
    seen = set()
    for n in list(range(4, 300, 4)) + [301, 512, 1024, 4096]:
        t = 4 * chunk
        route, plan = ops.plan_route(n, t, chunk, topk, wires)
        try:
            want = ops.plan_round(n, t, chunk, topk, wires)
        except ops.SharedMemoryRefusal:
            assert route == ops.TWO_PASS and plan == ops.mix_plan(n, t, max(wires, 1)), n
        else:
            assert route == ops.ONE_PASS and plan == want, n
        seen.add(route)
    assert seen == {ops.ONE_PASS, ops.TWO_PASS}
    with pytest.raises(ValueError, match="wires"):
        ops.plan_route(20, 1536, 512, None, 3)  # not a shared-memory refusal


def test_the_one_pass_limits():
    """The largest node count the one-pass plan takes at chunk 512: 172
    nodes for DSGD and the gossip stage dense, 164 at top-64, 128 and 120
    for DSGT; one more row group takes two passes."""
    for wires, topk, limit in ((1, None, 172), (ops.GOSSIP_STAGE, None, 172), (1, 64, 164),
                               (ops.GOSSIP_STAGE, 64, 164), (2, None, 128), (2, 64, 120)):
        assert ops.plan_route(limit, 1 << 16, 512, topk, wires)[0] == ops.ONE_PASS
        assert ops.plan_route(limit + 4, 1 << 16, 512, topk, wires)[0] == ops.TWO_PASS


@pytest.mark.parametrize("n,t", [(192, 65536), (1024, 262144), (512, 4096), (5, 3),
                                 (4096, 1 << 30), (130, 65536), (172, 65536), (194, 1530),
                                 (256, 65536), (2101, 64), (16000, 64), (16000, 1 << 20)])
@pytest.mark.parametrize("wires", [1, 2])
def test_mix_splits_fill_the_card_within_the_grid(n, t, wires):
    """The mix kernel's plan (``ops.mix_plan``): its shared memory fits a
    block's limit and is the staged rows' bytes (on the strip path also
    the warps' rings and each row's count and w_self); its strip is a
    multiple of 4 columns, a lane each (at most 128 B a row); it stages
    all n rows (the strip path) wherever a 4-column strip of them fits,
    the widest strip that does (128 B rows at 1,024 nodes), else windows
    of 128 B rows (the band path); its persistent grid, one block an SM,
    fills the card where the tiles allow and never passes them."""
    cols, window, smem, grid = ops.mix_plan(n, t, wires)
    assert cols % 4 == 0 and 4 <= cols <= 32
    meta = ops._MIX_RING_BYTES + 4 * (2 * n + -2 * n % 4)
    strip_fits = meta + 4 * 4 * n <= ops.SMEM_LIMIT_BYTES
    assert (window == n) == strip_fits
    if strip_fits:
        assert smem == meta + 4 * cols * n <= ops.SMEM_LIMIT_BYTES
        assert cols == 32 or meta + 4 * (cols + 4) * n > ops.SMEM_LIMIT_BYTES
        tiles = -(-t // cols) * wires
    else:
        assert cols == 32 and smem == 4 * cols * window
        assert window < n and smem + 4 * cols > ops.SMEM_LIMIT_BYTES >= smem
        tiles = -(-t // cols) * wires * -(-n // 256)
    assert grid == min(tiles, ops.H100_SMS)
    if n == 1024:
        assert (cols, window) == (32, 1024)  # 128 B rows


def _program_w_offs(w, rounds, **programs):
    """The realized W_off of ``rounds`` rounds of the fused engine under
    ``programs`` (``_round_gates`` advancing the counters)."""
    from repro_torch.core.engine import FusedEngine

    n = w.shape[0]
    eng, _ = FusedEngine.simulated(w, {"p": torch.zeros(n, 8)}, scale_chunk=8, **programs)
    comm = dict(eng._topo_init())
    out = []
    for _ in range(rounds):
        w_off, _, new, _ = eng._round_gates(comm)
        out.append(w_off)
        comm.update(new)
    return out


@pytest.mark.parametrize("programs", [
    dict(topology_program="node_churn:p_down=0.3,mean_downtime=2,seed=1"),
    dict(topology_program="edge_failure:p=0.3,seed=2"),
    dict(topology_program="round_robin_subgraphs"),
    dict(topology_program="rgg_rewire"),
    dict(node_program="payload_drop:p=0.2,seed=1"),
    dict(topology_program="edge_failure:p=0.2,seed=3",
         node_program="stragglers:frac=0.5,rate=0.5,drop=1"),
], ids=lambda p: "+".join(v.split(":")[0] for v in p.values()))
def test_block_list_covers_every_program_w(programs):
    """The mix reads only each row's listed nonzeros of W_off, listed on
    the card from the W of the round (``ops.mix_lists`` is the same list
    in Python): for 12 rounds of each program at 194 nodes, each row's
    list is its nonzero columns in ascending order with their weights,
    so the mix over the lists alone is the dense mix."""
    n, t = 194, 40
    w = mixing_matrix("erdos_renyi", n, p=0.03, seed=4)
    rng = np.random.default_rng(0)
    nbr = torch.as_tensor(rng.normal(size=(n, t)), dtype=torch.float32)
    seen = set()
    for w_off in _program_w_offs(w, 12, **programs):
        lists = ops.mix_lists(w_off)
        assert len(lists) == n
        listed = torch.zeros_like(w_off)
        for i, (cols, weights) in enumerate(lists):
            assert torch.equal(cols, torch.sort(cols).values)
            assert cols.tolist() == [j for j in range(n) if w_off[i, j] != 0]
            assert torch.equal(weights, w_off[i, cols])
            listed[i, cols] = weights
        assert torch.equal(listed, w_off)
        np.testing.assert_allclose(_np(listed @ nbr), _np(w_off @ nbr), rtol=0, atol=0)
        seen.add(tuple(c.numel() for c, _ in lists))
    if "topology_program" in programs:
        assert len(seen) > 1  # the program changes which neighbours are listed


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_meta_route_counts_two_launches(kernel):
    """On ``meta`` tensors (the dry run) a refused shape counts its wire
    pass under its wire stage's ``launches`` and its mix under
    ``round_mix.launches``, never the one-pass count, and allocates the
    one-pass wrapper's outputs; a served shape counts one launch."""
    wires = KERNELS[kernel]
    fn = getattr(ops, kernel)
    for n, t, two in ((192, 2048, True), (20, 1536, False)):
        bufs = [torch.empty(n, t, device="meta") for _ in range(
            {ops.GOSSIP_STAGE: 3, 1: 4, 2: 8}[wires])]
        w_off, w_self = torch.empty(n, n, device="meta"), torch.empty(n, device="meta")
        wire = ROUTE_WIRE[kernel]
        before = (fn.launches, wire.launches, ops.round_mix.launches)
        outs = _call(kernel, ops, bufs, w_off, w_self, scale_chunk=CHUNK)
        after = (fn.launches, wire.launches, ops.round_mix.launches)
        assert [a - b for a, b in zip(after, before)] == ([0, 1, 1] if two else [1, 0, 0])
        nw = _n_mixed(wires)
        assert [tuple(o.shape) for o in outs] == (
            [(n, t)] * 3 * nw + [(n, t // CHUNK)] * nw)
        assert all(o.device.type == "meta" and o.dtype == torch.float32 for o in outs)


def test_round_mix_twin_and_refusals():
    """``round_mix`` on the CPU is its twin, one or two wires; it refuses
    a third wire, mismatched buffers and a wrong W."""
    n, t = 10, 12
    w_off, w_self = _t(_weights(n, "erdos_renyi"))
    a, b, c, d = _t(_inputs(n, t, 1, seed=3))
    before = ops.round_mix.launches
    m1, m2 = ops.round_mix(w_off, w_self, (a, c), (b, d))
    assert torch.equal(m1, w_off @ a + w_self[:, None] * b)
    assert torch.equal(m2, ref.round_mix_ref(w_off, w_self, c, d))
    assert ops.round_mix.launches == before  # a twin call is no launch
    with pytest.raises(ValueError, match="one or two wires"):
        ops.round_mix(w_off, w_self, (a, b, c), (a, b, c))
    with pytest.raises(ValueError, match="one or two wires"):
        ops.round_mix(w_off, w_self, (a,), (a, b))
    with pytest.raises(ValueError, match="expected"):
        ops.round_mix(w_off, w_self, (a,), (torch.zeros(n, t + 1),))
    with pytest.raises(ValueError, match="do not match"):
        ops.round_mix(w_off[:5], w_self, (a,), (b,))


@pytest.mark.parametrize("kernel", list(KERNELS))
def test_route_wire_stages_skip_q_on_request(kernel):
    """Each round's pass-1 wire stage on the CPU is its twin; with
    ``store_q=False`` (the route's call) its int8 payloads are None and
    every other output is unchanged; a twin call is no launch."""
    wires, wire = KERNELS[kernel], ROUTE_WIRE[kernel]
    n, t, chunk = 10, 128, 32
    bufs = _t(_inputs(n, t, wires, seed=4))
    args = bufs if wires == ops.GOSSIP_STAGE else (*bufs, ALPHA)
    twin = {ops.GOSSIP_STAGE: ref.wire_stage_gossip_ref, 1: ref.wire_stage_ref,
            2: ref.wire_stage_gt_ref}[wires]
    q_at = {ops.GOSSIP_STAGE: (0,), 1: (1,), 2: (2, 6)}[wires]
    before = wire.launches
    for topk in (None, 8):
        want = twin(*args, scale_chunk=chunk, topk=topk)
        full = wire(*args, scale_chunk=chunk, topk=topk)
        lean = wire(*args, scale_chunk=chunk, topk=topk, store_q=False)
        assert len(full) == len(lean) == len(want)
        for i, (a, b, c) in enumerate(zip(full, lean, want)):
            assert torch.equal(a, c), (topk, i)
            assert (b is None) if i in q_at else torch.equal(b, c), (topk, i)
        assert all(full[i].dtype == torch.int8 for i in q_at)
    assert wire.launches == before


# ---------------------------------------------------------------------------
# training at 192 nodes against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_train_decentralized_fused_at_192_nodes_matches_reference(algorithm):
    """``train_decentralized(engine="fused")`` on a 192-hospital ring
    (the EHR cohort cut into 192 sites, the 42 -> 32 -> 2 MLP, Q = 10)
    for 3 rounds, from the reference's init, against the reference's
    trainer on its Pallas engine (interpret mode): per-round loss within
    rtol 1e-5, the consensus parameters within 1e-5."""
    import jax

    from repro.configs.base import FLRunConfig as JFLRunConfig
    from repro.configs.ehr_mlp import class_weights as j_class_weights
    from repro.models.mlp import make_mlp_loss as j_make_mlp_loss
    from repro.models.mlp import mlp_init as j_mlp_init
    from repro.training.trainer import train_decentralized as j_train
    from repro_torch.configs.base import FLRunConfig
    from repro_torch.configs.ehr_mlp import class_weights
    from repro_torch.convert import params_from_numpy
    from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher
    from repro_torch.models.mlp import make_mlp_loss
    from repro_torch.training.trainer import train_decentralized

    n = 192
    kw = dict(algorithm=algorithm, q=10, topology="ring", n_nodes=n, batch_per_node=20,
              alpha0=0.02)
    init = j_mlp_init(jax.random.key(0))
    single = params_from_numpy(jax.tree_util.tree_map(np.asarray, init), device="cpu")

    def batches():
        return make_node_batcher(generate_ehr_cohort(seed=0, n_hospitals=n), m=20, seed=1)

    res = train_decentralized(make_mlp_loss(class_weights()), single, FLRunConfig(**kw),
                              batches(), rounds=3, engine="fused", device="cpu")
    j_res = j_train(j_make_mlp_loss(j_class_weights()), init, JFLRunConfig(**kw), batches(),
                    rounds=3, engine="fused")
    assert res.engine.name == "fused" and res.engine.layout.n_nodes == n
    assert ops.plan_route(n, res.engine.layout.total, 512, None, 2 if algorithm == "dsgt"
                          else 1)[0] == ops.TWO_PASS
    np.testing.assert_allclose(res.history.column("loss"), j_res.history.column("loss"),
                               rtol=1e-5)
    for k in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(_np(res.consensus[k][leaf]),
                                       np.asarray(j_res.consensus[k][leaf]), rtol=0,
                                       atol=1e-5, err_msg=f"{k}.{leaf}")


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

# (n, t, topk, topology, chunk): the first shapes past the one-pass plan, a
# dense W_off, sparse graphs of 1,024 and 2,101 nodes, and a ragged row
# group on a chunk
# that is not a multiple of 4 (the kernels' scalar path)
CARD_SHAPES = [(192, 4096, None, "ring", 512), (128, 2048, 64, "ring", 512),
               (512, 2048, None, "complete", 512), (1024, 2048, None, "erdos_renyi", 512),
               (194, 1530, None, "erdos_renyi", 306), (2101, 128, None, "erdos_renyi", 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_route_matches_twin_on_card(cuda, kernel, shape):
    """The two-pass route on the card against the one-pass twin, every
    (ef, dc, stale): recon', res' and scales bitwise, mixed within 1e-5 x
    max(1, max|input|); two launches a call, none of the one-pass
    kernel."""
    n, t, topk, topo, chunk = shape
    wires = KERNELS[kernel]
    if ops.plan_route(n, t, chunk, topk, wires)[0] != ops.TWO_PASS:
        pytest.skip("the one-pass kernel serves this shape")
    fn = getattr(ops, kernel)
    w_off, w_self = _t(_weights(n, topo), cuda)
    twin = {"gossip_mix": ref.gossip_mix_ref, "fused_round": ref.fused_round_ref,
            "fused_round_gt": ref.fused_round_gt_ref}[kernel]
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _t(_inputs(n, t, wires, seed=k), cuda)
        kw = dict(scale_chunk=chunk, error_feedback=ef, difference_coding=dc,
                  stale_mix=stale, topk=topk)
        wire = ROUTE_WIRE[kernel]
        before = (fn.launches, wire.launches, ops.round_mix.launches)
        got = _call(kernel, ops, bufs, w_off, w_self, **kw)
        want = (twin(*bufs, w_off, w_self, **kw) if wires == ops.GOSSIP_STAGE
                else twin(*bufs, w_off, w_self, ALPHA, **kw))
        torch.cuda.synchronize()
        after = (fn.launches, wire.launches, ops.round_mix.launches)
        assert [a - b for a, b in zip(after, before)] == [0, 1, 1]
        nw = _n_mixed(wires)
        scale = max(1.0, max(float(b.abs().max()) for b in bufs))
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape and a.dtype == b.dtype, (kw, i)
            if i < nw:
                assert float((a - b).abs().max()) <= ATOL * scale, (kw, i)
            else:
                assert torch.equal(a, b), (kw, i)


def _card_weights(n, graph, device):
    """W_off and w_self on the card: the ring's or the complete graph's,
    or (``random``) a random W_off with exact zeros -- 2% dense past 100
    nodes, 70% below -- made on the card from a seed (n = 16,000 is 1 GB)."""
    if graph != "random":
        return _t(_weights(n, graph), device)
    gen = torch.Generator(device=device).manual_seed(n)
    w = torch.rand(n, n, generator=gen, device=device)
    w *= torch.rand(n, n, generator=gen, device=device) >= (0.98 if n > 100 else 0.3)
    w.fill_diagonal_(0.0)
    return w, torch.rand(n, generator=gen, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t,offset,graph", [
    (1024, 4096, 0, "random"), (7, 1030, 0, "random"), (2101, 64, 0, "random"),
    (300, 1027, 1, "random"), (5, 3, 0, "random"), (1024, 4096, 0, "ring"),
    (512, 4096, 0, "complete"), (16000, 64, 0, "random"), (16000, 67, 1, "random")])
@pytest.mark.parametrize("wires", [1, 2])
def test_round_mix_kernel_matches_twin_on_card(cuda, n, t, offset, graph, wires):
    """The mix kernel alone: the 16-byte and the 4-byte copies (t not a
    multiple of 4, a buffer one float off 16-byte alignment), a ragged
    last strip, a ring, the complete graph and a random W with exact
    zeros, the strip path with narrower strips (2,101 nodes) and the
    band path with its j windows (16,000); within 1e-5 of the twin at the
    scale of W's row sums. (The stale mix, both wires, runs through the
    route in test_route_matches_twin_on_card at 2,101 nodes.)"""
    w_off, w_self = _card_weights(n, graph, cuda)
    gen = torch.Generator(device=cuda).manual_seed(t)
    bufs = []
    for _ in range(2 * wires):
        flat = torch.randn(n * t + offset, generator=gen, device=cuda)
        bufs.append(flat[offset:].view(n, t))
    nbrs, srcs = bufs[:wires], bufs[wires:]
    before = ops.round_mix.launches
    got = ops.round_mix(w_off, w_self, nbrs, srcs)
    torch.cuda.synchronize()
    assert ops.round_mix.launches == before + 1
    scale = float(w_off.abs().sum(dim=1).max()) + 1.0
    for g, a, b in zip(got, nbrs, srcs):
        want = ref.round_mix_ref(w_off, w_self, a, b)
        assert float((g - want).abs().max()) <= ATOL * scale * 4


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(20, 1536, "hospital20"), (128, 65536, "ring")],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kernel", list(KERNELS))
def test_route_mix_equals_one_pass_bitwise_on_card(cuda, kernel, shape):
    """Where the one-pass kernel runs, the route's wire stage (no int8
    store) then the mix kernel give its bits, every (ef, dc, stale):
    mixed by ``torch.equal`` (both sum each output's nonzero terms in
    ascending j, then add w_self * self), recon', res' and the scales
    bitwise."""
    n, t, topo = shape
    wires = KERNELS[kernel]
    assert ops.plan_route(n, t, CHUNK, None, wires)[0] == ops.ONE_PASS
    w_off, w_self = _t(_weights(n, topo), cuda)
    alpha = None if wires == ops.GOSSIP_STAGE else ALPHA
    for k, (ef, dc, stale) in enumerate(FLAGS):
        bufs = _t(_inputs(n, t, wires, seed=k), cuda)
        kw = dict(scale_chunk=CHUNK, error_feedback=ef, difference_coding=dc)
        one = _call(kernel, ops, bufs, w_off, w_self, stale_mix=stale, **kw)
        olds = (bufs[4], bufs[6]) if wires == 2 else (bufs[wires + 1],)
        mixed, recons, ress, scales = ops._route(wires, bufs, olds, w_off, w_self, alpha,
                                                 stale, topk=None, **kw)
        torch.cuda.synchronize()
        nw = _n_mixed(wires)
        routed = (mixed + recons + ress + scales if wires != 2 else
                  mixed + (recons[0], ress[0], recons[1], ress[1]) + scales)
        assert len(routed) == len(one)
        for i, (a, b) in enumerate(zip(routed, one)):
            assert torch.equal(a, b), (kernel, shape, (ef, dc, stale), i, nw)
