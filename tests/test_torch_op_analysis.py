"""``repro_torch.launch.op_analysis`` by hand count, as
``tests/test_hlo_analysis.py`` holds the reference's HLO accounting: a
Q-step loop of L layers counts Q x L times one step's FLOPs (eager
PyTorch runs every iteration: there is no trip count to infer), a
backward counts the forward and its two gradient products, the
collectives on a fake group of 8 ranks count and weigh exactly (with the
bytes that cross a host boundary and a pod boundary), a hand kernel
called on ``meta`` is charged ``benchmarks/kernel_bench.py``'s count and
counts one launch, its twin on the CPU is no launch, and the live-bytes
peak follows the allocations."""

import pytest

torch = pytest.importorskip("torch")
dist = torch.distributed

from repro_torch.benchmarks import kernel_bench as kb  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.gossip.ops import wire_stage_gt, wire_stage_gt_compact  # noqa: E402
from repro_torch.kernels.rglru_scan.ops import rglru_scan  # noqa: E402
from repro_torch.launch.op_analysis import kernel_cost, op_analysis  # noqa: E402

M, K, N = 8, 16, 32


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("q,layers", [(1, 1), (4, 1), (2, 3)])
def test_q_steps_of_l_layers_count_q_times_l(q, layers, device):
    x = torch.ones(M, K, device=device)
    ws = [torch.ones(K, K, device=device) for _ in range(layers)]
    with op_analysis() as oa:
        for _ in range(q):
            h = x
            for w in ws:
                h = h @ w
    costs = oa.costs()
    assert costs.flops == q * layers * 2 * M * K * K
    assert costs.kernel_calls == {} and costs.collectives == {}


def test_backward_counts_forward_plus_backward():
    x = torch.ones(M, K, requires_grad=True)
    w = torch.ones(K, N, requires_grad=True)
    with op_analysis() as oa:
        (x @ w).sum().backward()
    # the forward product, then dL/dx = g w^T and dL/dw = x^T g
    assert oa.costs().flops == 3 * 2 * M * K * N


@pytest.fixture
def fake_rank3_of_8():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("cpu:fake,meta:fake", store=FakeStore(), rank=3, world_size=8)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_collectives_count_and_weigh_exactly(fake_rank3_of_8):
    """Rank 3 of 8 with 4 ranks a host: group A (0-3) stays in host 0,
    group B (1, 3, 5, 7) spans both; with 4 ranks a pod B crosses pods."""
    a = dist.new_group([0, 1, 2, 3])
    b = dist.new_group([1, 3, 5, 7])
    x = torch.empty(4, 16, device="meta")  # 256 B
    for pod, cross_pod in ((None, 0), (4, 1)):
        with op_analysis(ranks_per_host=4, pod_ranks=pod) as oa:
            out = torch.empty(16, 16, device="meta")
            dist.all_gather_into_tensor(out, x, group=a)  # 1024 B, inside host 0
            dist.all_gather_into_tensor(out, x, group=b)  # 1024 B, across hosts
            dist.all_reduce(x, group=b)  # 256 B, across
            dist.reduce_scatter_tensor(x, out, group=a)  # the input, 1024 B, inside
            ops = [dist.P2POp(dist.isend, x, 7, b),  # to rank 7: host 1
                   dist.P2POp(dist.irecv, torch.empty(2, 16, device="meta"), 1, b)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        c = oa.costs()
        assert c.collectives == {
            "all-gather": {"count": 2, "bytes": 2048, "cross_bytes": 1024},
            "all-reduce": {"count": 1, "bytes": 256, "cross_bytes": 256},
            "reduce-scatter": {"count": 1, "bytes": 1024, "cross_bytes": 0},
            "send": {"count": 1, "bytes": 256, "cross_bytes": 256},
            "recv": {"count": 1, "bytes": 128, "cross_bytes": 0},
        }
        assert c.collective_bytes == 2048 + 256 + 1024 + 256  # a receive is its sender's
        assert c.cross_node_bytes == 1024 + 256 + 256
        assert c.cross_pod_bytes == cross_pod * (1024 + 256 + 256)
        sends = [e for e in c.events if e["kind"] in ("send", "recv")]
        assert [(e["kind"], e["peer"], e["ranks"]) for e in sends] == [
            ("send", 7, (1, 3, 5, 7)), ("recv", 1, (1, 3, 5, 7))]
    # rank_stride: group rank g stands for rank 16 g of the layout, so even
    # the host-local group A spans hosts of 8
    with op_analysis(rank_stride=16) as oa:
        dist.all_reduce(x, group=a)
    assert oa.costs().cross_node_bytes == 256


def test_meta_kernels_are_charged_kernel_benchs_count():
    n, t, chunk = 2, 4096, 512
    bufs = [torch.empty(n, t, device="meta") for _ in range(8)]
    before = wire_stage_gt.launches, wire_stage_gt_compact.launches
    q = torch.empty(2, 256, 4, 64, device="meta", dtype=torch.bfloat16)
    kv = torch.empty(2, 256, 2, 64, device="meta", dtype=torch.bfloat16)
    with op_analysis() as oa:
        outs = wire_stage_gt(*bufs, 0.02, scale_chunk=chunk)
        wire_stage_gt_compact(*bufs, 0.02, scale_chunk=chunk, topk=64, bitmap=True)
        y = flash_attention(q, kv, kv, causal=True, window=100)
        rglru_scan(*(torch.empty(3, 5, 32, device="meta") for _ in range(2)),
                   torch.empty(3, 32, device="meta"))
    c = oa.costs()
    assert (wire_stage_gt.launches, wire_stage_gt_compact.launches) == (
        before[0] + 1, before[1] + 1)
    assert c.kernel_calls == {"wire_stage_gt": 1, "wire_stage_gt_compact": 1,
                              "flash_attention": 1, "rglru_scan": 1}
    want_ops = (kb.wire_ops(n, t, chunk, 2) + kb.compact_gt_ops(n, t, chunk, 64, True, 2 * n * t)
                + kb.flash_flops(2, 256, 256, 4, 64, True, 100) + kb.rglru_ops(3, 5, 32))
    assert c.kernel_flops == want_ops and c.flops == want_ops
    assert c.kernel_bytes == (kb.wire_bytes_moved(n, t, chunk, 2)
                              + kb.compact_bytes_moved(n, t, chunk, 2, 64, True)
                              + kb.flash_bytes(2, 256, 256, 4, 2, 64) + kb.rglru_bytes(3, 5, 32))
    # the windowed causal pairs: 100 x 101 / 2 ramping up, then 100 a query
    assert kb.flash_flops(2, 256, 256, 4, 64, True, 100) == 4 * 2 * 4 * 64 * (
        100 * 101 // 2 + 156 * 100)
    # the kernels' outputs, allocated with their shapes and dtypes
    assert [tuple(o.shape) for o in outs] == [(n, t)] * 2 + [(n, t), (n, 8), (n, t), (n, t)] * 2
    assert outs[2].dtype == torch.int8 and y.shape == q.shape and y.device.type == "meta"
    assert kernel_cost("wire_stage_gt", dict(n=n, t=t, chunk=chunk, topk=None)) == (
        kb.wire_ops(n, t, chunk, 2), kb.wire_bytes_moved(n, t, chunk, 2))


@pytest.mark.parametrize("name,wires", [("gossip_mix", kb.GOSSIP_STAGE), ("fused_round", 1),
                                        ("fused_round_gt", 2)])
def test_meta_two_pass_route_is_charged_two_launches(name, wires):
    """A round the one-pass plan refuses (192 nodes) counts its wire pass
    under its wire stage's name (with no int8 store) and its mix under
    ``round_mix``, each charged kernel_bench's count (the mix at a dense
    W: a ``meta`` W has no zeros to skip); a round it serves counts one
    launch."""
    from repro_torch.kernels.gossip import ops

    fn = getattr(ops, name)
    chunk = 512
    for n, t, two in ((192, 2048, True), (20, 1536, False)):
        bufs = [torch.empty(n, t, device="meta") for _ in range({0: 3, 1: 4, 2: 8}[wires])]
        w = (torch.empty(n, n, device="meta"), torch.empty(n, device="meta"))
        args = (*bufs, *w) + (() if wires == kb.GOSSIP_STAGE else (0.02,))
        with op_analysis() as oa:
            fn(*args, scale_chunk=chunk)
        c = oa.costs()
        if two:
            nw = max(wires, 1)
            wire = kb.ROUTE_WIRES[name][0].__name__
            assert c.kernel_calls == {wire: 1, "round_mix": 1}
            assert c.kernel_flops == (kb.wire_ops(n, t, chunk, wires)
                                      + kb.mix_ops(n, t, nw))
            assert c.kernel_bytes == (kb.wire_bytes_moved(n, t, chunk, wires, q=False)
                                      + kb.mix_bytes(n, t, nw))
            assert kernel_cost(wire, dict(n=n, t=t, chunk=chunk, topk=None, q=False)) == (
                kb.wire_ops(n, t, chunk, wires), kb.wire_bytes_moved(n, t, chunk, wires, False))
            assert kernel_cost("round_mix", dict(n=n, t=t, wires=nw)) == (
                kb.mix_ops(n, t, nw), kb.mix_bytes(n, t, nw))
        else:
            assert c.kernel_calls == {name: 1}


def test_a_twin_on_the_cpu_is_no_launch():
    bufs = [torch.zeros(2, 1024) for _ in range(8)]
    before = wire_stage_gt.launches
    with op_analysis() as oa:
        wire_stage_gt(*bufs, 0.02)
    assert wire_stage_gt.launches == before
    assert oa.costs().kernel_calls == {} and oa.costs().kernel_flops == 0


def test_peak_follows_the_live_allocations():
    with op_analysis() as oa:
        a = torch.empty(1000, device="meta")  # 4,000 B live
        b = a * 2  # 8,000
        del a  # 4,000
        c = b + 1  # 8,000
        d = torch.empty(250, device="meta", dtype=torch.float64)  # 10,000: the peak
        del b, c, d
    assert oa.costs().peak_bytes == 10_000
