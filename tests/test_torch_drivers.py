"""The standalone drivers of the PyTorch port (ROADMAP.md item 17a)
against the reference's ``benchmarks/`` on the CPU.

* ``thm1_speedup.run_one`` at N 4, 8 and 16, T 20, one seed: within rtol
  1e-4 of the reference's (the same numpy targets and noise).
* ``ablations._run`` on each topology (DSGD and DSGT) and on Q 1 and 4 at
  reduced iterations: consensus_err and dist_to_opt within rtol 1e-3, the
  spectral gap within 1e-12.
* ``comm_bytes.main()``: every row's bytes exactly the reference's.
* ``kernel_bench``: every dense-wire, attention and scan bound of
  ``PERF.md`` section 6 recomputed from its counters equals the printed
  value to 0.01 µs (the cells whose operations depend on the drawn
  top-k payload are exempt), and ``--device cpu`` writes null kernel and
  library columns.
* ``comm_bytes.cross_check``: the int8 flat-wire row against the
  committed dry-run records (``experiments/dryrun_torch``), edge by edge,
  the padding to whole chunks in every tile itemized.
* ``roofline``: the committed records priced with the H100's figures
  alone, a row by hand.
* ``run.py --smoke`` on the CPU writes every table's JSON and the CSV; the
  roofline row prints the committed records' roofline; ``thm1_speedup --two-axis --smoke`` runs
  the two-axis table on gloo ranks (each cell's per-shard bytes x shards
  == its wire bytes).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.benchmarks import ablations, comm_bytes, kernel_bench, thm1_speedup  # noqa: E402
from repro_torch.benchmarks import run as run_all  # noqa: E402
from repro_torch.kernels.gossip.ops import mix_lists  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


@pytest.fixture(scope="module")
def ref():
    """The reference's drivers (``benchmarks/`` at the repository root)."""
    pytest.importorskip("jax")
    sys.path.insert(0, str(ROOT))
    try:
        from benchmarks import ablations as j_ablations
        from benchmarks import comm_bytes as j_comm_bytes
        from benchmarks import thm1_speedup as j_thm1
    finally:
        sys.path.remove(str(ROOT))
    return j_thm1, j_ablations, j_comm_bytes


@pytest.mark.parametrize("n", thm1_speedup.NODES)
def test_thm1_run_one_matches_reference(ref, n):
    j_thm1 = ref[0]
    got = thm1_speedup.run_one(n, 20, seed=0, device="cpu")
    want = j_thm1.run_one(n, 20, seed=0)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("topology", ablations.TOPOLOGIES)
@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_ablation_topology_runs_match_reference(ref, topology, algorithm):
    j_ablations = ref[1]
    got = ablations._run(topology, 1, 2.0, 40, 0.05, algorithm=algorithm, device="cpu")
    want = j_ablations._run(topology, 1, 2.0, 40, 0.05, algorithm=algorithm)
    for key in ("consensus_err", "dist_to_opt"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    assert got["comm_rounds"] == want["comm_rounds"]
    assert abs(got["spectral_gap"] - want["spectral_gap"]) <= 1e-12


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("heterogeneity", ablations.HETEROGENEITY)
def test_ablation_drift_runs_match_reference(ref, q, heterogeneity):
    j_ablations = ref[1]
    got = ablations._run("ring", q, heterogeneity, 48, 0.05, device="cpu")
    want = j_ablations._run("ring", q, heterogeneity, 48, 0.05)
    for key in ("consensus_err", "dist_to_opt"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-3, err_msg=key)
    assert got["comm_rounds"] == want["comm_rounds"] == 48 // q


def test_comm_bytes_rows_are_the_references(ref):
    j_comm_bytes = ref[2]
    got, want = comm_bytes.main(log=False), j_comm_bytes.main()
    assert got["arch"] == want["arch"] and got["param_bytes"] == want["param_bytes"]
    assert [r["strategy"] for r in got["rows"]] == [r["strategy"] for r in want["rows"]]
    for g, w in zip(got["rows"], want["rows"]):
        assert g["bytes_per_iter_per_node"] == w["bytes_per_iter_per_node"], g["strategy"]
        assert g["ratio_vs_centralized"] == w["ratio_vs_centralized"], g["strategy"]


#: PERF.md section 6's bounds, µs, H100 SXM peaks: (kernel, shape) ->
#: bound, the shapes of kernel_bench (the gossip kernels' dense wire and
#: the DSGD compact stage, whose operations depend on no data)
PERF_BOUNDS = {
    ("fused_round", "main"): 0.26, ("fused_round", "large"): 561.07,
    ("fused_round_gt", "main"): 0.51, ("fused_round_gt", "large"): 1122.14,
    ("gossip_mix", "main"): 0.22, ("gossip_mix", "large"): 480.94,
    ("wire_stage", "main"): 0.27, ("wire_stage", "large"): 581.10,
    ("wire_stage_gt", "main"): 0.53, ("wire_stage_gt", "large"): 1162.20,
    ("wire_stage_compact", "main"): 0.26, ("wire_stage_compact", "large"): 566.07,
    ("wire_stage_compact", "main top-16"): 0.26,
    ("decode_attention", "path"): 0.59, ("decode_attention", "large"): 100.17,
    ("decode_attention", "hd256 path"): 0.41,
    ("flash_attention", "path"): 1.57, ("flash_attention", "large"): 65.16,
    ("flash_attention", "hd256 path"): 3.44,
    ("wkv6", "path decode"): 5.21, ("wkv6", "large"): 806.31,
    ("wkv6", "path prefill"): 30.05,
    ("rglru_scan", "path decode"): 0.12, ("rglru_scan", "large"): 300.54,
    ("rglru_scan", "path prefill"): 9.44,
}
#: the zoo's attention shapes: (label, decode args | flash args, µs)
ZOO_DECODE = [("hd128 group 6", (8, 4096, 159, 48, 8, 128), 1.61),
              ("hd128 group 5", (8, 4096, 159, 40, 8, 128), 1.60),
              ("hd128 group 4", (8, 4096, 159, 40, 10, 128), 1.99),
              ("whisper self", (8, 448, 159, 16, 16, 64), 1.57),
              ("whisper cross", (8, 1500, 1500, 16, 16, 64), 14.68)]
ZOO_FLASH = [("hd128 group 6", (8, 128, 128, 48, 8, 128, True, 0), 8.76),
             ("hd128 group 5", (8, 128, 128, 40, 8, 128, True, 0), 7.51),
             ("hd128 group 4", (8, 128, 128, 40, 10, 128, True, 0), 7.83),
             ("internvl2 prefix + prompt", (8, 1152, 1152, 48, 8, 128, True, 0), 132.03),
             ("whisper encoder", (8, 1500, 1500, 16, 16, 64, False, 0), 74.55),
             ("whisper cross", (8, 128, 1500, 16, 16, 64, False, 0), 15.92)]


def test_kernel_bench_bounds_are_perf_mds():
    got = {}
    for cases in (kernel_bench.gossip_cases("cpu", counts_only=True),
                  kernel_bench.compact_cases("cpu", counts_only=True),
                  kernel_bench.attention_cases("cpu", counts_only=True),
                  kernel_bench.scan_cases("cpu", counts_only=True)):
        for case in cases:
            assert case.run is None and case.twin is None
            got[(case.kernel, case.shape)] = round(case.bound[0] * 1e3, 2)
    assert got == PERF_BOUNDS
    for label, args, want in ZOO_DECODE:
        case = kernel_bench.decode_case(label, *args, None, counts_only=True)
        assert round(case.bound[0] * 1e3, 2) == want, label
        assert case.bound[1] == "bytes"
    for label, args, want in ZOO_FLASH:
        case = kernel_bench.flash_case(label, *args, None, counts_only=True)
        assert round(case.bound[0] * 1e3, 2) == want, label


def test_kernel_bench_prices_the_two_pass_route():
    """The 1,024-node federation's rounds take the two-pass route; its
    cases count the round's bytes (the function's, moved once) against
    both passes' operations, the wire pass the wire stage's bytes without
    the int8 payload, the mix each wire's three buffers and W; the mix's
    multiply-adds are W_off's nonzeros a row (the function's), which are
    the terms the mix kernel's lists hold; the mix alone also on the
    1,024-node ring and the 512-node complete graph."""
    label, n, t, chunk, _ = kernel_bench.FEDERATION
    w_off, _ = kernel_bench.federation_weights("cpu")
    terms = kernel_bench.mix_terms(w_off)
    assert terms == float((w_off != 0).sum()) / n
    assert 5 <= terms <= 20  # about ten neighbours a node
    # the kernel's terms: its lists hold each row's nonzeros and no more
    assert sum(cols.numel() for cols, _ in mix_lists(w_off)) / n == terms
    cases = {(c.kernel, c.shape): c for c in kernel_bench.two_pass_cases("cpu", counts_only=True)}
    assert len(cases) == 11
    for name, wires in (("gossip_mix", kernel_bench.GOSSIP_STAGE), ("fused_round", 1),
                        ("fused_round_gt", 2)):
        nw = max(wires, 1)
        assert kernel_bench.plan_route(n, t, chunk, None, wires)[0] == "two_pass"
        wire_name = kernel_bench.ROUTE_WIRES[name][0].__name__
        route, wire = cases[(name, f"{label} route")], cases[(wire_name, f"{label} {name}")]
        mix = cases[("round_mix", f"{label} {name}")]
        assert all(c.run is None and c.twin is None for c in (route, wire, mix))
        assert route.nbytes == (kernel_bench.gossip_bytes(n, t, chunk) if nw > wires
                                else kernel_bench.round_bytes(n, t, chunk, wires))
        assert wire.nbytes == kernel_bench.wire_bytes_moved(n, t, chunk, wires) - nw * n * t
        assert mix.nbytes == 4 * (3 * nw * n * t + n * n + n)
        assert wire.ops == kernel_bench.wire_ops(n, t, chunk, wires)
        assert mix.ops == int(nw * n * t * (2 + 2 * terms))
        assert route.ops == wire.ops + mix.ops
        for c in (route, wire, mix):
            assert c.bound == kernel_bench.bound(c.nbytes, c.ops)
        # the mix moves far more bytes than its operations take at the peaks
        assert mix.bound[1] == "bytes" and route.bound[1] == "bytes"
    # by hand: DSGD's 4 + 3 fp32 buffers of 1024 x 262144, W, w_self, the
    # scales and alpha; the gossip wire pass reads x, recon, res and
    # writes recon', res' and the scales; the mixes' byte bounds
    assert cases[("fused_round", f"{label} route")].nbytes == 7_522_488_324
    assert kernel_bench.wire_bytes_moved(n, t, chunk, kernel_bench.GOSSIP_STAGE, q=False) == (
        4 * (5 * n * t + n * (t // chunk)))
    assert kernel_bench.route_ops(n, t, chunk, kernel_bench.GOSSIP_STAGE) == (
        kernel_bench.stage_ops(n, t, chunk) + kernel_bench.mix_ops(n, t, 1))
    assert [round(cases[("round_mix", f"{label} {name}")].bound[0] * 1e3, 2)
            for name in ("fused_round", "fused_round_gt")] == [962.81, 1924.37]
    # the ring's two neighbours a node leave it bound by bytes as the ER
    # graph is; the complete graph's 511 terms a row by its operations
    ring, full = cases[("round_mix", "ring-1024 fused_round")], cases[
        ("round_mix", "complete-512 fused_round")]
    assert ring.nbytes == cases[("round_mix", f"{label} fused_round")].nbytes
    assert ring.ops == int(n * t * (2 + 2 * 2))
    assert full.nbytes == 4 * (3 * 512 * 65_536 + 512 * 512 + 512)
    assert full.ops == 512 * 65_536 * (2 + 2 * 511)
    assert ring.bound[1] == "bytes" and full.bound[1] == "operations"
    assert all(c.run is None and c.library is None for c in (ring, full))


def test_kernel_bench_on_the_cpu_times_the_twins_alone(tmp_path):
    out = tmp_path / "kb.json"
    rows = kernel_bench.main(["--device", "cpu", "--shapes", "main,path decode",
                              "--out", str(out)])
    assert json.loads(out.read_text()) == rows
    kernels = {r["kernel"] for r in rows}
    assert kernels == set(kernel_bench.ALL_KERNELS) | set(kernel_bench.COMPACT_KERNELS) | {
        "wkv6", "rglru_scan"}
    for r in rows:
        assert r["kernel_us"] is None and r["library_us"] is None and r["card"] is None
        assert r["twin_us"] > 0 and r["device"] == "cpu"
        assert r["bound_by"] in ("bytes", "operations")
        want = PERF_BOUNDS.get((r["kernel"], r["shape"]))
        if want is not None:
            assert round(r["bound_us"], 2) == want


def test_run_smoke_writes_the_tables(tmp_path, capsys):
    res = run_all.main(["--smoke", "--device", "cpu", "--out-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(run_all.OUTPUTS.values())
    thm1 = json.loads((tmp_path / "thm1_results_torch.json").read_text())
    assert set(thm1["measure"]) == {"4", "8", "16"}
    abl = json.loads((tmp_path / "ablations_torch.json").read_text())
    assert set(abl["topology"]) == set(ablations.TOPOLOGIES)
    cb = json.loads((tmp_path / "comm_bytes_torch.json").read_text())
    assert len(cb["rows"]) == 7
    lines = out.split("name,us_per_call,derived\n")[1].strip().splitlines()
    assert [line.split(",")[0] for line in lines] == [
        "fig2_comm_rounds", "thm1_linear_speedup", "comm_bytes_table", "kernel_bench",
        "ablations", "roofline"]
    assert [r["name"] for r in res["csv"]] == [line.split(",")[0] for line in lines]
    # the roofline row runs on the committed dry-run records, at H100 prices
    roof = next(line for line in lines if line.startswith("roofline,"))
    oks = sum(r["status"] == "ok" for r in res["roofline"])
    assert roof.split(",")[2].startswith(f"pairs={oks};")
    assert len(res["roofline"]) == 40 and "item 18" not in out


def test_refusals(capsys, tmp_path):
    """``--two-axis`` was refused until the two-axis layout was ported
    (ROADMAP.md item 15); it now runs the table on gloo ranks. An unknown
    table is still refused."""
    out = tmp_path / "thm1.json"
    res = thm1_speedup.main(["--two-axis", "--smoke", "--t-steps", "20", "--seeds", "1",
                             "--device", "cpu", "--out", str(out)])
    row = json.loads(out.read_text())["two_axis"]
    assert row == res["two_axis"]
    for nodes, shards in ((8, 1), (4, 2), (2, 4)):
        tag = f"n{nodes}_s{shards}"
        assert row[f"wire_bytes_per_shard_{tag}"] * shards == row[f"wire_bytes_per_round_{tag}"]
        assert row[f"us_{tag}"] > 0
    assert "Two-axis round time" in capsys.readouterr().out
    with pytest.raises(SystemExit):
        run_all.main(["--skip", "nope", "--device", "cpu"])


@pytest.mark.parametrize("arch, padding", [("tinyllama-1.1b", 6192), ("dbrx-132b", 2064)])
def test_comm_bytes_cross_checks_the_dry_run(arch, padding, tmp_path, capsys):
    """One edge of the record's two-axis wire (16 tiles) is the table's
    int8 edge plus the padding to whole 512-column chunks in each of the
    16 tiles: 6,144 columns and their 12 scales for TinyLlama."""
    rec = json.loads((Path(__file__).resolve().parents[1] / "experiments" / "dryrun_torch"
                      / f"{arch}_train_4k_single_sharded_fused_shardmodel_q2.json").read_text())
    got = comm_bytes.cross_check(comm_bytes.main(arch, log=False), rec)
    assert got["padding_bytes"] == padding
    assert got["record_edge_bytes"] == 16 * rec["two_axis"]["wire_bytes_per_shard_one_edge"]
    if arch == "tinyllama-1.1b":
        assert padding == 6144 + 4 * 6144 // 512
        out = comm_bytes._cli(["--out", str(tmp_path / "cb.json")])
        assert out["cross_check"] == got and "cross-check" in capsys.readouterr().out
    bad = dict(rec, two_axis=dict(rec["two_axis"], wire_bytes_per_shard_one_edge=1))
    with pytest.raises(AssertionError):
        comm_bytes.cross_check(comm_bytes.main(arch, log=False), bad)


def test_roofline_prices_the_records_for_the_h100():
    from repro_torch.benchmarks import roofline

    assert (roofline.PEAK_FLOPS, roofline.HBM_BYTES_S) == (989e12, 3.35e12)
    assert (roofline.NVLINK_BYTES_S, roofline.IB_BYTES_S * 8) == (450e9, 400e9)
    src = Path(roofline.__file__).read_text()
    for tpu in ("197e12", "819e9", "50e9"):
        assert tpu not in src
    rows = roofline.rows_for("single")
    assert len(rows) == 40
    row = next(r for r in rows if (r["arch"], r["shape"]) == ("tinyllama-1.1b", "train_4k"))
    rec = next(r for r in roofline.load_records("single")
               if (r["arch"], r["shape"]) == ("tinyllama-1.1b", "train_4k"))
    coll = rec["collectives"]
    assert row["t_compute_s"] == rec["flops"] / 989e12
    assert row["t_memory_s"] == rec["traffic_bytes"] / 3.35e12
    assert row["t_collective_s"] == ((coll["total_bytes"] - coll["cross_node_bytes"]) / 450e9
                                     + coll["cross_node_bytes"] / (400e9 / 8))
    assert row["useful_ratio"] == 6.0 * rec["active_params"] * 4096 * 256 * 2 / (
        rec["flops"] * 256)
    wire = rec["two_axis"]["wire_bytes_per_shard_per_round"]
    assert row["t_wire_per_shard_s"] == wire / (400e9 / 8)
    assert next(r for r in rows if r["shape"] == "long_500k"
                and r["arch"] == "whisper-medium")["status"] == "skipped"
