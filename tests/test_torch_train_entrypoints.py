"""The LM trainer's entry points on the port, run on the CPU at a few
rounds: ``repro_torch.launch.train`` (the reference's flags and printed
JSON keys, plus ``device``), ``examples/quickstart.py``,
``benchmarks/serve_load.py --smoke``, ``examples/serve_consensus.py``
(the tokens served from the snapshots equal an in-memory engine's on the
published consensus) and ``examples/train_100m.py``; the refusals
(``sharded_fused``: the launcher's, and ``train_100m``'s naming ROADMAP.md
item 15) and the card default (each raises without ``--device cpu`` on
a machine with no card). The JSON keys are held against the reference's
own runs (the launcher, ``serve_consensus``) or its committed record
(``experiments/serve_ehr.json``)."""

import contextlib
import csv
import importlib.util
import io
import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import benchmarks.serve_load as j_serve_load  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro_torch.benchmarks import serve_load  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.examples import quickstart, serve_consensus, train_100m  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMALL = ["--rounds", "2", "--q", "2", "--nodes", "2", "--seq-len", "16", "--log-every", "0"]


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _json_tail(text: str) -> dict:
    """The JSON object a launcher printed (indented, after its log lines)."""
    return json.loads(text[text.index("\n{") + 1:] if not text.startswith("{")
                      else text)


def _reference_launcher(argv) -> dict:
    out = io.StringIO()
    old = sys.argv
    sys.argv = ["train.py", *argv]
    try:
        with contextlib.redirect_stdout(out):
            j_train.main()
    finally:
        sys.argv = old
    return _json_tail(out.getvalue())


def test_launcher_json_is_the_references():
    argv = ["--arch", "tinyllama-1.1b", *SMALL]
    want = _reference_launcher(argv)
    got = train.main([*argv, "--device", "cpu"])
    assert set(got) == set(want) | {"device"}
    assert got["device"] == "cpu"
    for key in ("arch", "fl_engine", "fl_schedule", "fl_topology_program",
                "fl_node_program", "fl_privacy", "fl_scope", "algorithm", "q", "rounds",
                "iterations", "dp_epsilon"):
        assert got[key] == want[key], key
    assert np.isfinite([got["loss_first"], got["loss_last"]]).all()


def test_launcher_round_axes_and_checkpoint(tmp_path):
    ck = tmp_path / "ck"
    got = train.main(["--arch", "smollm-360m", *SMALL, "--device", "cpu",
                      "--fl-engine", "fused", "--fl-staleness-depth", "2",
                      "--fl-privacy", "dp:sigma=0.5,clip=1.0", "--checkpoint", str(ck)])
    assert got["fl_schedule"] == "bounded_staleness:k=2"
    assert got["fl_privacy"] == "dp:sigma=0.5,clip=1.0" and got["dp_epsilon"] > 0
    assert (ck / "manifest.json").exists()


def test_launcher_refusals(capsys):
    with pytest.raises(SystemExit):
        train.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                    "--fl-engine", "sharded_fused"])
    assert "item 18" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        train.main(["--arch", "tinyllama-1.1b", "--device", "cpu",
                    "--fl-schedule", "pipelined", "--fl-staleness-depth", "2"])
    with pytest.raises(NotImplementedError, match="item 5"):
        train.main(["--arch", "tinyllama-1.1b", *SMALL, "--device", "cpu",
                    "--fl-engine", "fused", "--storage-dtype", "bfloat16"])


def test_quickstart_trains_and_serves(capsys):
    out = quickstart.main(["--device", "cpu", "--rounds", "3"])
    assert out["tokens"].shape == (2, 16)
    assert np.isfinite(out["losses"]).all() and len(out["losses"]) == 3
    assert "generated:" in capsys.readouterr().out


def test_serve_load_smoke_record_is_the_references(tmp_path):
    out = tmp_path / "serve.json"
    got = serve_load.main(["--smoke", "--device", "cpu", "--out", str(out)])
    want = json.loads((ROOT / "experiments" / "serve_ehr.json").read_text())
    assert json.loads(out.read_text()) == got
    assert set(got) == set(want) and got["smoke"] and got["backend"] == "cpu"
    assert len(got["rows"]) == 2
    for g, w in zip(got["rows"], want["rows"]):
        assert set(g) == set(w) and g["name"] == w["name"]
    assert got["rows"][0]["n_swaps"] >= 1 and got["rows"][0]["gen_tokens"] == 96
    for a, b in zip(serve_load.make_requests(5, 2, 9, 512, seed=3),
                    j_serve_load.make_requests(5, 2, 9, 512, seed=3)):
        np.testing.assert_array_equal(a, b)


def _reference_serve_consensus(tmp_path) -> dict:
    spec = importlib.util.spec_from_file_location(
        "j_serve_consensus", ROOT / "examples" / "serve_consensus.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    out = tmp_path / "ref.json"
    old = sys.argv
    sys.argv = ["serve_consensus.py", "--rounds", "2", "--nodes", "2", "--requests", "2",
                "--snap-dir", str(tmp_path / "ref_snaps"), "--out", str(out)]
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            mod.main()
    finally:
        sys.argv = old
    return json.loads(out.read_text())


def test_serve_consensus_serves_the_published_weights(tmp_path):
    args = serve_consensus._parser().parse_args([
        "--device", "cpu", "--rounds", "4", "--nodes", "2", "--requests", "4",
        "--snap-dir", str(tmp_path / "snaps"), "--out", str(tmp_path / "row.json")])
    result = serve_consensus.run(args, keep_published=True)
    assert sorted(result["published"]) == [2, 4]
    assert {rnd for _, rnd in result["outputs"]} <= {2, 4}
    held = serve_consensus.served_matches_in_memory(
        build_model(get_config(args.arch, smoke=True)), result, args)
    assert held == 4 and np.isfinite(result["losses"]).all()
    want = _reference_serve_consensus(tmp_path)
    staleness = {"staleness_mean", "staleness_max"}
    assert set(result["row"]) - staleness == set(want) - staleness


def test_serve_consensus_main_writes_its_row(tmp_path):
    out = tmp_path / "row.json"
    row = serve_consensus.main(["--device", "cpu", "--rounds", "2", "--nodes", "2",
                                "--requests", "2", "--snap-dir", str(tmp_path / "s"),
                                "--out", str(out)])
    assert json.loads(out.read_text()) == row
    assert row["final_round_served"] == 2 and row["gen_tokens"] == 2 * 2 * 8


def test_train_100m_smoke_and_refusal(tmp_path):
    metrics, ck = tmp_path / "m.csv", tmp_path / "ck"
    rows = train_100m.main(["--arch", "smollm-360m", "--smoke", "--rounds", "2", "--q", "2",
                            "--seq-len", "16", "--device", "cpu", "--metrics", str(metrics),
                            "--ckpt", str(ck)])
    with open(metrics) as f:
        header = next(csv.reader(f))
    assert header == sorted(rows[0]) and len(rows) == 2
    assert {"round", "iteration", "loss", "consensus_err", "comm_bytes"} <= set(header)
    assert (ck / "manifest.json").exists()
    with pytest.raises(NotImplementedError, match="item 15"):
        train_100m.main(["--fl-engine", "sharded_fused", "--device", "cpu",
                         "--model-shards", "2"])
    with pytest.raises(SystemExit):
        train_100m.main(["--smoke", "--device", "cpu"])


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device is usable")


def test_entry_points_refuse_the_cpu_by_default(no_card, tmp_path):
    for call in (
            lambda: train.main(["--arch", "tinyllama-1.1b", "--rounds", "1"]),
            lambda: quickstart.main([]),
            lambda: serve_load.main(["--smoke", "--out", os.devnull]),
            lambda: serve_consensus.main(["--snap-dir", str(tmp_path), "--out", os.devnull]),
            lambda: train_100m.main(["--rounds", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
