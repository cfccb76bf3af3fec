"""The PyTorch port's EHR round-axis drivers
(``repro_torch.benchmarks.{staleness,churn,straggler}_ehr``) against the
reference's (``benchmarks/*_ehr.py``): every cell of each driver's smoke
run in both packages from the reference's init, then one full cell per
driver against the committed ``experiments/*_ehr.json``.

The reference's drivers build ``FusedEngine.simulated(..., impl=
"pallas")``; here they build it with ``impl="jnp"`` (the bit-identical
chunked oracle), which stays fast on the CPU.

The committed JSONs were written under jax 0.4, whose threefry keys
were not partitionable: ``mlp_init(jax.random.key(0))`` drew another
init there than it does under the installed jax. The full cells start
from that init (``jax_threefry_partitionable=False``), with which the
reference here reproduces the JSONs' ``bal_acc`` exactly.

Tolerances: ``bal_acc`` within 0.02 (the port's multi-round policy: an
ulp of gradient can move an int8 step that error feedback absorbs); the
realized fractions, a function of the programs alone, exactly equal (to
the JSON within 1e-6). The iteration counts equal.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.core import engine as j_engine  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
import benchmarks.churn_ehr as j_churn  # noqa: E402
import benchmarks.staleness_ehr as j_staleness  # noqa: E402
import benchmarks.straggler_ehr as j_straggler  # noqa: E402
from repro_torch.benchmarks import churn_ehr, staleness_ehr, straggler_ehr  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FRACTIONS = ("mean_edge_fraction", "mean_payload_fraction", "mean_compute_fraction")


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


class _JnpFused:
    """``get_engine("fused")`` for the reference's drivers, on the jnp
    oracle."""

    @staticmethod
    def simulated(*args, **kw):
        kw["impl"] = "jnp"
        return j_engine.FusedEngine.simulated(*args, **kw)


@pytest.fixture
def reference(monkeypatch):
    for mod in (j_churn, j_staleness, j_straggler):
        monkeypatch.setattr(mod, "get_engine", lambda name: _JnpFused)


def _init(partitionable: bool):
    """The reference drivers' init, ``mlp_init(jax.random.key(0))``, as
    the port's drivers take it, drawn with the given threefry layout."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        return params_from_numpy(jax.tree_util.tree_map(
            np.asarray, j_mlp_init(jax.random.key(0))), device="cpu")
    finally:
        jax.config.update("jax_threefry_partitionable", before)


@pytest.fixture(scope="module")
def init():
    """The init the reference's drivers draw under the installed jax."""
    return _init(jax.config.jax_threefry_partitionable)


@pytest.fixture(scope="module")
def json_init():
    """The init the committed JSONs were trained from (jax 0.4's
    threefry)."""
    return _init(False)


def _same_cell(mine: dict, ref: dict, what: str) -> None:
    assert mine["iterations"] == ref["iterations"], what
    assert abs(mine["bal_acc"] - ref["bal_acc"]) <= 0.02, (what, mine["bal_acc"],
                                                           ref["bal_acc"])
    for k in FRACTIONS:
        if k in ref:
            assert mine[k] == ref[k], (what, k, mine[k], ref[k])
    for k in ("program", "schedule", "node_program", "q", "rounds"):
        if k in ref:
            assert mine[k] == ref[k], (what, k)


def test_staleness_smoke_matches_reference(reference, init):
    rec = staleness_ehr.run(staleness_ehr.SMOKE_ROUNDS_AT_Q1, device="cpu",
                            init_params=init, log=False)
    assert len(rec["cells"]) == 6
    for cell in rec["cells"]:
        ref = j_staleness.run_cell(cell["q"], cell["schedule"], cell["rounds"])
        _same_cell(cell, ref, f"Q={cell['q']} {cell['schedule']}")


def test_churn_smoke_matches_reference(reference, init):
    rec = churn_ehr.run(churn_ehr.SMOKE_ROUNDS, 10, device="cpu", init_params=init,
                        log=False)
    assert len(rec["cells"]) == 5
    for cell, p_down in zip(rec["cells"], j_churn.DOWNTIME_FRACTIONS + (None,)):
        program = (j_churn_edge() if p_down is None else None if p_down == 0.0 else
                   f"node_churn:p_down={p_down},mean_downtime={j_churn.MEAN_DOWNTIME},"
                   "seed=0")
        ref = j_churn.run_cell(program, churn_ehr.SMOKE_ROUNDS, 10)
        _same_cell(cell, ref, cell["program"])


def j_churn_edge() -> str:
    """The reference driver's matched link-flap program (built inline in
    its ``main``)."""
    p_mid = j_churn.DOWNTIME_FRACTIONS[2]
    return f"edge_failure:p={round(1.0 - (1.0 - p_mid) ** 2, 4)},seed=0"


def test_straggler_smoke_matches_reference(reference, init):
    rec = straggler_ehr.run(straggler_ehr.SMOKE_ROUNDS, 10, device="cpu",
                            init_params=init, log=False)
    assert len(rec["cells"]) == 13
    for cell in rec["cells"]:
        ref = j_straggler.run_cell(cell["staleness_depth"], cell["straggler_fraction"],
                                   straggler_ehr.SMOKE_ROUNDS, 10,
                                   robust_alpha=cell["robust_alpha"])
        _same_cell(cell, ref, f"k={cell['staleness_depth']} "
                              f"frac={cell['straggler_fraction']}")


def _committed(name: str, **match) -> dict:
    cells = json.loads((ROOT / "experiments" / f"{name}.json").read_text())["cells"]
    return next(c for c in cells if all(c.get(k) == v for k, v in match.items()))


def test_full_straggler_cell_against_the_committed_json(json_init):
    mine = straggler_ehr.run_cell(2, 0.5, 80, 10, device="cpu", init_params=json_init)
    want = _committed("straggler_ehr", staleness_depth=2, straggler_fraction=0.5,
                      robust_alpha=False)
    assert mine["iterations"] == want["iterations"] == 800
    for k in ("mean_payload_fraction", "mean_compute_fraction"):
        assert abs(mine[k] - want[k]) <= 1e-6, k
    assert abs(mine["bal_acc"] - want["bal_acc"]) <= 0.02


def test_full_staleness_cell_against_the_committed_json(json_init):
    mine = staleness_ehr.run_cell(16, "pipelined", 20, device="cpu", init_params=json_init)
    want = _committed("staleness_ehr", q=16, schedule="pipelined")
    assert mine["iterations"] == want["iterations"] == 320
    assert abs(mine["bal_acc"] - want["bal_acc"]) <= 0.02


def test_full_churn_cells_against_the_reference_and_the_committed_json(
        reference, init, json_init):
    """The p_down = 0.25 cell equals the reference's own run. The JSON's
    node_churn cells predate the reference's Markov chain (the JSON was
    written with the earlier block churn), so there the JSON is not the
    reference's output: its fraction is pinned as it stands. The matched
    ``edge_failure`` cell, which both versions share, is held to the
    JSON."""
    program = "node_churn:p_down=0.25,mean_downtime=5,seed=0"
    mine = churn_ehr.run_cell(program, 120, 10, device="cpu", init_params=init)
    ref = j_churn.run_cell(program, 120, 10)
    _same_cell(mine, ref, program)
    stale = _committed("churn_ehr", p_down=0.25)
    assert stale["mean_edge_fraction"] == pytest.approx(0.5632716119289398, abs=0)
    assert abs(mine["mean_edge_fraction"] - stale["mean_edge_fraction"]) > 0.04

    flap = churn_ehr.run_cell(churn_ehr.matched_edge_failure(), 120, 10, device="cpu",
                              init_params=json_init)
    want = _committed("churn_ehr", program=flap["program"])
    assert abs(flap["mean_edge_fraction"] - want["mean_edge_fraction"]) <= 1e-6
    assert abs(flap["bal_acc"] - want["bal_acc"]) <= 0.02


def test_cli_writes_the_json(tmp_path, init):
    out = tmp_path / "straggler.json"
    rec = straggler_ehr.main(["--smoke", "--device", "cpu", "--q", "2", "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["smoke"] is True and saved["device"] == "cpu"
    assert [c["schedule"] for c in saved["cells"]] == [c["schedule"] for c in rec["cells"]]
    ref_keys = set(_committed("straggler_ehr", staleness_depth=0))
    assert set(saved["cells"][0]) == ref_keys
    assert set(saved["summary"]) == {"frac=0.0", "frac=0.25", "frac=0.5"}
