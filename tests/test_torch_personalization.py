"""The PyTorch port's personalization driver
(``repro_torch.benchmarks.personalization_ehr``) against the reference's
(``benchmarks/personalization_ehr.py``) and its committed
``experiments/personalization_ehr.json``.

* The smoke run's three cells (``full``, ``backbone``,
  ``layerwise_freq4``) against the reference driver's ``run_cell`` from
  the reference's init under the installed jax (its ``get_engine``
  monkeypatched to ``impl="jnp"``): wire bytes and widths equal, the mean
  per-hospital balanced accuracy within 0.02.
* The full run (150 rounds at Q = 10) from the JSON's init (jax 0.4's
  threefry, ``jax_threefry_partitionable=False``): the bytes exactly
  171,072 / 156,816 / 171,072 a round, each cell's mean per-hospital
  balanced accuracy within 0.02 of the JSON's 0.5942 / 0.6213 / 0.5973,
  backbone >= full, the cohort stats equal.
* The CLI's ``--smoke`` JSON has the committed JSON's keys.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import benchmarks.personalization_ehr as j_personalization  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro_torch.benchmarks import personalization_ehr  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WIRE = {"full": 171_072, "backbone": 156_816, "layerwise_freq4": 171_072}


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


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
    for k in ("name", "scope", "iterations", "rounds", "q", "scale_chunk", "topk",
              "wire_bytes_per_round", "wire_total_cols", "layout_total_cols",
              "shared_fraction", "n_nodes"):
        assert mine[k] == want[k], (what, k, mine[k], want[k])
    assert abs(mine["bal_acc_per_hospital_mean"] - want["bal_acc_per_hospital_mean"]) <= 0.02, (
        what, mine["bal_acc_per_hospital_mean"], want["bal_acc_per_hospital_mean"])
    assert mine["wire_bytes_per_round"] == WIRE[mine["name"]]


def test_smoke_cells_match_the_reference_driver(monkeypatch):
    monkeypatch.setattr(j_personalization, "get_engine", lambda name: _JnpFused)
    init = _init(jax.config.jax_threefry_partitionable)
    rec = personalization_ehr.run(personalization_ehr.SMOKE_ROUNDS, 10, device="cpu",
                                  init_params=init, smoke=True, log=False)
    assert [r["name"] for r in rec["rows"]] == list(WIRE)
    for row, (name, scope) in zip(rec["rows"], personalization_ehr.CELLS):
        want = j_personalization.run_cell(name, scope, personalization_ehr.SMOKE_ROUNDS, 10)
        _same_row(row, want, name)


def test_full_run_against_the_committed_json():
    rec = personalization_ehr.run(150, 10, device="cpu", init_params=_init(False), log=False)
    want = json.loads((ROOT / "experiments" / "personalization_ehr.json").read_text())
    assert not want["smoke"] and rec["cohort_stats"] == want["cohort_stats"]
    rows = {r["name"]: r for r in rec["rows"]}
    for w in want["rows"]:
        _same_row(rows[w["name"]], w, w["name"])
    assert (rows["backbone"]["bal_acc_per_hospital_mean"]
            >= rows["full"]["bal_acc_per_hospital_mean"])
    full, backbone = rows["full"], rows["backbone"]
    assert (backbone["wire_bytes_per_round"] * full["layout_total_cols"]
            == full["wire_bytes_per_round"] * backbone["wire_total_cols"])


def test_cli_writes_the_json(tmp_path):
    out = tmp_path / "personalization.json"
    rec = personalization_ehr.main(["--smoke", "--device", "cpu", "--q", "2",
                                    "--out", str(out)])
    saved = json.loads(out.read_text())
    assert saved["smoke"] is True and saved["device"] == "cpu"
    assert [r["name"] for r in saved["rows"]] == [r["name"] for r in rec["rows"]]
    want = json.loads((ROOT / "experiments" / "personalization_ehr.json").read_text())
    assert set(saved) - {"device"} == set(want)
    for mine, theirs in zip(saved["rows"], want["rows"]):
        assert set(mine) == set(theirs), mine["name"]
