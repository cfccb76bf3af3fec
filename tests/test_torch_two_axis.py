"""The two-axis (gossip_node, model_shard) layout of the sharded engine
(``ShardedFusedEngine(model_axis=...)`` on a group of ``node ranks x S``
ranks): rank ``a * S + s`` holds node block ``a``'s column tile ``s`` of
every buffer, the wire stage runs per tile and the wire moves on the
node group of the shard only.

* Packing: ``pack(..., shards=S)``'s padding, ``shard_width``,
  ``with_shards``, ``flat_wire_bytes_per_shard`` and ``scoped_layout``'s
  per-shard ranges (and its uniformity refusal) equal the reference's.
* One spawned gloo group per world -- (4 nodes, S = 2) and (2 nodes, S =
  4), one node a node rank (8 ranks each), beside the S = 1 run of each
  torus in a one-rank group: DSGD dense, DSGT compact pipelined, DSGT
  dense ``bounded_staleness:k=2``, DSGD under dp (a clip that never
  binds: the clip is per tile, as the reference's), bf16 storage (the
  reference's ``tests/test_two_axis.py`` two-axis bf16 case) and
  ``slow_uplink`` (S = 2), a tile-uniform sub-range scope (S = 2), 3
  rounds each: the gathered params within 1e-5 of S = 1 (bf16: within
  one bf16 ulp), the metrics within rtol 1e-5; each rank hands the wire
  exactly ``flat_wire_bytes_per_shard`` per edge, direction and wire,
  per-shard bytes x S == ``wire_bytes``, and the model-group gathers are
  counted apart (``shard_gathers``: Q a round) from the wire's messages.
* Checkpoints: the S = 2 run's checkpoint (row blocks and tiles
  gathered) restores on S = 2 bitwise and is refused at S = 1 with the
  migration hint; a ``model_axis`` checkpoint at one shard restores on
  the single-axis engine.
* The NCCL rule: a world larger than the visible cards is refused.
* ``benchmarks/two_axis.py --smoke --device cpu`` writes its byte columns.
"""

import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import packing  # noqa: E402
from repro_torch.core.engine import ShardedFusedEngine  # noqa: E402
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.launch import mesh  # noqa: E402
from repro_torch.training.checkpoint import load_fl_state, save_fl_state  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
Q, CHUNK, ROUNDS = 2, 16, 3
BF16_ULP = 2.0 ** -8


def _params_np(n):
    """64 used columns: the layout is 64 wide at S = 1, 2 and 4 alike."""
    rng = np.random.default_rng(3)
    return ({"w": rng.normal(size=(n, 4, 12)).astype(np.float32),
             "b": rng.normal(size=(n, 16)).astype(np.float32)},
            {"t": rng.normal(size=(Q, n, 4, 12)).astype(np.float32)})


def test_shard_packing_equals_reference():
    """``pack(..., shards=)``, ``with_shards``, the per-shard byte count and
    the scoped per-shard ranges against the reference's packing."""
    pytest.importorskip("jax")
    from repro.core import packing as j_packing

    tree = {"w": np.zeros((4, 5, 7), np.float32), "b": np.zeros((4, 3), np.float32)}
    for shards in (1, 2, 4):
        for chunk in (8, 16):
            flat, lay = packing.pack({k: torch.as_tensor(v) for k, v in tree.items()},
                                     pad_to=chunk, shards=shards)
            j_flat, j_lay = j_packing.pack(tree, pad_to=chunk, shards=shards)
            assert (lay.total, lay.shards, lay.shard_width) == (
                j_lay.total, j_lay.shards, j_lay.shard_width)
            assert tuple(flat.shape) == tuple(j_flat.shape)
            for k in (None, 2, 4):
                assert (packing.flat_wire_bytes_per_shard(lay, 3, chunk, k)
                        == j_packing.flat_wire_bytes_per_shard(j_lay, 3, chunk, k))
                assert (packing.flat_wire_bytes_per_shard(lay, 1, chunk, k) * shards
                        == packing.flat_wire_bytes(lay, 1, chunk, k))
    lay = packing.pack_layout({"w": torch.zeros(4, 64)}, pad_to=16, shards=2)
    j_lay = j_packing.pack_layout({"w": np.zeros((4, 64), np.float32)}, pad_to=16,
                                  shards=2)
    for ranges in (((0, 16), (32, 48)), ((4, 20), (36, 52))):
        wl, local = packing.scoped_layout(lay, ranges, 16)
        j_wl, j_local = j_packing.scoped_layout(j_lay, ranges, 16)
        assert local == j_local
        assert (wl.total, wl.used, wl.shards) == (j_wl.total, j_wl.used, j_wl.shards)
    with pytest.raises(ValueError, match="not uniform across the 2 model shards"):
        packing.scoped_layout(lay, ((0, 16),), 16)
    assert lay.with_shards(4).shard_width == 16
    with pytest.raises(ValueError, match="not divisible by shards=3"):
        lay.with_shards(3)


CASES = [  # (name, algorithm, topk, schedule, extra knobs, shard counts that run it)
    ("dsgd-dense", "dsgd", None, "sequential", {}, (2, 4)),
    ("dsgt-top4-pipe", "dsgt", 4, "pipelined", {}, (2, 4)),
    ("dsgt-dense-k2", "dsgt", None, "bounded_staleness:k=2", {}, (2, 4)),
    # a clip that never binds: each tile's wire stage clips its own tile
    # (the reference's, which sees only the tile), so a binding clip at
    # S > 1 is not S = 1's; here the run holds each rank's noise tile
    ("dsgd-dp", "dsgd", None, "sequential", {"privacy": "dp:sigma=0.0001,clip=1000.0"},
     (2, 4)),
    ("dsgt-bf16", "dsgt", 4, "sequential", {"storage_dtype": "bfloat16"}, (2,)),
    ("dsgt-slow-uplink", "dsgt", 4, "sequential",
     {"node_program": "slow_uplink:frac=0.5,k_scale=0.5"}, (2,)),
    ("dsgd-scope", "dsgd", None, "pipelined", {"scope": "ranges:0-16,32-48"}, (2,)),
]

_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np, torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    from repro_torch.core.engine import ShardedFusedEngine
    from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round
    from repro_torch.core.packing import flat_wire_bytes_per_shard
    from repro_torch.core.schedules import inv_sqrt
    from repro_torch.launch.mesh import start_group, stop_group
    from repro_torch.training.checkpoint import load_fl_state, save_fl_state

    rank, world, nodes, shards, store, out = sys.argv[1:7]
    rank, world, nodes, shards = int(rank), int(world), int(nodes), int(shards)
    g = start_group(rank, world, store, device="cpu", node_axes={"data": nodes},
                    model_shards=shards)
    q, chunk, rounds = Q_, CHUNK_, ROUNDS_
    rng = np.random.default_rng(3)
    params = {"w": torch.tensor(rng.normal(size=(nodes, 4, 12)), dtype=torch.float32),
              "b": torch.tensor(rng.normal(size=(nodes, 16)), dtype=torch.float32)}
    batches = {"t": torch.tensor(rng.normal(size=(q, nodes, 4, 12)), dtype=torch.float32)}

    def loss(p, b):
        return ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2)) + (p["b"] ** 2).sum(dim=1)

    res, info = {}, {}
    for name, alg, topk, sched, extra, runs in CASES:
        if shards > 1 and shards not in runs:
            continue
        kw = dict(scale_chunk=chunk, topk=topk, round_schedule=sched, **extra)
        if shards > 1:
            kw["model_axis"] = "model"
        cfg = FLConfig(algorithm=alg, q=q, n_nodes=nodes)
        eng, rows = ShardedFusedEngine.from_group(g, params, **kw)
        rf = make_fl_round(loss, inv_sqrt(0.05), cfg, eng)
        st = init_fl_state(cfg, rows, eng)
        for _ in range(rounds):
            st, m = rf(st, batches)
        res[name + "/params"] = eng.gather_rows(st.params).float().numpy()
        if st.tracker is not None:
            res[name + "/tracker"] = eng.gather_rows(st.tracker).float().numpy()
        for k in ("loss", "local_loss", "grad_norm_sq", "consensus_err", "ef_residual_rms"):
            res[f"{name}/{k}"] = np.float64(float(m[k]))
        counts = torch.tensor([eng.collectives, eng.collective_bytes, eng.shard_gathers],
                              dtype=torch.int64)
        every = torch.empty(3 * world, dtype=torch.int64)
        dist.all_gather_into_tensor(every, counts)
        res[name + "/counts"] = every.numpy()
        wires = 2 if alg == "dsgt" else 1
        info[name] = {
            "wire_bytes": eng.wire_bytes(cfg),
            "per_shard": eng.wire_bytes_per_shard(cfg),
            "edge_tile": flat_wire_bytes_per_shard(eng.wire_layout, 1, chunk,
                                                   topk if eng.compact_wire else None),
            "dirs": len(eng.dirs), "wires": wires, "total": eng.layout.total}
        if name == "dsgt-top4-pipe":
            ck = out + ".ck"
            save_fl_state(ck, st, engine=eng)
            fresh, rows2 = ShardedFusedEngine.from_group(g, params, **kw)
            back = load_fl_state(ck, init_fl_state(cfg, rows2, fresh), engine=fresh)
            res[name + "/restored_equal"] = np.float64(
                torch.equal(back.params, st.params) and torch.equal(back.tracker, st.tracker)
                and all(torch.equal(back.comm[k], st.comm[k]) for k in st.comm
                        if not k.startswith("mix_recon")))
            dist.barrier()
    if rank == 0:
        np.savez(out, **res)
        with open(out + ".json", "w") as f:
            json.dump(info, f)
    stop_group(g)
    sys.stdout.flush()
    # leave without interpreter teardown: gloo's threads have been seen
    # to abort a process at exit after the group was destroyed
    os._exit(0)
    """
).replace("CASES", repr(CASES)).replace("Q_", str(Q)).replace("CHUNK_", str(CHUNK)).replace(
    "ROUNDS_", str(ROUNDS))


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """(4 nodes, S = 2) and (2 nodes, S = 4) on 8 gloo ranks each, and the
    S = 1 run of each torus on one rank, all started together."""
    tmp = tmp_path_factory.mktemp("two_axis")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = []
    for nodes, shards, world in ((4, 2, 8), (2, 4, 8), (4, 1, 1), (2, 1, 1)):
        tag = f"n{nodes}_s{shards}"
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, str(rank), str(world), str(nodes),
                 str(shards), str(tmp / f"store_{tag}"), str(tmp / f"{tag}.npz")],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for p in procs:
        out, _ = p.communicate(timeout=240)
        assert p.returncode == 0, out[-4000:]
    return tmp


def _load(tmp, nodes, shards):
    tag = f"n{nodes}_s{shards}"
    return np.load(tmp / f"{tag}.npz"), json.loads((tmp / f"{tag}.npz.json").read_text())


@pytest.mark.parametrize("nodes, shards", [(4, 2), (2, 4)])
def test_two_axis_equals_one_shard(spawned, nodes, shards):
    """Every case at S > 1 against S = 1 on the same torus: params (and
    tracker) within 1e-5 (bf16 storage: one bf16 ulp of the value), the
    metrics within rtol 1e-5; per-shard bytes x S == wire bytes; each
    rank hands the wire exactly ``flat_wire_bytes_per_shard`` per edge,
    direction and wire a round (one node a node rank: every edge crosses
    ranks), one message per buffer and direction; ``shard_gathers`` is Q
    a round on every rank, apart from the wire's messages."""
    got, info = _load(spawned, nodes, shards)
    one, info1 = _load(spawned, nodes, 1)
    for name, alg, topk, _, extra, runs in CASES:
        if shards not in runs:
            assert name + "/params" not in got.files
            continue
        for buf in ("params", "tracker"):
            key = f"{name}/{buf}"
            if key in one.files:
                tol = (BF16_ULP * np.abs(one[key]) + 1e-6) if "bf16" in name else 1e-5
                assert (np.abs(got[key] - one[key]) <= tol).all(), key
        for k in ("loss", "local_loss", "grad_norm_sq", "consensus_err", "ef_residual_rms"):
            np.testing.assert_allclose(got[f"{name}/{k}"], one[f"{name}/{k}"], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{name}/{k}")
        i = info[name]
        assert i["per_shard"] * shards == i["wire_bytes"] == info1[name]["wire_bytes"]
        counts = got[name + "/counts"].reshape(-1, 3)
        bufs = 2 if topk is None else 3
        per_round = i["dirs"] * i["wires"]
        assert (counts[:, 0] == ROUNDS * per_round * bufs).all(), name
        assert (counts[:, 1] == ROUNDS * per_round * i["edge_tile"]).all(), name
        assert int(counts[::shards, 1].sum()) == ROUNDS * i["per_shard"]
        assert (counts[:, 2] == ROUNDS * Q).all(), name
        assert (one[name + "/counts"][2] == 0)
    assert float(got["dsgt-top4-pipe/restored_equal"]) == 1.0


def test_checkpoint_shard_refusal_and_one_shard_restore(spawned, tmp_path):
    """The S = 2 checkpoint (its row blocks and column tiles gathered into
    the whole buffers) is refused by an S = 1 engine with the reference's
    migration hint; a ``model_axis`` engine at one shard writes a
    checkpoint the single-axis engine restores bitwise."""
    params, batches = _params_np(4)
    params = {k: torch.as_tensor(v) for k, v in params.items()}
    g = mesh.start_group(0, 1, str(tmp_path / "store"), device="cpu",
                         node_axes={"data": 4})
    try:
        manifest = json.loads((spawned / "n4_s2.npz.ck" / "manifest.json").read_text())
        assert manifest["mesh"]["model_shards"] == 2 and manifest["mesh"]["world"] == 8
        assert manifest["mesh"]["axis_names"] == ["data", "model"]
        cfg = FLConfig(algorithm="dsgt", q=Q, n_nodes=4)
        kw = dict(scale_chunk=CHUNK, topk=4, round_schedule="pipelined")
        eng, rows = ShardedFusedEngine.from_group(g, params, **kw)
        with pytest.raises(ValueError, match=r"model_shards=2 .*pack\(\.\.\., shards=1\)"):
            load_fl_state(str(spawned / "n4_s2.npz.ck"), init_fl_state(cfg, rows, eng),
                          engine=eng)
        two, rows2 = ShardedFusedEngine.from_group(g, params, model_axis="model", **kw)
        assert two.model_shards == 1 and two.model_axis == "model"
        rf = make_fl_round(lambda p, b: ((p["w"] - b["t"]) ** 2).sum(dim=(1, 2))
                           + (p["b"] ** 2).sum(dim=1), inv_sqrt(0.05), cfg, two)
        st = init_fl_state(cfg, rows2, two)
        for _ in range(2):
            st, _ = rf(st, batches)
        save_fl_state(str(tmp_path / "ck"), st, engine=two)
        back = load_fl_state(str(tmp_path / "ck"), init_fl_state(cfg, rows, eng), engine=eng)
        assert torch.equal(back.params, st.params) and torch.equal(back.tracker, st.tracker)
    finally:
        mesh.stop_group(g)


def test_model_axis_refusals(tmp_path):
    """The reference's ``__init__`` checks: the model axis is not a node
    axis, every tile holds whole chunks; a group tiled over model shards
    needs ``model_axis``; a world larger than the visible cards is
    refused with NCCL's one-rank-a-device rule."""
    g = mesh.start_group(0, 1, str(tmp_path / "store"), device="cpu",
                         node_axes={"data": 4})
    try:
        params = {"p": torch.zeros(4, 48)}
        with pytest.raises(ValueError, match="also a gossip node"):
            ShardedFusedEngine.from_group(g, params, scale_chunk=16, model_axis="data")
        tiled = dataclasses.replace(g, model_shards=2, world=2)
        lay = packing.pack_layout(params, pad_to=16)  # 48 columns: tiles of 24
        with pytest.raises(ValueError, match="per-shard width 24 not a multiple of "
                                             "scale_chunk 16"):
            ShardedFusedEngine(tiled, lay, scale_chunk=16, model_axis="model")
        with pytest.raises(ValueError, match="with model_axis="):
            ShardedFusedEngine(tiled, lay.with_shards(2), scale_chunk=8)
    finally:
        mesh.stop_group(g)
    with pytest.raises(ValueError, match="model_shards=3 does not divide"):
        mesh.start_group(0, 4, str(tmp_path / "s2"), device="cpu", model_shards=3)


def test_more_ranks_than_cards_is_refused(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="NCCL runs one rank a device"):
        mesh._check_world(2, torch.device("cuda", 0))
    mesh._check_world(1, torch.device("cuda", 0))
    mesh._check_world(8, torch.device("cpu"))


def test_layouts_are_the_references():
    """The production and test layouts and their helpers, as the
    reference's mesh module defines them (as axis names and sizes)."""
    prod, multi = mesh.make_production_mesh(), mesh.make_production_mesh(multi_pod=True)
    assert prod.shape == {"data": 16, "model": 16} and prod.world == 256
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert mesh.node_axes(multi) == ("pod", "data") and mesh.model_axis(multi) == "model"
    assert mesh.n_fl_nodes(multi) == 32 and mesh.n_model_shards(multi) == 16
    assert mesh.make_test_mesh().shape == {"pod": 2, "data": 2, "model": 2}
    assert mesh.make_test_mesh((4, 2)).shape == {"data": 4, "model": 2}
    assert mesh.make_test_mesh((8,)).axis_names == ("model",)  # the reference's slice
    only = mesh.MeshLayout(("data",), (8,))
    assert mesh.model_axis(only) is None and mesh.n_model_shards(only) == 1


def test_two_axis_benchmark_writes_its_byte_columns(tmp_path, capsys):
    from repro_torch.benchmarks import two_axis

    out = tmp_path / "two_axis.json"
    row = two_axis.main(["--smoke", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == row
    for nodes, shards in two_axis.CELLS:
        tag = f"n{nodes}_s{shards}"
        assert row[f"wire_bytes_per_shard_{tag}"] * shards == row[f"wire_bytes_per_round_{tag}"]
    assert row["wire_bytes_per_round_n8_s1"] == 8 * 2 * 2 * 16 * (8 + 8 + 4)
    assert "N= 2 x S= 4" in capsys.readouterr().out
