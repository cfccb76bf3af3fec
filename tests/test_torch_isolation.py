"""The PyTorch port stands alone: nothing under ``src/repro_torch/`` nor
``chip_smoke.py`` imports JAX or the JAX package, importing the port
loads no JAX, and its entry points refuse to run on the CPU unless asked
to (they default to ``cuda``)."""

import ast
import inspect
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _port_sources():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    names = {str(f.relative_to(PORT)) for f in files[:-1]}
    assert {"core/mixing.py", "core/compression.py",
            "benchmarks/fig2_comm_rounds.py", "serving/engine.py", "launch/serve.py",
            "models/transformer.py", "kernels/decode_attention/ops.py",
            "kernels/flash_attention/ops.py", "examples/serve_decode.py",
            "core/dynamics.py", "core/heterogeneity.py", "benchmarks/churn_ehr.py",
            "benchmarks/staleness_ehr.py", "benchmarks/straggler_ehr.py",
            "models/moe.py", "models/encdec.py", "configs/shapes.py",
            "configs/whisper_medium.py", "configs/dbrx_132b.py",
            "benchmarks/thm1_speedup.py", "benchmarks/ablations.py",
            "benchmarks/comm_bytes.py", "benchmarks/kernel_bench.py",
            "benchmarks/run.py", "models/sharding.py", "launch/op_analysis.py",
            "launch/dryrun.py", "benchmarks/run_dryruns.py", "benchmarks/roofline.py",
            "kernels/launches.py"} <= names
    assert len(files) > 20
    return files


@pytest.mark.parametrize("path", _port_sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "flax", "optax", "ml_dtypes"), (path, name)


def test_importing_the_port_loads_no_jax():
    code = ("import sys, repro_torch, repro_torch.examples.ehr_federated, "
            "repro_torch.training.trainer, repro_torch.kernels.gossip.ops, "
            "repro_torch.core.mixing, repro_torch.core.compression, "
            "repro_torch.training.metrics, repro_torch.benchmarks.fig2_comm_rounds, "
            "repro_torch.serving, repro_torch.launch.serve, "
            "repro_torch.examples.serve_decode, repro_torch.convert, "
            "repro_torch.launch.mesh, repro_torch.core, "
            "repro_torch.benchmarks.churn_ehr, repro_torch.benchmarks.staleness_ehr, "
            "repro_torch.benchmarks.straggler_ehr, repro_torch.launch.train, "
            "repro_torch.examples.quickstart, repro_torch.examples.serve_consensus, "
            "repro_torch.examples.train_100m, repro_torch.benchmarks.serve_load, "
            "repro_torch.data.tokens, repro_torch.models.moe, repro_torch.models.encdec, "
            "repro_torch.configs.shapes, repro_torch.configs.whisper_medium, "
            "repro_torch.configs.dbrx_132b, repro_torch.configs.internvl2_26b, "
            "repro_torch.benchmarks.thm1_speedup, repro_torch.benchmarks.ablations, "
            "repro_torch.benchmarks.comm_bytes, repro_torch.benchmarks.kernel_bench, "
            "repro_torch.benchmarks.run, repro_torch.training.snapshot, "
            "repro_torch.models.sharding, repro_torch.launch.op_analysis, "
            "repro_torch.launch.dryrun, repro_torch.benchmarks.run_dryruns, "
            "repro_torch.benchmarks.roofline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'ml_dtypes')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_the_fake_backend_is_torchs_own_in_the_dry_run_alone():
    """The dry run's fake process group is torch's own module
    (``torch.testing._internal.distributed.fake_pg``), imported by
    ``launch/dryrun.py`` only, inside the function that starts it."""
    users = {path.relative_to(ROOT).as_posix(): [n for n in _imports(path)
                                                if n and n.startswith("torch.testing")]
             for path in _port_sources()}
    assert {k: v for k, v in users.items() if v} == {
        "src/repro_torch/launch/dryrun.py": ["torch.testing._internal.distributed.fake_pg"]}
    tree = ast.parse((PORT / "launch" / "dryrun.py").read_text())
    top = [n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))]
    assert not any(getattr(n, "module", "") and n.module.startswith("torch.testing")
                   for n in top)


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card: the default device is usable")


def test_entry_points_refuse_the_cpu_by_default(no_card):
    from repro_torch.configs.base import FLRunConfig
    from repro_torch.configs.ehr_mlp import class_weights
    from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher
    from repro_torch.benchmarks.fig2_comm_rounds import run as fig2_run
    from repro_torch.device import resolve_device
    from repro_torch.examples.ehr_federated import run_fused_engine
    from repro_torch.models.mlp import make_mlp_loss, mlp_init
    from repro_torch.training.trainer import train_decentralized

    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    run = FLRunConfig(algorithm="dsgd", q=2, topology="hospital20", n_nodes=20)
    batcher = make_node_batcher(generate_ehr_cohort(seed=0), m=4, seed=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_decentralized(make_mlp_loss(class_weights()), mlp_init(0, device="cpu"),
                            run, batcher, rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_fused_engine(rounds=1, q=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fig2_run(iterations=1)
    # the EHR round-axis drivers, by their cells and their CLIs
    from repro_torch.benchmarks import churn_ehr, staleness_ehr, straggler_ehr
    with pytest.raises(RuntimeError, match="device='cpu'"):
        staleness_ehr.run_cell(1, "pipelined", 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        churn_ehr.run_cell("node_churn:p_down=0.25", 1, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        straggler_ehr.run_cell(2, 0.5, 1, 2)
    for driver in (staleness_ehr, churn_ehr, straggler_ehr):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            driver.main(["--smoke", "--out", os.devnull])
    # the standalone drivers and their harness
    from repro_torch.benchmarks import ablations, kernel_bench, thm1_speedup
    from repro_torch.benchmarks import run as run_all
    with pytest.raises(RuntimeError, match="device='cpu'"):
        thm1_speedup.run_one(4, 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ablations._run("ring", 1, 2.0, 1, 0.05)
    for driver in (thm1_speedup, kernel_bench, run_all):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            driver.main(["--out" if driver is not run_all else "--out-dir", os.devnull])
    assert inspect.signature(train_decentralized).parameters["engine"].default == "tree"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mlp_init(0)

    # the serving path: the launcher, the example, the bundle's inits
    from repro_torch.configs import get_config
    from repro_torch.examples import serve_decode
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.models.attention import init_kv_cache

    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "tinyllama-1.1b", "--max-new", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_decode.main([])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve_decode.demo("smollm-360m")
    bundle = build_model(get_config("smollm-360m", smoke=True))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bundle.init_fn(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bundle.init_decode_state_fn(1, 8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_kv_cache(1, 8, 1, 64)


def test_trainer_runs_on_the_cpu_when_asked():
    from repro_torch.configs.base import FLRunConfig
    from repro_torch.configs.ehr_mlp import class_weights
    from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher
    from repro_torch.models.mlp import make_mlp_loss, mlp_init
    from repro_torch.training.trainer import train_decentralized

    run = FLRunConfig(algorithm="dsgd", q=3, topology="hospital20", n_nodes=20,
                      batch_per_node=8)
    res = train_decentralized(make_mlp_loss(class_weights()), mlp_init(0, device="cpu"),
                              run, make_node_batcher(generate_ehr_cohort(seed=0), m=8,
                                                     seed=1),
                              rounds=2, engine="fused", device="cpu")
    assert len(res.history) == 2
    assert res.history.column("comm_bytes")[-1] == 2 * 83_592
    assert res.history.column("iteration")[-1] == 6
    assert np.isfinite(res.history.column("loss")).all()
    assert res.consensus["fc1"]["w"].shape == (42, 32)
    assert res.state.params.device.type == "cpu"
