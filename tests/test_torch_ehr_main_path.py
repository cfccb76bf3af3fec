"""The port's main path end to end on the CPU: the paper's FD-DSGT on the
fused engine (``repro_torch.examples.ehr_federated.run_fused_engine``)
against the JAX package's trainer on the same cohort, init and batches.
The wire accounting is exact; the final balanced accuracy agrees within
0.02 (the trajectories differ by error-feedback-absorbed int8 steps, see
tests/test_torch_fused_round.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.base import FLRunConfig  # noqa: E402
from repro.configs.ehr_mlp import class_weights  # noqa: E402
from repro.core.topology import mixing_matrix  # noqa: E402
from repro.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro.models.mlp import make_mlp_loss, mlp_balanced_accuracy, mlp_init  # noqa: E402
from repro.training.trainer import train_decentralized  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.examples.ehr_federated import run_fused_engine  # noqa: E402

ROUNDS, Q = 10, 10


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


def test_fused_engine_example_matches_reference_trainer(capsys):
    init = mlp_init(jax.random.key(0))
    out = run_fused_engine(
        rounds=ROUNDS, q=Q, device="cpu",
        init_params=params_from_numpy(jax.tree_util.tree_map(np.asarray, init),
                                      device="cpu"))
    printed = capsys.readouterr().out
    assert "comm_bytes/round=167,184 (int8 wire) vs 622,944 (fp32 wire)" in printed
    assert "wire saving: 3.73x" in printed

    data = generate_ehr_cohort(seed=0)
    run = FLRunConfig(algorithm="dsgt", q=Q, topology="hospital20", n_nodes=20,
                      batch_per_node=20, alpha0=0.02)
    ref = train_decentralized(make_mlp_loss(class_weights()), init, run,
                              make_node_batcher(data, m=20, seed=1), rounds=ROUNDS,
                              engine="fused", scale_chunk=512)
    xall = jnp.asarray(np.concatenate(data.features))
    yall = jnp.asarray(np.concatenate(data.labels))
    ref_bal = float(mlp_balanced_accuracy(ref.consensus, xall, yall))

    w = mixing_matrix("hospital20", 20)
    degrees = (w - np.diag(np.diag(w)) > 0).sum(axis=1)
    fp32_bytes = float(2 * degrees.sum() * 1442 * 4)
    ref_wire = ref.history.column("comm_bytes")[-1] / ROUNDS
    assert out["wire_bytes"] == ref_wire == 167_184
    assert out["wire_saving"] == fp32_bytes / ref_wire
    assert abs(out["bal_acc"] - ref_bal) <= 0.02, (out["bal_acc"], ref_bal)
    np.testing.assert_allclose(out["losses"], ref.history.column("loss"), rtol=1e-3)
    assert len(out["losses"]) == ROUNDS and np.isfinite(out["losses"]).all()
