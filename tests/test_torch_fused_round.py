"""The PyTorch port's ``FusedEngine`` round against the JAX package's
``FusedEngine(impl="jnp")`` on the paper's problem: the 20-hospital EHR
cohort, the 42 -> 32 -> 2 MLP packed into a (20, 1536) buffer, FD-DSGD and
FD-DSGT on the hospital graph at alpha = 0.02/sqrt(r). Both start from the
reference's init and draw the same batches from one numpy batcher.

Tolerances: one round agrees within 1e-5. Over several rounds the two
gradients differ by an ulp here and there (another summation order in
the MLP's matmuls), and a one-ulp change of a payload that sits on an
int8 rounding boundary moves that column by one quantization step;
error feedback carries the step into the next round's payload and so
absorbs it, but the trajectories are then equal only to that step's
size. So five rounds at Q = 10 agree on the loss within rtol 1e-3 and
on the consensus parameters within atol 1e-3.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.ehr_mlp import class_weights as j_class_weights  # noqa: E402
from repro.core import engine as j_engine  # noqa: E402
from repro.core import fl as j_fl  # noqa: E402
from repro.core.packing import pack as j_pack  # noqa: E402
from repro.core.schedules import inv_sqrt as j_inv_sqrt  # noqa: E402
from repro.models.mlp import make_mlp_loss as j_make_mlp_loss  # noqa: E402
from repro.models.mlp import mlp_init as j_mlp_init  # noqa: E402
from repro.training.trainer import stack_for_nodes as j_stack_for_nodes  # noqa: E402
from repro_torch.configs.ehr_mlp import class_weights  # noqa: E402
from repro_torch.convert import flat_from_numpy, params_from_numpy  # noqa: E402
from repro_torch.core.engine import (  # noqa: E402
    FusedEngine,
    ShardedFusedEngine,
    engine_names,
    get_engine,
)
from repro_torch.core.fl import FLConfig, init_fl_state, make_fl_round  # noqa: E402
from repro_torch.core.packing import pack_layout, unpack  # noqa: E402
from repro_torch.core.schedules import inv_sqrt  # noqa: E402
from repro_torch.core.topology import mixing_matrix  # noqa: E402
from repro_torch.data.ehr import generate_ehr_cohort, make_node_batcher  # noqa: E402
from repro_torch.models.mlp import make_mlp_loss  # noqa: E402
from repro_torch.training.trainer import stack_batches, stack_for_nodes  # noqa: E402

N, CHUNK = 20, 512
WIRE_BYTES = {"dsgt": 167_184, "dsgd": 83_592}


def _one_thread():
    """The suite runs several pytest workers; one intra-op thread each
    keeps them from oversubscribing the cores."""
    torch.set_num_threads(1)


_one_thread()


class _Pair:
    """The same run in both packages: engines, round functions, states."""

    def __init__(self, algorithm: str, q: int):
        self.cfg = FLConfig(algorithm=algorithm, q=q, n_nodes=N)
        j_cfg = j_fl.FLConfig(algorithm=algorithm, q=q, n_nodes=N)
        w = mixing_matrix("hospital20", N)
        init = j_mlp_init(jax.random.key(0))
        j_flat, j_layout = j_pack(j_stack_for_nodes(init, N), pad_to=CHUNK)
        self.j_engine = j_engine.FusedEngine(w, j_layout, scale_chunk=CHUNK, impl="jnp")
        self.j_round = jax.jit(j_fl.make_fl_round(
            j_make_mlp_loss(j_class_weights()), None, j_inv_sqrt(0.02), j_cfg,
            engine=self.j_engine))
        self.j_state = j_fl.init_fl_state(j_cfg, j_flat, engine=self.j_engine)

        single = params_from_numpy(jax.tree_util.tree_map(np.asarray, init), device="cpu")
        self.engine, flat = FusedEngine.simulated(w, stack_for_nodes(single, N),
                                                  scale_chunk=CHUNK)
        self.layout = self.engine.layout
        assert torch.equal(flat, flat_from_numpy(np.asarray(j_flat), self.layout,
                                                 device="cpu"))
        self.round = make_fl_round(make_mlp_loss(class_weights()), inv_sqrt(0.02),
                                   self.cfg, self.engine)
        self.state = init_fl_state(self.cfg, flat, self.engine)
        data = generate_ehr_cohort(seed=0)
        self.batcher = make_node_batcher(data, m=20, seed=1)

    def step(self):
        batches = stack_batches(self.batcher, self.cfg.q)
        self.state, m = self.round(self.state, batches)
        self.j_state, jm = self.j_round(self.j_state, batches)
        return m, jm


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_one_round_matches_reference(algorithm):
    pair = _Pair(algorithm, q=10)
    m, jm = pair.step()
    st, jst = pair.state, pair.j_state
    assert st.step == int(jst.step) == 10
    np.testing.assert_allclose(_np(st.params), _np(jst.params), rtol=0, atol=1e-5)
    assert set(st.comm) == set(jst.comm) == set(pair.engine.comm_keys(pair.cfg))
    for k in st.comm:
        np.testing.assert_allclose(_np(st.comm[k]), _np(jst.comm[k]), rtol=0,
                                   atol=1e-5, err_msg=k)
    if algorithm == "dsgt":
        np.testing.assert_allclose(_np(st.tracker), _np(jst.tracker), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(st.prev_grad), _np(jst.prev_grad), rtol=0,
                                   atol=1e-5)
    else:
        assert st.tracker is None and st.prev_grad is None
    for k in ("loss", "local_loss", "alpha", "grad_norm_sq", "consensus_err",
              "ef_residual_rms"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5, atol=1e-8,
                                   err_msg=k)
    assert float(m["comm_rounds"]) == float(jm["comm_rounds"]) == 1.0


@pytest.mark.parametrize("algorithm", ["dsgd", "dsgt"])
def test_five_rounds_track_reference(algorithm):
    pair = _Pair(algorithm, q=10)
    for _ in range(5):
        m, jm = pair.step()
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-3)
        assert m["wire_bytes"] == float(jm["wire_bytes"]) == pair.engine.wire_bytes(pair.cfg)
        assert m["wire_bytes"] == pair.j_engine.wire_bytes(pair.cfg) == WIRE_BYTES[algorithm]
    mine = unpack(pair.state.params, pair.layout)
    ref = pair.j_engine.params_view(pair.j_state.params)
    for k in ("fc1", "fc2"):
        for leaf in ("w", "b"):
            np.testing.assert_allclose(_np(mine[k][leaf].mean(dim=0)),
                                       _np(ref[k][leaf]).mean(axis=0), rtol=0,
                                       atol=1e-3, err_msg=f"{k}.{leaf}")
    np.testing.assert_allclose(float(m["consensus_err"]), float(jm["consensus_err"]),
                               rtol=0, atol=1e-3)


def test_dsgt_tracking_invariant():
    """mean_i tracker == mean_i prev_grad after every comm round, up to
    the error-feedback-corrected quantization drift (the bound of
    tests/test_megakernel.py)."""
    pair = _Pair("dsgt", q=2)
    for _ in range(8):
        pair.step()
        tracker, grads = _np(pair.state.tracker), _np(pair.state.prev_grad)
        drift = np.abs(tracker.mean(axis=0) - grads.mean(axis=0)).max()
        q_step = max(np.abs(tracker).max(), 1e-6) / 127.0
        assert drift < 10 * q_step + 1e-5, drift


def test_padding_columns_stay_zero():
    pair = _Pair("dsgt", q=3)
    for _ in range(2):
        pair.step()
    used = pair.layout.used
    for buf in (pair.state.params, pair.state.tracker, *pair.state.comm.values()):
        assert torch.count_nonzero(buf[:, used:]) == 0


def test_registry_and_refusals():
    """The registry; the validation of the wire and schedule knobs the
    port now has (``topk < 1``, ``bounded_staleness:k < 1``); topology and
    node programs now build (``tests/test_torch_dynamic_round.py``), and
    so does privacy (``tests/test_torch_privacy.py``) and a federation
    scope (``tests/test_torch_scope.py``; a pattern matching no leaf is
    the reference's ``ValueError``); the refusal that remains (bf16
    storage)."""
    assert "fused" in engine_names() and get_engine("fused") is FusedEngine
    assert get_engine("sharded_fused") is ShardedFusedEngine
    with pytest.raises(ValueError, match="unknown engine"):
        get_engine("mesh_fused")
    with pytest.raises(ValueError, match="wire_dtype"):
        FusedEngine(mixing_matrix("hospital20", N),
                    pack_layout({"p": torch.zeros(N, 1442)}, pad_to=CHUNK),
                    device="cpu", wire_dtype="bfloat16")
    w = mixing_matrix("hospital20", N)
    layout = pack_layout({"p": torch.zeros(N, 1442)}, pad_to=CHUNK)
    with pytest.raises(ValueError, match="topk must be >= 1"):
        FusedEngine(w, layout, device="cpu", topk=0)
    with pytest.raises(ValueError, match="k=0 must be >= 1"):
        FusedEngine(w, layout, device="cpu", round_schedule="bounded_staleness:k=0")
    with pytest.raises(ValueError, match="unknown round schedule"):
        FusedEngine(w, layout, device="cpu", round_schedule="overlapped")
    eng = FusedEngine(w, layout, device="cpu", topology_program="node_churn:p_down=0.1",
                      node_program="stragglers:frac=0.25")
    assert eng.dynamic_topology and eng.dynamic_nodes
    assert FusedEngine(w, layout, device="cpu", privacy="secure_agg").privacy.secure_agg
    assert FusedEngine(w, layout, device="cpu", scope="ranges:0-512").wire_layout.total == 512
    with pytest.raises(ValueError, match="matches no leaf"):
        FusedEngine(w, layout, device="cpu", scope="backbone")
    bf16 = FusedEngine(w, layout, device="cpu", storage_dtype=torch.bfloat16)
    assert bf16.storage_dtype == torch.bfloat16 and bf16.layout.storage_dtype == "bfloat16"
    with pytest.raises(ValueError, match=r"in \('float32', 'bfloat16'\) only"):
        FusedEngine(w, layout, device="cpu", storage_dtype=torch.float16)
    with pytest.raises(ValueError, match="scale_chunk"):
        FusedEngine(w, layout, scale_chunk=7, device="cpu")
    engine = FusedEngine(w, layout, device="cpu")
    cfg = FLConfig(algorithm="dsgd", q=1, n_nodes=N)
    with pytest.raises(ValueError, match="flat buffer"):
        init_fl_state(cfg, {"p": torch.zeros(N, 1442)}, engine)
    with pytest.raises(ValueError, match="flat buffer"):
        init_fl_state(cfg, torch.zeros(N, 1536, dtype=torch.float64), engine)
    with pytest.raises(ValueError, match="sequential"):
        engine.make_pipelined_round(None, None, cfg)
