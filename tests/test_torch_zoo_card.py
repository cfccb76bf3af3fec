"""The model zoo's smoke configs on the card against the same weights
on the CPU (``cuda`` marker: ``python -m pytest -q -m cuda
tests/test_torch_zoo_card.py`` on a machine with a card; the CPU parity
against the JAX package is in ``tests/test_torch_{moe,encdec,model_zoo}.py``).
This file imports no JAX, so it runs where the card is.

At fp32 compute (TF32 off): prefill logits within 1e-4 of their scale
(one fp32 function summed in another order), and the greedy tokens of
``generate`` (4 prompt + 4 new) equal. The card runs the flash and
decode kernels (non-causal and cross shapes for whisper) and the MoE
dispatch on CUDA.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.fl import tree_map  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

B, P = 2, 10


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["dbrx-132b", "llama4-scout-17b-a16e", "whisper-medium",
                                  "internvl2-26b", "qwen2.5-32b"])
def test_smoke_prefill_and_generate_on_card(arch, cuda):
    cfg = dataclasses.replace(get_config(arch, smoke=True), compute_dtype="float32")
    bundle = build_model(cfg)
    host = bundle.init_fn(torch.Generator().manual_seed(0), device="cpu")
    card = tree_map(lambda a: a.to(cuda), host)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, P)).astype(np.int64)}
    if cfg.family == "audio":
        batch["frames"] = rng.normal(size=(B, cfg.encoder.seq_len,
                                           cfg.encoder.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = rng.normal(size=(B, cfg.frontend_seq,
                                                  cfg.d_model)).astype(np.float32)
    got, _ = bundle.prefill_fn(card, {k: torch.as_tensor(v, device=cuda)
                                      for k, v in batch.items()})
    want, _ = bundle.prefill_fn(host, {k: torch.as_tensor(v) for k, v in batch.items()})
    scale = max(1.0, float(want.abs().max()))
    assert float((got.cpu() - want).abs().max()) <= 1e-4 * scale
    tokens = [ServeEngine(bundle, p, max_seq=16, batch=B).generate(
        batch["tokens"][:, :4], max_new_tokens=4, frames=batch.get("frames")).tokens
        for p in (card, host)]
    np.testing.assert_array_equal(tokens[0], tokens[1])
