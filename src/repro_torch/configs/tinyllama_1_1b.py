"""TinyLlama-1.1B [dense] — 22L d_model=2048 32H (GQA kv=4) d_ff=5632
vocab=32000 — llama2-arch small [arXiv:2401.02385].

A copy of ``repro.configs.tinyllama_1_1b``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    n_layers=22,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    d_ff=5632,
    vocab_size=32000,
    head_dim=64,
    window=4096,
    source="arXiv:2401.02385",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="tinyllama-1.1b-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        window=64,
        source="arXiv:2401.02385",
    )
