"""SmolLM-360M [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM-135M].

A copy of ``repro.configs.smollm_360m``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    family="dense",
    n_layers=32,
    d_model=960,
    n_heads=15,
    n_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    head_dim=64,
    window=4096,
    tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke",
        family="dense",
        n_layers=2,
        d_model=192,
        n_heads=3,
        n_kv_heads=1,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        window=64,
        tie_embeddings=True,
        source="hf:HuggingFaceTB/SmolLM-135M",
    )
