"""DBRX-132B [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, 16 experts top-4 (fine-grained) [hf:databricks/dbrx-base].

A copy of ``repro.configs.dbrx_132b``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab_size=100352,
    head_dim=128,
    n_experts=16,
    experts_per_token=4,
    window=4096,
    source="hf:databricks/dbrx-base",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b-smoke",
        family="moe",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        n_experts=4,
        experts_per_token=2,
        window=64,
        source="hf:databricks/dbrx-base",
    )
