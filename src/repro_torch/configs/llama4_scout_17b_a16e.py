"""Llama-4-Scout-17B-16E [moe] — 48L d_model=5120 40H (GQA kv=8) d_ff=8192,
MoE 16 experts top-1 + shared expert, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E].

A copy of ``repro.configs.llama4_scout_17b_a16e``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202048,
    head_dim=128,
    n_experts=16,
    experts_per_token=1,
    shared_expert=True,
    rope_theta=500000.0,
    window=4096,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-smoke",
        family="moe",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        n_experts=4,
        experts_per_token=1,
        shared_expert=True,
        window=64,
        source="hf:meta-llama/Llama-4-Scout-17B-16E",
    )
