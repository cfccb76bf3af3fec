"""Qwen2.5-32B [dense] — 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064 — GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B].

A copy of ``repro.configs.qwen2_5_32b``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    n_layers=64,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    head_dim=128,
    qkv_bias=True,
    rope_theta=1000000.0,
    window=4096,
    source="hf:Qwen/Qwen2.5-0.5B",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-32b-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        qkv_bias=True,
        window=64,
        source="hf:Qwen/Qwen2.5-0.5B",
    )
