"""Phi-3-medium-14B [dense] — 40L d_model=5120 40H (GQA kv=10) d_ff=17920
vocab=100352 — RoPE + SwiGLU + GQA [arXiv:2404.14219].

A copy of ``repro.configs.phi3_medium_14b``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=10,
    d_ff=17920,
    vocab_size=100352,
    head_dim=128,
    rope_theta=10000.0,
    window=4096,  # used only by the long_500k sliding-window decode policy
    source="arXiv:2404.14219",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-medium-14b-smoke",
        family="dense",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        window=64,
        source="arXiv:2404.14219",
    )
