"""RWKV-6 "Finch" 7B [ssm] — 32L d_model=4096 (attention-free)
d_ff=14336 vocab=65536 — data-dependent decay WKV [arXiv:2404.05892].

A copy of ``repro.configs.rwkv6_7b``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=0,  # attention-free; WKV heads = d_model/64 = 64
    n_kv_heads=0,
    d_ff=14336,
    vocab_size=65536,
    source="arXiv:2404.05892",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-7b-smoke",
        family="ssm",
        n_layers=2,
        d_model=256,
        n_heads=0,
        n_kv_heads=0,
        d_ff=512,
        vocab_size=512,
        source="arXiv:2404.05892",
    )
