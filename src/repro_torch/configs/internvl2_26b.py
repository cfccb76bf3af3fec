"""InternVL2-26B [vlm] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92553 — InternViT (STUB frontend) + InternLM2-20B language backbone
[arXiv:2404.16821]. input_specs() supplies 1024 patch embeddings.

A copy of ``repro.configs.internvl2_26b``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    head_dim=128,
    window=4096,
    frontend="vision_stub",
    frontend_seq=1024,
    source="arXiv:2404.16821",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b-smoke",
        family="vlm",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=2,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        window=64,
        frontend="vision_stub",
        frontend_seq=16,
        source="arXiv:2404.16821",
    )
