"""Whisper-medium [audio] — enc-dec, 24L decoder d_model=1024 16H d_ff=4096
vocab=51865; 24L encoder over 1500 stubbed conv-frontend frames
[arXiv:2212.04356].

A copy of ``repro.configs.whisper_medium``, field for field."""

from repro_torch.configs.base import EncoderConfig, ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    frontend="audio_stub",
    encoder=EncoderConfig(n_layers=24, d_model=1024, n_heads=16, d_ff=4096, seq_len=1500),
    source="arXiv:2212.04356",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-medium-smoke",
        family="audio",
        n_layers=2,
        d_model=256,
        n_heads=4,
        n_kv_heads=4,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        frontend="audio_stub",
        encoder=EncoderConfig(n_layers=2, d_model=256, n_heads=4, d_ff=512, seq_len=32),
        source="arXiv:2212.04356",
    )
