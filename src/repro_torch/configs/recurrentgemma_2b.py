"""RecurrentGemma-2B [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern 1 attn : 2 recurrent
[arXiv:2402.19427].

A copy of ``repro.configs.recurrentgemma_2b``, field for field."""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    n_layers=26,
    d_model=2560,
    n_heads=10,
    n_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    head_dim=256,
    block_pattern=("recurrent", "recurrent", "local_attention"),
    rnn_width=2560,
    conv_width=4,
    window=2048,
    source="arXiv:2402.19427",
)


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b-smoke",
        family="hybrid",
        n_layers=2,  # one recurrent + ... pattern truncated to 2 layers
        d_model=256,
        n_heads=4,
        n_kv_heads=1,
        d_ff=512,
        vocab_size=512,
        head_dim=64,
        block_pattern=("recurrent", "local_attention"),
        rnn_width=256,
        conv_width=4,
        window=64,
        source="arXiv:2402.19427",
    )
