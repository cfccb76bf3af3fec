"""Models of the port: the paper's EHR MLP (``mlp``) and the model zoo
that the trainer trains and the serving engine serves: the decoder-only
stack (``transformer``, with ``attention``, ``moe``, ``rwkv6`` and
``rglru`` blocks), the whisper encoder-decoder (``encdec``), their
``layers`` and the registry (``model``)."""

from repro_torch.models.model import ModelBundle, build_model

__all__ = ["build_model", "ModelBundle"]
