"""Models of the port: the paper's EHR MLP (``mlp``) and the dense
decoder-only transformer that the serving engine serves (``layers``,
``attention``, ``transformer``, ``model``)."""

from repro_torch.models.model import ModelBundle, build_model

__all__ = ["build_model", "ModelBundle"]
