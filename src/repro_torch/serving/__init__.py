"""Serving (counterpart of ``repro.serving``): the batched decode engine
over the consensus model, with hot-swap of published weights."""

from repro_torch.serving.engine import GenerationResult, ServeEngine

__all__ = ["ServeEngine", "GenerationResult"]
