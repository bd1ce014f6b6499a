"""Serving of the port (``InferenceModel``: float, bf16 and int8 serving,
one CUDA graph per batch key on the card)."""

from .inference_model import InferenceModel, enable_aot_cache

__all__ = ["InferenceModel", "enable_aot_cache"]
