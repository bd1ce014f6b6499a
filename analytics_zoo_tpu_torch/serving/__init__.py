"""Serving of the port (``InferenceModel`` so far)."""

from .inference_model import InferenceModel

__all__ = ["InferenceModel"]
