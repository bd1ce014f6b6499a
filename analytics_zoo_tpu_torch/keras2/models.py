"""Keras-2 model containers."""

from ..nn import Input, Model, Sequential  # noqa: F401

__all__ = ["Input", "Model", "Sequential"]
