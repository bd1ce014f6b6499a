"""Layers of the port (``torch.nn.Module``s with the JAX package's names
and parameter layouts)."""

from . import activations, initializers
from .attention import (FLASH_AUTO_MIN_SEQ, MultiHeadAttention,
                        TransformerLayer, causal_mask, dot_product_attention)
from .layers import Dense, Dropout, Embedding, LayerNormalization

__all__ = ["activations", "initializers", "Dense", "Dropout", "Embedding",
           "LayerNormalization", "MultiHeadAttention", "TransformerLayer",
           "causal_mask", "dot_product_attention", "FLASH_AUTO_MIN_SEQ"]
