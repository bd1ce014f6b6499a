"""Layers of the port (``torch.nn.Module``s with the JAX package's names
and parameter layouts), its losses and its metrics."""

from . import activations, initializers, losses, metrics
from .attention import (FLASH_AUTO_MIN_SEQ, MultiHeadAttention,
                        TransformerLayer, causal_mask, dot_product_attention)
from .layers import (Dense, Dropout, Embedding, LayerNormalization, Remat,
                     seed_dropout)

__all__ = ["activations", "initializers", "losses", "metrics", "Dense",
           "Dropout", "Embedding", "LayerNormalization", "Remat",
           "seed_dropout", "MultiHeadAttention", "TransformerLayer",
           "causal_mask", "dot_product_attention", "FLASH_AUTO_MIN_SEQ"]
