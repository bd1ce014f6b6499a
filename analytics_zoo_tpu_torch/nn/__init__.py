"""Layers of the port (``torch.nn.Module``s with the JAX package's names
and parameter layouts), its losses and its metrics."""

from . import activations, initializers, losses, metrics, quant
from .attention import (FLASH_AUTO_MIN_SEQ, MultiHeadAttention,
                        TransformerLayer, causal_mask, dot_product_attention)
from .layers import (AveragePooling2D, BatchNormalization, Conv1D, Conv2D,
                     Dense, Dropout, Embedding, Flatten, GlobalAveragePooling2D,
                     GlobalMaxPooling2D, LayerNormalization, MaxPooling2D,
                     Remat, ScaledWSConv2D, Sequential, ZeroPadding2D,
                     scaled_ws_kernel, seed_dropout)
from .layers_zoo import WordEmbedding
from .recurrent import GRU, LSTM, Bidirectional, SimpleRNN, TimeDistributed

__all__ = ["activations", "initializers", "losses", "metrics", "quant",
           "Dense",
           "Dropout", "Embedding", "LayerNormalization", "Remat",
           "AveragePooling2D", "BatchNormalization", "Conv1D", "Conv2D",
           "Flatten", "GlobalAveragePooling2D", "GlobalMaxPooling2D", "MaxPooling2D",
           "ScaledWSConv2D", "Sequential", "ZeroPadding2D",
           "scaled_ws_kernel",
           "seed_dropout", "MultiHeadAttention", "TransformerLayer",
           "causal_mask", "dot_product_attention", "FLASH_AUTO_MIN_SEQ",
           "LSTM", "GRU", "SimpleRNN", "Bidirectional", "TimeDistributed",
           "WordEmbedding"]
