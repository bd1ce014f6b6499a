"""Zoo layers of the port (``analytics_zoo_tpu/nn/layers_zoo.py``): so far
``WordEmbedding``, which the text models take their pre-trained tables
through.  The rest of that file waits in ROADMAP Queue 1 item 13."""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn


class WordEmbedding(nn.Module):
    """Pre-trained word embeddings, frozen by default (reference:
    WordEmbedding, zoo keras layers; loaded GloVe txt files for the text
    models).  ``weights``: [vocab, dim] array, or a GloVe-format txt path
    via :meth:`from_glove`.

    A frozen table is a buffer, ``embeddings``: the JAX package keeps it in
    its ``state`` collection, and a buffer is what ``convert`` maps to
    ``state``.  The optimizer never sees it, so no decoupled weight decay
    (adamw) shrinks it either.  ``trainable=True`` makes it the parameter
    ``embeddings``, as the JAX package's ``params`` holds it."""

    def __init__(self, weights: Any, trainable: bool = False):
        super().__init__()
        self.weights = np.asarray(weights, np.float32)
        if self.weights.ndim != 2:
            raise ValueError(
                f"weights must be [vocab, dim], got {self.weights.shape}")
        self.trainable = trainable
        table = torch.from_numpy(self.weights.copy())
        if trainable:
            self.embeddings = nn.Parameter(table)
        else:
            self.register_buffer("embeddings", table)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The table back to ``weights`` (its initial value in both
        packages; ``generator`` draws nothing)."""
        with torch.no_grad():
            self.embeddings.copy_(torch.from_numpy(self.weights))

    @staticmethod
    def from_glove(path: str, word_index: dict,
                   trainable: bool = False) -> "WordEmbedding":
        """Build from a GloVe-format text file ("word v1 v2 ...": one token
        per line) and a {word: idx} vocabulary (idx 0 = padding).  Words
        missing from the file stay zero.  Malformed lines (multi-token
        words, truncated tails, fastText "count dim" headers) are
        skipped."""
        vectors = {}
        dim = None
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 3:  # also skips fastText "count dim" header
                    continue
                try:
                    vec = np.asarray(parts[1:], np.float32)
                except ValueError:
                    continue  # word containing spaces etc.
                if dim is None:
                    dim = len(vec)
                if len(vec) != dim:
                    continue  # truncated/odd line
                vectors[parts[0]] = vec
        if dim is None:
            raise ValueError(f"no vectors found in {path}")
        table = np.zeros((max(word_index.values()) + 1, dim), np.float32)
        for word, idx in word_index.items():
            v = vectors.get(word)
            if v is not None:
                table[idx] = v
        return WordEmbedding(table, trainable=trainable)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embeddings)


__all__ = ["WordEmbedding"]
