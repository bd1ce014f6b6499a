"""TextClassifier (port of ``analytics_zoo_tpu/models/textclassification.py``;
reference: zoo.models.textclassification, TextClassifier.scala + py twin).

encoder="cnn": embedding -> temporal conv -> global max pool over time
(the reference's default CNN text classifier); "lstm"/"gru": recurrent
encoder, last output.  Input: int token ids [B, T] (from ``data.TextSet``'s
word2idx pipeline).  Module names follow the JAX tree (``embed``, ``conv``,
``lstm``, ``gru``, ``fc1``, ``drop``, ``head``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.layers import Conv1D, Dense, Dropout, Embedding
from ..nn.layers_zoo import WordEmbedding
from ..nn.recurrent import GRU, LSTM
from .common import ZooModel


class TextClassifier(ZooModel):
    def __init__(self, class_num: int, vocab_size: int = 20000,
                 token_length: int = 200, sequence_length: int = 500,
                 encoder: str = "cnn", encoder_output_dim: int = 256,
                 embedding_weights=None, embedding_trainable: bool = False,
                 embedding_shape=None):
        """``embedding_weights``: optional pre-trained [vocab, dim] table
        (e.g. ``nn.WordEmbedding.from_glove(...).weights``), as the
        reference's TextClassifier took a GloVe embedding file; frozen
        unless ``embedding_trainable``.  ``embedding_shape`` is the
        save/load round-trip of the table's shape (the values themselves
        travel in the saved variables)."""
        super().__init__()
        if embedding_weights is not None:
            embedding_weights = np.asarray(embedding_weights, np.float32)
            if embedding_weights.shape[0] != vocab_size:
                raise ValueError(
                    f"embedding_weights has {embedding_weights.shape[0]} "
                    f"rows but vocab_size={vocab_size}; out-of-range ids "
                    "would silently clamp to the last row")
            embedding_shape = list(embedding_weights.shape)
        elif embedding_shape is not None:
            # loading path: architecture only; the saved variables carry
            # the table's values
            embedding_weights = np.zeros(tuple(embedding_shape), np.float32)
        self._config = dict(class_num=class_num, vocab_size=vocab_size,
                            token_length=token_length,
                            sequence_length=sequence_length, encoder=encoder,
                            encoder_output_dim=encoder_output_dim,
                            embedding_shape=embedding_shape,
                            embedding_trainable=embedding_trainable)
        for k, v in self._config.items():
            setattr(self, k, v)
        if encoder not in ("cnn", "lstm", "gru"):
            raise ValueError(f"unknown encoder {encoder!r}")
        if embedding_weights is not None:
            self.embed = WordEmbedding(embedding_weights,
                                       trainable=embedding_trainable)
            dim = embedding_weights.shape[1]
        else:
            self.embed = Embedding(vocab_size, token_length)
            dim = token_length
        if encoder == "cnn":
            self.conv = Conv1D(dim, encoder_output_dim, 5, activation="relu")
        elif encoder == "lstm":
            self.lstm = LSTM(dim, encoder_output_dim)
        else:
            self.gru = GRU(dim, encoder_output_dim)
        self.fc1 = Dense(encoder_output_dim, 128, activation="relu")
        self.drop = Dropout(0.2)
        self.head = Dense(128, class_num)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids)
        if self.encoder == "cnn":
            # global max pool over time; amax shares the gradient evenly
            # among tied maxima, as jnp.max does
            h = torch.amax(self.conv(x), dim=1)
        elif self.encoder == "lstm":
            h = self.lstm(x)
        else:
            h = self.gru(x)
        return self.head(self.drop(self.fc1(h)))


__all__ = ["TextClassifier"]
