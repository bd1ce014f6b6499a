"""Seq2seq (port of ``analytics_zoo_tpu/models/seq2seq.py``): an
encoder-decoder over LSTM or GRU stacks with an optional dense bridge and
optional Luong dot attention over the encoder's outputs.

The recurrent layers carry no state between calls, so the bridge's summary
of the encoder enters the decoder as its first timestep, prepended to the
embedded decoder input, and the decoder's first output is dropped.  Child
names follow the JAX tree (``encoder/embed``, ``encoder/rnn_{i}``,
``bridge``, ``dec_embed``, ``ctx_proj``, ``decoder/rnn_{i}``,
``att_comb``, ``head``), with every input width given up front.  ``infer``
decodes greedily: ``max_length`` forwards over a rolling window of tokens
on the model's device, the argmax taken there and the ids copied to the
host once at the end (the JAX package runs the same loop as a
``lax.scan``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from ..nn.layers import Dense, Embedding
from ..nn.recurrent import GRU, LSTM
from .common import ZooModel


class _RNNStack(nn.Module):
    def __init__(self, input_dim: int, rnn_type: str = "lstm",
                 num_layers: int = 1, hidden_size: int = 64,
                 embedding: Optional[nn.Module] = None):
        super().__init__()
        self.rnn_type = rnn_type
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        if embedding is not None:
            self.embed = embedding
        cls = LSTM if rnn_type == "lstm" else GRU
        width = input_dim
        for i in range(num_layers):
            self.add_module(f"rnn_{i}", cls(width, hidden_size,
                                            return_sequences=True))
            width = hidden_size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if "embed" in self._modules:
            x = self.embed(x)
        for i in range(self.num_layers):
            x = getattr(self, f"rnn_{i}")(x)
        return x


class RNNEncoder(_RNNStack):
    """Stacked encoder RNN (``rnn_{i}``), after ``embedding`` (the child
    ``embed``) when one is given; ``input_dim`` is the width the first RNN
    sees (the embedding's output width where there is one)."""


class RNNDecoder(_RNNStack):
    """Stacked decoder RNN: the bridge's summary arrives as the first
    timestep of ``x`` (prepended by ``Seq2seq``), and the caller drops the
    first output step."""


class Seq2seq(ZooModel):
    """``forward`` takes int ids ``[B, T_enc + T_dec]`` (the encoder input,
    then the shifted decoder input), split at ``encoder_length``."""

    def __init__(self, vocab_size: int, embed_dim: int = 64,
                 hidden_size: int = 64, encoder_length: int = 10,
                 decoder_length: int = 10, rnn_type: str = "lstm",
                 num_layers: int = 1, use_attention: bool = False,
                 bridge: str = "dense", output_dim: Optional[int] = None):
        super().__init__()
        self._config = dict(vocab_size=vocab_size, embed_dim=embed_dim,
                            hidden_size=hidden_size,
                            encoder_length=encoder_length,
                            decoder_length=decoder_length, rnn_type=rnn_type,
                            num_layers=num_layers,
                            use_attention=use_attention, bridge=bridge,
                            output_dim=output_dim)
        self.vocab_size = vocab_size
        self.embed_dim = embed_dim
        self.hidden_size = hidden_size
        self.encoder_length = encoder_length
        self.decoder_length = decoder_length
        self.use_attention = use_attention
        self.bridge_type = bridge
        self.output_dim = output_dim or vocab_size
        self.encoder = RNNEncoder(embed_dim, rnn_type, num_layers,
                                  hidden_size,
                                  embedding=Embedding(vocab_size, embed_dim))
        if bridge == "dense":
            self.bridge = Dense(hidden_size, hidden_size)
        self.dec_embed = Embedding(vocab_size, embed_dim)
        if hidden_size != embed_dim:
            self.ctx_proj = Dense(hidden_size, embed_dim)
        self.decoder = RNNDecoder(embed_dim, rnn_type, num_layers,
                                  hidden_size)
        if use_attention:
            self.att_comb = Dense(2 * hidden_size, hidden_size,
                                  activation="tanh")
        self.head = Dense(hidden_size, self.output_dim)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        enc_ids = ids[:, :self.encoder_length]
        dec_ids = ids[:, self.encoder_length:]
        enc_out = self.encoder(enc_ids)
        # the bridge: the encoder's summary as a context vector prepended
        # to the decoder input
        summary = enc_out[:, -1]
        if self.bridge_type == "dense":
            summary = self.bridge(summary)
        dec_in = self.dec_embed(dec_ids)
        ctx = self.ctx_proj(summary) if "ctx_proj" in self._modules \
            else summary
        h = torch.cat([ctx[:, None, :], dec_in], dim=1)  # [B, 1+T_dec, E]
        h = self.decoder(h)[:, 1:]                      # the context step off
        if self.use_attention:
            # Luong dot attention over the encoder outputs
            att = torch.softmax(torch.einsum("btd,bsd->bts", h, enc_out),
                                dim=-1)
            c = torch.einsum("bts,bsd->btd", att, enc_out)
            h = self.att_comb(torch.cat([h, c], dim=-1))
        return self.head(h)

    @torch.no_grad()
    def infer(self, enc_ids, start_id: int = 0,
              max_length: Optional[int] = None) -> np.ndarray:
        """Greedy decode: int ids ``[B, max_length]``."""
        max_length = max_length or self.decoder_length
        device = self.estimator.device
        enc = torch.as_tensor(np.asarray(enc_ids), device=device)
        tokens = torch.full((enc.shape[0], self.decoder_length), start_id,
                            dtype=enc.dtype, device=device)
        was_training = self.training
        self.eval()
        outs = []
        try:
            for _ in range(max_length):
                logits = self(torch.cat([enc, tokens], dim=1))
                nxt = logits[:, -1].argmax(dim=-1).to(tokens.dtype)
                tokens = torch.cat([tokens[:, 1:], nxt[:, None]], dim=1)
                outs.append(nxt)
        finally:
            self.train(was_training)
        return torch.stack(outs, dim=1).cpu().numpy()


__all__ = ["RNNEncoder", "RNNDecoder", "Seq2seq"]
