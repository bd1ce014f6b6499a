"""MTNetForecaster (port of ``analytics_zoo_tpu/chronos/mtnet.py``): the
memory time-series network (Chang et al. 2018).

A long history is split into ``long_num`` memory blocks of ``time_step``
steps; one encoder (a ``"same"`` ``Conv1D``, dropout, a GRU) embeds every
block and the short-term window at once, the block axis folded into the
batch; the short-term embedding attends over the memory embeddings
through ``attn_w``; a ``head`` reads the context beside the short-term
embedding, and an autoregressive ``Dense(use_bias=False)`` over the last
``ar_window`` raw targets is added to it.
"""

from __future__ import annotations

from typing import Any

import torch
from torch import nn

from ..nn import initializers
from ..nn.layers import Conv1D, Dense, Dropout
from ..nn.recurrent import GRU
from .forecaster import _Forecaster


class _MTNet(nn.Module):
    def __init__(self, input_feature_num: int, long_num: int = 4,
                 time_step: int = 8, cnn_hid_size: int = 32,
                 rnn_hid_size: int = 32, cnn_kernel_size: int = 3,
                 ar_window: int = 4, dropout: float = 0.1,
                 output_dim: int = 1, horizon: int = 1):
        super().__init__()
        self.long_num = long_num
        self.time_step = time_step
        self.rnn_hid = rnn_hid_size
        self.ar_window = ar_window
        self.output_dim = output_dim
        self.horizon = horizon
        self.enc_cnn = Conv1D(input_feature_num, cnn_hid_size,
                              cnn_kernel_size, padding="same",
                              activation="relu")
        self.enc_drop = Dropout(dropout)
        self.enc_rnn = GRU(cnn_hid_size, rnn_hid_size)
        self.attn_w = nn.Parameter(torch.empty(rnn_hid_size, rnn_hid_size))
        self.head = Dense(2 * rnn_hid_size, horizon * output_dim)
        self.ar = Dense(ar_window, horizon, use_bias=False)
        self.reset_parameters()

    def reset_parameters(self, generator=None):
        initializers.glorot_uniform(self.attn_w, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, total, f = x.shape
        ln, t = self.long_num, self.time_step
        if total != (ln + 1) * t:
            raise ValueError(
                f"MTNet needs past_seq_len == (long_num+1)*time_step = "
                f"{(ln + 1) * t}, got {total}")
        # memory blocks and the short-term window folded into the batch:
        # one encoder embeds them all with shared weights
        blocks = x.reshape(b * (ln + 1), t, f)
        h = self.enc_rnn(self.enc_drop(self.enc_cnn(blocks)))
        h = h.reshape(b, ln + 1, self.rnn_hid)
        memory, short = h[:, :ln], h[:, ln]               # [B,ln,H], [B,H]
        # attention of the short-term embedding over the memory blocks
        scores = torch.einsum("blh,hk,bk->bl", memory, self.attn_w, short)
        attn = torch.softmax(scores, dim=-1)
        context = torch.einsum("bl,blh->bh", attn, memory)  # [B, H]
        out = self.head(torch.cat([context, short], dim=-1))
        out = out.reshape(b, self.horizon, self.output_dim)
        # the autoregressive highway on the recent raw targets (the first
        # output_dim features, TSDataset.roll's layout)
        ar_in = x[:, -self.ar_window:, :self.output_dim]   # [B, ar, D]
        ar_in = ar_in.transpose(1, 2).reshape(b * self.output_dim,
                                              self.ar_window)
        ar = self.ar(ar_in).reshape(b, self.output_dim, self.horizon)
        return out + ar.transpose(1, 2)


class MTNetForecaster(_Forecaster):
    """Reference API: MTNetForecaster(target_dim, feature_dim,
    long_series_num, series_length, ...) with fit/predict/evaluate/save/
    load through the Estimator.  ``past_seq_len`` must equal
    (long_series_num + 1) * series_length."""

    MODEL_CLS = _MTNet

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 long_series_num: int = 4, series_length: int = 0,
                 **kwargs: Any):
        if series_length == 0:
            if past_seq_len % (long_series_num + 1):
                raise ValueError(
                    f"past_seq_len {past_seq_len} not divisible into "
                    f"{long_series_num}+1 blocks; pass series_length")
            series_length = past_seq_len // (long_series_num + 1)
        kwargs.setdefault("ar_window", min(4, series_length))
        super().__init__(past_seq_len, future_seq_len, input_feature_num,
                         output_feature_num, long_num=long_series_num,
                         time_step=series_length, **kwargs)
