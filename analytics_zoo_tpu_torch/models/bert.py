"""BERT family (port of ``analytics_zoo_tpu/models/bert.py``): the encoder
trunk and the classifier, span (SQuAD) and token (NER) heads.

Parameter names follow the JAX tree (``tok_embed.embeddings``, ``pos_embed``,
``embed_ln``, ``layer_{i}``, ``pooler``, ``head``, ...), so
``convert.from_jax_variables`` output loads with ``load_state_dict``.
"""

from __future__ import annotations

from typing import Any, Optional

import torch
from torch import nn

from ..nn import Dense, Dropout, Embedding, LayerNormalization, Remat, \
    TransformerLayer, initializers
from .common import ZooModel


class BERT(nn.Module):
    """Encoder trunk: ids ``[B, T]`` (+ segment ids) -> ``[B, T, hidden]``
    f32.

    ``segments=True`` creates the segment embedding (``seg_embed``, over
    ``type_vocab`` ids); the JAX package creates it when ``init`` sees
    segment ids, PyTorch builds parameters up front.  ``dtype`` casts the
    activations after the embedding LayerNorm, so the encoder stack runs in
    it.

    ``remat``: checkpoint each whole encoder block (``Remat``; its
    parameters sit under ``remat_{i}/layer_{i}``, as in the JAX tree).
    ``remat_attention``: checkpoint only the dense attention core (not
    with ``use_flash=True``, which keeps no attention maps).  Both
    recompute in the backward what they do not keep.  ``use_ring``:
    every block's attention is ``parallel.ring_self_attention``, the
    sequence split over the mesh's ``seq`` axis (plain attention where
    the mesh has none)."""

    def __init__(self, vocab_size: int = 30522, hidden_size: int = 768,
                 n_layers: int = 12, n_heads: int = 12,
                 intermediate_mult: int = 4, max_position: int = 512,
                 type_vocab: int = 2, dropout: float = 0.1,
                 use_flash: bool = False, use_ring: bool = False,
                 segments: bool = False,
                 remat: bool = False, remat_attention: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.remat = remat
        self.dtype = dtype
        self.tok_embed = Embedding(vocab_size, hidden_size)
        self.pos_embed = nn.Parameter(torch.empty(1, max_position,
                                                  hidden_size))
        self.seg_embed = Embedding(type_vocab, hidden_size) if segments \
            else None
        self.embed_ln = LayerNormalization(hidden_size)
        self.embed_drop = Dropout(dropout)
        for i in range(n_layers):
            block = TransformerLayer(
                hidden_size, n_heads, hidden_mult=intermediate_mult,
                dropout=dropout, pre_ln=True, use_flash=use_flash,
                remat_attention=remat_attention and not remat,
                use_ring=use_ring)
            if remat:
                self.add_module(f"remat_{i}", Remat(block, f"layer_{i}"))
            else:
                self.add_module(f"layer_{i}", block)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        initializers.get("normal")(self.pos_embed, generator)

    def forward(self, ids: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.tok_embed(ids) + self.pos_embed[:, :ids.shape[1]]
        if segment_ids is not None:
            if self.seg_embed is None:
                raise ValueError("segment ids given to a BERT built without "
                                 "segments=True")
            x = x + self.seg_embed(segment_ids)
        x = self.embed_drop(self.embed_ln(x))
        if self.dtype is not None:
            x = x.to(self.dtype)
        for i in range(self.n_layers):
            name = f"remat_{i}" if self.remat else f"layer_{i}"
            x = getattr(self, name)(x, mask=mask)
        return x.float()


class BERTClassifier(ZooModel):
    """[CLS] pooler (tanh) + linear head."""

    def __init__(self, class_num: int, **bert_kwargs: Any):
        super().__init__()
        self._config = dict(class_num=class_num, **bert_kwargs)
        self.bert = BERT(**bert_kwargs)
        h = self.bert.hidden_size
        self.pooler = Dense(h, h, activation="tanh")
        self.head = Dense(h, class_num)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.head(self.pooler(self.bert(ids)[:, 0]))


class BERTSQuAD(ZooModel):
    """Span head: per-token (start, end) logits ``[B, T, 2]``."""

    def __init__(self, **bert_kwargs: Any):
        super().__init__()
        self._config = dict(**bert_kwargs)
        self.bert = BERT(**bert_kwargs)
        self.span_head = Dense(self.bert.hidden_size, 2)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.span_head(self.bert(ids))


class BERTNER(ZooModel):
    """Token-classification head: per-token entity logits."""

    def __init__(self, entity_num: int, **bert_kwargs: Any):
        super().__init__()
        self._config = dict(entity_num=entity_num, **bert_kwargs)
        self.bert = BERT(**bert_kwargs)
        self.ner_head = Dense(self.bert.hidden_size, entity_num)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return self.ner_head(self.bert(ids))


def squad_span_loss(y_pred: torch.Tensor, y_true: torch.Tensor
                    ) -> torch.Tensor:
    """``y_pred`` ``[B, T, 2]`` span logits; ``y_true`` int ``[B, 2]`` =
    (start, end): the mean of the start and end cross-entropies."""
    y_true = y_true.long()

    def nll(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        logp = torch.log_softmax(logits, dim=-1)
        return -torch.gather(logp, 1, idx[:, None])[:, 0]

    return (nll(y_pred[..., 0], y_true[:, 0]) +
            nll(y_pred[..., 1], y_true[:, 1])).mean() / 2.0
