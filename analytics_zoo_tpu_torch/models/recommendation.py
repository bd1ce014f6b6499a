"""Recommendation models (port of
``analytics_zoo_tpu/models/recommendation.py``): ``NeuralCF`` (GMF and MLP
towers), its serving tail ``NCFTail``, ``WideAndDeep`` in its three
``model_type``s, the ``UserItemFeature``/``UserItemPrediction`` records and
``recommend_for_user``/``recommend_for_item``.

Child names follow the JAX tree (``mlp_user_embed``, ``mlp_{i}``,
``mf_user_embed``, ``head``; ``wide``, ``embed_{i}``, ``deep_{i}``,
``deep_out``), so ``convert.from_jax_variables`` output loads with
``load_state_dict``.  PyTorch builds parameters up front, so every
``Dense`` gets its input width here from the constructor's arguments.
With ``sharded_embeddings=True`` every id table is a
``parallel.ShardedEmbedding`` (deduped gather, sparse row updates under the
Estimator) under the same child name.  ``SessionRecommender`` runs the
port's ``nn.GRU`` (``nn/recurrent.py``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..nn.layers import Dense, Embedding
from ..nn.recurrent import GRU
from ..parallel.embedding import SPARSE_LEAF, ShardedEmbedding
from .common import ZooModel


@dataclass
class UserItemFeature:
    user_id: int
    item_id: int
    label: Optional[int] = None


@dataclass
class UserItemPrediction:
    user_id: int
    item_id: int
    prediction: int
    probability: float


def _make_embedding(count: int, dim: int, sharded: bool) -> nn.Module:
    """The table behind one id column: ``Embedding`` (replicated, the
    default) or ``ShardedEmbedding`` when ``sharded_embeddings=True``."""
    if sharded:
        return ShardedEmbedding(count, dim)
    return Embedding(count, dim)


def _mlp(layers: Sequence[int], width: int, prefix: str, owner: nn.Module
         ) -> int:
    """Register ``prefix_{i}`` relu Dense layers of ``layers`` units on
    ``owner`` from an input of ``width``; returns the output width."""
    for i, units in enumerate(layers):
        owner.add_module(f"{prefix}_{i}", Dense(width, units,
                                                activation="relu"))
        width = units
    return width


class NeuralCF(ZooModel):
    """Neural Collaborative Filtering: GMF (elementwise product of the MF
    embeddings) beside an MLP over the concatenated embeddings."""

    def __init__(self, user_count: int, item_count: int, class_num: int = 2,
                 user_embed: int = 20, item_embed: int = 20,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 include_mf: bool = True, mf_embed: int = 20,
                 sharded_embeddings: bool = False):
        super().__init__()
        self._config = dict(user_count=user_count, item_count=item_count,
                            class_num=class_num, user_embed=user_embed,
                            item_embed=item_embed,
                            hidden_layers=list(hidden_layers),
                            include_mf=include_mf, mf_embed=mf_embed,
                            sharded_embeddings=sharded_embeddings)
        self.user_count = user_count
        self.item_count = item_count
        self.class_num = class_num
        self.user_embed = user_embed
        self.item_embed = item_embed
        self.hidden_layers = list(hidden_layers)
        self.include_mf = include_mf
        self.mf_embed = mf_embed
        self.sharded_embeddings = sharded_embeddings
        sh = sharded_embeddings
        self.mlp_user_embed = _make_embedding(user_count, user_embed, sh)
        self.mlp_item_embed = _make_embedding(item_count, item_embed, sh)
        width = _mlp(self.hidden_layers, user_embed + item_embed, "mlp",
                     self)
        if include_mf:
            self.mf_user_embed = _make_embedding(user_count, mf_embed, sh)
            self.mf_item_embed = _make_embedding(item_count, mf_embed, sh)
            width += mf_embed
        self.head = Dense(width, class_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: int ``[B, 2]``, (user id, item id)."""
        users, items = x[:, 0], x[:, 1]
        h = torch.cat([self.mlp_user_embed(users),
                       self.mlp_item_embed(items)], dim=-1)
        for i in range(len(self.hidden_layers)):
            h = getattr(self, f"mlp_{i}")(h)
        if self.include_mf:
            h = torch.cat([self.mf_user_embed(users)
                           * self.mf_item_embed(items), h], dim=-1)
        return self.head(h)

    # -- cached-serving split -------------------------------------------------

    def embedding_columns(self):
        """(table name, which id) of each gathered column, in the order
        ``NCFTail`` takes them."""
        cols = [("mlp_user_embed", "user"), ("mlp_item_embed", "item")]
        if self.include_mf:
            cols += [("mf_user_embed", "user"), ("mf_item_embed", "item")]
        return cols

    def serving_split(self, variables):
        """Split trained ``variables`` (a JAX ``{"params", ...}`` tree, as
        ``Estimator.get_model()`` gives) for cached serving: ``(tables,
        tail_module, tail_variables)``, the tables host arrays by child
        name and the tail an ``NCFTail`` whose child names match this
        model's."""
        params = variables["params"]
        leaf = SPARSE_LEAF if self.sharded_embeddings else "embeddings"
        tables = {name: np.asarray(params[name][leaf])
                  for name, _ in self.embedding_columns()}
        tail_keys = [f"mlp_{i}" for i in range(len(self.hidden_layers))]
        tail_keys.append("head")
        tail_vars = {"params": {k: params[k] for k in tail_keys},
                     "state": {}}
        return tables, NCFTail(self), tail_vars

    # -- recommend APIs -------------------------------------------------------

    def recommend_for_user(self, user_ids: Sequence[int], max_items: int = 5
                           ) -> List[UserItemPrediction]:
        """Score every item for each user; top-k per user."""
        return _recommend(self, user_ids, np.arange(self.item_count),
                          per="user", k=max_items)

    def recommend_for_item(self, item_ids: Sequence[int], max_users: int = 5
                           ) -> List[UserItemPrediction]:
        return _recommend(self, np.arange(self.user_count), item_ids,
                          per="item", k=max_users)


class NCFTail(ZooModel):
    """NeuralCF without its gathers: the input is the gathered vectors
    ``[ue | ie | mu | mi]`` (``[ue | ie]`` without MF), the output the class
    logits; ``mlp_{i}`` and ``head`` as in ``NeuralCF``."""

    def __init__(self, ncf: NeuralCF):
        super().__init__()
        self.user_embed = ncf.user_embed
        self.item_embed = ncf.item_embed
        self.hidden_layers = list(ncf.hidden_layers)
        self.include_mf = ncf.include_mf
        self.mf_embed = ncf.mf_embed
        self.class_num = ncf.class_num
        width = _mlp(self.hidden_layers, self.user_embed + self.item_embed,
                     "mlp", self)
        if self.include_mf:
            width += self.mf_embed
        self.head = Dense(width, self.class_num)

    def input_dim(self) -> int:
        return (self.user_embed + self.item_embed
                + (2 * self.mf_embed if self.include_mf else 0))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cut = self.user_embed + self.item_embed
        h = x[:, :cut]
        for i in range(len(self.hidden_layers)):
            h = getattr(self, f"mlp_{i}")(h)
        if self.include_mf:
            mu = x[:, cut:cut + self.mf_embed]
            mi = x[:, cut + self.mf_embed:cut + 2 * self.mf_embed]
            h = torch.cat([mu * mi, h], dim=-1)
        return self.head(h)


class WideAndDeep(ZooModel):
    """Wide & Deep.  Input x: float ``[B, wide_dim + indicator_dim +
    len(embed_in_dims) + continuous_cols]``, laid out as [wide multi-hot |
    indicator | embedding column ids | continuous]; the output is the sum
    of the wide and the deep logits (one of them for ``"wide"`` or
    ``"deep"``).  The embedding tables exist for every ``model_type``, as
    in the JAX tree."""

    def __init__(self, class_num: int = 2, model_type: str = "wide_n_deep",
                 wide_base_dims: Sequence[int] = (),
                 wide_cross_dims: Sequence[int] = (),
                 indicator_dims: Sequence[int] = (),
                 embed_in_dims: Sequence[int] = (),
                 embed_out_dims: Sequence[int] = (),
                 continuous_cols: int = 0,
                 hidden_layers: Sequence[int] = (40, 20, 10),
                 sharded_embeddings: bool = False):
        super().__init__()
        if model_type not in ("wide", "deep", "wide_n_deep"):
            raise ValueError(f"model_type must be 'wide', 'deep' or "
                             f"'wide_n_deep', got {model_type!r}")
        self._config = dict(class_num=class_num, model_type=model_type,
                            wide_base_dims=list(wide_base_dims),
                            wide_cross_dims=list(wide_cross_dims),
                            indicator_dims=list(indicator_dims),
                            embed_in_dims=list(embed_in_dims),
                            embed_out_dims=list(embed_out_dims),
                            continuous_cols=continuous_cols,
                            hidden_layers=list(hidden_layers),
                            sharded_embeddings=sharded_embeddings)
        for k, v in self._config.items():
            setattr(self, k, v)
        self.wide_dim = sum(wide_base_dims) + sum(wide_cross_dims)
        self.indicator_dim = sum(indicator_dims)
        for i, (n, d) in enumerate(zip(self.embed_in_dims,
                                       self.embed_out_dims)):
            self.add_module(f"embed_{i}",
                            _make_embedding(n, d, sharded_embeddings))
        if model_type in ("wide", "wide_n_deep"):
            self.wide = Dense(self.wide_dim, class_num, use_bias=False)
        if model_type in ("deep", "wide_n_deep"):
            width = (self.indicator_dim + continuous_cols
                     + sum(d for _, d in zip(self.embed_in_dims,
                                             self.embed_out_dims)))
            width = _mlp(self.hidden_layers, width, "deep", self)
            self.deep_out = Dense(width, class_num)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ofs = 0
        wide = x[:, ofs:ofs + self.wide_dim]
        ofs += self.wide_dim
        indicator = x[:, ofs:ofs + self.indicator_dim]
        ofs += self.indicator_dim
        embeds = []
        for i in range(min(len(self.embed_in_dims),
                           len(self.embed_out_dims))):
            ids = x[:, ofs].to(torch.int32)
            ofs += 1
            embeds.append(getattr(self, f"embed_{i}")(ids))
        cont = x[:, ofs:ofs + self.continuous_cols]
        parts = []
        if self.model_type in ("wide", "wide_n_deep"):
            parts.append(self.wide(wide))
        if self.model_type in ("deep", "wide_n_deep"):
            h = torch.cat([indicator] + embeds
                          + ([cont] if self.continuous_cols else []), dim=-1)
            for i in range(len(self.hidden_layers)):
                h = getattr(self, f"deep_{i}")(h)
            parts.append(self.deep_out(h))
        out = parts[0]
        for p in parts[1:]:
            out = out + p
        return out


class SessionRecommender(ZooModel):
    """GRU session-based recommender: item embeddings of the session's
    clicks through stacked GRUs (``gru_{i}`` returning sequences, then
    ``gru_out``), with ``include_history`` an MLP (``mlp_{i}``) over the
    mean embedding of the longer-term history beside it, then
    ``head`` ``Dense(item_count)``."""

    def __init__(self, item_count: int, item_embed: int = 32,
                 rnn_hidden_layers: Sequence[int] = (40, 20),
                 session_length: int = 10, include_history: bool = False,
                 mlp_hidden_layers: Sequence[int] = (40, 20),
                 history_length: int = 5):
        super().__init__()
        self._config = dict(item_count=item_count, item_embed=item_embed,
                            rnn_hidden_layers=list(rnn_hidden_layers),
                            session_length=session_length,
                            include_history=include_history,
                            mlp_hidden_layers=list(mlp_hidden_layers),
                            history_length=history_length)
        for k, v in self._config.items():
            setattr(self, k, v)
        self.item_embed = Embedding(item_count, item_embed)
        width = item_embed
        for i, units in enumerate(self.rnn_hidden_layers[:-1]):
            self.add_module(f"gru_{i}", GRU(width, units,
                                            return_sequences=True))
            width = units
        self.gru_out = GRU(width, self.rnn_hidden_layers[-1])
        width = self.rnn_hidden_layers[-1]
        if include_history:
            self.hist_embed = Embedding(item_count, item_embed)
            width += _mlp(self.mlp_hidden_layers, item_embed, "mlp", self)
        self.head = Dense(width, item_count)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: int ``[B, session_length (+ history_length)]`` item ids."""
        h = self.item_embed(x[:, :self.session_length])
        for i in range(len(self.rnn_hidden_layers) - 1):
            h = getattr(self, f"gru_{i}")(h)
        h = self.gru_out(h)
        if self.include_history:
            hist = x[:, self.session_length:
                     self.session_length + self.history_length]
            m = self.hist_embed(hist).mean(dim=1)
            for i in range(len(self.mlp_hidden_layers)):
                m = getattr(self, f"mlp_{i}")(m)
            h = torch.cat([h, m], dim=-1)
        return self.head(h)

    def recommend_for_session(self, sessions: np.ndarray, max_items: int = 5
                              ) -> List[List[tuple]]:
        """Top-k next items per session; returns [(item, prob), ...] rows."""
        logits = self.predict(np.asarray(sessions))
        probs = torch.softmax(torch.from_numpy(
            np.asarray(logits, np.float32)), dim=-1).numpy()
        out = []
        for row in probs:
            top = np.argsort(-row)[:max_items]
            out.append([(int(i), float(row[i])) for i in top])
        return out


def _recommend(model: ZooModel, user_ids, item_ids, per: str, k: int
               ) -> List[UserItemPrediction]:
    user_ids = np.asarray(list(user_ids))
    item_ids = np.asarray(list(item_ids))
    pairs = np.stack([np.repeat(user_ids, len(item_ids)),
                      np.tile(item_ids, len(user_ids))], axis=1)
    logits = model.predict(pairs.astype(np.int32))
    probs = torch.softmax(torch.from_numpy(np.asarray(logits, np.float32)),
                          dim=-1).numpy()
    cls = probs.argmax(-1)
    results: List[UserItemPrediction] = []
    n_u, n_i = len(user_ids), len(item_ids)
    # rank and report by P(positive) = 1 - P(class 0)
    pos_prob = 1.0 - probs[:, 0]
    grid = pos_prob.reshape(n_u, n_i)
    if per == "user":
        for ui, u in enumerate(user_ids):
            top = np.argsort(-grid[ui])[:k]
            for ii in top:
                idx = ui * n_i + ii
                results.append(UserItemPrediction(
                    int(u), int(item_ids[ii]), int(cls[idx]),
                    float(pos_prob[idx])))
    else:
        for ii, it in enumerate(item_ids):
            top = np.argsort(-grid[:, ii])[:k]
            for ui in top:
                idx = ui * n_i + ii
                results.append(UserItemPrediction(
                    int(user_ids[ui]), int(it), int(cls[idx]),
                    float(pos_prob[idx])))
    return results


__all__ = ["NeuralCF", "NCFTail", "WideAndDeep", "SessionRecommender",
           "UserItemFeature", "UserItemPrediction"]
