"""TextSet: the text preprocessing pipeline (a copy of
``analytics_zoo_tpu/data/text.py``, which is numpy and pandas only; the
port keeps its own copy, and ``to_feed`` builds the port's ``DataFeed``).

Reference (SURVEY.md §2.2): Scala ``feature/text/*.scala`` +
``pyzoo/zoo/feature/text/text_set.py``: TextFeature records flowed through
Tokenizer -> Normalizer -> WordIndexer -> SequenceShaper -> TextSetToSample,
feeding TextClassifier/KNRM/QARanker.

One host-side class with the same chainable stage names (tokenize /
normalize / word2idx / shape_sequence / generate_sample); the output is
int32 id arrays that batch directly onto the card.  Index 0 is PAD, index
1 is OOV (out-of-vocabulary), real words start at 2: the reference's
WordIndexer convention.
"""

from __future__ import annotations

import json
import os
import re
from collections import Counter
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

_TOKEN_RE = re.compile(r"[A-Za-z0-9']+")
PAD_ID = 0
OOV_ID = 1


class TextSet:
    """texts (+ optional integer labels) → tokenized/indexed/padded arrays."""

    def __init__(self, texts: Sequence[str],
                 labels: Optional[Sequence[int]] = None):
        self.texts = list(texts)
        self.labels = None if labels is None else np.asarray(labels,
                                                             np.int32)
        if self.labels is not None and len(self.labels) != len(self.texts):
            raise ValueError(
                f"{len(self.texts)} texts but {len(self.labels)} labels")
        self.tokens: Optional[List[List[str]]] = None
        self.word_index: Optional[Dict[str, int]] = None
        self._ids: Optional[List[List[int]]] = None
        self._seq_len: Optional[int] = None

    # -- constructors (reference: TextSet.read / from RDD) ---------------------

    @staticmethod
    def from_texts(texts: Sequence[str],
                   labels: Optional[Sequence[int]] = None) -> "TextSet":
        return TextSet(texts, labels)

    @staticmethod
    def read_csv(path: str, text_col: str = "text",
                 label_col: Optional[str] = "label") -> "TextSet":
        import pandas as pd
        df = pd.read_csv(path)
        labels = (df[label_col].to_numpy()
                  if label_col and label_col in df else None)
        return TextSet(df[text_col].astype(str).tolist(), labels)

    # -- pipeline stages (chainable, reference stage names) --------------------

    def tokenize(self) -> "TextSet":
        self.tokens = [_TOKEN_RE.findall(t) for t in self.texts]
        return self

    def normalize(self) -> "TextSet":
        """Lowercase (reference Normalizer also stripped punctuation, which
        the token regex already did)."""
        if self.tokens is None:
            self.tokenize()
        self.tokens = [[w.lower() for w in toks] for toks in self.tokens]
        return self

    def word2idx(self, max_words_num: Optional[int] = None,
                 min_freq: int = 1,
                 existing_index: Optional[Dict[str, int]] = None
                 ) -> "TextSet":
        """Build (or adopt) the vocab and map tokens → ids.  Val/test sets
        pass the train set's ``word_index`` so ids agree across splits."""
        if self.tokens is None:
            self.normalize()
        if existing_index is not None:
            self.word_index = dict(existing_index)
        else:
            counts = Counter(w for toks in self.tokens for w in toks)
            vocab = [w for w, c in counts.most_common(max_words_num)
                     if c >= min_freq]
            self.word_index = {w: i + 2 for i, w in enumerate(vocab)}
        wi = self.word_index
        self._ids = [[wi.get(w, OOV_ID) for w in toks]
                     for toks in self.tokens]
        return self

    def shape_sequence(self, len: int,  # noqa: A002 — reference arg name
                       trunc_mode: str = "pre") -> "TextSet":
        """Pad (with PAD_ID) or truncate every sequence to ``len``.
        ``trunc_mode``: "pre" keeps the tail, "post" keeps the head —
        reference SequenceShaper semantics."""
        if self._ids is None:
            raise ValueError("call word2idx before shape_sequence")
        out = []
        for ids in self._ids:
            if len_ := max(0, len - np.size(ids)):
                ids = list(ids) + [PAD_ID] * len_
            elif trunc_mode == "pre":
                ids = list(ids[-len:])
            else:
                ids = list(ids[:len])
            out.append(ids)
        self._ids = out
        self._seq_len = len
        return self

    # -- materialization -------------------------------------------------------

    def generate_sample(self) -> "TextSet":  # reference-parity no-op marker
        return self

    def to_numpy(self):
        if self._ids is None or self._seq_len is None:
            raise ValueError("run tokenize/word2idx/shape_sequence first")
        x = np.asarray(self._ids, np.int32)
        if self.labels is not None:
            return x, self.labels.copy()
        return x, None

    def to_feed(self, batch_size: int, **kw: Any):
        from .feed import DataFeed
        x, y = self.to_numpy()
        return DataFeed.from_arrays(x, y, batch_size, **kw)

    def vocab_size(self) -> int:
        """Embedding-table size: ids run 0..len(word_index)+1."""
        if self.word_index is None:
            raise ValueError("call word2idx first")
        return len(self.word_index) + 2

    def __len__(self) -> int:
        return len(self.texts)

    # -- word-index persistence (reference: save/load_word_index) --------------

    def save_word_index(self, path: str) -> str:
        if self.word_index is None:
            raise ValueError("no word index: call word2idx first")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.word_index, f)
        return path

    @staticmethod
    def load_word_index(path: str) -> Dict[str, int]:
        with open(path) as f:
            return json.load(f)
