"""FeatureTable and StringIndex (a copy of
``analytics_zoo_tpu/friesian/table.py``, which is pandas and numpy only,
with its imports pointed at the port: ``to_feed`` builds the port's
``DataFeed``, ``read_csv`` the port's ``data.readers.read_csv``).

FeatureTable: tabular feature engineering for recsys pipelines.

Reference (SURVEY.md §2.2): ``pyzoo/zoo/friesian/feature/table.py`` —
FeatureTable wrapped a Spark DataFrame with encode_string / gen_string_idx
(StringIndex), fillna/clip, cross_columns (hashed crosses), negative
sampling for implicit-feedback training, and train/test splits.

TPU-native: the table is sharded pandas (XShards of DataFrames — the same
host-parallel data plane the rest of the framework uses); global operations
(vocab building, negative sampling universe) reduce over shards, per-row
transforms run shard-parallel via ``XShards.transform_shard``.  Output
feeds ``zoo.models.recommendation`` through the unified Estimator.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

from ..data.shards import XShards


class StringIndex:
    """A fitted category→id vocabulary for one column (reference:
    StringIndex).  Ids start at 1; 0 is reserved for unseen/missing."""

    def __init__(self, col_name: str, index: Dict[Any, int]):
        self.col_name = col_name
        self.index = index

    @property
    def size(self) -> int:
        """Embedding-table size (ids run 0..len(index))."""
        return len(self.index) + 1

    def to_dict(self) -> Dict[Any, int]:
        return dict(self.index)


def _to_shards(df: Union[pd.DataFrame, XShards],
               num_shards: int = 4) -> XShards:
    if isinstance(df, XShards):
        return df
    parts = np.array_split(np.arange(len(df)), num_shards)
    return XShards([df.iloc[p].reset_index(drop=True) for p in parts])


class FeatureTable:
    """Sharded tabular data + chainable feature ops (each op returns a NEW
    FeatureTable; shards are never mutated in place)."""

    def __init__(self, shards: XShards):
        self.shards = shards

    # -- constructors ----------------------------------------------------------

    @staticmethod
    def from_pandas(df: pd.DataFrame, num_shards: int = 4) -> "FeatureTable":
        return FeatureTable(_to_shards(df, num_shards))

    @staticmethod
    def read_csv(path: str, **kw: Any) -> "FeatureTable":
        from ..data.readers import read_csv
        return FeatureTable(read_csv(path, **kw))

    # -- inspection ------------------------------------------------------------

    def to_pandas(self) -> pd.DataFrame:
        return pd.concat(self.shards.collect(), ignore_index=True)

    def __len__(self) -> int:
        return sum(len(df) for df in self.shards.collect())

    @property
    def columns(self) -> List[str]:
        return list(self.shards.collect()[0].columns)

    # -- cleaning --------------------------------------------------------------

    def fillna(self, value: Any,
               columns: Optional[Sequence[str]] = None) -> "FeatureTable":
        cols = list(columns) if columns else None

        def fill(df: pd.DataFrame) -> pd.DataFrame:
            df = df.copy()
            target = cols or df.columns
            df[target] = df[target].fillna(value)
            return df

        return FeatureTable(self.shards.transform_shard(fill))

    def clip(self, columns: Sequence[str], min: Any = None,  # noqa: A002
             max: Any = None) -> "FeatureTable":  # noqa: A002
        cols = list(columns)

        def do(df: pd.DataFrame) -> pd.DataFrame:
            df = df.copy()
            df[cols] = df[cols].clip(lower=min, upper=max)
            return df

        return FeatureTable(self.shards.transform_shard(do))

    def rename(self, mapping: Dict[str, str]) -> "FeatureTable":
        return FeatureTable(self.shards.transform_shard(
            lambda df: df.rename(columns=mapping)))

    def drop(self, *columns: str) -> "FeatureTable":
        return FeatureTable(self.shards.transform_shard(
            lambda df: df.drop(columns=list(columns))))

    # -- categorical encoding --------------------------------------------------

    def gen_string_idx(self, columns: Union[str, Sequence[str]],
                       freq_limit: int = 1) -> List[StringIndex]:
        """Build StringIndex vocabs from the full table (global reduce over
        shards), ordered by descending frequency (reference semantics)."""
        cols = [columns] if isinstance(columns, str) else list(columns)
        indices = []
        dfs = self.shards.collect()
        for c in cols:
            counts: Dict[Any, int] = {}
            for df in dfs:
                for v, n in df[c].value_counts().items():
                    counts[v] = counts.get(v, 0) + int(n)
            vocab = [v for v, n in sorted(counts.items(),
                                          key=lambda kv: (-kv[1], str(kv[0])))
                     if n >= freq_limit]
            indices.append(StringIndex(c, {v: i + 1 for i, v in
                                           enumerate(vocab)}))
        return indices

    def encode_string(self, columns: Union[str, Sequence[str]],
                      indices: Optional[Sequence[StringIndex]] = None
                      ) -> Tuple["FeatureTable", List[StringIndex]]:
        """Replace category values with ids (unseen → 0).  Pass the train
        table's ``indices`` to encode val/test consistently."""
        cols = [columns] if isinstance(columns, str) else list(columns)
        if indices is None:
            indices = self.gen_string_idx(cols)
        by_col = {si.col_name: si.index for si in indices}

        def encode(df: pd.DataFrame) -> pd.DataFrame:
            df = df.copy()
            for c in cols:
                df[c] = df[c].map(by_col[c]).fillna(0).astype(np.int64)
            return df

        return FeatureTable(self.shards.transform_shard(encode)), \
            list(indices)

    # -- crosses ---------------------------------------------------------------

    def cross_columns(self, crosses: Sequence[Sequence[str]],
                      bucket_sizes: Sequence[int]) -> "FeatureTable":
        """Hashed feature crosses: new column "a_b" = hash(a, b) % bucket
        (reference: cross_columns; W&D's wide-side crosses)."""
        if len(crosses) != len(bucket_sizes):
            raise ValueError("one bucket size per cross")

        def do(df: pd.DataFrame) -> pd.DataFrame:
            df = df.copy()
            for cols, size in zip(crosses, bucket_sizes):
                name = "_".join(cols)
                joined = df[list(cols)].astype(str).agg("_".join, axis=1)
                # stable non-cryptographic hash (python hash() is salted)
                df[name] = joined.map(
                    lambda s: _stable_hash(s) % size).astype(np.int64)
            return df

        return FeatureTable(self.shards.transform_shard(do))

    # -- negative sampling -----------------------------------------------------

    def negative_sample(self, item_size: int, item_col: str = "item",
                        label_col: str = "label", neg_num: int = 1,
                        seed: int = 0) -> "FeatureTable":
        """Implicit-feedback training data: every existing row becomes a
        positive (label 1) and gains ``neg_num`` copies with a random item
        and label 0 (reference: add_negative_samples).  ``item_size`` is the
        exclusive upper item-id bound; sampled ids start at 1 (0 = pad).

        Sampling is counter-based on ``(seed, global row, slot)`` — each
        negative is a pure function of the row's GLOBAL position, not of
        which shard holds it, so the same rows with the same ``seed``
        yield the same negatives across runs AND across shard counts
        (1-shard debugging reproduces the 64-shard job)."""
        if item_size < 2:
            raise ValueError(
                f"item_size must be >= 2 (ids sample from [1, item_size)),"
                f" got {item_size}")

        def do(df: pd.DataFrame, start: int) -> pd.DataFrame:
            gidx = np.arange(start, start + len(df), dtype=np.uint64)
            pos = df.copy()
            pos[label_col] = 1
            negs = []
            for j in range(neg_num):
                neg = df.copy()
                neg[item_col] = _counter_sample(seed, gidx, j, item_size)
                neg[label_col] = 0
                negs.append(neg)
            return pd.concat([pos] + negs, ignore_index=True)

        dfs = self.shards.collect()
        offsets = np.concatenate([[0], np.cumsum([len(d) for d in dfs])])
        out = [do(df, int(offsets[i])) for i, df in enumerate(dfs)]
        return FeatureTable(XShards(out))

    # -- splits / export -------------------------------------------------------

    def random_split(self, weights: Sequence[float], seed: int = 0
                     ) -> List["FeatureTable"]:
        """Row-wise split, e.g. [0.8, 0.2] (reference: split)."""
        w = np.asarray(weights, np.float64)
        w = w / w.sum()
        dfs = self.shards.collect()
        parts: List[List[pd.DataFrame]] = [[] for _ in w]
        for i, df in enumerate(dfs):
            rng = np.random.default_rng(seed + i)
            assign = rng.choice(len(w), size=len(df), p=w)
            for j in range(len(w)):
                parts[j].append(df[assign == j].reset_index(drop=True))
        return [FeatureTable(XShards(p)) for p in parts]

    def to_numpy_dict(self, feature_cols: Sequence[str],
                      label_col: str = "label") -> Dict[str, np.ndarray]:
        df = self.to_pandas()
        return {"x": df[list(feature_cols)].to_numpy(),
                "y": df[label_col].to_numpy()}

    def to_feed(self, feature_cols: Sequence[str], label_col: str = "label",
                batch_size: int = 32, **kw: Any):
        from ..data.feed import DataFeed
        d = self.to_numpy_dict(feature_cols, label_col)
        return DataFeed(d, batch_size, **kw)


def _counter_sample(seed: int, gidx: np.ndarray, slot: int,
                    item_size: int) -> np.ndarray:
    """Deterministic item ids in ``[1, item_size)`` from ``(seed, global
    row index, negative slot)`` — a vectorized splitmix64 finalizer, so
    the draw depends only on the row's global position (shard-count
    invariant by construction)."""
    mask = np.uint64(0xFFFFFFFFFFFFFFFF)
    key = np.uint64((seed * 0x9E3779B97F4A7C15
                     + (slot + 1) * 0xBF58476D1CE4E5B9)
                    & 0xFFFFFFFFFFFFFFFF)
    x = (gidx.astype(np.uint64) * np.uint64(0x94D049BB133111EB)) ^ key
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9) & mask
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB) & mask
    x = x ^ (x >> np.uint64(31))
    return (x % np.uint64(item_size - 1) + np.uint64(1)).astype(np.int64)


def _stable_hash(s: str) -> int:
    """FNV-1a 64-bit: deterministic across processes (unlike hash())."""
    h = 0xcbf29ce484222325
    for b in s.encode():
        h = ((h ^ b) * 0x100000001b3) & 0xFFFFFFFFFFFFFFFF
    return h
