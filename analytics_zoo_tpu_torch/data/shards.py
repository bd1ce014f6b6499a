"""XShards (a copy of ``analytics_zoo_tpu/data/shards.py``, which is numpy
and pandas only; the port keeps its own copy so that it imports nothing of
the JAX package).

XShards: the sharded-data abstraction, TPU-host-native.

Reference (SURVEY.md §2.2): ``SparkXShards`` (pyzoo/zoo/orca/data/shard.py)
held a Spark RDD whose partitions were lists of Python objects (pandas
DataFrames or numpy dicts) with a map-style API (``transform_shard``,
``partition_by``, ``repartition``, ``split``); ``RayXShards``
(pyzoo/zoo/orca/data/ray_xshards.py) moved those partitions into Ray actors to
feed Ray-based estimators.

TPU-native redesign: there is no driver/executor split — one Python process
per TPU host *is* the data plane.  An ``XShards`` is a list of host-local
shards; in multi-host runs each process holds only its own slice of the
global shard set (SPMD over hosts, matching how batches are then fed to the
ICI-connected chips).  ``transform_shard`` fans out over a thread pool (the
work is pandas/numpy, which releases the GIL for the heavy parts).  The
Spark→Ray object-store copy disappears: shards are already where the
estimator needs them.
"""

from __future__ import annotations

import concurrent.futures as _futures
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np


class XShards:
    """A collection of data shards local to this host process.

    API parity with the reference's XShards (pyzoo/zoo/orca/data/shard.py):
    ``transform_shard``, ``collect``, ``num_partitions``, ``repartition``,
    ``partition_by``, ``split``, ``len``; plus numpy-dict helpers used by the
    estimators.
    """

    def __init__(self, shards: Sequence[Any], max_workers: Optional[int] = None):
        self._shards: List[Any] = list(shards)
        self._max_workers = max_workers or min(16, os.cpu_count() or 4)

    # -- construction ---------------------------------------------------------

    @staticmethod
    def partition(data: Any, num_shards: Optional[int] = None) -> "XShards":
        """Partition in-memory data into shards (reference: XShards.partition).

        Accepts a numpy array, a dict of arrays ({"x": ..., "y": ...}), or a
        tuple/list of arrays; splits along axis 0.
        """
        n = num_shards or min(8, os.cpu_count() or 4)

        def split_leaf(a: np.ndarray) -> List[np.ndarray]:
            return np.array_split(a, n)

        if isinstance(data, np.ndarray):
            return XShards(split_leaf(data))
        if isinstance(data, dict):
            parts = {k: _split_nested(v, n) for k, v in data.items()}
            return XShards([{k: parts[k][i] for k in data} for i in range(n)])
        if isinstance(data, (tuple, list)):
            parts = [_split_nested(v, n) for v in data]
            return XShards([type(data)(p[i] for p in parts) for i in range(n)])
        raise TypeError(f"cannot partition data of type {type(data)}")

    # -- core API -------------------------------------------------------------

    def transform_shard(self, fn: Callable, *args: Any) -> "XShards":
        """Apply ``fn(shard, *args)`` to every shard in parallel."""
        if len(self._shards) <= 1:
            return XShards([fn(s, *args) for s in self._shards],
                           self._max_workers)
        with _futures.ThreadPoolExecutor(self._max_workers) as pool:
            out = list(pool.map(lambda s: fn(s, *args), self._shards))
        return XShards(out, self._max_workers)

    def collect(self) -> List[Any]:
        return list(self._shards)

    def num_partitions(self) -> int:
        return len(self._shards)

    def repartition(self, num_partitions: int) -> "XShards":
        """Rebalance shards; supports pandas DataFrames and numpy dicts."""
        shards = self._shards
        if not shards:
            return XShards([])
        first = shards[0]
        try:
            import pandas as pd
            if isinstance(first, pd.DataFrame):
                # row ranges by iloc: np.array_split of a DataFrame gives
                # numpy arrays under pandas 3, frames before it
                whole = pd.concat(shards, ignore_index=True)
                return XShards(
                    [whole.iloc[part] for part in np.array_split(
                        np.arange(len(whole)), num_partitions)],
                    self._max_workers)
        except ImportError:
            pass
        if isinstance(first, dict):
            whole = {k: _concat_nested([s[k] for s in shards]) for k in first}
            return XShards.partition(whole, num_partitions)
        if isinstance(first, np.ndarray):
            return XShards.partition(_concat_nested(shards), num_partitions)
        # generic python objects: round-robin regroup
        flat: List[Any] = []
        for s in shards:
            flat.extend(s if isinstance(s, list) else [s])
        groups: List[List[Any]] = [[] for _ in range(num_partitions)]
        for i, item in enumerate(flat):
            groups[i % num_partitions].append(item)
        return XShards(groups, self._max_workers)

    def partition_by(self, cols: str, num_partitions: Optional[int] = None
                     ) -> "XShards":
        """Hash-partition pandas shards by a column (reference: partition_by)."""
        import pandas as pd
        whole = pd.concat(self._shards, ignore_index=True)
        n = num_partitions or self.num_partitions() or 1
        codes = pd.util.hash_array(whole[cols].to_numpy()) % n
        return XShards([whole[codes == i] for i in range(n)],
                       self._max_workers)

    def split(self) -> List["XShards"]:
        """If each shard is a tuple/list of k pieces, split into k XShards
        (reference: XShards.split)."""
        first = self._shards[0]
        if not isinstance(first, (tuple, list)):
            raise ValueError("split() requires shards that are tuples/lists")
        k = len(first)
        return [XShards([s[i] for s in self._shards], self._max_workers)
                for i in range(k)]

    def __len__(self) -> int:
        total = 0
        for s in self._shards:
            total += _shard_len(s)
        return total

    def __iter__(self):
        return iter(self._shards)

    # -- numpy-dict helpers (estimator data contract) -------------------------

    def to_numpy_dict(self, feature_cols: Optional[Sequence[str]] = None,
                      label_cols: Optional[Sequence[str]] = None) -> "XShards":
        """pandas shards → {"x": ndarray, "y": ndarray} shards, the contract
        the reference estimators consumed (pyzoo/zoo/orca/data/utils.py)."""
        def conv(df):
            out: Dict[str, Any] = {}
            if feature_cols:
                xs = [df[c].to_numpy() for c in feature_cols]
                out["x"] = np.stack(xs, axis=1) if len(xs) > 1 else xs[0]
            if label_cols:
                ys = [df[c].to_numpy() for c in label_cols]
                out["y"] = np.stack(ys, axis=1) if len(ys) > 1 else ys[0]
            return out
        return self.transform_shard(conv)

    def concatenated(self) -> Any:
        """Materialize all shards into one object (arrays concatenated)."""
        shards = self._shards
        if not shards:
            return None
        first = shards[0]
        if isinstance(first, dict):
            return {k: _concat_nested([s[k] for s in shards]) for k in first}
        if isinstance(first, (tuple, list)):
            k = len(first)
            return type(first)(
                _concat_nested([s[i] for s in shards]) for i in range(k))
        return _concat_nested(shards)


def _split_nested(v: Any, n: int) -> List[Any]:
    if isinstance(v, np.ndarray):
        return np.array_split(v, n)
    if isinstance(v, (tuple, list)):
        parts = [_split_nested(x, n) for x in v]
        return [type(v)(p[i] for p in parts) for i in range(n)]
    raise TypeError(f"cannot split leaf of type {type(v)}")


def _concat_nested(vals: List[Any]) -> Any:
    first = vals[0]
    if isinstance(first, np.ndarray):
        return np.concatenate(vals, axis=0)
    if hasattr(first, "iloc"):  # pandas
        import pandas as pd
        return pd.concat(vals, ignore_index=True)
    if isinstance(first, (tuple, list)):
        k = len(first)
        return type(first)(
            _concat_nested([v[i] for v in vals]) for i in range(k))
    return np.concatenate([np.asarray(v) for v in vals], axis=0)


def _shard_len(s: Any) -> int:
    if isinstance(s, dict):
        return _shard_len(next(iter(s.values())))
    if isinstance(s, (tuple, list)) and s and hasattr(s[0], "__len__"):
        return _shard_len(s[0])
    try:
        return len(s)
    except TypeError:
        return 1
