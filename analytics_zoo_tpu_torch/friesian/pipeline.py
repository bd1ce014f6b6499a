"""FeaturePipeline (a copy of ``analytics_zoo_tpu/friesian/pipeline.py``,
plain numpy; the port's ``ClusterServing(pipelines=)`` takes its
``as_server_transform``).

FeaturePipeline: fitted, picklable per-request feature transforms.

``FeatureTable`` does offline feature engineering over sharded pandas;
serving needs the SAME transforms replayed per request on plain dicts —
no pandas, no shards, microseconds not milliseconds.  A
``FeaturePipeline`` records a chain of fitted steps (fillna, clip,
``StringIndex`` encodes, hashed crosses) as plain data, so it pickles
with the model artifact and replays anywhere:

    idx_u, idx_i = table.gen_string_idx(["user", "item"])
    pipe = (FeaturePipeline()
            .fillna(0.0, ["age"]).clip(["age"], min=0, max=100)
            .encode_string(idx_u).encode_string(idx_i)
            .cross_columns([("user", "item")], [1000]))
    feats = pipe.transform({"user": "u1", "item": "i9", "age": 31.0})

Registered on ``ClusterServing(pipelines={...})`` via
``as_server_transform``, it turns the raw event columns of an assembled
request batch into the model's numeric features server-side — clients
send events, not feature vectors.

Semantics match ``FeatureTable`` exactly (same ``_stable_hash`` for
crosses, unseen categories → the reserved id 0), asserted by the
offline-vs-pipeline parity tests.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .table import StringIndex, _stable_hash


def _is_missing(v: Any) -> bool:
    if v is None:
        return True
    if isinstance(v, float) and np.isnan(v):
        return True
    return False


def _fill_col(arr: np.ndarray, value: Any) -> np.ndarray:
    if arr.dtype.kind == "f":
        return np.where(np.isnan(arr), value, arr)
    if arr.dtype == object:
        return np.array([value if _is_missing(v) else v for v in arr],
                        dtype=object)
    return arr


def _encode_col(arr: np.ndarray, index: Dict[Any, int]) -> np.ndarray:
    """Category values → fitted ids; unseen/missing → the reserved id 0
    (``encode_string``'s transform-time semantics).  The wire may carry
    str(category) for a vocab fitted on non-strings — fall back to the
    string form before giving up on a value."""
    out = np.empty(len(arr), np.int64)
    for i, v in enumerate(arr):
        hit = index.get(v)
        if hit is None and not isinstance(v, str):
            hit = index.get(str(v))
        out[i] = 0 if hit is None else hit
    return out


class FeaturePipeline:
    """A fitted feature-transform chain over plain dict events.

    Steps are stored as plain tuples/dicts (no closures, no pandas), so
    the pipeline pickles alongside the model and replays identically in
    any process.  All chaining methods return ``self``."""

    def __init__(self) -> None:
        self._steps: List[tuple] = []

    # -- chain construction ---------------------------------------------------

    def fillna(self, value: Any,
               columns: Sequence[str]) -> "FeaturePipeline":
        self._steps.append(("fillna", {"value": value,
                                       "columns": list(columns)}))
        return self

    def clip(self, columns: Sequence[str], min: Any = None,  # noqa: A002
             max: Any = None) -> "FeaturePipeline":  # noqa: A002
        self._steps.append(("clip", {"columns": list(columns),
                                     "min": min, "max": max}))
        return self

    def encode_string(self, index: StringIndex) -> "FeaturePipeline":
        """Encode ``index.col_name`` through a vocab fitted offline by
        ``FeatureTable.gen_string_idx`` (unseen → 0)."""
        self._steps.append(("encode", {"column": index.col_name,
                                       "index": dict(index.index)}))
        return self

    def cross_columns(self, crosses: Sequence[Sequence[str]],
                      bucket_sizes: Sequence[int]) -> "FeaturePipeline":
        """Hashed crosses, same hash and naming as
        ``FeatureTable.cross_columns`` (new column ``"a_b"``)."""
        if len(crosses) != len(bucket_sizes):
            raise ValueError("one bucket size per cross")
        for cols, size in zip(crosses, bucket_sizes):
            self._steps.append(("cross", {"columns": list(cols),
                                          "size": int(size)}))
        return self

    # -- replay ---------------------------------------------------------------

    def transform(self, events: Union[Dict[str, Any],
                                      Sequence[Dict[str, Any]]]
                  ) -> Dict[str, np.ndarray]:
        """Replay the chain on one event dict or a list of them; returns
        ``{column: np.ndarray}`` with cross columns appended."""
        if isinstance(events, dict):
            events = [events]
        names = list(events[0])
        cols = {c: np.array([e.get(c) for e in events]) for c in names}
        for op, p in self._steps:
            if op == "fillna":
                for c in p["columns"]:
                    if c in cols:
                        cols[c] = _fill_col(cols[c], p["value"])
            elif op == "clip":
                for c in p["columns"]:
                    if c in cols:
                        cols[c] = np.clip(
                            cols[c].astype(np.float64), p["min"], p["max"])
            elif op == "encode":
                c = p["column"]
                if c in cols:
                    cols[c] = _encode_col(cols[c], p["index"])
            elif op == "cross":
                name = "_".join(p["columns"])
                joined = ["_".join(str(cols[c][i]) for c in p["columns"])
                          for i in range(len(events))]
                cols[name] = np.array(
                    [_stable_hash(s) % p["size"] for s in joined],
                    np.int64)
        return cols

    def transform_matrix(self, x: np.ndarray, columns: Sequence[str],
                         dtype: Any = np.float32) -> np.ndarray:
        """Replay the chain on a column-laid-out batch ``[B, C]`` (the
        serving wire layout).  ``columns`` names each position and MAY
        repeat (a ranking request carries one user column and k item
        columns) — a step applies at every position its column names.
        Crosses use the first occurrence of each named column and append
        to the right, in step order.  Returns a numeric ``[B, C']``."""
        x = np.asarray(x)
        if x.ndim != 2 or x.shape[1] != len(columns):
            raise ValueError(
                f"batch shape {x.shape} does not match the declared "
                f"{len(columns)} column(s)")
        names = list(columns)
        out_cols = [np.asarray(x[:, i]) for i in range(x.shape[1])]
        for op, p in self._steps:
            if op == "fillna":
                for i, c in enumerate(names):
                    if c in p["columns"]:
                        out_cols[i] = _fill_col(out_cols[i], p["value"])
            elif op == "clip":
                for i, c in enumerate(names):
                    if c in p["columns"]:
                        out_cols[i] = np.clip(
                            out_cols[i].astype(np.float64),
                            p["min"], p["max"])
            elif op == "encode":
                for i, c in enumerate(names):
                    if c == p["column"]:
                        out_cols[i] = _encode_col(out_cols[i], p["index"])
            elif op == "cross":
                srcs = [out_cols[names.index(c)] for c in p["columns"]]
                joined = ["_".join(str(col[i]) for col in srcs)
                          for i in range(x.shape[0])]
                names.append("_".join(p["columns"]))
                out_cols.append(np.array(
                    [_stable_hash(s) % p["size"] for s in joined],
                    np.int64))
        return np.stack([c.astype(dtype) for c in out_cols], axis=1)

    def as_server_transform(self, columns: Sequence[str],
                            dtype: Any = np.float32) -> Any:
        """A picklable ``fn(batch) -> features`` for
        ``ClusterServing(pipelines={model: fn})``: the assembled request
        batch (raw event columns, laid out per ``columns``) becomes the
        model's numeric features server-side."""
        return _ServerTransform(self, list(columns), dtype)


class _ServerTransform:
    """Top-level class (not a closure) so a pipeline registered on a
    server config stays picklable end to end."""

    def __init__(self, pipeline: FeaturePipeline, columns: List[str],
                 dtype: Any):
        self.pipeline = pipeline
        self.columns = columns
        self.dtype = dtype

    def __call__(self, x: np.ndarray) -> np.ndarray:
        return self.pipeline.transform_matrix(x, self.columns,
                                              dtype=self.dtype)
