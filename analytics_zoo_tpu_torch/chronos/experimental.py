# Port of analytics_zoo_tpu/chronos/experimental.py: a copy over the port's
# data/shards.py XShards and DataFeed.
"""XShardsTSDataset: the distributed TSDataset.

Reference (SURVEY.md §2.6): ``pyzoo/zoo/chronos/data/experimental/
xshardstsdataset.py`` — TSDataset semantics over SparkXShards so huge
multi-id panels (one shard = a subset of series ids) preprocess in
parallel without one host holding the whole frame.

Here the shards are host-local ``XShards`` (threaded per-shard
transforms); per-shard ops (impute, dt features, roll) run embarrassingly
parallel through ``transform_shard``, while ``scale`` does the one
genuinely distributed step — a two-pass global-moments reduction
(per-shard (count, sum, sumsq/min/max) → combined scaler → applied per
shard), so every shard is scaled by the GLOBAL statistics exactly as the
single-frame TSDataset would."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import pandas as pd

from ..data import XShards
from .data import TSDataset


def _make_ts(df: pd.DataFrame, cfg: Dict[str, Any]) -> TSDataset:
    return TSDataset(df, cfg["dt_col"], cfg["target_col"], cfg["id_col"],
                     cfg["extra_feature_col"])


class XShardsTSDataset:
    def __init__(self, shards: XShards, dt_col: str,
                 target_col: Union[str, Sequence[str]],
                 id_col: Optional[str] = None,
                 extra_feature_col: Optional[Sequence[str]] = None):
        self.shards = shards
        self._cfg = dict(dt_col=dt_col, target_col=target_col,
                         id_col=id_col, extra_feature_col=extra_feature_col)
        self.scaler: Optional[Dict[str, Any]] = None

    @staticmethod
    def from_xshards(shards: XShards, dt_col: str,
                     target_col: Union[str, Sequence[str]],
                     id_col: Optional[str] = None,
                     extra_feature_col: Optional[Sequence[str]] = None
                     ) -> "XShardsTSDataset":
        """Shards of DataFrames (each holding whole series — split by id,
        never mid-series) → distributed TSDataset."""
        return XShardsTSDataset(shards, dt_col, target_col, id_col,
                                extra_feature_col)

    @staticmethod
    def from_pandas(df: pd.DataFrame, dt_col: str,
                    target_col: Union[str, Sequence[str]],
                    id_col: Optional[str] = None,
                    extra_feature_col: Optional[Sequence[str]] = None,
                    num_shards: int = 4) -> "XShardsTSDataset":
        """Partition a multi-id frame into shards BY SERIES ID (a series
        never straddles shards, so rolling windows stay correct)."""
        if id_col is None:
            shards = XShards([df])
        else:
            ids = df[id_col].unique()
            groups = np.array_split(ids, max(1, min(num_shards, len(ids))))
            shards = XShards([
                df[df[id_col].isin(g)].reset_index(drop=True)
                for g in groups if len(g)])
        return XShardsTSDataset(shards, dt_col, target_col, id_col,
                                extra_feature_col)

    # -- per-shard ops (embarrassingly parallel) ------------------------------

    def _map(self, fn) -> "XShardsTSDataset":
        """Apply a TSDataset op per shard, IN PLACE (TSDataset semantics:
        ops mutate and return self, so ``ds.scale(...)`` without
        reassignment behaves identically on both classes)."""
        cfg = self._cfg
        feature_cols: List[Any] = []

        def run(df: pd.DataFrame) -> pd.DataFrame:
            ts = _make_ts(df, cfg)
            fn(ts)
            if not feature_cols:  # ops may ADD feature columns (dt feats)
                feature_cols.append(list(ts.feature_col))
            return ts.df

        self.shards = self.shards.transform_shard(run)
        if feature_cols and feature_cols[0] != list(
                self._cfg["extra_feature_col"] or []):
            self._cfg["extra_feature_col"] = feature_cols[0]
        return self

    def impute(self, mode: str = "last") -> "XShardsTSDataset":
        return self._map(lambda ts: ts.impute(mode))

    def gen_dt_feature(self, features: Optional[Sequence[str]] = None
                       ) -> "XShardsTSDataset":
        return self._map(lambda ts: ts.gen_dt_feature(features))

    # -- distributed scaling ---------------------------------------------------

    def _cols(self) -> List[str]:
        t = self._cfg["target_col"]
        targets = [t] if isinstance(t, str) else list(t)
        extras = list(self._cfg["extra_feature_col"] or [])
        return targets + extras

    def scale(self, scaler: Any = "standard", fit: bool = True
              ) -> "XShardsTSDataset":
        cols = self._cols()
        if isinstance(scaler, dict):
            self.scaler = scaler
        elif fit:
            # pass 1: per-shard sufficient statistics (per-column non-NaN
            # counts, NOT len(df) — sum/sumsq skip NaN, the count must too
            # or pre-impute scaling diverges from the single-frame path)
            stats = self.shards.transform_shard(
                lambda df: (df[cols].count(), df[cols].sum(),
                            (df[cols] ** 2).sum(),
                            df[cols].min(), df[cols].max())).collect()
            n = sum((s[0] for s in stats), pd.Series(0, index=cols))
            total = sum((s[1] for s in stats),
                        pd.Series(0.0, index=cols))
            total_sq = sum((s[2] for s in stats),
                           pd.Series(0.0, index=cols))
            if scaler == "standard":
                mean = total / n
                var = total_sq / n - mean ** 2
                std = np.sqrt(np.maximum(var, 0.0) * n / np.maximum(1, n - 1))
                std = pd.Series(std, index=cols).replace(0, 1.0)
                self.scaler = {"type": "standard", "mean": mean, "std": std}
            elif scaler == "minmax":
                mn = pd.concat([s[3] for s in stats], axis=1).min(axis=1)
                mx = pd.concat([s[4] for s in stats], axis=1).max(axis=1)
                rng = (mx - mn).replace(0, 1.0)
                self.scaler = {"type": "minmax", "min": mn, "range": rng}
            else:
                raise ValueError(f"unknown scaler {scaler!r}")
        elif self.scaler is None:
            raise ValueError("fit=False requires a previously fit scaler")
        s = self.scaler
        # pass 2 (in place): the single-frame TSDataset applies a fitted
        # dict scaler itself — one implementation of the formulas, not two
        self._map(lambda ts: ts.scale(s))
        return self

    def unscale_numpy(self, arr: np.ndarray) -> np.ndarray:
        ts = TSDataset(pd.DataFrame(columns=[self._cfg["dt_col"]]),
                       **self._cfg)
        ts.scaler = self.scaler
        return ts.unscale_numpy(arr)

    # -- windowing / export ---------------------------------------------------

    def roll(self, lookback: int, horizon: Union[int, Sequence[int]]
             ) -> "XShardsTSDataset":
        cfg = self._cfg

        def run(df: pd.DataFrame):
            ts = _make_ts(df, cfg)
            try:
                ts.roll(lookback, horizon)
            except ValueError:
                # a shard whose every series is shorter than the window
                # contributes nothing — the single-frame TSDataset drops
                # short series, so sharding must not turn that into a crash
                return None
            return ts.to_numpy()

        self._rolled = self.shards.transform_shard(run)
        return self

    def to_numpy(self) -> tuple:
        if not hasattr(self, "_rolled"):
            raise ValueError("call roll() first")
        parts = [p for p in self._rolled.collect() if p is not None]
        if not parts:
            raise ValueError(
                "no shard produced windows: every series is shorter than "
                "lookback + horizon")
        x = np.concatenate([p[0] for p in parts], axis=0)
        y = np.concatenate([p[1] for p in parts], axis=0)
        return x, y

    def to_feed(self, batch_size: int = 32, shuffle: bool = True,
                **kw: Any):
        from ..data import DataFeed
        x, y = self.to_numpy()
        return DataFeed.from_arrays(x, y, batch_size, shuffle=shuffle, **kw)
