# Port of analytics_zoo_tpu/chronos/data.py: a copy (pandas and numpy), its
# imports pointed at the port (to_feed builds the port's DataFeed).
"""TSDataset (reference: pyzoo/zoo/chronos/data/tsdataset.py).

Pandas-based container with the reference's method chain: impute,
deduplicate, resample, scale/unscale_numpy, gen_dt_feature, roll → numpy
(x, y) windows.  Pure host-side feature engineering; arrays feed the
forecasters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import pandas as pd

_DT_FEATURES = ["HOUR", "DAY", "DAYOFWEEK", "MONTH", "DAYOFYEAR",
                "WEEKOFYEAR", "MINUTE", "IS_WEEKEND"]


class TSDataset:
    def __init__(self, df: pd.DataFrame, dt_col: str,
                 target_col: Sequence[str], id_col: Optional[str] = None,
                 extra_feature_col: Optional[Sequence[str]] = None):
        self.df = df.copy()
        self.dt_col = dt_col
        self.target_col = ([target_col] if isinstance(target_col, str)
                           else list(target_col))
        self.id_col = id_col
        self.feature_col = list(extra_feature_col or [])
        self.scaler = None
        self._scaler_cols: List[str] = []
        self.df[dt_col] = pd.to_datetime(self.df[dt_col])
        self.df.sort_values(dt_col, inplace=True)
        self.df.reset_index(drop=True, inplace=True)

    # -- constructors ---------------------------------------------------------

    @staticmethod
    def from_pandas(df: pd.DataFrame, dt_col: str,
                    target_col: Union[str, Sequence[str]],
                    id_col: Optional[str] = None,
                    extra_feature_col: Optional[Sequence[str]] = None,
                    with_split: bool = False, val_ratio: float = 0.0,
                    test_ratio: float = 0.1):
        """Reference API; with_split returns (train, val, test) datasets."""
        ds = TSDataset(df, dt_col, target_col, id_col, extra_feature_col)
        if not with_split:
            return ds
        n = len(ds.df)
        n_test = int(n * test_ratio)
        n_val = int(n * val_ratio)
        n_train = n - n_val - n_test
        parts = (ds.df.iloc[:n_train], ds.df.iloc[n_train:n_train + n_val],
                 ds.df.iloc[n_train + n_val:])
        return tuple(
            TSDataset(p, dt_col, target_col, id_col, extra_feature_col)
            for p in parts)

    # -- cleaning -------------------------------------------------------------

    def impute(self, mode: str = "last") -> "TSDataset":
        cols = self.target_col + self.feature_col
        if mode == "last":
            self.df[cols] = self.df[cols].ffill().bfill()
        elif mode == "const":
            self.df[cols] = self.df[cols].fillna(0)
        elif mode == "linear":
            self.df[cols] = self.df[cols].interpolate(
                method="linear", limit_direction="both")
        else:
            raise ValueError(f"unknown impute mode {mode!r}")
        return self

    def deduplicate(self) -> "TSDataset":
        self.df.drop_duplicates(subset=[self.dt_col], keep="last",
                                inplace=True)
        self.df.reset_index(drop=True, inplace=True)
        return self

    def resample(self, interval: str, merge_mode: str = "mean") -> "TSDataset":
        num = self.target_col + self.feature_col
        g = self.df.set_index(self.dt_col)[num].resample(interval)
        agg = getattr(g, merge_mode)()
        keep = self.df.drop(columns=num).set_index(self.dt_col).resample(
            interval).first()
        self.df = pd.concat([agg, keep], axis=1).reset_index()
        return self

    # -- features -------------------------------------------------------------

    def gen_dt_feature(self, features: Optional[Sequence[str]] = None
                       ) -> "TSDataset":
        feats = [f.upper() for f in (features or
                                     ["HOUR", "DAYOFWEEK", "MONTH",
                                      "IS_WEEKEND"])]
        dt = self.df[self.dt_col].dt
        gens = {
            "HOUR": dt.hour, "DAY": dt.day, "DAYOFWEEK": dt.dayofweek,
            "MONTH": dt.month, "DAYOFYEAR": dt.dayofyear,
            "WEEKOFYEAR": dt.isocalendar().week.astype(np.int64),
            "MINUTE": dt.minute,
            "IS_WEEKEND": (dt.dayofweek >= 5).astype(np.int64),
        }
        for f in feats:
            if f not in gens:
                raise ValueError(f"unknown dt feature {f!r}; "
                                 f"known: {_DT_FEATURES}")
            self.df[f] = np.asarray(gens[f])
            if f not in self.feature_col:
                self.feature_col.append(f)
        return self

    # -- scaling --------------------------------------------------------------

    def scale(self, scaler: Any = "standard", fit: bool = True) -> "TSDataset":
        """scaler: "standard"/"minmax" or a fitted dict from another split."""
        cols = self.target_col + self.feature_col
        if isinstance(scaler, str):
            if fit:
                if scaler == "standard":
                    mean = self.df[cols].mean()
                    std = self.df[cols].std().replace(0, 1.0)
                    self.scaler = {"type": "standard", "mean": mean,
                                   "std": std}
                elif scaler == "minmax":
                    mn, mx = self.df[cols].min(), self.df[cols].max()
                    rng = (mx - mn).replace(0, 1.0)
                    self.scaler = {"type": "minmax", "min": mn, "range": rng}
                else:
                    raise ValueError(f"unknown scaler {scaler!r}")
            elif self.scaler is None:
                raise ValueError("fit=False requires a previously fit scaler")
        else:
            self.scaler = scaler
        s = self.scaler
        self._scaler_cols = cols
        if s["type"] == "standard":
            self.df[cols] = (self.df[cols] - s["mean"]) / s["std"]
        else:
            self.df[cols] = (self.df[cols] - s["min"]) / s["range"]
        return self

    def unscale_numpy(self, arr: np.ndarray) -> np.ndarray:
        """Invert the target-col part of the scaler on a rolled y array
        [N, horizon, n_targets]."""
        if self.scaler is None:
            return arr
        s = self.scaler
        n_t = len(self.target_col)
        if s["type"] == "standard":
            mean = s["mean"][self.target_col].to_numpy()[:n_t]
            std = s["std"][self.target_col].to_numpy()[:n_t]
            return arr * std + mean
        mn = s["min"][self.target_col].to_numpy()[:n_t]
        rng = s["range"][self.target_col].to_numpy()[:n_t]
        return arr * rng + mn

    # -- windowing ------------------------------------------------------------

    def roll(self, lookback: int, horizon: Union[int, Sequence[int]],
             feature_col: Optional[Sequence[str]] = None,
             target_col: Optional[Sequence[str]] = None) -> "TSDataset":
        """Sliding windows → self._x [N, lookback, F], self._y
        [N, horizon, T] (reference returns via to_numpy())."""
        targets = list(target_col or self.target_col)
        feats = list(feature_col if feature_col is not None
                     else self.feature_col)
        cols = targets + [f for f in feats if f not in targets]
        # int horizon = all steps 1..h (reference semantics); a list selects
        # specific future offsets
        horizons = (list(range(1, horizon + 1)) if isinstance(horizon, int)
                    else list(horizon))
        h_max = max(horizons)
        hsel = np.asarray(horizons) - 1

        def roll_one(frame: pd.DataFrame):
            values = frame[cols].to_numpy(np.float32)
            tgt = frame[targets].to_numpy(np.float32)
            n = len(values) - lookback - h_max + 1
            if n <= 0:
                return None
            idx = np.arange(lookback)[None, :] + np.arange(n)[:, None]
            yidx = np.arange(n)[:, None] + lookback + hsel[None, :]
            return values[idx], tgt[yidx]

        if self.id_col is not None:
            # multi-series: windows must NEVER span two ids (reference
            # grouped by id before rolling)
            parts = [roll_one(g.sort_values(self.dt_col))
                     for _, g in self.df.groupby(self.id_col, sort=False)]
            parts = [p for p in parts if p is not None]
            if not parts:
                raise ValueError("every id-series is too short for "
                                 f"lookback {lookback} + horizon {h_max}")
            self._x = np.concatenate([p[0] for p in parts])
            self._y = np.concatenate([p[1] for p in parts])
        else:
            out = roll_one(self.df)
            if out is None:
                raise ValueError(
                    f"series of {len(self.df)} rows too short for lookback "
                    f"{lookback} + horizon {h_max}")
            self._x, self._y = out
        return self

    def to_numpy(self) -> Tuple[np.ndarray, np.ndarray]:
        if not hasattr(self, "_x"):
            raise ValueError("call roll() first")
        return self._x, self._y

    def to_feed(self, batch_size: int = 32, shuffle: bool = True,
                **kw: Any):
        """Rolled windows → the port's DataFeed (reference:
        TSDataset.to_torch_data_loader — the train-loader bridge)."""
        from ..data import DataFeed
        x, y = self.to_numpy()
        return DataFeed.from_arrays(x, y, batch_size, shuffle=shuffle, **kw)

    def to_torch_data_loader(self, batch_size: int = 32,
                             shuffle: bool = True):
        """Rolled windows as a ``torch.utils.data.DataLoader`` (reference:
        TSDataset.to_torch_data_loader) — for porting torch training loops
        unchanged; native training uses :meth:`to_feed`."""
        import torch
        from torch.utils.data import DataLoader, TensorDataset
        x, y = self.to_numpy()
        ds = TensorDataset(torch.as_tensor(x), torch.as_tensor(y))
        return DataLoader(ds, batch_size=batch_size, shuffle=shuffle)

    def to_pandas(self) -> pd.DataFrame:
        return self.df.copy()
