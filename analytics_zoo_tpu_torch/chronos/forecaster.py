"""Forecasters (port of ``analytics_zoo_tpu/chronos/forecaster.py``): one
class per model with a uniform fit/predict/evaluate/save/load.

The LSTM, Seq2Seq (GRU or LSTM encoder-decoder) and TCN (dilated causal
convolutions) trunks are ``nn.Module``s built from ``input_feature_num``,
with the JAX tree's child names, and train through the port's Estimator
on ``device`` (``None``: the card), where every train step of a batch
shape is one CUDA graph replay.  A forecaster draws its trunk's initial
weights from a ``torch.Generator`` seeded with ``seed``, so one seed gives
one model on any device.  ``save``/``load`` are the Estimator's, in the
JAX package's checkpoint format: a forecaster saved by either package
loads in the other.  ARIMA and Prophet are the JAX package's numpy
backends, copied, with statsmodels and prophet behind the same lazy
imports.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import DeviceLike
from ..nn.layers import Conv1D, Dense, Dropout
from ..models.common import init_weights
from ..nn.recurrent import GRU, LSTM
from ..orca.learn import Estimator


def seeded(model: nn.Module, seed: int) -> nn.Module:
    """``model`` with every parameter drawn from a generator seeded with
    ``seed``."""
    return init_weights(model, torch.Generator().manual_seed(int(seed)))


# -- model trunks -------------------------------------------------------------

class _VanillaLSTM(nn.Module):
    def __init__(self, input_feature_num: int, hidden_dim: int = 32,
                 layer_num: int = 1, dropout: float = 0.1,
                 output_dim: int = 1, horizon: int = 1):
        super().__init__()
        self.hidden_dim, self.layer_num = hidden_dim, layer_num
        self.output_dim, self.horizon = output_dim, horizon
        width = input_feature_num
        for i in range(layer_num):
            self.add_module(f"lstm_{i}", LSTM(
                width, hidden_dim, return_sequences=i < layer_num - 1))
            self.add_module(f"drop_{i}", Dropout(dropout))
            width = hidden_dim
        self.head = Dense(hidden_dim, horizon * output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.layer_num):
            h = getattr(self, f"drop_{i}")(getattr(self, f"lstm_{i}")(h))
        return self.head(h).reshape(x.shape[0], self.horizon,
                                    self.output_dim)


class _Seq2SeqTS(nn.Module):
    def __init__(self, input_feature_num: int, lstm_hidden_dim: int = 32,
                 lstm_layer_num: int = 1, dropout: float = 0.1,
                 output_dim: int = 1, horizon: int = 1,
                 rnn_type: str = "lstm", teacher: bool = False):
        super().__init__()
        self.hidden = lstm_hidden_dim
        self.layers = lstm_layer_num
        self.output_dim, self.horizon = output_dim, horizon
        self.rnn_type = rnn_type
        cls = LSTM if rnn_type == "lstm" else GRU
        for part, width in (("enc", input_feature_num),
                            ("dec", lstm_hidden_dim)):
            for i in range(lstm_layer_num):
                self.add_module(f"{part}_{i}", cls(
                    width, lstm_hidden_dim, return_sequences=True))
                width = lstm_hidden_dim
        self.drop = Dropout(dropout)
        self.head = Dense(lstm_hidden_dim, output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self.layers):
            h = getattr(self, f"enc_{i}")(h)
        # the decoder: the encoder's summary repeated for each horizon step
        d = h[:, -1:].expand(-1, self.horizon, -1)
        for i in range(self.layers):
            d = getattr(self, f"dec_{i}")(d)
        return self.head(self.drop(d))


class _TCN(nn.Module):
    """Dilated temporal convolution network (Bai et al.): blocks of two
    causal convolutions (left padding of (k - 1) x dilation), dilation
    2^i in block i, a ``Dense`` projection of the block's input where the
    widths differ, and a residual ReLU; the head reads the last step."""

    def __init__(self, input_feature_num: int,
                 num_channels: Sequence[int] = (32, 32),
                 kernel_size: int = 3, dropout: float = 0.1,
                 output_dim: int = 1, horizon: int = 1):
        super().__init__()
        self.num_channels = list(num_channels)
        self.kernel_size = kernel_size
        self.output_dim = output_dim
        self.horizon = horizon
        width = input_feature_num
        for i, ch in enumerate(self.num_channels):
            blk_in = width
            for j in range(2):
                self.add_module(f"tcn{i}_conv{j}", Conv1D(
                    width, ch, kernel_size, padding="valid",
                    dilation=2 ** i, activation="relu"))
                self.add_module(f"tcn{i}_drop{j}", Dropout(dropout))
                width = ch
            if blk_in != ch:
                self.add_module(f"tcn{i}_proj", Dense(blk_in, ch))
        self.head = Dense(width, horizon * output_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x                                            # [B, T, F]
        for i, ch in enumerate(self.num_channels):
            pad = (self.kernel_size - 1) * 2 ** i
            blk_in = h
            for j in range(2):
                h = getattr(self, f"tcn{i}_conv{j}")(
                    F.pad(h, (0, 0, pad, 0)))            # causal pad
                h = getattr(self, f"tcn{i}_drop{j}")(h)
            if f"tcn{i}_proj" in self._modules:
                blk_in = getattr(self, f"tcn{i}_proj")(blk_in)
            h = torch.relu(h + blk_in)
        out = self.head(h[:, -1])
        return out.reshape(x.shape[0], self.horizon, self.output_dim)


# -- forecaster base ----------------------------------------------------------

class _Forecaster:
    MODEL_CLS: Any = None

    def __init__(self, past_seq_len: int, future_seq_len: int,
                 input_feature_num: int, output_feature_num: int,
                 loss: str = "mse", optimizer: str = "adam",
                 lr: float = 1e-3, metrics: Sequence[str] = ("mse",),
                 seed: int = 0, device: DeviceLike = None,
                 **model_kwargs: Any):
        self.past_seq_len = past_seq_len
        self.future_seq_len = future_seq_len
        self.input_feature_num = input_feature_num
        self.output_feature_num = output_feature_num
        self.model_kwargs = model_kwargs
        self.model = seeded(self._build_model(), seed)
        self.est = Estimator.from_keras(
            self.model, loss=loss, optimizer=optimizer, learning_rate=lr,
            metrics=list(metrics), seed=seed, device=device)

    def _build_model(self) -> nn.Module:
        return self.MODEL_CLS(input_feature_num=self.input_feature_num,
                              output_dim=self.output_feature_num,
                              horizon=self.future_seq_len,
                              **self.model_kwargs)

    @classmethod
    def from_tsdataset(cls, tsdata, past_seq_len: int = 24,
                       future_seq_len: int = 1, **kwargs: Any):
        tsdata.roll(past_seq_len, future_seq_len)
        x, y = tsdata.to_numpy()
        fc = cls(past_seq_len=past_seq_len, future_seq_len=future_seq_len,
                 input_feature_num=x.shape[-1],
                 output_feature_num=y.shape[-1], **kwargs)
        fc._tsdata_xy = (x, y)
        return fc

    def fit(self, data: Any = None, epochs: int = 1, batch_size: int = 32,
            validation_data: Any = None) -> Dict[str, Any]:
        if data is None:
            data = getattr(self, "_tsdata_xy", None)
            if data is None:
                raise ValueError("pass data or use from_tsdataset")
        return self.est.fit(data, epochs=epochs, batch_size=batch_size,
                            validation_data=validation_data, verbose=False)

    def predict(self, x: np.ndarray, batch_size: int = 32) -> np.ndarray:
        return self.est.predict(np.asarray(x, np.float32),
                                batch_size=batch_size)

    def evaluate(self, data: Tuple[np.ndarray, np.ndarray],
                 batch_size: int = 32) -> Dict[str, float]:
        return self.est.evaluate(data, batch_size=batch_size)

    def save(self, path: str) -> str:
        return self.est.save(path)

    def load(self, path: str) -> None:
        self.est.load(path)

    restore = load  # older reference name


class LSTMForecaster(_Forecaster):
    MODEL_CLS = _VanillaLSTM


class Seq2SeqForecaster(_Forecaster):
    MODEL_CLS = _Seq2SeqTS


class TCNForecaster(_Forecaster):
    MODEL_CLS = _TCN


# -- classical (statsmodels preferred, pure-numpy fallback) -------------------

class _NumpyARIMA:
    """Pure-numpy ARIMA(p, d, q) with optional seasonal differencing —
    Hannan–Rissanen two-stage estimation (long-AR residuals, then OLS on
    lagged values + lagged residuals), recursive forecasting with
    differencing inversion.  Exists so ARIMAForecaster EXECUTES in images
    without statsmodels (reference: chronos/model/arima.py wrapped
    pmdarima, an optional dep there too).  Seasonal AR/MA terms (P, Q > 0)
    need a full likelihood optimizer and stay statsmodels-only."""

    def __init__(self, order: Tuple[int, int, int],
                 seasonal_order: Tuple[int, int, int, int] = (0, 0, 0, 0)):
        self.p, self.d, self.q = order
        P, self.D, Q, self.s = seasonal_order
        if P or Q:
            raise NotImplementedError(
                "seasonal AR/MA (P, Q > 0) requires statsmodels; the "
                "numpy backend supports seasonal differencing (D) only")
        if self.d > 2 or self.D > 1:
            raise NotImplementedError("numpy ARIMA supports d<=2, D<=1")

    def fit(self, y: np.ndarray) -> "_NumpyARIMA":
        y = np.asarray(y, np.float64).ravel()
        # differencing pipeline: seasonal first, then regular; tails of
        # every level are kept for inversion at forecast time
        self._season_tail = None
        w = y
        if self.D and self.s:
            self._season_tail = w[-self.s:].copy()
            w = w[self.s:] - w[:-self.s]
        self._level_tails = []
        for _ in range(self.d):
            self._level_tails.append(w[-1])
            w = np.diff(w)
        p, q = self.p, self.q
        need = max(p, q) + p + q + 8
        if len(w) < need:
            raise ValueError(
                f"series too short for ARIMA{(p, self.d, q)}: {len(w)} "
                f"points after differencing, need >= {need}")
        if q:
            # stage 1: long-AR residuals
            p_long = min(max(p + q + 3, 10), len(w) // 3)
            e = np.zeros_like(w)
            X = np.column_stack(
                [np.ones(len(w) - p_long)]
                + [w[p_long - i:len(w) - i] for i in range(1, p_long + 1)])
            beta, *_ = np.linalg.lstsq(X, w[p_long:], rcond=None)
            e[p_long:] = w[p_long:] - X @ beta
        else:
            e = np.zeros_like(w)
        # stage 2: OLS on [1, w lags, e lags]
        m = max(p, q)
        cols = [np.ones(len(w) - m)]
        cols += [w[m - i:len(w) - i] for i in range(1, p + 1)]
        cols += [e[m - j:len(w) - j] for j in range(1, q + 1)]
        X2 = np.column_stack(cols)
        beta, *_ = np.linalg.lstsq(X2, w[m:], rcond=None)
        self.const = beta[0]
        self.phi = beta[1:1 + p]
        self.theta = beta[1 + p:1 + p + q]
        resid = np.zeros_like(w)
        resid[m:] = w[m:] - X2 @ beta
        self._w_tail = w[len(w) - max(p, 1):].copy()
        self._e_tail = resid[len(resid) - max(q, 1):].copy()
        return self

    def forecast(self, horizon: int) -> np.ndarray:
        p, q = self.p, self.q
        w_hist = list(self._w_tail)
        e_hist = list(self._e_tail)
        out = []
        for _ in range(horizon):
            v = self.const
            for i in range(1, p + 1):
                v += self.phi[i - 1] * w_hist[-i]
            for j in range(1, q + 1):
                v += self.theta[j - 1] * e_hist[-j]
            out.append(v)
            w_hist.append(v)
            e_hist.append(0.0)  # future shocks: expectation zero
        f = np.asarray(out)
        # invert regular differencing (innermost level first)
        for last in reversed(self._level_tails):
            f = last + np.cumsum(f)
        # invert seasonal differencing
        if self._season_tail is not None:
            s = self.s
            vals = list(self._season_tail)
            inv = []
            for k, fv in enumerate(f):
                inv.append(vals[k] + fv)
                vals.append(inv[-1])
            f = np.asarray(inv)
        return f


class ARIMAForecaster:
    """ARIMA via statsmodels when importable, else the pure-numpy
    Hannan–Rissanen backend (reference: chronos/model/arima.py — pmdarima,
    likewise an optional dep there)."""

    def __init__(self, order: Tuple[int, int, int] = (1, 0, 0),
                 seasonal_order: Tuple[int, int, int, int] = (0, 0, 0, 0),
                 backend: str = "auto"):
        """``backend``: "auto" (statsmodels if importable), "statsmodels",
        or "numpy"."""
        if backend not in ("auto", "statsmodels", "numpy"):
            raise ValueError(
                f"backend must be 'auto', 'statsmodels' or 'numpy', got "
                f"{backend!r}")
        if backend == "auto":
            try:
                from statsmodels.tsa.arima.model import ARIMA  # noqa: F401
                backend = "statsmodels"
            except ImportError:
                backend = "numpy"
        if backend == "statsmodels":
            from statsmodels.tsa.arima.model import ARIMA  # noqa: F401
        self.backend = backend
        self.order = order
        self.seasonal_order = seasonal_order
        self._fitted = None

    def fit(self, data: np.ndarray) -> "ARIMAForecaster":
        if self.backend == "statsmodels":
            from statsmodels.tsa.arima.model import ARIMA
            self._fitted = ARIMA(np.asarray(data, np.float64),
                                 order=self.order,
                                 seasonal_order=self.seasonal_order).fit()
        else:
            self._fitted = _NumpyARIMA(self.order,
                                       self.seasonal_order).fit(data)
        return self

    def predict(self, horizon: int = 1) -> np.ndarray:
        if self._fitted is None:
            raise ValueError("fit first")
        return np.asarray(self._fitted.forecast(horizon))

    def evaluate(self, y_true: np.ndarray, horizon: Optional[int] = None
                 ) -> Dict[str, float]:
        pred = self.predict(horizon or len(y_true))
        err = pred - np.asarray(y_true)
        return {"mse": float(np.mean(err ** 2)),
                "mae": float(np.mean(np.abs(err)))}


class _NumpyProphet:
    """Prophet-style decomposable model via ridge regression: piecewise-
    linear trend (changepoint basis, L2 on slope changes) + Fourier
    seasonalities — Prophet's own model family (Taylor & Letham 2017),
    fitted as a linear system instead of Stan MAP.  Exists so
    ProphetForecaster EXECUTES in images without the prophet package."""

    def __init__(self, n_changepoints: int = 25,
                 changepoint_range: float = 0.8,
                 yearly_order: int = 10, weekly_order: int = 3,
                 daily_order: int = 4, reg: float = 10.0,
                 force_seasons: Sequence[str] = ()):
        self.n_changepoints = n_changepoints
        self.changepoint_range = changepoint_range
        self.orders = {"yearly": (365.25, yearly_order),
                       "weekly": (7.0, weekly_order),
                       "daily": (1.0, daily_order)}
        # explicitly requested components are fitted regardless of span
        # (Prophet semantics: an explicit True overrides the auto gate)
        self.force_seasons = set(force_seasons)
        self.reg = reg

    def _design(self, t_days: np.ndarray) -> np.ndarray:
        cols = [np.ones_like(t_days), t_days]
        for cp in self._cps:
            cols.append(np.maximum(t_days - cp, 0.0))  # slope change
        for period, order in self._active:
            for k in range(1, order + 1):
                ang = 2 * np.pi * k * t_days / period
                cols.append(np.sin(ang))
                cols.append(np.cos(ang))
        return np.column_stack(cols)

    def fit(self, ds: np.ndarray, y: np.ndarray) -> "_NumpyProphet":
        import pandas as pd
        ds = pd.to_datetime(pd.Series(ds))
        order = np.argsort(ds.to_numpy())  # prophet sorts history too
        ds = ds.iloc[order].reset_index(drop=True)
        y = np.asarray(y, np.float64)[order]
        self._t0 = ds.iloc[0]
        t = (ds - self._t0).dt.total_seconds().to_numpy() / 86400.0
        span = t[-1] - t[0]
        # Prophet-style auto seasonality: enable a component if the
        # history covers >= 2 of its periods OR it was explicitly forced
        self._active = [po for name, po in self.orders.items()
                        if po[1] > 0
                        and (span >= 2 * po[0]
                             or name in self.force_seasons)]
        hi = t[0] + self.changepoint_range * span
        self._cps = np.linspace(t[0], hi, self.n_changepoints + 2)[1:-1]
        X = self._design(t)
        self._y_mean, self._y_scale = y.mean(), max(y.std(), 1e-9)
        ys = (y - self._y_mean) / self._y_scale
        # ridge: no penalty on intercept/base slope, L2 on changepoint
        # deltas (Prophet's Laplace prior, L2 here) and seasonal coefs
        pen = np.zeros(X.shape[1])
        pen[2:2 + len(self._cps)] = self.reg
        pen[2 + len(self._cps):] = 1.0
        A = X.T @ X + np.diag(pen)
        self._beta = np.linalg.solve(A, X.T @ ys)
        return self

    def predict(self, ds_future: np.ndarray) -> np.ndarray:
        import pandas as pd
        ds = pd.to_datetime(pd.Series(ds_future))
        t = (ds - self._t0).dt.total_seconds().to_numpy() / 86400.0
        yhat = self._design(t) @ self._beta
        return yhat * self._y_scale + self._y_mean


def _prophet_kwargs_to_numpy(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    """Translate standard Prophet constructor kwargs for _NumpyProphet;
    unknown/unsupported kwargs raise a clear error instead of a TypeError
    deep inside fit."""
    season_default = {"yearly": 10, "weekly": 3, "daily": 4}
    out: Dict[str, Any] = {}
    for k, v in kwargs.items():
        if k in ("n_changepoints", "changepoint_range"):
            out[k] = v
        elif k in ("yearly_seasonality", "weekly_seasonality",
                   "daily_seasonality"):
            name = k.split("_")[0]
            if v == "auto":
                continue  # keep the span-based auto default
            order = (season_default[name] if v is True
                     else 0 if v is False else int(v))
            out[f"{name}_order"] = order
            if order > 0:  # explicit request overrides the span gate
                out.setdefault("force_seasons", [])
                out["force_seasons"].append(name)
        else:
            raise ValueError(
                f"prophet kwarg {k!r} is not supported by the numpy "
                "fallback backend (supported: n_changepoints, "
                "changepoint_range, yearly/weekly/daily_seasonality); "
                "install prophet for the full parameter surface")
    return out


class ProphetForecaster:
    """Prophet when importable, else a pure-numpy decomposable-model
    backend (piecewise-linear trend + Fourier seasonality, ridge-fitted) —
    it always executes (reference: chronos/model/prophet.py wrapped the
    optional prophet package)."""

    def __init__(self, backend: str = "auto", **prophet_kwargs: Any):
        if backend not in ("auto", "prophet", "numpy"):
            raise ValueError(
                f"backend must be 'auto', 'prophet' or 'numpy', got "
                f"{backend!r}")
        if backend == "auto":
            try:
                from prophet import Prophet  # noqa: F401
                backend = "prophet"
            except ImportError:
                backend = "numpy"
        if backend == "prophet":
            try:
                from prophet import Prophet  # noqa: F401
            except ImportError as e:
                raise ImportError(
                    "backend='prophet' requires the optional 'prophet' "
                    "package (use backend='auto'/'numpy' for the built-in "
                    "fallback)") from e
        self.backend = backend
        self.kwargs = prophet_kwargs
        if backend == "numpy":
            # fail at construction, not deep inside fit
            _prophet_kwargs_to_numpy(prophet_kwargs)
        self._m = None
        self._last_ds = None

    def fit(self, df) -> "ProphetForecaster":
        """``df``: Prophet-convention DataFrame with ``ds`` and ``y``."""
        import pandas as pd
        if self.backend == "prophet":
            from prophet import Prophet
            self._m = Prophet(**self.kwargs)
            self._m.fit(df)
        else:
            kw = _prophet_kwargs_to_numpy(self.kwargs)
            self._m = _NumpyProphet(**kw).fit(
                df["ds"].to_numpy(), df["y"].to_numpy())
        self._last_ds = pd.to_datetime(df["ds"]).max()
        return self

    def predict(self, horizon: int = 1, freq: str = "D"):
        import pandas as pd
        if self._m is None:
            raise ValueError("fit first")
        if self.backend == "prophet":
            future = self._m.make_future_dataframe(periods=horizon,
                                                   freq=freq)
            return self._m.predict(future).tail(horizon)
        future_ds = pd.date_range(self._last_ds, periods=horizon + 1,
                                  freq=freq)[1:]
        yhat = self._m.predict(future_ds.to_numpy())
        return pd.DataFrame({"ds": future_ds, "yhat": yhat})
