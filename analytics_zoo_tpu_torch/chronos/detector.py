"""Anomaly detectors (port of ``analytics_zoo_tpu/chronos/detector.py``):
ThresholdDetector (numpy, a copy), AEDetector (a dense autoencoder through
the port's Estimator on ``device``, ``None``: the card) and DBScanDetector
(scikit-learn behind the same lazy import).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .. import DeviceLike
from ..nn.layers import Dense, Sequential
from ..orca.learn import Estimator
from .forecaster import seeded


class ThresholdDetector:
    """Flag |y - yhat| above a threshold; threshold fit from a normal-ratio
    quantile when not given (reference: threshold detection on residuals)."""

    def __init__(self, threshold: Optional[float] = None,
                 ratio: float = 0.01):
        self.threshold = threshold
        self.ratio = ratio

    def fit(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None
            ) -> "ThresholdDetector":
        err = np.abs(np.asarray(y) - (0 if y_pred is None
                                      else np.asarray(y_pred))).reshape(-1)
        if self.threshold is None:
            self.threshold = float(np.quantile(err, 1.0 - self.ratio))
        return self

    def score(self, y: np.ndarray, y_pred: Optional[np.ndarray] = None
              ) -> np.ndarray:
        return np.abs(np.asarray(y) - (0 if y_pred is None
                                       else np.asarray(y_pred))).reshape(-1)

    def anomaly_indexes(self, y: np.ndarray,
                        y_pred: Optional[np.ndarray] = None) -> np.ndarray:
        if self.threshold is None:
            self.fit(y, y_pred)
        return np.where(self.score(y, y_pred) > self.threshold)[0]


class AEDetector:
    """Autoencoder reconstruction-error detector (reference: AEDetector):
    ``Dense`` layers over windows of ``roll_len`` points, initialised from
    ``seed``."""

    def __init__(self, roll_len: int = 24, ratio: float = 0.05,
                 hidden: Sequence[int] = (16, 8), lr: float = 1e-3,
                 epochs: int = 10, batch_size: int = 32, seed: int = 0,
                 device: DeviceLike = None):
        self.roll_len = roll_len
        self.ratio = ratio
        self.hidden = list(hidden)
        self.lr = lr
        self.epochs = epochs
        self.batch_size = batch_size
        self.seed = seed
        self.device = device
        self._est = None
        self._threshold = None

    def _windows(self, y: np.ndarray) -> np.ndarray:
        y = np.asarray(y, np.float32).reshape(-1)
        if self.roll_len <= 1:
            return y[:, None]
        n = len(y) - self.roll_len + 1
        idx = np.arange(self.roll_len)[None, :] + np.arange(n)[:, None]
        return y[idx]

    def fit(self, y: np.ndarray) -> "AEDetector":
        x = self._windows(y)
        dims = self.hidden + [x.shape[-1]]
        ins = [x.shape[-1]] + dims[:-1]
        layers = [Dense(w, d, activation="relu" if i < len(dims) - 1
                        else None)
                  for i, (w, d) in enumerate(zip(ins, dims))]
        model = seeded(Sequential(layers), self.seed)
        self._est = Estimator.from_keras(model, loss="mse",
                                         learning_rate=self.lr,
                                         seed=self.seed, device=self.device)
        self._est.fit((x, x), epochs=self.epochs,
                      batch_size=min(self.batch_size, len(x)), verbose=False)
        self._threshold = float(np.quantile(self.score(y), 1 - self.ratio))
        return self

    def score(self, y: np.ndarray) -> np.ndarray:
        x = self._windows(y)
        recon = self._est.predict(x, batch_size=self.batch_size)
        err = np.mean(np.square(recon - x), axis=-1)
        # distribute window scores back to points (use the window end)
        pad = np.full(self.roll_len - 1, err[0])
        return np.concatenate([pad, err])

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        if self._est is None:
            self.fit(y)
        return np.where(self.score(y) > self._threshold)[0]


class DBScanDetector:
    """sklearn DBSCAN outlier detection (reference: DBScanDetector)."""

    def __init__(self, eps: float = 0.5, min_samples: int = 5):
        self.eps = eps
        self.min_samples = min_samples

    def anomaly_indexes(self, y: np.ndarray) -> np.ndarray:
        from sklearn.cluster import DBSCAN
        y = np.asarray(y, np.float64).reshape(-1, 1)
        labels = DBSCAN(eps=self.eps,
                        min_samples=self.min_samples).fit_predict(y)
        return np.where(labels == -1)[0]
