"""AnomalyDetector (port of ``analytics_zoo_tpu/models/anomalydetection.py``;
reference: zoo.models.anomalydetection, AnomalyDetector.scala + Unroll
helpers).

Stacked-LSTM next-value regressor over unrolled windows; anomalies are the
points whose prediction error ranks in the top ``anomaly_fraction``.
Module names follow the JAX tree (``lstm_{i}``, ``drop_{i}``, ``head``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..nn.layers import Dense, Dropout
from ..nn.recurrent import LSTM
from .common import ZooModel


def unroll(data: np.ndarray, unroll_length: int,
           predict_step: int = 1) -> Tuple[np.ndarray, np.ndarray]:
    """Sliding windows: series [N, F] -> (x [M, unroll, F], y [M])
    (reference: AnomalyDetector.unroll on an RDD; here vectorized numpy)."""
    data = np.asarray(data)
    if data.ndim == 1:
        data = data[:, None]
    n = len(data) - unroll_length - predict_step + 1
    if n <= 0:
        raise ValueError("series shorter than unroll_length + predict_step")
    idx = np.arange(unroll_length)[None, :] + np.arange(n)[:, None]
    x = data[idx]
    y = data[np.arange(n) + unroll_length + predict_step - 1, 0]
    return x.astype(np.float32), y.astype(np.float32)


class AnomalyDetector(ZooModel):
    def __init__(self, feature_shape: Sequence[int],
                 hidden_layers: Sequence[int] = (8, 32, 15),
                 dropouts: Sequence[float] = (0.2, 0.2, 0.2)):
        super().__init__()
        self._config = dict(feature_shape=list(feature_shape),
                            hidden_layers=list(hidden_layers),
                            dropouts=list(dropouts))
        self.feature_shape = tuple(feature_shape)
        self.hidden_layers = list(hidden_layers)
        self.dropouts = list(dropouts)
        width = self.feature_shape[-1]
        n = len(self.hidden_layers)
        for i, (units, rate) in enumerate(zip(self.hidden_layers,
                                              self.dropouts)):
            self.add_module(f"lstm_{i}", LSTM(
                width, units, return_sequences=i != n - 1))
            self.add_module(f"drop_{i}", Dropout(rate))
            width = units
        self.head = Dense(width, 1)
        self._depth = min(n, len(self.dropouts))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for i in range(self._depth):
            h = getattr(self, f"drop_{i}")(getattr(self, f"lstm_{i}")(h))
        return self.head(h)

    def detect_anomalies(self, y_true: np.ndarray, y_pred: np.ndarray,
                         anomaly_fraction: float = 0.05) -> np.ndarray:
        """Indices of the top-fraction absolute errors (reference:
        detectAnomalies RDD sort -> threshold)."""
        y_true = np.asarray(y_true).reshape(-1)
        y_pred = np.asarray(y_pred).reshape(-1)
        err = np.abs(y_true - y_pred)
        k = max(1, int(len(err) * anomaly_fraction))
        thresh = np.sort(err)[-k]
        return np.where(err >= thresh)[0]


__all__ = ["AnomalyDetector", "unroll"]
