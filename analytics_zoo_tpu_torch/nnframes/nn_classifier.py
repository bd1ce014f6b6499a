"""NNEstimator / NNModel / NNClassifier over pandas frames (port of
``analytics_zoo_tpu/nnframes/nn_classifier.py``: the same classes over the
port's ``Estimator.from_keras``, which takes ``device=``).

Reference: ``pyzoo/zoo/pipeline/nnframes/nn_classifier.py``:
``NNEstimator(model, criterion, preprocessing).setBatchSize(...)
.setMaxEpoch(...).fit(df)`` -> ``NNModel`` with ``transform(df)``.

The reference's ``Preprocessing`` hierarchy (SeqToTensor, ArrayToTensor,
ImageFeatureToTensor, ...) existed to marshal JVM Row objects into BigDL
Tensors.  Here a row is already a numpy-friendly value, so "preprocessing"
is any ``fn(column_value) -> ndarray`` applied per-cell before stacking.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
from torch.nn import Module

from .. import DeviceLike


def _stack_cols(df, cols: Sequence[str],
                preprocessing: Optional[Callable]) -> np.ndarray:
    """DataFrame columns → one [n, ...] array.  Cells may be scalars or
    ndarrays/lists (image/sequence columns); multiple scalar columns are
    stacked feature-wise."""
    mats = []
    for c in cols:
        vals = df[c].tolist()
        if preprocessing is not None:
            vals = [preprocessing(v) for v in vals]
        arr = np.asarray(vals)
        mats.append(arr if arr.ndim > 1 else arr[:, None])
    if len(mats) == 1:
        return mats[0]
    return np.concatenate([m.reshape(len(m), -1) for m in mats], axis=1)


class NNEstimator:
    """fit(df) → NNModel (reference: NNEstimator.scala / nn_classifier.py).

    Fluent setters mirror the reference's Spark-ML params API; plain
    constructor kwargs work too.
    """

    def __init__(self, model: Module, criterion: Any = "mse",
                 feature_preprocessing: Optional[Callable] = None,
                 label_preprocessing: Optional[Callable] = None,
                 device: DeviceLike = None):
        """``device``: the Estimator's (None: the card)."""
        self.model = model
        self.device = device
        self.criterion = criterion
        self.feature_preprocessing = feature_preprocessing
        self.label_preprocessing = label_preprocessing
        self.feature_cols: List[str] = ["features"]
        self.label_cols: List[str] = ["label"]
        self.batch_size = 32
        self.max_epoch = 1
        self.learning_rate: Optional[float] = None
        self.optimizer = "adam"
        self.metrics: Optional[Sequence[Any]] = None
        self.sharding: Any = "dp"

    # -- reference-parity fluent setters --------------------------------------

    def setFeaturesCol(self, *cols: str) -> "NNEstimator":
        self.feature_cols = list(cols)
        return self

    def setLabelCol(self, *cols: str) -> "NNEstimator":
        self.label_cols = list(cols)
        return self

    def setBatchSize(self, n: int) -> "NNEstimator":
        self.batch_size = n
        return self

    def setMaxEpoch(self, n: int) -> "NNEstimator":
        self.max_epoch = n
        return self

    def setLearningRate(self, lr: float) -> "NNEstimator":
        self.learning_rate = lr
        return self

    def setOptimMethod(self, opt: Any) -> "NNEstimator":
        self.optimizer = opt
        return self

    # -- core -----------------------------------------------------------------

    def _collect_xy(self, df) -> Dict[str, np.ndarray]:
        from ..data import XShards
        if isinstance(df, XShards):
            import pandas as pd
            df = pd.concat(df.collect(), ignore_index=True)
        x = _stack_cols(df, self.feature_cols, self.feature_preprocessing)
        out = {"x": x.astype(np.float32) if x.dtype == np.float64 else x}
        if all(c in df.columns for c in self.label_cols):
            y = _stack_cols(df, self.label_cols, self.label_preprocessing)
            if y.shape[-1] == 1:
                y = y[:, 0]
            out["y"] = y.astype(np.float32) if y.dtype == np.float64 else y
        return out

    def fit(self, df) -> "NNModel":
        """Train from DataFrame (or XShards-of-DataFrames) columns."""
        from ..orca.learn import Estimator
        data = self._collect_xy(df)
        if "y" not in data:
            raise ValueError(
                f"label column(s) {self.label_cols} not found in frame")
        est = Estimator.from_keras(
            self.model, loss=self.criterion, optimizer=self.optimizer,
            learning_rate=self.learning_rate, metrics=self.metrics,
            sharding=self.sharding, device=self.device)
        est.fit((data["x"], self._prepare_label(data["y"])),
                epochs=self.max_epoch, batch_size=self.batch_size,
                verbose=False)
        return self._make_model(est)

    def _prepare_label(self, y: np.ndarray) -> np.ndarray:
        return y

    def _make_model(self, est) -> "NNModel":
        return NNModel(self.model, est, self.feature_cols,
                       self.feature_preprocessing, self.batch_size)


class NNModel:
    """transform(df) appends a ``prediction`` column (reference: NNModel
    extends Spark ML Model[NNModel])."""

    prediction_col = "prediction"

    def __init__(self, model: Module, estimator, feature_cols: Sequence[str],
                 feature_preprocessing: Optional[Callable],
                 batch_size: int = 32):
        self.model = model
        self.estimator = estimator
        self.feature_cols = list(feature_cols)
        self.feature_preprocessing = feature_preprocessing
        self.batch_size = batch_size

    def setPredictionCol(self, col: str) -> "NNModel":
        self.prediction_col = col
        return self

    def setBatchSize(self, n: int) -> "NNModel":
        self.batch_size = n
        return self

    def _predict_array(self, df) -> np.ndarray:
        x = _stack_cols(df, self.feature_cols, self.feature_preprocessing)
        if x.dtype == np.float64:
            x = x.astype(np.float32)
        return self.estimator.predict(x, batch_size=self.batch_size)

    def transform(self, df):
        """DataFrame (or XShards of DataFrames) → same frame + prediction
        column.  XShards transform stays per-shard (order-preserving)."""
        from ..data import XShards
        if isinstance(df, XShards):
            return df.transform_shard(self._transform_one)
        return self._transform_one(df)

    def _transform_one(self, df):
        out = df.copy()
        pred = self._predict_array(df)
        out[self.prediction_col] = self._format_predictions(pred)
        return out

    def _format_predictions(self, pred: np.ndarray) -> List[Any]:
        return list(pred)

    def save(self, path: str) -> str:
        return self.estimator.save(path)

    def load_weights(self, path: str) -> "NNModel":
        self.estimator.load(path)
        return self


class NNClassifier(NNEstimator):
    """Classification specialization (reference: NNClassifier — label is a
    class index, transform emits the argmax class)."""

    def __init__(self, model: Module,
                 criterion: Any = "sparse_categorical_crossentropy",
                 feature_preprocessing: Optional[Callable] = None,
                 device: DeviceLike = None):
        super().__init__(model, criterion, feature_preprocessing,
                         device=device)

    def _prepare_label(self, y: np.ndarray) -> np.ndarray:
        return y.astype(np.int32)

    def _make_model(self, est) -> "NNClassifierModel":
        return NNClassifierModel(self.model, est, self.feature_cols,
                                 self.feature_preprocessing, self.batch_size)


class NNClassifierModel(NNModel):
    def _format_predictions(self, pred: np.ndarray) -> List[Any]:
        if pred.ndim > 1 and pred.shape[-1] > 1:
            return list(np.argmax(pred, axis=-1).astype(np.int64))
        return list((pred.reshape(len(pred), -1)[:, 0] > 0).astype(np.int64))
