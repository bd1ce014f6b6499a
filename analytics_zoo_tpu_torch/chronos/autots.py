"""AutoTS (port of ``analytics_zoo_tpu/chronos/autots.py``):
AutoTSEstimator searching model type, hyperparameters and lookback; the
result wrapped as a TSPipeline with save/load.

The search runs on the port's automl package; the model space is {lstm,
seq2seq, tcn}; lookback may itself be a search dimension (re-rolling the
TSDataset per trial under one lock, as the JAX package does).  Every
trial's forecaster trains through the port's Estimator on ``device``
(``None``: the card), each from the CUDA graph it captures for its batch
shape; concurrent trials take the Estimator's device lock in turn.  A
TSPipeline's directory (``model/``, the Estimator's checkpoint, and
``config.json`` with the target scaler) is the JAX package's, so either
package loads the other's.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import numpy as np

from .. import DeviceLike
from ..automl import hp as hp_mod
from ..automl.search import ASHAScheduler, RandomSearchEngine
from .forecaster import (LSTMForecaster, Seq2SeqForecaster, TCNForecaster)

_MODELS = {"lstm": LSTMForecaster, "seq2seq": Seq2SeqForecaster,
           "tcn": TCNForecaster}


def _target_scaler(tsdata) -> Optional[Dict[str, Any]]:
    """Compact, json-able slice of a TSDataset scaler covering the target
    columns only (what predictions need for unscaling)."""
    s = getattr(tsdata, "scaler", None)
    if s is None:
        return None
    cols = tsdata.target_col
    if s["type"] == "standard":
        return {"type": "standard",
                "mean": [float(v) for v in s["mean"][cols]],
                "std": [float(v) for v in s["std"][cols]]}
    return {"type": "minmax",
            "min": [float(v) for v in s["min"][cols]],
            "range": [float(v) for v in s["range"][cols]]}


class TSPipeline:
    """Fitted forecaster + the fitted target scaler: predict/evaluate/save/
    load.  Predictions are returned in the ORIGINAL (unscaled) space when a
    scaler is present, matching the reference TSPipeline (SURVEY.md §2.6)."""

    def __init__(self, forecaster, config: Dict[str, Any],
                 scaler: Optional[Dict[str, Any]] = None):
        self.forecaster = forecaster
        self.config = config
        self.scaler = scaler

    def _unscale(self, arr: np.ndarray) -> np.ndarray:
        s = self.scaler
        if s is None:
            return arr
        if s["type"] == "standard":
            return arr * np.asarray(s["std"]) + np.asarray(s["mean"])
        return arr * np.asarray(s["range"]) + np.asarray(s["min"])

    def predict(self, x: np.ndarray, unscale: bool = True) -> np.ndarray:
        pred = self.forecaster.predict(x)
        return self._unscale(pred) if unscale else pred

    def evaluate(self, data) -> Dict[str, float]:
        """Metrics in the original space when a scaler is present (x and y
        are still expected in the scaled space the model was trained on)."""
        if self.scaler is None:
            return self.forecaster.evaluate(data)
        x, y = data.to_numpy() if hasattr(data, "to_numpy") else data
        pred = self.predict(x)
        truth = self._unscale(np.asarray(y))
        err = pred - truth
        return {"mse": float(np.mean(err ** 2)),
                "mae": float(np.mean(np.abs(err)))}

    def save(self, path: str) -> str:
        os.makedirs(path, exist_ok=True)
        self.forecaster.save(os.path.join(path, "model"))

        def jsonable(v) -> bool:
            if isinstance(v, (int, float, str, bool, type(None))):
                return True
            if isinstance(v, (list, tuple)):
                return all(jsonable(x) for x in v)
            if isinstance(v, dict):  # model_kwargs must survive the trip
                return all(isinstance(k, str) and jsonable(x)
                           for k, x in v.items())
            return False

        payload = {k: v for k, v in self.config.items() if jsonable(v)}
        if self.scaler is not None:
            payload["__scaler__"] = self.scaler
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump(payload, f)
        return path

    @staticmethod
    def load(path: str, device: DeviceLike = None) -> "TSPipeline":
        with open(os.path.join(path, "config.json")) as f:
            config = json.load(f)
        scaler = config.pop("__scaler__", None)
        model_cls = _MODELS[config["model"]]
        fc = model_cls(
            past_seq_len=config["past_seq_len"],
            future_seq_len=config["future_seq_len"],
            input_feature_num=config["input_feature_num"],
            output_feature_num=config["output_feature_num"],
            device=device, **config.get("model_kwargs", {}))
        # built, then the weights loaded
        fc.est.load(os.path.join(path, "model"))
        return TSPipeline(fc, config, scaler=scaler)


class AutoTSEstimator:
    def __init__(self, model: Any = "lstm",
                 search_space: Optional[Dict[str, Any]] = None,
                 past_seq_len: Any = 24, future_seq_len: int = 1,
                 metric: str = "mse", metric_mode: str = "min",
                 seed: int = 0, device: DeviceLike = None):
        """``model``: name, list of names, or hp.choice over names;
        ``device``: where every trial trains (``None``: the card)."""
        if isinstance(model, str):
            model = [model]
        self.model_space = (model if isinstance(model, hp_mod.Sampler)
                            else hp_mod.choice(list(model)))
        self.search_space = dict(search_space or {})
        self.past_seq_len = past_seq_len
        self.future_seq_len = future_seq_len
        self.metric = metric
        self.metric_mode = metric_mode
        self.seed = seed
        self.device = device
        self.best_config: Optional[Dict[str, Any]] = None

    def fit(self, data, validation_data=None, epochs: int = 2,
            batch_size: int = 32, n_sampling: int = 4,
            scheduler: Optional[ASHAScheduler] = None,
            max_concurrent: Optional[int] = None) -> TSPipeline:
        """``data``: a TSDataset (re-rolled per lookback candidate) or a
        rolled (x, y) tuple.  ``max_concurrent``: parallel trials (a thread
        pool; their Estimator calls take the device lock in turn)."""
        from .data import TSDataset
        is_tsdata = isinstance(data, TSDataset)
        space = dict(self.search_space)
        space["model"] = self.model_space
        if isinstance(self.past_seq_len, hp_mod.Sampler):
            space["past_seq_len"] = self.past_seq_len
        engine = RandomSearchEngine(metric_mode=self.metric_mode,
                                    scheduler=scheduler,
                                    max_concurrent=max_concurrent or 1,
                                    seed=self.seed)

        import threading
        roll_lock = threading.Lock()  # concurrent trials share `data`:
        # roll() mutates the dataset's window state, so window extraction
        # must be atomic per trial (the arrays it returns are fresh copies)

        def make(config: Dict[str, Any]):
            cfg = dict(config)
            name = cfg.pop("model")
            lookback = int(cfg.pop("past_seq_len", self.past_seq_len))
            lr = cfg.pop("lr", 1e-3)
            if is_tsdata:
                with roll_lock:
                    data.roll(lookback, self.future_seq_len)
                    x, y = data.to_numpy()
            else:
                x, y = data
                lookback = x.shape[1]
            fc = _MODELS[name](past_seq_len=lookback,
                               future_seq_len=self.future_seq_len,
                               input_feature_num=x.shape[-1],
                               output_feature_num=y.shape[-1], lr=lr,
                               metrics=[self.metric] if self.metric != "loss"
                               else ("mse",), device=self.device, **cfg)
            return fc, (x, y), dict(config)

        def trial_fn(config, report):
            fc, (x, y), _ = make(config)
            if validation_data is not None:
                if isinstance(validation_data, TSDataset):
                    # re-roll per trial: each candidate lookback needs its
                    # own validation windows (same lock as `data`)
                    with roll_lock:
                        validation_data.roll(fc.past_seq_len,
                                             self.future_seq_len)
                        vx, vy = validation_data.to_numpy()
                else:
                    vx, vy = validation_data
            else:
                n_val = max(1, len(x) // 5)
                vx, vy = x[-n_val:], y[-n_val:]
                x, y = x[:-n_val], y[:-n_val]
            best = None
            for epoch in range(epochs):
                fc.fit((x, y), epochs=1,
                       batch_size=min(batch_size, len(x)))
                m = fc.evaluate((vx, vy),
                                batch_size=min(batch_size, len(vx)))
                m = m.get(self.metric, m["loss"])
                if best is None or (m < best if self.metric_mode == "min"
                                    else m > best):
                    best = m
                report(m, epoch + 1)
            return best

        best = engine.run(trial_fn, space, n_trials=n_sampling)
        self.best_config = dict(best.config)
        self.trials = engine.trials
        # refit winner on the full data
        fc, (x, y), raw_cfg = make(dict(best.config))
        fc.fit((x, y), epochs=epochs, batch_size=min(batch_size, len(x)))
        cfg = dict(raw_cfg)
        cfg.update(model=best.config["model"],
                   past_seq_len=fc.past_seq_len,
                   future_seq_len=self.future_seq_len,
                   input_feature_num=fc.input_feature_num,
                   output_feature_num=fc.output_feature_num,
                   model_kwargs={k: v for k, v in raw_cfg.items()
                                 if k not in ("model", "past_seq_len", "lr",
                                              "batch_size")})
        return TSPipeline(fc, cfg,
                          scaler=_target_scaler(data) if is_tsdata else None)

    def get_best_config(self) -> Dict[str, Any]:
        if self.best_config is None:
            raise ValueError("call fit() first")
        return dict(self.best_config)


class _SingleModelAuto(AutoTSEstimator):
    """Per-model search (reference: AutoLSTM/AutoTCN/AutoSeq2Seq in
    pyzoo/zoo/chronos/autots/model/): an AutoTSEstimator with the model
    family fixed, searching only hyperparameters (and lookback if given as
    a space)."""

    MODEL_NAME: str = ""

    def __init__(self, **kwargs: Any):
        if "model" in kwargs:
            raise ValueError(
                f"{type(self).__name__} searches the "
                f"{self.MODEL_NAME!r} family only; use AutoTSEstimator "
                "to search across model types")
        super().__init__(model=[self.MODEL_NAME], **kwargs)


class AutoLSTM(_SingleModelAuto):
    MODEL_NAME = "lstm"


class AutoTCN(_SingleModelAuto):
    MODEL_NAME = "tcn"


class AutoSeq2Seq(_SingleModelAuto):
    MODEL_NAME = "seq2seq"
