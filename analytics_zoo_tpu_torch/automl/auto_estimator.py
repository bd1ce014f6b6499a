"""AutoEstimator (port of ``analytics_zoo_tpu/automl/auto_estimator.py``):
a model-creator function and a search space -> trials -> the best config
refitted.

Same contract: ``model_creator(config) -> nn.Module`` (a port module, its
input widths given) and optional ``lr``/``learning_rate``/``batch_size``
entries inside the config; each trial trains through the port's Estimator
on ``device`` (``None``: the card) and reports the validation metric per
epoch (ASHA prunes).  Concurrent trials (``max_concurrent``) overlap only
outside the Estimator's device lock, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Any, Callable, Dict, Optional

from .. import DeviceLike
from .search import ASHAScheduler, RandomSearchEngine, SearchEngine, Trial

logger = logging.getLogger("analytics_zoo_tpu_torch")


class AutoEstimator:
    def __init__(self, model_creator: Callable[[Dict[str, Any]], Any],
                 loss: Any = "mse", optimizer: Any = "adam",
                 metric: str = "loss", metric_mode: str = "min",
                 search_engine: Optional[SearchEngine] = None,
                 device: DeviceLike = None):
        self.model_creator = model_creator
        self.loss = loss
        self.optimizer = optimizer
        self.metric = metric
        self.metric_mode = metric_mode
        self.engine = search_engine
        self.device = device
        self._best_trial: Optional[Trial] = None
        self._best_estimator = None

    # reference parity constructors ------------------------------------------
    @staticmethod
    def from_keras(model_creator, loss="mse", optimizer="adam",
                   metric="loss", metric_mode="min",
                   device: DeviceLike = None) -> "AutoEstimator":
        return AutoEstimator(model_creator, loss=loss, optimizer=optimizer,
                             metric=metric, metric_mode=metric_mode,
                             device=device)

    from_torch = from_keras  # the reference had both; one estimator here

    def _estimator(self, model: Any, lr: Any):
        from ..orca.learn import Estimator
        return Estimator.from_keras(
            model, loss=self.loss, optimizer=self.optimizer,
            learning_rate=lr,
            metrics=[self.metric] if self.metric != "loss" else None,
            device=self.device)

    def fit(self, data: Any, validation_data: Any = None, epochs: int = 1,
            batch_size: Any = 32, n_sampling: int = 4,
            search_space: Optional[Dict[str, Any]] = None,
            scheduler: Optional[ASHAScheduler] = None,
            max_concurrent: Optional[int] = None,
            seed: int = 0) -> "AutoEstimator":
        """Search; then keep the best trained estimator.

        ``scheduler``: an ASHAScheduler, or the string "asha" for default
        ASHA settings (reference: tune scheduler names).

        ``max_concurrent``: trials running at once, in a thread pool; their
        Estimator calls take the device lock in turn, so they overlap only
        in what a trial does outside them."""
        search_space = dict(search_space or {})
        val = validation_data if validation_data is not None else data
        if scheduler == "asha":
            scheduler = ASHAScheduler(metric_mode=self.metric_mode)
        engine = self.engine or RandomSearchEngine(
            metric_mode=self.metric_mode, scheduler=scheduler,
            max_concurrent=max_concurrent or 1, seed=seed)
        # fit()'s arguments must take effect on a pre-existing engine too
        # (custom search_engine, or a second fit() on the cached engine);
        # None = unspecified, an explicit 1 restores serial execution
        if max_concurrent is not None:
            engine.max_concurrent = max_concurrent
        if scheduler is not None:
            engine.scheduler = scheduler
        self.engine = engine

        def trial_fn(config: Dict[str, Any], report) -> float:
            lr = config.pop("lr", config.pop("learning_rate", None))
            bs = config.pop("batch_size", None) or (
                batch_size if isinstance(batch_size, int) else 32)
            est = self._estimator(self.model_creator(dict(config)), lr)
            best = None
            for epoch in range(epochs):
                est.fit(data, epochs=1, batch_size=int(bs), verbose=False)
                m = est.evaluate(val, batch_size=int(bs))[self.metric]
                better = best is None or (
                    m < best if self.metric_mode == "min" else m > best)
                if better:
                    best = m
                report(m, epoch + 1)
            return best

        if not isinstance(batch_size, int):  # a Sampler: search over it
            search_space.setdefault("batch_size", batch_size)
        best = engine.run(trial_fn, search_space, n_trials=n_sampling)
        self._best_trial = best
        # refit the winner to get its estimator (trials may be pruned)
        model = self.model_creator({k: v for k, v in best.config.items()
                                    if k not in ("lr", "learning_rate",
                                                 "batch_size")})
        lr = best.config.get("lr", best.config.get("learning_rate"))
        bs = int(best.config.get("batch_size") or (
            batch_size if isinstance(batch_size, int) else 32))
        est = self._estimator(model, lr)
        est.fit(data, epochs=epochs, batch_size=bs, verbose=False)
        self._best_estimator = est
        self._best_model = model
        return self

    def get_best_model(self):
        if self._best_estimator is None:
            raise ValueError("call fit() first")
        return self._best_model

    def get_best_estimator(self):
        if self._best_estimator is None:
            raise ValueError("call fit() first")
        return self._best_estimator

    def get_best_config(self) -> Dict[str, Any]:
        if self._best_trial is None:
            raise ValueError("call fit() first")
        return dict(self._best_trial.config)

    @property
    def trials(self):
        return self.engine.trials if self.engine else []
