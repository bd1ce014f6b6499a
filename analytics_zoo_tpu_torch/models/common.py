"""ZooModel: the model-zoo base class (port of
``analytics_zoo_tpu/models/common.py``).

A ZooModel is an ``nn.Module`` that records its constructor arguments in
``_config`` and registers its class by name, so a saved config can rebuild
it.  ``compile`` attaches the Estimator (``orca.learn``), so that
``fit``/``evaluate``/``predict``/``predict_classes`` run through it, as
in the JAX package; ``save_model``/``load_model`` arrive with the state
plane (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

_REGISTRY: Dict[str, type] = {}


class ZooModel(nn.Module):
    """Base: subclasses set ``self._config = {...}`` (constructor kwargs)."""

    _config: Dict[str, Any]

    def __init_subclass__(cls, **kw: Any):
        super().__init_subclass__(**kw)
        _REGISTRY[cls.__name__] = cls

    @staticmethod
    def from_config(class_name: str, config: Dict[str, Any]) -> "ZooModel":
        """Rebuild a registered model class from its ``_config``."""
        return _REGISTRY[class_name](**config)

    def init_weights(self, generator: Optional[torch.Generator] = None
                     ) -> "ZooModel":
        """Draw every parameter anew from ``generator`` with the layers'
        initializers (same distributions as the JAX package)."""
        for m in self.modules():
            reset = getattr(m, "reset_parameters", None)
            if reset is not None:
                reset(generator)
        return self

    # -- training plumbing ----------------------------------------------------

    def compile(self, loss: Any, optimizer: Any = "adam",
                learning_rate: Optional[float] = None,
                metrics: Optional[Sequence[Any]] = None,
                **kwargs: Any) -> "ZooModel":
        """Attach an Estimator over this model (``kwargs``: the
        Estimator's, ``device=`` among them)."""
        from ..orca.learn import Estimator
        self._estimator = Estimator.from_keras(
            self, loss=loss, optimizer=optimizer,
            learning_rate=learning_rate, metrics=metrics, **kwargs)
        return self

    def set_estimator(self, estimator: Any) -> "ZooModel":
        """Attach an externally built estimator instead of compile()'s."""
        self._estimator = estimator
        return self

    @property
    def estimator(self):
        if getattr(self, "_estimator", None) is None:
            raise ValueError(f"{type(self).__name__}: call compile() (or "
                             "set_estimator) before fit/evaluate/predict")
        return self._estimator

    def fit(self, data: Any, epochs: int = 1, batch_size: int = 32,
            **kwargs: Any) -> Dict[str, Any]:
        return self.estimator.fit(data, epochs=epochs, batch_size=batch_size,
                                  **kwargs)

    def evaluate(self, data: Any, batch_size: int = 32,
                 **kwargs: Any) -> Dict[str, float]:
        return self.estimator.evaluate(data, batch_size=batch_size, **kwargs)

    def predict(self, data: Any, batch_size: int = 32,
                **kwargs: Any) -> np.ndarray:
        return self.estimator.predict(data, batch_size=batch_size, **kwargs)

    def predict_classes(self, data: Any, batch_size: int = 32) -> np.ndarray:
        """Argmax over the output distribution (a single output: > 0)."""
        out = self.predict(data, batch_size=batch_size)
        if out.ndim > 1 and out.shape[-1] > 1:
            return np.argmax(out, axis=-1)
        return (out.reshape(len(out), -1)[:, 0] > 0).astype(np.int64)
