"""ZooModel: the model-zoo base class (port of
``analytics_zoo_tpu/models/common.py``).

A ZooModel is an ``nn.Module`` that records its constructor arguments in
``_config`` and registers its class by name, so a saved config can rebuild
it.  ``compile`` attaches the Estimator (``orca.learn``), so that
``fit``/``evaluate``/``predict``/``predict_classes`` run through it, as
in the JAX package.  ``save_model``/``load_model`` round-trip the weights
(``core/checkpoint.py``'s format, the JAX ``{"params", "state"}`` tree)
and the constructor config (``config.json``: class name and config) in
one directory, the JAX package's layout, so a directory saved by either
package loads in the other (a torch dtype in the config is written as its
name, ``"bfloat16"``, and listed under ``torch_dtypes``, a key the JAX
package does not read).  ``load_model`` puts the weights
into the rebuilt module and keeps the tree as ``_loaded_variables``; a
``compile`` after it trains from them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

_REGISTRY: Dict[str, type] = {}


def init_weights(model: nn.Module,
                 generator: Optional[torch.Generator] = None) -> nn.Module:
    """Draw every parameter of ``model`` anew from ``generator`` with its
    layers' initializers (``reset_parameters``)."""
    for m in model.modules():
        reset = getattr(m, "reset_parameters", None)
        if reset is not None:
            reset(generator)
    return model


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
        return init_weights(self, generator)

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

    # -- persistence ----------------------------------------------------------

    def save_model(self, path: str) -> str:
        """Weights (``weights/``, the JAX ``{"params", "state"}`` tree as
        this module holds it now) and ``config.json`` in one directory."""
        from ..convert import buffer_names, to_jax_variables
        from ..core import checkpoint as ckpt_io
        os.makedirs(path, exist_ok=True)
        ckpt_io.save(os.path.join(path, "weights"),
                     to_jax_variables(self.state_dict(), buffer_names(self)))
        dtypes = sorted(k for k, v in self._config.items()
                        if isinstance(v, torch.dtype))
        config = {k: str(v).replace("torch.", "") if k in dtypes else v
                  for k, v in self._config.items()}
        with open(os.path.join(path, "config.json"), "w") as f:
            json.dump({"class": type(self).__name__, "config": config,
                       "torch_dtypes": dtypes}, f)
        return path

    @staticmethod
    def load_model(path: str) -> "ZooModel":
        """Rebuild from a ``save_model`` directory of either package
        (class, config and weights); the weights are loaded and kept as
        ``_loaded_variables``."""
        from ..convert import from_jax_variables
        from ..core import checkpoint as ckpt_io
        with open(os.path.join(path, "config.json")) as f:
            meta = json.load(f)
        config = dict(meta["config"])
        for k in meta.get("torch_dtypes") or ():
            config[k] = getattr(torch, config[k])
        model = ZooModel.from_config(meta["class"], config)
        variables = ckpt_io.restore(os.path.join(path, "weights"))
        model.load_state_dict(from_jax_variables(variables), strict=True)
        model._loaded_variables = variables
        return model

