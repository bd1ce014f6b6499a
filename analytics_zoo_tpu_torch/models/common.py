"""ZooModel: the model-zoo base class (port of
``analytics_zoo_tpu/models/common.py``, serving subset).

A ZooModel is an ``nn.Module`` that records its constructor arguments in
``_config`` and registers its class by name, so a saved config can rebuild
it.  Training through ``compile``/``fit`` and ``save_model``/``load_model``
arrive with the state plane (ROADMAP Queue 1 item 6); until then a model
trains through ``orca.learn.Estimator.from_keras``.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

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
