"""Activation registry: the subset of ``analytics_zoo_tpu.nn.activations``
this port uses.

``"gelu"`` is the tanh approximation, because the JAX package's ``"gelu"``
is ``jax.nn.gelu``, whose default is ``approximate=True``.  PyTorch's own
default (``F.gelu(x)``) is the exact erf form and does not match it.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


ACTIVATIONS = {
    "gelu": gelu,
    "relu": F.relu,
    "tanh": torch.tanh,
    None: _identity,
}


def get(act: Optional[str]) -> Callable:
    try:
        return ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"unknown activation {act!r}; known: "
            f"{sorted(k for k in ACTIVATIONS if k)}") from None
