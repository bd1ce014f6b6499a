"""Activation registry: the names of ``analytics_zoo_tpu.nn.activations``,
with JAX's definitions and gradients.

``"gelu"`` is the tanh approximation, because the JAX package's ``"gelu"``
is ``jax.nn.gelu``, whose default is ``approximate=True``.  PyTorch's own
default (``F.gelu(x)``) is the exact erf form and does not match it.
``"leaky_relu"`` has JAX's slope of 0.01 and gradient 1 at 0 (PyTorch's
``F.leaky_relu`` gives the slope there); ``"relu"`` and ``"relu6"`` have
gradient 0 at their kinks, as JAX's do; ``"hard_sigmoid"`` is
``relu6(x + 3) / 6``.  ``get`` also takes any callable, as JAX's does.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def leaky_relu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, x, 0.01 * x)


def elu(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, torch.expm1(torch.where(x > 0, 0.0, x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def hard_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


def softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.softmax(x, dim=-1)


def log_softmax(x: torch.Tensor) -> torch.Tensor:
    return torch.log_softmax(x, dim=-1)


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


ACTIVATIONS = {
    "relu": F.relu,
    "relu6": F.relu6,
    "gelu": gelu,
    "silu": F.silu,
    "swish": F.silu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "softmax": softmax,
    "log_softmax": log_softmax,
    "softplus": softplus,
    "elu": elu,
    "leaky_relu": leaky_relu,
    "hard_sigmoid": hard_sigmoid,
    "linear": _identity,
    None: _identity,
}


def get(act: Union[str, Callable, None]) -> Callable:
    if callable(act):
        return act
    try:
        return ACTIVATIONS[act]
    except KeyError:
        raise ValueError(
            f"unknown activation {act!r}; known: "
            f"{sorted(k for k in ACTIVATIONS if k)}") from None
