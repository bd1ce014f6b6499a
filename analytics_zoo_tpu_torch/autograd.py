"""The autograd namespace of ``analytics_zoo_tpu/autograd.py``: the
reference's custom-loss function surface (``A.mean(A.square(y_true -
y_pred), axis=-1)``) and ``CustomLoss``, on torch.  The functions take
numpy's ``axis``/``keepdims`` spelling, as the JAX package's ``jnp``
functions do, so a custom loss written for either package runs on both.
``Lambda`` lives in ``nn.layers``."""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Union

import torch
import torch.nn.functional as F

Axis = Optional[Union[int, Sequence[int]]]

epsilon = 1e-7


def _dims(axis: Axis):
    return tuple(axis) if isinstance(axis, (list, tuple)) else axis


def abs(x: torch.Tensor) -> torch.Tensor:  # noqa: A001 - reference name
    return torch.abs(x)


def sum(x: torch.Tensor, axis: Axis = None,  # noqa: A001
        keepdims: bool = False) -> torch.Tensor:
    if axis is None:
        return x.sum()
    return x.sum(dim=_dims(axis), keepdim=keepdims)


def mean(x: torch.Tensor, axis: Axis = None,
         keepdims: bool = False) -> torch.Tensor:
    if axis is None:
        return x.mean()
    return x.mean(dim=_dims(axis), keepdim=keepdims)


def square(x: torch.Tensor) -> torch.Tensor:
    return torch.square(x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(x)


def exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(x)


def log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x)


def _pair_op(op: Callable, x: Any, y: Any) -> torch.Tensor:
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(x, dtype=y.dtype, device=y.device)
    if not isinstance(y, torch.Tensor):
        y = torch.as_tensor(y, dtype=x.dtype, device=x.device)
    return op(x, y)


def maximum(x: Any, y: Any) -> torch.Tensor:
    return _pair_op(torch.maximum, x, y)


def minimum(x: Any, y: Any) -> torch.Tensor:
    return _pair_op(torch.minimum, x, y)


def clip(x: torch.Tensor, a_min: Any = None, a_max: Any = None
         ) -> torch.Tensor:
    return torch.clamp(x, a_min, a_max)


def pow(x: torch.Tensor, a: Any) -> torch.Tensor:  # noqa: A001
    return torch.pow(x, a)


def neg(x: torch.Tensor) -> torch.Tensor:
    return torch.neg(x)


def stack(xs: Sequence[torch.Tensor], axis: int = 0) -> torch.Tensor:
    return torch.stack(list(xs), dim=axis)


def expand_dims(x: torch.Tensor, axis: int) -> torch.Tensor:
    return torch.unsqueeze(x, axis)


def squeeze(x: torch.Tensor, axis: Axis = None) -> torch.Tensor:
    if axis is None:
        return torch.squeeze(x)
    return torch.squeeze(x, _dims(axis))


def softsign(x: torch.Tensor) -> torch.Tensor:
    return F.softsign(x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def mm(x: torch.Tensor, y: torch.Tensor, axes: Any = None) -> torch.Tensor:
    """Matrix product (``axes``: a ``tensordot`` contraction)."""
    if axes is not None:
        return torch.tensordot(x, y, dims=axes)
    return x @ y


def batch_dot(x: torch.Tensor, y: torch.Tensor, axes: Any = (2, 1),
              normalize: bool = False) -> torch.Tensor:
    """The ``nn.Dot`` contraction."""
    from .nn import Dot
    return Dot(axes=axes, normalize=normalize)([x, y])


def l2_normalize(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=axis, keepdim=True)
                + epsilon)


def contiguous(x: torch.Tensor) -> torch.Tensor:
    return x.contiguous()


class CustomLoss:
    """A loss from an expression ``loss_func(y_true, y_pred)`` (scalar or
    per example), called with the Estimator's ``(y_pred, y_true)`` and
    averaged, as ``autograd.py`` CustomLoss is; ``forward(y_true,
    y_pred)`` is the reference's spelling and returns the tensor."""

    def __init__(self, loss_func: Callable, y_pred_shape: Any = None):
        self.loss_func = loss_func
        self.y_pred_shape = y_pred_shape

    def __call__(self, y_pred: torch.Tensor,
                 y_true: torch.Tensor) -> torch.Tensor:
        return torch.mean(self.loss_func(y_true, y_pred))

    def forward(self, y_true: torch.Tensor,
                y_pred: torch.Tensor) -> torch.Tensor:
        return self(y_pred, y_true)


__all__ = ["abs", "sum", "mean", "square", "sqrt", "exp", "log", "maximum",
           "minimum", "clip", "pow", "neg", "stack", "expand_dims",
           "squeeze", "softsign", "softplus", "epsilon", "mm", "batch_dot",
           "l2_normalize", "contiguous", "CustomLoss"]
