"""Loss functions (port of ``analytics_zoo_tpu/nn/losses.py``).

Every loss is ``fn(y_pred, y_true) -> scalar`` (mean over the batch), the
same math as the JAX package's, gradients included: a clip is
``torch.maximum`` / ``torch.minimum`` against a bound, which splits a tie's
gradient 0.5 / 0.5 as ``jnp.clip`` and ``jnp.maximum`` do (``torch.clamp``
gives all of it to the input), and an absolute value has gradient 1 at 0,
as ``jnp.abs`` does (``torch.abs`` has 0).  ``get`` resolves Keras-style
string names.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

import torch


def _clip(x: torch.Tensor, lo: Optional[float] = None,
          hi: Optional[float] = None) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)`` with its gradient at the bounds.  The bounds
    are filled on x's device (``new_full``), never copied from the host,
    so a CUDA graph can capture the loss."""
    if lo is not None:
        x = torch.maximum(x, x.new_full((), lo))
    if hi is not None:
        x = torch.minimum(x, x.new_full((), hi))
    return x


def _abs(x: torch.Tensor) -> torch.Tensor:
    """``jnp.abs(x)`` with its gradient of 1 at 0."""
    return torch.where(x >= 0, x, -x)


def _take(logits: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``logits[..., idx]`` per position (``take_along_axis`` on the last
    axis)."""
    return torch.gather(logits, -1, idx.long()[..., None])[..., 0]


def sparse_categorical_crossentropy(y_pred: torch.Tensor,
                                    y_true: torch.Tensor,
                                    from_logits: bool = True
                                    ) -> torch.Tensor:
    if from_logits:
        # softmax math in f32; logsumexp - gather never materialises the
        # [.., vocab] f32 log-probability array, as in the JAX package
        logits = y_pred.float()
        return (torch.logsumexp(logits, dim=-1) - _take(logits, y_true)).mean()
    logp = torch.log(_clip(y_pred, 1e-7, 1.0))
    return (-_take(logp, y_true)).mean()


def categorical_crossentropy(y_pred: torch.Tensor, y_true: torch.Tensor,
                             from_logits: bool = True) -> torch.Tensor:
    if from_logits:
        logp = torch.log_softmax(y_pred.float(), dim=-1)
    else:
        logp = torch.log(_clip(y_pred, 1e-7, 1.0))
    return -(y_true * logp).sum(dim=-1).mean()


def binary_crossentropy(y_pred: torch.Tensor, y_true: torch.Tensor,
                        from_logits: bool = True) -> torch.Tensor:
    y_true = y_true.to(y_pred.dtype)
    if from_logits:
        # numerically stable log-sigmoid form
        return torch.mean(_clip(y_pred, 0.0) - y_pred * y_true +
                          torch.log1p(torch.exp(-_abs(y_pred))))
    p = _clip(y_pred, 1e-7, 1 - 1e-7)
    return -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p)).mean()


def mean_squared_error(y_pred: torch.Tensor,
                       y_true: torch.Tensor) -> torch.Tensor:
    return torch.square(y_pred - y_true).mean()


def mean_absolute_error(y_pred: torch.Tensor,
                        y_true: torch.Tensor) -> torch.Tensor:
    return _abs(y_pred - y_true).mean()


def huber(y_pred: torch.Tensor, y_true: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    err = _abs(y_pred - y_true)
    quad = _clip(err, hi=delta)
    return (0.5 * quad ** 2 + delta * (err - quad)).mean()


def hinge(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return _clip(1.0 - y_true * y_pred, 0.0).mean()


def squared_hinge(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return torch.square(_clip(1.0 - y_true * y_pred, 0.0)).mean()


def mean_absolute_percentage_error(y_pred: torch.Tensor,
                                   y_true: torch.Tensor) -> torch.Tensor:
    diff = _abs((y_true - y_pred) / _clip(_abs(y_true), 1e-7))
    return 100.0 * diff.mean()


def mean_squared_logarithmic_error(y_pred: torch.Tensor,
                                   y_true: torch.Tensor) -> torch.Tensor:
    a = torch.log1p(_clip(y_pred, 0.0))
    b = torch.log1p(_clip(y_true, 0.0))
    return torch.square(a - b).mean()


def poisson(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return (y_pred - y_true * torch.log(_clip(y_pred, 1e-7))).mean()


def kld(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    p = _clip(y_true, 1e-7, 1.0)
    q = _clip(y_pred, 1e-7, 1.0)
    return (p * torch.log(p / q)).sum(dim=-1).mean()


def cosine_proximity(y_pred: torch.Tensor,
                     y_true: torch.Tensor) -> torch.Tensor:
    yp = y_pred / (torch.linalg.norm(y_pred, dim=-1, keepdim=True) + 1e-8)
    yt = y_true / (torch.linalg.norm(y_true, dim=-1, keepdim=True) + 1e-8)
    return -(yp * yt).sum(dim=-1).mean()


LOSSES = {
    "sparse_categorical_crossentropy": sparse_categorical_crossentropy,
    "categorical_crossentropy": categorical_crossentropy,
    "binary_crossentropy": binary_crossentropy,
    "mse": mean_squared_error,
    "mean_squared_error": mean_squared_error,
    "mae": mean_absolute_error,
    "mean_absolute_error": mean_absolute_error,
    "huber": huber,
    "hinge": hinge,
    "squared_hinge": squared_hinge,
    "mape": mean_absolute_percentage_error,
    "mean_absolute_percentage_error": mean_absolute_percentage_error,
    "msle": mean_squared_logarithmic_error,
    "mean_squared_logarithmic_error": mean_squared_logarithmic_error,
    "poisson": poisson,
    "kld": kld,
    "cosine_proximity": cosine_proximity,
}


def get(loss: Union[str, Callable]) -> Callable:
    if callable(loss):
        return loss
    try:
        return LOSSES[loss]
    except KeyError:
        raise ValueError(
            f"unknown loss {loss!r}; known: {sorted(LOSSES)}") from None
