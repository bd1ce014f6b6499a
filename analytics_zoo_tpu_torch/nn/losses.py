"""Loss functions (port of ``analytics_zoo_tpu/nn/losses.py``).

Every loss is ``fn(y_pred, y_true) -> scalar`` (mean over the batch), the
same math as the JAX package's.  ``get`` resolves Keras-style string
names.
"""

from __future__ import annotations

from typing import Callable, Union

import torch


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
    logp = torch.log(torch.clamp(y_pred, 1e-7, 1.0))
    return (-_take(logp, y_true)).mean()


def categorical_crossentropy(y_pred: torch.Tensor, y_true: torch.Tensor,
                             from_logits: bool = True) -> torch.Tensor:
    if from_logits:
        logp = torch.log_softmax(y_pred.float(), dim=-1)
    else:
        logp = torch.log(torch.clamp(y_pred, 1e-7, 1.0))
    return -(y_true * logp).sum(dim=-1).mean()


def binary_crossentropy(y_pred: torch.Tensor, y_true: torch.Tensor,
                        from_logits: bool = True) -> torch.Tensor:
    y_true = y_true.to(y_pred.dtype)
    if from_logits:
        # numerically stable log-sigmoid form
        return torch.mean(torch.clamp(y_pred, min=0) - y_pred * y_true +
                          torch.log1p(torch.exp(-torch.abs(y_pred))))
    p = torch.clamp(y_pred, 1e-7, 1 - 1e-7)
    return -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p)).mean()


def mean_squared_error(y_pred: torch.Tensor,
                       y_true: torch.Tensor) -> torch.Tensor:
    return torch.square(y_pred - y_true).mean()


def mean_absolute_error(y_pred: torch.Tensor,
                        y_true: torch.Tensor) -> torch.Tensor:
    return torch.abs(y_pred - y_true).mean()


def huber(y_pred: torch.Tensor, y_true: torch.Tensor,
          delta: float = 1.0) -> torch.Tensor:
    err = torch.abs(y_pred - y_true)
    quad = torch.clamp(err, max=delta)
    return (0.5 * quad ** 2 + delta * (err - quad)).mean()


def hinge(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - y_true * y_pred, min=0.0).mean()


def squared_hinge(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return torch.square(torch.clamp(1.0 - y_true * y_pred, min=0.0)).mean()


def mean_absolute_percentage_error(y_pred: torch.Tensor,
                                   y_true: torch.Tensor) -> torch.Tensor:
    diff = torch.abs((y_true - y_pred) /
                     torch.clamp(torch.abs(y_true), min=1e-7))
    return 100.0 * diff.mean()


def mean_squared_logarithmic_error(y_pred: torch.Tensor,
                                   y_true: torch.Tensor) -> torch.Tensor:
    a = torch.log1p(torch.clamp(y_pred, min=0.0))
    b = torch.log1p(torch.clamp(y_true, min=0.0))
    return torch.square(a - b).mean()


def poisson(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    return (y_pred - y_true * torch.log(torch.clamp(y_pred, min=1e-7))).mean()


def kld(y_pred: torch.Tensor, y_true: torch.Tensor) -> torch.Tensor:
    p = torch.clamp(y_true, 1e-7, 1.0)
    q = torch.clamp(y_pred, 1e-7, 1.0)
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
