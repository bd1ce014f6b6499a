"""Weight initializers: the subset of ``analytics_zoo_tpu.nn.initializers``
this port's layers use, drawing from an explicit ``torch.Generator``.

Same distributions as the JAX package (fan computed over the trailing two
axes of an ``(in, out)`` kernel; an OIHW conv kernel's fan in is I * H *
W), not the same numbers: JAX keys and torch
generators differ, so tests that compare the two packages initialise in JAX
and convert the weights.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

Initializer = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]


def _fans(shape: torch.Size) -> tuple:
    receptive = math.prod(shape[:-2]) if len(shape) > 2 else 1
    fan_in = shape[-2] * receptive if len(shape) > 1 else shape[-1]
    return fan_in, shape[-1] * receptive


@torch.no_grad()
def glorot_uniform(t: torch.Tensor,
                   generator: Optional[torch.Generator] = None) -> torch.Tensor:
    fan_in, fan_out = _fans(t.shape)
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return t.uniform_(-limit, limit, generator=generator)


def normal(stddev: float = 0.05) -> Initializer:
    @torch.no_grad()
    def init(t: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return t.normal_(0.0, stddev, generator=generator)
    return init


@torch.no_grad()
def zeros(t: torch.Tensor,
          generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.zero_()


@torch.no_grad()
def ones(t: torch.Tensor,
         generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return t.fill_(1.0)


@torch.no_grad()
def he_normal(t: torch.Tensor,
              generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """JAX's ``he_normal``: a normal truncated at 2 standard deviations,
    scaled to variance ``2 / fan_in``.  A 4-D tensor is an OIHW conv kernel
    (fan in = I * H * W, as JAX counts it on the HWIO kernel)."""
    fan_in = t[0].numel() if t.dim() == 4 else _fans(t.shape)[0]
    std = math.sqrt(2.0 / fan_in) / _TRUNC_STD
    return torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                       generator=generator)


@torch.no_grad()
def orthogonal(t: torch.Tensor,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """JAX's ``orthogonal``: a QR of a normal draw, the columns of the
    last axis against the rows of the others, orthonormal along the
    shorter side (a recurrent kernel ``[U, g * U]`` gets orthonormal
    rows)."""
    return torch.nn.init.orthogonal_(t, generator=generator)


# the standard deviation of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978

INITIALIZERS = {
    "glorot_uniform": glorot_uniform,
    "he_normal": he_normal,
    "normal": normal(0.05),
    "zeros": zeros,
    "ones": ones,
    "orthogonal": orthogonal,
}


def get(init: Union[str, Initializer]) -> Initializer:
    if callable(init):
        return init
    try:
        return INITIALIZERS[init]
    except KeyError:
        raise ValueError(f"unknown initializer {init!r}; known: "
                         f"{sorted(INITIALIZERS)}") from None
