"""Core layers: the subset of ``analytics_zoo_tpu.nn.layers`` on the BERT
serving path (``Dense``, ``Embedding``, ``Dropout``, ``LayerNormalization``).

Parameter names and layouts are the JAX package's, so a converted JAX tree
loads with ``load_state_dict``: Dense ``kernel`` is ``(in, out)``, LayerNorm
has ``gamma``/``beta``, Embedding has ``embeddings``.  Input widths are
constructor arguments (PyTorch builds parameters eagerly; JAX inferred them
from the first input).  Each layer draws its initial values in
``reset_parameters(generator)``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from . import activations, initializers


class Dense(nn.Module):
    """Fully connected layer: the matmul runs in the input's dtype, the bias
    is added in the output's dtype (as ``layers.py`` Dense does)."""

    def __init__(self, in_features: int, units: int,
                 activation: Optional[str] = None):
        super().__init__()
        self.activation = activations.get(activation)
        self.kernel = nn.Parameter(torch.empty(in_features, units))
        self.bias = nn.Parameter(torch.empty(units))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        initializers.glorot_uniform(self.kernel, generator)
        initializers.zeros(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.kernel.to(x.dtype)
        return self.activation(y + self.bias.to(y.dtype))


class Embedding(nn.Module):
    """Token embedding: ``embeddings[ids]`` over an ``(input_dim,
    output_dim)`` table."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.embeddings = nn.Parameter(torch.empty(input_dim, output_dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        initializers.get("normal")(self.embeddings, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embeddings)


class Dropout(nn.Module):
    """Identity unless the module is in training mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        return F.dropout(x, self.rate, training=True)


class LayerNormalization(nn.Module):
    """LayerNorm with f32 statistics whatever the activation dtype, the
    output cast back to the input dtype; epsilon 1e-6 as in the JAX
    package."""

    def __init__(self, dim: int, epsilon: float = 1e-6):
        super().__init__()
        self.epsilon = epsilon
        self.gamma = nn.Parameter(torch.empty(dim))
        self.beta = nn.Parameter(torch.empty(dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        initializers.ones(self.gamma)
        initializers.zeros(self.beta)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(dim=-1, keepdim=True)
        var = (xf - mean).square().mean(dim=-1, keepdim=True)
        y = (xf - mean) * torch.rsqrt(var + self.epsilon)
        return (y * self.gamma + self.beta).to(x.dtype)
