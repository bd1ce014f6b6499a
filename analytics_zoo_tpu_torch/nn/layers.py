"""Core layers: the subset of ``analytics_zoo_tpu.nn.layers`` on the BERT
serving and training paths (``Dense``, ``Embedding``, ``Dropout``,
``LayerNormalization``), and ``Remat`` (``nn/layers_extra.py``).

Parameter names and layouts are the JAX package's, so a converted JAX tree
loads with ``load_state_dict``: Dense ``kernel`` is ``(in, out)``, LayerNorm
has ``gamma``/``beta``, Embedding has ``embeddings``.  Input widths are
constructor arguments (PyTorch builds parameters eagerly; JAX inferred them
from the first input).  Each layer draws its initial values in
``reset_parameters(generator)``.
"""

from __future__ import annotations

import contextlib
from typing import Any, List, Optional

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
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
    """Identity unless the module is in training mode; then each element is
    kept with probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, as
    ``layers.py`` Dropout does.

    The mask is drawn from ``generator``, a ``torch.Generator`` on the
    activation's device: ``seed_dropout`` gives every Dropout of a model one
    generator seeded from a number (the Estimator does, from its ``seed``),
    so a run repeats its masks.  A Dropout with no generator, or one on
    another device, makes its own, seeded from torch's global generator."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def generator_for(self, device: torch.device) -> torch.Generator:
        device = _indexed(device)
        gen = self.generator
        if gen is None or _indexed(gen.device) != device:
            seed = int(torch.randint(2 ** 62, ()).item())
            gen = torch.Generator(device=device).manual_seed(seed)
            self.generator = gen
        return gen

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        # a 0/1 mask in x's dtype, drawn in one pass; x * mask is exact, so
        # the result rounds as the JAX package's where(mask, x / keep, 0)
        mask = torch.empty_like(x).bernoulli_(
            keep, generator=self.generator_for(x.device))
        return x * mask / keep


def _indexed(device: Any) -> torch.device:
    """``device`` with its index: a CUDA generator made for ``"cuda"``
    reports no index, an activation on the card always has one."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def seed_dropout(model: nn.Module, seed: int,
                 device: torch.device) -> torch.Generator:
    """Give every ``Dropout`` in ``model`` one generator on ``device``
    seeded with ``seed``; returns it."""
    gen = torch.Generator(device=_indexed(device)).manual_seed(int(seed))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    return gen


def _rewound_generators(gens: List[torch.Generator]):
    """``context_fn`` for ``torch.utils.checkpoint``: the forward records
    the generators' states, and the recompute in the backward starts from
    them (so every dropout mask repeats) and restores the generators to
    where they were before the recompute."""
    states: List[torch.Tensor] = []

    @contextlib.contextmanager
    def forward():
        states[:] = [g.get_state() for g in gens]
        yield

    @contextlib.contextmanager
    def recompute():
        now = [g.get_state() for g in gens]
        for g, st in zip(gens, states):
            g.set_state(st)
        try:
            yield
        finally:
            for g, st in zip(gens, now):
                g.set_state(st)

    return forward(), recompute()


class Remat(nn.Module):
    """Gradient checkpointing wrapper (port of ``nn.Remat``): the wrapped
    module's activations are recomputed in the backward instead of stored.
    The inner module sits under its own ``name``, as in the JAX tree
    (``remat_0/layer_0/...``)."""

    def __init__(self, inner: nn.Module, name: str):
        super().__init__()
        self.inner_name = name
        self.add_module(name, inner)

    def forward(self, x: torch.Tensor, **kwargs: Any) -> torch.Tensor:
        inner = getattr(self, self.inner_name)
        if not torch.is_grad_enabled():
            return inner(x, **kwargs)
        # only the input is kept; the recompute in the backward draws the
        # same dropout masks from the rewound generators
        gens = list({id(g): g for g in (m.generator_for(x.device)
                                        for m in inner.modules()
                                        if isinstance(m, Dropout))}.values())
        return torch.utils.checkpoint.checkpoint(
            inner, x, use_reentrant=False,
            context_fn=lambda: _rewound_generators(gens), **kwargs)


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
