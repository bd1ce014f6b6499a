"""Recurrent layers (port of ``analytics_zoo_tpu/nn/recurrent.py``):
``LSTM``, ``GRU``, ``SimpleRNN``, ``Bidirectional`` and ``TimeDistributed``.

The cells are the JAX package's, written out, not ``torch.nn.LSTM`` or
``torch.nn.GRU``: the LSTM's gates are i, f, g, o with the forget gate
``sigmoid(f + 1.0)``, and the GRU applies its reset gate to the recurrent
half only, ``n = tanh(xz_n + r * hz_n)`` (cuDNN's GRU applies it after
the recurrent bias).  Parameters are the JAX layout, ``kernel`` ``[F, g *
U]``, ``recurrent_kernel`` ``[U, g * U]`` and ``bias`` ``[g * U]``, so a
converted JAX tree loads one to one.

The time loop is a Python loop over T: on the card the Estimator captures
the whole train step, loop included, as one CUDA graph, so a replay pays
no host time a timestep.  The input product of every step is hoisted into
one ``[B * T, F] @ [F, g * U]`` product; each step then adds its
recurrent product and the bias in the JAX package's order.  The kernels
are read through attribute access on every forward, so an int8 serving
context's weight-only swap (``nn/quant.py``) is seen, and a calibrated
context leaves them dequantized (only ``Dense`` and ``Conv2D`` take int8
products).

``go_backwards`` runs the steps from the last input frame to the first;
the "last" output is then the last step of that loop, not the last input
frame, and ``return_sequences`` gives the outputs back in input order.
``return_state`` adds the final carry: ``(h, c)`` for the LSTM, ``h``
otherwise.
"""

from __future__ import annotations

import copy
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import nn

from . import initializers


class _RNNBase(nn.Module):
    n_gates = 1

    def __init__(self, input_dim: int, units: int,
                 return_sequences: bool = False, return_state: bool = False,
                 go_backwards: bool = False,
                 kernel_init: Union[str, Callable] = "glorot_uniform",
                 recurrent_init: Union[str, Callable] = "orthogonal"):
        super().__init__()
        self.input_dim = input_dim
        self.units = units
        self.return_sequences = return_sequences
        self.return_state = return_state
        self.go_backwards = go_backwards
        self.kernel_init = initializers.get(kernel_init)
        self.recurrent_init = initializers.get(recurrent_init)
        width = self.n_gates * units
        self.kernel = nn.Parameter(torch.empty(input_dim, width))
        self.recurrent_kernel = nn.Parameter(torch.empty(units, width))
        self.bias = nn.Parameter(torch.empty(width))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        self.recurrent_init(self.recurrent_kernel, generator)
        initializers.zeros(self.bias)

    def extra_repr(self) -> str:
        return (f"input_dim={self.input_dim}, units={self.units}, "
                f"return_sequences={self.return_sequences}, "
                f"go_backwards={self.go_backwards}")

    def _init_carry(self, x: torch.Tensor) -> Any:
        raise NotImplementedError

    def _step(self, xw_t: torch.Tensor, wh: torch.Tensor, b: torch.Tensor,
              carry: Any) -> Tuple[Any, torch.Tensor]:
        raise NotImplementedError

    def forward(self, x: torch.Tensor):
        """``x`` ``[B, T, F]``; returns ``[B, T, U]`` (``return_sequences``)
        or ``[B, U]``, with the final carry when ``return_state``."""
        wi = self.kernel.to(x.dtype)
        wh = self.recurrent_kernel.to(x.dtype)
        b = self.bias.to(x.dtype)
        bsz, t = x.shape[:2]
        xw = (x.reshape(bsz * t, -1) @ wi).reshape(bsz, t, -1)
        # one view a step through unbind, whose backward stacks the steps'
        # gradients once; indexing xw[:, i] would make each step's backward
        # a zero-filled [B, T, g * U] tensor and a full-size add (at T 500
        # three quarters of an LSTM train step's card time)
        xw_steps = xw.unbind(1)
        carry = self._init_carry(x)
        order = range(t - 1, -1, -1) if self.go_backwards else range(t)
        outs = []
        for i in order:
            carry, out = self._step(xw_steps[i], wh, b, carry)
            outs.append(out)
        last = outs[-1]
        if self.return_sequences:
            if self.go_backwards:
                outs = outs[::-1]
            out = torch.stack(outs, dim=1)
        else:
            out = last
        if self.return_state:
            return out, carry
        return out


class LSTM(_RNNBase):
    n_gates = 4

    def _init_carry(self, x):
        z = x.new_zeros((x.shape[0], self.units))
        return (z, z)  # (h, c)

    def _step(self, xw_t, wh, b, carry):
        h, c = carry
        z = xw_t + h @ wh + b
        i, f, g, o = torch.chunk(z, 4, dim=-1)
        i, f, o = torch.sigmoid(i), torch.sigmoid(f + 1.0), torch.sigmoid(o)
        c = f * c + i * torch.tanh(g)
        h = o * torch.tanh(c)
        return (h, c), h


class GRU(_RNNBase):
    n_gates = 3

    def _init_carry(self, x):
        return x.new_zeros((x.shape[0], self.units))

    def _step(self, xw_t, wh, b, h):
        u = self.units
        xz = xw_t + b
        hz = h @ wh
        r = torch.sigmoid(xz[:, :u] + hz[:, :u])
        z = torch.sigmoid(xz[:, u:2 * u] + hz[:, u:2 * u])
        n = torch.tanh(xz[:, 2 * u:] + r * hz[:, 2 * u:])
        h = (1 - z) * n + z * h
        return h, h


class SimpleRNN(_RNNBase):
    n_gates = 1

    def _init_carry(self, x):
        return x.new_zeros((x.shape[0], self.units))

    def _step(self, xw_t, wh, b, h):
        h = torch.tanh(xw_t + h @ wh + b)
        return h, h


class Bidirectional(nn.Module):
    """A recurrent layer run forward and backward, outputs merged by
    ``merge_mode`` (concat, sum, mul or ave).  The two runs are the children
    ``forward`` and ``backward`` (the JAX tree's names), each with its own
    weights; they sit in ``_modules`` only, since an attribute named
    ``forward`` would hide ``Module.forward``."""

    def __init__(self, layer: _RNNBase, merge_mode: str = "concat"):
        super().__init__()
        if merge_mode not in ("concat", "sum", "mul", "ave"):
            raise ValueError(f"unknown merge_mode {merge_mode!r}")
        bwd = copy.deepcopy(layer)
        bwd.go_backwards = not layer.go_backwards
        bwd.reset_parameters()
        self._modules["forward"] = layer
        self._modules["backward"] = bwd
        self.merge_mode = merge_mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        yf = self._modules["forward"](x)
        yb = self._modules["backward"](x)
        if self.merge_mode == "concat":
            return torch.cat([yf, yb], dim=-1)
        if self.merge_mode == "sum":
            return yf + yb
        if self.merge_mode == "mul":
            return yf * yb
        return (yf + yb) / 2


class TimeDistributed(nn.Module):
    """``layer`` applied to every timestep: the time axis folded into the
    batch for one call of the child ``inner``."""

    def __init__(self, layer: nn.Module):
        super().__init__()
        self.inner = layer

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[:2]
        y = self.inner(x.reshape((b * t,) + tuple(x.shape[2:])))
        return y.reshape((b, t) + tuple(y.shape[1:]))


__all__ = ["LSTM", "GRU", "SimpleRNN", "Bidirectional", "TimeDistributed"]
