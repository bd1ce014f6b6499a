"""The layer zoo of ``analytics_zoo_tpu/nn/layers_zoo.py``: the convolutional
LSTMs, unshared 2-D convs, the 1-D and 3-D transposed convs, the separable
1-D conv, ``AlphaDropout``, ``Softmax``, ``ActivityRegularization``,
``WordEmbedding``, ``LRN2D``, the ``cos`` merge, the BigDL element-op
layers, ``GaussianSampler``, ``ResizeBilinear`` and the Keras-1 ``Merge``
/ ``merge``.

Activations are channel-last and input widths are constructor arguments,
as everywhere in the port.  Kernels of rank 4 and 5 (the convolutional
LSTMs' ``kernel`` and ``recurrent_kernel``, ``Conv3DTranspose``'s, and
``LocallyConnected2D``'s ``[oh, ow, patch, filters]``) are stored as
``convert`` transposes them (JAX's last two axes first, reversed); the
rank-3 kernels of the 1-D layers keep the JAX layout.  The recurrences
are Python loops over the steps, each step's input one view of an
``unbind`` (as ``recurrent.py``'s), with the input conv of every step in
one call.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import activations, initializers
from .layers import (Add, Concatenate, Dropout, Multiply, _norm_padding,
                     _pair)
from .layers_extra import (Average, Dot, Maximum, Minimum, _channels_first,
                           _triple, conv_channels_last, deconv_channels_last)
from .module import record_aux_loss


# -- recurrent convolution -----------------------------------------------------

def hard_sigmoid_k1(x: torch.Tensor) -> torch.Tensor:
    """Keras-1's ``hard_sigmoid``: ``clip(0.2 x + 0.5, 0, 1)`` (not the
    ``relu6(x + 3) / 6`` of ``activations``)."""
    return torch.clamp(0.2 * x + 0.5, 0.0, 1.0)


def _k1_activation(name: Any) -> Callable:
    return hard_sigmoid_k1 if name == "hard_sigmoid" \
        else activations.get(name)


class _ConvLSTMND(nn.Module):
    """The convolutional LSTM over ``[B, T, *spatial, C]`` frames
    (``layers_zoo.py`` ``_ConvLSTMND``): gates ``i, f, g, o`` from a conv of
    the frame (``kernel``, any stride and padding) plus a stride-1 SAME
    conv of the hidden state (``recurrent_kernel``) plus ``bias``, whose
    forget quarter starts at 1 with ``unit_forget_bias``; Keras-1's
    defaults (tanh, the legacy hard sigmoid)."""

    _rank: int

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Any = "same", activation: Any = "tanh",
                 recurrent_activation: Any = "hard_sigmoid",
                 unit_forget_bias: bool = True,
                 return_sequences: bool = False, go_backwards: bool = False,
                 kernel_init: Any = "glorot_uniform"):
        super().__init__()
        norm = _pair if self._rank == 2 else _triple
        self.filters = filters
        self.kernel_size = norm(kernel_size)
        self.strides = norm(strides)
        self.padding = _norm_padding(padding)
        self.activation = _k1_activation(activation)
        self.recurrent_activation = _k1_activation(recurrent_activation)
        self.unit_forget_bias = unit_forget_bias
        self.return_sequences = return_sequences
        self.go_backwards = go_backwards
        self.kernel_init = initializers.get(kernel_init)
        self.kernel = nn.Parameter(torch.empty(
            (4 * filters, in_channels) + self.kernel_size))
        self.recurrent_kernel = nn.Parameter(torch.empty(
            (4 * filters, filters) + self.kernel_size))
        self.bias = nn.Parameter(torch.empty(4 * filters))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        self.kernel_init(self.recurrent_kernel, generator)
        with torch.no_grad():
            self.bias.zero_()
            if self.unit_forget_bias:
                self.bias[self.filters:2 * self.filters] = 1.0

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        r = self._rank
        if x.dim() != r + 3:
            names = "D,H,W" if r == 3 else "H,W"
            raise ValueError(f"{type(self).__name__} wants [B,T,{names},C], "
                             f"got {tuple(x.shape)}")
        b, t = x.shape[:2]
        f = self.filters
        wx = self.kernel.to(x.dtype)
        wh = self.recurrent_kernel.to(x.dtype)
        bias = self.bias.to(x.dtype)
        zx = conv_channels_last(x.reshape((b * t,) + tuple(x.shape[2:])),
                                wx, self.strides, self.padding)
        zx_steps = zx.reshape((b, t) + tuple(zx.shape[1:])).unbind(1)
        hid = cell = x.new_zeros(tuple(zx_steps[0].shape[:-1]) + (f,))
        act, rec = self.activation, self.recurrent_activation
        order = range(t - 1, -1, -1) if self.go_backwards else range(t)
        outs = []
        for i in order:
            z = zx_steps[i] + conv_channels_last(hid, wh, (1,) * r,
                                                 "SAME") + bias
            gi, gf, gg, go = z.split(f, dim=-1)
            cell = rec(gf) * cell + rec(gi) * act(gg)
            hid = rec(go) * act(cell)
            outs.append(hid)
        # backwards, the steps come out in processing order, as the JAX
        # package's reversed scan flipped back gives them
        return torch.stack(outs, dim=1) if self.return_sequences else hid


class ConvLSTM2D(_ConvLSTMND):
    """Convolutional LSTM over ``[B, T, H, W, C]``."""
    _rank = 2


class ConvLSTM3D(_ConvLSTMND):
    """Volumetric convolutional LSTM over ``[B, T, D, H, W, C]``."""
    _rank = 3


# -- unshared convolution ------------------------------------------------------

class LocallyConnected2D(nn.Module):
    """Conv2D with one kernel per output position, VALID only
    (``layers_zoo.py`` LocallyConnected2D).  The patches are ``(C, kh,
    kw)``-ordered, as ``conv_general_dilated_patches`` gives them;
    ``kernel`` is JAX's ``[oh, ow, C * kh * kw, filters]`` as ``convert``
    stores a 4-D kernel, ``[filters, C * kh * kw, oh, ow]``; ``bias`` is
    ``[oh, ow, filters]``.  ``input_hw`` fixes ``(oh, ow)``."""

    def __init__(self, in_channels: int, input_hw: Sequence[int],
                 filters: int, kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = "valid", activation: Any = None,
                 use_bias: bool = True, kernel_init: Any = "glorot_uniform"):
        super().__init__()
        if isinstance(padding, str) and padding.lower() != "valid":
            raise ValueError("LocallyConnected2D supports padding='valid' "
                             "only (keras semantics)")
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        (kh, kw), (sh, sw) = self.kernel_size, self.strides
        h, w = input_hw
        self.out_hw = ((h - kh) // sh + 1, (w - kw) // sw + 1)
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(kernel_init)
        self.kernel = nn.Parameter(torch.empty(
            (filters, in_channels * kh * kw) + self.out_hw))
        self.bias = nn.Parameter(torch.empty(self.out_hw + (filters,))) \
            if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        oh, ow = self.out_hw
        patches = F.unfold(_channels_first(x), self.kernel_size,
                           stride=self.strides)
        patches = patches.reshape(x.shape[0], -1, oh, ow)
        y = torch.einsum("bphw,fphw->bhwf", patches,
                         self.kernel.to(patches.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)


# -- transpose / separable variants -------------------------------------------

class _Deconv(nn.Module):
    def _init(self, shape: Tuple[int, ...], filters: int, activation: Any,
              use_bias: bool, kernel_init: Any) -> None:
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(kernel_init)
        self.kernel = nn.Parameter(torch.empty(shape))
        self.bias = nn.Parameter(torch.empty(filters)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def _out(self, y: torch.Tensor) -> torch.Tensor:
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)


class Conv3DTranspose(_Deconv):
    """Keras's 3-D transposed conv over NDHWC; ``kernel`` ``(filters, in,
    kd, kh, kw)``, JAX's DHWIO as ``convert`` transposes it."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = "same", activation: Any = None,
                 use_bias: bool = True, kernel_init: Any = "glorot_uniform"):
        super().__init__()
        self.strides = _triple(strides)
        self.padding = padding.upper()
        self._init((filters, in_channels) + _triple(kernel_size), filters,
                   activation, use_bias, kernel_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype).transpose(0, 1)
        return self._out(deconv_channels_last(x, w, self.strides,
                                              self.padding))


class Conv1DTranspose(_Deconv):
    """Keras's 1-D transposed conv over NWC; ``kernel`` is JAX's ``(k, in,
    filters)``."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1, padding: str = "same",
                 activation: Any = None, use_bias: bool = True,
                 kernel_init: Any = "glorot_uniform"):
        super().__init__()
        self.strides = (strides,)
        self.padding = padding.upper()
        self._init((kernel_size, in_channels, filters), filters, activation,
                   use_bias, kernel_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype).permute(1, 2, 0)
        return self._out(deconv_channels_last(x, w, self.strides,
                                              self.padding))


class SeparableConv1D(nn.Module):
    """Depthwise then pointwise 1-D conv: ``depthwise_kernel`` ``(k, 1, C *
    m)`` and ``pointwise_kernel`` ``(1, C * m, filters)`` (JAX's layouts),
    ``bias`` ``[filters]``."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1, padding: str = "same",
                 depth_multiplier: int = 1, activation: Any = None,
                 use_bias: bool = True, kernel_init: Any = "glorot_uniform"):
        super().__init__()
        self.in_channels = in_channels
        self.strides = strides
        self.padding = padding.upper()
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(kernel_init)
        mid = in_channels * depth_multiplier
        self.depthwise_kernel = nn.Parameter(torch.empty(kernel_size, 1,
                                                         mid))
        self.pointwise_kernel = nn.Parameter(torch.empty(1, mid, filters))
        self.bias = nn.Parameter(torch.empty(filters)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.depthwise_kernel, generator)
        self.kernel_init(self.pointwise_kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dw = self.depthwise_kernel.to(x.dtype).permute(2, 1, 0)
        y = conv_channels_last(x, dw, (self.strides,), self.padding,
                               groups=self.in_channels)
        pw = self.pointwise_kernel.to(y.dtype).permute(2, 1, 0)
        y = conv_channels_last(y, pw, (1,), "VALID")
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)


# -- keras-2 extras ------------------------------------------------------------

class AlphaDropout(Dropout):
    """SELU-preserving dropout: dropped units go to SELU's negative
    saturation, then an affine keeps mean and variance."""

    _ALPHA_P = -1.7580993408473766

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        a = (keep + self._ALPHA_P ** 2 * keep * (1 - keep)) ** -0.5
        b = -a * self._ALPHA_P * (1 - keep)
        mask = torch.empty_like(x).bernoulli_(
            keep, generator=self.generator_for(x.device)).bool()
        return a * torch.where(mask, x, torch.full_like(x, self._ALPHA_P)) + b


class Softmax(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.softmax(x, dim=self.axis)


class ActivityRegularization(nn.Module):
    """Identity that records ``l1 * sum|x| + l2 * sum x^2`` (f32) in its
    buffer ``aux_loss``, the JAX layer's ``state``, and hands the same
    number with its gradient to the aux-loss channel
    (``nn.module.record_aux_loss``), which the Estimator adds to the loss
    with ``aux_loss_weight``; ``penalty`` keeps it too, for a loss of the
    caller's to add."""

    def __init__(self, l1: float = 0.0, l2: float = 0.0):
        super().__init__()
        self.l1, self.l2 = float(l1), float(l2)
        self.register_buffer("aux_loss", torch.zeros(()))
        self.penalty: Optional[torch.Tensor] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pen = (self.l1 * x.abs().sum() + self.l2 * x.square().sum()).float()
        self.penalty = pen
        record_aux_loss(self, pen)
        with torch.no_grad():
            self.aux_loss.copy_(pen)
        return x


class WordEmbedding(nn.Module):
    """Pre-trained word embeddings, frozen by default (reference:
    WordEmbedding, zoo keras layers; loaded GloVe txt files for the text
    models).  ``weights``: [vocab, dim] array, or a GloVe-format txt path
    via :meth:`from_glove`.

    A frozen table is a buffer, ``embeddings``: the JAX package keeps it in
    its ``state`` collection, and a buffer is what ``convert`` maps to
    ``state``.  The optimizer never sees it, so no decoupled weight decay
    (adamw) shrinks it either.  ``trainable=True`` makes it the parameter
    ``embeddings``, as the JAX package's ``params`` holds it."""

    def __init__(self, weights: Any, trainable: bool = False):
        super().__init__()
        self.weights = np.asarray(weights, np.float32)
        if self.weights.ndim != 2:
            raise ValueError(
                f"weights must be [vocab, dim], got {self.weights.shape}")
        self.trainable = trainable
        table = torch.from_numpy(self.weights.copy())
        if trainable:
            self.embeddings = nn.Parameter(table)
        else:
            self.register_buffer("embeddings", table)

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The table back to ``weights`` (its initial value in both
        packages; ``generator`` draws nothing)."""
        with torch.no_grad():
            self.embeddings.copy_(torch.from_numpy(self.weights))

    @staticmethod
    def from_glove(path: str, word_index: dict,
                   trainable: bool = False) -> "WordEmbedding":
        """Build from a GloVe-format text file ("word v1 v2 ...": one token
        per line) and a {word: idx} vocabulary (idx 0 = padding).  Words
        missing from the file stay zero.  Malformed lines (multi-token
        words, truncated tails, fastText "count dim" headers) are
        skipped."""
        vectors = {}
        dim = None
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.rstrip("\n").split(" ")
                if len(parts) < 3:  # also skips fastText "count dim" header
                    continue
                try:
                    vec = np.asarray(parts[1:], np.float32)
                except ValueError:
                    continue  # word containing spaces etc.
                if dim is None:
                    dim = len(vec)
                if len(vec) != dim:
                    continue  # truncated/odd line
                vectors[parts[0]] = vec
        if dim is None:
            raise ValueError(f"no vectors found in {path}")
        table = np.zeros((max(word_index.values()) + 1, dim), np.float32)
        for word, idx in word_index.items():
            v = vectors.get(word)
            if v is not None:
                table[idx] = v
        return WordEmbedding(table, trainable=trainable)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embeddings)


# -- normalization -------------------------------------------------------------

class LRN2D(nn.Module):
    """Cross-channel local response normalization over NHWC (Caffe's and
    Keras-1's: ``alpha`` divided by the window ``n``)."""

    def __init__(self, alpha: float = 1e-4, k: float = 1.0,
                 beta: float = 0.75, n: int = 5):
        super().__init__()
        self.alpha, self.k, self.beta, self.n = alpha, k, beta, n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        half, c = self.n // 2, x.shape[-1]
        pad = F.pad(x.square(), (half, half))
        window = sum(pad[..., i:i + c] for i in range(self.n))
        return x / torch.pow(self.k + (self.alpha / self.n) * window,
                             self.beta)


# -- merge variants ------------------------------------------------------------

class Cos(nn.Module):
    """Cosine proximity of two inputs over the last axis, kept as a
    trailing singleton."""

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        a, b = inputs
        num = (a * b).sum(dim=-1, keepdim=True)
        den = (torch.linalg.vector_norm(a, dim=-1, keepdim=True)
               * torch.linalg.vector_norm(b, dim=-1, keepdim=True))
        return num / torch.clamp_min(den, 1e-12)


# -- BigDL element-op layers ---------------------------------------------------

class Identity(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x


class Exp(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.exp(x)


class Log(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.log(x)


class Sqrt(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(x)


class Square(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.square(x)


class Power(nn.Module):
    """``(scale * x + shift) ** power``."""

    def __init__(self, power: float, scale: float = 1.0, shift: float = 0.0):
        super().__init__()
        self.power, self.scale, self.shift = power, scale, shift

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.pow(self.scale * x + self.shift, self.power)


class Negative(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return -x


class AddConstant(nn.Module):
    def __init__(self, constant: float):
        super().__init__()
        self.constant = constant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.constant


class MulConstant(nn.Module):
    def __init__(self, constant: float):
        super().__init__()
        self.constant = constant

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.constant


class Scale(nn.Module):
    """``gamma * x + beta`` over the last axis (``gamma`` ones, ``beta``
    zeros)."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))
        self.beta = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype) + self.beta.to(x.dtype)


class Threshold(nn.Module):
    """``x`` where ``x > th``, else ``value``."""

    def __init__(self, th: float = 1e-6, value: float = 0.0):
        super().__init__()
        self.th, self.value = th, value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x > self.th, x, torch.full_like(x, self.value))


class HardShrink(nn.Module):
    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x.abs() > self.lam, x, torch.zeros_like(x))


class SoftShrink(nn.Module):
    def __init__(self, lam: float = 0.5):
        super().__init__()
        self.lam = lam

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.sign(x) * torch.clamp_min(x.abs() - self.lam, 0.0)


class CAdd(nn.Module):
    """A trainable ``bias`` of shape ``size`` (zeros), broadcast-added."""

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(size)
        self.bias = nn.Parameter(torch.zeros(self.size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.bias.to(x.dtype)


class CMul(nn.Module):
    """A trainable ``weight`` of shape ``size`` (ones), broadcast-
    multiplied."""

    def __init__(self, size: Sequence[int]):
        super().__init__()
        self.size = tuple(size)
        self.weight = nn.Parameter(torch.ones(self.size))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.weight.to(x.dtype)


class HardTanh(nn.Module):
    def __init__(self, min_value: float = -1.0, max_value: float = 1.0):
        super().__init__()
        self.min_value, self.max_value = min_value, max_value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(x, self.min_value, self.max_value)


class GaussianSampler(Dropout):
    """``[mean, log_var] -> mean + exp(log_var / 2) * N(0, 1)`` in
    training, ``mean`` in eval; the noise comes from the dropout
    generator."""

    def __init__(self):
        super().__init__(0.0)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        mean, log_var = inputs
        if not self.training:
            return mean
        eps = torch.empty_like(mean).normal_(
            generator=self.generator_for(mean.device))
        return mean + torch.exp(0.5 * log_var) * eps


class ResizeBilinear(nn.Module):
    """Bilinear resize of NHWC maps on the legacy corner-origin grid, ``src
    = dst * in / out`` (or ``(in - 1) / (out - 1)`` with
    ``align_corners``), as the reference sampled; not the half-pixel grid
    of ``F.interpolate``."""

    def __init__(self, output_height: int, output_width: int,
                 align_corners: bool = False):
        super().__init__()
        self.out_hw = (output_height, output_width)
        self.align_corners = align_corners

    def _grid(self, o_size: int, i_size: int, device: torch.device):
        if self.align_corners and o_size > 1:
            scale = (i_size - 1) / (o_size - 1)
        else:
            scale = i_size / o_size
        src = torch.arange(o_size, dtype=torch.float32, device=device) * scale
        lo = torch.clamp(torch.floor(src).to(torch.int64), 0, i_size - 1)
        hi = torch.clamp_max(lo + 1, i_size - 1)
        return lo, hi, src - lo

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[1:3]
        y0, y1, wy = self._grid(self.out_hw[0], h, x.device)
        x0, x1, wx = self._grid(self.out_hw[1], w, x.device)
        xf = x.float()
        wx, wy = wx[None, None, :, None], wy[None, :, None, None]

        def cols(rows):  # [b, oh, w, c] -> [b, oh, ow, c]
            return rows[:, :, x0] * (1.0 - wx) + rows[:, :, x1] * wx

        out = cols(xf[:, y0]) * (1.0 - wy) + cols(xf[:, y1]) * wy
        return out.to(x.dtype)


# -- keras-1 merge API ---------------------------------------------------------

class Merge(nn.Module):
    """Keras-1's ``Merge(mode=...)`` over a list of inputs: sum, mul, ave,
    max, min, concat, dot or cos, the merge layer a child named by the
    mode."""

    def __init__(self, mode: str = "sum", concat_axis: int = -1,
                 dot_axes: Any = -1):
        super().__init__()
        mode = mode.lower()
        table = {"sum": Add, "mul": Multiply, "ave": Average,
                 "max": Maximum, "min": Minimum}
        if mode in table:
            impl: nn.Module = table[mode]()
        elif mode == "concat":
            impl = Concatenate(axis=concat_axis)
        elif mode == "dot":
            impl = Dot(axes=dot_axes)
        elif mode == "cos":
            impl = Cos()
        else:
            raise ValueError(f"unknown merge mode {mode!r}")
        self.mode = mode
        self.add_module(mode, impl)

    def forward(self, inputs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = getattr(self, self.mode)(list(inputs))
        if self.mode == "dot" and out.dim() == 1:
            out = out[:, None]  # keras batch_dot keeps >= 2 dims
        return out


def merge(inputs: Sequence[Any], mode: str = "sum", concat_axis: int = -1,
          dot_axes: Any = -1):
    """Keras-1's ``merge([a, b], mode="sum")``: on tensors, or on the
    symbolic tensors of a functional ``Model`` (then a graph node)."""
    return Merge(mode=mode, concat_axis=concat_axis,
                 dot_axes=dot_axes)(list(inputs))


__all__ = ["ConvLSTM2D", "ConvLSTM3D", "LocallyConnected2D",
           "Conv3DTranspose", "Conv1DTranspose", "SeparableConv1D",
           "AlphaDropout", "Softmax", "ActivityRegularization",
           "WordEmbedding", "LRN2D", "Cos", "Identity", "Exp", "Log",
           "Sqrt", "Square", "Power", "Negative", "AddConstant",
           "MulConstant", "Scale", "Threshold", "HardShrink", "SoftShrink",
           "CAdd", "CMul", "HardTanh", "GaussianSampler", "ResizeBilinear",
           "Merge", "merge", "hard_sigmoid_k1"]
