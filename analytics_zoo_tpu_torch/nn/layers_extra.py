"""The extended layer set of ``analytics_zoo_tpu/nn/layers_extra.py``: 3-D
and transposed convs, depthwise and separable convs, unshared 1-D convs,
the 1-D and 3-D pools, resizing, padding and cropping, the stochastic
regularizers, the parametric activations, the tensor-op layers, the merges
and ``Highway``/``MaxoutDense``.  ``Remat`` lives in ``layers.py``.

Activations are channel-last (NWC, NHWC, NDHWC) as in the JAX package;
the convs run on the channel-first view PyTorch's kernels take.  Input
widths are constructor arguments.  Conv kernels of rank 4 and 5 are OIHW /
OIDHW (``convert`` transposes JAX's HWIO / DHWIO); a transposed conv's
kernel keeps the JAX meaning of its axes, ``(filters, in)`` first, and is
handed to ``conv_transpose`` as ``(in, filters, ...)``.  Kernels of rank 3
(``LocallyConnected1D``, ``MaxoutDense``) keep the JAX layout.

The stochastic layers (``SpatialDropout*``, ``GaussianNoise``,
``GaussianDropout``) are ``Dropout``s: they draw from the model's dropout
generator (``seed_dropout``), so the Estimator seeds, checkpoints and
registers it with its CUDA graphs like any dropout mask's.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from . import activations, initializers
from .layers import (AveragePooling2D, Conv2D, Dropout, MaxPooling2D,
                     _pair, _same_pads)


def _triple(v: Union[int, Sequence[int]]) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)  # type: ignore


def _norm_cropping(cropping: Union[int, Sequence[Any]], ndim: int
                   ) -> Tuple[Tuple[int, int], ...]:
    """int -> symmetric per dim; per-dim entries may be int or (lo, hi)."""
    if isinstance(cropping, int):
        return ((cropping, cropping),) * ndim
    return tuple((c, c) if isinstance(c, int) else tuple(c)
                 for c in cropping)


# -- channel-last convolution of any rank ------------------------------------

def _channels_first(x: torch.Tensor) -> torch.Tensor:
    return x.permute((0, x.dim() - 1) + tuple(range(1, x.dim() - 1)))


def _channels_last(y: torch.Tensor) -> torch.Tensor:
    return y.permute((0,) + tuple(range(2, y.dim())) + (1,))


def _pads_nd(padding: Any, sizes: Sequence[int], window: Sequence[int],
             strides: Sequence[int], dilation: Sequence[int]
             ) -> Tuple[Tuple[int, int], ...]:
    if padding == "VALID":
        return ((0, 0),) * len(sizes)
    if padding == "SAME":
        return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                     zip(sizes, window, strides, dilation))
    return tuple(tuple(p) for p in padding)


def _pad_spatial(x: torch.Tensor, pads: Sequence[Tuple[int, int]],
                 value: float = 0.0) -> torch.Tensor:
    """Pad the spatial dims of a channel-last ``x`` (negative pads crop)."""
    flat = [0, 0]
    for lo, hi in reversed(list(pads)):
        flat += [lo, hi]
    if not any(flat):
        return x
    return F.pad(x, flat, value=value)


def conv_channels_last(x: torch.Tensor, w: torch.Tensor,
                       strides: Sequence[int], padding: Any,
                       dilation: Optional[Sequence[int]] = None,
                       groups: int = 1) -> torch.Tensor:
    """``conv_general_dilated`` over ``[B, *spatial, C]`` with an ``[O,
    I / groups, *window]`` kernel, for 1, 2 or 3 spatial dims; XLA's SAME
    (odd pad at the end), VALID or explicit pads."""
    nd = x.dim() - 2
    dilation = tuple(dilation or (1,) * nd)
    pads = _pads_nd(padding, x.shape[1:-1], w.shape[2:], strides, dilation)
    if all(lo == hi for lo, hi in pads):
        conv_pad = tuple(lo for lo, _ in pads)
    else:
        x = _pad_spatial(x, pads)
        conv_pad = (0,) * nd
    conv = (F.conv1d, F.conv2d, F.conv3d)[nd - 1]
    return _channels_last(conv(_channels_first(x), w, stride=tuple(strides),
                               padding=conv_pad, dilation=dilation,
                               groups=groups))


def deconv_pads(k: int, s: int, padding: str) -> Tuple[int, int]:
    """The JAX package's ``_deconv_pads``: the pads of the direct conv over
    the ``s``-dilated input and the flipped kernel that is Keras's
    transposed conv."""
    if padding == "VALID":
        return (k - 1, k - 1)
    pt = max(k - s, 0)
    return (k - 1 - pt // 2, k - 1 - (pt - pt // 2) + max(s - k, 0))


def deconv_channels_last(x: torch.Tensor, w: torch.Tensor,
                         strides: Sequence[int],
                         padding: str) -> torch.Tensor:
    """Keras's transposed conv (the JAX package's ``_deconv``) over ``[B,
    *spatial, C]`` with ``w`` in ``conv_transpose``'s ``[in, out,
    *window]`` layout.  ``conv_transpose`` with padding ``p`` and output
    padding ``q`` is the direct conv with pads ``(k - 1 - p, k - 1 - p +
    q)``; pads it cannot express (a SAME whose ``k - s`` is odd) come from
    the full output, cropped or extended."""
    ks = tuple(w.shape[2:])
    pads = [deconv_pads(k, s, padding) for k, s in zip(ks, strides)]
    p = [k - 1 - lo for k, (lo, _) in zip(ks, pads)]
    q = [hi - lo for lo, hi in pads]
    tconv = (F.conv_transpose1d, F.conv_transpose2d,
             F.conv_transpose3d)[len(ks) - 1]
    xin = _channels_first(x)
    if all(0 <= o < s for o, s in zip(q, strides)):
        y = tconv(xin, w, stride=tuple(strides), padding=p,
                  output_padding=q)
        return _channels_last(y)
    y = _channels_last(tconv(xin, w, stride=tuple(strides)))
    return _pad_spatial(y, [(lo - (k - 1), hi - (k - 1))
                            for k, (lo, hi) in zip(ks, pads)])


# -- convolution variants ------------------------------------------------------

class _Conv(nn.Module):
    """A conv with a ``kernel`` of ``shape``, an optional ``bias`` of
    ``filters`` and an activation."""

    def __init__(self, shape: Tuple[int, ...], filters: int,
                 activation: Any, use_bias: bool, kernel_init: Any):
        super().__init__()
        self.filters = filters
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


class Conv3D(_Conv):
    """3-D convolution over NDHWC (``layers_extra.py`` Conv3D); the kernel
    is OIDHW."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = "same", activation: Any = None,
                 use_bias: bool = True, kernel_init: Any = "he_normal"):
        self.kernel_size = _triple(kernel_size)
        self.strides = _triple(strides)
        self.padding = padding.upper()
        super().__init__((filters, in_channels) + self.kernel_size, filters,
                         activation, use_bias, kernel_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_channels_last(x, self.kernel.to(x.dtype), self.strides,
                               self.padding)
        return self._out(y)


class Conv2DTranspose(_Conv):
    """Transposed conv over NHWC with Keras's semantics (the gradient of a
    conv, ``layers_zoo.py`` ``_deconv``), not ``lax.conv_transpose``'s
    SAME.  The kernel is ``(filters, in, kh, kw)``: JAX's HWIO ``(kh, kw,
    in, filters)`` as ``convert`` transposes every 4-D kernel."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = "same", activation: Any = None,
                 use_bias: bool = True, kernel_init: Any = "he_normal"):
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding.upper()
        super().__init__((filters, in_channels) + self.kernel_size, filters,
                         activation, use_bias, kernel_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.kernel.to(x.dtype).transpose(0, 1)
        return self._out(deconv_channels_last(x, w, self.strides,
                                              self.padding))


class DepthwiseConv2D(_Conv):
    """Per-channel conv (``layers_extra.py`` DepthwiseConv2D): ``C``
    groups, output channel ``o`` from input channel ``o //
    depth_multiplier``; the kernel is ``(C * depth_multiplier, 1, kh,
    kw)``, JAX's ``(kh, kw, 1, C * depth_multiplier)`` transposed."""

    def __init__(self, in_channels: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = "same", depth_multiplier: int = 1,
                 use_bias: bool = True, kernel_init: Any = "he_normal",
                 activation: Any = None):
        self.in_channels = in_channels
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = padding.upper()
        self.depth_multiplier = depth_multiplier
        out = in_channels * depth_multiplier
        super().__init__((out, 1) + self.kernel_size, out, activation,
                         use_bias, kernel_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv_channels_last(x, self.kernel.to(x.dtype), self.strides,
                               self.padding, groups=self.in_channels)
        return self._out(y)


class SeparableConv2D(nn.Module):
    """Depthwise then pointwise (``layers_extra.py`` SeparableConv2D): the
    children ``depthwise`` (no bias) and ``pointwise`` (a 1x1
    ``Conv2D``)."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: str = "same", depth_multiplier: int = 1,
                 activation: Any = None, use_bias: bool = True):
        super().__init__()
        self.depthwise = DepthwiseConv2D(in_channels, kernel_size, strides,
                                         padding, depth_multiplier,
                                         use_bias=False)
        self.pointwise = Conv2D(in_channels * depth_multiplier, filters, 1,
                                1, "same", activation, use_bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pointwise(self.depthwise(x))


class LocallyConnected1D(nn.Module):
    """Unshared 1-D conv over ``[B, T, C]`` (``layers_extra.py``
    LocallyConnected1D): one ``(kernel_size * C, filters)`` kernel per
    output position, ``kernel`` ``[out_t, k * C, filters]`` and ``bias``
    ``[out_t, filters]``; ``input_length`` fixes ``out_t``."""

    def __init__(self, in_channels: int, input_length: int, filters: int,
                 kernel_size: int, strides: int = 1, activation: Any = None,
                 use_bias: bool = True, kernel_init: Any = "glorot_uniform"):
        super().__init__()
        self.kernel_size, self.strides = kernel_size, strides
        self.out_t = (input_length - kernel_size) // strides + 1
        self.activation = activations.get(activation)
        self.kernel_init = initializers.get(kernel_init)
        self.kernel = nn.Parameter(torch.empty(
            self.out_t, kernel_size * in_channels, filters))
        self.bias = nn.Parameter(torch.empty(self.out_t, filters)) \
            if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c = x.shape[0], x.shape[-1]
        # [B, out_t, C, k] windows -> [B, out_t, k * C] in (k, C) order
        win = x.unfold(1, self.kernel_size, self.strides)[:, :self.out_t]
        win = win.transpose(2, 3).reshape(b, self.out_t,
                                          self.kernel_size * c)
        y = torch.einsum("btk,tkf->btf", win, self.kernel.to(win.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)


# -- pooling variants ----------------------------------------------------------

class MaxPooling1D(nn.Module):
    """A ``(1, pool_size)`` 2-D pool, the child ``pool``, over
    ``x[:, None]``."""

    _pool_cls: type = MaxPooling2D

    def __init__(self, pool_size: int = 2, strides: Optional[int] = None,
                 padding: str = "valid"):
        super().__init__()
        self.pool = self._pool_cls(
            (1, pool_size), (1, strides if strides is not None
                             else pool_size), padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pool(x[:, None])[:, 0]


class AveragePooling1D(MaxPooling1D):
    _pool_cls = AveragePooling2D


class MaxPooling3D(nn.Module):
    """3-D pool over NDHWC, SAME or VALID; the average divides by the real
    pixels under the window (``layers_extra.py`` ``_Pool3D``)."""

    kind = "max"

    def __init__(self, pool_size: Union[int, Sequence[int]] = 2,
                 strides: Optional[Union[int, Sequence[int]]] = None,
                 padding: str = "valid"):
        super().__init__()
        self.pool_size = _triple(pool_size)
        self.strides = (_triple(strides) if strides is not None
                        else self.pool_size)
        self.padding = padding.upper()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        pads = _pads_nd(self.padding, x.shape[1:4], self.pool_size,
                        self.strides, (1, 1, 1))
        if self.kind == "max":
            xp = _pad_spatial(x, pads, float("-inf"))
            return _channels_last(F.max_pool3d(
                _channels_first(xp), self.pool_size, self.strides))
        s = _channels_last(F.avg_pool3d(
            _channels_first(_pad_spatial(x, pads)), self.pool_size,
            self.strides, divisor_override=1))
        ones = _pad_spatial(x.new_ones((1,) + tuple(x.shape[1:4]) + (1,)),
                            pads)
        cnt = _channels_last(F.avg_pool3d(
            _channels_first(ones), self.pool_size, self.strides,
            divisor_override=1))
        return s / cnt


class AveragePooling3D(MaxPooling3D):
    kind = "avg"


class GlobalAveragePooling3D(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2, 3))


class GlobalMaxPooling3D(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=(1, 2, 3))


# -- resizing / padding / cropping ---------------------------------------------

class UpSampling1D(nn.Module):
    def __init__(self, size: int = 2):
        super().__init__()
        self.size = size

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.repeat_interleave(self.size, dim=1)


class UpSampling2D(nn.Module):
    def __init__(self, size: Union[int, Sequence[int]] = 2):
        super().__init__()
        self.size = _pair(size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for axis, n in enumerate(self.size, start=1):
            x = x.repeat_interleave(n, dim=axis)
        return x


class UpSampling3D(UpSampling2D):
    def __init__(self, size: Union[int, Sequence[int]] = 2):
        super().__init__()
        self.size = _triple(size)


class ZeroPadding1D(nn.Module):
    def __init__(self, padding: Union[int, Sequence[int]] = 1):
        super().__init__()
        self.padding = ((padding, padding) if isinstance(padding, int)
                        else tuple(padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pad_spatial(x, [self.padding])


class ZeroPadding3D(nn.Module):
    def __init__(self, padding: Union[int, Sequence[int]] = 1):
        super().__init__()
        self.padding = _triple(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pad_spatial(x, [(p, p) for p in self.padding])


class Cropping1D(nn.Module):
    def __init__(self, cropping: Union[int, Sequence[int]] = 1):
        super().__init__()
        self.cropping = ((cropping, cropping) if isinstance(cropping, int)
                         else tuple(cropping))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, b = self.cropping
        return x[:, a:x.shape[1] - b]


class Cropping2D(nn.Module):
    def __init__(self, cropping: Union[int, Sequence[Any]] = 1):
        super().__init__()
        self.cropping = _norm_cropping(cropping, 2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (t, b), (l, r) = self.cropping
        return x[:, t:x.shape[1] - b, l:x.shape[2] - r]


class Cropping3D(nn.Module):
    def __init__(self, cropping: Union[int, Sequence[Any]] = 1):
        super().__init__()
        self.cropping = _norm_cropping(cropping, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (d0, d1), (h0, h1), (w0, w1) = self.cropping
        return x[:, d0:x.shape[1] - d1, h0:x.shape[2] - h1,
                 w0:x.shape[3] - w1]


# -- shape / sequence utilities ------------------------------------------------

class RepeatVector(nn.Module):
    """``[B, D] -> [B, n, D]``."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[:, None, :].repeat(1, self.n, 1)


class Permute(nn.Module):
    """Permute the non-batch dims, numbered from 1 as in Keras."""

    def __init__(self, dims: Sequence[int]):
        super().__init__()
        self.dims = tuple(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.permute((0,) + self.dims)


class Masking(nn.Module):
    """Zero the timesteps whose every feature equals ``mask_value``."""

    def __init__(self, mask_value: float = 0.0):
        super().__init__()
        self.mask_value = mask_value

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        keep = (x != self.mask_value).any(dim=-1, keepdim=True)
        return torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                device=x.device))


# -- stochastic regularization -------------------------------------------------

class SpatialDropout1D(Dropout):
    """Drop whole channels: one keep/drop draw a (sample, channel), the
    kept ones scaled by ``1 / (1 - rate)``."""

    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], 1, x.shape[-1])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        mask = torch.empty(self._mask_shape(x), dtype=x.dtype,
                           device=x.device).bernoulli_(
            keep, generator=self.generator_for(x.device))
        return x * mask / keep


class SpatialDropout2D(SpatialDropout1D):
    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], 1, 1, x.shape[-1])


class SpatialDropout3D(SpatialDropout1D):
    def _mask_shape(self, x: torch.Tensor) -> Tuple[int, ...]:
        return (x.shape[0], 1, 1, 1, x.shape[-1])


def _normal_like(layer: Dropout, x: torch.Tensor) -> torch.Tensor:
    return torch.empty_like(x).normal_(
        generator=layer.generator_for(x.device))


class GaussianNoise(Dropout):
    """``x + stddev * N(0, 1)`` in training, ``x`` otherwise."""

    def __init__(self, stddev: float):
        super().__init__(0.0)
        self.stddev = float(stddev)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.stddev <= 0.0:
            return x
        return x + self.stddev * _normal_like(self, x)


class GaussianDropout(Dropout):
    """``x * (1 + sqrt(rate / (1 - rate)) * N(0, 1))`` in training."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        std = (self.rate / (1.0 - self.rate)) ** 0.5
        return x * (1.0 + std * _normal_like(self, x))


# -- parametric activations ----------------------------------------------------

class LeakyReLU(nn.Module):
    def __init__(self, alpha: float = 0.3):
        super().__init__()
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha * x)


class ELU(nn.Module):
    def __init__(self, alpha: float = 1.0):
        super().__init__()
        self.alpha = alpha

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        neg = torch.where(x > 0, torch.zeros_like(x), x)
        return torch.where(x > 0, x, self.alpha * torch.expm1(neg))


class ThresholdedReLU(nn.Module):
    def __init__(self, theta: float = 1.0):
        super().__init__()
        self.theta = theta

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x > self.theta, x, torch.zeros_like(x))


class SReLU(nn.Module):
    """S-shaped ReLU with four ``[C]`` parameters: ``t_left``, ``a_left``
    (zeros), ``t_right``, ``a_right`` (ones)."""

    def __init__(self, dim: int):
        super().__init__()
        self.t_left = nn.Parameter(torch.zeros(dim))
        self.a_left = nn.Parameter(torch.zeros(dim))
        self.t_right = nn.Parameter(torch.ones(dim))
        self.a_right = nn.Parameter(torch.ones(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tl, al = self.t_left.to(x.dtype), self.a_left.to(x.dtype)
        tr, ar = self.t_right.to(x.dtype), self.a_right.to(x.dtype)
        below = tl + al * (x - tl)
        above = tr + ar * (x - tr)
        return torch.where(x < tl, below, torch.where(x > tr, above, x))


class PReLU(nn.Module):
    """Learnable leaky slope ``alpha`` ``[C]`` (zeros)."""

    def __init__(self, dim: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.alpha.to(x.dtype) * x)


# -- tensor-op layers ----------------------------------------------------------

class Select(nn.Module):
    """Index ``index`` of dim ``dim``."""

    def __init__(self, dim: int, index: int):
        super().__init__()
        self.dim, self.index = dim, index

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        size = x.shape[self.dim]
        if not -size <= self.index < size:
            raise ValueError(f"Select index {self.index} out of range for "
                             f"dim {self.dim} of size {size}")
        return x.select(self.dim, self.index)


class Narrow(nn.Module):
    """``length`` elements of dim ``dim`` from ``offset`` (``-1``: to the
    end)."""

    def __init__(self, dim: int, offset: int, length: int = 1):
        super().__init__()
        self.dim, self.offset, self.length = dim, offset, length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        stop = (x.shape[self.dim] if self.length == -1
                else self.offset + self.length)
        return x.narrow(self.dim, self.offset, stop - self.offset)


class Squeeze(nn.Module):
    """Drop size-1 dims (``dim``, or every one but the batch dim)."""

    def __init__(self, dim: Optional[Union[int, Sequence[int]]] = None):
        super().__init__()
        self.dim = dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.dim is not None:
            dims = (self.dim,) if isinstance(self.dim, int) else self.dim
            for d in sorted((d % x.dim() for d in dims), reverse=True):
                if x.shape[d] != 1:
                    raise ValueError(f"cannot squeeze dim {d} of size "
                                     f"{x.shape[d]}")
                x = x.squeeze(d)
            return x
        for d in range(x.dim() - 1, 0, -1):
            if x.shape[d] == 1:
                x = x.squeeze(d)
        return x


# -- merge layers --------------------------------------------------------------

class Average(nn.Module):
    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return sum(xs) / len(xs)


class Maximum(nn.Module):
    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = xs[0]
        for x in xs[1:]:
            out = torch.maximum(out, x)
        return out


class Minimum(nn.Module):
    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = xs[0]
        for x in xs[1:]:
            out = torch.minimum(out, x)
        return out


class Subtract(nn.Module):
    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        if len(xs) != 2:
            raise ValueError("Subtract takes exactly 2 inputs")
        return xs[0] - xs[1]


class Dot(nn.Module):
    """Batched dot (``layers_extra.py`` Dot): a's axis ``i`` against b's
    axis ``j``, dim 0 the shared batch, the other dims a's then b's."""

    def __init__(self, axes: Union[int, Sequence[int]] = -1,
                 normalize: bool = False):
        super().__init__()
        self.axes = (axes, axes) if isinstance(axes, int) else tuple(axes)
        self.normalize = normalize

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        a, b = xs
        ia, ib = self.axes[0] % a.dim(), self.axes[1] % b.dim()
        if ia == 0 or ib == 0:
            raise ValueError("Dot cannot contract the batch dim (axis 0)")
        if self.normalize:
            a = a / (torch.linalg.vector_norm(a, dim=ia, keepdim=True)
                     + 1e-12)
            b = b / (torch.linalg.vector_norm(b, dim=ib, keepdim=True)
                     + 1e-12)
        letters = "abcdefghijklmnopqrstuvwxy"
        sub_a = ["z"] + [letters[i - 1] for i in range(1, a.dim())]
        sub_b = ["z"] + [letters[a.dim() - 1 + i - 1]
                         for i in range(1, b.dim())]
        sub_a[ia] = sub_b[ib] = "K"
        out = [c for c in sub_a[1:] if c != "K"] + \
              [c for c in sub_b[1:] if c != "K"]
        spec = (f"z{''.join(sub_a[1:])},z{''.join(sub_b[1:])}->"
                f"z{''.join(out)}")
        return torch.einsum(spec, a, b)


# -- BigDL/zoo extras ----------------------------------------------------------

class Highway(nn.Module):
    """``t * h + (1 - t) * x`` with ``h = act(x W + b)`` and ``t =
    sigmoid(x W_g + b_g)``; ``gate_bias`` starts at -1 (mostly carry)."""

    def __init__(self, dim: int, activation: Any = "relu"):
        super().__init__()
        self.activation = activations.get(activation)
        self.kernel = nn.Parameter(torch.empty(dim, dim))
        self.bias = nn.Parameter(torch.empty(dim))
        self.gate_kernel = nn.Parameter(torch.empty(dim, dim))
        self.gate_bias = nn.Parameter(torch.empty(dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        initializers.glorot_uniform(self.kernel, generator)
        initializers.zeros(self.bias)
        initializers.glorot_uniform(self.gate_kernel, generator)
        with torch.no_grad():
            self.gate_bias.fill_(-1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.activation(x @ self.kernel.to(x.dtype)
                            + self.bias.to(x.dtype))
        t = torch.sigmoid(x @ self.gate_kernel.to(x.dtype)
                          + self.gate_bias.to(x.dtype))
        return t * h + (1.0 - t) * x


class MaxoutDense(nn.Module):
    """The max over ``nb_feature`` linear pieces: ``kernel`` ``[k, in,
    units]``, ``bias`` ``[k, units]``."""

    def __init__(self, in_features: int, units: int, nb_feature: int = 4,
                 use_bias: bool = True):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(nb_feature, in_features,
                                               units))
        self.bias = nn.Parameter(torch.empty(nb_feature, units)) \
            if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        initializers.glorot_uniform(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.einsum("bd,kdu->bku", x, self.kernel.to(x.dtype))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y.amax(dim=1)


__all__ = [
    "Conv3D", "Conv2DTranspose", "DepthwiseConv2D", "SeparableConv2D",
    "LocallyConnected1D", "MaxPooling1D", "AveragePooling1D",
    "MaxPooling3D", "AveragePooling3D", "GlobalAveragePooling3D",
    "GlobalMaxPooling3D", "UpSampling1D", "UpSampling2D", "UpSampling3D",
    "ZeroPadding1D", "ZeroPadding3D", "Cropping1D", "Cropping2D",
    "Cropping3D", "RepeatVector", "Permute", "Masking", "SpatialDropout1D",
    "SpatialDropout2D", "SpatialDropout3D", "GaussianNoise",
    "GaussianDropout", "LeakyReLU", "ELU", "ThresholdedReLU", "SReLU",
    "PReLU", "Select", "Narrow", "Squeeze", "Average", "Maximum",
    "Minimum", "Subtract", "Dot", "Highway", "MaxoutDense"]
