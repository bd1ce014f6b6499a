"""Core layers: every class of ``analytics_zoo_tpu.nn.layers`` (``Dense``,
``Embedding``, ``Dropout``, ``LayerNormalization``, the convs, the pools,
``Flatten``, ``Reshape``, ``Activation``, ``Lambda``, ``ZeroPadding2D``,
``BatchNormalization``, the merges ``Concatenate``/``Add``/``Multiply``,
``Sequential``) and ``Remat`` (``nn/layers_extra.py``).

Parameter names are the JAX package's, so a JAX tree converted by
``convert.from_jax_variables`` loads with ``load_state_dict``: Dense
``kernel`` is ``(in, out)``, a conv ``kernel`` is OIHW (the converter
transposes JAX's HWIO), LayerNorm and BatchNorm have ``gamma``/``beta``,
BatchNorm's running statistics are the buffers ``mean``/``var`` (the JAX
``state``), Embedding has ``embeddings``.  Input widths are
constructor arguments (PyTorch builds parameters eagerly; JAX inferred them
from the first input).  Each layer draws its initial values in
``reset_parameters(generator)``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from . import activations, initializers, quant


class Dense(nn.Module):
    """Fully connected layer: the matmul runs in the input's dtype, the bias
    (where ``use_bias``) is added in the output's dtype (as ``layers.py``
    Dense does).  ``activation`` is a name of ``activations`` or a
    callable; ``kernel_init`` and ``bias_init`` a name of ``initializers``
    or a callable ``(tensor, generator) -> tensor``."""

    def __init__(self, in_features: int, units: int,
                 activation: Union[str, Callable, None] = None,
                 use_bias: bool = True,
                 kernel_init: Union[str, Callable] = "glorot_uniform",
                 bias_init: Union[str, Callable] = "zeros"):
        super().__init__()
        self.in_features = in_features
        self.units = units
        self.activation = activations.get(activation)
        self.use_bias = use_bias
        self.kernel_init = initializers.get(kernel_init)
        self.bias_init = initializers.get(bias_init)
        self.kernel = nn.Parameter(torch.empty(in_features, units))
        self.bias = nn.Parameter(torch.empty(units)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            self.bias_init(self.bias, generator)

    def extra_repr(self) -> str:
        act = getattr(self.activation, "__name__", repr(self.activation))
        return (f"in_features={self.in_features}, units={self.units}, "
                f"activation={act}, use_bias={self.use_bias}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # an int8 serving context may observe x or take the int8 product
        y = quant.dense(self, x)
        if y is None:
            y = x @ self.kernel.to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)


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


# set on the thread that runs a Remat block's recompute in the backward
_recompute = threading.local()


def recomputing() -> bool:
    """True inside a ``Remat`` block's recompute: a layer must not update its
    buffers there, or a step would update them twice."""
    return getattr(_recompute, "depth", 0) > 0


def _rewound_generators(gens: List[torch.Generator]):
    """``context_fn`` for ``torch.utils.checkpoint``: the forward records
    the generators' states, and the recompute in the backward starts from
    them (so every dropout mask repeats), runs with ``recomputing()`` true
    (so batch norm leaves its running statistics alone) and restores the
    generators to where they were before the recompute."""
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
        _recompute.depth = getattr(_recompute, "depth", 0) + 1
        try:
            yield
        finally:
            _recompute.depth -= 1
            for g, st in zip(gens, now):
                g.set_state(st)

    return forward(), recompute()


class Remat(nn.Module):
    """Gradient checkpointing wrapper (port of ``nn.Remat``): the wrapped
    module's activations are recomputed in the backward instead of stored.
    The inner module sits under its own ``name``, as in the JAX tree
    (``remat_0/layer_0/...``).  The recompute repeats the forward's dropout
    masks and updates no buffer: a batch norm inside updates its running
    statistics once a step, as under ``jax.checkpoint``.  It does run its
    forward kernels again, so ``ops.fused_bn``'s launch counts include the
    recompute: two forward launches a step for such a norm, one backward."""

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


# -- convolution / pooling (NHWC) ---------------------------------------------
#
# Activations stay logical NHWC, as in the JAX package.  A permute of a
# contiguous NHWC tensor to NCHW is a channels_last view (no copy), which
# is what F.conv2d and the pools run on; their channels_last output
# permutes back to contiguous NHWC, again without a copy.  Conv kernels are
# OIHW (PyTorch's layout); convert.py maps them from and to JAX's HWIO.

Pads = Tuple[Tuple[int, int], Tuple[int, int]]


def _pair(v: Union[int, Sequence[int]]) -> Tuple[int, int]:
    return (v, v) if isinstance(v, int) else tuple(v)  # type: ignore


def _norm_padding(p: Any) -> Any:
    """'same'/'valid' -> upper string; int / (h, w) / ((lo, hi), (lo, hi))
    -> explicit per-dimension pad pairs (``layers.py``'s rule)."""
    if isinstance(p, str):
        return p.upper()
    if isinstance(p, int):
        return ((p, p), (p, p))
    p = tuple(p)
    if all(isinstance(e, int) for e in p):
        return tuple((e, e) for e in p)
    return tuple((int(a), int(b)) for a, b in p)


def _same_pads(size: int, window: int, stride: int, dilation: int = 1
               ) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: the output is ceil(size /
    stride) and the odd pad goes at the end (a 3x3/s2 on an even size pads
    (0, 1), the 7x7/s2 stem on 224 (2, 3))."""
    eff = (window - 1) * dilation + 1
    total = max((-(-size // stride) - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


def _resolve_pads(padding: Any, hw: Tuple[int, int], window: Tuple[int, int],
                  strides: Tuple[int, int],
                  dilation: Tuple[int, int] = (1, 1)) -> Pads:
    if padding == "VALID":
        return ((0, 0), (0, 0))
    if padding == "SAME":
        return tuple(_same_pads(n, k, s, d) for n, k, s, d in
                     zip(hw, window, strides, dilation))  # type: ignore
    return padding


def _pad_nhwc(x: torch.Tensor, pads: Pads, value: float = 0.0
              ) -> torch.Tensor:
    (t, b), (l, r) = pads
    if t == b == l == r == 0:
        return x
    return F.pad(x, (0, 0, l, r, t, b), value=value)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def conv2d_nhwc(x: torch.Tensor, w: torch.Tensor, strides: Tuple[int, int],
                padding: Any, dilation: Tuple[int, int] = (1, 1),
                groups: int = 1) -> torch.Tensor:
    """``conv_general_dilated(x, w, strides, padding, rhs_dilation,
    ("NHWC", "HWIO", "NHWC"), groups)`` with ``w`` OIHW: cuDNN on the
    channels_last view.  Symmetric pads go to the conv, asymmetric ones
    (SAME with an odd total) to an explicit ``F.pad`` first."""
    pads = _resolve_pads(padding, tuple(x.shape[1:3]), tuple(w.shape[2:]),
                         strides, dilation)
    (t, b), (l, r) = pads
    conv_pad = (0, 0)
    if t == b and l == r:
        conv_pad = (t, l)
    else:
        x = _pad_nhwc(x, pads)
    y = F.conv2d(_nchw(x), w, stride=strides, padding=conv_pad,
                 dilation=dilation, groups=groups)
    return _nhwc(y)


class Conv2D(nn.Module):
    """2-D convolution over NHWC activations with an OIHW ``kernel``
    (``layers.py`` Conv2D).  ``padding``: "same" (XLA's, odd pad at the
    end), "valid", or explicit numbers as the JAX layer takes them.  A
    1x1/s1 unpadded conv runs as a matmul over the flattened positions, as
    in the JAX package.  ``dtype`` casts input and kernel for the compute;
    the output comes back in the input's dtype."""

    def __init__(self, in_channels: int, filters: int,
                 kernel_size: Union[int, Sequence[int]],
                 strides: Union[int, Sequence[int]] = 1,
                 padding: Any = "same", activation: Optional[str] = None,
                 use_bias: bool = True, kernel_init: str = "he_normal",
                 dilation: Union[int, Sequence[int]] = 1, groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if in_channels % groups or filters % groups:
            raise ValueError(f"groups={groups} must divide in_channels "
                             f"{in_channels} and filters {filters}")
        self.filters = filters
        self.kernel_size = _pair(kernel_size)
        self.strides = _pair(strides)
        self.padding = _norm_padding(padding)
        self.activation = activations.get(activation)
        self.use_bias = use_bias
        self.kernel_init = initializers.get(kernel_init)
        self.dilation = _pair(dilation)
        self.groups = groups
        self.dtype = dtype
        kh, kw = self.kernel_size
        self.kernel = nn.Parameter(torch.empty(filters, in_channels // groups,
                                               kh, kw))
        self.bias = nn.Parameter(torch.empty(filters)) if use_bias else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.kernel_init(self.kernel, generator)
        if self.bias is not None:
            initializers.zeros(self.bias)

    def _kernel(self) -> torch.Tensor:
        """The kernel the conv consumes (a subclass may transform it)."""
        return self.kernel

    # plain Conv2D takes part in calibrated int8 serving; a subclass that
    # transforms its kernel (ScaledWSConv2D) opts out
    _act_quant = True

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = quant.conv(self, x)
        if y is None:
            y = self._float_conv(x, self._kernel())
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return self.activation(y)

    def _float_conv(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        xc = x if self.dtype is None else x.to(self.dtype)
        wc = (w if self.dtype is None else w.to(self.dtype)).to(xc.dtype)
        pad_free = (self.padding in ("SAME", "VALID")
                    or all(p == (0, 0) for p in self.padding))
        if (self.kernel_size == (1, 1) and self.strides == (1, 1)
                and pad_free and self.dilation == (1, 1)
                and self.groups == 1):
            y = F.linear(xc.reshape(-1, xc.shape[-1]),
                         wc.reshape(self.filters, -1))
            y = y.reshape(*x.shape[:-1], self.filters)
        else:
            y = conv2d_nhwc(xc, wc, self.strides, self.padding,
                            self.dilation, self.groups)
        return y.to(x.dtype)


def scaled_ws_kernel(w: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    """Scaled Weight Standardization of an OIHW kernel (``layers.py``
    ``scaled_ws_kernel``): ``gain_o * (W - mean_o) / (std_o *
    sqrt(fan_in))`` with statistics over each output channel's fan in
    (dims 1, 2, 3; HWIO's 0, 1, 2)."""
    fan_in = w[0].numel()
    mean = w.mean(dim=(1, 2, 3), keepdim=True)
    var = w.var(dim=(1, 2, 3), keepdim=True, unbiased=False)
    scale = torch.rsqrt(torch.clamp_min(var * fan_in, 1e-4))
    return (w - mean) * (scale * gain.reshape(-1, 1, 1, 1))


class ScaledWSConv2D(Conv2D):
    """Conv2D whose kernel is standardized per output channel with a
    learnable ``ws_gain`` (``layers.py`` ScaledWSConv2D).  ``skip_init``
    folds a zero-initialised scalar ``skip_gain`` (times ``branch_scale``)
    into the gain: a conv is linear in its weights, so this is the SkipInit
    residual scale with its gradient taken in weight space."""

    _act_quant = False  # weight standardization needs the float kernel

    def __init__(self, *args: Any, skip_init: bool = False,
                 branch_scale: float = 1.0, **kwargs: Any):
        self.skip_init = skip_init
        self.branch_scale = branch_scale
        super().__init__(*args, **kwargs)
        self.ws_gain = nn.Parameter(torch.empty(self.filters))
        self.skip_gain = nn.Parameter(torch.empty(())) if skip_init else None
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        if hasattr(self, "ws_gain"):
            initializers.ones(self.ws_gain)
        if getattr(self, "skip_gain", None) is not None:
            initializers.zeros(self.skip_gain)

    def _kernel(self) -> torch.Tensor:
        gain = self.ws_gain
        if self.skip_gain is not None:
            gain = gain * (self.skip_gain * self.branch_scale)
        return scaled_ws_kernel(self.kernel, gain)


class Conv1D(nn.Module):
    """1-D convolution over ``[B, T, C]`` (``layers.py`` Conv1D): the child
    ``conv``, a ``Conv2D`` with kernel ``(1, k)``, stride ``(1, s)`` and
    dilation ``(1, d)``, run on ``x[:, None]``; its kernel is the JAX
    package's 4-D ``[1, k, Cin, Cout]``, OIHW here."""

    def __init__(self, in_channels: int, filters: int, kernel_size: int,
                 strides: int = 1, padding: Any = "same",
                 activation: Optional[str] = None, use_bias: bool = True,
                 kernel_init: str = "he_normal", dilation: int = 1):
        super().__init__()
        self.conv = Conv2D(in_channels, filters, (1, kernel_size),
                           (1, strides), padding, activation, use_bias,
                           kernel_init, (1, dilation))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x[:, None])[:, 0]


def _pool(x: torch.Tensor, kind: str, window: Tuple[int, int],
          strides: Tuple[int, int], padding: Any) -> torch.Tensor:
    """``layers.py`` ``_pool`` over NHWC: max pads with -inf; average
    divides by the count of real pixels under SAME and by the full window
    under VALID or explicit pads (torch's count_include_pad)."""
    pads = _resolve_pads(padding, tuple(x.shape[1:3]), window, strides)
    if kind == "max":
        xp = _pad_nhwc(x, pads, value=float("-inf"))
        return _nhwc(F.max_pool2d(_nchw(xp), window, strides))
    s = _nhwc(F.avg_pool2d(_nchw(_pad_nhwc(x, pads)), window, strides,
                           divisor_override=1))
    if padding != "SAME":
        return s / (window[0] * window[1])
    ones = _pad_nhwc(x.new_ones((1,) + tuple(x.shape[1:3]) + (1,)), pads)
    cnt = _nhwc(F.avg_pool2d(_nchw(ones), window, strides,
                             divisor_override=1))
    return s / cnt


class MaxPooling2D(nn.Module):
    def __init__(self, pool_size: Union[int, Sequence[int]] = 2,
                 strides: Optional[Union[int, Sequence[int]]] = None,
                 padding: Any = "valid"):
        super().__init__()
        self.pool_size = _pair(pool_size)
        self.strides = _pair(strides) if strides is not None \
            else self.pool_size
        self.padding = _norm_padding(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(x, "max", self.pool_size, self.strides, self.padding)


class AveragePooling2D(MaxPooling2D):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _pool(x, "avg", self.pool_size, self.strides, self.padding)


class GlobalAveragePooling2D(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2))


class GlobalMaxPooling2D(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=(1, 2))


class GlobalAveragePooling1D(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=1)


class GlobalMaxPooling1D(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.amax(dim=1)


class Flatten(nn.Module):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], -1)


class Reshape(nn.Module):
    """``[B, ...] -> [B, *target_shape]``."""

    def __init__(self, target_shape: Sequence[int]):
        super().__init__()
        self.target_shape = tuple(target_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape((x.shape[0],) + self.target_shape)


class Activation(nn.Module):
    """An activation of ``activations`` (or any callable) as a layer."""

    def __init__(self, activation: Union[str, Callable]):
        super().__init__()
        self.fn = activations.get(activation)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class Lambda(nn.Module):
    """A function of the inputs as a layer (``layers.py`` Lambda).
    ``name``, where given, names its node in a functional ``Model``."""

    def __init__(self, fn: Callable, name: Optional[str] = None):
        super().__init__()
        self.fn = fn
        self.name = name

    def forward(self, *args: Any) -> Any:
        return self.fn(*args)


class ZeroPadding2D(nn.Module):
    def __init__(self, padding: Union[int, Sequence[int]] = 1):
        super().__init__()
        self.padding = _pair(padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        ph, pw = self.padding
        return _pad_nhwc(x, ((ph, ph), (pw, pw)))


# -- normalization -------------------------------------------------------------

class BatchNormalization(nn.Module):
    """Batch norm with running statistics in the buffers ``mean`` and
    ``var`` (the JAX package's ``state``), momentum 0.99 and epsilon 1e-3 by
    default (``layers.py`` BatchNormalization).

    Training updates the buffers in place to ``m * run + (1 - m) * batch``
    with the biased batch variance; that is not ``torch.nn.BatchNorm2d``'s
    rule (its momentum is the complement and its running variance
    unbiased).  Channel-last training runs ``train_fn``, the fused
    ``ops.fused_bn.bn_train`` (the CUDA kernels on the card); training over
    another axis takes the inline shifted f32 moments.  The normalize of
    that path and of eval is the rounding-compensated one, in the
    activation's dtype.

    ``group``: the ``torch.distributed`` data group whose ranks hold one
    global batch in equal parts (set by the Estimator over several
    processes; None in one process): training then normalizes by the
    global batch's moments, through ``fused_bn.bn_train``'s split form
    (any axis: the channel axis is moved last for it)."""

    def __init__(self, dim: int, momentum: float = 0.99,
                 epsilon: float = 1e-3, center: bool = True,
                 scale: bool = True, axis: int = -1):
        super().__init__()
        from ..ops import fused_bn
        self.momentum = momentum
        self.epsilon = epsilon
        self.axis = axis
        self.train_fn = fused_bn.bn_train
        self.group = None
        self.gamma = nn.Parameter(torch.empty(dim)) if scale else None
        self.beta = nn.Parameter(torch.empty(dim)) if center else None
        self.register_buffer("mean", torch.zeros(dim))
        self.register_buffer("var", torch.ones(dim))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        if self.gamma is not None:
            initializers.ones(self.gamma)
        if self.beta is not None:
            initializers.zeros(self.beta)

    @torch.no_grad()
    def _update(self, mean: torch.Tensor, var: torch.Tensor) -> None:
        if recomputing():  # the forward of this step already updated them
            return
        m = self.momentum
        self.mean.copy_(m * self.mean + (1 - m) * mean)
        self.var.copy_(m * self.var + (1 - m) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.axis % x.dim()
        dim = x.shape[axis]
        if self.training and (axis == x.dim() - 1 or self.group is not None):
            gamma = self.gamma if self.gamma is not None \
                else self.mean.new_ones(dim)
            beta = self.beta if self.beta is not None \
                else self.mean.new_zeros(dim)
            xl = x if axis == x.dim() - 1 else x.movedim(axis, -1)
            if self.group is None:
                y, mean, var = self.train_fn(xl, gamma, beta, self.epsilon)
            else:
                y, mean, var = self.train_fn(xl, gamma, beta, self.epsilon,
                                             group=self.group)
            self._update(mean.detach(), var.detach())
            return y if axis == x.dim() - 1 else y.movedim(-1, axis)
        shape = [1] * x.dim()
        shape[axis] = dim
        if self.training:
            # f32 moments shifted by one stop-gradded sample per channel
            # (shift-invariant, so values and gradients are the unshifted
            # ones); gradients flow through mean and var
            red = tuple(i for i in range(x.dim()) if i != axis)
            xf = x.float()
            idx = tuple(0 if i in red else slice(None)
                        for i in range(x.dim()))
            shift = xf[idx].detach().reshape(shape)
            xc = xf - shift
            mean_c = xc.mean(dim=red)
            var = torch.clamp_min(xc.square().mean(dim=red)
                                  - mean_c.square(), 0.0)
            mean = mean_c + shift.reshape(-1)
            self._update(mean.detach(), var.detach())
        else:
            mean, var = self.mean, self.var
        inv = torch.rsqrt(var + self.epsilon)
        if self.gamma is not None:
            inv = inv * self.gamma
        mean_c = mean.to(x.dtype)
        sh = (mean_c.float() - mean) * inv
        if self.beta is not None:
            sh = sh + self.beta
        y = (x - mean_c.reshape(shape)) * inv.to(x.dtype).reshape(shape)
        return y + sh.to(x.dtype).reshape(shape)


# -- merge layers: each takes one list of tensors -------------------------------

class Concatenate(nn.Module):
    def __init__(self, axis: int = -1):
        super().__init__()
        self.axis = axis

    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        return torch.cat(list(xs), dim=self.axis)


class Add(nn.Module):
    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = xs[0]
        for x in xs[1:]:
            out = out + x
        return out


class Multiply(nn.Module):
    def forward(self, xs: Sequence[torch.Tensor]) -> torch.Tensor:
        out = xs[0]
        for x in xs[1:]:
            out = out * x
        return out


# -- containers ----------------------------------------------------------------

class Sequential(nn.Module):
    """Linear stack of layers (``layers.py`` Sequential): layer ``i`` sits
    under ``f"{i:02d}_layer{i}"``, the JAX tree's name for an unnamed
    layer, or under the name given with it as a ``(name, layer)`` pair."""

    def __init__(self, layers: Optional[Sequence[Any]] = None):
        super().__init__()
        self._names: List[str] = []
        for layer in layers or []:
            self.add(layer)

    def add(self, layer: Any) -> "Sequential":
        i = len(self._names)
        name, layer = layer if isinstance(layer, tuple) \
            else (f"{i:02d}_layer{i}", layer)
        self.add_module(name, layer)
        self._names.append(name)
        return self

    def forward(self, x: Any) -> Any:
        for name in self._names:
            x = getattr(self, name)(x)
        return x
