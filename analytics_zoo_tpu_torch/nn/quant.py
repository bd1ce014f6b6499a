"""Int8 serving: int8 weights and static int8 activation quantization (port
of ``analytics_zoo_tpu/nn/quant.py``).

Weights.  ``InferenceModel.load(dtype="int8")`` stores every large float
leaf as the JAX package's int8 leaf, ``{__int8_weight__, q, scale}``: here
an ``Int8Weight`` submodule under the weight's own name, whose parameters
carry those three names (so its ``state_dict`` keys are the converted JAX
tree's).  ``install`` puts them in place and gives the owning module a
class of the same name whose attribute lookup turns an ``Int8Weight`` into
its bf16 dequantization, ``q.to(bf16) * scale.to(bf16)``, on every access,
as the JAX package's ``_dequantize_tree`` does inside every forward.  A
layer thus reads ``self.kernel`` as before and sees the weight-only form;
storage on the card stays int8.

Activations.  A calibration forward under a ``Calibrator`` records the
input absolute maximum of each ``Dense`` and plain ``Conv2D`` (keyed by the
module's qualified name with ``/`` for ``.``, the JAX scope path); serving
under a ``QuantApply`` quantizes those inputs with the frozen static scale
and runs the product as int8 x int8 -> int32 (``torch._int_mm``), then one
per-output-channel rescale to bf16.  ``ScaledWSConv2D`` opts out (its
weight standardization needs the float kernel), as do the raw projection
parameters of attention, the embeddings and the recurrent layers' kernels
(``nn/recurrent.py``), which only ever see the weight-only form.
``using`` makes a context visible to the layers of one forward on the
calling thread; no model's ``forward`` signature changes.

The int8 products are exact in both packages, so the port's int8 outputs
differ from the JAX package's only in the order of bf16 roundings.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import _launches

MARKER = "__int8_weight__"
COMPUTE_DTYPE = torch.bfloat16


class Int8Weight(nn.Module):
    """One int8 weight in the port's layout: ``q`` int8 and ``scale`` f32
    per the JAX leaf's last axis (a conv kernel's output channels: OIHW
    ``q`` with a ``[O, 1, 1, 1]`` scale), and the marker.  ``k_major``
    keeps a 2-D ``q`` (a Dense kernel, ``(in, out)``) with its ``in`` axis
    contiguous, the layout cuBLASLt's int8 kernels take without a copy.
    ``was_buffer`` records whether the float weight it replaced was a
    buffer."""

    def __init__(self, q_shape, scale_shape, was_buffer: bool = False,
                 k_major: bool = False):
        super().__init__()
        self.was_buffer = was_buffer
        q = torch.zeros(tuple(q_shape)[::-1], dtype=torch.int8).t() \
            if k_major else torch.zeros(q_shape, dtype=torch.int8)
        self.q = nn.Parameter(q, requires_grad=False)
        self.scale = nn.Parameter(torch.ones(scale_shape),
                                  requires_grad=False)
        self.register_parameter(MARKER, nn.Parameter(
            torch.ones((), dtype=torch.int8), requires_grad=False))

    def dequantize(self, dtype: torch.dtype) -> torch.Tensor:
        return self.q.to(dtype) * self.scale.to(dtype)


_INT8_CLASSES: Dict[type, type] = {}


def _int8_class(cls: type) -> type:
    """``cls`` under its own name, with an ``Int8Weight`` child read back
    as its bf16 dequantization."""
    sub = _INT8_CLASSES.get(cls)
    if sub is None:
        def __getattr__(self, name):
            w = self.__dict__["_modules"].get(name)
            if isinstance(w, Int8Weight):
                return w.dequantize(COMPUTE_DTYPE)
            return super(sub, self).__getattr__(name)

        sub = type(cls.__name__, (cls,), {
            "__getattr__": __getattr__, "__module__": cls.__module__,
            "__qualname__": cls.__qualname__, "_int8_base": cls})
        _INT8_CLASSES[cls] = sub
    return sub


def base_class(module: nn.Module) -> type:
    """The class ``module`` was built as (``install`` may have swapped it)."""
    cls = type(module)
    return cls.__dict__.get("_int8_base", cls)


def _owner(model: nn.Module, key: str) -> Tuple[nn.Module, str]:
    *path, name = key.split(".")
    return model.get_submodule(".".join(path)), name


def install(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """Load ``state`` into ``model`` where some weights are int8 leaves
    (keys ``X.q``, ``X.scale`` and ``X.__int8_weight__``): each such ``X``
    becomes an ``Int8Weight``; every other tensor keeps the dtype it has in
    ``state`` (bf16 for the small leaves).  Strict, as ``load_state_dict``
    is."""
    suffix = "." + MARKER
    for key in [k for k in state if k.endswith(suffix)]:
        base = key[:-len(suffix)]
        owner, name = _owner(model, base)
        was_buffer = name in owner._buffers
        delattr(owner, name)
        q_shape = state[base + ".q"].shape
        owner.add_module(name, Int8Weight(
            q_shape, state[base + ".scale"].shape, was_buffer,
            k_major=name == "kernel" and len(q_shape) == 2))
        owner.__class__ = _int8_class(base_class(owner))
    current = model.state_dict(keep_vars=True)
    for key, t in state.items():
        cur = current.get(key)
        if cur is not None and cur.dtype != t.dtype:
            cur.data = cur.data.to(t.dtype)
    model.load_state_dict(state, strict=True)


def uninstall(model: nn.Module) -> None:
    """Undo ``install``: every ``Int8Weight`` becomes a float weight of its
    shape again (values undefined until the next load) and every module
    its own class."""
    for module in list(model.modules()):
        for name, child in list(module._modules.items()):
            if isinstance(child, Int8Weight):
                delattr(module, name)
                empty = torch.empty(child.q.shape, device=child.q.device)
                if child.was_buffer:
                    module.register_buffer(name, empty)
                else:
                    module.register_parameter(name, nn.Parameter(empty))
        module.__class__ = base_class(module)


def module_paths(model: nn.Module) -> Dict[int, str]:
    """Each submodule's key: its qualified name with ``/`` for ``.``, the
    JAX package's scope path."""
    return {id(m): name.replace(".", "/") for name, m in model.named_modules()}


# -- contexts --------------------------------------------------------------

class Calibrator:
    """Collect mode: each participating layer's input absolute maximum, by
    key, over one or more float forwards run eagerly."""

    mode = "collect"

    def __init__(self):
        self.amax: Dict[str, float] = {}

    def observe(self, key: str, x: torch.Tensor) -> None:
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "int8 calibration must run eagerly: the Calibrator reads "
                "activation ranges back to the host, which a CUDA graph "
                f"capture cannot (layer {key}). Run the calibration forward "
                "outside the capture - InferenceModel.load(calibrate=batch) "
                "does this for you.")
        val = float(x.float().abs().max())
        self.amax[key] = max(self.amax.get(key, 0.0), val)


class QuantApply:
    """Apply mode: frozen per-tensor activation scales (Python floats, so a
    captured graph bakes them in) and the int8 weights."""

    mode = "apply"

    def __init__(self, amax: Mapping[str, float],
                 compute_dtype: torch.dtype = COMPUTE_DTYPE):
        self.amax = dict(amax)
        self.compute_dtype = compute_dtype

    def scale_for(self, key: str) -> Optional[float]:
        a = self.amax.get(key)
        if a is None or a <= 0.0:
            return None
        return a / 127.0


_active = threading.local()


@contextlib.contextmanager
def using(ctx, paths: Dict[int, str]) -> Iterator[None]:
    """Make ``ctx`` (a ``Calibrator`` or ``QuantApply``) visible to the
    layers that run on this thread until the block ends; ``paths`` is
    ``module_paths`` of the model."""
    prev = getattr(_active, "state", None)
    _active.state = (ctx, paths)
    try:
        yield
    finally:
        _active.state = prev


def _calibrated(layer: nn.Module, x: torch.Tensor):
    """(context, key, int8 kernel) when ``layer`` takes its int8 product
    under the active context; None otherwise.  In collect mode the input
    is observed and None returned."""
    state = getattr(_active, "state", None)
    if state is None:
        return None
    ctx, paths = state
    key = paths[id(layer)]
    if ctx.mode == "collect":
        ctx.observe(key, x)
        return None
    w = layer._modules.get("kernel")
    if not isinstance(w, Int8Weight) or key not in ctx.amax:
        return None  # never calibrated: the weight-only form
    return ctx, key, w


def dense(layer: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
    """A ``Dense``'s product ``x @ kernel`` under the active context, or
    None for the layer's own float path: the int8 product where the layer
    was calibrated, the weight dequantized in ``x``'s dtype where its
    recorded range is 0 (``layers.py`` Dense)."""
    found = _calibrated(layer, x)
    if found is None:
        return None
    ctx, key, w = found
    y = dense_quantized(ctx, key, x, w.q, w.scale, ctx.compute_dtype)
    if y is not None:
        return y.to(x.dtype)
    return x @ w.dequantize(x.dtype)


def conv(layer: nn.Module, x: torch.Tensor) -> Optional[torch.Tensor]:
    """A plain ``Conv2D``'s convolution under the active context, or None
    for the layer's own float path (``dense``'s rules; a layer with
    ``_act_quant`` false never takes part)."""
    found = _calibrated(layer, x) if layer._act_quant else None
    if found is None:
        return None
    ctx, key, w = found
    y = conv_quantized(ctx, key, x, w.q, w.scale, layer.strides,
                       layer.padding, layer.dilation, layer.groups,
                       ctx.compute_dtype)
    if y is not None:
        return y.to(x.dtype)
    return layer._float_conv(x, w.dequantize(x.dtype))


# -- the int8 products ------------------------------------------------------

def _quantize_activation(ctx: QuantApply, key: str, x: torch.Tensor):
    """The frozen static scale (None: the layer was never calibrated) and
    the symmetrically quantized input (zero point 0, so zero padding stays
    exact); ``torch.round`` rounds half to even, as ``jnp.round``."""
    s_in = ctx.scale_for(key)
    if s_in is None:
        return None, None
    xq = torch.clamp(torch.round(x.float() * (1.0 / s_in)), -127, 127)
    return s_in, xq.to(torch.int8)


def _rescale(y32: torch.Tensor, w_scale: torch.Tensor, s_in: float,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """One fused (s_in * s_w[channel]) rescale of the int32 product."""
    scale = w_scale.float().reshape(-1) * s_in
    return (y32.float() * scale).to(compute_dtype)


def int_mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """int8 ``[M, K] @ [K, N]`` -> int32 ``[M, N]``, exact.  On the card
    ``torch._int_mm`` wants more than 16 rows and K and N multiples of 8,
    and cuBLASLt's int8 kernels both operands K-major (``b`` as the
    transpose of a row-major ``[N, K]``; a Dense's ``Int8Weight`` is kept
    so): the operands are padded with zero rows and columns (exact) or
    laid out so, and the result cut back.  ``int_mm.launches`` counts the
    card's calls."""
    if not a.is_cuda:
        return torch._int_mm(a, b)
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, 17), -(-k // 8) * 8, -(-n // 8) * 8
    a = F.pad(a, (0, kp - k, 0, mp - m)) if (mp, kp) != (m, k) \
        else a.contiguous()
    bt = b.t()  # [N, K]
    bt = F.pad(bt, (0, kp - k, 0, np_ - n)) if (kp, np_) != (k, n) \
        else bt.contiguous()
    y = torch._int_mm(a, bt.t())
    _count_int_mm()
    return y[:m, :n] if (mp, np_) != (m, n) else y


def _count_int_mm() -> None:
    if _launches.deferred(_count_int_mm):
        return
    with _count_lock:
        int_mm.launches += 1


int_mm.launches = 0
_count_lock = threading.Lock()


def dense_quantized(ctx: QuantApply, key: str, x: torch.Tensor,
                    wq: torch.Tensor, w_scale: torch.Tensor,
                    compute_dtype: torch.dtype) -> Optional[torch.Tensor]:
    """int8 GEMM with a static activation scale: q(x) @ wq -> int32, then
    one per-output-channel rescale; None where the layer has no scale."""
    s_in, xq = _quantize_activation(ctx, key, x)
    if s_in is None:
        return None
    y32 = int_mm(xq.reshape(-1, xq.shape[-1]), wq)
    y32 = y32.reshape(*x.shape[:-1], wq.shape[-1])
    return _rescale(y32, w_scale, s_in, compute_dtype)


def conv_int8(xq: torch.Tensor, wq: torch.Tensor, strides, padding,
              dilation=(1, 1), groups: int = 1) -> torch.Tensor:
    """``conv_general_dilated(xq, wq, ..., ("NHWC", "HWIO", "NHWC"),
    preferred_element_type=int32)`` with ``wq`` OIHW: an int8 NHWC map in,
    the exact int32 NHWC map out, as GEMMs (``int_mm``).  A 1x1 unpadded
    conv is a GEMM over the (strided) positions; any other gathers its
    patches (``F.unfold``) from a bf16 copy of the map, in which every
    int8 value is exact."""
    from .layers import _resolve_pads
    n, h, w, c = xq.shape
    o, cg, kh, kw = wq.shape
    (t, b), (l, r) = _resolve_pads(padding, (h, w), (kh, kw), tuple(strides),
                                   tuple(dilation))
    sh, sw = strides
    if kh == kw == 1 and t == b == l == r == 0:
        xs = xq[:, ::sh, ::sw]
        ho, wo = xs.shape[1:3]
        cols = xs.reshape(-1, c)
        width = cg
    else:
        xb = F.pad(xq.to(torch.bfloat16), (0, 0, l, r, t, b))
        ho = (h + t + b - (dilation[0] * (kh - 1) + 1)) // sh + 1
        wo = (w + l + r - (dilation[1] * (kw - 1) + 1)) // sw + 1
        cols = F.unfold(xb.permute(0, 3, 1, 2), (kh, kw), dilation=dilation,
                        stride=strides)  # [N, C*kh*kw, L], C slowest
        cols = cols.transpose(1, 2).reshape(-1, c * kh * kw).to(torch.int8)
        width = cg * kh * kw
    og = o // groups
    wmat = wq.reshape(o, -1)
    y = torch.cat([int_mm(cols[:, g * width:(g + 1) * width].contiguous(),
                          wmat[g * og:(g + 1) * og].t())
                   for g in range(groups)], dim=1) if groups > 1 \
        else int_mm(cols, wmat.t())
    return y.reshape(n, ho, wo, o)


def conv_quantized(ctx: QuantApply, key: str, x: torch.Tensor,
                   wq: torch.Tensor, w_scale: torch.Tensor, strides, padding,
                   dilation, groups: int,
                   compute_dtype: torch.dtype) -> Optional[torch.Tensor]:
    """int8 convolution with a static activation scale: q(x) conv wq ->
    int32, then one per-output-channel rescale; None where the layer has no
    scale."""
    s_in, xq = _quantize_activation(ctx, key, x)
    if s_in is None:
        return None
    y32 = conv_int8(xq, wq, strides, padding, dilation, groups)
    return _rescale(y32, w_scale, s_in, compute_dtype)


__all__ = ["COMPUTE_DTYPE", "Calibrator", "Int8Weight", "MARKER",
           "QuantApply", "base_class", "conv", "conv_int8",
           "conv_quantized", "dense", "dense_quantized", "install",
           "int_mm", "module_paths", "uninstall", "using"]
