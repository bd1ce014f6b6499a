"""Foreign-model import (``analytics_zoo_tpu/models/net.py``): a PyTorch or
TF/Keras model converted into the port's layers, weights included.

The conversion is the JAX package's, walk for walk: the same supported
layer vocabulary, the same node names (``0_linear``, ``layer1_0_conv1``,
...), the same weight trees in the JAX layout, the same refusals (each
names the escape hatch below).  The converted net holds those weights in
its layers (loaded through ``convert.from_jax_variables``), so its
``state_dict`` is the JAX converter's tree and a JAX ``ForeignNet``'s
variables load into it, and back, one-to-one.  Activations inside the net
are channel-last (NHWC) as in the JAX package: a torch net that takes NCHW
images transposes at its input, and hands NCHW back when it ends in a
feature map.  Batch norms train by the JAX package's rule (momentum the
complement of torch's, biased batch variance), channel-last through
``ops.fused_bn.bn_train`` on the card.

  ESCAPE HATCH: write the forward as an ``nn.Module`` yourself and pour
  the foreign weights in through ``Net.torch_params_to_tree(mod)`` (every
  torch parameter and buffer by name) or ``model.get_weights()`` on the
  Keras side.

``tensorflow`` is imported only inside ``load_tf``, ``load_keras`` and
the Keras helpers they call.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn as tnn

from .. import nn
from ..convert import from_jax_variables

Params = Dict[str, Any]


def _load(module: tnn.Module, params: Params, state: Params) -> None:
    """The JAX-layout trees into ``module``'s parameters and buffers."""
    module.load_state_dict(from_jax_variables(
        {"params": params, "state": state}), strict=True)


def _to_nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1).contiguous()


class ForeignNet(tnn.Module):
    """A converted model whose execution is a chain: each stage a child
    under its node name, run in order.  ``nchw_input``: the torch net took
    NCHW images; the input is made NHWC and a 4-D output goes back to
    NCHW."""

    def __init__(self, stages: Sequence[Tuple[str, tnn.Module]],
                 variables: Params, source: str, nchw_input: bool = False):
        super().__init__()
        self.stage_names = [name for name, _ in stages]
        for name, mod in stages:
            self.add_module(name, mod)
        self.source = source
        self.nchw_input = nchw_input
        _load(self, variables.get("params", {}), variables.get("state", {}))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.nchw_input and x.dim() == 4:
            x = _to_nhwc(x)
        for name in self.stage_names:
            x = getattr(self, name)(x)
        if self.nchw_input and x.dim() == 4:
            x = x.permute(0, 3, 1, 2)
        return x


class ForeignGraphNet(tnn.Module):
    """A converted model with DAG structure (residual adds, branches,
    merges).  ``nodes`` run in topological order over named values; a node
    is a layer (a child under its node name, weights loaded) or a function
    of earlier values.  A constant of the torch graph is a buffer of this
    module that the ``state_dict`` leaves out (as the JAX tree does)."""

    def __init__(self, input_names: Sequence[str], nodes: Sequence[Dict],
                 output_name: str, variables: Params, source: str,
                 nchw_input: bool = False):
        super().__init__()
        self.input_names = list(input_names)
        self.nodes = []
        for node in nodes:
            node = dict(node)
            if node["module"] is not None:
                if hasattr(self, node["name"]):
                    raise NotImplementedError(
                        f"node name {node['name']!r} collides with an "
                        "attribute of ForeignGraphNet; see the escape hatch "
                        "in analytics_zoo_tpu_torch.models.net")
                self.add_module(node["name"], node.pop("module"))
                node["module"] = True
            elif "const" in node:
                self.register_buffer(f"_const_{node['name']}",
                                     node.pop("const"), persistent=False)
            self.nodes.append(node)
        self.output_name = output_name
        self.source = source
        self.nchw_input = nchw_input
        _load(self, variables.get("params", {}), variables.get("state", {}))

    def forward(self, *xs: torch.Tensor) -> torch.Tensor:
        if len(xs) != len(self.input_names):
            raise ValueError(f"model takes {len(self.input_names)} inputs, "
                             f"got {len(xs)}")
        env: Dict[str, Any] = {}
        for name, x in zip(self.input_names, xs):
            if self.nchw_input and x.dim() == 4:
                x = _to_nhwc(x)
            env[name] = x
        for node in self.nodes:
            name = node["name"]
            args = [env[a] if ref else a for ref, a in node["args"]]
            if node["module"]:
                env[name] = getattr(self, name)(*args)
            elif node["fn"] is None:  # a constant
                env[name] = getattr(self, f"_const_{name}")
            else:
                env[name] = node["fn"](*args)
        out = env[self.output_name]
        if self.nchw_input and out.dim() == 4:
            out = out.permute(0, 3, 1, 2)
        return out


class Net:
    """Loader namespace (``Net.load_torch``, ``load_tf``, ``load_keras``;
    ``load_bigdl`` and ``load_caffe`` raise)."""

    # -- torch -----------------------------------------------------------------

    @staticmethod
    def load_torch(module: Any, example_input: Any) -> tnn.Module:
        """Convert a ``torch.nn.Module`` (or a TorchScript file path) whose
        execution is a Sequential chain of supported leaf layers into a
        ``ForeignNet``; any other module goes through ``torch.fx``
        (``load_torch_graph``).  ``example_input``: one real input batch
        (NCHW for conv nets), which traces each layer's input shape."""
        if isinstance(module, str):
            try:
                module = torch.jit.load(module)
            except RuntimeError:
                module = torch.load(module, weights_only=False)
        module = module.eval()
        try:
            leaves = _torch_leaves(module)
        except NotImplementedError:
            return _load_torch_fx(module, example_input)
        x = torch.as_tensor(np.asarray(example_input))
        shapes = _torch_trace_shapes(leaves, x)
        stages: List[Tuple[str, tnn.Module]] = []
        params: Params = {}
        state: Params = {}
        # the NCHW shape the last Flatten consumed, carried through
        # order-preserving layers until the first Linear reorders its
        # kernel rows into NHWC flatten order
        flat_origin: Optional[Tuple[int, ...]] = None
        for i, leaf in enumerate(leaves):
            kind = _torch_kind(leaf)
            name = f"{i}_{kind.lower()}"
            conv = _TORCH_CONVERTERS.get(kind)
            if conv is None:
                raise NotImplementedError(
                    f"torch layer {kind} is not in the supported conversion "
                    f"set {sorted(_TORCH_CONVERTERS)}; see the escape hatch "
                    "in analytics_zoo_tpu_torch.models.net's docstring")
            mod, p, s = conv(leaf, shapes[i], flat_origin)
            if kind == "Flatten" and len(shapes[i]) == 4:
                flat_origin = tuple(shapes[i])
            elif kind == "Linear":
                flat_origin = None
            if mod is None:
                continue
            stages.append((name, mod))
            if p:
                params[name] = p
            if s:
                state[name] = s
        return ForeignNet(stages, {"params": params, "state": state},
                          source="torch", nchw_input=x.dim() == 4)

    @staticmethod
    def load_torch_graph(module: Any, example_input: Any) -> "ForeignGraphNet":
        """Convert a graph-structured ``torch.nn.Module`` (residual adds,
        branches, concats: torchvision-style ResNets) through ``torch.fx``
        into a ``ForeignGraphNet``.  TorchScript modules cannot be
        fx-traced."""
        return _load_torch_fx(module, example_input)

    @staticmethod
    def torch_params_to_tree(module: Any) -> Dict[str, np.ndarray]:
        """Escape hatch: every parameter and buffer as ``{name: array}``."""
        return {n: p.detach().cpu().numpy()
                for n, p in module.state_dict().items()}

    # -- tf/keras --------------------------------------------------------------

    @staticmethod
    def load_tf(model_or_path: Any) -> tnn.Module:
        """Convert a ``tf.keras`` model (object, ``.h5``/``.keras`` file or
        a SavedModel directory) built from supported layers: a Sequential
        into a ``ForeignNet``, a functional model into a
        ``ForeignGraphNet``.  Keras is channel-last already."""
        import tensorflow as tf
        model = model_or_path
        if isinstance(model, str):
            model = tf.keras.models.load_model(model)
        if not isinstance(model, tf.keras.Sequential):
            return _load_keras_functional(model)
        layers = [l for l in model.layers
                  if type(l).__name__ != "InputLayer"]
        stages: List[Tuple[str, tnn.Module]] = []
        params: Params = {}
        state: Params = {}
        for i, layer in enumerate(layers):
            kind = type(layer).__name__
            name = f"{i}_{kind.lower()}"
            conv = _TF_CONVERTERS.get(kind)
            if conv is None:
                raise NotImplementedError(
                    f"keras layer {kind} is not in the supported conversion "
                    f"set {sorted(_TF_CONVERTERS)}; see the escape hatch in "
                    "analytics_zoo_tpu_torch.models.net's docstring")
            mod, p, s = conv(layer)
            if mod is None:
                continue
            stages.append((name, mod))
            if p:
                params[name] = p
            if s:
                state[name] = s
        return ForeignNet(stages, {"params": params, "state": state},
                          source="tf")

    @staticmethod
    def load_keras(model_or_path: Any,
                   weights_path: Optional[str] = None) -> tnn.Module:
        """The reference's ``Net.load_keras(def_path, weights_path)``: an
        architecture JSON plus an optional weights file, a single saved
        model path, or a live Keras model; converted by ``load_tf``."""
        import tensorflow as tf
        model = model_or_path
        if isinstance(model, str) and model.endswith(".json"):
            with open(model) as f:
                model = tf.keras.models.model_from_json(f.read())
        elif isinstance(model, str):
            model = tf.keras.models.load_model(model)
        if weights_path is not None:
            model.load_weights(weights_path)
        return Net.load_tf(model)

    # -- formats with no converter --------------------------------------------

    @staticmethod
    def load_bigdl(*a: Any, **k: Any) -> None:
        raise NotImplementedError(
            "BigDL protobuf serialization is a JVM-era format with no "
            "runtime here; retrain or re-export via torch/keras "
            "(consciously dropped, as in the JAX package)")

    load_caffe = load_bigdl


# -- torch helpers -------------------------------------------------------------

def _torch_kind(m: Any) -> str:
    n = type(m).__name__
    if n == "RecursiveScriptModule":
        return m.original_name
    return n


def _torch_leaves(m: Any) -> List[Any]:
    kids = list(m.children())
    if not kids:
        return [m]
    kind = _torch_kind(m)
    if kind not in ("Sequential", "ModuleList"):
        raise NotImplementedError(
            f"torch container {kind} does not guarantee Sequential "
            "execution; only nn.Sequential trees convert as a chain (see "
            "the escape hatch in analytics_zoo_tpu_torch.models.net)")
    out: List[Any] = []
    for k in kids:
        out.extend(_torch_leaves(k))
    return out


def _torch_trace_shapes(leaves: List[Any], x: torch.Tensor
                        ) -> List[Tuple[int, ...]]:
    """Each leaf's input shape, by running the chain leaf by leaf."""
    shapes: List[Tuple[int, ...]] = []
    with torch.no_grad():
        for leaf in leaves:
            shapes.append(tuple(x.shape))
            x = leaf(x)
    return shapes


def _np(t: Any) -> np.ndarray:
    return t.detach().cpu().numpy()


def _t_linear(m, in_shape, prev_flat):
    kernel = _np(m.weight).T.copy()      # [in, out]
    if prev_flat is not None:
        # the Linear consumed a Flatten of NCHW maps, the converted net
        # flattens NHWC: kernel rows c*H*W+h*W+w -> h*W*C+w*C+c
        _, c, h, wid = prev_flat
        perm = np.arange(c * h * wid).reshape(c, h, wid)
        kernel = kernel[perm.transpose(1, 2, 0).reshape(-1)]
    p = {"kernel": kernel}
    if m.bias is not None:
        p["bias"] = _np(m.bias)
    return nn.Dense(m.in_features, m.out_features,
                    use_bias=m.bias is not None), p, {}


def _t_conv2d(m, in_shape, prev_flat):
    stride = tuple(m.stride)
    pad = m.padding
    if isinstance(pad, str):
        if pad == "valid":
            padding: Any = "valid"
        elif pad == "same" and stride == (1, 1):
            padding = "same"
        else:
            raise NotImplementedError(
                f"torch Conv2d padding={pad!r} stride={stride} has no "
                "exact equivalent; use the escape hatch")
    else:
        # torch pads symmetrically, which is not XLA's SAME at stride > 1
        pad = (pad, pad) if isinstance(pad, int) else tuple(pad)
        padding = ((pad[0], pad[0]), (pad[1], pad[1]))
    p = {"kernel": _np(m.weight).transpose(2, 3, 1, 0)}  # OIHW -> HWIO
    if m.bias is not None:
        p["bias"] = _np(m.bias)
    return (nn.Conv2D(m.in_channels, m.out_channels, tuple(m.kernel_size),
                      stride, padding, use_bias=m.bias is not None,
                      groups=m.groups, dilation=tuple(m.dilation)), p, {})


def _t_batchnorm(m, in_shape, prev_flat):
    if m.running_mean is None:
        raise NotImplementedError(
            "BatchNorm with track_running_stats=False evaluates on batch "
            "statistics, which this converter's inference semantics don't "
            "replicate; use the escape hatch")
    if m.momentum is None:
        raise NotImplementedError(
            "BatchNorm with momentum=None (cumulative averaging) has no "
            "equivalent here; use the escape hatch")
    affine = m.weight is not None
    # torch: running = (1-mom)*running + mom*batch; here m*run + (1-m)*batch
    mod = nn.BatchNormalization(m.num_features, momentum=1.0 - m.momentum,
                                epsilon=m.eps, center=affine, scale=affine)
    p = {"gamma": _np(m.weight), "beta": _np(m.bias)} if affine else {}
    s = {"mean": _np(m.running_mean), "var": _np(m.running_var)}
    return mod, p, s


def _t_layernorm(m, in_shape, prev_flat):
    if len(m.normalized_shape) != 1:
        raise NotImplementedError(
            f"LayerNorm over {len(m.normalized_shape)} trailing dims has no "
            "equivalent (last-axis only); use the escape hatch")
    if m.weight is None:
        raise NotImplementedError(
            "LayerNorm(elementwise_affine=False) is unsupported; use the "
            "escape hatch")
    return (nn.LayerNormalization(m.normalized_shape[0], epsilon=m.eps),
            {"gamma": _np(m.weight), "beta": _np(m.bias)}, {})


def _t_embedding(m, in_shape, prev_flat):
    return (nn.Embedding(m.num_embeddings, m.embedding_dim),
            {"embeddings": _np(m.weight)}, {})


def _t_act(name):
    def conv(m, in_shape, prev_flat):
        return nn.Activation(name), {}, {}
    return conv


def _gelu_erf(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x)


def _t_gelu(m, in_shape, prev_flat):
    # torch's GELU defaults to the exact erf form; the port's "gelu" is the
    # tanh approximation: pick by the module's own setting
    exact = getattr(m, "approximate", "none") == "none"
    return nn.Activation(_gelu_erf if exact else "gelu"), {}, {}


def _pool_args(k, s, pad, ceil, count_include_pad, kind: str):
    k = (k, k) if isinstance(k, int) else tuple(k)
    s = s or k
    s = (s, s) if isinstance(s, int) else tuple(s)
    if ceil:
        raise NotImplementedError(
            "torch pooling with ceil_mode=True has no exact equivalent "
            "here; use the escape hatch")
    pad = (pad, pad) if isinstance(pad, int) else tuple(pad)
    if kind == "avg" and pad != (0, 0) and not count_include_pad:
        raise NotImplementedError(
            "AvgPool2d(count_include_pad=False) with padding has no exact "
            "equivalent here; use the escape hatch")
    padding: Any = ("valid" if pad == (0, 0)
                    else ((pad[0], pad[0]), (pad[1], pad[1])))
    cls = nn.MaxPooling2D if kind == "max" else nn.AveragePooling2D
    return cls(k, s, padding=padding)


def _t_pool(kind):
    def conv(m, in_shape, prev_flat):
        return _pool_args(m.kernel_size, m.stride, m.padding,
                          getattr(m, "ceil_mode", False),
                          getattr(m, "count_include_pad", True), kind), {}, {}
    return conv


def _t_flatten(m, in_shape, prev_flat):
    return nn.Flatten(), {}, {}


def _t_dropout(m, in_shape, prev_flat):
    return nn.Dropout(m.p), {}, {}


class _GlobalMeanKeep(tnn.Module):
    """``AdaptiveAvgPool2d(1)`` over NHWC: the spatial mean, kept as 1x1."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.mean(dim=(1, 2), keepdim=True)


def _t_adaptive_avg(m, in_shape, prev_flat):
    out = m.output_size
    out = (out, out) if isinstance(out, int) else tuple(out)
    if out not in ((1, 1), (1,)):
        raise NotImplementedError(
            "AdaptiveAvgPool2d converts only for output_size=1 "
            "(global average)")
    return _GlobalMeanKeep(), {}, {}


_TORCH_CONVERTERS: Dict[str, Callable] = {
    "Linear": _t_linear,
    "Conv2d": _t_conv2d,
    "BatchNorm1d": _t_batchnorm,
    "BatchNorm2d": _t_batchnorm,
    "LayerNorm": _t_layernorm,
    "Embedding": _t_embedding,
    "ReLU": _t_act("relu"),
    "GELU": _t_gelu,
    "Tanh": _t_act("tanh"),
    "Sigmoid": _t_act("sigmoid"),
    "Softmax": _t_act("softmax"),
    "Flatten": _t_flatten,
    "Dropout": _t_dropout,
    "MaxPool2d": _t_pool("max"),
    "AvgPool2d": _t_pool("avg"),
    "AdaptiveAvgPool2d": _t_adaptive_avg,
    "Identity": lambda m, s, f: (None, {}, {}),
}


# -- torch fx graph conversion -------------------------------------------------

# elementwise module kinds a pending Flatten->Linear kernel reorder flows
# through
_ORDER_PRESERVING_KINDS = frozenset({
    "ReLU", "GELU", "Tanh", "Sigmoid", "Softmax", "Dropout", "Identity",
    "LeakyReLU", "ELU", "SiLU", "Hardswish",
})

# kinds with per-position parameters: on an NCHW-flattened value they would
# need their own reorder, which is not implemented
_POSITIONAL_PARAM_KINDS = frozenset({"LayerNorm", "BatchNorm1d"})


def _load_torch_fx(module: Any, example_input: Any) -> ForeignGraphNet:
    """fx-trace a torch module and convert its DAG (the JAX package's walk:
    every 4-D value NHWC inside the net; ShapeProp's NCHW shapes remap
    axis arguments and reorder Linear kernels after a flatten)."""
    from torch import fx
    from torch.fx.passes.shape_prop import ShapeProp

    if isinstance(module, torch.jit.ScriptModule):
        raise NotImplementedError(
            "TorchScript modules cannot be fx-traced; only Sequential "
            "TorchScript chains convert (see the escape hatch in "
            "analytics_zoo_tpu_torch.models.net)")
    module = module.eval()
    x = torch.as_tensor(np.asarray(example_input))
    try:
        traced = fx.symbolic_trace(module)
        ShapeProp(traced).propagate(x)
    except Exception as e:
        raise NotImplementedError(
            f"module could not be fx-traced for graph conversion ({e}); "
            "see the escape hatch in analytics_zoo_tpu_torch.models.net's "
            "docstring") from e

    def shp(n) -> Optional[Tuple[int, ...]]:
        tm = n.meta.get("tensor_meta") if isinstance(n, fx.Node) else None
        return tuple(tm.shape) if tm is not None else None

    input_names: List[str] = []
    nodes: List[Dict] = []
    params: Params = {}
    state: Params = {}
    output_name: Optional[str] = None
    alias: Dict[str, str] = {}
    flat_origin: Dict[str, Tuple[int, ...]] = {}
    # values derived only from non-scalar constants keep torch's NCHW-flat
    # order: combined with a flattened NHWC map they would misorder
    const_origin: Dict[str, bool] = {}

    def res(n) -> str:
        name = n.name
        while name in alias:
            name = alias[name]
        return name

    def refargs(args) -> List[Tuple[bool, Any]]:
        return [(True, res(a)) if isinstance(a, fx.Node) else (False, a)
                for a in args]

    for n in traced.graph.nodes:
        if n.op == "placeholder":
            input_names.append(n.name)
            continue
        if n.op == "output":
            arg = n.args[0]
            if not isinstance(arg, fx.Node):
                raise NotImplementedError(
                    "only single-tensor outputs convert; see the escape "
                    "hatch in analytics_zoo_tpu_torch.models.net")
            output_name = res(arg)
            continue
        if n.op == "call_module":
            leaf = traced.get_submodule(n.target)
            kind = _torch_kind(leaf)
            conv = _TORCH_CONVERTERS.get(kind)
            if conv is None:
                raise NotImplementedError(
                    f"torch layer {kind} is not in the supported conversion "
                    f"set {sorted(_TORCH_CONVERTERS)}; see the escape hatch "
                    "in analytics_zoo_tpu_torch.models.net's docstring")
            in_shape = shp(n.args[0]) or ()
            mod, p, s = conv(leaf, in_shape, flat_origin.get(res(n.args[0])))
            if kind == "Flatten" and len(in_shape) == 4:
                flat_origin[n.name] = in_shape
            elif kind in _ORDER_PRESERVING_KINDS:
                src = res(n.args[0])
                if src in flat_origin:
                    flat_origin[n.name] = flat_origin[src]
            elif (kind in _POSITIONAL_PARAM_KINDS
                  and res(n.args[0]) in flat_origin):
                raise NotImplementedError(
                    f"{kind} applied to a flattened NCHW feature map would "
                    "need its per-position parameters reordered, which is "
                    "unsupported; use the escape hatch")
            if mod is None:
                alias[n.name] = res(n.args[0])
                continue
            nodes.append({"name": n.name, "module": mod, "fn": None,
                          "args": refargs(n.args)})
            if p:
                params[n.name] = p
            if s:
                state[n.name] = s
            continue
        if n.op in ("call_function", "call_method"):
            handled = _fx_function(n, shp, res, refargs, alias, flat_origin,
                                   const_origin)
            if handled is not None:
                nodes.append(handled)
            operands = [a for a in n.args if isinstance(a, fx.Node)]
            if operands and all(res(a) in const_origin for a in operands):
                const_origin[res(n)] = any(const_origin[res(a)]
                                           for a in operands)
            continue
        if n.op == "get_attr":
            # a constant of the forward; a 4-D one is NCHW in torch and
            # NHWC in the converted graph
            t = traced
            for part in n.target.split("."):
                t = getattr(t, part)
            val = t.detach().cpu().clone()
            if val.dim() == 4:
                val = val.permute(0, 2, 3, 1).contiguous()
            const_origin[n.name] = val.numel() > 1
            nodes.append({"name": n.name, "module": None, "fn": None,
                          "const": val, "args": []})
            continue
        raise NotImplementedError(f"fx op {n.op} is unsupported")

    if output_name is None:
        raise NotImplementedError("traced graph has no output node")
    return ForeignGraphNet(input_names, nodes, output_name,
                           {"params": params, "state": state},
                           source="torch", nchw_input=x.dim() == 4)


_BINOPS = {
    ("add", "iadd", "add_"): lambda a, b: a + b,
    ("sub", "isub", "sub_"): lambda a, b: a - b,
    ("rsub",): lambda a, b: b - a,  # torch.rsub(x, o) == o - x
    ("mul", "imul", "mul_"): lambda a, b: a * b,
    ("truediv", "div", "div_"): lambda a, b: a / b,
}

_UNARY = {
    "relu": F.relu, "relu_": F.relu, "tanh": torch.tanh,
    "sigmoid": torch.sigmoid, "silu": F.silu, "hardswish": F.hardswish,
    "abs": torch.abs, "exp": torch.exp,
}


def _flatten_batch(v: torch.Tensor) -> torch.Tensor:
    return v.reshape(v.shape[0], -1)


def _fx_function(n, shp, res, refargs, alias, flat_origin,
                 const_origin) -> Optional[Dict]:
    """One fx call_function/call_method node: a graph node, an alias
    (identity ops), or a refusal."""
    from torch import fx

    target = n.target
    tname = target if isinstance(target, str) else getattr(
        target, "__name__", str(target))
    is4d = (shp(n.args[0]) is not None and len(shp(n.args[0])) == 4
            if n.args and isinstance(n.args[0], fx.Node) else False)

    def node(fn, args):
        return {"name": n.name, "module": None, "fn": fn,
                "args": refargs(args)}

    def propagate_flat():
        for a in n.args:
            if isinstance(a, fx.Node):
                src = res(a)
                if src in flat_origin:
                    flat_origin[n.name] = flat_origin[src]
                return

    for names, fn in _BINOPS.items():
        if tname in names:
            operands = [a for a in n.args[:2] if isinstance(a, fx.Node)]
            if any(res(a) in flat_origin for a in operands):
                for a in operands:
                    if const_origin.get(res(a)):
                        raise NotImplementedError(
                            f"elementwise {tname} between a flattened "
                            "NCHW feature map and a non-scalar constant "
                            "tensor would need the constant reordered "
                            "to NHWC-flat order, which is unsupported; "
                            "use the escape hatch")
            propagate_flat()
            return node(fn, n.args[:2])

    if tname in _UNARY:
        propagate_flat()
        return node(_UNARY[tname], n.args[:1])

    if tname == "gelu":
        approx = n.kwargs.get("approximate", "none")
        return node(lambda v, a=approx: F.gelu(v, approximate=a),
                    n.args[:1])

    if tname in ("contiguous", "clone", "detach", "dropout"):
        # F.dropout is an identity only under a trace-time-constant
        # training=False (torch's own default is True, even under .eval())
        if tname == "dropout":
            train_flag = (n.args[2] if len(n.args) > 2
                          else n.kwargs.get("training", True))
            if train_flag is not False:
                raise NotImplementedError(
                    "F.dropout without a trace-time-constant training=False "
                    "has no converted equivalent (torch's default is "
                    "training=True even under .eval()); use nn.Dropout "
                    "modules instead")
        alias[n.name] = res(n.args[0])
        src = res(n.args[0])
        if src in flat_origin:
            flat_origin[n.name] = flat_origin[src]
        return None

    if tname == "flatten":
        start = (n.args[1] if len(n.args) > 1
                 else n.kwargs.get("start_dim", 0))
        if start != 1:
            raise NotImplementedError(
                "only flatten(start_dim=1) converts; see the escape hatch")
        in_shape = shp(n.args[0])
        if in_shape is not None and len(in_shape) == 4:
            flat_origin[n.name] = in_shape
        return node(_flatten_batch, n.args[:1])

    if tname in ("view", "reshape"):
        tail = n.args[1:]
        if len(tail) == 1 and isinstance(tail[0], (tuple, list)):
            tail = tuple(tail[0])
        if len(tail) == 2 and tail[1] == -1:
            in_shape = shp(n.args[0])
            if in_shape is not None and len(in_shape) == 4:
                flat_origin[n.name] = in_shape
            return node(_flatten_batch, n.args[:1])
        raise NotImplementedError(
            f"{tname}{tuple(tail)} is unsupported (only (B, -1) flattens "
            "convert); see the escape hatch")

    if tname == "size":
        if len(n.args) < 2:
            raise NotImplementedError(
                "x.size() as a tuple is unsupported; use the escape hatch")
        d = n.args[1]
        if is4d and d not in (0, -4):
            raise NotImplementedError(
                f"x.size({d}) on a 4-D NCHW tensor has a layout-dependent "
                "meaning after NHWC conversion; use the escape hatch")
        return node(lambda v, dd=d: v.shape[dd], n.args[:1])

    if tname in ("cat", "concat"):
        tensors = n.args[0]
        dim = n.args[1] if len(n.args) > 1 else n.kwargs.get("dim", 0)
        if any(res(t) in flat_origin for t in tensors
               if isinstance(t, fx.Node)):
            raise NotImplementedError(
                "cat of flattened NCHW feature maps feeding a Linear would "
                "need a per-segment kernel reorder, which is unsupported; "
                "use the escape hatch")
        shapes = [shp(t) for t in tensors]
        if all(s is not None and len(s) == 4 for s in shapes):
            if dim in (1, -3):
                axis = -1
            elif dim == 0:
                axis = 0
            else:
                raise NotImplementedError(
                    f"cat over NCHW dim {dim} has no NHWC mapping here")
        else:
            axis = dim
        return {"name": n.name, "module": None,
                "fn": (lambda *vs, a=axis: torch.cat(vs, dim=a)),
                "args": [(True, res(t)) for t in tensors]}

    if tname == "softmax":
        dim = n.args[1] if len(n.args) > 1 else n.kwargs.get("dim", -1)
        if is4d:
            dim = {0: 0, 1: -1, 2: 1, 3: 2}[dim % 4]
        return node(lambda v, d=dim: torch.softmax(v, dim=d), n.args[:1])

    if tname == "mean":
        dims = n.args[1] if len(n.args) > 1 else n.kwargs.get("dim")
        keep = (n.args[2] if len(n.args) > 2
                else n.kwargs.get("keepdim", False))
        if dims is None:
            return node(lambda v: v.mean(), n.args[:1])
        dims = [dims] if isinstance(dims, int) else list(dims)
        if is4d:
            if sorted(d % 4 for d in dims) != [2, 3]:
                raise NotImplementedError(
                    f"mean over NCHW dims {dims} has no NHWC mapping here")
            axes = (1, 2)
        else:
            axes = tuple(dims)
        return node(lambda v, a=axes, k=keep: v.mean(dim=a, keepdim=k),
                    n.args[:1])

    if tname == "adaptive_avg_pool2d":
        out = n.args[1] if len(n.args) > 1 else n.kwargs.get("output_size")
        out = (out, out) if isinstance(out, int) else tuple(out)
        if out != (1, 1):
            raise NotImplementedError(
                "adaptive_avg_pool2d converts only for output_size=1")
        return node(lambda v: v.mean(dim=(1, 2), keepdim=True), n.args[:1])

    if tname in ("max_pool2d", "avg_pool2d"):
        k = n.args[1] if len(n.args) > 1 else n.kwargs.get("kernel_size")
        s = n.args[2] if len(n.args) > 2 else n.kwargs.get("stride")
        # F.max_pool2d(x, k, s, pad, dilation, ceil_mode); avg_pool2d has
        # no dilation and ceil_mode at position 4
        ceil_pos = 5 if tname == "max_pool2d" else 4
        ceil = (n.kwargs.get("ceil_mode", False)
                or (len(n.args) > ceil_pos and n.args[ceil_pos]))
        dil = (n.args[4] if (tname == "max_pool2d" and len(n.args) > 4)
               else n.kwargs.get("dilation", 1))
        if not ceil and dil not in (1, (1, 1)):
            raise NotImplementedError(
                "functional max_pool2d with dilation has no equivalent "
                "here; use the escape hatch")
        pad = n.args[3] if len(n.args) > 3 else n.kwargs.get("padding", 0)
        cip = (n.args[5] if len(n.args) > 5
               else n.kwargs.get("count_include_pad", True))
        kind = "max" if tname == "max_pool2d" else "avg"
        return {"name": n.name, "module": _pool_args(k, s, pad, ceil, cip,
                                                     kind),
                "fn": None, "args": refargs(n.args[:1])}

    raise NotImplementedError(
        f"torch op {tname!r} is not in the supported conversion set; see "
        "the escape hatch in analytics_zoo_tpu_torch.models.net's docstring")


# -- keras helpers -------------------------------------------------------------

def _k_weights(layer) -> List[np.ndarray]:
    return [np.asarray(w) for w in layer.get_weights()]


def _reduce(fn, vs):
    out = vs[0]
    for v in vs[1:]:
        out = fn(out, v)
    return out


# merge layers (functional graphs only): functions of the inbound list
_K_MERGES: Dict[str, Callable] = {
    "Add": lambda cfg: (lambda *vs: sum(vs[1:], vs[0])),
    "Subtract": lambda cfg: (lambda a, b: a - b),
    "Multiply": lambda cfg: (lambda *vs: _reduce(torch.mul, vs)),
    "Average": lambda cfg: (lambda *vs: sum(vs[1:], vs[0]) / len(vs)),
    "Maximum": lambda cfg: (lambda *vs: _reduce(torch.maximum, vs)),
    "Minimum": lambda cfg: (lambda *vs: _reduce(torch.minimum, vs)),
    "Concatenate": lambda cfg: (
        lambda *vs, a=cfg.get("axis", -1): torch.cat(vs, dim=a)),
}


def _keras_inbound(layer_cfg) -> List[str]:
    """The producer layer names feeding one layer, from its serialized
    inbound nodes (Keras 3's ``__keras_tensor__`` format and Keras 2's
    nested lists)."""
    nodes = layer_cfg.get("inbound_nodes", [])
    if len(nodes) != 1:
        raise NotImplementedError(
            f"layer {layer_cfg.get('name')!r} is applied {len(nodes)} times "
            "(shared layers are unsupported in conversion); see the escape "
            "hatch in analytics_zoo_tpu_torch.models.net")
    names: List[str] = []

    def walk(obj):
        if isinstance(obj, dict):
            if obj.get("class_name") == "__keras_tensor__":
                hist = obj["config"]["keras_history"]
                if hist[1] != 0:
                    raise NotImplementedError(
                        "shared-layer tensors are unsupported in conversion")
                names.append(hist[0])
                return
            for v in obj.values():
                walk(v)
        elif isinstance(obj, (list, tuple)):
            if (len(obj) >= 3 and isinstance(obj[0], str)
                    and isinstance(obj[1], int) and isinstance(obj[2], int)):
                names.append(obj[0])
                return
            for v in obj:
                walk(v)

    walk(nodes)
    return names


def _load_keras_functional(model) -> ForeignGraphNet:
    """A functional tf.keras model (skip connections, merges) by its config
    DAG: layers through the Sequential path's table, merges as
    functions."""
    cfg = model.get_config()
    by_name = {l.name: l for l in model.layers}
    out_spec = cfg.get("output_layers")
    if (isinstance(out_spec, (list, tuple)) and len(out_spec) == 3
            and isinstance(out_spec[0], str)):
        out_spec = [out_spec]
    if not out_spec or len(out_spec) != 1:
        raise NotImplementedError(
            "multi-output functional models are unsupported in conversion; "
            "see the escape hatch in analytics_zoo_tpu_torch.models.net")
    output_name = out_spec[0][0]

    input_names: List[str] = []
    nodes: List[Dict] = []
    params: Params = {}
    state: Params = {}
    alias: Dict[str, str] = {}

    def res(name: str) -> str:
        while name in alias:
            name = alias[name]
        return name

    layer_cfgs = {l["name"]: l for l in cfg["layers"]}
    done: set = set()
    order: List[str] = []

    def visit(name: str, stack=()):
        if name in done:
            return
        if name in stack:
            raise ValueError(f"cycle at layer {name!r}")
        lc = layer_cfgs[name]
        if lc["class_name"] != "InputLayer":
            for dep in _keras_inbound(lc):
                visit(dep, stack + (name,))
        done.add(name)
        order.append(name)

    for l in cfg["layers"]:
        visit(l["name"])

    # the input order is Model(inputs=[a, b])'s, not the walk's
    in_spec = cfg.get("input_layers")
    if (isinstance(in_spec, (list, tuple)) and len(in_spec) == 3
            and isinstance(in_spec[0], str)):
        in_spec = [in_spec]
    declared_inputs = [t[0] for t in (in_spec or [])]

    for name in order:
        lc = layer_cfgs[name]
        kind = lc["class_name"]
        if kind == "InputLayer":
            input_names.append(name)
            continue
        inbound = [res(p) for p in _keras_inbound(lc)]
        if kind in _K_MERGES:
            nodes.append({"name": name, "module": None,
                          "fn": _K_MERGES[kind](lc.get("config", {})),
                          "args": [(True, p) for p in inbound]})
            continue
        conv = _TF_CONVERTERS.get(kind)
        if conv is None:
            raise NotImplementedError(
                f"keras layer {kind} is not in the supported conversion "
                f"set {sorted(_TF_CONVERTERS) + sorted(_K_MERGES)}; see "
                "the escape hatch in analytics_zoo_tpu_torch.models.net")
        mod, p, s = conv(by_name[name])
        if mod is None:
            alias[name] = inbound[0]
            continue
        nodes.append({"name": name, "module": mod, "fn": None,
                      "args": [(True, p) for p in inbound]})
        if p:
            params[name] = p
        if s:
            state[name] = s

    if declared_inputs and set(declared_inputs) == set(input_names):
        input_names = declared_inputs
    return ForeignGraphNet(input_names, nodes, res(output_name),
                           {"params": params, "state": state}, source="tf")


def _k_dense(layer):
    w = _k_weights(layer)
    cfg = layer.get_config()
    p = {"kernel": w[0]}
    if cfg.get("use_bias", True):
        p["bias"] = w[1]
    return (nn.Dense(w[0].shape[0], cfg["units"],
                     activation=cfg.get("activation"),
                     use_bias=cfg.get("use_bias", True)), p, {})


def _k_conv2d(layer):
    w = _k_weights(layer)
    cfg = layer.get_config()
    p = {"kernel": w[0]}  # keras stores HWIO already
    if cfg.get("use_bias", True):
        p["bias"] = w[1]
    groups = cfg.get("groups", 1)
    return (nn.Conv2D(w[0].shape[2] * groups, cfg["filters"],
                      tuple(cfg["kernel_size"]), tuple(cfg["strides"]),
                      cfg["padding"], activation=cfg.get("activation"),
                      use_bias=cfg.get("use_bias", True),
                      dilation=tuple(cfg.get("dilation_rate", (1, 1))),
                      groups=groups), p, {})


def _k_batchnorm(layer):
    cfg = layer.get_config()
    if cfg.get("axis") not in (-1, [len(layer.input.shape) - 1],
                               len(layer.input.shape) - 1, [-1], 3, [3]):
        raise NotImplementedError("BatchNormalization converts on the "
                                  "channel-last axis only")
    w = _k_weights(layer)
    i = 0
    p = {}
    if cfg.get("scale", True):
        p["gamma"] = w[i]
        i += 1
    if cfg.get("center", True):
        p["beta"] = w[i]
        i += 1
    s = {"mean": w[i], "var": w[i + 1]}
    return (nn.BatchNormalization(w[i].shape[0], momentum=cfg["momentum"],
                                  epsilon=cfg["epsilon"],
                                  center=cfg.get("center", True),
                                  scale=cfg.get("scale", True)), p, s)


def _k_layernorm(layer):
    cfg = layer.get_config()
    w = _k_weights(layer)
    return (nn.LayerNormalization(w[0].shape[0], epsilon=cfg["epsilon"]),
            {"gamma": w[0], "beta": w[1]}, {})


def _k_embedding(layer):
    cfg = layer.get_config()
    return (nn.Embedding(cfg["input_dim"], cfg["output_dim"]),
            {"embeddings": _k_weights(layer)[0]}, {})


def _k_pool(cls):
    def conv(layer):
        cfg = layer.get_config()
        return (cls(tuple(cfg["pool_size"]), tuple(cfg["strides"]),
                    cfg["padding"]), {}, {})
    return conv


def _k_simple(factory):
    return lambda layer: (factory(layer), {}, {})


_TF_CONVERTERS: Dict[str, Callable] = {
    "Dense": _k_dense,
    "Conv2D": _k_conv2d,
    "BatchNormalization": _k_batchnorm,
    "LayerNormalization": _k_layernorm,
    "Embedding": _k_embedding,
    "MaxPooling2D": _k_pool(nn.MaxPooling2D),
    "AveragePooling2D": _k_pool(nn.AveragePooling2D),
    "GlobalAveragePooling2D": _k_simple(
        lambda l: nn.GlobalAveragePooling2D()),
    "GlobalMaxPooling2D": _k_simple(lambda l: nn.GlobalMaxPooling2D()),
    "GlobalAveragePooling1D": _k_simple(
        lambda l: nn.GlobalAveragePooling1D()),
    "Flatten": _k_simple(lambda l: nn.Flatten()),
    "Dropout": _k_simple(lambda l: nn.Dropout(l.get_config()["rate"])),
    "Activation": _k_simple(
        lambda l: nn.Activation(l.get_config()["activation"])),
    "ReLU": _k_simple(lambda l: nn.Activation("relu")),
    "Softmax": _k_simple(lambda l: nn.Activation("softmax")),
}


__all__ = ["ForeignNet", "ForeignGraphNet", "Net"]
