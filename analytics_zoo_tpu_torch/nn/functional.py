"""The functional Model API (``analytics_zoo_tpu/nn/functional.py``):
``Input`` -> layer calls -> ``Model(inputs, outputs)``.

Calling a layer on a ``SymbolicTensor`` records a graph node instead of
computing; ``Model`` runs the recorded DAG in topological order.  A layer
object called twice is one set of weights used twice (Keras's sharing), and
each layer sits in the ``Model`` under the JAX package's node name: its
``name`` attribute where it has one, else its class in snake case,
``_1``, ``_2``, ... for the next of the same base (``dense``,
``dense_1``).  So a JAX functional model's variables load into the port's
with ``convert.from_jax_variables``.

How a call is recorded: a ``SymbolicTensor`` is a ``torch.Tensor`` on the
``meta`` device (batch dim 1) whose ``__torch_function__`` runs every op
on ``meta`` copies of its operands, so a layer's own ``forward`` runs
unchanged and only propagates shapes and dtypes.  Two process-wide module
hooks (``torch.nn.modules.module.register_module_forward_pre_hook`` and
``..._forward_hook``) mark the outermost module called on a symbolic
argument: it runs in eval mode (no dropout draw, no running-statistics
update) and its output becomes the node's ``SymbolicTensor``.  A call on
ordinary tensors passes both hooks through.

The hooks are in place only while a ``SymbolicTensor`` with a node is
alive: the first one (an ``Input``) installs them and the last one's
finalizer removes them, so that once a graph is built and its handles are
dropped, every module call takes torch's hook-free path again.  A node
holds its arguments as ``_Ref``s to their nodes, never as symbolic
values, and a ``Model`` holds only nodes; its ``inputs`` and ``outputs``
are fresh symbolic values of its end nodes, made on each read.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils import _pytree as pytree

from .module import snake


class _Node:
    """One recorded layer application (``layer`` None: an ``Input``):
    its arguments with every symbolic value as a ``_Ref``, and the meta
    tensor of its output."""

    def __init__(self, layer: Optional[nn.Module], args: Tuple[Any, ...],
                 kwargs: Dict[str, Any], meta: torch.Tensor):
        self.layer = layer
        self.args = _map_symbolic(args, _Ref)
        self.kwargs = _map_symbolic(kwargs, _Ref)
        self.meta = meta
        self.name: Optional[str] = None  # assigned by Model

    def symbolic(self) -> "SymbolicTensor":
        """A new handle on this node's output."""
        return _track(SymbolicTensor(self.meta, self))


class _Ref:
    """A recorded argument: the node that makes it (None for a value made
    inside a layer's symbolic forward)."""

    __slots__ = ("node",)

    def __init__(self, sym: "SymbolicTensor"):
        self.node = sym.node


def _plain(t: torch.Tensor) -> torch.Tensor:
    """``t`` as a plain tensor of its own: unlike ``as_subclass``, which
    shares ``t``'s tensor and so keeps ``t``'s Python object alive with
    the copy, this detaches into a new one."""
    with torch._C.DisableTorchFunctionSubclass():
        return torch.Tensor._make_subclass(torch.Tensor, t)


def _meta_of(x: Any) -> Any:
    """An operand as ``meta``: a ``SymbolicTensor`` as its plain meta
    tensor, any other tensor copied to ``meta``."""
    if isinstance(x, SymbolicTensor):
        return _plain(x)
    if isinstance(x, torch.Tensor) and x.device.type != "meta":
        return x.to("meta")
    return x


class SymbolicTensor(torch.Tensor):
    """A placeholder flowing through layer calls while a graph is built:
    a meta tensor with the ``node`` that makes it (None for the
    intermediate values inside a layer's symbolic forward).  A layer
    returning a tuple yields one symbolic value that stands for the
    tuple; split it with a ``Lambda(lambda t: t[i])``.  ``+``, ``-`` and
    ``*`` between symbolic tensors, or with a constant on either side,
    record ``Lambda`` nodes (``add``, ``sub_const``, ``rsub_const``, ...)."""

    node: Optional[_Node]

    @staticmethod
    def __new__(cls, meta: torch.Tensor, node: Optional[_Node] = None):
        t = torch.Tensor._make_subclass(cls, meta)
        t.node = node
        return t

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        with torch._C.DisableTorchFunctionSubclass():
            args, kwargs = pytree.tree_map(_meta_of, (args, kwargs or {}))
            out = func(*args, **kwargs)
        return pytree.tree_map(
            lambda t: SymbolicTensor(t) if isinstance(t, torch.Tensor)
            and not isinstance(t, SymbolicTensor)
            and t.device.type == "meta" else t, out)

    def __repr__(self) -> str:
        with torch._C.DisableTorchFunctionSubclass():
            shape = tuple(self.shape)
        layer = None if self.node is None or self.node.layer is None \
            else type(self.node.layer).__name__
        return f"SymbolicTensor(shape={shape}, layer={layer})"

    # arithmetic sugar: recorded as Lambda nodes outside a layer's forward,
    # plain (meta) arithmetic inside one
    def _binop(self, other: Any, fn, name: str, plain) -> Any:
        if _recording():
            return plain(other)
        from .layers import Lambda
        lam = Lambda(fn, name=name)
        return lam(self, other) if isinstance(other, SymbolicTensor) \
            else lam(self)

    def __add__(self, other):
        if isinstance(other, SymbolicTensor):
            return self._binop(other, lambda a, b: a + b, "add",
                               super().__add__)
        return self._binop(other, lambda a, o=other: a + o, "add_const",
                           super().__add__)

    def __sub__(self, other):
        if isinstance(other, SymbolicTensor):
            return self._binop(other, lambda a, b: a - b, "sub",
                               super().__sub__)
        return self._binop(other, lambda a, o=other: a - o, "sub_const",
                           super().__sub__)

    def __mul__(self, other):
        if isinstance(other, SymbolicTensor):
            return self._binop(other, lambda a, b: a * b, "mul",
                               super().__mul__)
        return self._binop(other, lambda a, o=other: a * o, "mul_const",
                           super().__mul__)

    def __radd__(self, other):
        return self._binop(other, lambda a, o=other: o + a, "radd_const",
                           super().__radd__)

    def __rsub__(self, other):
        return self._binop(other, lambda a, o=other: o - a, "rsub_const",
                           super().__rsub__)

    def __rmul__(self, other):
        return self._binop(other, lambda a, o=other: o * a, "rmul_const",
                           super().__rmul__)


# -- the two module hooks ---------------------------------------------------

_tls = threading.local()
# reentrant: a finalizer may run on a thread that holds the lock
_hooks_lock = threading.RLock()
_hooks: List[Any] = []
_live = [0]  # symbolic values with a node that are alive


def _track(sym: "SymbolicTensor") -> "SymbolicTensor":
    """Count ``sym`` as a live graph handle, installing the hooks for the
    first; its finalizer uncounts it and removes them after the last."""
    with _hooks_lock:
        # counted first: a finalizer run inside the install cannot reach 0
        _live[0] += 1
        if not _hooks:
            mm = torch.nn.modules.module
            _hooks.append(mm.register_module_forward_pre_hook(_pre_hook))
            _hooks.append(mm.register_module_forward_hook(
                _post_hook, with_kwargs=True, always_call=True))
    weakref.finalize(sym, _untrack)
    return sym


def _untrack() -> None:
    with _hooks_lock:
        _live[0] -= 1
        if _live[0] == 0:
            for h in _hooks:
                h.remove()
            _hooks.clear()


def _recording() -> bool:
    """True inside the forward of a layer called on symbolic tensors."""
    return getattr(_tls, "depth", 0) > 0


def _contains_symbolic(x: Any) -> bool:
    if isinstance(x, SymbolicTensor):
        return True
    if isinstance(x, (list, tuple)):
        return any(_contains_symbolic(v) for v in x)
    if isinstance(x, dict):
        return any(_contains_symbolic(v) for v in x.values())
    return False


def _map_symbolic(x: Any, fn, kind: Optional[type] = None) -> Any:
    """``x`` with ``fn`` applied to each ``kind`` in it (default
    ``SymbolicTensor``), through lists, tuples and dicts."""
    kind = kind or SymbolicTensor
    if isinstance(x, kind):
        return fn(x)
    if isinstance(x, (list, tuple)):
        return type(x)(_map_symbolic(v, fn, kind) for v in x)
    if isinstance(x, dict):
        return {k: _map_symbolic(v, fn, kind) for k, v in x.items()}
    return x


def _pre_hook(module: nn.Module, args: Tuple[Any, ...]) -> None:
    depth = getattr(_tls, "depth", 0)
    if depth == 0 and not _contains_symbolic(args):
        return
    if depth == 0:
        # the outermost symbolic call: a shape pass in eval mode
        _tls.modes = [(m, m.training) for m in module.modules()]
        module.eval()
    _tls.depth = depth + 1


def _post_hook(module: nn.Module, args: Tuple[Any, ...], *rest: Any) -> Any:
    # (kwargs, out) after a forward; (out,) when the forward raised, which
    # torch calls an always-called hook with
    kwargs, out = rest if len(rest) == 2 else ({}, rest[0])
    depth = getattr(_tls, "depth", 0)
    if depth == 0:
        return None
    _tls.depth = depth - 1
    if depth > 1:
        return None
    for m, mode in _tls.modes:
        m.training = mode
    _tls.modes = []
    if out is None:  # the forward raised: the error goes on
        return None
    meta = _plain(out) if isinstance(out, torch.Tensor) \
        else torch.empty(0, device="meta")
    return _Node(module, args, dict(kwargs), meta).symbolic()


def Input(shape: Sequence[int], dtype: torch.dtype = torch.float32,
          name: Optional[str] = None) -> SymbolicTensor:
    """A graph input; ``shape`` excludes the batch dim."""
    meta = torch.empty((1,) + tuple(shape), dtype=dtype, device="meta")
    return _Node(None, (), {"name": name}, meta).symbolic()


def _node_of(ref: Any) -> _Node:
    """The node of a ``SymbolicTensor`` or a ``_Ref``."""
    if ref.node is None:
        raise ValueError("a symbolic value made inside a layer's forward "
                         "is not a graph node")
    return ref.node


class Model(nn.Module):
    """Run a recorded DAG (``functional.py`` Model).  ``inputs`` and
    ``outputs``: a ``SymbolicTensor`` or a list.  ``forward`` takes the
    tensors in ``inputs`` order (or one list of them) and returns the
    outputs (a tuple when several).  It holds the graph's nodes and no
    symbolic value."""

    def __init__(self, inputs: Any, outputs: Any):
        super().__init__()
        self._in_nodes: List[_Node] = [_node_of(s) for s in (
            inputs if isinstance(inputs, (list, tuple)) else [inputs])]
        self._out_nodes: List[_Node] = [_node_of(s) for s in (
            outputs if isinstance(outputs, (list, tuple)) else [outputs])]
        self._order = self._toposort()
        self._assign_names()

    @property
    def inputs(self) -> List[SymbolicTensor]:
        return [n.symbolic() for n in self._in_nodes]

    @property
    def outputs(self) -> List[SymbolicTensor]:
        return [n.symbolic() for n in self._out_nodes]

    def _toposort(self) -> List[_Node]:
        order: List[_Node] = []
        seen: set = set()
        input_nodes = {id(n) for n in self._in_nodes}

        def visit(node: _Node, stack: set) -> None:
            if id(node) in seen:
                return
            if id(node) in stack:
                raise ValueError("cycle in model graph")
            if id(node) not in input_nodes:
                if node.layer is None:
                    raise ValueError("graph references an Input that is "
                                     "not in Model(inputs=...)")
                stack = stack | {id(node)}
                for ref in self._deps(node):
                    visit(_node_of(ref), stack)
            seen.add(id(node))
            order.append(node)

        for out in self._out_nodes:
            visit(out, set())
        return order

    @staticmethod
    def _deps(node: _Node) -> List[_Ref]:
        deps: List[_Ref] = []
        _map_symbolic((node.args, node.kwargs), deps.append, _Ref)
        return deps

    def _assign_names(self) -> None:
        # one name per layer object: calling a layer twice shares weights
        by_layer: Dict[int, str] = {}
        counts: Dict[str, int] = {}
        for node in self._order:
            if node.layer is None:
                continue
            key = id(node.layer)
            if key not in by_layer:
                base = getattr(node.layer, "name", None) \
                    or snake(type(node.layer).__name__)
                idx = counts.get(base, 0)
                counts[base] = idx + 1
                name = base if idx == 0 else f"{base}_{idx}"
                self.add_module(name, node.layer)
                by_layer[key] = name
            node.name = by_layer[key]

    def forward(self, *xs: Any, **kwargs: Any) -> Any:
        if len(xs) == 1 and isinstance(xs[0], (list, tuple)) \
                and len(self._in_nodes) > 1:
            xs = tuple(xs[0])
        if len(xs) != len(self._in_nodes):
            raise ValueError(
                f"model takes {len(self._in_nodes)} inputs, got {len(xs)}")
        values: Dict[int, Any] = {}
        for node, x in zip(self._in_nodes, xs):
            values[id(node)] = x

        def resolve(ref: _Ref) -> Any:
            return values[id(ref.node)]

        for node in self._order:
            if node.layer is None or id(node) in values:
                continue
            args = _map_symbolic(node.args, resolve, _Ref)
            kw = _map_symbolic(node.kwargs, resolve, _Ref)
            values[id(node)] = getattr(self, node.name)(*args, **kw)
        outs = tuple(values[id(n)] for n in self._out_nodes)
        return outs[0] if len(outs) == 1 else outs


__all__ = ["Input", "Model", "SymbolicTensor"]
