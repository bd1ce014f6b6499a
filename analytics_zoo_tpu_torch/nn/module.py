"""Module helpers of the port (``analytics_zoo_tpu/nn/module.py``): the
parameter count and the taps, every submodule's output keyed by its JAX
scope path.

In the JAX package a ``Scope`` records each child's output while the
module runs (``Module.apply_with_taps``).  Here the modules are
``torch.nn.Module``s whose attribute names are the JAX scope names, so a
submodule's dotted name with ``/`` for ``.`` is its scope path
(``block3.mha`` -> ``"block3/mha"``), and a forward hook on each
submodule records its output.  A module called twice in one forward (a
shared layer of a functional ``Model``) records one tap per call, the
second under ``"<path>#1"``, as the JAX package does.

The aux-loss channel: a layer with an auxiliary loss (``ActivityRegularization``'s
penalty, ``parallel.MoE``'s load-balance loss) hands it, with its gradient,
to :func:`record_aux_loss` in its forward, and the Estimator's train step
adds ``aux_loss_weight`` times the f32 sum of what :func:`aux_losses`
collected in that forward to the loss.  The JAX package sums the
``aux_loss`` leaves of the forward's new state; a module's record
replaces its earlier one in the same forward, as ``put_variable`` does.
The sum is made from the forward's own tensors, so a captured step
computes it in its graph.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Dict, Iterable, Iterator, Mapping, Optional, Tuple

import torch
from torch import nn


def param_count(tree: Any) -> int:
    """The number of parameters: of a module's parameters, of a
    ``state_dict``-like mapping (every tensor counts), or of a JAX-style
    ``{"params", "state"}`` tree (its ``"params"`` only, as the JAX
    function counts them)."""
    if isinstance(tree, nn.Module):
        return sum(p.numel() for p in tree.parameters())
    if isinstance(tree, Mapping) and "params" in tree:
        tree = tree["params"]

    def count(node: Any) -> int:
        if isinstance(node, Mapping):
            return sum(count(v) for v in node.values())
        if isinstance(node, (list, tuple)):
            return sum(count(v) for v in node)
        shape = getattr(node, "shape", None)
        return int(torch.Size(shape).numel()) if shape is not None else 0

    return count(tree)


def snake(name: str) -> str:
    """``CamelCase`` -> ``camel_case``: the JAX package's default scope
    name of a layer class."""
    out = []
    for i, c in enumerate(name):
        if c.isupper() and i and not name[i - 1].isupper():
            out.append("_")
        out.append(c.lower())
    return "".join(out)


def scope_paths(model: nn.Module) -> Iterator[Tuple[str, nn.Module]]:
    """``(scope path, submodule)`` of every submodule of ``model`` (the
    model itself excluded)."""
    for name, mod in model.named_modules():
        if name:
            yield name.replace(".", "/"), mod


@contextlib.contextmanager
def recording_taps(model: nn.Module,
                   paths: Optional[Iterable[str]] = None
                   ) -> Iterator[Dict[str, Any]]:
    """A dict that fills, while the context is open, with the output of
    each submodule call keyed by scope path (all submodules, or those in
    ``paths``).  The hooks go away when the context closes, whether or not
    the forward raised."""
    taps: Dict[str, Any] = {}
    wanted = None if paths is None else set(paths)

    def hook_for(path: str):
        def hook(module, args, out):
            key, i = path, 1
            while key in taps:  # a shared module: one tap per call
                key = f"{path}#{i}"
                i += 1
            taps[key] = out
        return hook

    handles = []
    try:
        for path, mod in scope_paths(model):
            if wanted is None or path in wanted:
                handles.append(mod.register_forward_hook(hook_for(path)))
        yield taps
    finally:
        for h in handles:
            h.remove()


def apply_with_taps(model: nn.Module, *args: Any, **kwargs: Any
                    ) -> Tuple[Any, Dict[str, Any]]:
    """``model(*args, **kwargs)`` and every submodule's output keyed by its
    scope path (``"block0/mha"``): the port of ``Module.apply_with_taps``
    (the JAX function also returns the new state; here a module's state
    is its buffers, updated in place).  Runs in the model's current mode
    (``train()``/``eval()``) and leaves no hook behind, also when the
    forward raises."""
    with recording_taps(model) as taps:
        out = model(*args, **kwargs)
    return out, taps


class _AuxCtx(threading.local):
    def __init__(self) -> None:
        self.records: Optional[Dict[int, torch.Tensor]] = None


_AUX = _AuxCtx()


@contextlib.contextmanager
def aux_losses() -> Iterator[Dict[int, torch.Tensor]]:
    """Collect the aux losses that the layers record while the block runs:
    a dict of each recording module's last value (keyed by the module's
    id).  Nested collectors are independent; the outer one resumes when
    the inner one closes."""
    prev = _AUX.records
    _AUX.records = {}
    try:
        yield _AUX.records
    finally:
        _AUX.records = prev


def record_aux_loss(module: nn.Module, value: torch.Tensor) -> None:
    """``module``'s aux loss of this forward (a scalar that keeps its
    gradient), for the open :func:`aux_losses` collector; dropped when
    none is open (eval, predict, a caller's own loop)."""
    if _AUX.records is not None:
        _AUX.records[id(module)] = value


def aux_loss_sum(records: Dict[int, torch.Tensor]) -> Optional[torch.Tensor]:
    """The f32 sum of a collector's records; None when it holds none."""
    if not records:
        return None
    vals = [v.float() for v in records.values()]
    total = vals[0]
    for v in vals[1:]:
        total = total + v
    return total


__all__ = ["apply_with_taps", "aux_loss_sum", "aux_losses", "param_count",
           "record_aux_loss", "recording_taps", "scope_paths", "snake"]
