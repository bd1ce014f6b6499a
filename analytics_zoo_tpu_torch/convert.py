"""JAX variables tree <-> this package's ``state_dict``.

The JAX package keeps ``{"params": tree, "state": tree}`` where each tree is
nested dicts keyed by scope names (``nn/module.py``).  The port's modules
carry the same names as attributes, so a leaf at ``params/bert/layer_0/mha/wq``
becomes the key ``bert.layer_0.mha.wq``, and a leaf of ``state`` (batch
norm's running ``mean``/``var``) the key of a buffer.  Dense kernels keep
JAX's ``(in, out)`` layout in the port, so loading them is a plain copy.
Conv kernels are the one layout change: a 4-D or 5-D leaf named
``kernel`` or ``*_kernel`` is JAX's HWIO / DHWIO and the port's OIHW /
OIDHW (the last two axes moved first and swapped), transposed here and
only here.  A transposed conv's 4-D kernel takes the same rule, and so
does any other 4-D kernel (``LocallyConnected2D``'s ``[oh, ow, patch,
filters]`` is ``[filters, patch, oh, ow]`` in the port).

An int8 weight of the JAX package's serving path is the dict
``{"__int8_weight__", "q", "scale"}``; each of its three leaves maps to one
key like any other (``kernel.q``, ``kernel.scale``, ``kernel.__int8_weight__``;
``nn.quant.Int8Weight`` holds them), and a conv kernel's ``q`` and
``scale`` are transposed with it.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch
from torch import nn

def _to_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().clone()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no numpy-native twin
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _is_conv_kernel(path: tuple, t: Any) -> bool:
    """A 4-D or 5-D kernel (a leaf named ``kernel`` or ``*_kernel``, such
    as a convolutional LSTM's ``recurrent_kernel``), or the ``q`` or
    ``scale`` of an int8 4-D one."""
    if len(t.shape) == 5:
        return path[-1] == "kernel" or path[-1].endswith("_kernel")
    if len(t.shape) != 4:
        return False
    return path[-1] == "kernel" or path[-1].endswith("_kernel") or (
        len(path) > 1 and path[-2] == "kernel" and path[-1] in ("q", "scale"))


def _to_torch_layout(t: torch.Tensor) -> torch.Tensor:
    """HWIO -> OIHW, DHWIO -> OIDHW: the last two axes first, reversed."""
    nd = t.dim() - 2
    return t.permute((nd + 1, nd) + tuple(range(nd)))


def _to_jax_layout(t: torch.Tensor) -> torch.Tensor:
    """OIHW -> HWIO, OIDHW -> DHWIO (a view)."""
    nd = t.dim() - 2
    return t.permute(tuple(range(2, nd + 2)) + (1, 0))


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a JAX ``{"params", "state"}`` tree (numpy or JAX arrays) into
    a ``state_dict``; every leaf becomes exactly one key (conv kernels
    transposed HWIO -> OIHW).  Empty subtrees (parameter-free children such
    as dropout) produce no key.  An int8 weight's three leaves become three
    keys."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: tuple) -> None:
        if isinstance(node, Mapping):
            for name, child in node.items():
                walk(child, path + (str(name),))
            return
        key = ".".join(path)
        if key in out:
            raise ValueError(f"two leaves map to the key {key!r}")
        t = _to_tensor(node)
        out[key] = _to_torch_layout(t).contiguous() \
            if _is_conv_kernel(path, t) else t

    for part in ("params", "state"):
        walk(variables.get(part, {}), ())
    return out


def to_jax_variables(state_dict: Mapping[str, torch.Tensor],
                     state_keys: Iterable[str] = ()) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_variables`: a ``state_dict`` as a JAX
    ``{"params", "state"}`` tree of numpy arrays (keys split at ``.``).
    Keys in ``state_keys`` (a model's :func:`buffer_names`) go under
    ``"state"``, every other under ``"params"``; conv kernels go back to
    HWIO (an int8 one's ``q`` and ``scale`` too).  numpy has no bfloat16,
    so bf16 tensors come back as float32 arrays (exact: every bf16 value
    is an f32 value)."""
    def host(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: host(v) for k, v in node.items()}
        t = node.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy().copy()

    return host(jax_variables(state_dict, state_keys))


def jax_variables(state_dict: Mapping[str, torch.Tensor],
                  state_keys: Iterable[str] = ()) -> Dict[str, Any]:
    """:func:`to_jax_variables`'s tree over the tensors themselves (conv
    kernels as HWIO views, dtypes kept): what a checkpoint snapshots."""
    state_keys = set(state_keys)
    return {part: jax_tree((k, v) for k, v in state_dict.items()
                           if (k in state_keys) == (part == "state"))
            for part in ("params", "state")}


def jax_tree(named: Iterable[Any]) -> Dict[str, Any]:
    """``(state_dict key, tensor)`` pairs as the JAX tree they form (keys
    split at ``.``), each leaf the tensor itself or, for a conv kernel, its
    HWIO view: no copy, so ``copy_`` into a leaf writes the tensor (how an
    optimizer's state in optax's layout is loaded in place)."""
    out: Dict[str, Any] = {}
    for key, t in named:
        *path, leaf = key.split(".")
        node = out
        for name in path:
            node = node.setdefault(name, {})
            if not isinstance(node, dict):
                raise ValueError(f"key {key!r} nests under a leaf")
        if leaf in node:
            raise ValueError(f"two keys map to the leaf {key!r}")
        node[leaf] = _to_jax_layout(t) \
            if _is_conv_kernel((*path, leaf), t) else t
    return out


def buffer_names(model: nn.Module) -> List[str]:
    """The ``state_dict`` keys of ``model``'s buffers: its JAX ``state``."""
    keys = set(model.state_dict())
    return [name for name, _ in model.named_buffers() if name in keys]


__all__ = ["buffer_names", "from_jax_variables", "jax_tree",
           "jax_variables", "to_jax_variables"]
