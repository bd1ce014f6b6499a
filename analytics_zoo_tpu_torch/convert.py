"""JAX variables tree <-> this package's ``state_dict``.

The JAX package keeps ``{"params": tree, "state": tree}`` where each tree is
nested dicts keyed by scope names (``nn/module.py``).  The port's modules
carry the same names as attributes, so a leaf at ``params/bert/layer_0/mha/wq``
becomes the key ``bert.layer_0.mha.wq``, and a leaf of ``state`` (batch
norm's running ``mean``/``var``) the key of a buffer.  Dense kernels keep
JAX's ``(in, out)`` layout in the port, so loading them is a plain copy.
Conv kernels are the one layout change: a 4-D leaf named ``kernel`` is
JAX's HWIO and the port's OIHW, transposed here and only here.

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
    """A 4-D conv kernel, or the ``q`` or ``scale`` of an int8 one."""
    if len(t.shape) != 4:
        return False
    return path[-1] == "kernel" or (
        len(path) > 1 and path[-2] == "kernel" and path[-1] in ("q", "scale"))


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
        out[key] = t.permute(3, 2, 0, 1).contiguous() \
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
    state_keys = set(state_keys)
    out: Dict[str, Any] = {"params": {}, "state": {}}
    for key, t in state_dict.items():
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        *path, leaf = key.split(".")
        node = out["state" if key in state_keys else "params"]
        for name in path:
            node = node.setdefault(name, {})
            if not isinstance(node, dict):
                raise ValueError(f"key {key!r} nests under a leaf")
        if leaf in node:
            raise ValueError(f"two keys map to the leaf {key!r}")
        if _is_conv_kernel((*path, leaf), t):
            t = t.permute(2, 3, 1, 0)
        node[leaf] = t.numpy().copy()
    return out


def buffer_names(model: nn.Module) -> List[str]:
    """The ``state_dict`` keys of ``model``'s buffers: its JAX ``state``."""
    keys = set(model.state_dict())
    return [name for name, _ in model.named_buffers() if name in keys]


__all__ = ["buffer_names", "from_jax_variables", "to_jax_variables"]
