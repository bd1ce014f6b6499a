"""JAX variables tree <-> this package's ``state_dict``.

The JAX package keeps ``{"params": tree, "state": tree}`` where each tree is
nested dicts keyed by scope names (``nn/module.py``).  The port's modules
carry the same names as attributes, so a leaf at ``params/bert/layer_0/mha/wq``
becomes the key ``bert.layer_0.mha.wq``, and a leaf of ``state`` (batch
norm's running ``mean``/``var``) the key of a buffer.  Dense kernels keep
JAX's ``(in, out)`` layout in the port, so loading them is a plain copy.
Conv kernels are the one layout change: a 4-D leaf named ``kernel`` is
JAX's HWIO and the port's OIHW, transposed here and only here.
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch
from torch import nn

# the JAX package's marker key of an int8-quantized weight
_INT8_MARKER = "__int8_weight__"


def _to_tensor(leaf: Any) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no numpy-native twin
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _is_conv_kernel(leaf: str, t: Any) -> bool:
    return leaf == "kernel" and len(t.shape) == 4


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a JAX ``{"params", "state"}`` tree (numpy or JAX arrays) into
    a ``state_dict``; every leaf becomes exactly one key (conv kernels
    transposed HWIO -> OIHW).  Empty subtrees (parameter-free children such
    as dropout) produce no key.  An int8-quantized weight raises
    ``NotImplementedError``."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: tuple) -> None:
        if isinstance(node, Mapping):
            if _INT8_MARKER in node:
                raise NotImplementedError(
                    f"int8 weight at {'/'.join(path)}: the int8 serving "
                    "path is not ported yet (ROADMAP Queue 1 item 1)")
            for name, child in node.items():
                walk(child, path + (str(name),))
            return
        key = ".".join(path)
        if key in out:
            raise ValueError(f"two leaves map to the key {key!r}")
        t = _to_tensor(node)
        out[key] = t.permute(3, 2, 0, 1).contiguous() \
            if _is_conv_kernel(path[-1], t) else t

    for part in ("params", "state"):
        walk(variables.get(part, {}), ())
    return out


def to_jax_variables(state_dict: Mapping[str, torch.Tensor],
                     state_keys: Iterable[str] = ()) -> Dict[str, Any]:
    """The inverse of :func:`from_jax_variables`: a ``state_dict`` as a JAX
    ``{"params", "state"}`` tree of numpy arrays (keys split at ``.``).
    Keys in ``state_keys`` (a model's :func:`buffer_names`) go under
    ``"state"``, every other under ``"params"``; conv kernels go back to
    HWIO.  numpy has no bfloat16, so bf16 tensors come back as float32
    arrays (exact: every bf16 value is an f32 value)."""
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
        if _is_conv_kernel(leaf, t):
            t = t.permute(2, 3, 1, 0)
        node[leaf] = t.numpy().copy()
    return out


def buffer_names(model: nn.Module) -> List[str]:
    """The ``state_dict`` keys of ``model``'s buffers: its JAX ``state``."""
    keys = set(model.state_dict())
    return [name for name, _ in model.named_buffers() if name in keys]


__all__ = ["buffer_names", "from_jax_variables", "to_jax_variables"]
