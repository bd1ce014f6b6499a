"""JAX variables tree -> this package's ``state_dict``.

The JAX package keeps ``{"params": tree, "state": tree}`` where each tree is
nested dicts keyed by scope names (``nn/module.py``).  The port's modules
carry the same names as attributes, so a leaf at ``params/bert/layer_0/mha/wq``
becomes the key ``bert.layer_0.mha.wq``.  Dense kernels keep JAX's
``(in, out)`` layout in the port, so loading is a plain copy: no transpose.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _to_tensor(leaf: Any) -> torch.Tensor:
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":  # ml_dtypes' bf16: no numpy-native twin
        return torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def from_jax_variables(variables: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Flatten a JAX ``{"params", "state"}`` tree (numpy or JAX arrays) into
    a ``state_dict``; every leaf becomes exactly one key.  Empty subtrees
    (parameter-free children such as dropout) produce no key."""
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Any, path: tuple) -> None:
        if isinstance(node, Mapping):
            for name, child in node.items():
                walk(child, path + (str(name),))
            return
        key = ".".join(path)
        if key in out:
            raise ValueError(f"two leaves map to the key {key!r}")
        out[key] = _to_tensor(node)

    for part in ("params", "state"):
        walk(variables.get(part, {}), ())
    return out


__all__ = ["from_jax_variables"]
