"""GraphNet surgery (``analytics_zoo_tpu/models/graphnet.py``): a model's
intermediate outputs as a new model, for feature extraction and transfer
learning; freezing is the Estimator's ``frozen=``.

``GraphNet(resnet, ["layer4_2_relu_2"])`` outputs the activation at that
scope path of the base (``nn.module.apply_with_taps``'s keys).  At top
level it shares the base's tree: its ``state_dict``, ``load_state_dict``,
``named_parameters`` and ``named_buffers`` are the base's, so a checkpoint
of the base loads straight in (the JAX ``GraphNet.init`` returns the base's
variables).  Embedded as a child of another module, the base sits under
``base`` (``<child>.base.<...>``), as in the JAX tree.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..nn.module import recording_taps, scope_paths


class GraphNet(nn.Module):
    """``base`` with the outputs at ``outputs`` (scope paths relative to
    the base, such as ``["block3", "block3/mha"]``): one tensor, or a
    tuple when several.  A path that is not a key picks the one key that
    ends with it (the JAX ``_select``'s suffix rule); none or several
    raise."""

    def __init__(self, base: nn.Module, outputs: Sequence[str]):
        super().__init__()
        self.base = base
        self.outputs = list(outputs)
        if not self.outputs:
            raise ValueError("GraphNet needs at least one output path")

    def _select(self, taps: Dict[str, Any]) -> Any:
        sel = []
        for p in self.outputs:
            key = p
            if key not in taps:
                close = sorted(k for k in taps if k.endswith(p))
                if len(close) != 1:
                    raise KeyError(f"no submodule output at {p!r}; "
                                   f"available: {sorted(taps)[:20]}")
                key = close[0]
            sel.append(taps[key])
        return sel[0] if len(sel) == 1 else tuple(sel)

    def _paths(self) -> Optional[List[str]]:
        """The base's scope paths to hook: the outputs' own, where each
        names exactly one submodule (exact or by suffix); None (hook all)
        when one may be a second call of a shared module."""
        known = [p for p, _ in scope_paths(self.base)]
        paths = []
        for p in self.outputs:
            if "#" in p:
                return None
            hit = [p] if p in known else [k for k in known if k.endswith(p)]
            if len(hit) != 1:
                return None
            paths.append(hit[0])
        return paths

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        with recording_taps(self.base, self._paths()) as taps:
            self.base(*args, **kwargs)
        return self._select(taps)

    # -- at top level the base's tree -------------------------------------

    def state_dict(self, *args: Any, destination: Any = None,
                   prefix: str = "", keep_vars: bool = False):
        if prefix or args:
            return super().state_dict(*args, destination=destination,
                                      prefix=prefix, keep_vars=keep_vars)
        return self.base.state_dict(destination=destination,
                                    keep_vars=keep_vars)

    def load_state_dict(self, state_dict: Any, strict: bool = True,
                        assign: bool = False):
        return self.base.load_state_dict(state_dict, strict=strict,
                                         assign=assign)

    def named_parameters(self, prefix: str = "", recurse: bool = True,
                         remove_duplicate: bool = True
                         ) -> Iterator[Tuple[str, nn.Parameter]]:
        if prefix:
            return super().named_parameters(prefix, recurse,
                                            remove_duplicate)
        return self.base.named_parameters(prefix, recurse, remove_duplicate)

    def named_buffers(self, prefix: str = "", recurse: bool = True,
                      remove_duplicate: bool = True
                      ) -> Iterator[Tuple[str, torch.Tensor]]:
        if prefix:
            return super().named_buffers(prefix, recurse, remove_duplicate)
        return self.base.named_buffers(prefix, recurse, remove_duplicate)


__all__ = ["GraphNet"]
