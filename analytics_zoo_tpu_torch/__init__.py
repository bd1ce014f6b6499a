"""PyTorch / CUDA port of ``analytics_zoo_tpu`` for NVIDIA Hopper (H100).

The JAX package stays the reference; this package mirrors its module names
and its variable layout so that a JAX ``{"params", "state"}`` tree loads
here one-to-one (``convert.from_jax_variables``).  It imports ``torch`` and
``numpy`` only: never ``jax`` and nothing of ``analytics_zoo_tpu``.

Entry points take ``device=None``, which means the card.  When the card is
asked for and there is none they raise; they never fall back to the CPU.
Pass ``device="cpu"`` explicitly to run the plain PyTorch versions of the
kernels (the tests do).
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]


def default_device() -> torch.device:
    """The device an entry point runs on when the caller names none."""
    return torch.device("cuda")


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (``None`` -> the card); raises if a
    CUDA device is asked for and none is present."""
    dev = default_device() if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested (device=None means the card) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "the plain PyTorch path explicitly")
    return dev


__all__ = ["default_device", "resolve_device"]
