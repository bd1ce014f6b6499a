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

import contextlib
import gc
import threading
from typing import Iterator, Optional, Union

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


_gc_lock = threading.Lock()
_gc_holds = 0
_gc_was_enabled = True


@contextlib.contextmanager
def collector_held() -> Iterator[None]:
    """Hold Python's cyclic garbage collector off, in every thread, while
    the block runs: each CUDA graph capture runs inside one.

    ``torch.cuda.graph`` no longer collects before it captures, so a dead
    reference cycle that holds an earlier graph (an estimator or a served
    model its owner dropped) could be collected while a capture is under
    way; that graph's destructor makes CUDA calls a capture forbids, and
    the capture failed with "operation not permitted when stream is
    capturing".  Nested and concurrent holds are counted: the collector
    comes back, as it was, when the last one ends."""
    global _gc_holds, _gc_was_enabled
    with _gc_lock:
        if _gc_holds == 0:
            _gc_was_enabled = gc.isenabled()
            gc.disable()
        _gc_holds += 1
    try:
        yield
    finally:
        with _gc_lock:
            _gc_holds -= 1
            if _gc_holds == 0 and _gc_was_enabled:
                gc.enable()


__all__ = ["collector_held", "default_device", "resolve_device"]
