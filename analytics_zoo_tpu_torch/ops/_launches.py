"""Launch counts across CUDA graph capture and replay.

Each kernel wrapper counts its launches in Python.  While a graph is
captured nothing runs, and a replay runs no Python: so inside
``recording(stream)`` a wrapper's count call made on the capturing stream
is recorded instead of made (``deferred``), and ``replay`` makes the
recorded calls again, once per replay of the graph.  The counts then say
how often each kernel ran.  The rule is the stream's, not the thread's: a
capture of a train step launches its backward kernels from autograd's own
thread, on the forward's stream.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Dict, Iterator, List, Tuple

Recorded = List[Tuple[Callable, tuple]]

_lock = threading.Lock()
# capturing stream (its cuda_stream handle) -> the list its counts go to
_streams: Dict[int, Recorded] = {}


def _current_stream() -> int:
    """The handle of the calling thread's current CUDA stream."""
    import torch
    return torch.cuda.current_stream().cuda_stream


@contextlib.contextmanager
def recording(stream: object) -> Iterator[Recorded]:
    """Record the count calls made on ``stream`` (a ``torch.cuda.Stream``:
    the one a graph captures), from any thread, while the block runs, into
    the list it yields."""
    key = stream.cuda_stream
    rec: Recorded = []
    with _lock:
        _streams[key] = rec
    try:
        yield rec
    finally:
        with _lock:
            _streams.pop(key, None)


def deferred(count: Callable, *args) -> bool:
    """True, with ``count(*args)`` recorded, when called on a stream inside
    ``recording``; False otherwise (the caller counts now)."""
    if not _streams:
        return False
    key = _current_stream()
    with _lock:
        rec = _streams.get(key)
    if rec is None:
        return False
    rec.append((count, args))
    return True


def replay(rec: Recorded) -> None:
    """Make the count calls a capture recorded: one replay's launches."""
    for count, args in rec:
        count(*args)
