"""Launch counts across CUDA graph capture and replay.

Each kernel wrapper counts its launches in Python.  While a graph is
captured nothing runs, and a replay runs no Python: so inside
``recording()`` a wrapper's count call is recorded instead of made
(``deferred``), and ``replay`` makes the recorded calls again, once per
replay of the graph.  The counts then say how often each kernel ran.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Callable, Iterator, List, Tuple

_local = threading.local()

Recorded = List[Tuple[Callable, tuple]]


@contextlib.contextmanager
def recording() -> Iterator[Recorded]:
    """Record, on this thread, the count calls of the block (a graph's
    capture) into the list it yields."""
    prev = getattr(_local, "recorded", None)
    _local.recorded = rec = []
    try:
        yield rec
    finally:
        _local.recorded = prev


def deferred(count: Callable, *args) -> bool:
    """True, with ``count(*args)`` recorded, inside ``recording()``; False
    otherwise (the caller counts now)."""
    rec = getattr(_local, "recorded", None)
    if rec is None:
        return False
    rec.append((count, args))
    return True


def replay(rec: Recorded) -> None:
    """Make the count calls a capture recorded: one replay's launches."""
    for count, args in rec:
        count(*args)
