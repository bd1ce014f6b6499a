"""Preallocated shared-memory batch-buffer pool for multi-process decode
(a copy of ``analytics_zoo_tpu/data/shm_pool.py``: framework-neutral, kept
in the port so that it imports nothing of the JAX package).

The streaming feed's process backend (data/stream.py) forks decode
workers; the expensive part of multi-process input pipelines is normally
the transport — pickling every decoded row through a ``multiprocessing``
queue costs a serialize + copy + deserialize per row (tens of MB/s of
pure overhead at ImageNet scale).  This pool removes the transport
entirely: the parent preallocates ``slots`` batch-sized buffers in
``multiprocessing.shared_memory`` **before forking**, so parent and
children share the same physical pages, and a worker decodes each row
*directly into its batch's final position* (no per-row pickle, no
per-batch ``np.stack``).  The only thing that crosses the process
boundary per batch is a few-int control message.

Lifecycle contract:

- slots circulate through a fork-safe free queue: ``acquire()`` blocks
  when every slot is in flight — that bound IS the feed's memory bound
  (the process analog of workers blocking on the full native queue);
- ``release(slot)`` is idempotent per cycle and callable from any
  parent thread (the feed releases a crashed worker's half-written slot
  on its behalf);
- ``close()`` unlinks every segment (idempotent; also attempted on GC),
  so an exhausted or abandoned epoch leaves nothing in ``/dev/shm`` —
  asserted by test.

``available()`` gates the whole backend: no ``shared_memory`` module or
no ``fork`` start method (the backend relies on fork inheritance so the
user's ``load_sample`` closure never needs to be picklable) means the
feed falls back to threads.
"""

from __future__ import annotations

import logging
import os
import queue as pyqueue
import threading
import uuid
from typing import Dict, Optional, Tuple

import numpy as np

logger = logging.getLogger("analytics_zoo_tpu_torch")

#: /dev/shm name prefix for every segment this pool creates — leak checks
#: (tests, ops) can glob for it.  Not the JAX package's ``zoofeed``, so
#: that a leak check of one package never counts the other's live pools.
SHM_PREFIX = "zootorchfeed"

_ALIGN = 64  # per-key offset alignment inside a slot segment


def available() -> bool:
    """Can the process decode backend run here?  Needs
    ``multiprocessing.shared_memory`` (py3.8+) and the ``fork`` start
    method (Linux; fork inheritance is what makes arbitrary
    ``load_sample`` closures work without pickling)."""
    try:
        from multiprocessing import shared_memory  # noqa: F401
        import multiprocessing as mp
        return "fork" in mp.get_all_start_methods()
    except (ImportError, AttributeError):
        return False


class ShmBatchPool:
    """``slots`` preallocated batch buffers in POSIX shared memory.

    ``spec``: ``{key: (row_shape, dtype)}`` — one fixed-size segment per
    slot holds every key's ``[batch, *row_shape]`` array at an aligned
    offset.  ``views(slot)`` returns zero-copy numpy views over the
    slot; the views built here (pre-fork) are inherited by forked
    workers, so both sides address the same pages.
    """

    def __init__(self, slots: int, batch: int,
                 spec: Dict[str, Tuple[Tuple[int, ...], np.dtype]],
                 ctx=None):
        from multiprocessing import shared_memory
        if ctx is None:
            import multiprocessing as mp
            ctx = mp.get_context("fork")
        if slots < 2:
            raise ValueError(f"pool needs >= 2 slots (one filling, one "
                             f"consuming), got {slots}")
        self.slots = slots
        self.batch = batch
        self.spec = {k: (tuple(shape), np.dtype(dt))
                     for k, (shape, dt) in spec.items()}
        # segment layout: aligned per-key offsets
        offsets: Dict[str, int] = {}
        off = 0
        for k, (shape, dt) in self.spec.items():
            nbytes = int(batch * int(np.prod(shape, dtype=np.int64))
                         * dt.itemsize)
            offsets[k] = off
            off += -(-nbytes // _ALIGN) * _ALIGN
        self._nbytes = max(off, _ALIGN)
        self._offsets = offsets
        self._segs = []
        self._views = []
        self._closed = False
        self._close_lock = threading.Lock()
        run = uuid.uuid4().hex[:8]
        try:
            for s in range(slots):
                seg = shared_memory.SharedMemory(
                    create=True, size=self._nbytes,
                    name=f"{SHM_PREFIX}_{os.getpid()}_{run}_{s}")
                self._segs.append(seg)
                self._views.append({
                    k: np.ndarray((batch,) + shape, dtype=dt,
                                  buffer=seg.buf, offset=offsets[k])
                    for k, (shape, dt) in self.spec.items()})
        except BaseException:
            self.close()
            raise
        # fork-safe slot circulation; qsize() on Linux is exact enough
        # for the feed.shm_in_use gauge
        self._free = ctx.Queue()
        for s in range(slots):
            self._free.put(s)

    # -- slot circulation -----------------------------------------------------

    def acquire(self, timeout: Optional[float] = None) -> Optional[int]:
        """Next free slot id; blocks (the memory bound) until one is
        released.  None on timeout."""
        try:
            return self._free.get(timeout=timeout)
        except pyqueue.Empty:
            return None

    def release(self, slot: int) -> None:
        """Return a slot to the free queue (no-op after close)."""
        if self._closed:
            return
        try:
            self._free.put(slot)
        except (ValueError, OSError, AssertionError):
            pass  # pool closing under us: segments are being unlinked

    def views(self, slot: int) -> Dict[str, np.ndarray]:
        """Zero-copy ``{key: [batch, *row_shape]}`` numpy views over the
        slot's shared pages (same dict object every call)."""
        return self._views[slot]

    def in_use(self) -> int:
        """Approximate slots currently out of the free queue."""
        if self._closed:
            return 0
        try:
            return self.slots - self._free.qsize()
        except (NotImplementedError, OSError):
            return 0

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        """Unlink every segment (idempotent).  Parent-only: children
        never unlink — the parent owns segment lifetime, which is what
        keeps a crashed worker from taking the pool down with it."""
        with self._close_lock:
            if self._closed:
                return
            self._closed = True
        free = getattr(self, "_free", None)
        if free is not None:
            try:
                free.close()
                free.cancel_join_thread()
            except (OSError, AttributeError):
                pass
        self._views = []
        for seg in self._segs:
            try:
                seg.close()
            except (OSError, BufferError):
                pass
            try:
                seg.unlink()
            except FileNotFoundError:
                pass
            except OSError:
                pass
        self._segs = []

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass


class SlotBatch(dict):
    """One decoded batch living in a pool slot: a plain dict of
    zero-copy numpy views plus the slot's release handle.

    The consumer (or the feed's placed path, after the device copy of
    the batch completes) calls ``release()`` to return the slot;
    holding a view past release means the pool may overwrite it — the
    standard buffer-pool contract.  GC releases as a safety net, so a
    consumer that copies (``np.stack``/``np.asarray``) and drops the
    batch keeps the pipeline flowing without ever naming the slot."""

    def __init__(self, views: Dict[str, np.ndarray], slot: int,
                 pool: ShmBatchPool):
        super().__init__(views)
        self._slot = slot
        self._pool = pool

    def release(self) -> None:
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.release(self._slot)

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 — GC during teardown
            pass
