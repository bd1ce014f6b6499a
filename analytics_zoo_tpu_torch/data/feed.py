"""DataFeed and PrefetchIterator: host-side batching onto one device
(port of ``analytics_zoo_tpu/data/feed.py``).

The same batch order as the JAX package: each epoch shuffles row indices
with ``np.random.default_rng(seed + epoch)``, batches are fixed-size, and
the last partial batch is either dropped (``drop_remainder``, the training
default) or padded by wrapping around to the first rows, with ``step_mask``
marking the real rows so that ``evaluate`` scores every row exactly.  Each
batch is placed on the estimator's device as it is yielded.

A feed yields global batches: ``batch_size`` is the global batch.  Over
several processes every process is given the whole dataset (the same
``seed`` gives every process the same shuffle) and takes its equal slice
of each global batch, ``shard_batch``'s rows of its batch shard along the
mesh's batch axes (``BATCH_AXES``: ``data`` and ``fsdp``); ranks that
differ only along another axis (``model``) take the same rows.  A batch
that the batch axes do not divide raises there, as in the JAX package.
``FeedBase`` holds the index arithmetic that ``DataFeed`` and
``stream.StreamingDataFeed`` share.  ``PrefetchIterator`` runs a feed's epoch on a producer thread
(``Estimator.fit(prefetch=)``); with ``place`` it also places host batches
there, on the card through pinned staging and a side stream
(``PlacedBatch``: the consumer's stream waits on the copy's event).
XShards inputs are not ported yet.
"""

from __future__ import annotations

import queue as queue_mod
import threading
import time
from typing import Any, Callable, Dict, Iterator, List, Optional

import numpy as np
import torch

from ..core import metrics as _metrics_lib
from .shards import XShards


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def to_device(a: Any, device: torch.device) -> torch.Tensor:
    """A host array as a tensor on ``device``; float64 becomes float32, as
    JAX places it with 64-bit types off."""
    return torch.from_numpy(host_array(a)).to(device)


def nrows(v: Any) -> int:
    """The row count of an array or of the first leaf of a tree."""
    if isinstance(v, (tuple, list)):
        return nrows(v[0])
    if isinstance(v, dict):
        return nrows(next(iter(v.values())))
    return len(v)


def leaves(tree: Any) -> List[Any]:
    """The leaves of nested dicts, lists and tuples, in ``tree_map``'s
    order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _take(a: Any, sel: np.ndarray) -> np.ndarray:
    return np.asarray(a)[sel]


def host_array(a: Any) -> np.ndarray:
    """A leaf as a contiguous numpy array in the dtype it is placed in
    (float64 -> float32, as ``to_device``)."""
    arr = np.ascontiguousarray(a)
    return arr.astype(np.float32) if arr.dtype == np.float64 else arr


def pinned(a: Any) -> torch.Tensor:
    """A copy of a host leaf in pinned (page-locked) memory, from which a
    copy to the card runs asynchronously."""
    arr = host_array(a)
    dtype = torch.from_numpy(np.empty(0, arr.dtype)).dtype
    t = torch.empty(arr.shape, dtype=dtype, pin_memory=True)
    t.numpy()[...] = arr
    return t


class PlacedBatch(dict):
    """A batch whose tensors a producer thread copied to the card on a side
    stream, with ``ready`` recorded after the copies.  ``wait`` makes the
    consumer's stream wait on ``ready`` and marks the tensors as used
    there (``record_stream``), so the allocator does not hand their memory
    to the side stream while the consumer still reads it."""

    def __init__(self, tensors: Dict[str, Any],
                 ready: Optional["torch.cuda.Event"]):
        super().__init__(tensors)
        self.ready = ready

    def wait(self) -> "PlacedBatch":
        """Order the calling thread's current stream after the copies;
        returns the batch."""
        if self.ready is not None:
            stream = torch.cuda.current_stream(self.ready.device)
            stream.wait_event(self.ready)
            for t in leaves(dict(self)):
                t.record_stream(stream)
        return self

    def synchronize(self) -> None:
        """Block the calling thread until the copies are done."""
        if self.ready is not None:
            self.ready.synchronize()


def device_placer(device: torch.device) -> Callable[[Any], Any]:
    """Host batch -> batch on ``device``.  On the card each leaf is staged
    in pinned memory (a host copy, so the source may be reused once this
    returns) and copied on a side stream made for this placer; the result
    is a ``PlacedBatch``.  On the CPU it is ``to_device``, whose tensors
    alias the host arrays (``stream.detach_for_placement`` copies a pool
    slot's first)."""
    device = torch.device(device)
    if device.type != "cuda":
        return lambda batch: tree_map(lambda a: to_device(a, device), batch)
    stream = torch.cuda.Stream(device)

    def place(batch):
        with torch.cuda.stream(stream):
            out = tree_map(lambda a: pinned(a).to(device, non_blocking=True),
                           batch)
            ready = torch.cuda.Event()
            ready.record(stream)
        return PlacedBatch(out, ready)
    return place


BATCH_AXES = ("data", "fsdp")  # mesh axes a batch dim is sharded over


def batch_axis_size(mesh: Any) -> int:
    """The number of batch shards of ``mesh``: the product of its batch
    axes' sizes."""
    size = 1
    for a in BATCH_AXES:
        if a in mesh.axis_names:
            size *= mesh.shape[a]
    return size


def shard_batch(batch: Any, mesh: Any) -> Any:
    """This rank's rows of a global batch: block ``mesh.index(BATCH_AXES)``
    of ``batch_axis_size(mesh)`` equal blocks of every leaf's dim 0 (a
    view); the batch itself on a mesh of one batch shard.  A global batch
    the batch axes do not divide raises (there is no replicated fallback
    across processes)."""
    s = batch_axis_size(mesh)
    if s == 1:
        return batch
    k = mesh.index(BATCH_AXES)

    def take(a: Any) -> Any:
        n = nrows(a)
        if n % s:
            raise ValueError(
                f"global batch dim {n} does not divide the mesh batch axes "
                f"(size {s}); pick a batch size divisible by the data/fsdp "
                "axes in multi-process runs (no replicated fallback across "
                "processes)")
        m = n // s
        return a[k * m:(k + 1) * m]

    return tree_map(take, batch)


class FeedBase:
    """The index arithmetic every feed shares: the epoch's shuffle, fixed
    batches, the padded last batch's mask and the rows a drop_remainder
    epoch skips.  ``batch_size`` is the global batch; single process, it
    is the local batch too."""

    def __init__(self, num_samples: int, batch_size: int, shuffle: bool,
                 seed: int, drop_remainder: bool):
        self._n = num_samples
        self.global_batch = batch_size
        self._local_batch = max(1, batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder

    @property
    def num_rows(self) -> int:
        return self._n

    def steps_per_epoch(self) -> int:
        if self.drop_remainder:
            return self._n // self._local_batch
        return -(-self._n // self._local_batch)

    def epoch_index(self, epoch_idx: int) -> np.ndarray:
        """Row order for one epoch; raises if it yields no batch."""
        if self.steps_per_epoch() == 0:
            raise ValueError(
                f"dataset of {self._n} rows yields no batches of local "
                f"size {self._local_batch}")
        idx = np.arange(self._n)
        if self.shuffle:
            np.random.default_rng(self.seed + epoch_idx).shuffle(idx)
        return idx

    def batch_index(self, idx: np.ndarray, step: int) -> np.ndarray:
        sel = idx[step * self._local_batch:(step + 1) * self._local_batch]
        if len(sel) < self._local_batch:  # pad the last partial batch
            sel = np.resize(sel, self._local_batch)
        return sel

    def step_mask(self, step: int) -> np.ndarray:
        """1.0 for the rows of batch ``step`` that exist, 0.0 for padding."""
        real = min(self._local_batch,
                   max(0, self._n - step * self._local_batch))
        m = np.zeros((self._local_batch,), np.float32)
        m[:real] = 1.0
        return m

    def dropped_rows(self, epoch_idx: int = 0):
        """The rows a drop_remainder epoch skips in that epoch's order, or
        None (an unshuffled feed's are its ``remainder``)."""
        if not self.shuffle:
            return self.remainder()
        return None


class DataFeed(FeedBase):
    """An epoch-iterable source of device-resident batches over in-memory
    arrays: ``data`` is ``{"x": ..., "y": ...}`` (``y`` optional; each a
    numpy array or nested dicts/lists/tuples of them, with one row count)."""

    def __init__(self, data: Dict[str, Any], batch_size: int,
                 shuffle: bool = True, seed: int = 0,
                 drop_remainder: bool = True):
        if "x" not in data:
            raise ValueError("DataFeed requires at least an 'x' entry")
        self._data = dict(data)
        n = nrows(self._data["x"])
        for k, v in self._data.items():
            if nrows(v) != n:
                raise ValueError(
                    f"feature/label row mismatch: {k} has {nrows(v)} rows, "
                    f"x has {n}")
        super().__init__(n, batch_size, shuffle, seed, drop_remainder)

    @staticmethod
    def from_arrays(x: Any, y: Any = None, batch_size: int = 32,
                    **kw: Any) -> "DataFeed":
        data = {"x": x}
        if y is not None:
            data["y"] = y
        return DataFeed(data, batch_size, **kw)

    @staticmethod
    def from_shards(shards: XShards, batch_size: int = 32,
                    **kw: Any) -> "DataFeed":
        """Numpy-dict XShards (``{"x": ..., "y": ...}``) as one feed."""
        data = shards.concatenated()
        if not isinstance(data, dict):
            data = {"x": data}
        return DataFeed(data, batch_size, **kw)

    def remainder(self) -> Optional[Dict[str, np.ndarray]]:
        """The tail rows a drop_remainder epoch skips (unshuffled order),
        or None."""
        r = self._n % self._local_batch
        if r == 0:
            return None
        sel = np.arange(self._n - r, self._n)
        return tree_map(lambda a: _take(a, sel), self._data)

    def dropped_rows(self, epoch_idx: int = 0):
        """The rows a drop_remainder epoch skips in THIS epoch's order."""
        r = self._n % self._local_batch
        if r == 0:
            return None
        sel = self.epoch_index(epoch_idx)[self._n - r:]
        return tree_map(lambda a: _take(a, sel), self._data)

    def epoch(self, device: torch.device, epoch_idx: int = 0
              ) -> Iterator[Dict[str, Any]]:
        """One epoch's batches, each placed on ``device``.  Each step hits
        the ``feed.stall`` fault point (core/faults.py), where an armed
        delay stands for a slow storage read, and observes its host-side
        assembly (slice and placement call) in ``feed.batch_assembly_ms``."""
        from ..core import faults
        from ..core import metrics as metrics_lib
        reg = faults.get_registry()
        m_assemble = metrics_lib.get_registry().histogram(
            "feed.batch_assembly_ms")
        idx = self.epoch_index(epoch_idx)
        for step in range(self.steps_per_epoch()):
            reg.fire("feed.stall")
            t0 = time.monotonic()
            sel = self.batch_index(idx, step)
            batch = tree_map(lambda a: to_device(_take(a, sel), device),
                             self._data)
            m_assemble.observe((time.monotonic() - t0) * 1000.0)
            yield batch


class PrefetchIterator:
    """Depth-bounded background prefetch over a batch iterator (port of the
    JAX package's ``PrefetchIterator``).

    A producer thread drives the wrapped iterator (a feed's epoch: its
    batch indexing, and for an in-memory feed the placement too) and parks
    up to ``depth`` ready batches in a bounded queue; the consumer's
    ``next()`` blocks only when the feed is slower than the step, which is
    what ``train.data_wait_ms`` measures.  ``gauge`` (e.g. the
    ``train.prefetch_depth`` gauge) follows the queue's fill.

    ``place``: a callable applied to every item inside the producer
    thread (``stream.make_placer(device)`` over host batches).  On the
    card it stages the batch in pinned memory and copies it on a side
    stream; the consumer's ``next()`` makes its own stream wait on that
    copy (``PlacedBatch.wait``).  Items carrying a ``release()`` handle
    (shared-memory pool slots of the streaming feed's process backend) are
    retired one item behind the placement: once the next item is placed,
    the previous copy is waited for (its unhidden tail observed as
    ``feed.h2d_ms``) and its slot recycled.

    Exceptions from the producer re-raise in the consumer at the position
    they occurred.  ``close()`` is safe mid-epoch: it unblocks and joins
    the producer without draining the rest of the epoch."""

    _END = object()

    def __init__(self, it: Iterator, depth: int = 2,
                 gauge: Optional[Any] = None,
                 place: Optional[Callable[[Any], Any]] = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._it = iter(it)
        self._q: "queue_mod.Queue" = queue_mod.Queue(maxsize=depth)
        self._gauge = gauge
        self._place = place
        self._staged = None  # (placed, releasable raw item, dispatch ms)
        self._m_h2d = (_metrics_lib.get_registry().histogram("feed.h2d_ms")
                       if place is not None else None)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True,
                                        name="zoo-prefetch")
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                if self._gauge is not None:
                    self._gauge.set(self._q.qsize())
                return True
            except queue_mod.Full:
                continue
        return False

    def _stage(self, raw: Any) -> Any:
        """Place this item, then retire the previous one: the one-item lag
        keeps a slot from being reused while its bytes are in flight."""
        t0 = time.monotonic()
        placed = self._place(raw)
        disp_ms = (time.monotonic() - t0) * 1000.0
        self._retire()
        self._staged = (placed, raw if hasattr(raw, "release") else None,
                        disp_ms)
        return placed

    def _retire(self) -> None:
        # producer thread only (close() leaves the last slot to the
        # SlotBatch GC safety net rather than racing the producer)
        staged, self._staged = self._staged, None
        if staged is None:
            return
        placed, raw, disp_ms = staged
        if raw is not None:
            t0 = time.monotonic()
            if isinstance(placed, PlacedBatch):
                placed.synchronize()
            self._m_h2d.observe(disp_ms + (time.monotonic() - t0) * 1000.0)
            raw.release()
        else:
            # no slot to recycle: no forced wait, the dispatch half only
            self._m_h2d.observe(disp_ms)

    def _produce(self) -> None:
        try:
            for batch in self._it:
                if self._place is not None:
                    batch = self._stage(batch)
                if not self._put(("item", batch)):
                    return  # closed mid-epoch
                if self._stop.is_set():
                    return
            self._retire()
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            self._put(("error", e))
            return
        self._put((self._END, None))

    def __iter__(self) -> "PrefetchIterator":
        return self

    def __next__(self):
        if self._stop.is_set():
            raise StopIteration
        kind, payload = self._q.get()
        if self._gauge is not None:
            self._gauge.set(self._q.qsize())
        if kind == "item":
            if isinstance(payload, PlacedBatch):
                payload.wait()  # on the consumer's stream
            return payload
        self._stop.set()
        if kind == "error":
            raise payload
        raise StopIteration

    def close(self, timeout: float = 5.0) -> None:
        """Stop the producer and reclaim its thread (idempotent).  The wait
        is bounded: a producer wedged inside the wrapped iterator (a hung
        loader) is abandoned after ``timeout`` (a daemon thread, it exits
        at its next queue handoff)."""
        self._stop.set()
        deadline = time.monotonic() + timeout
        while self._thread.is_alive():
            try:  # unblock a producer stuck on a full queue
                self._q.get_nowait()
            except queue_mod.Empty:
                pass
            self._thread.join(timeout=0.05)
            if time.monotonic() > deadline:
                break
        if not self._thread.is_alive():
            close_it = getattr(self._it, "close", None)
            if close_it is not None:
                try:  # prompt generator cleanup (stream feeds join
                    close_it()  # their decode workers)
                except (RuntimeError, ValueError):
                    pass
        if self._gauge is not None:
            self._gauge.set(0.0)


def as_feed(data: Any, batch_size: int, **kw: Any) -> FeedBase:
    """The estimator's accepted data forms as a feed: a feed (``DataFeed``,
    ``StreamingDataFeed``: as is), XShards of numpy dicts, a dict ``{"x":
    ..., "y": ...}``, an ``(x, y)`` tuple, or a bare array (no labels)."""
    if isinstance(data, FeedBase):
        return data
    if isinstance(data, XShards):
        return DataFeed.from_shards(data, batch_size, **kw)
    if isinstance(data, dict):
        return DataFeed(data, batch_size, **kw)
    if isinstance(data, tuple) and len(data) == 2:
        return DataFeed.from_arrays(data[0], data[1], batch_size, **kw)
    return DataFeed.from_arrays(data, None, batch_size, **kw)
