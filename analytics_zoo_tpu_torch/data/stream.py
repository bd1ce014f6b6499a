"""StreamingDataFeed: bounded-memory input pipeline over the native queue
(port of ``analytics_zoo_tpu/data/stream.py``: the same workers, queue,
step ordering, slot pool, retries, fault points, counters and spans; the
batches land on a torch device instead of a mesh).

Reference (SURVEY.md §2.2): FeatureSet cached the training set in DRAM/PMEM
native arrays and fed per-worker mini-batches; the PMEM path existed
precisely because datasets outgrow RAM.  DataFeed (feed.py) is the
whole-dataset-in-RAM analog — fine for MNIST, disqualifying for ImageNet.

This feed never materializes the dataset: decode workers pull sample
indices, run the user loader (decode + augment for images), and assemble
batches.  The bounded C++ MPMC queue (native/zoo_native.cpp) is the
synchronization/backpressure primitive between decoders and the consumer:
producers push an 8-byte batch token (blocking when the bound is hit — that
bound IS the memory bound), while the batch arrays themselves stay
in-process in a token-keyed dict, so no payload bytes are copied.  The
consumer reorders tokens so batches always arrive in STEP ORDER regardless
of worker timing (predict depends on row order; training gets reproducible
batch sequences), and double-buffers device placement so the host→device
copy of batch N+1 overlaps compute of batch N.

Two decode backends (``workers=``):

- ``"thread"`` (default): worker THREADS — zero setup cost, fine when the
  loader releases the GIL (PIL decode, file I/O), and the
  bisection-safe path: its batch sequences are byte-identical to the
  pre-backend code.
- ``"process"``: worker PROCESSES writing rows **directly into a pool of
  preallocated ``multiprocessing.shared_memory`` batch buffers**
  (data/shm_pool.py).  A GIL-bound decode (numpy augment chains, JPEG
  headers, tensor packing) serializes threads at ~1 core; processes scale
  it across the host.  Zero-copy assembly: no per-row pickle, no
  per-batch ``np.stack`` — each row is decoded into its batch's final
  position in shared pages, and only a few-int control message crosses
  the process boundary per batch.  Workers are FORKED so the loader
  closure never needs to be picklable; slot acquisition happens in step
  order (under the step-claim lock), which makes the pool bound
  deadlock-free by construction.  Falls back to ``"thread"`` (with a
  warning) where ``shared_memory``/fork are unavailable.

The backpressure/step-ordering contracts are shared: the native queue
still carries 8-byte step tokens — under the process backend each token
names a batch that lives in a shm slot — and the consumer logic is
literally the same function.

Loader resilience: at ImageNet scale a corrupt JPEG or a flaky filesystem
read is routine, and a single exception must not cost an epoch.  Each
sample read gets ``retries`` bounded retries; after that,
``on_error="skip"`` substitutes a neighboring sample and counts the loss
(``skipped_rows``/``load_failures`` make the degradation visible, and
``max_skipped`` bounds it), while the default ``on_error="raise"``
propagates the failure to the consumer.  The ``feed.read_fail`` injection
point (core/faults.py) makes both paths deterministically testable; forked
workers inherit the armed registry and their hit/fire counts are absorbed
back into the parent registry at epoch end.

Same interface as DataFeed (both subclass feed.FeedBase), so Estimator.fit
takes either interchangeably.

Forked workers and the card: by the time an epoch forks its workers the
parent usually holds a CUDA context, which a child cannot use (torch marks
a forked child as such and raises on any CUDA call there).  The children
therefore run only the loader, on numpy, and write into the pool's shared
pages; every tensor is made in the parent.
"""

from __future__ import annotations

import logging
import queue as pyqueue
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from ..core import metrics as metrics_lib
from ..core import trace as trace_lib
from ..core.config import ZooConfig
from ..native import NativeQueue
from . import shm_pool
from .feed import FeedBase, PlacedBatch, device_placer
from .shm_pool import ShmBatchPool, SlotBatch

logger = logging.getLogger("analytics_zoo_tpu_torch")

_ERROR_TOKEN = (1 << 63) - 1

#: How many alternative indices a skipped sample may be substituted with
#: before the failure is treated as systemic and re-raised.
_MAX_FALLBACK_TRIES = 8

#: Valid ``workers=`` backends.
FEED_BACKENDS = ("thread", "process")


def detach_for_placement(batch: Dict[str, np.ndarray],
                         device: torch.device) -> Dict[str, np.ndarray]:
    """Make a pool-slot batch safe to place on ``device``.

    On the card placement stages the batch in pinned memory, a host copy,
    so the slot may be recycled once the placement returns.  On the CPU,
    however, ``torch.from_numpy`` aliases the slot: the "placed" tensor
    would be overwritten when the slot is reused, or fault once it is
    unlinked.  On the CPU we therefore detach with one host memcpy first;
    elsewhere this is a passthrough."""
    if torch.device(device).type == "cpu":
        return {k: np.array(v) for k, v in batch.items()}
    return batch


def make_placer(device: torch.device):
    """``feed.device_placer`` wrapped with the pool-slot detach rule — the
    ``place=`` callable for ``PrefetchIterator`` when iterating a feed's
    host-batch epoch (``epoch(place=False)``)."""
    device = torch.device(device)
    place_on = device_placer(device)

    def place(batch):
        if isinstance(batch, SlotBatch):
            batch = detach_for_placement(batch, device)
        return place_on(batch)
    return place


class StreamingDataFeed(FeedBase):
    """Index-based streaming loader: ``load_sample(i, rng)`` → sample dict.

    ``retries``: per-sample reload attempts after a loader exception
    (0 = fail on first exception).  ``on_error``: what to do once retries
    are exhausted — ``"raise"`` (default) aborts the epoch with the
    loader's exception; ``"skip"`` substitutes the next loadable sample
    index and increments ``skipped_rows``.  ``max_skipped`` (with
    ``"skip"``) bounds silent degradation: exceeding it raises.

    ``workers``: decode backend — ``"thread"`` (default; also the
    ``ZooConfig.feed_backend`` default) or ``"process"`` (shared-memory
    slot pool, see module docstring).  ``num_workers`` defaults to
    ``ZooConfig.feed_workers`` (else 4)."""

    def __init__(self, num_samples: int,
                 load_sample: Callable[..., Dict[str, np.ndarray]],
                 batch_size: int, shuffle: bool = True, seed: int = 0,
                 num_workers: Optional[int] = None,
                 prefetch_batches: int = 4,
                 drop_remainder: bool = True,
                 retries: int = 0, on_error: str = "raise",
                 max_skipped: Optional[int] = None,
                 workers: Optional[str] = None):
        super().__init__(num_samples, batch_size, shuffle, seed,
                         drop_remainder)
        if on_error not in ("raise", "skip"):
            raise ValueError(f"on_error must be 'raise' or 'skip', "
                             f"got {on_error!r}")
        if retries < 0:
            raise ValueError(f"retries must be >= 0, got {retries}")
        if num_workers is None:
            cfg_workers = ZooConfig.feed_workers
            num_workers = 4 if cfg_workers is None else cfg_workers
        if workers is None:
            workers = ZooConfig.feed_backend
        if workers not in FEED_BACKENDS:
            raise ValueError(f"workers must be one of {FEED_BACKENDS}, "
                             f"got {workers!r}")
        if workers == "process" and not shm_pool.available():
            logger.warning(
                "workers='process' needs multiprocessing.shared_memory and "
                "the fork start method; falling back to workers='thread'")
            workers = "thread"
        self.workers = workers
        self._load = load_sample
        self.num_workers = max(1, num_workers)
        self.prefetch_batches = max(1, prefetch_batches)
        self.retries = retries
        self.on_error = on_error
        self.max_skipped = max_skipped
        self._counter_lock = threading.Lock()
        self.skipped_rows = 0    # rows substituted because their sample
        #                          never loaded (on_error="skip")
        self.load_failures = 0   # loader exceptions seen (incl. retried)
        self._spec = None        # probed {key: (row_shape, dtype)}
        # optional loader protocols (duck-typed off the bound method's
        # owner, e.g. ImageSet): ``hint_indices(list)`` lets a readahead
        # reader start fetching a batch's files before decode asks for
        # them; ``feed_stats() -> {"io_wait_ms": ...}`` exposes the
        # calling worker's cumulative blocked-on-storage time
        owner = getattr(load_sample, "__self__", None)
        self._hint_fn = getattr(owner, "hint_indices", None)
        self._stats_fn = getattr(owner, "feed_stats", None)
        # telemetry (core/metrics.py): per-sample load latency + the
        # resilience counters mirrored process-wide, so "is the input
        # pipeline degrading?" is answerable without holding the feed
        reg = metrics_lib.get_registry()
        self._m_load = reg.histogram("feed.load_ms")
        self._m_failures = reg.counter("feed.load_failures")
        self._m_retries = reg.counter("feed.retries")
        self._m_skipped = reg.counter("feed.skipped_rows")
        # decoded-batch lookahead occupancy (high-water mark = realized
        # prefetch depth): a gauge pinned at 0 means the consumer eats
        # batches as fast as the workers decode them — the feed, not the
        # device, is the bottleneck
        self._m_ready = reg.gauge("feed.ready_depth")
        # per-stage breakdown of the input pipeline (bench.py
        # input_pipeline reads these): whole-batch decode wall, the part
        # of it spent blocked on storage, shm-slot occupancy, and the
        # host→device copy time not hidden by the pipeline
        self._m_decode = reg.histogram("feed.decode_ms")
        self._m_io = reg.histogram("feed.io_wait_ms")
        self._m_shm = reg.gauge("feed.shm_in_use")
        self._m_h2d = reg.histogram("feed.h2d_ms")
        # span tree (core/trace.py): one trace id per epoch; per-batch
        # decode spans hang under the epoch root — the thread backend
        # records them in the worker, the process backend forwards the
        # timings over the existing control-message channel and the
        # parent records them (children can't reach the parent's ring)
        self.trace_id: Optional[str] = None
        self._epoch_sid: Optional[str] = None

    def _begin_epoch_trace(self, epoch_idx: int) -> None:
        if trace_lib.enabled:
            self.trace_id = trace_lib.new_trace_id()
            self._epoch_sid = trace_lib.new_span_id()
        else:
            self.trace_id = self._epoch_sid = None

    def _record_decode_span(self, step: int, decode_ms: float,
                            io_ms: float) -> None:
        if self.trace_id is not None:
            trace_lib.record(
                self.trace_id, "feed.decode",
                {"step": step, "decode_ms": round(decode_ms, 3),
                 "io_wait_ms": round(io_ms, 3)},
                parent=self._epoch_sid, dur_ms=decode_ms)

    def _end_epoch_trace(self, epoch_idx: int, steps: int,
                         t0: float) -> None:
        if self.trace_id is not None:
            trace_lib.record(
                self.trace_id, "feed.epoch",
                {"epoch": epoch_idx, "steps": steps,
                 "backend": self.workers},
                span_id=self._epoch_sid,
                dur_ms=(time.monotonic() - t0) * 1000.0)

    # -- resilient sample loading --------------------------------------------

    def _fault_registry(self):
        from ..core import faults
        return faults.get_registry()

    # Counter updates are routed through these three so the process
    # backend's forked workers can re-bind them to fork-shared values
    # (plain ints on a forked copy of ``self`` would be invisible to the
    # parent and to sibling workers — max_skipped must bound the GLOBAL
    # skip count, exactly like the thread backend's shared lock does).

    def _note_failure(self) -> None:
        with self._counter_lock:
            self.load_failures += 1
        self._m_failures.inc()

    def _note_retry(self) -> None:
        self._m_retries.inc()

    def _note_skip(self) -> int:
        with self._counter_lock:
            self.skipped_rows += 1
            skipped = self.skipped_rows
        self._m_skipped.inc()
        return skipped

    def _hint_rows(self, sel: Sequence[int]) -> None:
        """Advisory: tell a readahead-capable loader which rows decode
        next, so file reads overlap the current batch's decode."""
        if self._hint_fn is None:
            return
        try:
            self._hint_fn([int(i) for i in sel])
        except Exception:  # noqa: BLE001 — readahead is best-effort
            logger.debug("readahead hint failed", exc_info=True)

    def _io_wait_ms(self) -> float:
        """The calling worker's cumulative blocked-on-storage ms, 0.0 for
        loaders without the ``feed_stats`` protocol."""
        if self._stats_fn is None:
            return 0.0
        try:
            return float(self._stats_fn().get("io_wait_ms", 0.0))
        except Exception:  # noqa: BLE001 — stats are best-effort
            return 0.0

    def _load_with_retry(self, i: int, rng,
                         inject: bool = True) -> Dict[str, np.ndarray]:
        """One sample through the loader with ``retries`` bounded retries.
        The ``feed.read_fail`` injection point sits INSIDE the attempt so
        an armed fault exercises the same except-clause a real corrupt
        read would — and is retried the same way.  ``inject=False`` for
        fallback substitution loads, so a fault armed against the primary
        sample cannot cascade into every substitute."""
        last: Optional[BaseException] = None
        for _attempt in range(self.retries + 1):
            try:
                if _attempt:
                    self._note_retry()
                if inject:
                    self._fault_registry().raise_if("feed.read_fail",
                                                    OSError)
                t0 = time.monotonic()
                out = self._load(i, rng=rng)
                self._m_load.observe((time.monotonic() - t0) * 1000.0)
                return out
            except Exception as e:  # noqa: BLE001 — loader bugs vary freely
                last = e
                self._note_failure()
        assert last is not None
        raise last

    def _load_row(self, i: int, rng) -> Dict[str, np.ndarray]:
        """Sample ``i`` with retry + optional skip-and-substitute."""
        try:
            return self._load_with_retry(i, rng)
        except Exception:
            if self.on_error != "skip":
                raise
            skipped = self._note_skip()
            if self.max_skipped is not None and skipped > self.max_skipped:
                raise RuntimeError(
                    f"streaming feed skipped {skipped} rows "
                    f"(max_skipped={self.max_skipped}): loader failures "
                    "are no longer a tolerable minority") from None
            # substitute neighboring samples (no injection hits, plain
            # retries only) so the batch keeps its static shape
            for k in range(1, _MAX_FALLBACK_TRIES + 1):
                alt = (i + k) % self._n
                try:
                    return self._load_with_retry(alt, rng, inject=False)
                except Exception:
                    continue
            raise RuntimeError(
                f"sample {i} and {_MAX_FALLBACK_TRIES} fallback samples all "
                "failed to load: the failure is systemic, not per-sample")

    # -- tail coverage --------------------------------------------------------

    def _load_tail(self, sel: List[int]) -> Dict[str, np.ndarray]:
        """Tail rows (remainder / dropped_rows) through the worker pool.
        A serial reload of an ImageNet-sized tail used to stall the epoch
        boundary on the caller thread; now up to ``num_workers`` threads
        load concurrently.  Determinism: single-worker feeds keep the
        historical sequential rng stream; parallel loads give each row
        its own ``(seed, i)``-derived rng so the result is independent of
        completion order."""
        self._hint_rows(sel)
        if self.num_workers <= 1 or len(sel) <= 1:
            rng = np.random.default_rng(self.seed)
            rows = [self._load_row(int(i), rng) for i in sel]
        else:
            from concurrent.futures import ThreadPoolExecutor
            with ThreadPoolExecutor(
                    max_workers=min(self.num_workers, len(sel)),
                    thread_name_prefix="zoo-feed-tail") as ex:
                rows = list(ex.map(
                    lambda i: self._load_row(
                        int(i), np.random.default_rng((self.seed, int(i)))),
                    sel))
        return {k: np.stack([row[k] for row in rows]) for k in rows[0]}

    def remainder(self) -> Optional[Dict[str, np.ndarray]]:
        r = self._n % self._local_batch
        if r == 0:
            return None
        return self._load_tail(list(range(self._n - r, self._n)))

    def dropped_rows(self, epoch_idx: int = 0):
        """Exact drop_remainder coverage even when shuffled: reload the
        tail of this epoch's permutation through the sample loader."""
        r = self._n % self._local_batch
        if r == 0:
            return None
        sel = self.epoch_index(epoch_idx)[self._n - r:]
        return self._load_tail([int(i) for i in sel])

    # -- epoch iteration ------------------------------------------------------

    def epoch(self, device: torch.device, epoch_idx: int = 0,
              place: bool = True) -> Iterator[Dict[str, "np.ndarray"]]:
        """One epoch's batches on ``device`` (tensors; on the card each
        batch's copy is ordered before the consumer's stream reads it).
        ``place=False`` yields host numpy batches (no device placement):
        the consumer owns staging, e.g. to stack K batches into one
        infeed-chunk transfer for ``Estimator._multi_step_data``.  Under
        the process backend an unplaced batch is a ``SlotBatch`` of
        zero-copy views over its shm slot — copy (``np.stack`` /
        ``np.asarray``) or call ``.release()`` before asking for more
        batches than the pool holds (GC releases as a safety net)."""
        device = torch.device(device)
        if self.workers == "process":
            return self._epoch_process(device, epoch_idx, place)
        return self._epoch_thread(device, epoch_idx, place)

    def _consume(self, queue: NativeQueue, ready: Dict, ready_cond,
                 errors: List[BaseException], bound: int, steps: int,
                 device: torch.device, place: bool):
        """The shared consumer half of both backends: in-step-order token
        draining, double-buffered placement, and (for shm batches) slot
        recycling one step behind the yield so the device copy of batch N
        completes — overlapped with the placement of N+1 — before its
        host buffer is reused."""
        m_ready = self._m_ready

        def take(expected_step: int) -> Dict[str, np.ndarray]:
            """Next batch in step order; holds out-of-order arrivals.  Live
            because steps are claimed in order: the token for
            ``expected_step`` is pushed or being produced.  Bounded because
            once ``ready`` holds ``bound`` batches the consumer stops
            draining tokens — producers then block on the full queue (or
            the empty slot pool), halting production while the straggler
            decode finishes (batches land in ``ready`` BEFORE their token
            push, so the straggler's batch still arrives).  All waits are
            EVENT-DRIVEN: the condition wakes on inserts/errors and the
            native queue's pop blocks until a token or close — an idle
            consumer costs zero wakeups, not 5/s of polling."""
            while True:
                with ready_cond:
                    if expected_step in ready:
                        batch = ready.pop(expected_step)
                        m_ready.set(len(ready))
                        return batch
                    if errors:
                        raise errors[0]
                    if len(ready) >= bound:
                        ready_cond.wait()
                        continue
                item = queue.pop(timeout=None)
                if item is None:
                    continue                    # spurious empty wakeup
                if int.from_bytes(item[0], "big") == _ERROR_TOKEN:
                    with ready_cond:
                        err = errors[0] if errors else None
                    raise err if err is not None else \
                        RuntimeError("worker aborted")

        def finish(item):
            out, slot, disp_ms = item
            if slot is not None:
                # the copy of this batch was dispatched one iteration ago
                # and overlapped the next batch's staging; the residual
                # wait here is the UNHIDDEN host→device time
                t0 = time.monotonic()
                if isinstance(out, PlacedBatch):
                    out.synchronize()
                self._m_h2d.observe(
                    disp_ms + (time.monotonic() - t0) * 1000.0)
                slot.release()
                self._m_shm.set(self._pool_in_use())
            elif disp_ms is not None:
                # thread backend: no slot to recycle, so no forced sync —
                # observe the dispatch half so per-backend h2d numbers
                # (bench input_pipeline) stay comparable
                self._m_h2d.observe(disp_ms)
            if isinstance(out, PlacedBatch):
                out.wait()  # the consumer's stream, after the copy
            return out

        placer = device_placer(device) if place else None
        pending = None
        for step in range(steps):
            batch = take(step)
            if place:
                slot = batch if isinstance(batch, SlotBatch) else None
                t0 = time.monotonic()
                out = placer(detach_for_placement(batch, device)
                             if slot is not None else batch)
                item = (out, slot, (time.monotonic() - t0) * 1000.0)
            else:
                item = (batch, None, None)      # consumer owns the slot
            if pending is not None:
                yield finish(pending)           # batch N computes while
            pending = item                      # N+1 already on device
        if pending is not None:
            yield finish(pending)

    def _pool_in_use(self) -> int:
        pool = getattr(self, "_active_pool", None)
        return pool.in_use() if pool is not None else 0

    # -- thread backend -------------------------------------------------------

    def _epoch_thread(self, device: torch.device, epoch_idx: int,
                      place: bool) -> Iterator[Dict[str, "np.ndarray"]]:
        idx = self.epoch_index(epoch_idx)
        steps = self.steps_per_epoch()
        self._begin_epoch_trace(epoch_idx)
        epoch_t0 = time.monotonic()

        # the bounded native queue carries batch tokens; ready holds the
        # actual arrays (at most prefetch_batches + num_workers entries,
        # because push blocks when the queue is full)
        queue = NativeQueue(max_items=self.prefetch_batches)
        ready: Dict[int, Dict[str, np.ndarray]] = {}
        ready_lock = threading.Lock()
        # one condition guards BOTH ready and errors: workers notify when
        # either changes, so the consumer never busy-waits
        ready_cond = threading.Condition(ready_lock)
        step_iter = iter(range(steps))
        step_lock = threading.Lock()
        errors: List[BaseException] = []

        def worker(wid: int) -> None:
            rng = np.random.default_rng(
                (self.seed + epoch_idx) * 10007 + wid)
            while True:
                with step_lock:
                    step = next(step_iter, None)
                if step is None:
                    return
                sel = self.batch_index(idx, step)
                try:
                    self._hint_rows(sel)
                    t0 = time.monotonic()
                    io0 = self._io_wait_ms()
                    rows = [self._load_row(int(i), rng) for i in sel]
                    batch = {k: np.stack([r[k] for r in rows])
                             for k in rows[0]}
                    decode_ms = (time.monotonic() - t0) * 1000.0
                    self._m_decode.observe(decode_ms)
                    io_ms = self._io_wait_ms() - io0
                    if io_ms > 0:
                        self._m_io.observe(io_ms)
                    self._record_decode_span(step, decode_ms,
                                             max(0.0, io_ms))
                except BaseException as e:          # noqa: BLE001 loader bug
                    with ready_cond:
                        errors.append(e)
                        ready_cond.notify_all()
                    try:
                        queue.push(_ERROR_TOKEN.to_bytes(8, "big"))
                    except RuntimeError:
                        pass                        # consumer already gone
                    return
                with ready_cond:
                    ready[step] = batch
                    self._m_ready.set(len(ready))
                    ready_cond.notify_all()
                try:
                    queue.push(step.to_bytes(8, "big"))  # blocks when full
                except RuntimeError:                # queue closed: abandon
                    return

        workers = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in workers:
            t.start()

        bound = self.prefetch_batches + self.num_workers

        try:
            yield from self._consume(queue, ready, ready_cond, errors,
                                     bound, steps, device, place)
        finally:
            queue.close()
            for t in workers:
                try:
                    t.join(timeout=5)
                except TypeError:
                    # generator finalized during interpreter teardown:
                    # threading internals are already torn down
                    pass
            self._end_epoch_trace(epoch_idx, steps, epoch_t0)

    # -- process backend ------------------------------------------------------

    def _batch_spec(self, idx: np.ndarray) -> Dict[str, tuple]:
        """``{key: (row_shape, dtype)}`` for shm slot sizing, probed from
        ONE sample loaded on the caller (plain load: no injection hits,
        no counter effects) and cached across epochs."""
        if self._spec is not None:
            return self._spec
        last: Optional[BaseException] = None
        row = None
        for k in range(min(len(idx), _MAX_FALLBACK_TRIES)):
            try:
                row = self._load(int(idx[k]),
                                 rng=np.random.default_rng(self.seed))
                break
            except Exception as e:  # noqa: BLE001 — probe the next sample
                last = e
        if row is None:
            raise RuntimeError(
                "could not load any sample to probe the batch spec for "
                "the shared-memory pool") from last
        self._spec = {key: (np.asarray(v).shape, np.asarray(v).dtype)
                      for key, v in row.items()}
        return self._spec

    def _epoch_process(self, device: torch.device, epoch_idx: int,
                       place: bool) -> Iterator[Dict[str, "np.ndarray"]]:
        import multiprocessing as mp
        ctx = mp.get_context("fork")
        idx = self.epoch_index(epoch_idx)
        steps = self.steps_per_epoch()
        self._begin_epoch_trace(epoch_idx)
        epoch_t0 = time.monotonic()
        spec = self._batch_spec(idx)
        nslots = max(2, self.prefetch_batches + self.num_workers)
        pool = ShmBatchPool(nslots, self._local_batch, spec, ctx=ctx)
        self._active_pool = pool
        queue = NativeQueue(max_items=self.prefetch_batches)
        ready: Dict[int, Dict[str, np.ndarray]] = {}
        ready_cond = threading.Condition(threading.Lock())
        errors: List[BaseException] = []
        sh = _ProcShared(ctx, self)
        fail0, skip0 = self.load_failures, self.skipped_rows
        stop = threading.Event()
        procs = [ctx.Process(target=_process_worker,
                             args=(self, idx, epoch_idx, steps, pool, wid,
                                   sh),
                             daemon=True, name=f"zoo-feed-w{wid}")
                 for wid in range(self.num_workers)]
        import warnings
        with warnings.catch_warnings():
            # Python warns on a fork from a process with threads; the
            # children run the loader on numpy only (never torch.cuda, the
            # PyTorch-DataLoader contract), so the warning is noise here
            warnings.filterwarnings("ignore", message=".*fork.*",
                                    category=DeprecationWarning)
            for p in procs:
                p.start()

        def forward() -> None:
            """Parent-side forwarder: turns worker control messages into
            ready-dict inserts + native-queue tokens (the consumer
            contract the thread backend already speaks), releases the
            slots of crashed workers, and converts a hard worker death
            into the same error path a loader exception takes."""
            done = [False] * self.num_workers
            n_done = 0
            while not stop.is_set() and n_done < self.num_workers:
                try:
                    msg = sh.result_q.get(timeout=0.5)
                except pyqueue.Empty:
                    for wid, p in enumerate(procs):
                        if done[wid] or p.exitcode is None:
                            continue
                        done[wid] = True
                        n_done += 1
                        if sh.finished[wid].value:
                            continue        # clean exit, message raced
                        slot = sh.held[wid].value
                        if slot >= 0:       # crash mid-write: reclaim
                            pool.release(slot)
                            sh.held[wid].value = -1
                        err = RuntimeError(
                            f"streaming decode worker {wid} died (exit "
                            f"code {p.exitcode}) mid-batch")
                        with ready_cond:
                            errors.append(err)
                            ready_cond.notify_all()
                        try:
                            queue.push(_ERROR_TOKEN.to_bytes(8, "big"))
                        except RuntimeError:
                            return
                    continue
                kind = msg[0]
                if kind == "batch":
                    _, step, slot, decode_ms, io_ms, load_ms = msg
                    self._m_decode.observe(decode_ms)
                    self._m_load.observe(load_ms)  # per-sample batch mean
                    if io_ms > 0:
                        self._m_io.observe(io_ms)
                    # forked workers can't reach this process's span
                    # ring — the decode timing rode the control message,
                    # so the span is recorded HERE, under the epoch root
                    self._record_decode_span(step, decode_ms,
                                             max(0.0, io_ms))
                    batch = SlotBatch(pool.views(slot), slot, pool)
                    with ready_cond:
                        ready[step] = batch
                        self._m_ready.set(len(ready))
                        ready_cond.notify_all()
                    self._m_shm.set(pool.in_use())
                    try:
                        queue.push(step.to_bytes(8, "big"))
                    except RuntimeError:
                        return              # consumer closed: abandon
                elif kind == "error":
                    _, wid, slot, exc = msg
                    if slot >= 0:
                        pool.release(slot)
                    with ready_cond:
                        errors.append(exc)
                        ready_cond.notify_all()
                    try:
                        queue.push(_ERROR_TOKEN.to_bytes(8, "big"))
                    except RuntimeError:
                        return
                elif kind == "done":
                    wid = msg[1]
                    if not done[wid]:
                        done[wid] = True
                        n_done += 1

        fwd = threading.Thread(target=forward, daemon=True,
                               name="zoo-feed-forwarder")
        fwd.start()

        try:
            yield from self._consume(queue, ready, ready_cond, errors,
                                     nslots, steps, device, place)
        finally:
            stop.set()
            queue.close()
            for p in procs:
                if p.is_alive():
                    p.terminate()           # may be blocked on the pool
            for p in procs:
                try:
                    p.join(timeout=5)
                except (AssertionError, ValueError):
                    pass
            try:
                fwd.join(timeout=5)
            except (RuntimeError, TypeError):
                pass
            # fold the workers' fork-shared counters back into the feed,
            # its metrics, and the fault registry (times charges consumed
            # in children must disarm the parent's spec too)
            self.load_failures = max(self.load_failures, sh.failures.value)
            self.skipped_rows = max(self.skipped_rows, sh.skipped.value)
            if self.load_failures > fail0:
                self._m_failures.inc(self.load_failures - fail0)
            if self.skipped_rows > skip0:
                self._m_skipped.inc(self.skipped_rows - skip0)
            if sh.retries_v.value:
                self._m_retries.inc(sh.retries_v.value)
            if sh.fault_hits.value or sh.fault_fired.value:
                self._fault_registry().absorb(
                    "feed.read_fail", hits=sh.fault_hits.value,
                    fired=sh.fault_fired.value)
            try:
                sh.result_q.close()
                sh.result_q.cancel_join_thread()
            except (OSError, AttributeError):
                pass
            self._active_pool = None
            pool.close()
            self._m_shm.set(0)
            self._end_epoch_trace(epoch_idx, steps, epoch_t0)


class _ProcShared:
    """Fork-shared control state for one process-backend epoch: the step
    claim counter, resilience counters, per-worker held-slot markers
    (crash recovery), clean-exit flags, and the control-message queue."""

    def __init__(self, ctx, feed: StreamingDataFeed):
        self.step = ctx.Value("l", 0)
        self.failures = ctx.Value("l", feed.load_failures)
        self.retries_v = ctx.Value("l", 0)
        self.skipped = ctx.Value("l", feed.skipped_rows)
        self.fault_hits = ctx.Value("l", 0)
        self.fault_fired = ctx.Value("l", 0)
        self.held = [ctx.Value("l", -1) for _ in range(feed.num_workers)]
        self.finished = [ctx.Value("b", 0) for _ in range(feed.num_workers)]
        self.result_q = ctx.Queue()


class _ChildFaultView:
    """A forked worker's view of the fault registry: decisions run
    against the inherited (copy-on-write) armed specs — deterministic per
    worker — while hit/fire counts mirror into fork-shared values so the
    PARENT registry can absorb them at epoch end (``fired()`` visible to
    tests, ``times`` charges consumed, armed-leak checks coherent)."""

    def __init__(self, real, hits, fired):
        self._real = real
        self._hits = hits
        self._fired = fired

    def raise_if(self, name: str,
                 default_exc=RuntimeError) -> None:
        h0, f0 = self._real.hits(name), self._real.fired(name)
        try:
            self._real.raise_if(name, default_exc)
        finally:
            dh = self._real.hits(name) - h0
            df = self._real.fired(name) - f0
            if dh:
                with self._hits.get_lock():
                    self._hits.value += dh
            if df:
                with self._fired.get_lock():
                    self._fired.value += df


def _vinc(v) -> int:
    with v.get_lock():
        v.value += 1
        return v.value


def _picklable_exc(e: BaseException) -> BaseException:
    import pickle
    try:
        pickle.dumps(e)
        return e
    except Exception:  # noqa: BLE001 — unpicklable user exception
        return RuntimeError(f"{type(e).__name__}: {e}")


def _process_worker(feed: StreamingDataFeed, idx: np.ndarray,
                    epoch_idx: int, steps: int, pool: ShmBatchPool,
                    wid: int, sh: _ProcShared) -> None:
    """Forked decode worker main loop.

    Runs in a CHILD process: ``feed`` is a copy-on-write copy, so its
    counter/fault plumbing is re-bound to the fork-shared values first.
    Step claim and slot acquisition happen under ONE lock so slots are
    acquired in step order — with claim order == step order this makes
    the pool bound deadlock-free (the lowest outstanding step always
    holds or gets the next free slot; later steps cannot starve it)."""
    try:
        real = feed._fault_registry()
        child_faults = _ChildFaultView(real, sh.fault_hits, sh.fault_fired)
        feed._fault_registry = lambda: child_faults
        feed._note_failure = lambda: _vinc(sh.failures) and None
        feed._note_retry = lambda: _vinc(sh.retries_v) and None
        feed._note_skip = lambda: _vinc(sh.skipped)
        # the child's metrics registry is invisible to the parent — the
        # parent observes decode/io from control messages instead
        metrics_lib.get_registry().enabled = False
        rng = np.random.default_rng((feed.seed + epoch_idx) * 10007 + wid)
        while True:
            with sh.step.get_lock():
                step = sh.step.value
                if step >= steps:
                    break
                slot = pool.acquire()       # in step order — see docstring
                sh.step.value = step + 1
                sh.held[wid].value = slot
            if slot is None:
                break                       # pool closing under us
            sel = feed.batch_index(idx, step)
            feed._hint_rows(sel)
            t0 = time.monotonic()
            io0 = feed._io_wait_ms()
            load_s = 0.0
            views = pool.views(slot)
            for k, i in enumerate(sel):
                t1 = time.monotonic()
                row = feed._load_row(int(i), rng)
                load_s += time.monotonic() - t1
                if set(row) != set(views):
                    raise ValueError(
                        f"load_sample keys {sorted(row)} do not match the "
                        f"probed batch spec {sorted(views)}")
                for key, v in row.items():
                    views[key][k] = v       # decoded straight into place
            decode_ms = (time.monotonic() - t0) * 1000.0
            io_ms = feed._io_wait_ms() - io0
            # the child's metrics registry is invisible to the parent —
            # per-sample loader latency rides the control message instead
            load_ms = load_s * 1000.0 / max(1, len(sel))
            # drop the held marker BEFORE reporting: once the message is
            # out, the batch owns the slot — a hard death in between must
            # not let the crash path reclaim a slot the consumer now holds
            sh.held[wid].value = -1
            sh.result_q.put(("batch", step, slot, decode_ms, io_ms,
                             load_ms))
    except BaseException as e:  # noqa: BLE001 — loader bugs vary freely
        try:
            sh.result_q.put(("error", wid, int(sh.held[wid].value),
                             _picklable_exc(e)))
            sh.held[wid].value = -1
        except Exception:       # parent already tearing down
            pass
    finally:
        try:
            sh.finished[wid].value = 1
            sh.result_q.put(("done", wid))
        except Exception:
            pass
