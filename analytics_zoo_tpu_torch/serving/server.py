# Port of analytics_zoo_tpu/serving/server.py: a copy with its imports pointed at
# the port, changed where it reaches the model (see "Port" below).
"""ClusterServing: the always-on inference service.

Reference (SURVEY.md §2.8/§3.5): a Flink streaming job polled Redis
(`serving_stream`), batched records, ran InferenceModel through JNI
(OpenVINO/TF/BigDL), and wrote results back to per-key Redis entries; an
akka-HTTP frontend fed the same queue.

TPU-native redesign: one process, a PIPELINE of stages so host work
overlaps device work end to end (the monolithic batcher serialized
assembly → inference → reply on one thread, so a slow client socket
stalled all inference):

  1. a TCP acceptor thread per connection parses frames and pushes
     requests onto a NATIVE C++ bounded queue (the Redis-list
     equivalent);
  2. an ASSEMBLY thread runs a pluggable :class:`Scheduler`
     (serving/scheduler.py) that decides WHEN arrived
     requests become device batches — ``"window"`` (default, the
     original fixed batch window: up to ``batch_size`` requests or
     ``batch_timeout_ms``) or ``"continuous"`` (admit everything
     arrived into the very next device step, weighted-fair across
     models) — then sheds expired deadlines, groups by (model,
     version, input shape), and writes each group's rows into a REUSED
     per-shape staging buffer (no fresh ``np.stack`` allocation per
     batch), pushing assembled batches onto a small internal queue;
  3. ``inference_workers`` threads (default 2, bounded by
     ``InferenceModel.concurrent_num``) pull assembled batches and run
     the AOT-compiled model — batch k+1 assembles while batch k
     computes, and with 2 workers two shape groups infer concurrently;
  4. a per-connection REPLY WRITER thread encodes (zero-copy
     scatter-gather, see protocol.py) and sends each reply, so frame
     encoding and ``sendall`` never block the next ``model.predict``
     and one slow-reading client backpressures only its own connection.

``inference_workers=1`` restores the strictly serialized inference
order of the pre-pipeline server (bisection baseline).

High availability: this server is designed to run as one
replica of N behind ``serving/router.py``:

- **health pings** — a header-only ``{"type": "ping"}`` frame rides the
  native queue and is answered by the ASSEMBLY stage (the single
  ordered stage), so a wedged-but-connected replica (assembly stalled
  on an armed ``serving.model_latency``, queue jammed) fails the probe
  by timeout even though its socket still accepts writes;
- **graceful drain** — ``drain()`` flips the server to a ``draining``
  state: new requests get a retryable ``"draining"`` reply while
  in-flight batches finish, so a rolling restart sheds zero requests;
- **admission control** — a request whose whole deadline budget is
  below the observed queue wait (EWMA) is rejected at arrival
  (``deadline unattainable``) instead of being shed later, and
  ``admission_queue_limit`` puts a soft depth cap in front of the
  native queue's hard one;
- **hard-kill** — ``kill()`` (and the ``serving.replica_down`` fault
  point) dies the way SIGKILL would: no drain replies, no flushes —
  the failure mode the router's failover must absorb.

Port: the model call is the port's ``InferenceModel.predict``.  On the
card each inference worker replays the model's CUDA graphs itself (one
graph a batch key, every graph of a model on its serving stream); a
worker waits on an event recorded after its own replay, so two workers
on two shape groups overlap their host work with each other's replays.
A model loaded with ``device=None`` runs on the card or raises; the
server never moves work to the CPU.  The knobs' defaults come from
``ZooConfig``'s (the port has no context).  ``main`` is the
``zoo-serving`` launcher (``python -m analytics_zoo_tpu_torch.serving.
server``), with one flag the JAX package's lacks: ``--device`` (default
the card).  One repair beside the JAX
package's: a request that enters the pending table after ``stop()``
closed the queue is answered ``server shutting down`` at once, where the
JAX package's leaves it pending.
"""

from __future__ import annotations

import logging
import queue as queue_mod
import socket
import threading
import time
import uuid as uuid_mod
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from analytics_zoo_tpu_torch.core.config import ZooConfig
from analytics_zoo_tpu_torch.core.faults import FaultRegistry, get_registry
from analytics_zoo_tpu_torch.native import NativeQueue
from .inference_model import InferenceModel
from .model_registry import ModelRegistry
from . import protocol
from . import scheduler as scheduler_lib

logger = logging.getLogger("analytics_zoo_tpu")


def _config_default(field: str, fallback: Any) -> Any:
    """``ZooConfig``'s default for ``field`` (else ``fallback``).  The JAX
    package reads the initialized context's config here; the port has no
    context, so its knobs take the config's defaults, which are the same
    values."""
    return getattr(ZooConfig(), field, fallback)


class _Pending:
    __slots__ = ("uuid", "arr", "conn", "lock", "writer", "expires",
                 "trace", "span", "enq_t", "wait_ms", "ping", "model",
                 "version", "klass")

    def __init__(self, uid: str, arr: Optional[np.ndarray],
                 conn: socket.socket,
                 lock: threading.Lock, writer: "Optional[_ConnWriter]",
                 expires: Optional[float] = None,
                 trace: Optional[str] = None, ping: bool = False,
                 model: Optional[str] = None,
                 version: Optional[str] = None,
                 span: Optional[str] = None,
                 klass: Optional[str] = None):
        self.uuid = uid
        self.arr = arr
        self.conn = conn
        self.lock = lock
        self.writer = writer  # per-connection outbound stage
        # absolute time.monotonic() deadline (from the client's
        # ``deadline_ms`` budget, re-anchored at arrival); None = no limit
        self.expires = expires
        # trace id from the frame header (core/trace.py): rides every
        # reply so the client can correlate its per-stage breakdown
        self.trace = trace
        # the SENDER's span id from the frame header: the parent this
        # request's server-side stage spans attach under in trace.tree()
        self.span = span
        self.enq_t = time.monotonic()  # arrival → assembly = queue wait
        self.wait_ms = 0.0             # filled at assembly pickup
        self.ping = ping               # health probe: answered, not batched
        # routing: the REQUEST's model/version header fields, raw (None
        # = route to the server's default model).  Resolution against
        # the registry happens at assembly, so a version hot-swapped
        # while the request was queued serves the NEW active version.
        self.model = model
        self.version = version
        # request class ("interactive" | "batch") for per-class
        # admission/shedding; None = unclassified (pre-klass behavior)
        self.klass = klass


class _AssembledBatch:
    """One (model, shape)-grouped batch staged for inference: the
    pending requests, the staged input (a view into a pooled buffer),
    the pool key/buffer to release once inference materialized its
    output, and the RESOLVED model the workers must run it on (resolved
    at assembly so it pins the version active at dispatch time)."""

    __slots__ = ("group", "x", "buf_key", "buf", "assembly_ms",
                 "im", "model", "version", "_done")

    def __init__(self, group: List[_Pending], x: np.ndarray,
                 buf_key: Tuple, buf: np.ndarray, assembly_ms: float,
                 im: Any, model: str, version: str):
        self.group = group
        self.x = x
        self.buf_key = buf_key
        self.buf = buf
        self.assembly_ms = assembly_ms
        self.im = im          # the resolved model object for this batch
        self.model = model    # registry name (default traffic resolves)
        self.version = version
        self._done = False    # registry in-flight accounting closed?


class _ConnWriter:
    """Per-connection reply stage: a bounded outbound queue + one writer
    thread doing encode + scatter-gather send.  Inference workers hand
    replies over and move straight to the next batch; a client that
    stops reading blocks only its own writer (its queue then
    backpressures only requests from that connection)."""

    def __init__(self, conn: socket.socket, send_lock: threading.Lock,
                 reply_hist: metrics_lib.Histogram,
                 max_items: Optional[int] = None):
        self._conn = conn
        self._lock = send_lock
        self._m_reply = reply_hist
        self._q: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max_items or self.MAX_ITEMS)
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="zoo-serving-reply")
        self._thread.start()

    #: outbound queue bound: a conforming client keeps far fewer replies
    #: outstanding (the resilient client caps in-flight at 1024)
    MAX_ITEMS = 4096
    #: how long push() tolerates a FULL writer queue before declaring
    #: the client dead.  A full queue means MAX_ITEMS replies sit unread
    #: — waiting longer would stall the SHARED inference workers (and
    #: stop()'s drain) on one broken client.
    PUSH_GRACE_S = 1.0

    def push(self, header: Dict[str, Any],
             arr: Optional[np.ndarray]) -> bool:
        """Enqueue one reply; False once the writer is closed (the
        caller falls back to a best-effort direct send).  A queue that
        stays full past ``PUSH_GRACE_S`` kills the connection: the
        client is not reading and the workers must not block on it."""
        deadline = time.monotonic() + self.PUSH_GRACE_S
        while not self._closed.is_set():
            try:
                self._q.put((header, arr), timeout=0.1)
                return True
            except queue_mod.Full:
                if time.monotonic() > deadline:
                    logger.warning(
                        "reply writer queue full for %.1fs: client is "
                        "not reading; dropping the connection",
                        self.PUSH_GRACE_S)
                    self._closed.set()
                    try:  # unblock the writer's in-flight sendall too
                        self._conn.shutdown(socket.SHUT_RDWR)
                    except OSError:
                        pass
                    try:
                        self._conn.close()
                    except OSError:
                        pass
                    return False
        return False

    def _loop(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue_mod.Empty:
                if self._closed.is_set():
                    return  # closed AND flushed
                continue
            header, arr = item
            t0 = time.monotonic()
            try:
                with self._lock:
                    protocol.send_frame_parts(
                        self._conn, protocol.encode_parts(header, arr))
            except (OSError, ValueError):
                pass  # client gone; counters were final pre-send
            reply_ms = (time.monotonic() - t0) * 1000.0
            self._m_reply.observe(reply_ms)
            if header.get("span") is not None and trace_lib.enabled:
                # the reply-writer stage span: only measurable here,
                # after the send — parents under the server.batch span
                # whose id rides the reply header
                tid = header.get("trace")
                trace_lib.record(tid, "server.reply",
                                 {"reply_ms": round(reply_ms, 3)},
                                 parent=header["span"], dur_ms=reply_ms)

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop after flushing queued replies (sends to a dead socket
        fail fast, so a closed connection drains immediately)."""
        self._closed.set()
        if timeout is not None:
            self._thread.join(timeout=timeout)


class ClusterServing:
    """config parity with the reference's config.yaml: model + batch size +
    address (the Redis url's slot)."""

    def __init__(self, model: Optional[InferenceModel] = None,
                 host: str = "127.0.0.1",
                 port: int = 0, batch_size: int = 16,
                 batch_timeout_ms: int = 5, queue_items: int = 4096,
                 push_timeout: float = 5.0,
                 inference_workers: Optional[int] = None,
                 staging_pool: Optional[int] = None,
                 admission_queue_limit: Optional[int] = None,
                 scheduler: Union[str, scheduler_lib.Scheduler,
                                  None] = None,
                 models: Union[ModelRegistry, Dict[str, Any],
                               None] = None,
                 pipelines: Optional[Dict[str, Any]] = None,
                 faults: Optional[FaultRegistry] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        """``inference_workers``: concurrent model-call threads pulling
        assembled batches (default from ``ZooConfig.inference_workers``,
        2; bounded by the model's ``concurrent_num``).  1 restores the
        pre-pipeline strictly-ordered inference for bisection.

        ``staging_pool``: per-shape-bucket staging buffers kept for
        reuse (default ``inference_workers + 2``); beyond the pool,
        assembly allocates fresh buffers rather than blocking.

        ``admission_queue_limit``: soft admission cap — reject new
        requests with a retryable ``queue full`` reply once the native
        queue's depth reaches this (default None = only the queue's own
        hard bound applies).  Set below ``queue_items`` so a router can
        fail over to an emptier replica before this one saturates.

        ``scheduler``: assembly batching policy — ``"window"`` (fixed
        batch window, the bisection baseline), ``"continuous"``
        (admit arrivals into the very next device step), or a prebuilt
        :class:`~.scheduler.Scheduler` instance (one per server).
        Default: ``ZooConfig.scheduler`` (``"window"``).

        ``models``: multi-model serving — a prebuilt
        :class:`~.model_registry.ModelRegistry` or a ``{name: model}``
        dict.  Requests route by their ``model`` header field (and an
        optional ``version`` pin); ``model`` (the positional arg) is
        additionally registered under the name ``"default"`` and serves
        requests that name no model.

        ``pipelines``: ``{model_name: callable}`` server-side feature
        transforms, applied to the assembled batch (``fn(x) -> x'``)
        right before that model's ``predict`` — e.g. a fitted
        ``friesian.FeaturePipeline.as_server_transform(...)`` turning
        raw event columns into the model's numeric features, so clients
        send raw events instead of shipping the feature recipe."""
        self._metrics = metrics or metrics_lib.get_registry()
        self.pipelines = dict(pipelines or {})
        self.registry = ModelRegistry.ensure(models,
                                             metrics=self._metrics)
        if model is not None:
            self.registry.register(ModelRegistry.DEFAULT, model)
        names = self.registry.names()
        if not names:
            raise ValueError("ClusterServing needs model= or models=")
        # where header-less requests route: the "default" entry, or the
        # single hosted model; None (multi-model, no default) rejects
        # requests that name no model
        self._default_name = (
            ModelRegistry.DEFAULT if ModelRegistry.DEFAULT in names
            else names[0] if len(names) == 1 else None)
        self.batch_size = batch_size
        self.batch_timeout_ms = batch_timeout_ms
        self.push_timeout = push_timeout  # how long accept blocks when full
        if inference_workers is None:
            inference_workers = _config_default("inference_workers", 2)
        bounds = [getattr(m, "concurrent_num", None)
                  for m in self.registry.models()]
        bound = min([int(b) for b in bounds if b], default=None)
        self.inference_workers = max(1, min(
            int(inference_workers),
            int(bound) if bound else int(inference_workers)))
        if staging_pool is None:
            staging_pool = _config_default("staging_pool", None)
        self.staging_pool = (int(staging_pool) if staging_pool
                             else self.inference_workers + 2)
        self.admission_queue_limit = admission_queue_limit
        # EWMA of observed queue waits (ms), written only by the single
        # assembly thread, read by conn threads for the deadline-aware
        # admission gate (a request whose whole budget is below the
        # typical wait would only be shed later — reject it at the door)
        self._wait_ewma = 0.0
        # per-class admission: batch-class traffic sheds
        # FIRST under pressure — a stricter attainability margin on the
        # observed wait and an earlier depth cap — so interactive
        # traffic holds its SLO through a transient.  Unclassified
        # requests keep the exact pre-klass gate for bisection.
        self.admission_batch_wait_margin = float(_config_default(
            "admission_batch_wait_margin", 2.0))
        self.admission_batch_depth_frac = float(_config_default(
            "admission_batch_depth_frac", 0.5))
        # lazily-created per-klass labeled counter handles (bounded:
        # klass values are validated against protocol.KLASSES at parse)
        self._m_klass: Dict[Tuple[str, str], metrics_lib.Counter] = {}
        self._faults = faults or get_registry()
        self._queue: "NativeQueue" = NativeQueue(max_items=queue_items)
        # assembled-batch queue: SMALL on purpose — backpressure must
        # reach the native queue (and from there the "queue full"
        # rejection path) instead of hiding in an elastic buffer
        self._batch_q: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=max(1, self.inference_workers))
        self._workers_done = threading.Event()  # drain: exit when empty
        self._pending: Dict[int, _Pending] = {}
        self._pending_lock = threading.Lock()
        self._next_id = 0
        # staging-buffer pool: (shape, dtype) -> free buffers; rows are
        # written in place instead of np.stack's fresh allocation
        self._staging: Dict[Tuple, List[np.ndarray]] = {}
        self._staging_lock = threading.Lock()
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.host, self.port = self._sock.getsockname()
        self._stop = threading.Event()
        self._draining = threading.Event()
        self._threads: List[threading.Thread] = []
        self._threads_lock = threading.Lock()
        self._conns: set = set()  # open client sockets, for drain/close
        self._writers: Dict[socket.socket, _ConnWriter] = {}
        # observability (reference: the Flink job's metrics): monotonically
        # increasing counters, read via stats() and mirrored into the
        # process telemetry registry under ``server.*`` (core/metrics.py).
        # Invariant on a healthy server:
        #   requests == replies + errors + pending
        # from any client's point of view (counters bump before reply
        # frames go out), hence requests == replies + errors once
        # in-flight work drains (pending == 0).  errors subsumes rejected
        # (queue full), shed (deadline exceeded) and drained (stop()
        # replied "server shutting down").
        self._stats_lock = threading.Lock()
        self._counters = {"requests": 0, "replies": 0, "batches": 0,
                          "errors": 0, "batch_rows": 0, "rejected": 0,
                          "shed": 0, "drained": 0, "shed_batches": 0,
                          "pings": 0, "draining_rejected": 0,
                          "admission_rejected": 0, "unknown_model": 0}
        # handle-per-counter (not one-shot inc): _count runs on every
        # request/reply, and a name lookup there would serialize all
        # serving threads on the registry's global lock
        self._m_counters = {k: self._metrics.counter("server." + k)
                            for k in self._counters}
        self._m_depth = self._metrics.gauge("server.queue_depth")
        self._m_batch_size = self._metrics.histogram(
            "server.batch_size", buckets=metrics_lib.SIZE_BUCKETS)
        self._m_queue_wait = self._metrics.histogram("server.queue_wait_ms")
        self._m_infer = self._metrics.histogram("server.inference_ms")
        self._m_assembly = self._metrics.histogram("server.assembly_ms")
        self._m_reply = self._metrics.histogram("server.reply_ms")
        self._m_shed_per_batch = self._metrics.histogram(
            "server.shed_per_batch", buckets=metrics_lib.SIZE_BUCKETS)
        # per-(model, version) labeled metric handles, created lazily at
        # first batch and cached — per-batch registry name lookups would
        # serialize the inference workers on the registry's global lock.
        # Retired when the version is unloaded: refresh-style swaps mint
        # monotone version strings, so without retirement a server
        # hot-refreshed for months accumulates a dead labeled series
        # (and a cache entry) per swap in every /metrics scrape.
        self._m_model_series: Dict[Tuple[str, str], Tuple] = {}
        if scheduler is None:
            scheduler = _config_default("scheduler", "window")
        try:
            self.scheduler = scheduler_lib.make(scheduler)
            self.scheduler.attach(self)
        except Exception:
            # scheduler validation is the only failure path left after
            # the socket went listening: close it, or a corrected retry
            # on the same fixed port hits EADDRINUSE until process exit
            self._sock.close()
            raise
        self.registry.on_unload(self._retire_model_series)

    @property
    def model(self) -> Any:
        """The default model's ACTIVE version — the back-compat
        single-model accessor; the authoritative map is
        ``self.registry``.  Assigning it is the legacy raw swap (flip
        with no warming, no drain); prefer :meth:`update_model`."""
        if self._default_name is None:
            raise AttributeError(
                "multi-model server has no single .model; use "
                "registry.resolve(name)")
        im, _, _ = self.registry.resolve(self._default_name)
        return im

    @model.setter
    def model(self, m: Any) -> None:
        if self._default_name is None:
            raise AttributeError(
                "multi-model server has no single .model; use "
                "registry.swap(name, model)")
        # keep_old=False: the legacy contract REPLACED the model —
        # repeated assignments must not accumulate resident versions
        self.registry.swap(self._default_name, m, warm=False,
                           drain=False, keep_old=False)

    def update_model(self, model: Any, version: Optional[str] = None,
                     warm: bool = True) -> str:
        """Hot-swap the default model's serving version without
        dropping connections (reference: cluster serving's model-update
        flow — a new model version replaced the loaded one between
        batches).  Rides :meth:`ModelRegistry.swap`: the incoming model
        is WARMED first (``InferenceModel.warm_from`` AOT-compiles the
        active version's realized shape buckets, so the first post-swap
        batches don't eat cold XLA compiles — the pre-registry
        implementation just assigned ``self.model`` and stalled on a
        fresh compile per bucket), then the active version flips
        atomically; in-flight batches finish on the old version.
        Returns the new version string.  ``warm=False`` restores the
        raw cold flip."""
        if self._default_name is None:
            raise ValueError(
                "multi-model server: use registry.swap(name, model)")
        # keep_old=False preserves the legacy replace-in-place memory
        # behavior: a server refreshed via update_model for months must
        # hold ONE resident model, not every version ever served.
        # In-flight batches still finish on the old model (each
        # assembled batch holds its own reference); use registry.swap
        # directly to retain old versions for canary pins.
        ver = self.registry.swap(self._default_name, model,
                                 version=version, warm=warm,
                                 drain=False, keep_old=False)
        logger.info("ClusterServing model updated (version %s)", ver)
        return ver

    def stats(self) -> Dict[str, Any]:
        """Service counters: requests seen, replies sent, batches run,
        errors (any non-success reply), ``shed_batches`` (batches that
        shed at least one expired request — the per-batch shed signal
        that a cumulative ``shed`` count loses between polls), the
        realized mean batch size (micro-batching health), plus queue
        health: ``pending`` (in-flight right now), ``queue_depth``
        (native-queue occupancy) and ``queue_depth_max`` (high-water
        mark since start).

        Healthy-server invariant, asserted by the observability tests:
        ``requests == replies + errors + pending`` — every request seen
        is either answered (reply or error) or still in flight; nothing
        is silently dropped.  Counters are bumped BEFORE the reply frame
        is sent, so the invariant holds from any client's point of view
        (a stats() poll racing in-flight pipeline stages may transiently
        see requests exceed the right-hand side while a batch runs)."""
        with self._stats_lock:
            c = dict(self._counters)
        c["mean_batch_size"] = (c.pop("batch_rows") / c["batches"]
                                if c["batches"] else 0.0)
        with self._pending_lock:
            # scheduler-held rows (continuous batching's backlog) are
            # out of _pending but still in flight from the client's view
            c["pending"] = len(self._pending) + self.scheduler.backlog()
        c["queue_depth"] = self._m_depth.value
        c["queue_depth_max"] = self._m_depth.max
        c["inference_workers"] = self.inference_workers
        c["state"] = self.state
        c["scheduler"] = self.scheduler.name
        c["models"] = self.registry.stats()
        return c

    @property
    def state(self) -> str:
        """Lifecycle state: ``serving`` → ``draining`` → ``stopped``.
        Rides every pong so the router (and ``/healthz``) sees a drain
        begin before the first ``"draining"`` rejection does."""
        if self._stop.is_set():
            return "stopped"
        if self._draining.is_set():
            return "draining"
        return "serving"

    def _count(self, **deltas: int) -> None:
        with self._stats_lock:
            for k, v in deltas.items():
                self._counters[k] += v  # unknown keys fail loudly
        for k, v in deltas.items():  # registry mirror: server.* counters
            self._m_counters[k].inc(v)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "ClusterServing":
        # idempotent: `ClusterServing(...).start()` used as a context
        # manager would otherwise double-start the pipeline (a second
        # assembly thread + worker pool racing the first)
        with self._threads_lock:
            if self._threads:
                return self
        t_accept = threading.Thread(target=self._accept_loop, daemon=True,
                                    name="zoo-serving-accept")
        t_assembly = threading.Thread(target=self._assembly_loop,
                                      daemon=True,
                                      name="zoo-serving-assembly")
        workers = [threading.Thread(target=self._worker_loop, args=(i,),
                                    daemon=True,
                                    name=f"zoo-serving-infer-{i}")
                   for i in range(self.inference_workers)]
        with self._threads_lock:
            self._threads = [t_accept, t_assembly] + workers
        for t in self._threads:
            t.start()
        logger.info("ClusterServing listening on %s:%d (batch=%d, "
                    "inference_workers=%d, scheduler=%s, models=%s, "
                    "native queue=%s)", self.host,
                    self.port, self.batch_size, self.inference_workers,
                    self.scheduler.name, self.registry.names(),
                    self._queue.is_native)
        return self

    def drain(self, wait: bool = True, timeout: float = 30.0) -> bool:
        """Enter the ``draining`` state: new requests are rejected with a
        retryable ``"draining"`` reply (clients back off and land on a
        sibling replica, or on this port's successor) while everything
        already admitted finishes normally.  Health pings keep being
        answered — with ``state="draining"`` — so a router stops routing
        here *before* the first rejection.

        With ``wait`` (the default), blocks until every admitted request
        has been answered (``requests == replies + errors`` and no
        pending entries) or ``timeout`` elapses; returns True iff fully
        drained.  The rolling-restart recipe is
        ``srv.drain(); srv.stop()`` — zero dropped requests."""
        self._draining.set()
        logger.info("ClusterServing %s:%d draining", self.host, self.port)
        if not wait:
            return True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._stats_lock:
                settled = (self._counters["requests"]
                           == self._counters["replies"]
                           + self._counters["errors"])
            with self._pending_lock:
                settled = settled and not self._pending
            if settled:
                return True
            time.sleep(0.01)
        return False

    def _inflight_traces(self) -> List[str]:
        """Trace ids of every request this replica currently holds —
        queued (``_pending``), parked in the scheduler's backlog, or
        assembled and waiting for a worker.  What the flight recorder
        names when the replica dies: the requests a sibling replica (or
        a client replay) must pick up."""
        with self._pending_lock:
            tids = [p.trace for p in self._pending.values()
                    if p.trace is not None and not p.ping]
        for p in self.scheduler.held_rows():
            if p.trace is not None and not p.ping:
                tids.append(p.trace)
        with self._batch_q.mutex:
            batches = list(self._batch_q.queue)
        for ab in batches:
            tids.extend(p.trace for p in ab.group if p.trace is not None)
        return tids

    def dump_flight_record(self, reason: str = "on_demand",
                           dump_dir: Optional[str] = None
                           ) -> Optional[str]:
        """Dump this process's flight record (core/flightrec.py) with
        this replica's context: address, lifecycle state, counters, and
        the trace ids currently in flight here.  Returns the dump path,
        or None when no dump directory is configured.  Never raises —
        the kill() path calls this BEFORE tearing anything down, and
        the scheduler's live backlog races the still-running assembly
        thread (a torn in-flight listing beats no dump, and no dump
        must never beat the kill itself)."""
        from analytics_zoo_tpu_torch.core import flightrec
        try:
            tids = self._inflight_traces()
        except Exception:  # noqa: BLE001 — assembly still mutating
            tids = []
        return flightrec.dump(reason, dump_dir=dump_dir, extra={
            "replica": f"{self.host}:{self.port}",
            "state": self.state,
            "in_flight_traces": tids,
            "scheduler": self.scheduler.name,
        })

    def kill(self) -> None:
        """Die the way SIGKILL would: close every socket NOW — no drain
        replies, no writer flushes, pending requests simply vanish.
        This is the ``serving.replica_down`` failure mode the router's
        failover (reconnect + idempotent re-enqueue on a sibling
        replica) must absorb; tests use it to hard-kill an in-process
        replica without losing the process.

        The flight recorder fires FIRST (best-effort, while ``_pending``
        still names the in-flight work): the dump is the only record of
        which requests died here — by the time the router notices, this
        replica has no state left to ask."""
        if self._stop.is_set():
            return
        self.dump_flight_record("serving.replica_down")
        self._stop.set()
        self.registry.off_unload(self._retire_model_series)
        self._workers_done.set()
        self._queue.close()
        with self._threads_lock:
            conns = list(self._conns)
        for s in [self._sock] + conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        self._m_depth.set(0.0)
        logger.info("ClusterServing %s:%d hard-killed", self.host,
                    self.port)

    def partition(self) -> None:
        """Sever every open client connection WITHOUT killing the
        process — the ``serving.net_partition`` failure mode: from the
        clients' side the replica went dark mid-conversation, but the
        pipeline, the native queue, the pending table and the listening
        socket are all still alive, so the partition "heals" as soon as
        a client reconnects.  Requests whose conn died before their
        reply was written get their reply dropped on the floor by the
        writer (exactly like a real partition); clients recover via
        reconnect + idempotent same-uuid re-enqueue, and the router's
        breaker/health machinery decides whether to route around the
        replica in the meantime."""
        with self._threads_lock:
            conns = list(self._conns)
        for s in conns:
            try:
                s.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                s.close()
            except OSError:
                pass
        logger.info("ClusterServing %s:%d partitioned: %d client "
                    "conn(s) severed (process and listener stay up)",
                    self.host, self.port, len(conns))

    def stop(self, drain_timeout: float = 5.0) -> None:
        """Graceful drain: stop intake, let in-flight pipeline stages
        finish (assembly → workers → reply writers, in dependency
        order), reply ``server shutting down`` to every request still
        pending — whether it was waiting in the native queue or already
        assembled in the internal batch queue — then close client
        sockets.

        Idempotent — the second and later calls are no-ops."""
        if self._stop.is_set():
            return
        self._stop.set()
        # a prebuilt registry outlives this server: drop our unload
        # observer or every rolling restart leaks a hook retaining the
        # whole stopped server
        self.registry.off_unload(self._retire_model_series)
        self._queue.close()
        try:
            # close() alone does NOT wake a thread blocked in accept() on
            # Linux — the blocked accept keeps the socket alive in LISTEN
            # and the port stays bound; shutdown() interrupts it
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # join in pipeline order: acceptor + assembly first (no new
        # batches), then workers (each finishes — and replies to — the
        # batch it is currently running; batches still queued stay put
        # for the drain below), then the reply writers flush.
        with self._threads_lock:
            stages = list(self._threads)
        workers = [t for t in stages if t.name.startswith(
            "zoo-serving-infer")]
        for t in stages:
            if t in workers:
                continue
            t.join(timeout=drain_timeout)
            if t.is_alive():
                logger.warning("ClusterServing.stop: thread %s did not "
                               "exit within %.1fs", t.name, drain_timeout)
        self._workers_done.set()  # workers: exit once the queue is empty
        for t in workers:
            t.join(timeout=drain_timeout)
            if t.is_alive():
                logger.warning("ClusterServing.stop: thread %s did not "
                               "exit within %.1fs", t.name, drain_timeout)
        # requests still sitting in the closed queue will never be popped
        # through _take: zero the occupancy gauge so a stopped server (or
        # a successor sharing the process registry) reports no phantom
        # queue depth; the high-water mark is preserved
        self._m_depth.set(0.0)
        # drain (a): never assembled — still in _pending / native queue
        with self._pending_lock:
            pending = list(self._pending.values())
            self._pending.clear()
        # drain (b): admitted by the scheduler but never dispatched —
        # parked in its local backlog (continuous batching holds rows
        # there between fill and admit)
        pending.extend(self.scheduler.drain_rows())
        # drain (c): assembled but never inferred — left in the internal
        # batch queue because a worker timed out or stop raced dispatch
        while True:
            try:
                ab = self._batch_q.get_nowait()
            except queue_mod.Empty:
                break
            self._finish_batch(ab)
            pending.extend(ab.group)
        # health probes pending in the queue get a terminal pong (they
        # never counted as requests, so no error/drained accounting)
        pings = [p for p in pending if p.ping]
        pending = [p for p in pending if not p.ping]
        for p in pings:
            self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                                 "pong": True, "state": "stopped"}, None)
        if pending:
            self._count(errors=len(pending), drained=len(pending))
            for p in pending:
                self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                                     "error": "server shutting down"},
                                 None)
            logger.info("ClusterServing.stop: drained %d pending "
                        "request(s)", len(pending))
        # flush per-connection reply writers BEFORE closing sockets: the
        # drain replies above must reach their clients first
        with self._threads_lock:
            writers = list(self._writers.values())
            conns = list(self._conns)
        for w in writers:
            w.close(timeout=drain_timeout)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    # -- stage 1: accept + parse ---------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            t = threading.Thread(target=self._conn_loop, args=(conn,),
                                 daemon=True, name="zoo-serving-conn")
            with self._threads_lock:
                self._conns.add(conn)
            t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        writer = _ConnWriter(conn, send_lock, self._m_reply)
        with self._threads_lock:
            self._writers[conn] = writer
        try:
            while not self._stop.is_set():
                frame = protocol.recv_frame(conn)
                if frame is None:
                    return
                if self._faults.fire("serving.conn_drop"):
                    # injected transient network fault: the request (and
                    # this connection) vanish without a reply — clients
                    # must recover via reconnect + idempotent re-enqueue
                    logger.debug("fault: dropping connection")
                    return
                if self._faults.fire("serving.replica_down"):
                    # injected hard crash: the whole replica vanishes,
                    # SIGKILL-style — no reply, no drain.  Clients and
                    # the router recover via reconnect/failover.
                    logger.debug("fault: replica down")
                    self.kill()
                    return
                if self._faults.fire("serving.net_partition"):
                    # injected network partition: every client conn is
                    # severed but the PROCESS lives — pipeline, queue,
                    # pending state and the listener all survive, so the
                    # replica "heals" the moment clients reconnect.
                    logger.debug("fault: net partition")
                    self.partition()
                    return
                header, arr = protocol.decode(frame)
                uid = header.get("uuid") or str(uuid_mod.uuid4())
                tid = header.get("trace")
                if header.get("type") == protocol.PING:
                    self._enqueue_ping(uid, tid, conn, send_lock, writer)
                    continue
                if header.get("type") == protocol.METRICS:
                    # telemetry scrape: answered inline (a registry read,
                    # no queue slot, no request accounting) so a cluster
                    # scrape works even against a draining replica
                    with send_lock:
                        protocol.send_frame(conn, protocol.encode(
                            {"uuid": uid, "trace": tid,
                             "metrics": self._metrics.snapshot()}))
                    continue
                # request class rides the optional-header mechanism:
                # absent (or unknown) = unclassified, the exact
                # pre-klass admission path
                klass = header.get("klass")
                if klass not in protocol.KLASSES:
                    klass = None
                self._count(requests=1)
                if klass is not None:
                    self._klass_counter("server.requests", klass).inc()
                if self._draining.is_set():
                    # retryable by design: the client backs off and its
                    # retry lands on a sibling replica (router) or on
                    # this port's successor (rolling restart)
                    self._count(errors=1, draining_rejected=1)
                    with send_lock:
                        protocol.send_frame(conn, protocol.encode(
                            {"uuid": uid, "trace": tid,
                             "error": "draining"}))
                    continue
                if arr is None:
                    # protocol-legal but not servable: a header-only frame
                    # has no tensor to batch — reject here rather than let
                    # it poison the pipeline
                    self._count(errors=1)
                    with send_lock:
                        protocol.send_frame(conn, protocol.encode(
                            {"uuid": uid, "trace": tid,
                             "error": "no tensor in request"}))
                    continue
                # model routing: validate at the door (an unroutable
                # request costs a reply, not a queue slot); the raw
                # header fields ride the _Pending so assembly re-resolves
                # against the version active at dispatch time.
                # Fast path: default traffic with no version pin is
                # always routable (the default entry always has an
                # active version) — skip the registry-lock round trip
                # that would otherwise serialize every conn thread.
                mname = header.get("model")
                mver = header.get("version")
                bad = (None if (mname is None and mver is None
                                and self._default_name is not None)
                       else self.registry.route_error(
                           mname if mname is not None
                           else self._default_name, mver))
                if bad is not None:
                    self._count(errors=1, unknown_model=1)
                    with send_lock:
                        protocol.send_frame(conn, protocol.encode(
                            {"uuid": uid, "trace": tid, "error": bad}))
                    continue
                # deadline_ms is a RELATIVE budget re-anchored at arrival:
                # client and server clocks never need to agree
                deadline_ms = header.get("deadline_ms")
                expires = (time.monotonic() + deadline_ms / 1000.0
                           if deadline_ms is not None else None)
                reason = self._admission_reject(deadline_ms, klass)
                if reason is not None:
                    self._count(errors=1, admission_rejected=1)
                    if klass is not None:
                        self._klass_counter("server.admission_rejected",
                                            klass).inc()
                    with send_lock:
                        protocol.send_frame(conn, protocol.encode(
                            {"uuid": uid, "trace": tid, "error": reason}))
                    continue
                with self._pending_lock:
                    rid = self._next_id
                    self._next_id += 1
                    self._pending[rid] = _Pending(uid, arr, conn, send_lock,
                                                  writer, expires,
                                                  trace=tid, model=mname,
                                                  version=mver,
                                                  span=header.get("span"),
                                                  klass=klass)
                # occupancy BEFORE the push: the assembly stage may pop
                # (and decrement) the instant push returns, and a +1 that
                # lands after the -1 would miss the high-water mark
                self._m_depth.add(1)
                try:
                    ok = (not self._faults.fire("serving.queue_reject")
                          and self._queue.push(rid.to_bytes(8, "big"),
                                               timeout=self.push_timeout))
                except RuntimeError:  # queue closed: server is stopping
                    self._m_depth.add(-1)
                    self._answer_after_stop(rid)
                    raise
                if not ok:  # back-pressure: reject instead of dropping
                    self._m_depth.add(-1)  # never entered the queue
                    with self._pending_lock:
                        self._pending.pop(rid, None)
                    self._count(errors=1, rejected=1)
                    with send_lock:
                        protocol.send_frame(conn, protocol.encode(
                            {"uuid": uid, "trace": tid,
                             "error": "queue full"}))
        except (OSError, ValueError) as e:
            logger.debug("connection closed: %s", e)
        except RuntimeError:
            pass  # queue closed: server is stopping
        finally:
            with self._threads_lock:
                self._conns.discard(conn)
                self._writers.pop(conn, None)
            writer.close()
            conn.close()

    def _klass_counter(self, name: str,
                       klass: str) -> metrics_lib.Counter:
        """Cached ``<name>{klass=...}`` counter handle — per-request
        registry name lookups would serialize the conn threads on the
        registry's global lock.  Bounded: klass is validated against
        ``protocol.KLASSES`` before this is called."""
        key = (name, klass)
        c = self._m_klass.get(key)
        if c is None:
            c = self._metrics.counter(name, klass=klass)
            self._m_klass[key] = c
        return c

    def _admission_reject(self, deadline_ms,
                          klass: Optional[str] = None) -> Optional[str]:
        """Admission gate, evaluated at arrival: the rejection reason, or
        None to admit.

        - **queue depth**: past ``admission_queue_limit`` the reply is a
          retryable ``queue full`` — same semantics as the native
          queue's hard bound, but tripped early enough that a router can
          fail over before this replica saturates.
        - **deadline**: a request whose entire budget is below the
          observed queue wait (EWMA, maintained by the assembly stage)
          would be shed after waiting anyway; ``deadline unattainable``
          at the door costs the client nothing and the queue no slot.
          Only applies while requests are actually queued (depth >= 1):
          an idle server's stale EWMA must not reject a fresh burst.
        - **per class**: ``klass="batch"`` sheds FIRST — its
          depth cap is ``admission_queue_limit ×
          admission_batch_depth_frac`` and its attainability test
          multiplies the observed wait by
          ``admission_batch_wait_margin``, so under a transient the
          batch tier is rejected (retryably) while interactive and
          unclassified traffic keep the exact pre-klass gate."""
        # rows the continuous scheduler eagerly pulled into its backlog
        # are load the native-queue gauge no longer sees — without them
        # the gate admits into a saturated replica the router should
        # have failed over from (same correction stats() makes)
        depth = self._m_depth.value + self.scheduler.backlog()
        limit = self.admission_queue_limit
        margin = 1.0
        if klass == "batch":
            margin = self.admission_batch_wait_margin
            if limit is not None:
                limit = max(1, int(limit * self.admission_batch_depth_frac))
        if limit is not None and depth >= limit:
            return "queue full (admission limit)"
        if (deadline_ms is not None and depth >= 1
                and 0.0 < self._wait_ewma
                and deadline_ms < self._wait_ewma * margin):
            return (f"deadline unattainable: budget {deadline_ms}ms < "
                    f"observed queue wait ~{self._wait_ewma:.0f}ms"
                    + (f" x {margin:g} (batch margin)"
                       if margin != 1.0 else ""))
        return None

    def _enqueue_ping(self, uid: str, tid: Optional[str],
                      conn: socket.socket, send_lock: threading.Lock,
                      writer: "Optional[_ConnWriter]") -> None:
        """Queue a health probe for the ASSEMBLY stage to answer — the
        point of riding the queue is that a wedged assembly stage (or a
        jammed queue) fails the probe even though the socket is fine.
        The push timeout is short: a jammed queue should fail the probe
        NOW (error-carrying pong), not block this connection's reader
        for the full ``push_timeout``."""
        self._count(pings=1)
        with self._pending_lock:
            rid = self._next_id
            self._next_id += 1
            self._pending[rid] = _Pending(uid, None, conn, send_lock,
                                          writer, trace=tid, ping=True)
        self._m_depth.add(1)
        try:
            ok = self._queue.push(rid.to_bytes(8, "big"), timeout=0.05)
        except RuntimeError:  # queue closed: server is stopping
            self._m_depth.add(-1)
            self._answer_after_stop(rid)
            raise
        if not ok:
            self._m_depth.add(-1)
            with self._pending_lock:
                self._pending.pop(rid, None)
            with send_lock:
                protocol.send_frame(conn, protocol.encode(
                    {"uuid": uid, "trace": tid, "pong": True,
                     "state": self.state, "error": "queue full"}))

    def _answer_after_stop(self, rid: int) -> None:
        """A request or probe that entered ``_pending`` while ``stop()``
        closed the queue (a client's replay on a connection accepted
        during the stop): ``stop()``'s drain may have run already, so it
        is answered here, or it would stay in flight forever.  Sent
        inline, since this connection closes right after."""
        with self._pending_lock:
            p = self._pending.pop(rid, None)
        if p is None:
            return  # the drain answered it
        if p.ping:
            header = {"uuid": p.uuid, "trace": p.trace, "pong": True,
                      "state": "stopped"}
        else:
            self._count(errors=1, drained=1)
            header = {"uuid": p.uuid, "trace": p.trace,
                      "error": "server shutting down"}
        try:
            with p.lock:
                protocol.send_frame(p.conn, protocol.encode(header))
        except (OSError, ValueError):
            pass  # client went away

    # -- stage 2: batch assembly ----------------------------------------------

    def _assembly_loop(self) -> None:
        # the batching POLICY lives in the scheduler (window /
        # continuous / custom); this thread just runs it.  The scheduler
        # owns the native-queue pops and routes every round through
        # fault-fire → ping answers → deadline shed →
        # _assemble_and_dispatch (see scheduler.Scheduler._finish_round)
        self.scheduler.run(self)

    def _assemble_and_dispatch(self, batch: List[_Pending]) -> None:
        """Group by (model, version, input shape) — mixed-shape requests
        can't stack and mixed-model rows run different executables —
        stage each group's rows into a pooled buffer, resolve the
        group's model against the registry (pinning the version active
        NOW, so a hot swap applies to everything assembled after the
        flip), and hand the assembled batches to the inference
        workers."""
        groups: Dict[Tuple, List[_Pending]] = {}
        for p in batch:
            # normalize an absent model to the default name BEFORE
            # grouping: clients saying model="default" explicitly and
            # clients saying nothing mean the same executable, and raw
            # header keys would split them into two half-size batches
            groups.setdefault(
                (p.model if p.model is not None else self._default_name,
                 p.version)
                + tuple(p.arr.shape) + (str(p.arr.dtype),),
                []).append(p)
        now = time.monotonic()
        # resolve each raw group, then MERGE groups that resolved to
        # the same executable: canary clients pinning the currently-
        # active version and unpinned clients otherwise split into two
        # half-size batches every round.  (Raw version pins can't be
        # normalized at grouping time — resolving the pin there would
        # let a flip landing mid-round error unpinned rows.)
        resolved: Dict[Tuple, List] = {}
        for key, group in groups.items():
            mname, mver = key[0], key[1]
            try:
                # begin=True: the in-flight increment happens inside
                # resolve's lock hold, so a concurrent swap's drain can
                # never see zero in-flight while this batch is between
                # resolution and dispatch
                im, mname, mver = self.registry.resolve(
                    mname, mver, begin=True)
            except KeyError as e:
                # the pinned version (or the whole model) was unloaded
                # between admission and assembly: explicit error reply,
                # nothing silently dropped
                self._count(errors=len(group), unknown_model=len(group))
                for p in group:
                    self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                                         "error": str(e.args[0])}, None)
                continue
            rkey = (mname, mver) + key[2:]
            entry = resolved.get(rkey)
            if entry is None:
                resolved[rkey] = [im, mname, mver, group]
            else:
                # duplicate in-flight begin: the merged batch closes
                # exactly one, so release the extra now (the kept one
                # holds the count above zero throughout)
                self.registry.done(mname, mver)
                entry[3].extend(group)
        for im, mname, mver, group in resolved.values():
            t0 = time.monotonic()
            buf_key, buf = self._acquire_buf(group[0].arr.shape,
                                             group[0].arr.dtype)
            for i, p in enumerate(group):
                buf[i] = p.arr  # row copy into the reused staging buffer
                p.wait_ms = (now - p.enq_t) * 1000.0
                self._m_queue_wait.observe(p.wait_ms)
                # admission-gate estimate: only this (single) assembly
                # thread writes, conn threads read — GIL-safe
                self._wait_ewma += 0.2 * (p.wait_ms - self._wait_ewma)
            assembly_ms = (time.monotonic() - t0) * 1000.0
            self._m_assembly.observe(assembly_ms)
            ab = _AssembledBatch(group, buf[:len(group)], buf_key, buf,
                                 assembly_ms, im, mname, mver)
            if not self._dispatch(ab):
                # stopping and nobody will run it: explicit drain reply
                self._finish_batch(ab)
                self._release_buf(ab)
                self._count(errors=len(group), drained=len(group))
                for p in group:
                    self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                                         "error": "server shutting down"},
                                     None)

    def _finish_batch(self, ab: _AssembledBatch) -> None:
        """Close the registry's in-flight accounting for ``ab`` — the
        version-drain substrate behind ``ModelRegistry.swap``.
        Idempotent: dispatch-failure, worker and stop()-drain paths may
        all reach the same batch."""
        if not ab._done:
            ab._done = True
            self.registry.done(ab.model, ab.version)

    def _retire_model_series(self, name: str, version: str) -> None:
        """Registry unload hook: drop the (name, version) handle-cache
        entry and its ``server.requests{model=,version=}`` series.  The
        per-model ``server.batch_size{model=}`` series is shared across
        versions and deliberately NOT retired — an entry always keeps
        an active version (unload refuses it), so model names — unlike
        monotone refresh-swap version strings — are a bounded set."""
        self._m_model_series.pop((name, version), None)
        self._metrics.remove("server.requests", model=name,
                             version=version)

    def _model_series(self, name: str, version: str) -> Tuple:
        """Cached per-(model, version) labeled handles:
        ``server.requests{model=,version=}`` and
        ``server.batch_size{model=}``.

        A cache MISS for an already-unloaded version (a batch still in
        flight across a ``drain=False`` refresh swap) gets working but
        UNREGISTERED handles — re-registering would resurrect the
        series the unload hook just retired, permanently, since the
        hook never fires for that version again."""
        key = (name, version)
        h = self._m_model_series.get(key)
        if h is None:
            if version not in self.registry.versions(name):
                return (metrics_lib.Counter("server.requests", (),
                                            self._metrics),
                        metrics_lib.Histogram(
                            "server.batch_size", (), self._metrics,
                            buckets=metrics_lib.SIZE_BUCKETS))
            h = (self._metrics.counter("server.requests", model=name,
                                       version=version),
                 self._metrics.histogram(
                     "server.batch_size",
                     buckets=metrics_lib.SIZE_BUCKETS, model=name))
            self._m_model_series[key] = h
            if version not in self.registry.versions(name):
                # lost the race with a concurrent unload whose retire
                # hook ran between our check and the registration:
                # retire again (idempotent) — h keeps working unscraped
                self._retire_model_series(name, version)
        return h

    def _dispatch(self, ab: _AssembledBatch) -> bool:
        """Blocking put with a bounded post-stop grace window (workers
        keep draining during stop, so a full queue usually clears)."""
        stop_deadline: Optional[float] = None
        while True:
            try:
                self._batch_q.put(ab, timeout=0.25)
                return True
            except queue_mod.Full:
                if not self._stop.is_set():
                    continue
                if stop_deadline is None:
                    stop_deadline = time.monotonic() + 2.0
                elif time.monotonic() > stop_deadline:
                    return False

    def _acquire_buf(self, shape: Tuple[int, ...],
                     dtype: Any) -> Tuple[Tuple, np.ndarray]:
        """A staging buffer with capacity for a full batch of this
        shape, reused across batches (pool bounded by
        ``staging_pool``); the pool-miss path allocates fresh."""
        key = (tuple(shape), str(dtype))
        with self._staging_lock:
            free = self._staging.get(key)
            if free:
                return key, free.pop()
        return key, np.empty((self.batch_size,) + tuple(shape),
                             dtype=dtype)

    def _release_buf(self, ab: _AssembledBatch) -> None:
        """Return ``ab``'s staging buffer to the pool — idempotent (error
        paths may race the success path's release; the same ndarray must
        never sit in the pool twice, or two later assemblies would stage
        different batches into shared bytes)."""
        buf, ab.buf = ab.buf, None
        if buf is None:
            return
        with self._staging_lock:
            free = self._staging.setdefault(ab.buf_key, [])
            if len(free) < self.staging_pool:
                free.append(buf)

    def _take(self, rid_bytes: bytes) -> Optional[_Pending]:
        rid = int.from_bytes(rid_bytes, "big")
        self._m_depth.add(-1)  # popped from the native queue
        with self._pending_lock:
            return self._pending.pop(rid, None)

    def _answer_ping(self, p: _Pending) -> None:
        """Pong with the server's state + queue depth — the payload the
        router's health view is built from.  An armed
        ``serving.health_fail`` eats the pong (the probe times out
        client-side): the "wedged backend, healthy socket" failure."""
        if self._faults.fire("serving.health_fail"):
            logger.debug("fault: swallowing health ping %s", p.uuid)
            return
        self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                             "pong": True, "state": self.state,
                             "queue_depth": int(self._m_depth.value)},
                         None)

    def _shed_expired(self, batch: List[_Pending]) -> List[_Pending]:
        """Drop requests whose deadline already passed — running inference
        for a client that stopped waiting wastes TPU time AND delays every
        live request behind it.  Shed requests get an explicit error reply
        (the client's query raises instead of timing out)."""
        now = time.monotonic()
        live: List[_Pending] = []
        expired: List[_Pending] = []
        for p in batch:
            if p.expires is not None and p.expires < now:
                expired.append(p)
            else:
                live.append(p)
        if expired:
            # count FIRST, reply second: a client reacting to the shed
            # reply must already see consistent counters in stats().
            # shed_batches + the per-batch histogram record the shed
            # DISTRIBUTION — a cumulative counter can't tell "one bad
            # batch shed 30" from "30 batches shed 1 each".
            self._count(errors=len(expired), shed=len(expired),
                        shed_batches=1)
            self._m_shed_per_batch.observe(len(expired))
            for p in expired:
                if p.klass is not None:
                    self._klass_counter("server.shed", p.klass).inc()
            for p in expired:
                self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                                     "error": "deadline exceeded"}, None)
        return live

    # -- stage 3: inference workers --------------------------------------------

    def _worker_loop(self, wid: int) -> None:
        # exit check at the TOP: on stop() a worker finishes the batch it
        # is running and returns — batches still queued get an explicit
        # "server shutting down" drain reply instead of late inference
        while not self._workers_done.is_set():
            try:
                ab = self._batch_q.get(timeout=0.25)
            except queue_mod.Empty:
                continue
            try:
                self._run_batch(ab)
            except Exception as e:  # noqa: BLE001 — workers must survive
                logger.warning("batch failed: %s", e)
                self._release_buf(ab)
                self._count(errors=len(ab.group))
                for p in ab.group:
                    self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                                         "error": str(e)}, None)
            finally:
                self._finish_batch(ab)

    def _run_batch(self, ab: _AssembledBatch) -> None:
        # a batch can sit in the internal queue past its rows' deadlines:
        # re-shed here so inference never runs for a departed client
        group = self._shed_expired(ab.group)
        if not group:
            self._release_buf(ab)
            return
        x = ab.x
        if len(group) < len(ab.group):
            # re-shed dropped rows: re-stage the survivors so row i of
            # the model input is row i of ``group`` — predicting on the
            # stale full buffer would zip survivors with OTHER requests'
            # outputs (silently wrong answers)
            buf = ab.buf if ab.buf is not None else np.empty(
                (self.batch_size,) + group[0].arr.shape,
                dtype=group[0].arr.dtype)
            for i, p in enumerate(group):
                buf[i] = p.arr
            x = buf[:len(group)]
        self._count(batches=1, batch_rows=len(group))
        self._m_batch_size.observe(len(group))
        # per-model labeled series (the unlabeled ones above aggregate)
        m_req, m_bs = self._model_series(ab.model, ab.version)
        m_req.inc(len(group))
        m_bs.observe(len(group))
        t_inf = time.monotonic()
        try:
            pipe = self.pipelines.get(ab.model or self._default_name)
            if pipe is not None:
                # registered feature transform: raw event columns in,
                # model-ready features out (counts toward inference_ms —
                # it is per-request serving compute either way)
                x = pipe(x)
            out = np.asarray(ab.im.predict(x))
            infer_ms = (time.monotonic() - t_inf) * 1000.0
            if np.may_share_memory(out, x):
                # a pass-through-ish model returned (a view of) its
                # input: the reply rows would alias the staging buffer,
                # which the pool is about to hand to the next assembly —
                # copy before releasing
                out = out.copy()
            self._release_buf(ab)
            self._m_infer.observe(infer_ms)
            # count BEFORE sending: a client that reacts to the
            # reply must already see consistent counters in stats()
            # (requests == replies + errors + pending at all times)
            self._count(replies=len(group))
            for p, row in zip(group, out):
                stages = None
                sid = None
                if p.trace is not None:
                    # per-stage breakdown rides the reply header so
                    # the client can answer "where did the latency
                    # go?" without a second round trip
                    stages = {
                        "server.queue_wait_ms": round(p.wait_ms, 3),
                        "server.assembly_ms": round(ab.assembly_ms, 3),
                        "server.inference_ms": round(infer_ms, 3),
                        "server.batch_size": len(group)}
                    if trace_lib.enabled:
                        # span tree: server.batch parents under the
                        # client attempt span from the frame header;
                        # the pipeline stages hang beneath it (the
                        # reply-writer stage attaches in _ConnWriter
                        # once the send actually happened)
                        sid = trace_lib.new_span_id()
                        trace_lib.record(p.trace, "server.batch", stages,
                                         span_id=sid, parent=p.span)
                        trace_lib.record(
                            p.trace, "server.assembly",
                            {"assembly_ms": round(ab.assembly_ms, 3)},
                            parent=sid, dur_ms=ab.assembly_ms)
                        trace_lib.record(
                            p.trace, "server.inference",
                            {"inference_ms": round(infer_ms, 3)},
                            parent=sid, dur_ms=infer_ms)
                hdr = {"uuid": p.uuid, "trace": p.trace,
                       "stages": stages}
                if sid is not None:
                    hdr["span"] = sid
                if p.model is not None:
                    # name the (resolved) serving version only for
                    # requests that routed by model explicitly — the
                    # default traffic's reply frames stay byte-identical
                    # to the pre-registry server for bisection
                    hdr["model"] = ab.model
                    hdr["version"] = ab.version
                self._send_reply(p, hdr, row)
        except Exception as e:  # noqa: BLE001 — report to the client
            logger.warning("inference failed: %s", e)
            self._release_buf(ab)
            self._count(errors=len(group))
            for p in group:
                self._send_reply(p, {"uuid": p.uuid, "trace": p.trace,
                                     "error": str(e)}, None)

    # -- stage 4: reply delivery ------------------------------------------------

    def _send_reply(self, p: _Pending, header: Dict[str, Any],
                    arr: Optional[np.ndarray]) -> None:
        """Hand the reply to the connection's writer stage; fall back to
        a best-effort inline send when the writer is gone (connection
        closing, or stop() already flushed it)."""
        if p.writer is not None and p.writer.push(header, arr):
            return
        try:
            with p.lock:
                protocol.send_frame_parts(p.conn,
                                          protocol.encode_parts(header,
                                                                arr))
        except (OSError, ValueError):
            pass  # client went away


def main(argv: Optional[List[str]] = None) -> None:
    """``zoo-serving`` launcher (reference: the cluster-serving-start script
    + config.yaml, scripts/cluster-serving/).  Loads a ``ZooModel.save_model``
    directory (of either package), starts the TCP service and, optionally,
    the HTTP frontend.  Runnable as ``python -m
    analytics_zoo_tpu_torch.serving.server``; serves on the card unless
    ``--device`` names another device."""
    import argparse
    import signal

    parser = argparse.ArgumentParser(prog="zoo-serving",
                                     description=main.__doc__)
    parser.add_argument("--model-dir", default=None,
                        help="a ZooModel.save_model directory (the "
                             "'default' model)")
    parser.add_argument("--model", action="append", default=None,
                        metavar="NAME=DIR",
                        help="additional named model(s) for multi-model "
                             "serving; repeatable")
    parser.add_argument("--scheduler", default=None,
                        choices=sorted(scheduler_lib.SCHEDULERS),
                        help="assembly batching policy (default: "
                             "ZooConfig.scheduler, window)")
    parser.add_argument("--config", default=None,
                        help="ZooConfig JSON/YAML file; its serving "
                             "fields (scheduler, models) seed the flags")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8980)
    parser.add_argument("--batch-size", type=int, default=16)
    parser.add_argument("--inference-workers", type=int, default=None,
                        help="concurrent model-call threads (default: "
                             "ZooConfig.inference_workers, 2)")
    parser.add_argument("--http-port", type=int, default=None,
                        help="also serve HTTP/JSON on this port")
    parser.add_argument("--hedge-ms", default=None, metavar="MS|auto",
                        help="router hedge threshold in ms, or 'auto' to "
                             "self-tune from the observed latency "
                             "distribution (requires --http-port)")
    parser.add_argument("--autoscale", action="store_true",
                        help="run a ServingController that scales "
                             "zoo-serving subprocess replicas to hold "
                             "the SLO (requires --http-port; see "
                             "ZooConfig controller_* fields)")
    parser.add_argument("--slo-p99-ms", type=float, default=None,
                        help="autoscaler SLO on the windowed client p99 "
                             "(default: ZooConfig.controller_slo_p99_ms)")
    parser.add_argument("--min-replicas", type=int, default=None,
                        help="autoscaler pool floor (default: "
                             "ZooConfig.controller_min_replicas)")
    parser.add_argument("--max-replicas", type=int, default=None,
                        help="autoscaler pool ceiling (default: "
                             "ZooConfig.controller_max_replicas)")
    parser.add_argument("--controller-interval", type=float, default=None,
                        help="seconds between control ticks (default: "
                             "ZooConfig.controller_interval_s)")
    parser.add_argument("--device", default=None,
                        help="the device the models run on (default: the "
                             "card; 'cpu' runs the plain versions of the "
                             "kernels)")
    args = parser.parse_args(argv)

    def load(mdir: str) -> InferenceModel:
        return InferenceModel(device=args.device).load_zoo_model(mdir)

    cfg = None
    if args.config is not None:
        cfg = ZooConfig.from_file(args.config)
    models = {}
    for spec in args.model or []:
        name, sep, mdir = spec.partition("=")
        if not sep or not name or not mdir:
            parser.error(f"--model expects NAME=DIR, got {spec!r}")
        models[name] = load(mdir)
    if cfg is not None:
        for name, mdir in (cfg.models or {}).items():
            if name not in models:
                models[name] = load(mdir)
    model = load(args.model_dir) if args.model_dir else None
    if model is None and not models:
        parser.error("at least one of --model-dir / --model / a config "
                     "with models is required")
    scheduler = args.scheduler or (cfg.scheduler if cfg else None)
    serving = ClusterServing(model, host=args.host, port=args.port,
                             batch_size=args.batch_size,
                             inference_workers=args.inference_workers,
                             scheduler=scheduler,
                             models=models or None,
                             ).start()
    if (args.autoscale or args.hedge_ms is not None) \
            and args.http_port is None:
        parser.error("--autoscale/--hedge-ms route through the HTTP "
                     "frontend's replica set; add --http-port")
    frontend = None
    controller = None
    if args.http_port is not None:
        from .http_frontend import HTTPFrontend
        from .router import ReplicaSet
        hedge = args.hedge_ms
        if hedge is not None and hedge != "auto":
            hedge = float(hedge)
        router = ReplicaSet([(serving.host, serving.port)],
                            hedge_ms=hedge)
        frontend = HTTPFrontend(host=args.host, port=args.http_port,
                                router=router).start()
        logger.info("HTTP frontend on %s:%d", args.host, frontend.port)
        if args.autoscale:
            from .controller import (HysteresisPolicy, ServingController,
                                     SubprocessReplicaFactory)
            base = cfg or ZooConfig()
            # new replicas are clones of this one: same model/scheduler
            # flags, their own port (picked by the factory)
            child: List[str] = []
            if args.model_dir:
                child += ["--model-dir", args.model_dir]
            for spec in args.model or []:
                child += ["--model", spec]
            if args.config:
                child += ["--config", args.config]
            if args.scheduler:
                child += ["--scheduler", args.scheduler]
            child += ["--batch-size", str(args.batch_size)]
            if args.inference_workers is not None:
                child += ["--inference-workers",
                          str(args.inference_workers)]
            if args.device is not None:
                child += ["--device", args.device]
            policy = HysteresisPolicy(
                slo_p99_ms=(args.slo_p99_ms
                            if args.slo_p99_ms is not None
                            else base.controller_slo_p99_ms),
                queue_high=base.controller_queue_high,
                min_replicas=(args.min_replicas
                              if args.min_replicas is not None
                              else base.controller_min_replicas),
                max_replicas=(args.max_replicas
                              if args.max_replicas is not None
                              else base.controller_max_replicas),
                up_cooldown_s=base.controller_up_cooldown_s,
                down_cooldown_s=base.controller_down_cooldown_s,
                down_ticks=base.controller_down_ticks)
            controller = ServingController(
                router, SubprocessReplicaFactory(extra_args=child),
                policy=policy,
                interval_s=(args.controller_interval
                            if args.controller_interval is not None
                            else base.controller_interval_s),
                scrape_cluster=True,
                flightrec_dir=base.flightrec_dir).start()
            logger.info("autoscaler on: slo_p99=%.0fms replicas=[%d,%d]",
                        policy.slo_p99_ms, policy.min_replicas,
                        policy.max_replicas)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *_: stop.set())
    signal.signal(signal.SIGINT, lambda *_: stop.set())
    try:
        stop.wait()
    finally:
        if controller is not None:
            controller.close()  # stop loop, retire subprocess replicas
        if frontend is not None:
            frontend.stop()
        # SIGTERM = rolling-restart contract: drain (retryable
        # "draining" replies, in-flight batches finish) before stop
        serving.drain(timeout=10.0)
        serving.stop()


if __name__ == "__main__":
    main()
