# Port of analytics_zoo_tpu/serving/client.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Serving client (reference: pyzoo/zoo/serving/client.py — InputQueue
pushed b64-Arrow ndarrays into Redis, OutputQueue polled result keys).

Same two-class API over the TCP frame protocol; one connection carries both
directions, results are matched by uuid.

Resilience: the reference leaned on Redis persistence + Flink
restarts to ride out worker loss; here the client itself is the retry
layer.  A connection that dies (server restart, injected
``serving.conn_drop``) is re-established with exponential backoff +
jitter, and the in-flight request is re-enqueued VERBATIM under its
original uuid — inference is deterministic, so a duplicate run returns
the same answer and the re-enqueue is idempotent from the caller's view.
Retryable server errors ("queue full" backpressure, "server shutting
down" drain) are retried the same way, bounded by the ``RetryPolicy``.
A per-request deadline rides in the frame header (``deadline_ms``) so
the server can shed the request instead of serving a reply nobody is
waiting for.
"""

from __future__ import annotations

import logging
import random
import socket
import threading
import time
import uuid as uuid_mod
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from . import protocol

logger = logging.getLogger("analytics_zoo_tpu")

#: Server error replies that mean "try again", not "your request is bad".
#: ``draining`` is the rolling-restart reply: the replica is finishing
#: in-flight work and a retry (after backoff) lands on this port's
#: successor — or, behind the router, on a sibling replica immediately.
RETRYABLE_ERRORS = ("queue full", "server shutting down", "draining")

#: The keys of ``_Conn.stats`` — shared with consumers that must render
#: a zeroed stats dict for a connection that doesn't exist yet (the
#: frontend's per-replica ``/stats`` view), so the payload shape cannot
#: drift when a counter is added here.
CONN_STATS_KEYS = ("reconnects", "resends", "retries", "replayed")


@dataclass
class RetryPolicy:
    """Bounded exponential backoff with deterministic, seedable jitter.

    ``max_attempts`` counts every try including the first; delays grow
    ``base_delay * 2^k`` capped at ``max_delay``, each multiplied by a
    jitter factor drawn uniformly from [1-jitter, 1+jitter] using a
    ``random.Random(seed)`` so tests replay exactly."""

    max_attempts: int = 4
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    seed: Optional[int] = None

    def __post_init__(self) -> None:
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")
        self._rng = random.Random(self.seed)

    def delay(self, attempt: int) -> float:
        """Backoff before retry number ``attempt`` (1-based)."""
        raw = min(self.base_delay * (2 ** max(0, attempt - 1)),
                  self.max_delay)
        lo, hi = 1.0 - self.jitter, 1.0 + self.jitter
        return raw * self._rng.uniform(max(0.0, lo), hi)


class _Conn:
    """Shared connection + background reader demuxing replies by uuid,
    with reconnect + idempotent resend of in-flight frames.

    Request frames are kept as one contiguous ``bytes`` (the resend
    record needs the full frame anyway); replies arrive through the
    zero-copy receive path (``protocol.recv_frame``'s single
    preallocated buffer), so the decoded ndarray aliases the receive
    buffer instead of copying.  A reply whose length prefix exceeds
    ``protocol.MAX_FRAME_BYTES`` kills the reader (ValueError) exactly
    like a dead socket — the reconnect path takes over."""

    #: replies for abandoned uuids (query timed out before the server
    #: answered) are evicted oldest-first beyond this bound
    MAX_UNCLAIMED = 1024
    #: in-flight frames kept for resend are evicted the same way, bounded
    #: both by count and by total bytes (frames hold the full encoded
    #: tensor; large batches must not double the client's memory without
    #: limit).  An evicted request loses its recovery path — logged when
    #: that actually bites (see resend).
    MAX_INFLIGHT = 1024
    MAX_INFLIGHT_BYTES = 64 * 1024 * 1024

    def __init__(self, host: str, port: int, timeout: float = 30.0,
                 retry: Optional[RetryPolicy] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 labels: Optional[Dict[str, str]] = None):
        self.host, self.port = host, port
        self.connect_timeout = timeout
        self.retry = retry or RetryPolicy()
        # extra metric labels on every client.* series this connection
        # emits — the router labels each replica's connection
        # ``replica=host:port`` so one scrape separates the backends
        self._labels = dict(labels or {})
        # insertion-ordered (dicts are), so eviction drops the oldest
        self._results: Dict[str, Tuple[Optional[np.ndarray], Optional[str],
                                       Optional[Dict]]]
        self._results = {}
        self._inflight: Dict[str, bytes] = {}  # uuid -> encoded frame
        self._inflight_bytes = 0
        # uuid -> (trace id, enqueue time.monotonic, client span id):
        # the client half of the end-to-end trace (core/trace.py); the
        # span id also rode the frame header so server-side stage spans
        # parent under this attempt
        self._traces: Dict[str, Tuple[str, float, Optional[str]]] = {}
        self._generation = 0  # bumped per successful (re)connect
        self._cond = threading.Condition()
        self._send_lock = threading.Lock()
        self._conn_lock = threading.Lock()  # serializes reconnects
        self._closed = False
        self.stats = dict.fromkeys(CONN_STATS_KEYS, 0)
        # uuid -> times its frame was replayed by a reconnect; bounded by
        # the retry policy so a flapping backend can't replay forever
        self._replay_counts: Dict[str, int] = {}
        self._metrics = metrics or metrics_lib.get_registry()
        self._m_request = self._metrics.histogram("client.request_ms",
                                                  **self._labels)
        self.sock: Optional[socket.socket] = None
        self._reader: Optional[threading.Thread] = None
        self._connect()

    def _bump(self, key: str) -> None:
        """One resilience event: the legacy ``stats`` dict AND the
        process registry (``client.<key>``) move together."""
        self.stats[key] += 1
        self._metrics.inc("client." + key, **self._labels)

    def trace_id(self, uid: str) -> Optional[str]:
        """The trace id stamped on request ``uid`` (None once the
        request is forgotten or was never traced)."""
        with self._cond:
            info = self._traces.get(uid)
        return info[0] if info else None

    # -- connection lifecycle --------------------------------------------------

    def _connect(self) -> None:
        """One connection attempt (raises OSError on failure)."""
        sock = socket.create_connection((self.host, self.port),
                                        timeout=self.connect_timeout)
        # the timeout bounds connect only; left on the socket it would kill
        # the background reader after any 30s idle gap (recv raises, thread
        # exits, every later query returns None)
        sock.settimeout(None)
        self.sock = sock
        self._generation += 1
        # reader binds the socket as an argument: a stale reader from a
        # previous connection must never recv() from the new socket
        self._reader = threading.Thread(target=self._read_loop,
                                        args=(sock,), daemon=True)
        self._reader.start()

    def _read_loop(self, sock: socket.socket) -> None:
        try:
            while True:
                frame = protocol.recv_frame(sock)
                if frame is None:
                    return
                header, arr = protocol.decode(frame)
                with self._cond:
                    # the full header, not just stages: pong replies
                    # carry their payload (state, queue_depth) there
                    self._results[header["uuid"]] = (arr,
                                                     header.get("error"),
                                                     header)
                    while len(self._results) > self.MAX_UNCLAIMED:
                        self._results.pop(next(iter(self._results)))
                    self._cond.notify_all()
        except (OSError, ValueError):
            pass

    @property
    def alive(self) -> bool:
        """The reader thread exits exactly when the server closes (or
        resets) its end — the reliable liveness signal; a dead peer is NOT
        reliably visible on send (the first write after a remote close
        succeeds)."""
        return self._reader is not None and self._reader.is_alive()

    def reconnect(self) -> None:
        """Re-establish the connection with bounded backoff + jitter.
        Raises the last OSError when every attempt fails."""
        with self._conn_lock:
            if self._closed:
                raise OSError("connection closed by caller")
            if self.alive:
                return  # another thread already reconnected
            last: Optional[OSError] = None
            for attempt in range(1, self.retry.max_attempts + 1):
                try:
                    self.sock.close()
                except OSError:
                    pass
                try:
                    self._connect()
                    self._bump("reconnects")
                    logger.debug("reconnected to %s:%d (attempt %d)",
                                 self.host, self.port, attempt)
                    self._replay_inflight()
                    return
                except OSError as e:
                    last = e
                    if attempt < self.retry.max_attempts:
                        time.sleep(self.retry.delay(attempt))
            raise OSError(
                f"could not reconnect to {self.host}:{self.port} after "
                f"{self.retry.max_attempts} attempts: {last}") from last

    def _replay_inflight(self) -> None:
        """Re-enqueue EVERY recorded in-flight frame on a fresh connection.
        Requests from other threads sharing this connection died with the
        old socket too — without a full replay, only the thread that
        noticed the dead reader would retry, and the rest would silently
        wait out their timeouts.  Duplicates are harmless: replies key on
        uuid and inference is deterministic.

        Replays per uid are BOUNDED by the retry policy: a backend that
        flaps faster than it answers would otherwise replay the same
        frames on every reconnect, forever.  A uid over the cap is failed
        with a visible error reply (its ``query`` raises instead of
        waiting out the timeout) and dropped from the record."""
        cap = self.retry.max_attempts
        with self._cond:
            items = list(self._inflight.items())
            frames = []
            for uid, frame in items:
                n = self._replay_counts.get(uid, 0) + 1
                if n > cap:
                    self._inflight.pop(uid, None)
                    self._inflight_bytes -= len(frame)
                    self._replay_counts.pop(uid, None)
                    self._results[uid] = (
                        None,
                        f"replay budget exhausted: request replayed "
                        f"{cap} times across reconnects without a reply",
                        None)
                    continue
                self._replay_counts[uid] = n
                frames.append(frame)
            if len(frames) < len(items):
                self._cond.notify_all()
                logger.warning(
                    "%d in-flight request(s) exceeded the replay cap "
                    "(%d) and were failed", len(items) - len(frames), cap)
        for frame in frames:
            try:
                with self._send_lock:
                    protocol.send_frame(self.sock, frame)
                self._bump("resends")
                self._bump("replayed")
            except OSError:
                return  # died again: the next liveness check handles it

    def close(self) -> None:
        self._closed = True
        try:
            self.sock.close()
        except OSError:
            pass

    # -- sending ---------------------------------------------------------------

    def send_request(self, header: Dict, arr: Optional[np.ndarray]) -> None:
        """Encode + send a request frame, recording it for idempotent
        resend; reconnects with backoff on a dead socket."""
        frame = protocol.encode(header, arr)
        uid = header["uuid"]
        with self._cond:
            old = self._inflight.get(uid)
            if old is not None:
                # same uid re-sent (router retry on this replica): the
                # byte accounting must not count the frame twice
                self._inflight_bytes -= len(old)
            self._inflight[uid] = frame
            self._inflight_bytes += len(frame)
            if header.get("trace") is not None:
                self._traces[uid] = (header["trace"], time.monotonic(),
                                     header.get("span"))
            while (len(self._inflight) > self.MAX_INFLIGHT
                   or self._inflight_bytes > self.MAX_INFLIGHT_BYTES):
                evicted = next(iter(self._inflight))
                dropped = self._inflight.pop(evicted)
                self._inflight_bytes -= len(dropped)
                self._traces.pop(evicted, None)
                self._replay_counts.pop(evicted, None)
        self._send_frame_with_retry(uid, frame)

    def resend(self, uid: str) -> bool:
        """Re-enqueue the recorded in-flight frame for ``uid`` (same uuid:
        the server's reply keying makes the retry idempotent).  False if
        the frame is no longer recorded (evicted or already answered)."""
        with self._cond:
            frame = self._inflight.get(uid)
        if frame is None:
            logger.warning(
                "request %s cannot be retried: its frame was evicted from "
                "the in-flight record (raise _Conn.MAX_INFLIGHT[_BYTES] if "
                "this client legitimately keeps that many outstanding)",
                uid)
            return False
        if self._send_frame_with_retry(uid, frame):
            self._bump("resends")  # replay-carried sends count there
        return True

    def _send_frame_with_retry(self, uid: str, frame: bytes) -> bool:
        """Send ``frame``, reconnecting on a dead socket.  Returns False
        when a reconnect's inflight replay already carried the frame (so
        callers don't send — or count — a duplicate), True otherwise."""
        last: Optional[OSError] = None
        for attempt in range(1, self.retry.max_attempts + 1):
            if not self.alive:
                gen = self._generation
                self.reconnect()  # raises after its own bounded attempts
                with self._cond:
                    replayed = (self._generation != gen
                                and uid in self._inflight)
                if replayed:
                    return False  # _replay_inflight carried this frame
            try:
                with self._send_lock:
                    protocol.send_frame(self.sock, frame)
                return True
            except OSError as e:
                last = e
                self._bump("retries")
                if attempt < self.retry.max_attempts:
                    time.sleep(self.retry.delay(attempt))
        raise OSError(f"send failed after {self.retry.max_attempts} "
                      f"attempts: {last}") from last

    # -- receiving -------------------------------------------------------------

    def wait(self, uid: str, timeout: Optional[float]
             ) -> Optional[Tuple[Optional[np.ndarray], Optional[str],
                                 Optional[Dict]]]:
        """The ``(array, error, reply header)`` triple for ``uid``, or
        None on timeout."""
        with self._cond:
            ok = self._cond.wait_for(lambda: uid in self._results,
                                     timeout=timeout)
            if not ok:
                return None
            # the resend record stays until the caller accepts the reply
            # (query retries "queue full" replies by resending it)
            return self._results.pop(uid)

    def ping(self, timeout: float = 1.0) -> Optional[Dict]:
        """One health-probe round trip: the pong header (``state``,
        ``queue_depth``) or None when no pong arrives in ``timeout``.
        Deliberately NO retry and NO reconnect — a failed probe IS the
        signal the health checker exists to observe."""
        uid = f"ping-{uuid_mod.uuid4().hex[:12]}"
        try:
            with self._send_lock:
                protocol.send_frame(self.sock, protocol.encode_ping(uid))
        except (OSError, AttributeError):  # dead or never-connected sock
            return None
        res = self.wait(uid, timeout)
        if res is None:
            return None
        _, err, header = res
        if err is not None and not (header or {}).get("pong"):
            return None  # an error reply that isn't even a pong
        return header

    def peek(self, uid: str):
        with self._cond:
            return self._results.pop(uid, None)

    def metrics_snapshot(self, timeout: float = 2.0) -> Optional[Dict]:
        """One telemetry-scrape round trip: the server's registry
        ``snapshot()`` dict, or None when no reply arrives in
        ``timeout``.  Like ``ping``, deliberately no retry and no
        reconnect — the caller (a cluster-scope scrape) simply skips an
        unreachable replica."""
        uid = f"metrics-{uuid_mod.uuid4().hex[:12]}"
        try:
            with self._send_lock:
                protocol.send_frame(self.sock,
                                    protocol.encode_metrics_request(uid))
        except (OSError, AttributeError):
            return None
        res = self.wait(uid, timeout)
        if res is None:
            return None
        _, _err, header = res
        return (header or {}).get("metrics")

    def forget(self, uid: str
               ) -> Optional[Tuple[str, float, Optional[str]]]:
        """Drop the resend record (request answered, or caller gave up).
        Returns the (trace id, enqueue time, client span id) triple for
        the request, so the caller can close out its trace."""
        with self._cond:
            frame = self._inflight.pop(uid, None)
            if frame is not None:
                self._inflight_bytes -= len(frame)
            self._replay_counts.pop(uid, None)
            return self._traces.pop(uid, None)


class InputQueue:
    """``enqueue(name, t=ndarray)`` → uuid (reference API shape)."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8980,
                 frontend_url: Optional[str] = None,
                 retry: Optional[RetryPolicy] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None,
                 labels: Optional[Dict[str, str]] = None):
        if frontend_url:  # "host:port" parity with the reference's url conf
            host, port_s = frontend_url.rsplit(":", 1)
            port = int(port_s)
        self._conn = _Conn(host, port, retry=retry, metrics=metrics,
                           labels=labels)

    def enqueue(self, name: str, deadline: Optional[float] = None,
                trace_id: Optional[str] = None, uid: Optional[str] = None,
                model: Optional[str] = None,
                version: Optional[str] = None,
                klass: Optional[str] = None,
                **kwargs: np.ndarray) -> str:
        """Send one named tensor; returns the uuid to ``query`` on.

        ``uid``: explicit request uuid (auto-generated when omitted).
        The router's failover passes the FAILED attempt's uuid when it
        re-enqueues on a sibling replica, keeping the retry idempotent
        end to end exactly like a same-connection resend.

        ``deadline``: optional per-request budget in SECONDS, carried to
        the server as ``deadline_ms`` in the frame header.  The server
        sheds the request (error reply "deadline exceeded") instead of
        running inference once the budget is spent.  Retries restamp the
        full budget — the server re-anchors it at arrival, so clocks never
        need to agree across hosts.

        ``trace_id``: the end-to-end trace id for this request
        (core/trace.py); auto-generated when omitted, pass one to join
        an existing trace (the HTTP frontend propagates the caller's
        ``X-Trace-Id`` this way).  Read it back with ``trace_id(uid)``.

        ``model``/``version``: route to a named model (and optionally a
        pinned loaded version) in a multi-model server
        (``ClusterServing(models=...)``, serving/model_registry.py);
        omitted = the server's default model's active version.  An
        unroutable pair gets a non-retryable error reply (``query``
        raises).

        ``klass``: request class (``"interactive"`` | ``"batch"``) for
        the server's per-class admission gate — under pressure batch
        traffic is shed first so interactive traffic holds its SLO.
        Omitted = unclassified (the frame is byte-identical to a
        pre-klass client's)."""
        if len(kwargs) != 1:
            raise ValueError("exactly one named tensor per enqueue "
                             "(reference: t=ndarray)")
        (_, arr), = kwargs.items()
        uid = uid or f"{name}-{uuid_mod.uuid4()}"
        header = protocol.request_header(
            uid, trace=trace_id or trace_lib.new_trace_id(),
            # the client span id travels in the header so the server's
            # stage spans parent under THIS attempt in trace.tree()
            span=trace_lib.new_span_id() if trace_lib.enabled else None,
            model=model, version=version,
            deadline_ms=(max(1, int(deadline * 1000))
                         if deadline is not None else None),
            klass=klass)
        self._conn.send_request(header, np.asarray(arr))
        return uid

    def trace_id(self, uid: str) -> Optional[str]:
        """The trace id riding request ``uid``'s frame header (None once
        the request has been answered and forgotten)."""
        return self._conn.trace_id(uid)

    def close(self) -> None:
        self._conn.close()

    @property
    def conn(self) -> _Conn:
        return self._conn


class OutputQueue:
    """``query(uuid)`` / ``dequeue()`` (reference API shape)."""

    #: how often a blocked query re-checks connection liveness
    _POLL = 0.25

    def __init__(self, input_queue: Optional[InputQueue] = None,
                 host: str = "127.0.0.1", port: int = 8980,
                 retry: Optional[RetryPolicy] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        if input_queue is not None:
            self._conn = input_queue.conn
        else:
            self._conn = _Conn(host, port, retry=retry, metrics=metrics)

    def query(self, uid: str, timeout: Optional[float] = 30.0
              ) -> Optional[np.ndarray]:
        """The reply for ``uid``; None on timeout.

        Survives a server restart mid-wait: a dead connection is
        re-established (backoff + jitter) and the recorded request frame is
        re-enqueued under the SAME uuid.  Retryable error replies
        ("queue full", "server shutting down") are retried the same way,
        bounded by the connection's RetryPolicy; other errors raise."""
        conn = self._conn
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        error_retries = 0
        while True:
            left = (None if deadline is None
                    else deadline - time.monotonic())
            if left is not None and left <= 0:
                conn.forget(uid)
                conn._metrics.inc("client.timeouts")
                return None
            # wait in slices so a dead reader is noticed promptly even
            # when the reply will never come
            slice_t = self._POLL if left is None else min(self._POLL, left)
            res = conn.wait(uid, slice_t)
            if res is None:
                if not conn.alive:
                    try:
                        if not conn.resend(uid):
                            return None  # nothing recorded to retry
                    except OSError:
                        conn.forget(uid)
                        raise
                continue
            arr, err, header = res
            stages = (header or {}).get("stages")
            if err is None:
                info = conn.forget(uid)
                if info is not None:
                    # close out the end-to-end trace: client-observed
                    # total + the server's per-stage breakdown from the
                    # reply header (stamped by the inference worker that
                    # ran the batch: queue wait, batch assembly,
                    # inference, realized batch size), one span, one
                    # correlatable id.  The span id is the one that rode
                    # the request header, so the server-side stage spans
                    # already hang beneath this record in trace.tree().
                    tid, t0, sid = info
                    total = (time.monotonic() - t0) * 1000.0
                    all_stages = {"client.total_ms": round(total, 3)}
                    if stages:
                        all_stages.update(stages)
                    conn._m_request.observe(total)
                    trace_lib.record(tid, "client", all_stages,
                                     span_id=sid, dur_ms=total)
                    trace_lib.maybe_log_slow(tid, uid, total, all_stages)
                return arr
            if (any(m in err for m in RETRYABLE_ERRORS)
                    and error_retries + 1 < conn.retry.max_attempts):
                error_retries += 1
                conn._bump("retries")
                # never sleep past the caller's deadline: cap the backoff
                # at the remaining budget (the loop top then times out)
                delay = conn.retry.delay(error_retries)
                if deadline is not None:
                    delay = min(delay,
                                max(0.0, deadline - time.monotonic()))
                time.sleep(delay)
                try:
                    if conn.resend(uid):
                        continue
                except OSError:
                    conn.forget(uid)
                    raise
            conn.forget(uid)
            raise RuntimeError(f"serving error for {uid}: {err}")
