# Port of analytics_zoo_tpu/serving/http_frontend.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""HTTP/JSON frontend for ClusterServing.

Reference (SURVEY.md §2.8): the akka-http gateway
(zoo/.../serving/http/FrontEndApp) accepted JSON/image POSTs, encoded them
into the Redis queue, awaited the result key, and responded.

TPU-native: a stdlib ThreadingHTTPServer that rides the SAME data path as
binary clients — each request goes through a :class:`ReplicaSet`
(serving/router.py) over the TCP protocol, awaited by uuid, and returned
as JSON.  The frontend therefore shares the native queue, the
micro-batcher, and the AOT executables with every other client instead
of owning a second inference path.

High availability: the frontend is no longer hard-wired to one
backend.  Pass ``backends=["host:port", ...]`` (or a prebuilt
``router=ReplicaSet(...)``) and requests are least-pending routed with
retry-on-other-replica failover, per-replica circuit breakers, active
health checking and optional hedged reads — a replica dying hard or
draining for a rolling restart costs latency, not errors.  The
single-backend constructor shape (``serving_host``/``serving_port``) is
unchanged and simply builds a one-replica set.

Endpoints (TF-Serving-flavored JSON):
  POST /predict   {"instances": <nested list>, "dtype": "float32"?,
                   "deadline_ms": <int>?, "model": <name>?,
                   "version": <version>?}
                  → {"predictions": <nested list>}
                  ``model``/``version`` route within a multi-model
                  backend (serving/model_registry.py): an unroutable
                  pair answers 404.
  GET  /health    → {"status": "ok"}  (the frontend process itself)
  GET  /healthz   → {"status": "ok"|"degraded"|"down",
                     "replicas": {"<host:port>": {healthy, state,
                     breaker, pending, ...}}} — the routed view; HTTP
                     503 when NO replica is available, 200 otherwise,
                     so a load balancer can pull a frontend whose whole
                     backend set is gone
  GET  /stats     → namespaced counters: ``frontend.*`` (this gateway),
                    ``client.*`` (the resilient backend connection),
                    ``server.*`` (the serving pipeline's counters, when
                    the backend is co-located in this process) and
                    ``frontend.request_ms.*`` route-latency summaries,
                    PLUS a flat back-compat view (the pre-registry key
                    names: ``requests``, ``timeouts``, ``reconnects``,
                    ...).  The flat view exists because the old code
                    merged ``conn.stats`` into its own dict with
                    ``dict.update`` — same-named keys silently clobbered
                    each other; the namespaced keys are the fix, the
                    flat keys keep old dashboards alive.
  GET  /metrics   → Prometheus text exposition (format 0.0.4) of the
                    whole process registry — serving ``server.*``,
                    ``client.*`` and ``frontend.*`` series in one scrape.

Observability: every route's latency lands in the
``frontend.request_ms{route=...}`` histogram; ``/predict`` accepts an
``X-Trace-Id`` header (one is generated when absent), propagates it down
the serving frame so the backend's per-stage breakdown correlates, and
echoes it back on the response.

Failure semantics: a per-request deadline (``deadline_ms`` in the JSON
body, or the ``X-Deadline-Ms`` header) is propagated to the serving
backend in the frame header; the backend sheds the request once the
budget is spent and the frontend answers 504.  Backend restarts are
ridden out by the resilient client underneath (reconnect with backoff +
idempotent re-enqueue) — the counters for that surface in ``/stats``.
"""

from __future__ import annotations

import json
import logging
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from .router import ReplicaSet

logger = logging.getLogger("analytics_zoo_tpu")

#: The frontend's own counters (the old ad-hoc ``_stats`` dict keys, now
#: ``frontend.<key>`` series in the process registry).
_FRONTEND_COUNTERS = ("requests", "errors", "timeouts",
                      "deadline_exceeded", "rejected")


class HTTPFrontend:
    """HTTP gateway in front of a running ClusterServing's TCP port."""

    def __init__(self, serving_host: str = "127.0.0.1",
                 serving_port: int = 8980, host: str = "127.0.0.1",
                 port: int = 0, query_timeout: float = 30.0,
                 backends: Optional[list] = None,
                 router: Optional[ReplicaSet] = None,
                 hedge_ms: Optional[float] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        """``backends``: list of ``"host:port"`` (or ``(host, port)``)
        serving replicas — the HA deployment shape.  ``router``: a fully
        configured ReplicaSet to use instead (the frontend owns and
        closes it either way).  With neither, the single
        ``serving_host:serving_port`` backend is wrapped in a
        one-replica set, preserving the original behavior."""
        self._metrics = metrics or metrics_lib.get_registry()
        if router is not None:
            self._router = router
        else:
            self._router = ReplicaSet(
                backends or [(serving_host, serving_port)],
                query_timeout=query_timeout, hedge_ms=hedge_ms,
                metrics=self._metrics)
        self.query_timeout = query_timeout
        # handle-per-counter: the old dict + lock, now shared with every
        # other telemetry consumer (snapshot / Prometheus / JSONL)
        self._counters = {k: self._metrics.counter("frontend." + k)
                          for k in _FRONTEND_COUNTERS}
        # per-route latency histogram handles, cached so the per-request
        # cost is a dict hit, not a registry name lookup (routes are a
        # small closed set: the four GET paths, /predict, "other")
        self._route_hists: dict = {}
        frontend = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # route to our logger
                logger.debug("http: " + fmt, *args)

            def _observe_once(self) -> None:
                # route latency lands BEFORE the response bytes (the
                # same counters-before-reply rule the serving server
                # follows): a client that reacts to the reply with an
                # immediate /metrics scrape must see this request in
                # the histogram.  Idempotent — the handler's finally
                # re-calls it to catch replies that failed mid-send.
                if not getattr(self, "_routed", True):
                    self._routed = True
                    frontend._observe_route(
                        self._route,
                        (time.monotonic() - self._t0) * 1000.0)

            def _json(self, code: int, payload,
                      trace_id: Optional[str] = None) -> None:
                body = json.dumps(payload).encode()
                self._observe_once()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                if trace_id:
                    self.send_header("X-Trace-Id", trace_id)
                self.end_headers()
                self.wfile.write(body)

            def _text(self, code: int, body: str, content_type: str
                      ) -> None:
                raw = body.encode()
                self._observe_once()
                self.send_response(code)
                self.send_header("Content-Type", content_type)
                self.send_header("Content-Length", str(len(raw)))
                self.end_headers()
                self.wfile.write(raw)

            def do_GET(self):
                self._t0 = time.monotonic()
                path, _, query = self.path.partition("?")
                self._route = path if path in (
                    "/", "/health", "/healthz", "/stats",
                    "/metrics") else "other"
                self._routed = False
                try:
                    if path in ("/", "/health"):
                        self._json(200, {"status": "ok"})
                    elif path == "/healthz":
                        # own + per-replica health; 503 only when NO
                        # replica is routable, so load balancers pull a
                        # frontend whose whole backend set is down
                        hz = frontend.healthz()
                        self._json(200 if hz["status"] != "down" else 503,
                                   hz)
                    elif path == "/stats":
                        self._json(200, frontend.stats())
                    elif path == "/metrics":
                        # Prometheus scrape.  Default scope: the whole
                        # LOCAL process registry (serving + client +
                        # frontend + training when co-located).
                        # ?scope=cluster scrapes every routable
                        # replica's registry over the TCP metrics frame
                        # and serves the MERGED view with replica=
                        # labels dropped — one scrape for the whole
                        # replica set, whichever processes it spans.
                        from urllib.parse import parse_qs
                        scope = parse_qs(query).get("scope", [""])[-1]
                        if scope == "cluster":
                            text = frontend.cluster_prometheus()
                        else:
                            text = frontend._metrics.prometheus()
                        self._text(200, text,
                                   "text/plain; version=0.0.4; "
                                   "charset=utf-8")
                    else:
                        self._json(404,
                                   {"error": f"no route {self.path}"})
                finally:
                    self._observe_once()

            def do_POST(self):
                self._t0 = time.monotonic()
                self._route = ("/predict" if self.path == "/predict"
                               else "other")  # keep /predict latency pure
                self._routed = False
                try:
                    self._do_predict()
                finally:
                    self._observe_once()

            def _do_predict(self):
                if self.path != "/predict":
                    self._json(404, {"error": f"no route {self.path}"})
                    return
                frontend._bump("requests")  # every attempt, not just 200s
                # join the caller's trace or start one: the id rides the
                # serving frame header end-to-end and comes back on the
                # response, so a slow request is correlatable across the
                # HTTP log, the serving server and the client breakdown
                tid = (self.headers.get("X-Trace-Id")
                       or trace_lib.new_trace_id())
                try:
                    n = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(n) or b"{}")
                    arr = np.asarray(req["instances"],
                                     dtype=req.get("dtype", "float32"))
                    deadline_ms = req.get("deadline_ms",
                                          self.headers.get("X-Deadline-Ms"))
                    deadline = (float(deadline_ms) / 1000.0
                                if deadline_ms is not None else None)
                    # multi-model routing (TF-Serving flavor): name the
                    # model (and optionally pin a loaded version) in the
                    # request body; absent = the backend's default model
                    model = req.get("model")
                    version = req.get("version")
                    # per-class admission: "interactive" | "batch" —
                    # under pressure the backend sheds batch first
                    klass = req.get("klass")
                except (KeyError, ValueError, TypeError) as e:
                    frontend._bump("errors")
                    self._json(400, {"error": f"bad request: {e}"},
                               trace_id=tid)
                    return
                try:
                    out = frontend.predict(arr, deadline=deadline,
                                           trace_id=tid, model=model,
                                           version=version, klass=klass)
                except RuntimeError as e:  # serving-side error reply
                    if ("unknown model" in str(e)
                            or "unknown version" in str(e)
                            or "no model specified" in str(e)):
                        frontend._bump("errors")
                        self._json(404, {"error": str(e)}, trace_id=tid)
                        return
                    if "deadline exceeded" in str(e):
                        frontend._bump("deadline_exceeded")
                        self._json(504, {"error": str(e)}, trace_id=tid)
                        return
                    if "queue full" in str(e):
                        frontend._bump("rejected")
                        self._json(503, {"error": str(e)}, trace_id=tid)
                        return
                    frontend._bump("errors")
                    self._json(500, {"error": str(e)}, trace_id=tid)
                    return
                except OSError as e:  # backend unreachable even after retry
                    frontend._bump("errors")
                    self._json(503, {"error": f"serving unreachable: {e}"},
                               trace_id=tid)
                    return
                if out is None:
                    frontend._bump("timeouts")
                    self._json(504, {"error": "serving timed out"},
                               trace_id=tid)
                    return
                self._json(200, {"predictions": out.tolist()},
                           trace_id=tid)

        self._httpd = ThreadingHTTPServer((host, port), Handler)
        self.host, self.port = self._httpd.server_address[:2]
        self._thread: Optional[threading.Thread] = None

    def _bump(self, key: str) -> None:
        self._counters[key].inc()

    def _observe_route(self, route: str, ms: float) -> None:
        h = self._route_hists.get(route)
        if h is None:
            h = self._metrics.histogram("frontend.request_ms", route=route)
            self._route_hists[route] = h
        h.observe(ms)

    def healthz(self) -> dict:
        """The ``/healthz`` payload: the router's per-replica view plus
        this gateway's own liveness (trivially ok if we are answering)."""
        hz = self._router.healthz()
        hz["frontend"] = "ok"
        return hz

    def cluster_metrics(self) -> dict:
        """The merged cluster snapshot (``ReplicaSet.cluster_metrics``):
        every routable replica's registry folded into one, ``replica=``
        labels dropped."""
        return self._router.cluster_metrics()

    def cluster_prometheus(self) -> str:
        """``GET /metrics?scope=cluster``: the merged cluster snapshot
        rendered as Prometheus text exposition."""
        merged = self.cluster_metrics()
        return metrics_lib.MetricsRegistry.from_snapshot(
            merged).prometheus()

    def stats(self) -> dict:
        """The ``/stats`` payload: namespaced ``frontend.*`` /
        ``client.*`` counters plus the flat back-compat view (old key
        names, no prefix).  Namespacing fixes the key-collision bug
        where ``dict.update(conn.stats)`` could silently clobber
        same-named frontend keys.  With multiple replicas, per-replica
        ``client.<key>{replica=...}`` entries ride along and the
        unlabeled keys are the SUM across replicas (what the old
        single-backend dashboards summed implicitly)."""
        out: dict = {}
        for key, c in self._counters.items():
            out[f"frontend.{key}"] = c.value
        conn_stats = self._conn_stats_by_replica()
        totals: dict = {}
        for name, st in conn_stats.items():
            for key, v in st.items():
                totals[key] = totals.get(key, 0) + v
                if len(conn_stats) > 1:
                    out[f"client.{key}{{replica={name}}}"] = v
        for key, v in totals.items():
            out[f"client.{key}"] = v
        # registry-only client series (e.g. client.timeouts, which has
        # no conn.stats mirror) complete the namespaced view
        for key, v in self._metrics.flat(prefix="client.").items():
            out.setdefault(f"client.{key}", v)
        # the router's health/breaker view: one poll answers "which
        # replica is taking the traffic and which is ejected?"
        hz = self._router.healthz()
        out["router.status"] = hz["status"]
        for name, rep in hz["replicas"].items():
            if len(hz["replicas"]) > 1:
                out[f"router.replica{{replica={name}}}"] = rep
        # co-located serving pipeline counters (requests / replies /
        # rejected / shed / drained + the queue-depth gauge): when the
        # backend shares this process registry, one /stats poll answers
        # "is the pipeline shedding or backpressuring?" without a
        # second endpoint; remote backends simply contribute no
        # server.* series here
        for key, v in self._metrics.flat(prefix="server.").items():
            out.setdefault(f"server.{key}", v)
        snap = self._metrics.snapshot()
        for series, val in snap.items():
            if series.startswith("frontend.request_ms"):
                out[series] = val
        # flat view (back-compat): the pre-registry response shape —
        # frontend keys first, then the resilient client's; the sets are
        # disjoint today and the namespaced keys above are authoritative
        for key, c in self._counters.items():
            out[key] = c.value
        out.update(totals)
        return out

    def _conn_stats_by_replica(self) -> dict:
        from .client import CONN_STATS_KEYS
        stats = {}
        for r in self._router.replicas:
            stats[r.name] = (dict(r._conn.stats) if r._conn is not None
                             else dict.fromkeys(CONN_STATS_KEYS, 0))
        return stats

    def predict(self, arr: np.ndarray,
                deadline: Optional[float] = None,
                trace_id: Optional[str] = None,
                model: Optional[str] = None,
                version: Optional[str] = None,
                klass: Optional[str] = None) -> Optional[np.ndarray]:
        """One request through the replica set.  Least-pending routing,
        retry-on-other-replica failover, circuit breaking, reconnect
        with backoff and idempotent re-enqueue all live underneath
        (serving/router.py + serving/client.py) — a backend restart or
        replica loss surfaces here only as a slightly slower reply.
        ``deadline`` (seconds) rides to the server so an expired request
        is shed instead of served; ``trace_id`` joins the request to an
        existing end-to-end trace (core/trace.py), and the trace names
        the replica that served it."""
        # the router waits a grace window past the deadline: the shed
        # happens when the batcher reaches the request, and its explicit
        # "deadline exceeded" reply beats an anonymous client-side
        # timeout as the 504 reason
        return self._router.predict(arr, deadline=deadline,
                                    trace_id=trace_id, model=model,
                                    version=version, klass=klass)

    # -- lifecycle ------------------------------------------------------------

    def start(self) -> "HTTPFrontend":
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True)
        self._thread.start()
        logger.info("HTTPFrontend listening on %s:%d", self.host, self.port)
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        # the replica set: health checker + every backend connection.
        # Bounded even with a hedged request in flight — predict()
        # observes the closed flag on its next poll slice.
        self._router.close()

    close = stop  # alias: the satellite tests close() a frontend

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
