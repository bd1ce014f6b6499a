# Port of analytics_zoo_tpu/core/flightrec.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Flight recorder: capture process state at the moment a fault fires.

The resilience layers made faults survivable; nothing made
them *explainable* — by the time a supervisor restarted a gang or a
router failed over a dead replica, the dying process's recent spans,
metric movement and warnings were gone.  This module keeps a bounded
in-memory picture of "what was this process doing just now" and dumps
it to ``flightrec_<pid>.json`` when something goes wrong:

- **spans**: the trace ring (core/trace.py) at dump time — the recent
  request/step causality, including the in-flight ids a dying serving
  replica was holding;
- **metric deltas**: the registry snapshot plus per-counter deltas
  since the previous dump (or since the recorder was configured), so a
  dump shows what MOVED during the failure window, not just totals;
- **log lines**: a bounded ring of recent WARNING+ log records from the
  framework logger.

Dump triggers (all best-effort — a failing dump must never mask the
original fault):

- ``ClusterServing.kill()`` — the ``serving.replica_down`` fault path
  and any SIGKILL-equivalent death, with the replica's in-flight trace
  ids in the dump's context;
- ``Estimator.fit`` — an unhandled step exception or a terminal
  ``NonFiniteLossError`` (dumped into ``model_dir``);
- a circuit breaker opening in ``ReplicaSet`` (the router-side view of
  a replica failure);
- SIGTERM, when :func:`install_signal_dump` is active (the zoo-launch
  supervisor's gang-termination path) — the handler chains to whatever
  was installed before it;
- on demand: ``ClusterServing.dump_flight_record()`` /
  :func:`dump`.

A dump needs a directory: ``configure(dir)``, ``ZooConfig.flightrec_dir``
(applied by ``init_orca_context``), or the ``ZOO_FLIGHTREC_DIR`` env var
the supervisor sets.  With no directory configured every trigger is a
no-op — production-safe by default.
"""

from __future__ import annotations

import collections
import json
import logging
import os
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional

logger = logging.getLogger("analytics_zoo_tpu")

#: How many recent WARNING+ log lines the recorder keeps.
MAX_LOG_LINES = 128


class _LogRing(logging.Handler):
    """Bounded ring of formatted WARNING+ lines from the framework
    logger — the "what was it complaining about" third of a dump."""

    def __init__(self, maxlen: int):
        super().__init__(level=logging.WARNING)
        self.ring: "collections.deque[str]" = collections.deque(
            maxlen=maxlen)

    def emit(self, record: logging.LogRecord) -> None:
        try:
            self.ring.append(
                f"{record.levelname} {record.getMessage()}")
        except Exception:  # noqa: BLE001 — never break logging
            pass


class FlightRecorder:
    """Per-process flight recorder.  Use the module-level singleton
    (:func:`get_recorder`); components register context providers that
    contribute a dict to every dump (a serving replica reports its
    address, lifecycle state and in-flight trace ids)."""

    def __init__(self, max_log_lines: int = MAX_LOG_LINES):
        self._lock = threading.Lock()
        self._dir: Optional[str] = None
        self._providers: List[Callable[[], Dict[str, Any]]] = []
        self._baseline: Dict[str, Any] = {}
        self._log = _LogRing(max_log_lines)
        logger.addHandler(self._log)
        self._prev_sigterm = None
        self._signal_installed = False

    # -- configuration --------------------------------------------------------

    def configure(self, dump_dir: Optional[str]) -> None:
        """Set (or clear) the dump directory and rebase the metric-delta
        baseline at "now"."""
        with self._lock:
            self._dir = dump_dir
            self._baseline = self._counter_snapshot()

    @property
    def dump_dir(self) -> Optional[str]:
        d = self._dir
        if d is not None:
            return d
        return os.environ.get("ZOO_FLIGHTREC_DIR") or None

    def add_context(self, fn: Callable[[], Dict[str, Any]]) -> None:
        with self._lock:
            if fn not in self._providers:
                self._providers.append(fn)

    def remove_context(self, fn: Callable[[], Dict[str, Any]]) -> None:
        with self._lock:
            try:
                self._providers.remove(fn)
            except ValueError:
                pass

    # -- dumping --------------------------------------------------------------

    @staticmethod
    def _counter_snapshot() -> Dict[str, Any]:
        from . import metrics as metrics_lib
        snap = metrics_lib.get_registry().snapshot()
        return {k: v for k, v in snap.items()
                if not isinstance(v, dict)}

    def dump(self, reason: str, dump_dir: Optional[str] = None,
             extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
        """Write ``flightrec_<pid>.json`` (previous dump rotated to
        ``.1``) and return its path — None when no directory is
        configured.  Never raises: the recorder must not turn a fault
        into a different fault."""
        try:
            return self._dump(reason, dump_dir, extra)
        except Exception:  # noqa: BLE001 — diagnostics stay best-effort
            logger.debug("flight-recorder dump failed", exc_info=True)
            return None

    def _dump(self, reason: str, dump_dir: Optional[str],
              extra: Optional[Dict[str, Any]]) -> Optional[str]:
        d = dump_dir or self.dump_dir
        if not d:
            return None
        from . import metrics as metrics_lib
        from . import trace as trace_lib
        snap = metrics_lib.get_registry().snapshot()
        with self._lock:
            base = dict(self._baseline)
            providers = list(self._providers)
            log_tail = list(self._log.ring)
        delta = {}
        for k, v in snap.items():
            if isinstance(v, dict):
                continue
            if v - base.get(k, 0) != 0:
                delta[k] = v - base.get(k, 0)
        context: Dict[str, Any] = {}
        for fn in providers:
            try:
                context.update(fn() or {})
            except Exception:  # noqa: BLE001 — a dying provider is fine
                pass
        context.update(extra or {})  # trigger-site context wins
        payload = {
            "reason": reason,
            "wall": time.time(),
            "pid": os.getpid(),
            "spans": [r.to_dict() for r in trace_lib.recent()],
            "log": log_tail,
            "metrics": snap,
            "metrics_delta": delta,
            "context": context,
        }
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"flightrec_{os.getpid()}.json")
        if os.path.exists(path):
            os.replace(path, path + ".1")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f)
        os.replace(tmp, path)
        with self._lock:
            self._baseline = {k: v for k, v in snap.items()
                              if not isinstance(v, dict)}
        logger.warning("flight record dumped to %s (reason: %s)", path,
                       reason)
        return path

    # -- signal hook ----------------------------------------------------------

    def install_signal_dump(self) -> None:
        """Dump on SIGTERM (the supervisor's gang-termination path),
        then chain to the previously installed handler so
        PreemptionGuard-style handlers keep working.  Main-thread only;
        silently skipped elsewhere."""
        if self._signal_installed:
            return
        try:
            prev = signal.getsignal(signal.SIGTERM)

            def _handler(signum, frame):
                self.dump("sigterm")
                if callable(prev):
                    prev(signum, frame)
                elif prev == signal.SIG_DFL:
                    signal.signal(signal.SIGTERM, signal.SIG_DFL)
                    os.kill(os.getpid(), signal.SIGTERM)

            signal.signal(signal.SIGTERM, _handler)
            self._prev_sigterm = prev
            self._signal_installed = True
        except (ValueError, OSError):  # not the main thread
            logger.debug("flightrec signal hook skipped (not main thread)")


_RECORDER: Optional[FlightRecorder] = None
_RECORDER_LOCK = threading.Lock()


def get_recorder() -> FlightRecorder:
    """The process-global flight recorder (created on first use)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder()
        return _RECORDER


def configure(dump_dir: Optional[str]) -> None:
    get_recorder().configure(dump_dir)


def dump(reason: str, dump_dir: Optional[str] = None,
         extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Module-level convenience: dump the process flight record."""
    return get_recorder().dump(reason, dump_dir=dump_dir, extra=extra)


def install_signal_dump() -> None:
    get_recorder().install_signal_dump()
