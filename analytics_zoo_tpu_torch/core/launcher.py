# Port of analytics_zoo_tpu/core/launcher.py: the gang supervisor and
# zoo-launch over torch.distributed (the workers' contract is
# core/context.py's), and the serving half (the child command is this
# package's server module).
"""``zoo-launch``: the multi-process launcher and gang supervisor, and the
serving replicas' launcher.

**Gang training** (:func:`launch`, ``main``): spawn N local processes, each
one rank of a ``torch.distributed`` job that ``init_orca_context(
"multihost")`` joins from the environment (``ZOO_COORDINATOR``,
``ZOO_NUM_PROCESSES``, ``ZOO_PROCESS_ID``); ``--process-id`` with
``--coordinator`` runs one process of an N-process job on this machine.
The workers' devices follow ``--platform`` and ``--devices-per-proc``
(``_child_env``): ``cpu`` hides the cards, ``--devices-per-proc k`` gives
worker i cards ``i*k .. i*k+k-1``, and without it every worker sees every
card (several ranks on one card: gloo over CUDA tensors).

``launch()`` is a *supervisor*, not a waiter: it polls the whole gang, so
the first worker death is seen within ``poll_interval`` seconds, stops the
survivors (SIGTERM, then SIGKILL after ``grace``: the window
``PreemptionGuard`` needs to land a checkpoint) and, within a restart
budget with exponential backoff, relaunches the gang, whose workers
auto-resume from their latest checkpoint.  A gang restarts whole: a
process group cannot take one rank back.  Hung workers are told from slow
ones by heartbeat files (``ZOO_HEARTBEAT_FILE``, beaten by the training
loop through ``core.context.heartbeat``); a worker silent for
``heartbeat_timeout`` is treated as a crash.  The same rank failing first
``crash_loop_threshold`` times aborts with ``EXIT_CRASH_LOOP``.  With
heartbeats on, a status line of the gang is logged every
``status_interval`` seconds and, with ``metrics_dir``, each worker's
payloads go to ``metrics_w<rank>.jsonl`` (size-rotated), the workers'
registry snapshots fold into ``gang_metrics.jsonl`` (and ``GET /metrics``
on ``--metrics-port``), and ``ZOO_FLIGHTREC_DIR`` collects their flight
records.  The supervisor adds ``ZOO_RESTART_COUNT``,
``ZOO_HEARTBEAT_FILE`` and ``ZOO_HEARTBEAT_INTERVAL`` to the workers'
environment.

**Serving replicas**: :func:`launch_serving_replica` spawns one ``python
-m analytics_zoo_tpu_torch.serving.server`` child on a free port (the
``ServingController``'s subprocess scale-up), :func:`wait_serving_ready`
polls until it accepts connections, :func:`_terminate_gang` stops
children.

Usage:
  python -m analytics_zoo_tpu_torch.core.launcher --nprocs 2 train.py
  python -m analytics_zoo_tpu_torch.core.launcher --nprocs 2 --platform cpu train.py
  python -m analytics_zoo_tpu_torch.core.launcher --nprocs 4 --max-restarts 3 --heartbeat-timeout 60 train.py
"""

from __future__ import annotations

import json
import logging
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

logger = logging.getLogger("analytics_zoo_tpu_torch")

SERVER_MODULE = "analytics_zoo_tpu_torch.serving.server"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _terminate_gang(procs: List[subprocess.Popen], grace: float) -> None:
    """SIGTERM every live child, give them ``grace`` seconds to exit, then
    SIGKILL stragglers and reap."""
    for p in procs:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
    deadline = time.monotonic() + grace
    for p in procs:
        if p.poll() is None:
            try:
                p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    for p in procs:
        if p.poll() is None:
            try:
                p.kill()
            except OSError:
                pass
            p.wait()


def launch_serving_replica(extra_args: List[str],
                           host: str = "127.0.0.1",
                           port: Optional[int] = None,
                           env: Optional[Dict[str, str]] = None,
                           ) -> Tuple[subprocess.Popen, int]:
    """Spawn ONE ``zoo-serving`` child of this package on this machine.
    ``extra_args`` is the model/config tail of the child's command line
    (``--model-dir ...`` etc.); host/port are prepended here so the
    caller controls the address.  Returns ``(proc, port)``; pair with
    :func:`wait_serving_ready` before routing traffic at it."""
    if port is None:
        port = _free_port()
    cmd = [sys.executable, "-m", SERVER_MODULE,
           "--host", host, "--port", str(port)] + list(extra_args)
    child_env = dict(os.environ)
    if env:
        child_env.update(env)
    proc = subprocess.Popen(cmd, env=child_env)
    logger.info("launched serving replica pid=%d on %s:%d", proc.pid,
                host, port)
    return proc, port


def wait_serving_ready(host: str, port: int,
                       proc: Optional[subprocess.Popen] = None,
                       timeout: float = 60.0,
                       interval: float = 0.1) -> bool:
    """Poll until the replica accepts TCP connections (the server loads,
    and so warms, its model before binding).  Returns False early when
    ``proc`` already exited."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if proc is not None and proc.poll() is not None:
            return False
        try:
            with socket.create_connection((host, port), timeout=1.0):
                return True
        except OSError:
            time.sleep(interval)
    return False


#: Exit code when the supervisor aborts on a diagnosed crash loop.
EXIT_CRASH_LOOP = 86

#: Size-based rotation threshold for the supervisor's jsonl files
#: (``metrics_w<rank>.jsonl`` → ``.jsonl.1``): a long-running gang must
#: not grow its telemetry files without bound.
METRICS_ROTATE_BYTES = 4 * 1024 * 1024


def _child_env(coordinator: str, nprocs: int, pid: int,
               devices_per_proc: Optional[int], platform: Optional[str],
               extra: Optional[Dict[str, str]] = None,
               local: Optional[Tuple[int, int]] = None) -> dict:
    """A worker's environment: the context's contract (``ZOO_COORDINATOR``,
    ``ZOO_NUM_PROCESSES``, ``ZOO_PROCESS_ID``), its place on this host
    (``ZOO_LOCAL_RANK``, ``ZOO_LOCAL_WORLD_SIZE`` from ``local``, the
    (local rank, local process count) pair; by default every process runs
    here) and its devices.  ``platform="cpu"`` hides every card
    (``CUDA_VISIBLE_DEVICES=""``: gloo over CPU tensors); otherwise, with
    ``devices_per_proc``, worker ``pid`` sees cards ``pid * k ... pid * k
    + k - 1`` of this host (``CUDA_VISIBLE_DEVICES``, and
    ``ZOO_DEVICES_PER_PROC`` tells the context the cards are its own), and
    without it every worker sees every card (``choose_backend`` in
    ``core/context.py`` gives local rank ``i`` card ``i``, or gloo over a
    shared card when the host has fewer cards than workers)."""
    local_rank, local_world = local or (pid, nprocs)
    env = dict(os.environ)
    env["ZOO_COORDINATOR"] = coordinator
    env["ZOO_NUM_PROCESSES"] = str(nprocs)
    env["ZOO_PROCESS_ID"] = str(pid)
    env["ZOO_LOCAL_RANK"] = str(local_rank)
    env["ZOO_LOCAL_WORLD_SIZE"] = str(local_world)
    env.pop("ZOO_DEVICES_PER_PROC", None)
    if platform == "cpu":
        env["CUDA_VISIBLE_DEVICES"] = ""
    elif devices_per_proc:
        first = pid * devices_per_proc
        env["CUDA_VISIBLE_DEVICES"] = ",".join(
            str(first + i) for i in range(devices_per_proc))
        env["ZOO_DEVICES_PER_PROC"] = str(devices_per_proc)
    if extra:
        env.update(extra)
    return env


def _read_heartbeat_payload(path: Optional[str]) -> dict:
    """The worker's last JSON status payload (context._Heartbeat), or {}
    for a missing/empty/legacy-touch heartbeat file.  Tolerant by
    design: the payload is best-effort telemetry, the mtime is the
    liveness contract."""
    if path is None:
        return {}
    try:
        with open(path) as f:
            text = f.read()
        return json.loads(text) if text.strip() else {}
    except (OSError, json.JSONDecodeError):
        return {}


def _fold_gang_snapshots(by_rank_attempt: Dict[Tuple[int, int], dict]
                         ) -> dict:
    """Fold per-(rank, attempt) registry snapshots into ONE gang-level
    snapshot via ``MetricsRegistry.merge``.

    The (rank, attempt) granularity is the restart-correctness seam:
    a restarted rank's registry starts back at zero, so

    - **counters/histograms** from EVERY attempt merge (sum /
      bucket-add) — each attempt counted disjoint events, so the fold
      is the rank's true lifetime total, and taking a max instead
      (the tempting "latest wins" shortcut) would silently lose every
      pre-restart event — the max-vs-sum confusion the tests pin down;
    - **gauge values** are point-in-time state: a dead attempt's queue
      depth is not load anymore, so gauges from non-latest attempts
      contribute only their high-water ``max`` (value zeroed before
      the merge)."""
    from .metrics import MetricsRegistry
    latest_attempt: Dict[int, int] = {}
    for (rank, attempt) in by_rank_attempt:
        latest_attempt[rank] = max(latest_attempt.get(rank, -1), attempt)
    snaps = []
    for (rank, attempt), snap in sorted(by_rank_attempt.items()):
        if attempt != latest_attempt[rank]:
            snap = {
                series: (dict(val, value=0.0)
                         if isinstance(val, dict) and "value" in val
                         and "count" not in val else val)
                for series, val in snap.items()}
        snaps.append(snap)
    return MetricsRegistry.merge(snaps)


def aggregate_worker_metrics(metrics_dir: str) -> dict:
    """Offline gang aggregation: fold the per-worker
    ``metrics_w<rank>.jsonl`` files (current + ``.1`` rotation) under
    ``metrics_dir`` into one gang-level snapshot.  Tolerant by design:
    empty files, torn trailing lines (a worker died mid-write) and
    ranks that never beat simply contribute nothing.  Only lines
    carrying a ``metrics`` registry snapshot participate; the LATEST
    such line per (rank, attempt) wins, and attempts fold per
    ``_fold_gang_snapshots`` (counters sum across restarts — no
    double-count, no lost history)."""
    import glob
    import re
    by_ra: Dict[Tuple[int, int], dict] = {}
    paths = []
    for path in glob.glob(os.path.join(metrics_dir,
                                       "metrics_w*.jsonl*")):
        m = re.search(r"metrics_w(\d+)\.jsonl(\.1)?$", path)
        if m:
            # rotated ``.1`` generation FIRST, current file second: for
            # the same (rank, attempt) the current file's newer snapshot
            # must win the latest-line-wins fold, and a plain sorted()
            # would process ".jsonl" before ".jsonl.1"
            paths.append((int(m.group(1)), 0 if m.group(2) else 1, path))
    for rank, _, path in sorted(paths):
        try:
            with open(path) as f:
                lines = f.readlines()
        except OSError:
            continue
        for line in lines:
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue  # torn write from a dying worker
            snap = rec.get("metrics")
            if not isinstance(snap, dict):
                continue
            by_ra[(rank, int(rec.get("attempt", 0)))] = snap
    return _fold_gang_snapshots(by_ra)


class _GangStatus:
    """Periodic gang-status aggregation: every ``interval`` seconds the
    supervisor reads each worker's heartbeat JSON payload, logs ONE
    line summarizing the whole gang (step/loss/samples-per-sec per
    rank) and, when ``metrics_dir`` is set, appends each worker's
    payload to ``metrics_w<rank>.jsonl`` there (size-rotated to
    ``.jsonl.1``) — the training-side trajectory file the
    observability docs describe.

    Workers launched with metrics aggregation embed their full
    registry snapshot in epoch-end heartbeat payloads
    (``ZOO_HEARTBEAT_METRICS``); this class folds the latest snapshot
    per (rank, attempt) into ONE gang-level snapshot
    (``gang_snapshot()``), appends it to ``gang_metrics.jsonl`` and —
    with ``--metrics-port`` — serves it as a Prometheus scrape."""

    def __init__(self, interval: Optional[float],
                 metrics_dir: Optional[str],
                 rotate_bytes: int = METRICS_ROTATE_BYTES):
        self.interval = interval
        self.metrics_dir = metrics_dir
        self.rotate_bytes = rotate_bytes
        self._last = time.monotonic()
        self._gang: Dict[Tuple[int, int], dict] = {}
        self._gang_lock = threading.Lock()
        if metrics_dir is not None:
            os.makedirs(metrics_dir, exist_ok=True)

    def gang_snapshot(self) -> dict:
        """The current gang-level merged snapshot (see
        ``_fold_gang_snapshots`` for the restart semantics)."""
        with self._gang_lock:
            by_ra = dict(self._gang)
        return _fold_gang_snapshots(by_ra)

    def gang_prometheus(self) -> str:
        """The gang snapshot as Prometheus text — what ``--metrics-port``
        serves."""
        from .metrics import MetricsRegistry
        return MetricsRegistry.from_snapshot(
            self.gang_snapshot()).prometheus()

    def maybe_emit(self, procs: List[subprocess.Popen],
                   hb_files: List[Optional[str]], attempt: int,
                   force: bool = False) -> None:
        """``force=True``: the gang just finished an attempt — emit the
        closing status (the workers' last forced epoch-end beats) even
        if the interval hasn't elapsed."""
        if self.interval is None or not any(hb_files):
            return
        now = time.monotonic()
        if not force and now - self._last < self.interval:
            return
        self._last = now
        from .metrics import append_jsonl_rotating
        parts = []
        saw_registry = False
        for rank, hb in enumerate(hb_files):
            payload = _read_heartbeat_payload(hb)
            alive = procs[rank].poll() is None
            bits = [f"w{rank}"]
            if not alive:
                bits.append("exited")
            for key in ("step", "loss", "samples_per_sec"):
                if key in payload:
                    v = payload[key]
                    bits.append(f"{key}={v:.4g}"
                                if isinstance(v, float) else f"{key}={v}")
            parts.append("[" + " ".join(bits) + "]")
            if isinstance(payload.get("metrics"), dict):
                saw_registry = True
                with self._gang_lock:
                    self._gang[(rank, attempt)] = payload["metrics"]
            if self.metrics_dir is not None and payload:
                rec = dict(payload, rank=rank, attempt=attempt)
                try:
                    append_jsonl_rotating(
                        os.path.join(self.metrics_dir,
                                     f"metrics_w{rank}.jsonl"),
                        json.dumps(rec), self.rotate_bytes)
                except OSError:
                    pass  # telemetry must never kill supervision
        if saw_registry and self.metrics_dir is not None:
            try:
                append_jsonl_rotating(
                    os.path.join(self.metrics_dir, "gang_metrics.jsonl"),
                    json.dumps({"wall": time.time(), "attempt": attempt,
                                "metrics": self.gang_snapshot()}),
                    self.rotate_bytes)
            except OSError:
                pass
        logger.info("gang status (attempt %d): %s", attempt,
                    " ".join(parts))


class _GangMetricsServer:
    """``--metrics-port``: a tiny HTTP endpoint on the SUPERVISOR
    serving the merged gang snapshot — ``GET /metrics`` (Prometheus
    text) and ``GET /metrics.json`` (the raw merged snapshot) — so one
    scrape covers the whole gang without reaching into any worker."""

    def __init__(self, port: int, status: _GangStatus):
        from http.server import BaseHTTPRequestHandler, HTTPServer
        gang = status

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):
                logger.debug("gang-metrics http: " + fmt, *args)

            def do_GET(self):
                try:
                    if self.path.startswith("/metrics.json"):
                        body = json.dumps(gang.gang_snapshot()).encode()
                        ctype = "application/json"
                    elif self.path.startswith("/metrics"):
                        body = gang.gang_prometheus().encode()
                        ctype = ("text/plain; version=0.0.4; "
                                 "charset=utf-8")
                    else:
                        self.send_response(404)
                        self.end_headers()
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass  # scraper went away mid-reply

        self._httpd = HTTPServer(("127.0.0.1", port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(target=self._httpd.serve_forever,
                                        daemon=True,
                                        name="zoo-gang-metrics")
        self._thread.start()

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()


def _supervise(procs: List[subprocess.Popen], hb_files: List[Optional[str]],
               heartbeat_timeout: Optional[float],
               timeout: Optional[float], poll_interval: float,
               status: Optional["_GangStatus"] = None,
               attempt: int = 0
               ) -> Tuple[str, Optional[int], Optional[int]]:
    """Poll the gang until a verdict: ("ok", None, 0), ("crash", rank, rc),
    ("hang", rank, None), or ("timeout", None, None)."""
    start = time.monotonic()
    while True:
        all_done = True
        for rank, p in enumerate(procs):
            rc = p.poll()
            if rc is None:
                all_done = False
                hb = hb_files[rank]
                if heartbeat_timeout is not None and hb is not None:
                    try:
                        stale = (time.time() - os.path.getmtime(hb)
                                 > heartbeat_timeout)
                    except OSError:
                        stale = True  # file vanished: no proof of life
                    if stale:
                        return "hang", rank, None
            elif rc != 0:
                return "crash", rank, rc
        if status is not None:
            status.maybe_emit(procs, hb_files, attempt, force=all_done)
        if all_done:
            return "ok", None, 0
        if timeout is not None and time.monotonic() - start > timeout:
            return "timeout", None, None
        time.sleep(poll_interval)


def launch(script: str, script_args: List[str], nprocs: int,
           devices_per_proc: Optional[int] = None,
           coordinator: Optional[str] = None,
           platform: Optional[str] = None,
           timeout: Optional[float] = None,
           max_restarts: int = 0,
           backoff: float = 0.5,
           backoff_factor: float = 2.0,
           max_backoff: float = 30.0,
           heartbeat_timeout: Optional[float] = None,
           heartbeat_interval: float = 1.0,
           heartbeat_dir: Optional[str] = None,
           grace: float = 5.0,
           poll_interval: float = 0.05,
           crash_loop_threshold: int = 3,
           metrics_dir: Optional[str] = None,
           status_interval: Optional[float] = 10.0,
           metrics_port: Optional[int] = None,
           metrics_rotate_bytes: int = METRICS_ROTATE_BYTES,
           on_event: Optional[Callable[[str, dict], None]] = None) -> int:
    """Run a gang of ``nprocs`` local processes under supervision.

    Returns 0 when (an attempt of) the gang finishes cleanly.  On the
    first worker crash (nonzero exit) or heartbeat loss the surviving
    workers are terminated and, while ``max_restarts`` budget remains, the
    whole gang is relaunched after an exponential backoff
    (``backoff * backoff_factor**attempt``, capped at ``max_backoff``) —
    workers resume from their checkpoints via ``auto_resume``.  When the
    budget is exhausted the failing worker's exit code is returned; a
    diagnosed crash loop (the same rank first-failing
    ``crash_loop_threshold`` times) aborts early with ``EXIT_CRASH_LOOP``.

    ``timeout`` bounds one attempt's wall clock; exceeding it kills the
    gang and raises ``subprocess.TimeoutExpired`` (the pre-supervisor
    contract).  ``on_event(kind, info)`` observes supervisor decisions
    ("crash"/"hang"/"restart"/"crash_loop"/"ok") — tests assert on it.

    ``status_interval``/``metrics_dir``: with heartbeats on, the
    supervisor reads each worker's heartbeat JSON payload (step, loss,
    samples/sec — written by ``core.heartbeat(**status)``) every
    ``status_interval`` seconds, logs one gang-status line, and — when
    ``metrics_dir`` is given — appends each worker's payload to
    ``<metrics_dir>/metrics_w<rank>.jsonl`` (size-rotated at
    ``metrics_rotate_bytes``; docs/observability.md).  With
    ``metrics_dir`` set, workers also embed full registry snapshots in
    their epoch-end heartbeats (``ZOO_HEARTBEAT_METRICS``) which the
    supervisor folds into one GANG-level snapshot —
    ``<metrics_dir>/gang_metrics.jsonl`` plus, with ``metrics_port``, a
    Prometheus ``GET /metrics`` endpoint on the supervisor — and
    exports ``ZOO_FLIGHTREC_DIR=<metrics_dir>`` so workers dump flight
    records there when the gang is torn down.
    """
    emit = on_event or (lambda kind, info: None)
    hb_dir = heartbeat_dir
    own_hb_dir = heartbeat_timeout is not None and hb_dir is None
    if own_hb_dir:
        hb_dir = tempfile.mkdtemp(prefix="zoo_hb_")
    try:
        return _launch_supervised(
            script, script_args, nprocs, devices_per_proc, coordinator,
            platform, timeout, max_restarts, backoff, backoff_factor,
            max_backoff, heartbeat_timeout, heartbeat_interval, hb_dir,
            grace, poll_interval, crash_loop_threshold, emit,
            metrics_dir, status_interval, metrics_port,
            metrics_rotate_bytes)
    finally:
        if own_hb_dir:
            import shutil
            shutil.rmtree(hb_dir, ignore_errors=True)


def _launch_supervised(script, script_args, nprocs, devices_per_proc,
                       coordinator, platform, timeout, max_restarts,
                       backoff, backoff_factor, max_backoff,
                       heartbeat_timeout, heartbeat_interval, hb_dir,
                       grace, poll_interval, crash_loop_threshold,
                       emit, metrics_dir=None, status_interval=None,
                       metrics_port=None,
                       metrics_rotate_bytes=METRICS_ROTATE_BYTES) -> int:
    status = _GangStatus(status_interval, metrics_dir,
                         rotate_bytes=metrics_rotate_bytes)
    metrics_server = None
    if metrics_port is not None:
        metrics_server = _GangMetricsServer(metrics_port, status)
        logger.info("gang metrics endpoint on 127.0.0.1:%d/metrics",
                    metrics_server.port)
    try:
        return _run_attempts(
            script, script_args, nprocs, devices_per_proc, coordinator,
            platform, timeout, max_restarts, backoff, backoff_factor,
            max_backoff, heartbeat_timeout, heartbeat_interval, hb_dir,
            grace, poll_interval, crash_loop_threshold, emit,
            metrics_dir, status)
    finally:
        if metrics_server is not None:
            metrics_server.stop()


def _run_attempts(script, script_args, nprocs, devices_per_proc,
                  coordinator, platform, timeout, max_restarts,
                  backoff, backoff_factor, max_backoff,
                  heartbeat_timeout, heartbeat_interval, hb_dir,
                  grace, poll_interval, crash_loop_threshold,
                  emit, metrics_dir, status) -> int:
    attempt = 0
    first_fail_counts: Dict[int, int] = {}
    while True:
        coord = coordinator or f"127.0.0.1:{_free_port()}"
        procs: List[subprocess.Popen] = []
        hb_files: List[Optional[str]] = []
        try:
            # spawning INSIDE the try: a mid-loop Popen failure (fork
            # EAGAIN, full hb filesystem) must not orphan the ranks
            # already started — they'd block in torch.distributed.init_process_group
            # forever waiting for the missing gang members
            for pid in range(nprocs):
                extra = {"ZOO_RESTART_COUNT": str(attempt)}
                if metrics_dir is not None:
                    # metrics aggregation is on: have workers embed
                    # registry snapshots in epoch-end heartbeats (the
                    # gang fold's input) and dump flight records into
                    # the same directory when the gang is torn down
                    extra["ZOO_HEARTBEAT_METRICS"] = "1"
                    extra["ZOO_FLIGHTREC_DIR"] = metrics_dir
                hb: Optional[str] = None
                if hb_dir is not None:
                    hb = os.path.join(hb_dir, f"hb_a{attempt}_w{pid}")
                    # baseline touch: the worker owns it from
                    # init_orca_context on, but import time must not read
                    # as a hang
                    with open(hb, "a"):
                        os.utime(hb, None)
                    extra["ZOO_HEARTBEAT_FILE"] = hb
                    extra["ZOO_HEARTBEAT_INTERVAL"] = str(
                        heartbeat_interval)
                hb_files.append(hb)
                env = _child_env(coord, nprocs, pid, devices_per_proc,
                                 platform, extra)
                procs.append(subprocess.Popen(
                    [sys.executable, script, *script_args], env=env))
            verdict, rank, rc = _supervise(procs, hb_files,
                                           heartbeat_timeout, timeout,
                                           poll_interval, status=status,
                                           attempt=attempt)
        finally:
            _terminate_gang(procs, grace)
        if verdict == "ok":
            emit("ok", {"attempt": attempt})
            return 0
        if verdict == "timeout":
            raise subprocess.TimeoutExpired(script, timeout)  # type: ignore[arg-type]
        # crash or hang: ``rank`` is the first-detected culprit
        emit(verdict, {"attempt": attempt, "rank": rank, "rc": rc})
        logger.warning("gang attempt %d: worker %d %s (rc=%s); "
                       "terminated the gang", attempt, rank,
                       "crashed" if verdict == "crash" else
                       "lost its heartbeat", rc)
        fail_rc = rc if (rc is not None and rc > 0) else 1
        first_fail_counts[rank] = first_fail_counts.get(rank, 0) + 1
        if first_fail_counts[rank] >= crash_loop_threshold:
            emit("crash_loop", {"rank": rank,
                                "count": first_fail_counts[rank]})
            logger.error(
                "crash loop: worker %d was the first failure in %d of %d "
                "attempts — aborting instead of restarting (fix the worker; "
                "restarts cannot outrun a deterministic fault)",
                rank, first_fail_counts[rank], attempt + 1)
            return EXIT_CRASH_LOOP
        if attempt >= max_restarts:
            logger.error("restart budget exhausted after %d attempt(s); "
                         "giving up with rc=%d", attempt + 1, fail_rc)
            return fail_rc
        delay = min(backoff * (backoff_factor ** attempt), max_backoff)
        emit("restart", {"attempt": attempt + 1, "delay": delay})
        logger.warning("relaunching the gang in %.2fs "
                       "(restart %d of %d)", delay, attempt + 1,
                       max_restarts)
        time.sleep(delay)
        attempt += 1


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    # the supervisor process never goes through init_orca_context, so its
    # own decisions (crash/restart verdicts, gang-status lines) need a
    # handler of their own to reach the zoo-launch terminal
    logging.basicConfig(level=logging.INFO)
    parser = argparse.ArgumentParser(
        prog="zoo-launch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--nprocs", type=int, required=True,
                        help="total number of processes in the job")
    parser.add_argument("--devices-per-proc", type=int, default=None,
                        help="cards a process (CUDA_VISIBLE_DEVICES: "
                             "process i takes cards i*k .. i*k+k-1)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (default: a free "
                             "local port)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="run only this process id (one invocation per "
                             "host on a real cluster)")
    parser.add_argument("--platform", default=None,
                        help="cpu hides the cards (gloo over CPU tensors); "
                             "cuda (the default) lets the workers see them")
    parser.add_argument("--timeout", type=float, default=None,
                        help="wall-clock bound for one gang attempt (s)")
    parser.add_argument("--max-restarts", type=int, default=0,
                        help="gang restarts allowed after a worker crash or "
                             "heartbeat loss (workers auto-resume from "
                             "checkpoints)")
    parser.add_argument("--restart-backoff", type=float, default=0.5,
                        help="base exponential-backoff delay between "
                             "restarts (s)")
    parser.add_argument("--heartbeat-timeout", type=float, default=None,
                        help="kill-and-restart a worker whose heartbeat "
                             "file goes stale for this many seconds "
                             "(default: heartbeats off)")
    parser.add_argument("--heartbeat-interval", type=float, default=1.0,
                        help="seconds between worker heartbeats")
    parser.add_argument("--crash-loop-threshold", type=int, default=3,
                        help="abort (exit %d) when the same worker first-"
                             "fails this many times" % EXIT_CRASH_LOOP)
    parser.add_argument("--metrics-dir", default=None,
                        help="append each worker's heartbeat status "
                             "payload to metrics_w<rank>.jsonl here "
                             "(size-rotated), fold worker registry "
                             "snapshots into gang_metrics.jsonl, and "
                             "collect worker flight-recorder dumps")
    parser.add_argument("--status-interval", type=float, default=10.0,
                        help="seconds between gang-status log lines "
                             "(heartbeat payload aggregation)")
    parser.add_argument("--metrics-port", type=int, default=None,
                        help="serve the merged gang-level snapshot as "
                             "Prometheus text on this supervisor port "
                             "(GET /metrics; 0 = any free port)")
    parser.add_argument("script")
    parser.add_argument("script_args", nargs=argparse.REMAINDER)
    args = parser.parse_args(argv)

    if args.process_id is not None:
        if not args.coordinator:
            parser.error("--process-id requires --coordinator")
        env = _child_env(args.coordinator, args.nprocs, args.process_id,
                         args.devices_per_proc, args.platform,
                         local=(0, 1))  # one process on this host
        os.execve(sys.executable,
                  [sys.executable, args.script, *args.script_args], env)
    raise SystemExit(launch(
        args.script, args.script_args, args.nprocs,
        args.devices_per_proc, args.coordinator, args.platform,
        timeout=args.timeout, max_restarts=args.max_restarts,
        backoff=args.restart_backoff,
        heartbeat_timeout=args.heartbeat_timeout,
        heartbeat_interval=args.heartbeat_interval,
        crash_loop_threshold=args.crash_loop_threshold,
        metrics_dir=args.metrics_dir,
        status_interval=args.status_interval,
        metrics_port=args.metrics_port))


if __name__ == "__main__":
    main()
