# Port of analytics_zoo_tpu/serving/batch.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Offline batch scoring against the online replica pool.

The reference platform promises one stack for BOTH halves of inference:
Cluster Serving for online traffic and Orca-style ``predict`` over large
offline datasets.  This repo grew the online half (the pipeline server,
the ReplicaSet router, per-class admission); this module is the offline
half, built ON TOP of it instead of beside it — a batch job is just
``klass="batch"`` traffic through the same pool, so the server's
per-class admission gate keeps interactive p99 intact while the job
soaks up slack capacity (the Gemma-on-Cloud-TPU serving setup in
PAPERS.md: batch and interactive sharing capacity under an SLO).

:class:`BatchScorer` takes a row source (ndarray, ``{"x": ...}`` dict,
``DataFeed``, ``FeatureTable``, or an iterable of row chunks), splits it
into fixed-size **shards**, and streams each shard's rows through a
:class:`~analytics_zoo_tpu_torch.serving.router.ReplicaSet` with a bounded
in-flight window.  Fault tolerance is the TensorFlow-paper kind —
re-execution from a journal, not best-effort:

- every completed shard is written **atomically** (``.npz`` to a temp
  name, crc32, ``os.replace`` — the core/checkpoint.py pattern) and then
  appended to ``journal.jsonl``;
- ``resume=True`` replays the journal, crc-verifies each finished
  shard's bytes, and skips it — after a client crash or a replica kill
  the job re-scores ONLY the unjournaled tail.  Zero lost and zero
  duplicated rows by construction: the job's output is the journaled
  shards concatenated in shard order, each shard covering a disjoint,
  contiguous row range.

**Shadow validation** (``shadow_version=``) scores every shard against
the active version AND a pinned candidate (the registry's canary pins),
accumulates per-metric deltas (mean/max abs delta, argmax mismatch
rate), and a ``promote_if(deltas)`` gate flips the candidate live via
``ModelRegistry.promote()`` — warm → atomic flip → drain, zero
downtime — closing the offline→online loop end to end.

Telemetry: ``batch.rows`` / ``batch.retries`` / ``batch.resumed_shards``
counters, a ``batch.inflight`` gauge, and a ``batch.job`` span with one
``batch.shard`` child per scored shard.  A job that exhausts its shard
retries dumps a flight record (``batch_abort``) before raising.

CLI: ``zoo-score`` (see :func:`main`) runs a journaled job against a
running pool from a ``.npy``/``.npz`` file.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import threading
import time
import zlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from analytics_zoo_tpu_torch.core import faults as faults_lib
from analytics_zoo_tpu_torch.core import flightrec
from analytics_zoo_tpu_torch.core import metrics as metrics_lib
from analytics_zoo_tpu_torch.core import trace as trace_lib
from analytics_zoo_tpu_torch.core.config import ZooConfig
from .client import RetryPolicy
from .router import ReplicaSet

logger = logging.getLogger("analytics_zoo_tpu")

#: job-directory layout
JOB_META = "job.json"
JOURNAL = "journal.jsonl"


class BatchJobError(RuntimeError):
    """A batch job failed permanently (shard retries exhausted, config
    mismatch on resume, or the replica set went away)."""


def _crc32_file(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                break
            crc = zlib.crc32(chunk, crc)
    return crc & 0xFFFFFFFF


@dataclass
class ShadowDeltas:
    """Per-metric drift between the active version and the shadow
    candidate, accumulated over every scored row.  ``mismatch_rate``
    is the argmax-disagreement fraction for multi-class outputs, exact
    value disagreement otherwise — the "would this row's decision
    change" number a promotion gate actually wants."""

    rows: int = 0
    mean_abs_delta: float = 0.0
    max_abs_delta: float = 0.0
    mismatches: int = 0

    @property
    def mismatch_rate(self) -> float:
        return self.mismatches / self.rows if self.rows else 0.0

    def fold(self, active: np.ndarray, shadow: np.ndarray) -> None:
        """Accumulate one shard's (active, shadow) output pair."""
        a = np.asarray(active, np.float64)
        s = np.asarray(shadow, np.float64)
        n = len(a)
        diff = np.abs(a - s)
        # streaming mean over rows: weight the old mean by old n
        total = self.mean_abs_delta * self.rows + float(diff.mean()) * n
        self.rows += n
        self.mean_abs_delta = total / self.rows
        self.max_abs_delta = max(self.max_abs_delta, float(diff.max()))
        if a.ndim >= 2 and a.shape[-1] > 1:
            flat_a = a.reshape(n, -1)
            flat_s = s.reshape(n, -1)
            self.mismatches += int(
                (flat_a.argmax(-1) != flat_s.argmax(-1)).sum())
        else:
            self.mismatches += int(
                (diff.reshape(n, -1).max(-1) > 0).sum())

    def to_dict(self) -> Dict[str, Any]:
        return {"rows": self.rows,
                "mean_abs_delta": self.mean_abs_delta,
                "max_abs_delta": self.max_abs_delta,
                "mismatch_rate": self.mismatch_rate}


@dataclass
class BatchJobReport:
    """What a finished job looked like: row/shard accounting, retry and
    resume counts, shadow deltas, and the promotion outcome."""

    out_dir: str
    rows: int = 0
    n_shards: int = 0
    scored_shards: int = 0
    resumed_shards: int = 0
    retries: int = 0
    duration_s: float = 0.0
    deltas: Optional[ShadowDeltas] = None
    promoted: Optional[str] = None  # version promote_if flipped live
    shard_files: List[str] = field(default_factory=list)

    def to_dict(self) -> Dict[str, Any]:
        d = {"out_dir": self.out_dir, "rows": self.rows,
             "n_shards": self.n_shards,
             "scored_shards": self.scored_shards,
             "resumed_shards": self.resumed_shards,
             "retries": self.retries,
             "duration_s": round(self.duration_s, 3),
             "promoted": self.promoted}
        if self.deltas is not None:
            d["deltas"] = self.deltas.to_dict()
        return d

    def output(self) -> np.ndarray:
        """The job's full output, journaled shards concatenated in
        shard order — row i of the result is the score of source row
        i, resumed and re-scored shards alike."""
        return read_output(self.out_dir)


def read_output(out_dir: str, key: str = "y") -> np.ndarray:
    """Concatenate a job directory's journaled shard outputs in shard
    order (``key="y_shadow"`` reads the candidate's outputs of a shadow
    job).  Raises :class:`BatchJobError` on gaps — a journal missing
    shard k means the job never finished."""
    entries = _read_journal(out_dir)
    if not entries:
        raise BatchJobError(f"no journaled shards under {out_dir}")
    by_shard = {e["shard"]: e for e in entries}
    n = max(by_shard) + 1
    missing = [i for i in range(n) if i not in by_shard]
    if missing:
        raise BatchJobError(
            f"journal under {out_dir} is missing shard(s) {missing}; "
            "the job did not run to completion (resume it)")
    parts = []
    for i in range(n):
        with np.load(os.path.join(out_dir, by_shard[i]["file"])) as z:
            parts.append(z[key])
    return np.concatenate(parts, axis=0)


def _read_journal(out_dir: str) -> List[Dict[str, Any]]:
    """Parse ``journal.jsonl``, tolerating a torn final line (a crash
    mid-append leaves a partial record; the shard it described simply
    re-scores)."""
    path = os.path.join(out_dir, JOURNAL)
    entries: List[Dict[str, Any]] = []
    if not os.path.exists(path):
        return entries
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                entries.append(json.loads(line))
            except json.JSONDecodeError:
                logger.warning("batch journal %s: ignoring torn line "
                               "(crash mid-append)", path)
    return entries


def _rows_from(source: Any,
               feature_cols: Optional[Sequence[str]] = None) -> np.ndarray:
    """Normalize any supported row source to one (n, ...) ndarray."""
    if isinstance(source, np.ndarray):
        return source
    if isinstance(source, dict):
        if "x" not in source:
            raise ValueError("dict row source needs an 'x' entry")
        return np.asarray(source["x"])
    if hasattr(source, "to_numpy_dict"):        # friesian FeatureTable
        if feature_cols is None:
            raise ValueError(
                "FeatureTable row source needs feature_cols=[...]")
        return np.asarray(source.to_numpy_dict(feature_cols)["x"])
    if hasattr(source, "_data"):                # data.DataFeed and kin
        return np.asarray(source._data["x"])
    if hasattr(source, "__iter__"):             # reader: row-chunk iter
        chunks = [np.asarray(c) for c in source]
        if not chunks:
            raise ValueError("empty row-chunk iterable")
        return np.concatenate(chunks, axis=0)
    raise TypeError(f"unsupported row source {type(source).__name__}")


class BatchScorer:
    """Journaled, resumable batch scoring through a ReplicaSet.

    ``replicas`` is either a live :class:`ReplicaSet` (shared with other
    clients; NOT closed by the scorer) or a backend list (``["host:port",
    ...]``), in which case the scorer owns the set it builds and closes
    it in :meth:`close`.  ``shard_size`` / ``max_inflight`` default to
    the :class:`ZooConfig` knobs (``batch_shard_size`` /
    ``batch_max_inflight``)."""

    def __init__(self, replicas: Any, out_dir: str,
                 shard_size: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 retry: Optional[RetryPolicy] = None,
                 model: Optional[str] = None,
                 deadline: Optional[float] = None,
                 request_timeout: float = 30.0,
                 config: Optional[ZooConfig] = None,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        cfg = config or ZooConfig()
        if isinstance(replicas, ReplicaSet):
            self._rs, self._own_rs = replicas, False
        else:
            self._rs = ReplicaSet(replicas)
            self._own_rs = True
        self.out_dir = out_dir
        self.shard_size = int(shard_size or cfg.batch_shard_size)
        self.max_inflight = int(max_inflight or cfg.batch_max_inflight)
        if self.shard_size < 1 or self.max_inflight < 1:
            raise ValueError("shard_size and max_inflight must be >= 1")
        self.retry = retry or RetryPolicy()
        self.model = model
        self.deadline = deadline
        self.request_timeout = request_timeout
        self._metrics = metrics or metrics_lib.get_registry()
        self._m_rows = self._metrics.counter("batch.rows")
        self._m_retries = self._metrics.counter("batch.retries")
        self._m_resumed = self._metrics.counter("batch.resumed_shards")
        self._m_inflight = self._metrics.gauge("batch.inflight")
        self._inflight = 0
        self._inflight_lock = threading.Lock()

    # -- lifecycle ------------------------------------------------------------

    def close(self) -> None:
        if self._own_rs:
            self._rs.close()

    def __enter__(self) -> "BatchScorer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- the job --------------------------------------------------------------

    def score(self, source: Any, resume: bool = False,
              shadow_version: Optional[str] = None,
              promote_if: Optional[Callable[[Dict[str, Any]], bool]] = None,
              registry: Any = None,
              feature_cols: Optional[Sequence[str]] = None
              ) -> BatchJobReport:
        """Run (or resume) one journaled job over ``source``.

        ``resume=True`` requires the job directory's ``job.json`` to
        match this call's row count / shard size / model / shadow
        version — resuming a DIFFERENT job into the same directory
        would silently interleave two jobs' shards.  ``promote_if``
        (shadow mode only) receives the accumulated deltas dict after
        the last shard; a truthy return promotes ``shadow_version`` on
        ``registry`` (a :class:`ModelRegistry`) via its zero-downtime
        :meth:`~ModelRegistry.promote` path."""
        if promote_if is not None and shadow_version is None:
            raise ValueError("promote_if needs shadow_version=")
        if promote_if is not None and registry is None:
            raise ValueError("promote_if needs registry= (the serving "
                             "ModelRegistry to promote on)")
        rows = _rows_from(source, feature_cols)
        n = len(rows)
        if n == 0:
            raise ValueError("row source is empty")
        n_shards = -(-n // self.shard_size)
        os.makedirs(self.out_dir, exist_ok=True)
        meta = {"n_rows": n, "shard_size": self.shard_size,
                "n_shards": n_shards, "model": self.model,
                "shadow_version": shadow_version}
        done = self._prepare_journal(meta, resume)

        report = BatchJobReport(out_dir=self.out_dir, rows=n,
                                n_shards=n_shards,
                                resumed_shards=len(done))
        deltas = ShadowDeltas() if shadow_version is not None else None
        if done:
            self._m_resumed.inc(len(done))
        t0 = time.monotonic()
        tid = trace_lib.new_trace_id()
        job_sp = trace_lib.span("batch.job", trace_id=tid,
                                **{"batch.n_shards": n_shards,
                                   "batch.resumed": len(done)})
        try:
            with job_sp:
                # resumed shards still feed the job-level deltas: the
                # promotion gate must see EVERY row, not just the tail
                # scored after the crash
                if deltas is not None:
                    for i in sorted(done):
                        with np.load(os.path.join(
                                self.out_dir, done[i]["file"])) as z:
                            deltas.fold(z["y"], z["y_shadow"])
                for i in range(n_shards):
                    if i in done:
                        report.shard_files.append(done[i]["file"])
                        continue
                    lo = i * self.shard_size
                    hi = min(n, lo + self.shard_size)
                    fname = self._run_shard(i, rows[lo:hi], lo, hi, tid,
                                            job_sp, shadow_version,
                                            deltas, report)
                    report.shard_files.append(fname)
                    report.scored_shards += 1
        except BaseException as e:
            # the abort flight record: enough to reconstruct where the
            # job stood (journal state, counters, the failing error)
            flightrec.dump("batch_abort", extra={
                "job_dir": self.out_dir, "error": repr(e),
                "scored_shards": report.scored_shards,
                "resumed_shards": report.resumed_shards,
                "n_shards": n_shards, "retries": report.retries})
            raise
        report.duration_s = time.monotonic() - t0
        report.deltas = deltas
        if deltas is not None and promote_if is not None \
                and promote_if(deltas.to_dict()):
            from .model_registry import ModelRegistry
            name = self.model or ModelRegistry.DEFAULT
            report.promoted = registry.promote(name, shadow_version)
            logger.info("batch job %s: shadow deltas cleared the gate; "
                        "promoted %s version %s", self.out_dir, name,
                        shadow_version)
        return report

    # -- journal --------------------------------------------------------------

    def _prepare_journal(self, meta: Dict[str, Any], resume: bool
                         ) -> Dict[int, Dict[str, Any]]:
        """Write/validate ``job.json`` and return the crc-verified
        finished shards ``{shard: journal entry}`` (empty for a fresh
        job)."""
        meta_path = os.path.join(self.out_dir, JOB_META)
        journal_path = os.path.join(self.out_dir, JOURNAL)
        if not resume:
            tmp = meta_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(meta, f)
            os.replace(tmp, meta_path)
            open(journal_path, "w").close()  # truncate any old journal
            return {}
        if not os.path.exists(meta_path):
            raise BatchJobError(
                f"resume=True but {meta_path} does not exist; start the "
                "job without resume first")
        with open(meta_path) as f:
            old = json.load(f)
        if old != meta:
            raise BatchJobError(
                f"resume config mismatch under {self.out_dir}: the "
                f"journal was written by {old}, this call is {meta} — "
                "resuming a different job here would interleave shards")
        done: Dict[int, Dict[str, Any]] = {}
        for e in _read_journal(self.out_dir):
            path = os.path.join(self.out_dir, e["file"])
            try:
                ok = _crc32_file(path) == int(e["crc32"])
            except OSError:
                ok = False
            if ok:
                done[int(e["shard"])] = e
            else:
                logger.warning("batch resume %s: shard %s failed crc "
                               "verification; re-scoring it",
                               self.out_dir, e.get("shard"))
        return done

    def _journal_append(self, entry: Dict[str, Any]) -> None:
        """Durably append one finished-shard record.  The shard file
        was already renamed into place, so a crash between the rename
        and this append merely re-scores that shard on resume."""
        path = os.path.join(self.out_dir, JOURNAL)
        with open(path, "a") as f:
            f.write(json.dumps(entry) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- shard scoring --------------------------------------------------------

    def _run_shard(self, idx: int, shard: np.ndarray, lo: int, hi: int,
                   tid: str, job_sp: trace_lib.Span,
                   shadow_version: Optional[str],
                   deltas: Optional[ShadowDeltas],
                   report: BatchJobReport) -> str:
        """Score one shard (with shard-level retries) and journal it.
        Raises :class:`BatchJobError` when the retry budget runs out."""
        last_err: Optional[BaseException] = None
        for attempt in range(1, self.retry.max_attempts + 1):
            sp = job_sp.child("batch.shard")
            sp.stages["batch.shard_idx"] = idx
            sp.stages["batch.shard_rows"] = hi - lo
            try:
                with sp:
                    # ``batch.shard_fail`` injection point
                    # (core/faults.py): an armed fault fails the whole
                    # shard attempt, exercising the retry → journal →
                    # resume machinery end to end
                    faults_lib.get_registry().raise_if("batch.shard_fail")
                    y = self._score_rows(shard, tid, None)
                    out = {"y": y}
                    if shadow_version is not None:
                        out["y_shadow"] = self._score_rows(
                            shard, tid, shadow_version)
                fname = self._write_shard(idx, lo, hi, out)
                if deltas is not None:
                    deltas.fold(out["y"], out["y_shadow"])
                self._m_rows.inc(hi - lo)
                return fname
            except (OSError, BatchJobError):
                raise  # pool closed / permanent — no point retrying
            except Exception as e:  # noqa: BLE001 — injected faults,
                # timeouts and transient serving errors all take the
                # same bounded shard-retry path
                last_err = e
                if attempt < self.retry.max_attempts:
                    report.retries += 1
                    self._m_retries.inc()
                    delay = self.retry.delay(attempt)
                    logger.warning(
                        "batch shard %d attempt %d/%d failed (%s); "
                        "retrying in %.2fs", idx, attempt,
                        self.retry.max_attempts, e, delay)
                    time.sleep(delay)
        raise BatchJobError(
            f"shard {idx} (rows [{lo}, {hi})) failed after "
            f"{self.retry.max_attempts} attempts: "
            f"{last_err}") from last_err

    def _score_rows(self, shard: np.ndarray, tid: str,
                    version: Optional[str]) -> np.ndarray:
        """One pass of a shard's rows through the pool: a window of
        ``max_inflight`` concurrent ``klass="batch"`` requests via
        :meth:`ReplicaSet.submit`.  Row timeouts retry within the pass;
        a non-retryable serving error fails the pass (the shard-level
        retry owns backoff)."""
        n = len(shard)
        out: List[Optional[np.ndarray]] = [None] * n
        pending = list(range(n))
        for attempt in range(1, self.retry.max_attempts + 1):
            sem = threading.Semaphore(self.max_inflight)

            def _done(_f: Any, _sem: Any = sem) -> None:
                _sem.release()
                with self._inflight_lock:
                    self._inflight -= 1
                    self._m_inflight.set(self._inflight)

            futures: List[Tuple[int, Any]] = []
            for j in pending:
                sem.acquire()
                with self._inflight_lock:
                    self._inflight += 1
                    self._m_inflight.set(self._inflight)
                f = self._rs.submit(shard[j], klass="batch",
                                    model=self.model, version=version,
                                    deadline=self.deadline,
                                    timeout=self.request_timeout,
                                    trace_id=tid)
                f.add_done_callback(_done)
                futures.append((j, f))
            failed: List[int] = []
            row_err: Optional[BaseException] = None
            for j, f in futures:
                try:
                    r = f.result()
                except OSError:
                    raise  # ReplicaSet closed under the job: permanent
                except RuntimeError as e:
                    # non-retryable serving error (bad model/version,
                    # payload rejection): retrying the row cannot help
                    row_err = e
                    r = None
                if r is None and row_err is not None:
                    raise row_err
                if r is None:
                    failed.append(j)  # timed out; retry the row
                else:
                    out[j] = np.asarray(r)
            if not failed:
                return np.stack(out, axis=0)
            self._m_retries.inc(len(failed))
            if attempt < self.retry.max_attempts:
                time.sleep(self.retry.delay(attempt))
            pending = failed
        raise TimeoutError(
            f"{len(pending)} row(s) still unanswered after "
            f"{self.retry.max_attempts} passes")

    def _write_shard(self, idx: int, lo: int, hi: int,
                     arrays: Dict[str, np.ndarray]) -> str:
        """Atomic shard write: npz to a temp name, crc32 the bytes,
        ``os.replace`` into place, THEN journal — a crash at any point
        leaves either a complete, verifiable shard or nothing."""
        fname = f"shard_{idx:05d}.npz"
        final = os.path.join(self.out_dir, fname)
        tmp = final + ".tmp"
        with open(tmp, "wb") as f:
            np.savez(f, **arrays)
        crc = _crc32_file(tmp)
        os.replace(tmp, final)
        self._journal_append({"shard": idx, "file": fname, "crc32": crc,
                              "lo": lo, "hi": hi})
        return fname


# -- CLI ----------------------------------------------------------------------

def main(argv: Optional[Sequence[str]] = None) -> int:
    """``zoo-score``: run a journaled batch job against a running pool.

    Input is a ``.npy`` array or an ``.npz`` with an ``x`` entry; the
    report (rows, shards, retries, resume count, shadow deltas) prints
    as JSON.  Promotion gating is an in-process API (``promote_if=`` +
    the server's ``ModelRegistry``); the CLI reports deltas only.
    """
    p = argparse.ArgumentParser(
        prog="zoo-score",
        description="Offline batch scoring through a serving replica "
                    "pool, with a resumable shard journal.")
    p.add_argument("--backend", action="append", required=True,
                   metavar="HOST:PORT",
                   help="replica address (repeat for a pool)")
    p.add_argument("--input", required=True,
                   help=".npy array or .npz with an 'x' entry")
    p.add_argument("--out", required=True,
                   help="job directory (journal + shard outputs)")
    p.add_argument("--model", default=None,
                   help="model name for multi-model pools")
    p.add_argument("--shard-size", type=int, default=None)
    p.add_argument("--max-inflight", type=int, default=None)
    p.add_argument("--deadline", type=float, default=None,
                   help="per-request deadline seconds")
    p.add_argument("--resume", action="store_true",
                   help="skip crc-verified journaled shards")
    p.add_argument("--shadow-version", default=None,
                   help="also score a pinned candidate version and "
                        "report per-metric deltas")
    args = p.parse_args(argv)

    if args.input.endswith(".npz"):
        with np.load(args.input) as z:
            rows = z["x"]
    else:
        rows = np.load(args.input)
    scorer = BatchScorer(args.backend, args.out,
                         shard_size=args.shard_size,
                         max_inflight=args.max_inflight,
                         model=args.model, deadline=args.deadline)
    try:
        report = scorer.score(rows, resume=args.resume,
                              shadow_version=args.shadow_version)
    finally:
        scorer.close()
    print(json.dumps(report.to_dict(), indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
