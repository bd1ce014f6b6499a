# Port of analytics_zoo_tpu/core/ckpt_manager.py: the same manifest,
# generation layout, policies and CLI, over the port's core/checkpoint.py;
# snapshots are taken from torch tensors (see "Port" below).
"""Asynchronous checkpoint manager: non-blocking snapshots, delta
checkpoints for sharded embeddings, manifest-driven retention/GC.

Motivation: ``core/checkpoint.py`` gives one crash-consistent
*mechanism* — serialize a tree, crc it, tmp+rename the meta — but the
fit loop calls it inline, so checkpoint cadence trades directly against
step time, and sharded embedding tables make every full save
prohibitively large.  The TensorFlow systems paper treats checkpoint
fault-tolerance as a first-class dataflow concern; the MLPerf TPU-pod
paper shows why: at pod scale preemption is routine and recovery-point
objective is a headline metric.  This module is the *policy* layer that
makes frequent checkpoints affordable:

1. **Async saves.**  ``save_async`` only snapshots device state to
   reusable bounded host buffers (double-buffered: at most one snapshot
   pending + one being written) and returns; a background writer thread
   does serialize → crc32 → tmp+rename → manifest append.  What happens
   when a save is requested while one is in flight is an explicit
   policy: ``block`` (wait for the pending slot), ``skip`` (drop the
   request, count ``ckpt.skipped``), or ``latest-wins`` (replace the
   pending snapshot; a superseded *delta* is merged into its
   replacement so no touched-row window is ever lost).

   Snapshot safety: the snapshot is a genuine copy, never a view of the
   live tensors — the train step updates them in place, so a view would
   hold a later step's values by the time the writer serializes it (see
   "Port" below for how the copy is made).

2. **Delta checkpoints.**  For ``sharded_embeddings`` leaves the
   estimator's sparse-update path already dedups touched row ids
   inside the step, so between full saves the manager journals only
   ``(table, ids, rows)`` per generation: the dense remainder of the
   tree (params minus tables, opt state, rng, ...) is saved in full —
   it is small — while each table contributes only the rows touched
   since the previous generation.  Restore replays base + ordered
   deltas; after ``compact_every`` consecutive deltas the next save is
   promoted to a fresh full generation (in-line compaction), and
   ``compact()`` folds a chain offline (the ``zoo-ckpt compact`` CLI).

3. **Manifest-driven retention/GC.**  An fsync'd append-only
   ``MANIFEST.jsonl`` in the checkpoint directory is the single source
   of truth: a generation exists only once its manifest line is fully
   on disk (the writer appends it *after* the generation's files are
   durable), so ``kill -9`` at any byte offset leaves either a
   complete, visible generation or an invisible partial one — restore
   always lands on a complete crc-clean generation.  A torn final line
   (crash mid-append) is ignored by the reader.  Retention keeps the
   last ``keep_last`` full generations plus every ``anchor_every``-th
   full as a long-horizon anchor; GC first appends a ``gc`` manifest
   line naming the collected generations (so a crash mid-delete cannot
   resurrect half a generation) and never collects a generation that a
   live base+delta restore chain still needs (the JAX package's
   ``core/chaos.py`` invariant law 7).

Layered strictly *over* ``core/checkpoint.py``: every generation
directory is a complete, self-verifying checkpoint written by
``checkpoint.save`` (crc32 per file, tmp+rename commit), so all of its
integrity machinery — and its ``checkpoint.write_fail`` injection point
— applies to every async write.  The writer additionally fires the
``checkpoint.slow_write`` fault point so chaos storms can wedge the
background thread without touching the step loop.

Telemetry: ``ckpt.save_ms`` / ``ckpt.snapshot_ms`` / ``ckpt.restore_ms``
histograms, ``ckpt.queue_depth`` gauge, ``ckpt.skipped`` /
``ckpt.full_bytes`` / ``ckpt.delta_bytes`` / ``ckpt.gc_removed`` /
``ckpt.write_errors`` counters, and a ``ckpt.save`` span per background
write (docs/observability.md).

Port: the estimator's step updates its parameters and optimizer state in
place (a CUDA graph replays against fixed addresses), so the next step
would overwrite what a lazy host copy had not read yet.  A snapshot of a
CUDA tensor is therefore a clone on the card, made on the caller's
current stream (so ordered before any later step on that stream); the
writer thread copies the clones to the host on the manager's side stream
once their event has completed, and serializes.  The training thread
pays only for enqueueing the clones (the card copies them at its memory
rate); the host copy, its memory and the file writes are the writer's.
A delta's rows are gathered (``index_select``) into the snapshot the
same way.  CPU tensors and numpy arrays are copied at once.  Snapshot
buffers, on the card or the host, are reused as the JAX package reuses
its host buffers (at most two sets a kind), so a steady cadence of saves
allocates nothing.  Restore gives numpy arrays (torch tensors for dtypes numpy
lacks), as ``core/checkpoint.py`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import secrets
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from . import checkpoint as ckpt_io
from . import faults as faults_lib
from . import metrics as metrics_lib
from . import trace as trace_lib

logger = logging.getLogger("analytics_zoo_tpu_torch")

MANIFEST = "MANIFEST.jsonl"
_ROWS = "rows.npz"

INFLIGHT_POLICIES = ("block", "skip", "latest-wins")


# -- manifest ------------------------------------------------------------------

def read_manifest(path: str) -> Tuple[List[dict], set]:
    """Parse ``MANIFEST.jsonl`` under ``path``.

    Returns ``(records, gc_gens)``: generation records in append order,
    and the set of generation tags named by ``gc`` lines.  Unparseable
    lines are skipped — the only way one arises from this writer is a
    crash mid-append, which by construction can only tear the *final*
    line, and ignoring it is exactly the crash-consistency contract (the
    generation it would have named never became visible).
    """
    recs: List[dict] = []
    gcd: set = set()
    try:
        with open(os.path.join(path, MANIFEST), encoding="utf-8") as f:
            raw = f.read()
    except OSError:
        return recs, gcd
    for line in raw.split("\n"):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        if rec.get("kind") == "gc":
            gcd.update(rec.get("gens") or [])
        elif rec.get("gen"):
            recs.append(rec)
    return recs, gcd


def visible_generations(path: str) -> List[dict]:
    """Generation records visible for restore (manifest order, GC'd
    generations excluded)."""
    recs, gcd = read_manifest(path)
    return [r for r in recs if r["gen"] not in gcd]


def has_manifest(path: str) -> bool:
    """True when ``path`` holds a manager manifest with at least one
    visible generation (the manager-world analog of
    ``checkpoint.exists``)."""
    return bool(visible_generations(path))


def _resolve_chain(by_gen: Dict[str, dict],
                   target: dict) -> Optional[List[dict]]:
    """The restore chain ``[base_full, delta, ..., target]`` for a
    generation record, or None when a link is missing (a predecessor
    whose write failed, or — a GC bug — one that was collected)."""
    if target.get("kind") == "full":
        return [target]
    chain = [target]
    cur = target
    seen = {target["gen"]}
    while cur.get("kind") != "full":
        prev = cur.get("prev")
        if prev is None or prev in seen or prev not in by_gen:
            return None
        seen.add(prev)
        cur = by_gen[prev]
        chain.append(cur)
    chain.reverse()
    return chain


# -- host snapshots ------------------------------------------------------------

class _DeviceCopies:
    """The card's half of one snapshot: its CUDA tensors are cloned on the
    caller's current stream; ``seal`` records an event after the clones,
    and ``reading`` makes the writer's side stream wait for it and the
    writer's copies to the host run on that stream, so they neither see a
    later step's writes nor hold up the steps that follow."""

    def __init__(self) -> None:
        self.device: Optional[torch.device] = None
        self.event: Optional[Any] = None

    def copy(self, t: torch.Tensor, buf: Any) -> torch.Tensor:
        """``t`` copied on the card: into ``buf`` (a snapshot buffer the
        writer is done with) when it fits, else into a new clone."""
        self.device = t.device
        if (isinstance(buf, torch.Tensor) and buf.is_cuda
                and buf.shape == t.shape and buf.dtype == t.dtype
                and buf.stride() == t.stride()):
            return buf.copy_(t)
        return t.detach().clone()

    def seal(self) -> None:
        if self.device is not None:
            self.event = torch.cuda.Event()
            self.event.record(torch.cuda.current_stream(self.device))

    @contextlib.contextmanager
    def reading(self, stream: Optional[Any]) -> Iterator[None]:
        if self.event is None:
            yield
            return
        stream.wait_event(self.event)
        try:
            with torch.cuda.stream(stream):
                yield
        finally:  # the buffers go back to the pool once read
            stream.synchronize()


def _host_leaf(leaf: Any, buf: Any, copies: _DeviceCopies) -> Any:
    """A snapshot of one leaf, a genuine copy (the step updates the
    original in place) into ``buf`` where it fits: a CUDA tensor copied on
    the card through ``copies``, a CPU tensor or numpy array on the host;
    a scalar by reference."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.is_cuda:
            return copies.copy(t, buf)
        if (isinstance(buf, torch.Tensor) and buf.shape == t.shape
                and buf.dtype == t.dtype and buf is not t):
            return buf.copy_(t)
        return t.clone()
    if isinstance(leaf, np.ndarray):
        if (isinstance(buf, np.ndarray) and buf.shape == leaf.shape
                and buf.dtype == leaf.dtype and buf is not leaf):
            np.copyto(buf, leaf)
            return buf
        return np.array(leaf, copy=True)
    return leaf  # scalars and strings are immutable


def _host_copy(tree: Any, bufs: Optional[List[Any]],
               copies: _DeviceCopies) -> Tuple[Any, List[Any]]:
    leaves, structure = ckpt_io.flatten(tree)
    out = [_host_leaf(leaf, bufs[i] if bufs is not None and i < len(bufs)
                      else None, copies)
           for i, leaf in enumerate(leaves)]
    newbufs = [o if isinstance(o, (torch.Tensor, np.ndarray)) else None
               for o in out]
    return ckpt_io.unflatten(structure, out), newbufs


def _gather_rows(table: Any, ids: np.ndarray, copies: _DeviceCopies) -> Any:
    """A snapshot of ``table[ids]`` (a CUDA table's gathered on the card,
    on the caller's stream, like the clones of ``copies``)."""
    if isinstance(table, torch.Tensor):
        idx = torch.from_numpy(ids).to(table.device)
        rows = table.detach().index_select(0, idx)
        if rows.is_cuda:
            copies.device = rows.device
        return rows
    return np.array(np.asarray(table)[ids], copy=True)


def _to_numpy_ids(ids: Any) -> np.ndarray:
    if isinstance(ids, torch.Tensor):
        ids = ids.detach().cpu().numpy()
    return np.asarray(ids).astype(np.int64, copy=True)


def _dir_bytes(path: str) -> int:
    total = 0
    for root, _dirs, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(root, name))
            except OSError:
                pass
    return total


class _Snapshot:
    """One host-side snapshot queued for the writer thread."""

    __slots__ = ("kind", "gen", "dirname", "step", "extra", "tree",
                 "buffers", "tables", "base", "prev", "ordinal",
                 "prev_tip", "prev_dsf", "copies")

    def __init__(self, kind: str, gen: str, step: int,
                 extra: Optional[dict], tree: Any,
                 buffers: Optional[List[Any]],
                 tables: Optional[Dict[str, Tuple[np.ndarray,
                                                  np.ndarray]]],
                 base: Optional[str], prev: Optional[str],
                 ordinal: Optional[int], prev_tip: Optional[dict],
                 prev_dsf: int):
        self.kind = kind
        self.gen = gen
        self.dirname = f"{kind}_{gen}"
        self.step = step
        self.extra = extra
        self.tree = tree
        self.buffers = buffers
        self.tables = tables
        self.base = base
        self.prev = prev
        self.ordinal = ordinal
        self.prev_tip = prev_tip
        self.prev_dsf = prev_dsf
        self.copies: Optional[_DeviceCopies] = None


# -- restore / verify (module-level: usable without a manager) -----------------

def restore_path(path: str) -> Tuple[Any, dict]:
    """Restore the newest restorable generation under a manager
    directory.  Returns ``(tree, manifest_record)``.

    Walks visible generations newest-first; a generation that is
    corrupt (crc mismatch, missing files) or whose base+delta chain is
    unresolvable (a predecessor's write failed before the crash) is
    skipped with a WARNING and the next older one is tried — the
    crash-consistency contract is "a complete older generation", not
    "the newest line in the manifest".
    """
    t0 = time.monotonic()
    visible = visible_generations(path)
    if not visible:
        raise FileNotFoundError(
            f"no visible checkpoint generations under {path} "
            f"(missing or empty {MANIFEST})")
    by_gen = {r["gen"]: r for r in visible}
    last_err: Optional[BaseException] = None
    for rec in reversed(visible):
        chain = _resolve_chain(by_gen, rec)
        if chain is None:
            logger.warning(
                "checkpoint generation %s at %s has an unresolvable "
                "base+delta chain (prev=%s); trying an older one",
                rec["gen"], path, rec.get("prev"))
            continue
        try:
            tree = _restore_chain(path, chain)
        except (ckpt_io.CheckpointCorruptError, OSError, KeyError,
                ValueError) as e:
            last_err = e
            logger.warning(
                "checkpoint generation %s at %s failed to restore "
                "(%s); trying an older one", rec["gen"], path, e)
            continue
        metrics_lib.get_registry().observe(
            "ckpt.restore_ms", (time.monotonic() - t0) * 1000.0)
        return tree, rec
    raise ckpt_io.CheckpointCorruptError(
        f"no restorable checkpoint generation under {path}: "
        f"{last_err}")


def _apply_delta_rows(tables: Dict[str, Any], rec: dict,
                      gen_dir: str) -> None:
    """Replay one delta generation's ``(ids, rows)`` journal into the
    table dict (verifying the rows file against the manifest crc)."""
    rows_path = os.path.join(gen_dir, _ROWS)
    want = rec.get("rows_crc32")
    got = ckpt_io._crc32_file(rows_path)
    if want is not None and got != int(want):
        metrics_lib.get_registry().inc("checkpoint.corrupt_files")
        raise ckpt_io.CheckpointCorruptError(
            f"delta rows file {rows_path} is corrupt: crc32 "
            f"{got:#010x} != recorded {int(want):#010x}")
    raw_names = rec.get("rows_dtype") or {}
    with np.load(rows_path, allow_pickle=False) as data:
        for i, tp in enumerate(rec.get("tables") or []):
            ids = data[f"ids_{i}"]
            # ml_dtypes rows were stored as uint bit patterns
            # (ckpt_io._npz_safe); view them back to the real dtype —
            # a value cast here would turn bits into garbage numerics
            rows = ckpt_io._from_npz(data[f"rows_{i}"],
                                     raw_names.get(tp))
            if not ids.size:
                continue
            tbl = tables.get(tp)
            if tbl is None:
                raise KeyError(
                    f"delta generation {rec['gen']} journals table "
                    f"{tp!r} absent from its base generation")
            if isinstance(tbl, np.ndarray):
                tbl = tbl.copy()
                tbl[ids] = np.asarray(rows).astype(tbl.dtype, copy=False)
            else:
                tbl = tbl.clone()
                tbl[torch.from_numpy(ids)] = torch.as_tensor(
                    rows).to(tbl.dtype)
            tables[tp] = tbl


def _restore_chain(path: str, chain: List[dict]) -> Any:
    from ..parallel import embedding as emb_lib
    target = chain[-1]
    target_dir = os.path.join(path, target["dir"])
    if len(chain) == 1:
        return ckpt_io.restore(target_dir)
    # base full: only its TABLES are needed (the dense remainder comes
    # from the target delta's own full dense save)
    base_dir = os.path.join(path, chain[0]["dir"])
    base_tree = ckpt_io.restore(base_dir)
    _dense_base, tables = emb_lib.split_sparse(base_tree)
    for rec in chain[1:]:
        _apply_delta_rows(tables, rec, os.path.join(path, rec["dir"]))
    dense = ckpt_io.restore(target_dir)
    return emb_lib.merge_sparse(dense, tables)


def verify_path(path: str) -> Tuple[List[str], List[str]]:
    """Crc-check every shard of every visible generation.

    Returns ``(errors, warnings)``.  Errors are integrity violations
    the crash-consistency contract forbids — a visible generation with
    a missing directory, a corrupt file, or a chain broken *by GC*.
    Warnings are tolerated states restore already falls back across: a
    delta whose predecessor never landed (its write failed), which the
    manifest can legitimately contain after a write-fail storm.
    """
    errors: List[str] = []
    warns: List[str] = []
    recs, gcd = read_manifest(path)
    visible = [r for r in recs if r["gen"] not in gcd]
    by_gen = {r["gen"]: r for r in visible}
    for rec in visible:
        gen = rec["gen"]
        gen_dir = os.path.join(path, rec.get("dir") or "")
        if not os.path.isdir(gen_dir):
            errors.append(f"{gen}: generation directory missing "
                          f"({rec.get('dir')})")
            continue
        try:
            with open(os.path.join(gen_dir, ckpt_io._META)) as f:
                meta = json.load(f)
        except (OSError, ValueError) as e:
            errors.append(f"{gen}: unreadable checkpoint meta: {e}")
            continue
        for name in sorted(meta.get("crc32") or {}):
            try:
                ckpt_io._verify_crc(gen_dir, name, meta.get("crc32"))
            except ckpt_io.CheckpointCorruptError as e:
                errors.append(f"{gen}: {e}")
        if rec.get("kind") != "delta":
            continue
        want = rec.get("rows_crc32")
        try:
            got = ckpt_io._crc32_file(os.path.join(gen_dir, _ROWS))
            if want is not None and got != int(want):
                errors.append(f"{gen}: delta rows crc32 {got:#010x} "
                              f"!= recorded {int(want):#010x}")
        except OSError as e:
            errors.append(f"{gen}: delta rows file unreadable: {e}")
        if _resolve_chain(by_gen, rec) is None:
            prev = rec.get("prev")
            if prev in gcd:
                errors.append(
                    f"{gen}: base+delta chain broken by GC "
                    f"(predecessor {prev} was collected)")
            else:
                warns.append(
                    f"{gen}: chain unresolvable (predecessor {prev} "
                    f"never landed); restore falls back to an older "
                    f"generation")
    return errors, warns


# -- the manager ---------------------------------------------------------------

class CheckpointManager:
    """Async, delta-capable, manifest-driven checkpointing for one
    directory.  See the module docstring for semantics.

    Threading: ``save_async``/``save`` are intended to be called from
    one producer thread (the fit loop); the background writer is the
    only other mutator.  ``restore``/``verify``/``generations`` are
    safe from any thread.
    """

    def __init__(self, path: str, *, keep_last: int = 3,
                 anchor_every: int = 0, inflight: str = "block",
                 compact_every: int = 8, retries: int = 3,
                 retry_delay: float = 0.05, delta: bool = True,
                 metrics: Optional[Any] = None):
        if inflight not in INFLIGHT_POLICIES:
            raise ValueError(
                f"inflight policy must be one of {INFLIGHT_POLICIES}, "
                f"got {inflight!r}")
        if compact_every < 1:
            raise ValueError(
                f"compact_every must be >= 1, got {compact_every}")
        self.path = str(path)
        self.keep_last = int(keep_last)
        self.anchor_every = int(anchor_every)
        self.inflight_policy = inflight
        self.compact_every = int(compact_every)
        self.retries = int(retries)
        self.retry_delay = float(retry_delay)
        self.delta = bool(delta)
        os.makedirs(self.path, exist_ok=True)

        reg = metrics or metrics_lib.get_registry()
        self._m_save = reg.histogram("ckpt.save_ms")
        self._m_snap = reg.histogram("ckpt.snapshot_ms")
        self._m_depth = reg.gauge("ckpt.queue_depth")
        self._m_skip = reg.counter("ckpt.skipped")
        self._m_full_b = reg.counter("ckpt.full_bytes")
        self._m_delta_b = reg.counter("ckpt.delta_bytes")
        self._m_gc = reg.counter("ckpt.gc_removed")
        self._m_err = reg.counter("ckpt.write_errors")

        self._cond = threading.Condition()
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._pending: Optional[_Snapshot] = None
        self._writing: Optional[_Snapshot] = None
        self._last_error: Optional[BaseException] = None
        self._force_full = False
        #: reusable host buffer sets, one free pool per snapshot kind
        #: (full and delta trees flatten differently); bounded at two
        #: sets per kind — one writing + one pending is all the queue
        #: can hold
        self._free: Dict[str, List[List[Any]]] = {"full": [],
                                                  "delta": []}
        #: newest enqueued-or-landed generation: {"gen", "kind", "base"}
        self._tip: Optional[dict] = None
        self._deltas_since_full = 0
        #: record of the generation the last ``restore`` landed on
        self.last_restored: Optional[dict] = None
        self.last_written_gen: Optional[str] = None
        #: the writer's stream for the snapshots' copies to the host (made
        #: with the first snapshot of a CUDA tensor)
        self._copy_stream: Optional[Any] = None

        recs, gcd = read_manifest(self.path)
        self._seq = len(recs)
        ords = [int(r["ordinal"]) for r in recs
                if r.get("kind") == "full" and r.get("ordinal")
                is not None]
        self._full_count = (max(ords) + 1) if ords else 0

    # -- lifecycle -------------------------------------------------------------

    def _ensure_writer(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._writer_loop, name="zoo-ckpt-writer",
                daemon=True)
            self._thread.start()

    def close(self, timeout: float = 30.0) -> None:
        """Drain in-flight saves (best effort, bounded) and stop the
        writer thread.  Idempotent."""
        self.flush(timeout=timeout, raise_error=False)
        with self._cond:
            self._closed = True
            self._cond.notify_all()
            t = self._thread
        if t is not None:
            t.join(timeout=timeout)

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # -- save ------------------------------------------------------------------

    def save_async(self, tree: Any, step: int,
                   extra: Optional[dict] = None,
                   touched: Optional[Dict[str, Any]] = None) -> bool:
        """Snapshot ``tree`` to host and hand it to the writer thread.

        Returns True when the snapshot was accepted (it WILL become a
        visible generation unless its write fails), False when the
        in-flight policy dropped it (``skip``).  Callers that maintain
        touched-row state (the estimator) must reset it only on True —
        on False the rows stay marked and ride the next accepted save.

        ``touched``: ``{table_path: row_ids}`` where ``table_path`` is
        the full-tree path of a ``sharded_embeddings`` leaf (e.g.
        ``"params/user/sharded_embeddings"``).  When given — and a base
        generation exists — only those rows are journaled (a delta
        generation); otherwise the save is full.
        """
        return self._save(tree, step, extra, touched,
                          self.inflight_policy)

    def save(self, tree: Any, step: int, extra: Optional[dict] = None,
             touched: Optional[Dict[str, Any]] = None,
             force_full: bool = False) -> None:
        """Blocking save: enqueue (waiting for the pending slot
        regardless of policy) and drain the writer.  Raises the
        writer's error if the write failed."""
        with self._cond:
            if force_full:
                self._force_full = True
        self._save(tree, step, extra, touched, "block")
        self.flush(raise_error=True)

    def save_for_exit(self, tree: Any, step: int,
                      extra: Optional[dict] = None,
                      touched: Optional[Dict[str, Any]] = None,
                      timeout: float = 30.0) -> Optional[int]:
        """Bounded time-to-exit save for the SIGTERM path: when a
        snapshot is already in flight, just drain it (its host copy
        already exists — no new device sync in the preemption window)
        and report *its* step; otherwise take a fresh blocking save.
        Returns the step made durable, or None when nothing landed
        inside ``timeout``."""
        st = self.inflight_step()
        if st is not None and self.flush(timeout=timeout,
                                         raise_error=False):
            return st
        self._save(tree, step, extra, touched, "block")
        if self.flush(timeout=timeout, raise_error=False):
            return step
        return None

    def _save(self, tree: Any, step: int, extra: Optional[dict],
              touched: Optional[Dict[str, Any]], policy: str) -> bool:
        with self._cond:
            if self._closed:
                raise RuntimeError("CheckpointManager is closed")
            self._ensure_writer()
            merge_from: Optional[_Snapshot] = None
            force_full_now = False
            if policy == "block":
                while self._pending is not None:
                    self._cond.wait()
            elif policy == "skip":
                if self._pending is not None or self._writing is not None:
                    self._m_skip.inc()
                    return False
            else:  # latest-wins
                old = self._pending
                if old is not None:
                    self._pending = None
                    self._reclaim_buffers(old)
                    # rewind chain bookkeeping to before the superseded
                    # snapshot was enqueued; its touched-row window is
                    # folded into the replacement below
                    self._tip = old.prev_tip
                    self._deltas_since_full = old.prev_dsf
                    if old.kind == "delta":
                        merge_from = old
                    else:
                        # never let a delta supersede a pending FULL —
                        # the replacement is promoted so durability
                        # cadence (and later chains) survive
                        force_full_now = True
                    self._m_skip.inc()
                    self._cond.notify_all()
            prev_tip = (dict(self._tip) if self._tip is not None
                        else None)
            prev_dsf = self._deltas_since_full

            t0 = time.monotonic()
            snap = self._snapshot(tree, step, extra, touched,
                                  prev_tip, prev_dsf, force_full_now)
            self._m_snap.observe((time.monotonic() - t0) * 1000.0)
            if merge_from is not None and snap.kind == "delta":
                self._merge_delta(snap, merge_from)
            self._pending = snap
            self._tip = {"gen": snap.gen, "kind": snap.kind,
                         "base": (snap.base if snap.kind == "delta"
                                  else snap.gen)}
            self._deltas_since_full = (prev_dsf + 1
                                       if snap.kind == "delta" else 0)
            self._force_full = False
            self._cond.notify_all()
            self._update_depth()
        return True

    def _snapshot(self, tree: Any, step: int, extra: Optional[dict],
                  touched: Optional[Dict[str, Any]],
                  prev_tip: Optional[dict], prev_dsf: int,
                  force_full_now: bool) -> _Snapshot:
        """Build the host snapshot (caller holds the lock; the only
        contention is the writer's brief state flips, and keeping the
        producer single-file here is what bounds the buffer pool)."""
        from ..parallel import embedding as emb_lib
        copies = _DeviceCopies()
        want_delta = (self.delta and touched is not None
                      and prev_tip is not None
                      and not self._force_full and not force_full_now
                      and prev_dsf < self.compact_every)
        tables_payload: Optional[Dict[str, Tuple[np.ndarray,
                                                 np.ndarray]]] = None
        if want_delta:
            dense, tables = emb_lib.split_sparse(tree)
            if not tables:
                want_delta = False
        if want_delta:
            bufs = (self._free["delta"].pop()
                    if self._free["delta"] else None)
            host_tree, bufs = _host_copy(dense, bufs, copies)
            tables_payload = {}
            for tp in sorted(touched):
                if tp not in tables:
                    raise KeyError(
                        f"touched table {tp!r} is not a "
                        f"sharded_embeddings leaf of the tree "
                        f"(known: {sorted(tables)})")
                ids = _to_numpy_ids(touched[tp])
                tables_payload[tp] = (ids, _gather_rows(tables[tp], ids,
                                                        copies))
            kind = "delta"
            base = prev_tip["base"]
            prev: Optional[str] = prev_tip["gen"]
            ordinal: Optional[int] = None
        else:
            bufs = (self._free["full"].pop()
                    if self._free["full"] else None)
            host_tree, bufs = _host_copy(tree, bufs, copies)
            kind, base, prev = "full", None, None
            ordinal = self._full_count
            self._full_count += 1
        self._seq += 1
        gen = f"{self._seq:06d}-{secrets.token_hex(2)}"
        copies.seal()
        if copies.device is not None and self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(copies.device)
        snap = _Snapshot(kind, gen, int(step), dict(extra or {}),
                         host_tree, bufs, tables_payload, base, prev,
                         ordinal, prev_tip, prev_dsf)
        snap.copies = copies
        return snap

    @staticmethod
    def _merge_delta(snap: _Snapshot, old: _Snapshot) -> None:
        """Fold a superseded pending delta's journal into its
        replacement.  Rows in both windows take the replacement's value
        (newer); rows only in the superseded window were untouched
        since it was snapshotted, so its gathered values are still
        current — nothing is lost by dropping the old snapshot."""
        assert snap.tables is not None
        for tp, (ids_o, rows_o) in (old.tables or {}).items():
            if tp not in snap.tables:
                snap.tables[tp] = (ids_o, rows_o)
                continue
            ids_n, rows_n = snap.tables[tp]
            keep = ~np.isin(ids_o, ids_n)
            if isinstance(rows_n, torch.Tensor):
                rows_o = torch.as_tensor(rows_o).to(rows_n.device)
                rows = torch.cat([rows_n, rows_o[
                    torch.from_numpy(keep).to(rows_n.device)]])
            else:
                rows = np.concatenate([rows_n, rows_o[keep]])
            snap.tables[tp] = (np.concatenate([ids_n, ids_o[keep]]), rows)

    def _reclaim_buffers(self, snap: _Snapshot) -> None:
        if snap.buffers is not None and len(self._free[snap.kind]) < 2:
            self._free[snap.kind].append(snap.buffers)

    def _update_depth(self) -> None:
        depth = ((1 if self._pending is not None else 0)
                 + (1 if self._writing is not None else 0))
        self._m_depth.set(depth)

    # -- writer ----------------------------------------------------------------

    def _writer_loop(self) -> None:
        while True:
            with self._cond:
                while self._pending is None and not self._closed:
                    self._cond.wait()
                if self._pending is None:
                    return
                snap = self._pending
                self._pending = None
                self._writing = snap
                self._cond.notify_all()
                self._update_depth()
            err: Optional[BaseException] = None
            try:
                self._write_one(snap)
            except BaseException as e:  # noqa: BLE001 — writer must
                err = e                 # survive to serve later saves
            with self._cond:
                self._writing = None
                self._reclaim_buffers(snap)
                if err is not None:
                    self._last_error = err
                    self._m_err.inc()
                    # the failed generation never became visible; any
                    # delta already chained on it resolves nowhere, so
                    # rewind the tip and force the next save full
                    self._force_full = True
                    if (self._tip is not None
                            and self._tip["gen"] == snap.gen):
                        self._tip = snap.prev_tip
                        self._deltas_since_full = snap.prev_dsf
                    logger.warning(
                        "async checkpoint write of generation %s "
                        "(step %s) failed: %s — next save is forced "
                        "full", snap.gen, snap.step, err)
                else:
                    self.last_written_gen = snap.gen
                self._cond.notify_all()
                self._update_depth()

    def _write_one(self, snap: _Snapshot) -> None:
        t0 = time.monotonic()
        faults_lib.get_registry().fire("checkpoint.slow_write")
        gen_dir = os.path.join(self.path, snap.dirname)
        copies = snap.copies or _DeviceCopies()
        with trace_lib.span("ckpt.save") as sp, \
                copies.reading(self._copy_stream):
            ckpt_io.save(gen_dir, snap.tree, step=snap.step,
                         extra=snap.extra, retries=self.retries,
                         retry_delay=self.retry_delay, keep=1)
            rec: Dict[str, Any] = {
                "kind": snap.kind, "gen": snap.gen, "step": snap.step,
                "dir": snap.dirname, "extra": snap.extra or {},
                "unix": round(time.time(), 3),
            }
            if snap.kind == "full":
                rec["ordinal"] = snap.ordinal
            else:
                order, crc, dtypes = self._write_rows(gen_dir,
                                                      snap.tables)
                rec["base"] = snap.base
                rec["prev"] = snap.prev
                rec["tables"] = order
                rec["rows"] = {tp: int(snap.tables[tp][0].size)
                               for tp in order}
                rec["rows_crc32"] = crc
                if dtypes:
                    rec["rows_dtype"] = dtypes
            nbytes = _dir_bytes(gen_dir)
            rec["bytes"] = nbytes
            self._append_manifest(rec)
            dur_ms = (time.monotonic() - t0) * 1000.0
            self._m_save.observe(dur_ms)
            (self._m_full_b if snap.kind == "full"
             else self._m_delta_b).inc(nbytes)
            sp.stages.update(gen=snap.gen, kind=snap.kind,
                             step=snap.step, bytes=nbytes)
        try:
            self._retention_gc()
        except OSError as e:
            # GC failure must not fail the save that triggered it —
            # the generation is already durable and visible
            logger.warning("checkpoint retention GC at %s failed: %s",
                           self.path, e)

    def _write_rows(self, gen_dir: str,
                    tables: Optional[Dict[str, Tuple[np.ndarray,
                                                     np.ndarray]]]
                    ) -> Tuple[List[str], int, Dict[str, str]]:
        order = sorted(tables or {})
        payload: Dict[str, np.ndarray] = {}
        dtypes: Dict[str, str] = {}
        for i, tp in enumerate(order):
            ids, rows = tables[tp]
            payload[f"ids_{i}"] = ids
            # ml_dtypes rows (bfloat16/float8) land in the npz as uint
            # bit-pattern views; the real dtype name must ride the
            # manifest so restore can reinterpret bits, not value-cast
            payload[f"rows_{i}"], raw = ckpt_io._npz_safe(rows)
            if raw is not None:
                dtypes[tp] = raw
        final = os.path.join(gen_dir, _ROWS)
        tmp = os.path.join(gen_dir,
                           f".rows.{secrets.token_hex(4)}.tmp")

        def _do() -> None:
            with open(tmp, "wb") as f:
                ckpt_io.savez(f, payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, final)

        try:
            ckpt_io._write_with_retry(_do, "delta rows", self.retries,
                                      self.retry_delay)
        finally:
            try:
                os.remove(tmp)
            except OSError:
                pass
        ckpt_io.fsync_dir(gen_dir)
        return order, ckpt_io._crc32_file(final), dtypes

    def _append_manifest(self, rec: dict) -> None:
        """Durable manifest append: O_APPEND write + fsync of the file
        AND its directory.  Routed through ``_write_with_retry`` so the
        ``checkpoint.write_fail`` injection point covers the commit
        point of the async path too."""
        data = (json.dumps(rec, sort_keys=True) + "\n").encode("utf-8")
        mpath = os.path.join(self.path, MANIFEST)

        def _do() -> None:
            fd = os.open(mpath,
                         os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
            try:
                os.write(fd, data)
                os.fsync(fd)
            finally:
                os.close(fd)

        ckpt_io._write_with_retry(_do, "manifest append", self.retries,
                                  self.retry_delay)
        ckpt_io.fsync_dir(self.path)

    # -- retention / GC --------------------------------------------------------

    def _retention_gc(self) -> None:
        """Collect generations no live restore chain needs.

        Liveness: the last ``keep_last`` full generations, every
        ``anchor_every``-th full ever written (by its save-time
        ordinal, so anchor choice is stable across GCs), and every
        delta whose resolved chain bases on a kept-recent full.  The
        ``gc`` manifest line is appended BEFORE any directory is
        deleted: a crash mid-delete leaves invisible directories the
        next GC sweeps, never a visible generation with missing files.
        ``keep_last <= 0`` disables collection entirely.
        """
        if self.keep_last <= 0:
            return
        recs, gcd = read_manifest(self.path)
        visible = [r for r in recs if r["gen"] not in gcd]
        by_gen = {r["gen"]: r for r in visible}
        fulls = [r for r in visible if r.get("kind") == "full"]
        recent = fulls[-self.keep_last:]
        live = {r["gen"] for r in recent}
        if self.anchor_every > 0:
            for r in fulls:
                ordinal = r.get("ordinal")
                if (ordinal is not None
                        and int(ordinal) % self.anchor_every == 0):
                    live.add(r["gen"])
        recent_gens = {r["gen"] for r in recent}
        for r in visible:
            if r.get("kind") != "delta":
                continue
            chain = _resolve_chain(by_gen, r)
            if chain is not None and chain[0]["gen"] in recent_gens:
                live.update(c["gen"] for c in chain)
        dead = [r["gen"] for r in visible if r["gen"] not in live]
        if dead:
            self._append_manifest({"kind": "gc", "gens": dead})
        live_dirs = {by_gen[g]["dir"] for g in live}
        removed = 0
        for name in os.listdir(self.path):
            if not (name.startswith("full_")
                    or name.startswith("delta_")):
                continue
            if name in live_dirs:
                continue
            if (self._writing is not None
                    and name == self._writing.dirname):
                continue
            shutil.rmtree(os.path.join(self.path, name),
                          ignore_errors=True)
            removed += 1
        if removed:
            self._m_gc.inc(removed)

    # -- drain / introspection -------------------------------------------------

    def flush(self, timeout: Optional[float] = None,
              raise_error: bool = True) -> bool:
        """Wait until no save is in flight.  Returns True when drained
        with no writer error since the last flush; False on timeout or
        (with ``raise_error=False``) on a swallowed write error."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._cond:
            while (self._pending is not None
                   or self._writing is not None):
                rem = (None if deadline is None
                       else deadline - time.monotonic())
                if rem is not None and rem <= 0:
                    return False
                self._cond.wait(rem)
            err, self._last_error = self._last_error, None
        if err is not None:
            if raise_error:
                raise err
            return False
        return True

    def in_flight(self) -> bool:
        with self._cond:
            return (self._pending is not None
                    or self._writing is not None)

    def inflight_step(self) -> Optional[int]:
        """The newest step of any in-flight snapshot, or None."""
        with self._cond:
            steps = [s.step for s in (self._pending, self._writing)
                     if s is not None]
        return max(steps) if steps else None

    def generations(self) -> List[dict]:
        return visible_generations(self.path)

    def verify(self) -> List[str]:
        """Integrity errors across every visible generation (crc every
        shard); empty means clean.  Tolerated chain gaps are logged by
        :func:`verify_path` as warnings, not returned here."""
        errors, _warns = verify_path(self.path)
        return errors

    # -- restore / compact -----------------------------------------------------

    def restore(self) -> Any:
        """Restore the newest restorable generation (see
        :func:`restore_path`) and re-point the manager's chain tip at
        it, so subsequent deltas chain off what was actually loaded."""
        tree, rec = restore_path(self.path)
        visible = visible_generations(self.path)
        by_gen = {r["gen"]: r for r in visible}
        chain = _resolve_chain(by_gen, rec) or [rec]
        with self._cond:
            self.last_restored = dict(rec)
            self._tip = {"gen": rec["gen"], "kind": rec["kind"],
                         "base": (rec.get("base") or rec["gen"])}
            self._deltas_since_full = len(chain) - 1
            self._force_full = False
        return tree

    def compact(self) -> Optional[str]:
        """Fold the newest base+delta chain into a fresh full
        generation (offline; restores on host — run it from the
        ``zoo-ckpt`` CLI, not a live trainer).  Returns the new full
        generation's tag, or the existing tag when the newest
        generation is already full."""
        self.flush(raise_error=False)
        tree = self.restore()
        rec = dict(self.last_restored or {})
        if rec.get("kind") == "full":
            return rec.get("gen")
        self.save(tree, int(rec.get("step") or 0),
                  extra=rec.get("extra") or {}, force_full=True)
        return self.last_written_gen


# -- zoo-ckpt CLI --------------------------------------------------------------

def _fmt_bytes(n: Optional[int]) -> str:
    if n is None:
        return "?"
    size = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if size < 1024 or unit == "GiB":
            return (f"{size:.1f}{unit}" if unit != "B"
                    else f"{int(size)}B")
        size /= 1024
    return f"{int(n)}B"


def _cmd_ls(path: str) -> int:
    visible = visible_generations(path)
    if not visible:
        print(f"no visible generations under {path}")
        return 0
    print(f"{'GEN':<13} {'KIND':<6} {'STEP':>8} {'BYTES':>10}  CHAIN")
    for rec in visible:
        if rec.get("kind") == "delta":
            chain = (f"base={rec.get('base')} prev={rec.get('prev')} "
                     f"rows={sum((rec.get('rows') or {}).values())}")
        else:
            chain = "-"
        print(f"{rec['gen']:<13} {rec.get('kind', '?'):<6} "
              f"{rec.get('step', '?'):>8} "
              f"{_fmt_bytes(rec.get('bytes')):>10}  {chain}")
    return 0


def _cmd_verify(path: str) -> int:
    errors, warns = verify_path(path)
    for w in warns:
        print(f"WARN  {w}")
    for e in errors:
        print(f"ERROR {e}")
    n = len(visible_generations(path))
    if errors:
        print(f"{len(errors)} integrity error(s) across {n} "
              f"generation(s)")
        return 1
    print(f"{n} generation(s) verified clean")
    return 0


def _cmd_compact(path: str) -> int:
    with CheckpointManager(path) as mgr:
        gen = mgr.compact()
    print(f"compacted {path} -> full generation {gen}")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    """The ``zoo-ckpt`` command: ``python -m
    analytics_zoo_tpu_torch.core.ckpt_manager ls|verify|compact PATH``."""
    ap = argparse.ArgumentParser(
        prog="zoo-ckpt",
        description="Inspect, verify and compact manager-format "
                    "checkpoint directories (docs/checkpointing.md).")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_ls = sub.add_parser(
        "ls", help="list visible generations with sizes and "
                   "base/delta chains")
    p_ls.add_argument("path")
    p_verify = sub.add_parser(
        "verify", help="crc-check every shard of every visible "
                       "generation (exit 1 on corruption)")
    p_verify.add_argument("path")
    p_compact = sub.add_parser(
        "compact", help="fold the newest base+delta chain into a "
                        "fresh full generation")
    p_compact.add_argument("path")
    ns = ap.parse_args(argv)
    if ns.cmd == "ls":
        return _cmd_ls(ns.path)
    if ns.cmd == "verify":
        return _cmd_verify(ns.path)
    return _cmd_compact(ns.path)


if __name__ == "__main__":  # pragma: no cover
    raise SystemExit(main())
