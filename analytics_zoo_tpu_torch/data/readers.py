"""Distributed file readers producing XShards (port of
``analytics_zoo_tpu/data/readers.py``, which is numpy and pandas apart
from its process index; the port keeps its own copy).

Reference (SURVEY.md §2.2): ``orca.data.pandas.read_csv/read_json``
(pyzoo/zoo/orca/data/pandas/preprocessing.py) read files into SparkXShards
with a backend switch ("spark" | "pandas").

Files are globbed, the file list is split across processes (process i of
N takes files i, i+N, ...), and each process reads its files into local
shards in parallel.  The JAX package's ``jax.process_index()`` and
``process_count()`` are :func:`process_grid` here: ``torch.distributed``'s
rank and world size once a process group is initialized, else 0 of 1, which
is what the JAX calls return in one process.
"""

from __future__ import annotations

import collections
import glob
import os
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .feed import tree_map
from .shards import XShards


def process_grid() -> Tuple[int, int]:
    """(this process's index, the process count): ``torch.distributed``'s
    rank and world size when a process group is initialized, else (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class FileReadahead:
    """Per-worker raw-file readahead: a background thread reads hinted
    files' bytes into a bounded cache so storage latency overlaps decode.

    The streaming feed's decode workers hint each batch's file list
    before decoding it (``StreamingDataFeed`` -> ``ImageSet.hint_indices``
    -> ``hint()``); while the worker decodes image k, the reader thread is
    already pulling image k+1's bytes off storage.  ``get(path)`` returns
    the cached bytes or, on a miss, reads inline and counts the blocked
    time, so the fraction of decode wall spent waiting on storage is an
    honest, per-worker number (``wait_ms`` is thread-local; the feed
    surfaces deltas as the ``feed.io_wait_ms`` series).

    One instance per worker (thread or forked process): ``ImageSet``
    creates them lazily keyed on pid, so fork inheritance can never share
    a dead reader thread.
    """

    def __init__(self, depth: int = 8):
        if depth < 1:
            raise ValueError(f"readahead depth must be >= 1, got {depth}")
        self.pid = os.getpid()
        self.depth = depth
        self._cond = threading.Condition(threading.Lock())
        self._want: "collections.deque[str]" = collections.deque()
        self._cache: Dict[str, bytes] = {}
        self._reading: Optional[str] = None  # path the reader holds now
        self._drop: set = set()    # in-flight reads the decoder already
        #                            satisfied inline: discard, don't cache
        self._tl = threading.local()  # per-caller-thread wait accounting
        self._closed = False
        self._thread: Optional[threading.Thread] = None

    @property
    def wait_ms(self) -> float:
        """Cumulative blocked-on-storage ms for the CALLING thread."""
        return getattr(self._tl, "ms", 0.0)

    def hint(self, paths: Sequence[str]) -> None:
        """Advise which files are about to be read (drops hints beyond
        the bound: they fall back to inline reads, never to an unbounded
        queue)."""
        with self._cond:
            if self._closed:
                return
            queued = set(self._want)
            for p in paths:
                if p in queued or p in self._cache:
                    continue
                if len(self._want) >= 4 * self.depth:
                    break
                self._want.append(p)
                queued.add(p)
            if self._want and self._thread is None:
                self._thread = threading.Thread(
                    target=self._read_loop, daemon=True,
                    name="zoo-readahead")
                self._thread.start()
            self._cond.notify_all()

    def get(self, path: str) -> bytes:
        """The file's bytes: from cache when the readahead won the race,
        else read inline with the blocked time counted.  A miss retires
        the path from the readahead's queue (and marks an in-flight read
        of it for discard), so a lost race leaves no stale cache entry
        behind to fill the cache and park the reader."""
        with self._cond:
            data = self._cache.pop(path, None)
            if data is not None:
                self._cond.notify_all()  # cache slot freed: reader resumes
                return data
            try:  # we're reading it ourselves: the hint is stale now
                self._want.remove(path)
            except ValueError:
                pass
            if self._reading == path:
                self._drop.add(path)
        t0 = time.monotonic()
        with open(path, "rb") as f:
            data = f.read()
        self._tl.ms = getattr(self._tl, "ms", 0.0) \
            + (time.monotonic() - t0) * 1000.0
        return data

    def _read_loop(self) -> None:
        while True:
            with self._cond:
                self._reading = None
                while not self._closed and (
                        not self._want or len(self._cache) >= self.depth):
                    self._cond.wait()
                if self._closed:
                    return
                path = self._want.popleft()
                if path in self._cache:
                    continue
                self._reading = path
            try:
                with open(path, "rb") as f:
                    data = f.read()
            except OSError:
                continue  # the decode-side read reports the real error
            with self._cond:
                if self._closed:
                    return
                if path in self._drop:   # decoder read it inline meanwhile
                    self._drop.discard(path)
                    continue
                self._cache[path] = data
                self._cond.notify_all()

    def close(self) -> None:
        with self._cond:
            self._closed = True
            self._want.clear()
            self._cache.clear()
            self._cond.notify_all()


def _expand(file_path: str, extensions: Sequence[str]) -> List[str]:
    # extension matching is case-insensitive: ``.CSV``/``.JPG`` files of a
    # globbed directory are read like lower-case ones
    exts = tuple(e.lower() for e in extensions)
    if os.path.isdir(file_path):
        files = sorted(
            f for f in glob.glob(os.path.join(file_path, "**", "*"),
                                 recursive=True)
            if os.path.isfile(f) and f.lower().endswith(exts))
    else:
        files = sorted(glob.glob(file_path))
    if not files:
        raise FileNotFoundError(f"no files match {file_path!r}")
    return files


def _my_files(files: List[str]) -> tuple:
    """This process's slice of the global file list (round-robin).

    Returns (my_files, row_slice): when there are fewer files than
    processes, every process reads the full file list and ``row_slice =
    (pid, n)`` tells the reader to keep only rows ``pid::n``, so the union
    over processes is exactly the dataset, no row duplicated."""
    pid, n = process_grid()
    if len(files) < n:
        return files, (pid, n)
    return files[pid::n], None


def _apply_row_slice(shards: XShards, row_slice) -> XShards:
    if row_slice is None:
        return shards
    pid, n = row_slice
    return shards.transform_shard(
        lambda d: d.iloc[pid::n] if hasattr(d, "iloc")
        else tree_map(lambda a: a[pid::n], d))


def read_csv(file_path: str, num_shards: Optional[int] = None,
             **kwargs: Any) -> XShards:
    """Read CSV file(s)/glob/dir into pandas-DataFrame XShards."""
    import pandas as pd
    files, row_slice = _my_files(_expand(file_path, (".csv",)))
    shards = _apply_row_slice(XShards(files).transform_shard(
        lambda f: pd.read_csv(f, **kwargs)), row_slice)
    if num_shards and num_shards != shards.num_partitions():
        shards = shards.repartition(num_shards)
    return shards


def read_json(file_path: str, num_shards: Optional[int] = None,
              **kwargs: Any) -> XShards:
    import pandas as pd
    files, row_slice = _my_files(_expand(file_path, (".json", ".jsonl")))
    shards = _apply_row_slice(XShards(files).transform_shard(
        lambda f: pd.read_json(f, **kwargs)), row_slice)
    if num_shards and num_shards != shards.num_partitions():
        shards = shards.repartition(num_shards)
    return shards


def read_parquet(file_path: str, num_shards: Optional[int] = None,
                 **kwargs: Any) -> XShards:
    import pandas as pd
    files, row_slice = _my_files(_expand(file_path, (".parquet", ".pq")))
    shards = _apply_row_slice(XShards(files).transform_shard(
        lambda f: pd.read_parquet(f, **kwargs)), row_slice)
    if num_shards and num_shards != shards.num_partitions():
        shards = shards.repartition(num_shards)
    return shards


def read_npz(file_path: str, keys: Optional[Sequence[str]] = None) -> XShards:
    """Read .npz archives into numpy-dict shards (one shard per file)."""
    files, row_slice = _my_files(_expand(file_path, (".npz",)))

    def load(f):
        with np.load(f) as z:
            return {k: z[k] for k in (keys or z.files)}
    return _apply_row_slice(XShards(files).transform_shard(load), row_slice)
