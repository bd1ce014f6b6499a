"""DataFeed: host-side batching onto one device (port of
``analytics_zoo_tpu/data/feed.py``, the in-memory array feed).

The same batch order as the JAX package: each epoch shuffles row indices
with ``np.random.default_rng(seed + epoch)``, batches are fixed-size, and
the last partial batch is either dropped (``drop_remainder``, the training
default) or padded by wrapping around to the first rows, with ``step_mask``
marking the real rows so that ``evaluate`` scores every row exactly.  Each
batch is placed on the estimator's device as it is yielded.

Single process: the global batch is the local batch.  The prefetch thread,
stream feeds and XShards inputs are not ported yet.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch


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
    arr = np.ascontiguousarray(a)
    if arr.dtype == np.float64:
        arr = arr.astype(np.float32)
    return torch.from_numpy(arr).to(device)


def nrows(v: Any) -> int:
    """The row count of an array or of the first leaf of a tree."""
    if isinstance(v, (tuple, list)):
        return nrows(v[0])
    if isinstance(v, dict):
        return nrows(next(iter(v.values())))
    return len(v)


def _take(a: Any, sel: np.ndarray) -> np.ndarray:
    return np.asarray(a)[sel]


class DataFeed:
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
        self._n = n
        self.global_batch = batch_size
        self._local_batch = max(1, batch_size)
        self.shuffle = shuffle
        self.seed = seed
        self.drop_remainder = drop_remainder

    @staticmethod
    def from_arrays(x: Any, y: Any = None, batch_size: int = 32,
                    **kw: Any) -> "DataFeed":
        data = {"x": x}
        if y is not None:
            data["y"] = y
        return DataFeed(data, batch_size, **kw)

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
        """One epoch's batches, each placed on ``device``."""
        idx = self.epoch_index(epoch_idx)
        for step in range(self.steps_per_epoch()):
            sel = self.batch_index(idx, step)
            yield tree_map(lambda a: to_device(_take(a, sel), device),
                           self._data)


def as_feed(data: Any, batch_size: int, **kw: Any) -> DataFeed:
    """The estimator's accepted data forms as a DataFeed: a DataFeed (as
    is), a dict ``{"x": ..., "y": ...}``, an ``(x, y)`` tuple, or a bare
    array (no labels)."""
    if isinstance(data, DataFeed):
        return data
    if isinstance(data, dict):
        return DataFeed(data, batch_size, **kw)
    if isinstance(data, tuple) and len(data) == 2:
        return DataFeed.from_arrays(data[0], data[1], batch_size, **kw)
    return DataFeed.from_arrays(data, None, batch_size, **kw)
