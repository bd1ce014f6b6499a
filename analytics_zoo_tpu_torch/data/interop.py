"""Foreign input-pipeline interop (port of
``analytics_zoo_tpu/data/interop.py``): tf.data, torch Dataset/DataLoader
and plain Python iterables as the port's feeds.

Reference (SURVEY.md §2.2): "orca TF Dataset" wrapped ``tf.data.Dataset``
for the TF estimators (pyzoo/zoo/orca/data/tf/data.py), TFPark's
``TFDataset`` fed per-worker queues, and the torch estimators took
``data_creator`` functions returning DataLoaders
(pyzoo/zoo/orca/learn/pytorch/).

Every foreign source becomes one of two feeds:

- map-style sources (torch ``Dataset.__getitem__``) ride
  ``StreamingDataFeed``: native-queue prefetch, decode workers, step-order
  delivery, with the foreign object only supplying ``load_sample``;
- stream-style sources (``tf.data.Dataset``, generators, torch
  ``IterableDataset``) ride ``IterableDataFeed``: re-batched to the global
  batch, the final partial batch padded and masked so ``evaluate`` stays
  exact.

TensorFlow is not a dependency: ``from_tf_dataset`` imports it lazily and
raises a clear error when absent.  One process only: the JAX package's
agreement between processes on the number of batches (an allgather each
batch) comes with several processes, ROADMAP Queue 1 item 7; until then
an ``IterableDataFeed`` raises when ``torch.distributed`` runs more than
one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, Optional

import numpy as np
import torch

from .feed import FeedBase, to_device, tree_map
from .readers import process_grid


def _as_sample_dict(elem: Any) -> Dict[str, Any]:
    if isinstance(elem, dict):
        return elem
    if isinstance(elem, (tuple, list)):
        if len(elem) == 2:
            return {"x": elem[0], "y": elem[1]}
        if len(elem) == 1:
            return {"x": elem[0]}
        raise ValueError(
            f"sample tuples must be (x,) or (x, y); got {len(elem)} items")
    return {"x": elem}


class IterableDataFeed(FeedBase):
    """Unknown-length sample stream -> fixed-shape batches on a device.

    ``make_iter(epoch_idx)`` returns a fresh iterator of samples (dicts,
    (x, y) tuples, or bare arrays).  The final partial batch is padded to
    the static shape (its last row repeated) and carries a ``mask`` entry
    weighting padding rows 0 (``Estimator.evaluate`` consumes it for exact
    metrics, ``fit`` skips the batch); with ``drop_remainder`` the tail is
    dropped instead.  After one pass the true row count is known
    (``num_rows``), which ``Estimator.predict`` reads after iterating;
    until then ``steps_per_epoch()`` is -1."""

    def __init__(self, make_iter: Callable[[int], Iterator[Any]],
                 batch_size: int, drop_remainder: bool = False,
                 seed: int = 0, pre_sharded: bool = False):
        """``pre_sharded``: the iterator already yields only this
        process's samples (the JAX package's knob for several processes;
        one process reads the whole stream either way)."""
        super().__init__(num_samples=0, batch_size=batch_size,
                         shuffle=False, seed=seed,
                         drop_remainder=drop_remainder)
        self._make_iter = make_iter
        self.pre_sharded = pre_sharded

    def steps_per_epoch(self) -> int:
        if self._n:
            return super().steps_per_epoch()
        return -1  # unknown until one pass completes

    def remainder(self) -> Optional[Dict[str, np.ndarray]]:
        return None  # the padded+masked final batch covers the tail

    def step_mask(self, step: int) -> np.ndarray:
        # masks are attached by epoch() itself (length unknown up front)
        return np.ones((self._local_batch,), np.float32)

    def epoch(self, device: torch.device, epoch_idx: int = 0
              ) -> Iterator[Dict[str, Any]]:
        """One pass over the stream as batches on ``device``."""
        if process_grid()[1] > 1:
            raise NotImplementedError(
                "IterableDataFeed over several processes is not ported yet "
                "(ROADMAP Queue 1 item 7: the processes' agreement on the "
                "batch count); run one process")
        it = self._make_iter(epoch_idx)
        lb = self._local_batch
        count = 0
        pending = None
        exhausted = False

        def flush(batch_rows, n_real, include_mask):
            batch = {k: np.stack([np.asarray(r[k]) for r in batch_rows])
                     for k in batch_rows[0]}
            if include_mask:
                m = np.zeros((len(batch_rows),), np.float32)
                m[:n_real] = 1.0
                batch["mask"] = m
            return tree_map(lambda a: to_device(a, device), batch)

        while True:
            rows: list = []
            while len(rows) < lb and not exhausted:
                try:
                    rows.append(_as_sample_dict(next(it)))
                    count += 1
                except StopIteration:
                    exhausted = True
            n_real = len(rows)
            if n_real == 0:
                break
            include_mask = n_real < lb
            if include_mask and self.drop_remainder:
                break
            if n_real < lb:
                rows = rows + [rows[-1]] * (lb - n_real)
            if pending is not None:
                yield pending  # one-batch lookahead, like DataFeed
            pending = flush(rows, n_real, include_mask)
            if exhausted:
                break
        self._n = count
        if pending is not None:
            yield pending


def from_iterator(make_iter: Callable[[int], Iterator[Any]],
                  batch_size: int, **kw: Any) -> IterableDataFeed:
    """Generic stream -> feed.  ``make_iter(epoch_idx)`` yields samples."""
    return IterableDataFeed(make_iter, batch_size, **kw)


def from_tf_dataset(dataset: Any, batch_size: int, batched: bool = False,
                    **kw: Any) -> IterableDataFeed:
    """``tf.data.Dataset`` -> feed.

    Elements map like any sample: dict passthrough, (x, y) tuple, or a
    single tensor.  Pass ``batched=True`` for a dataset that already went
    through ``.batch(...)``: it is unbatched and re-batched to the global
    batch.  No shape-based guessing: a leading None dim also legitimately
    means ragged sequences.  Re-iterated per epoch, so shuffling and
    augmentation inside the tf pipeline re-apply each epoch."""
    try:
        import tensorflow as tf  # noqa: F401  (optional dependency)
    except ImportError as e:
        raise ImportError(
            "from_tf_dataset needs tensorflow installed "
            "(pip install analytics-zoo-tpu[tf])") from e
    if batched:
        dataset = dataset.unbatch()

    def make_iter(epoch_idx: int):
        return iter(dataset.as_numpy_iterator())

    return IterableDataFeed(make_iter, batch_size, **kw)


def from_torch_dataset(dataset: Any, batch_size: int, shuffle: bool = True,
                       num_workers: int = 4, seed: int = 0,
                       **kw: Any):
    """Map-style ``torch.utils.data.Dataset`` -> StreamingDataFeed (native-
    queue prefetch and decode workers run ``dataset[i]`` off the critical
    path).  Iterable-style datasets go through ``IterableDataFeed``."""
    if hasattr(dataset, "__getitem__") and hasattr(dataset, "__len__"):
        from .stream import StreamingDataFeed

        def load_sample(i: int, rng=None) -> Dict[str, np.ndarray]:
            return _to_numpy_sample(dataset[i])

        return StreamingDataFeed(len(dataset), load_sample, batch_size,
                                 shuffle=shuffle, num_workers=num_workers,
                                 seed=seed, **kw)
    return IterableDataFeed(lambda e: iter(dataset), batch_size,
                            seed=seed, **kw)


def from_torch_dataloader(loader: Any, batch_size: Optional[int] = None,
                          **kw: Any) -> IterableDataFeed:
    """``torch.utils.data.DataLoader`` -> feed.  The loader's own batching
    is flattened back to samples, then re-batched to the global batch."""
    bs = batch_size or getattr(loader, "batch_size", None) or 32

    def make_iter(epoch_idx: int):
        for batch in loader:
            sample = _to_numpy_sample(batch)
            n = len(next(iter(sample.values())))
            for i in range(n):
                yield {k: v[i] for k, v in sample.items()}

    return IterableDataFeed(make_iter, bs, **kw)


def _to_numpy_sample(elem: Any) -> Dict[str, np.ndarray]:
    def to_np(v):
        if hasattr(v, "detach"):  # torch tensor
            return v.detach().cpu().numpy()
        return np.asarray(v)

    sample = _as_sample_dict(elem)
    return {k: to_np(v) for k, v in sample.items()}
