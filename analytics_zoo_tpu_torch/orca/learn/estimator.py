"""The Estimator: fit/evaluate/predict of a model on one device (port of
``analytics_zoo_tpu/orca/learn/estimator.py``, single-device core).

Same contract as the JAX package's ``ZooEstimator``:

- ``fit`` runs shuffled epochs of fixed-size batches (the remainder
  dropped) and returns ``{"loss": [per-epoch mean], "val_<metric>": ...}``;
- ``evaluate`` scores every row: the last partial batch is padded and its
  padding weighted out by a mask, the loss summed per example;
- ``predict`` returns exactly one output row per input row.

A train step is one forward in training mode (batch norm layers use the
batch's statistics and update their running ones, the buffers), then
``torch.autograd.grad`` of the loss over the parameters and the
optimizer's step (``optimizers.py``: optax's numbers, through
``torch.optim`` where it can be configured to match) in place; the
optimizer never sees a buffer.  With ``grad_accum=k`` (the JAX package's
semantics) the batch splits into ``k`` equal micro-batches, views of the
batch on the device, each a forward and backward; their gradients sum in
f32 buffers made once, are divided by ``k``, and one update is applied;
the step's loss is the mean of the micro losses, and batch norm normalizes
each micro-batch by its own statistics and updates its running ones once
per micro-batch.  A batch that ``k`` does not divide raises.
On the card each train step is a replay of a CUDA graph, the counterpart
of the JAX package's compiled ``_train_step`` (``jax.jit``): the first
step of a (batch shapes, dtypes) key runs eagerly on a side stream as a
real step (it builds the kernels and cuBLAS's workspace, the optimizer's
state and the ``grad_accum`` buffers), then the step is captured into one
graph over static input buffers, with the dropout and augment generators
registered so that a replay draws the masks the eager step would; later
steps copy their batch into the static inputs and replay.  A captured
``fit`` gives the eager ``fit``'s step losses.  Nothing of the step lives
on the host: the optimizer's count and learning rate are device tensors
(``optimizers.py``), and the Python step count moves outside the graph.
A capture that fails raises, naming the last op it reached; nothing falls
back to eager.  ``cuda_graphs=False`` runs the card eagerly (a yardstick);
on the CPU the same entry points run the eager step.  ``_multi_step`` and
``_multi_step_data`` (K steps over one batch, or over a leading-K chunk
placed in one copy) are K of ``_train_step``: on the card K replays of the
one step graph, each after a copy of its batch into the static inputs.
``evaluate`` and ``predict`` run in eval mode (running statistics,
buffers fixed).  Dropout draws its masks from one generator on the
device, seeded from ``seed``, so two runs with one seed repeat their
masks; ``augment`` (a ``data.DeviceAugment`` chain or any ``fn(x,
generator, training)``) runs on each training batch with a second
generator seeded from ``seed``, and deterministically
(``training=False``) on the batches of ``evaluate``/``predict``.  The model runs on ``device``
(``None``: the card).

Constructor knobs of the JAX estimator that are not ported yet raise
``NotImplementedError`` (naming the ROADMAP item) when set to anything but
their default; they are never ignored.  ``save``/``load`` wait for the
checkpoint format (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import inspect
import logging
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ... import DeviceLike, resolve_device
from ...convert import buffer_names, to_jax_variables
from ...core import metrics as telemetry
from ...core import trace as trace_lib
from ...core.config import ZooConfig
from ...data.feed import (FeedBase, PrefetchIterator, as_feed,
                          device_placer, leaves, nrows, to_device, tree_map)
from ...data.stream import make_placer
from ...nn import losses as losses_lib
from ...nn import metrics as metrics_lib
from ...nn.layers import Dropout, _indexed, seed_dropout
from ...ops import _launches
from . import optimizers as opt_lib

logger = logging.getLogger("analytics_zoo_tpu_torch")

_Q1 = "ROADMAP Queue 1 item"
# the JAX estimator's knobs that the port does not take yet: name ->
# (default, where it is scheduled)
_UNPORTED_KNOBS = {
    "sharding": ("dp", f"{_Q1} 7 (sharding)"),
    "nan_policy": (None, f"{_Q1} 7 (nan_policy)"),
    "nan_max_rollbacks": (3, f"{_Q1} 7 (nan_policy)"),
    "grad_compression": (None, f"{_Q1} 7 (grad_compression)"),
    "frozen": (None, f"{_Q1} 7 (frozen)"),
    "profile": (None, f"{_Q1} 7 (profile)"),
    "profile_dir": (None, f"{_Q1} 7 (profile)"),
    "profile_steps": ((10, 20), f"{_Q1} 7 (profile)"),
    "log_dir": (None, f"{_Q1} 7 (summaries)"),
    "app_name": ("train", f"{_Q1} 7 (summaries)"),
    "aux_loss_weight": (0.01, f"{_Q1} 9 (MoE auxiliary losses)"),
    "embedding_lr": (None, f"{_Q1} 8 (sharded embeddings)"),
    "model_dir": (None, f"{_Q1} 6 (state plane)"),
    "preemption_checkpoint": (False, f"{_Q1} 6 (state plane)"),
    "preemption_sync_every": (10, f"{_Q1} 6 (state plane)"),
    "checkpoint_retries": (3, f"{_Q1} 6 (state plane)"),
    "checkpoint_async": (False, f"{_Q1} 6 (state plane)"),
    "checkpoint_inflight": ("latest-wins", f"{_Q1} 6 (state plane)"),
    "checkpoint_keep_last": (3, f"{_Q1} 6 (state plane)"),
    "checkpoint_anchor_every": (0, f"{_Q1} 6 (state plane)"),
    "checkpoint_delta": (True, f"{_Q1} 6 (state plane)"),
    "checkpoint_compact_every": (8, f"{_Q1} 6 (state plane)"),
}
_UNPORTED_FIT_ARGS = {
    "checkpoint_trigger": (None, f"{_Q1} 6 (state plane)"),
    "auto_resume": (False, f"{_Q1} 6 (state plane)"),
    "feature_cols": (None, f"{_Q1} 5 (XShards inputs)"),
    "label_cols": (None, f"{_Q1} 5 (XShards inputs)"),
}


def _refuse_unported(what: str, given: Dict[str, Any],
                     table: Dict[str, tuple]) -> None:
    for name, value in given.items():
        if name not in table:
            raise TypeError(f"{what} got an unexpected argument {name!r}")
        default, item = table[name]
        same = value == default or (
            isinstance(value, (list, tuple))
            and isinstance(default, tuple) and tuple(value) == default)
        if not same:
            raise NotImplementedError(
                f"{what}({name}={value!r}) is not ported yet ({item}); "
                f"only the default {default!r} is taken")


class Estimator:
    """Factory façade, as the JAX package's."""

    @staticmethod
    def from_keras(model: nn.Module, loss: Any, optimizer: Any = "adam",
                   learning_rate: Optional[Any] = None,
                   metrics: Optional[Sequence[Any]] = None,
                   **kwargs: Any) -> "ZooEstimator":
        """An estimator over an ``nn.Module``."""
        return ZooEstimator(model=model, loss=loss, optimizer=optimizer,
                            learning_rate=learning_rate, metrics=metrics,
                            **kwargs)

    from_fn = from_keras


class ZooEstimator:
    """The single concrete estimator, on one device."""

    def __init__(self, model: nn.Module, loss: Any, optimizer: Any = "adam",
                 learning_rate: Optional[Any] = None,
                 metrics: Optional[Sequence[Any]] = None,
                 grad_clip_norm: Optional[float] = None, seed: int = 0,
                 device: DeviceLike = None, augment: Any = None,
                 grad_accum: int = 1, cuda_graphs: bool = True,
                 **knobs: Any):
        _refuse_unported("ZooEstimator", knobs, _UNPORTED_KNOBS)
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        self.grad_accum = int(grad_accum)
        self._grad_sum: Optional[List[torch.Tensor]] = None
        self.device = resolve_device(device)
        self.augment = augment
        self.model = model.to(self.device)
        self.loss_fn = losses_lib.get(loss)
        self.optimizer = opt_lib.get(optimizer, learning_rate,
                                     grad_clip_norm)
        self.metrics = [metrics_lib.get(m) for m in (metrics or [])]
        self.seed = seed
        seed_dropout(self.model, seed, self.device)
        self._aug_gen = torch.Generator(
            device=_indexed(self.device)).manual_seed(int(seed))
        self._params: List[nn.Parameter] = list(self.model.parameters())
        self._opt_state: Any = None
        self._epoch = 0
        self._py_step = 0
        # False trains the card eagerly too (a yardstick for the graphs)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._graphs: Dict[tuple, _StepGraph] = {}
        self._pool = None  # one memory pool for this estimator's graphs
        self._placer = None  # _multi_step_data's copies to the card
        # captures made: the counterpart of the JAX package's executable
        # cache probe (_jit_cache_size); one per (batch shapes, dtypes) key
        self.capture_count = 0

    # -- steps ----------------------------------------------------------------

    def _loss_and_grads(self, x: Any, y: Any) -> tuple:
        """One forward in training mode and the gradient of its loss over
        the parameters (None where the loss does not reach one)."""
        if self.augment is not None:
            x = self.augment(x, self._aug_gen, training=True)
        loss = self.loss_fn(self.model(x), y)
        return loss, torch.autograd.grad(loss, self._params,
                                         allow_unused=True)

    def _accumulated(self, batch: Dict[str, Any]) -> tuple:
        """``grad_accum`` micro-batches of ``batch`` (views, no copy), each
        a forward and backward; returns the mean micro loss and the f32 sum
        of the gradients divided by ``grad_accum``, in buffers made at the
        first step and reused."""
        accum = self.grad_accum
        n = nrows(batch["x"])
        if n % accum:
            raise ValueError(f"batch size {n} is not divisible by "
                             f"grad_accum={accum}")
        m = n // accum
        if self._grad_sum is None:
            self._grad_sum = [torch.zeros_like(p, dtype=torch.float32)
                              for p in self._params]
        else:
            for s in self._grad_sum:
                s.zero_()
        losses = []
        for i in range(accum):
            micro = tree_map(lambda a: a[i * m:(i + 1) * m], batch)
            loss, grads = self._loss_and_grads(micro["x"], micro["y"])
            with torch.no_grad():
                for s, g in zip(self._grad_sum, grads):
                    if g is not None:
                        s.add_(g)
            losses.append(loss.detach())
        with torch.no_grad():
            grads = []
            for s, p in zip(self._grad_sum, self._params):
                s.div_(accum)
                grads.append(s if s.dtype == p.dtype else s.to(p.dtype))
        return torch.stack(losses).mean(), grads

    def _step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step on ``batch`` (what a graph captures): the
        loss, on the device."""
        self.model.train()
        if self.grad_accum > 1:
            loss, grads = self._accumulated(batch)
        else:
            loss, grads = self._loss_and_grads(batch["x"], batch["y"])
        with torch.no_grad():
            # a parameter the loss does not reach has a zero gradient, as
            # in JAX
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, self._params)]
            self._opt_state = self.optimizer.step(self._params, grads,
                                                  self._opt_state)
        return loss.detach()

    def _graph_for(self, batch: Dict[str, Any]) -> Tuple[
            "_StepGraph", List[torch.Tensor], Optional[torch.Tensor]]:
        """The step graph of ``batch``'s key and the batch's leaves; a new
        key runs its first step eagerly (the third item, its loss) and is
        captured."""
        if self._opt_state is None:
            self._opt_state = self.optimizer.init(self._params)
        flat = [to_device(a, self.device) if not isinstance(a, torch.Tensor)
                else a for a in leaves(batch)]
        key = (_structure(batch),
               tuple((tuple(t.shape), t.dtype) for t in flat))
        graph = self._graphs.get(key)
        if graph is not None:
            return graph, flat, None
        graph = _StepGraph(self, batch, flat)
        self._graphs[key] = graph
        self.capture_count += 1
        return graph, flat, graph.first_loss

    def _train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss (on the
        device, not synchronised).  On the card: a replay of the key's
        graph."""
        if not self.cuda_graphs:
            if self._opt_state is None:
                self._opt_state = self.optimizer.init(self._params)
            loss = self._step(batch)
        else:
            graph, flat, loss = self._graph_for(batch)
            if loss is None:
                graph.load(flat)
                loss = graph.replay().clone()
        self._py_step += 1
        return loss

    def _multi_step(self, batch: Dict[str, Any], k: int) -> torch.Tensor:
        """``k`` optimizer steps on one ``batch`` (the JAX package's
        ``lax.scan`` over ``_train_step``): ``k`` of ``_train_step``, on the
        card ``k`` replays of the key's graph.  Returns the ``k`` losses as
        one device tensor, not synchronised."""
        if k < 1:
            raise ValueError(f"k must be >= 1, got {k}")
        return torch.stack([self._train_step(batch) for _ in range(k)])

    def _multi_step_data(self, batches: Dict[str, Any]) -> torch.Tensor:
        """``K`` optimizer steps over ``K`` distinct batches, the leading
        axis of every leaf of ``batches`` (host arrays or device tensors),
        step ``i`` on slice ``i``: the infeed-chunk pattern, the chunk
        placed in one host-to-device copy a leaf.  On the card a host
        chunk is staged in pinned memory and copied on a side stream,
        which the steps wait for; so the copy overlaps the steps already
        queued.  Returns the ``K`` losses as one device tensor."""
        if self.device.type == "cuda" and not any(
                isinstance(a, torch.Tensor) for a in leaves(batches)):
            if self._placer is None:
                self._placer = device_placer(self.device)
            chunk = self._placer(batches).wait()
        else:
            chunk = tree_map(lambda a: a.to(self.device)
                             if isinstance(a, torch.Tensor)
                             else to_device(a, self.device), batches)
        return torch.stack([self._train_step(tree_map(lambda a: a[i], chunk))
                            for i in range(nrows(chunk["x"]))])

    def _forward_eval(self, x: Any) -> Any:
        if self.augment is not None:
            x = self.augment(x, None, training=False)
        return self.model(x)

    def _eval_step(self, batch: Dict[str, Any],
                   mask: torch.Tensor) -> List[torch.Tensor]:
        out = self._forward_eval(batch["x"])
        per_ex = _per_example_loss(self.loss_fn, out, batch["y"])
        stats = [torch.stack([(per_ex * mask).sum(), mask.sum()])]
        for m in self.metrics:
            stats.append(m.update(out, batch["y"], mask))
        return stats

    # -- training -------------------------------------------------------------

    def fit(self, data: Any, epochs: int = 1, batch_size: int = 32,
            validation_data: Any = None, prefetch: Optional[int] = None,
            verbose: bool = True,
            **unported: Any) -> Dict[str, List[float]]:
        """Train; returns ``{"loss": [...], "val_<metric>": [...]}``.

        ``data``: a feed (``DataFeed``, ``StreamingDataFeed``), an ``(x,
        y)`` tuple or an ``{"x", "y"}`` dict; ``batch_size`` is the global
        batch.  Only full batches train (a feed's padded last batch is
        skipped, so padding never enters batch statistics).  The loss is
        read back once per epoch, not per step.

        ``prefetch``: the feed's lookahead depth (default
        ``ZooConfig.prefetch``, 2): a producer thread runs the feed's epoch
        (for a streaming feed, its host batches and their placement: on the
        card pinned staging and a copy on a side stream, which the step's
        stream waits for) while the card runs the step, so
        ``train.data_wait_ms`` measures only time the loop waited on the
        feed.  ``prefetch=0`` iterates the feed inline on this thread.
        Every step records ``train.steps``, ``train.samples``,
        ``train.step_ms`` and ``train.data_wait_ms`` (and the gauge
        ``train.prefetch_depth``) in ``core/metrics.py``'s registry, and a
        ``train.step`` span under its epoch's ``train.epoch`` span."""
        _refuse_unported("fit", unported, _UNPORTED_FIT_ARGS)
        if prefetch is None:
            prefetch = ZooConfig.prefetch
        feed = as_feed(data, batch_size, seed=self.seed)
        # a feed that pads its last batch trains on its full batches only
        full = feed.steps_per_epoch() if feed.drop_remainder \
            else feed.num_rows // feed._local_batch
        reg = telemetry.get_registry()
        m_step = reg.histogram("train.step_ms")
        m_wait = reg.histogram("train.data_wait_ms")
        m_steps = reg.counter("train.steps")
        m_samples = reg.counter("train.samples")
        m_prefetch = reg.gauge("train.prefetch_depth")
        record_spans = trace_lib.enabled and reg.enabled
        fit_tid = trace_lib.new_trace_id() if record_spans else None
        fit_sid = trace_lib.new_span_id() if record_spans else None
        self.trace_id = fit_tid
        history: Dict[str, List[float]] = {"loss": []}
        for _ in range(epochs):
            epoch_sid = trace_lib.new_span_id() if record_spans else None
            t0 = time.monotonic()
            losses: List[torch.Tensor] = []
            epoch_wait = 0.0
            if prefetch and prefetch > 0 and _supports_host_epoch(feed):
                # stream feeds: host batches, placed in the producer
                batch_iter = PrefetchIterator(
                    feed.epoch(self.device, self._epoch, place=False),
                    depth=prefetch, gauge=m_prefetch,
                    place=make_placer(self.device))
            elif prefetch and prefetch > 0:
                batch_iter = PrefetchIterator(
                    iter(feed.epoch(self.device, self._epoch)),
                    depth=prefetch, gauge=m_prefetch)
            else:
                batch_iter = iter(feed.epoch(self.device, self._epoch))
            try:
                while True:
                    t_fetch = time.monotonic()
                    batch = next(batch_iter, None)
                    if batch is None:
                        break
                    wait = time.monotonic() - t_fetch
                    epoch_wait += wait
                    m_wait.observe(wait * 1000.0)
                    if "mask" in batch:  # a padded batch: never trained on
                        continue
                    if len(losses) == full:  # the padded last batch
                        break
                    losses.append(self._train_step(batch))
                    step_ms = (time.monotonic() - t_fetch) * 1000.0
                    m_step.observe(step_ms)
                    if record_spans:
                        trace_lib.record(
                            fit_tid, "train.step",
                            {"step": self._py_step,
                             "step_ms": round(step_ms, 3),
                             "data_wait_ms": round(wait * 1000.0, 3)},
                            parent=epoch_sid, dur_ms=step_ms)
                    m_steps.inc()
                    m_samples.inc(feed.global_batch)
            finally:
                # a mid-epoch exit must not leak the producer thread
                if isinstance(batch_iter, PrefetchIterator):
                    batch_iter.close()
                else:
                    close = getattr(batch_iter, "close", None)
                    if close is not None:
                        close()
            if not losses:
                raise ValueError(
                    "fit got no full batches (dataset smaller than one "
                    "batch after dropping the padded tail); reduce "
                    "batch_size")
            self._epoch += 1
            # one host synchronisation an epoch
            epoch_loss = float(torch.stack(losses).float().mean())
            history["loss"].append(epoch_loss)
            dt = time.monotonic() - t0
            if record_spans:
                trace_lib.record(
                    fit_tid, "train.epoch",
                    {"epoch": self._epoch, "loss": round(epoch_loss, 6),
                     "steps": len(losses),
                     "step_ms": round(1000.0 * dt / len(losses), 3),
                     "data_wait_ms": round(
                         1000.0 * epoch_wait / len(losses), 3)},
                    span_id=epoch_sid, parent=fit_sid, dur_ms=dt * 1000.0)
            if verbose:
                logger.info("epoch %d: loss=%.4f (%.1f examples/s)",
                            self._epoch, epoch_loss,
                            len(losses) * feed.global_batch / dt)
            if validation_data is not None:
                for k, v in self.evaluate(validation_data,
                                          batch_size).items():
                    history.setdefault(f"val_{k}", []).append(v)
        return history

    # -- evaluation -----------------------------------------------------------

    def evaluate(self, data: Any, batch_size: int = 32) -> Dict[str, float]:
        """Exact metrics over every row: the last partial batch is padded
        to the batch shape and its padding weighted out by a mask."""
        feed = as_feed(data, batch_size, shuffle=False, seed=self.seed,
                       drop_remainder=False)
        totals: Optional[List[torch.Tensor]] = None

        def accumulate(totals, batch, mask):
            stats = self._eval_step(batch, to_device(mask, self.device))
            return stats if totals is None else \
                [a + b for a, b in zip(totals, stats)]

        self.model.eval()
        with torch.no_grad():
            for step, batch in enumerate(feed.epoch(self.device, 0)):
                totals = accumulate(totals, batch, feed.step_mask(step))
            if feed.drop_remainder:
                # a user-constructed training feed: cover the rows its
                # epoch 0 drops with one padded, masked batch
                rem = feed.dropped_rows(0)
                if rem is not None:
                    batch, mask = _pad_remainder(rem, feed)
                    totals = accumulate(
                        totals, tree_map(lambda a: to_device(a, self.device),
                                         batch), mask)
        if totals is None:
            raise ValueError("evaluate got no batches")
        out = {"loss": float(totals[0][0] / torch.clamp(totals[0][1],
                                                        min=1.0))}
        for m, stat in zip(self.metrics, totals[1:]):
            out[m.name] = float(m.result(stat))
        return out

    # -- inference ------------------------------------------------------------

    def predict(self, data: Any, batch_size: int = 32) -> np.ndarray:
        """Forward over all rows, in order: exactly one output row per
        input row (the last batch padded, then trimmed)."""
        feed = as_feed(data, batch_size, shuffle=False, drop_remainder=False)
        if feed.shuffle:
            raise ValueError("predict needs row order preserved: construct "
                             "the feed with shuffle=False")
        outs: List[np.ndarray] = []
        self.model.eval()
        with torch.no_grad():
            for batch in feed.epoch(self.device, 0):
                outs.append(_to_numpy(self._forward_eval(batch["x"])))
            if feed.drop_remainder:
                rem = feed.remainder()
                if rem is not None:  # tail rows the epoch skipped
                    outs.append(_to_numpy(self._forward_eval(tree_map(
                        lambda a: to_device(a, self.device), rem["x"]))))
        return np.concatenate(outs, axis=0)[:feed.num_rows]

    # -- state ----------------------------------------------------------------

    def get_model(self) -> Dict[str, Any]:
        """The current variables as the JAX tree ``{"params", "state"}``
        of numpy arrays (``convert.to_jax_variables``): parameters under
        ``"params"``, buffers (batch norm's running statistics) under
        ``"state"``."""
        return to_jax_variables(self.model.state_dict(),
                                buffer_names(self.model))

    def save(self, path: Optional[str] = None) -> str:
        raise NotImplementedError(
            f"Estimator.save is not ported yet ({_Q1} 6: the checkpoint "
            "format comes with the state plane)")

    def load(self, path: Optional[str] = None) -> None:
        raise NotImplementedError(
            f"Estimator.load is not ported yet ({_Q1} 6: the checkpoint "
            "format comes with the state plane)")


def _structure(tree: Any) -> Any:
    """The nesting of a batch without its leaves: part of a graph's key."""
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return (type(tree).__name__,) + tuple(_structure(v) for v in tree)
    return None


def _rebuild(tree: Any, flat: List[Any]) -> Any:
    """``tree``'s nesting with the leaves of ``flat``, in ``leaves``'
    order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def _failed_at(err: BaseException) -> str:
    """Where a capture failed and why: the first error of the chain (an op
    the capture refused; ending the capture then fails too), at the
    innermost call of its traceback outside torch itself, as ``file:line
    (function): code: error``."""
    while err.__context__ is not None:
        err = err.__context__
    frames = traceback.extract_tb(err.__traceback__)
    ours = [f for f in frames if "/torch/" not in f.filename] or frames
    f = ours[-1]
    return f"{f.filename}:{f.lineno} ({f.name}): {f.line}: {err}"


class _StepGraph:
    """One (batch shapes, dtypes) key's captured train step: static input
    buffers, the step's graph in the estimator's memory pool, its loss as
    a static output, and the kernel launches its capture recorded
    (``ops._launches``), made again at each replay.

    Made from the key's first batch: the batch is copied into the static
    inputs, the step runs once eagerly on a side stream as a real step
    (``first_loss``), and the same step is captured on that stream with
    the model's dropout generator and the augment generator registered, so
    that each replay draws the random numbers the next eager step would."""

    def __init__(self, est: "ZooEstimator", batch: Dict[str, Any],
                 flat: List[torch.Tensor]):
        device = est.device
        current = torch.cuda.current_stream(device)
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in flat]
        self.load(flat)
        static_batch = _rebuild(batch, self.static)
        side = torch.cuda.Stream(device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            first = est._step(static_batch).clone()
        first.record_stream(current)
        self.first_loss = first
        if est._pool is None:
            est._pool = torch.cuda.graph_pool_handle()
        self.graph = torch.cuda.CUDAGraph()
        for gen in _generators(est):
            self.graph.register_generator_state(gen)
        try:
            with _launches.recording(side) as self.launches:
                with torch.cuda.graph(self.graph, pool=est._pool,
                                      stream=side,
                                      capture_error_mode="thread_local"):
                    self.loss = est._step(static_batch)
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of the train step failed at "
                f"{_failed_at(e)}") from e
        current.wait_stream(side)

    def load(self, flat: List[torch.Tensor]) -> None:
        """Copy a batch's leaves into the static inputs (on the current
        stream)."""
        for s, t in zip(self.static, flat):
            s.copy_(t, non_blocking=True)

    def replay(self) -> torch.Tensor:
        """One step on what the static inputs hold; returns the static
        loss, which the next replay overwrites."""
        self.graph.replay()
        _launches.replay(self.launches)
        return self.loss


def _generators(est: "ZooEstimator") -> List[torch.Generator]:
    """The card's generators a step draws from besides the default one:
    the model's dropout generators and the augment generator."""
    gens = {id(m.generator): m.generator for m in est.model.modules()
            if isinstance(m, Dropout) and m.generator is not None}
    if est.augment is not None:
        gens[id(est._aug_gen)] = est._aug_gen
    return [g for g in gens.values() if g.device.type == "cuda"]


def _supports_host_epoch(feed: Any) -> bool:
    """Can this feed yield host batches (``epoch(..., place=False)``)?
    True for ``StreamingDataFeed``; in-memory feeds place their own."""
    try:
        return "place" in inspect.signature(feed.epoch).parameters
    except (TypeError, ValueError):
        return False


def _per_example_loss(loss_fn: Callable, out: Any, y: Any) -> torch.Tensor:
    """``[batch]`` losses from a mean-reducing loss: each example through
    the loss with a singleton batch dim (``torch.func.vmap``)."""
    def one(o, y1):
        return loss_fn(tree_map(lambda a: a[None], o),
                       tree_map(lambda a: a[None], y1))

    return torch.func.vmap(one)(out, y)


def _pad_remainder(rem: Dict[str, Any], feed: FeedBase):
    """Remainder rows as one full batch (the last row repeated) and its
    mask."""
    r = nrows(rem["x"])
    lb = feed._local_batch

    def pad(a):
        a = np.asarray(a)
        return np.concatenate([a, np.repeat(a[-1:], lb - r, axis=0)], axis=0)

    mask = np.zeros((lb,), np.float32)
    mask[:r] = 1.0
    return tree_map(pad, rem), mask


def _to_numpy(out: torch.Tensor) -> np.ndarray:
    if out.dtype == torch.bfloat16:  # numpy has no bf16
        out = out.float()
    return out.cpu().numpy()
