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

import itertools
import logging
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ... import DeviceLike, resolve_device
from ...convert import buffer_names, to_jax_variables
from ...data.feed import DataFeed, nrows, as_feed, to_device, tree_map
from ...nn import losses as losses_lib
from ...nn import metrics as metrics_lib
from ...nn.layers import _indexed, seed_dropout
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
    "prefetch": (None, f"{_Q1} 5 (prefetch)"),
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
                 grad_accum: int = 1, **knobs: Any):
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

    def _train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss (on the
        device, not synchronised)."""
        if self._opt_state is None:
            self._opt_state = self.optimizer.init(self._params)
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
        self._py_step += 1
        return loss.detach()

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
            validation_data: Any = None, verbose: bool = True,
            **unported: Any) -> Dict[str, List[float]]:
        """Train; returns ``{"loss": [...], "val_<metric>": [...]}``.

        ``data``: a DataFeed, an ``(x, y)`` tuple or an ``{"x", "y"}``
        dict; ``batch_size`` is the global batch.  Only full batches train
        (a feed's padded last batch is skipped, so padding never enters
        batch statistics).  The loss is read back once per epoch, not per
        step."""
        _refuse_unported("fit", unported, _UNPORTED_FIT_ARGS)
        feed = as_feed(data, batch_size, seed=self.seed)
        history: Dict[str, List[float]] = {"loss": []}
        for _ in range(epochs):
            batches = feed.epoch(self.device, self._epoch)
            if not feed.drop_remainder:
                batches = itertools.islice(
                    batches, feed.num_rows // feed._local_batch)
            losses = [self._train_step(batch) for batch in batches]
            if not losses:
                raise ValueError(
                    "fit got no full batches (dataset smaller than one "
                    "batch after dropping the padded tail); reduce "
                    "batch_size")
            self._epoch += 1
            epoch_loss = float(torch.stack(losses).float().mean())
            history["loss"].append(epoch_loss)
            if verbose:
                logger.info("epoch %d: loss=%.4f", self._epoch, epoch_loss)
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


def _per_example_loss(loss_fn: Callable, out: Any, y: Any) -> torch.Tensor:
    """``[batch]`` losses from a mean-reducing loss: each example through
    the loss with a singleton batch dim (``torch.func.vmap``)."""
    def one(o, y1):
        return loss_fn(tree_map(lambda a: a[None], o),
                       tree_map(lambda a: a[None], y1))

    return torch.func.vmap(one)(out, y)


def _pad_remainder(rem: Dict[str, Any], feed: DataFeed):
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
