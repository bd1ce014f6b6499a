"""The Estimator: fit/evaluate/predict of a model on one device (port of
``analytics_zoo_tpu/orca/learn/estimator.py``, single-device core).

Same contract as the JAX package's ``ZooEstimator``:

- ``fit`` runs shuffled epochs of fixed-size batches (the remainder
  dropped, or with a ``DataFeed(drop_remainder=False)`` wrap-padded into
  the last batch, which trains) and returns ``{"loss": [per-epoch mean],
  "val_<metric>": ...}``;
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

A model with ``parallel.ShardedEmbedding`` tables trains them on the sparse
path (the JAX package's): the dense optimizer never sees a table; the
forward runs under ``embedding.inject_taps``, the gradient is taken over
the dense parameters and each lookup's gathered unique rows, and each
table gets ``index_add_`` of ``-embedding_lr`` times its rows' gradient on
the unique ids, inside the same step (and the same CUDA graph).
``sharding=embedding_row_rules()`` is taken (one card holds every table
whole).  ``fit``/``evaluate``/``predict`` take ``XShards`` (of DataFrames
with ``feature_cols``/``label_cols``).

``fit``, ``evaluate``, ``predict``, ``save``, ``load`` and a trigger's
save run their whole bodies under one process-wide reentrant lock, the JAX
package's ``_device_lock``: estimators driven from several threads (the
automl trials) never capture, replay or allocate in a graph pool at the
same time.

``frozen=`` (a list of parameter-path prefixes, matched on ``/``-joined
component boundaries, or a predicate of the path) takes the matched
parameters out of the step: no gradient is taken over them, the optimizer
never sees them (no update, no weight decay), and the optimizer's state in
a checkpoint is ``optax.multi_transform``'s tree (``opt_lib.Masked``), so
a frozen estimator's checkpoint loads in either package.  Buffers (batch
norm's running statistics) still update, as the JAX package's ``state``
does.

The JAX estimator's single-device knobs are taken as it takes them:

- ``nan_policy="skip_step"`` keeps the step's pre-step state inside the
  step (and its CUDA graph): the dense parameters, the model's buffers
  (batch norm's running statistics, which the forward moves before the
  verdict is known) and every tensor of the optimizer's state are copied
  into buffers made once, and after the update each is set back to its
  copy where ``ok = isfinite(loss) & isfinite(global_norm(grads, row
  grads))`` is false, by ``torch.where`` on the device; the sparse
  tables' row gradients are zeroed where ``ok`` is false, and an int32
  ``bad_steps`` counter on the device adds ``1 - ok``.  Nothing reads
  ``ok`` on the host: a poisoned step is one replay like any other.
  ``"warn"``, ``"raise"`` and ``"rollback"`` read the loss (with the
  gradient norm folded into it) once a step; ``"rollback"`` reloads the
  newest ``model_dir`` checkpoint in place, at most
  ``nan_max_rollbacks`` times, then raises ``NonFiniteLossError``.
- ``fit`` fires the fault points ``worker.crash``, ``worker.hang`` and
  ``step.nan`` (which NaN-fills the batch's float leaves) before each
  step, and on an unhandled exception dumps the flight record
  (``core/flightrec.py``) into ``model_dir`` and re-raises.
- ``profile=`` counts new step keys (a capture on the card) as
  ``train.compiles`` with a ``train.compile`` span, sets the ``train.mfu``
  gauge each epoch, and with ``trace_dir``/``trace_steps`` (or
  ``profile_dir``/``profile_steps``) records steps ``[start, end)`` with
  ``torch.profiler`` into a Chrome trace, the device synchronised before
  the window opens and before it closes, so the window holds whole
  replays.
- ``log_dir``/``app_name`` write the per-epoch scalars through
  ``core/summary.py`` (``get_train_summary``, ``get_validation_summary``).

Over several processes (``core/context.py``'s ``init_orca_context``) the
estimator trains one global batch a step across the mesh's ranks:
``sharding=`` ``"dp"``, ``"fsdp"``, ``"tp"``, ``"tp+fsdp"``, ``"2d"`` or a
rule list, and ``grad_compression=`` ``None``, ``"none"``, ``"bf16"`` or
``"int8"``, as ``scaleout.py`` describes (the batch sharded, batch norm over
the global batch, gradients all-reduced, rule-placed leaves kept as this
rank's pieces, the quantized wire and its residuals).  ``evaluate``
returns the global metrics and ``predict`` this process's rows; the fit
beats the supervisor's heartbeat (``core.context.heartbeat``), and meters
``train.grad_bytes`` a step and ``train.comm_ms`` an epoch under
``grad_compression``.  A checkpoint over several processes is the JAX
package's multi-process layout, written collectively
(``checkpoint_async`` falls back to it).  The MoE layers' knob
(``aux_loss_weight``) raises ``NotImplementedError`` (naming its ROADMAP
item) when set to anything but its default; it is never ignored.

The state plane is the JAX package's: ``save``/``load`` write and read
``core/checkpoint.py``'s format (the JAX estimator's tree: ``params`` and
``state`` in the JAX layout, ``opt_state`` in optax's layout, ``step``,
``rng``, ``bad_steps``, ``extra={"epoch"}``; a checkpoint of either
package loads in the other), ``fit(checkpoint_trigger=)`` saves on a
``Trigger``, ``checkpoint_async=True`` routes saves through
``core/ckpt_manager.py`` (snapshots written by a background thread, delta
generations of the ShardedEmbedding rows touched since the last accepted
save), ``preemption_checkpoint=True`` checkpoints on SIGTERM/SIGINT and
raises ``Preempted``, and ``fit(auto_resume=True)`` resumes from
``model_dir`` with ``epochs`` the total target.  A load copies into the
live tensors (parameters, buffers, the optimizer's moments, ``step`` and
count tensors, the touched-row masks) and sets the generators' states
through the generators themselves, so the captured graphs go on replaying
against the loaded state.  The port's dropout and augment generators ride
the checkpoint under ``torch_generators``, a key the JAX estimator does
not read (its ``rng`` is the JAX key of ``seed``, which a JAX step never
advances); a checkpoint without it reseeds them from ``seed``.
"""

from __future__ import annotations

import functools
import inspect
import logging
import math
import os
import threading
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ... import DeviceLike, collector_held, resolve_device
from ...convert import buffer_names, from_jax_variables, jax_tree, \
    jax_variables, to_jax_variables
from ...core import checkpoint as ckpt_io
from ...core import faults as faults_lib
from ...core import metrics as telemetry
from ...core import trace as trace_lib
from ...core.config import ZooConfig
from ...core.context import config_default, current_mesh, heartbeat
from ...data.feed import (FeedBase, PrefetchIterator, as_feed,
                          device_placer, leaves, nrows, shard_batch,
                          to_device, tree_map)
from ...data.shards import XShards
from ...data.stream import make_placer
from ...nn import losses as losses_lib
from ...nn import metrics as metrics_lib
from ...nn.layers import Dropout, _indexed, seed_dropout
from ...ops import _launches
from ...parallel import embedding as emb_lib
from . import optimizers as opt_lib
from .scaleout import Scaleout, one_process
from .trigger import Trigger

logger = logging.getLogger("analytics_zoo_tpu_torch")

_Q1 = "ROADMAP Queue 1 item"
# the JAX estimator's knobs that the port does not take yet: name ->
# (default, where it is scheduled)
_UNPORTED_KNOBS = {
    "aux_loss_weight": (0.01, f"{_Q1} 9 (MoE auxiliary losses)"),
}

#: Valid values for ``ZooEstimator(nan_policy=...)``.
NAN_POLICIES = ("warn", "skip_step", "rollback", "raise")

#: Per-device peak FLOP/s, the ``train.mfu`` denominator when neither
#: ``profile["peak_flops"]`` nor ``ZooConfig.device_peak_flops`` is set.
#: "cpu" is the JAX package's nominal figure (a trend signal only).
#: "gpu" holds published dense rates by card (a substring of
#: ``torch.cuda.get_device_name``) and compute dtype: the H100 SXM's
#: bf16/f16 tensor-core rate and its f32 rate outside the tensor cores.
#: On a card not listed no peak is known and ``train.mfu`` stays unset.
NOMINAL_PEAK_FLOPS = {
    "cpu": 5e10,
    "gpu": {"H100": {torch.bfloat16: 989e12, torch.float16: 989e12,
                     torch.float32: 67e12}},
}


def nominal_peak_flops(device: torch.device,
                       dtype: torch.dtype) -> Optional[float]:
    """``NOMINAL_PEAK_FLOPS``' figure for ``device`` computing in
    ``dtype``; None for a card or dtype the table does not list."""
    if device.type != "cuda":
        return NOMINAL_PEAK_FLOPS["cpu"]
    name = torch.cuda.get_device_name(device)
    for card, rates in NOMINAL_PEAK_FLOPS["gpu"].items():
        if card in name:
            return rates.get(dtype)
    return None


def _compute_dtype(model: nn.Module) -> torch.dtype:
    """The dtype a model computes in: the first floating ``dtype`` that a
    module of it declares (BERT's, ResNet's), else its first floating
    parameter's."""
    for m in model.modules():
        dt = getattr(m, "dtype", None)
        if isinstance(dt, torch.dtype) and dt.is_floating_point:
            return dt
    for p in model.parameters():
        if p.is_floating_point():
            return p.dtype
    return torch.float32


class NonFiniteLossError(RuntimeError):
    """A training step produced a non-finite loss and the configured
    ``nan_policy`` could not (or was told not to) heal it."""

    def __init__(self, step: int, message: Optional[str] = None):
        super().__init__(message
                         or f"non-finite loss at train step {step}")
        self.step = step
# the tree key of the port's own generators (dropout, augment), which the
# JAX estimator's load does not read
_GENERATORS = "torch_generators"


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


def _has_torch_leaf(model: nn.Module) -> bool:
    """Whether a leaf module of ``model`` is one of ``torch.nn``'s own (or
    a TorchScript module): such a model is foreign to the port."""
    return any(type(m).__module__.startswith("torch.")
               for m in model.modules() if not list(m.children()))


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

    @staticmethod
    def from_torch(*, model: Any, loss: Any, optimizer: Any = "adam",
                   example_input: Any = None,
                   learning_rate: Optional[Any] = None,
                   metrics: Optional[Sequence[Any]] = None,
                   **kwargs: Any) -> "ZooEstimator":
        """The reference's ``Estimator.from_torch(model=, loss=,
        optimizer=)``.  In the port every model is a ``torch.nn.Module``,
        so the rule is by leaf: a model with a leaf module of ``torch.nn``
        itself (``torch.nn.Linear``, ``Conv2d``, ...), or a TorchScript
        module or file path, is foreign and is converted by
        ``Net.load_torch`` (which needs ``example_input=``, one batch in
        torch's layout); a model whose leaves are all the port's layers
        (or the caller's own modules) is native and passes through."""
        if isinstance(model, str) or _has_torch_leaf(model):
            from ...models.net import Net
            if example_input is None:
                raise ValueError(
                    "from_torch needs example_input= (one example batch, "
                    "torch layout) to convert a torch module")
            model = Net.load_torch(model, example_input)
        return ZooEstimator(model=model, loss=loss, optimizer=optimizer,
                            learning_rate=learning_rate, metrics=metrics,
                            **kwargs)

    @staticmethod
    def from_graph(model: Any, loss: Any, optimizer: Any = "adam",
                   learning_rate: Optional[Any] = None,
                   metrics: Optional[Sequence[Any]] = None,
                   **kwargs: Any) -> "ZooEstimator":
        """The reference's TF-graph ``Estimator.from_graph``: a tf.keras
        model (object or saved path) is converted by ``Net.load_tf``; a
        ``torch.nn.Module`` passes through."""
        if not isinstance(model, nn.Module):
            from ...models.net import Net
            model = Net.load_tf(model)
        return ZooEstimator(model=model, loss=loss, optimizer=optimizer,
                            learning_rate=learning_rate, metrics=metrics,
                            **kwargs)


def _under_device_lock(method: Callable) -> Callable:
    """``method``'s whole body under ``ZooEstimator._device_lock``."""
    @functools.wraps(method)
    def locked(self, *args: Any, **kwargs: Any) -> Any:
        with ZooEstimator._device_lock:
            return method(self, *args, **kwargs)
    return locked


class ZooEstimator:
    """The single concrete estimator, on one device."""

    #: The process-wide device lock (the JAX package's): ``fit``,
    #: ``evaluate``, ``predict``, ``save``, ``load`` and a trigger's save
    #: hold it for their whole bodies, so estimators driven from several
    #: threads (the automl thread pool's trials) never capture, replay or
    #: allocate in a graph pool at the same time; they overlap only in
    #: what they do outside these calls.  Reentrant: ``fit`` saves and
    #: loads under it.
    _device_lock = threading.RLock()

    def __init__(self, model: nn.Module, loss: Any, optimizer: Any = "adam",
                 learning_rate: Optional[Any] = None,
                 metrics: Optional[Sequence[Any]] = None,
                 grad_clip_norm: Optional[float] = None, seed: int = 0,
                 device: DeviceLike = None, augment: Any = None,
                 grad_accum: int = 1, cuda_graphs: bool = True,
                 embedding_lr: Optional[float] = None, sharding: Any = "dp",
                 model_dir: Optional[str] = None,
                 preemption_checkpoint: bool = False,
                 preemption_sync_every: int = 10,
                 checkpoint_retries: int = 3,
                 checkpoint_async: bool = False,
                 checkpoint_inflight: str = "latest-wins",
                 checkpoint_keep_last: int = 3,
                 checkpoint_anchor_every: int = 0,
                 checkpoint_delta: bool = True,
                 checkpoint_compact_every: int = 8,
                 frozen: Any = None,
                 nan_policy: Optional[str] = None,
                 nan_max_rollbacks: int = 3,
                 profile: Any = None,
                 profile_dir: Optional[str] = None,
                 profile_steps: Sequence[int] = (10, 20),
                 log_dir: Optional[str] = None,
                 app_name: str = "train",
                 grad_compression: Optional[str] = None,
                 **knobs: Any):
        if grad_accum < 1:
            raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")
        # ShardedEmbedding tables: updated by the sparse path, never by
        # the dense optimizer
        self._sparse = emb_lib.sparse_parameters(model)
        _check_sparse_support(self._sparse, grad_accum, frozen)
        _refuse_unported("ZooEstimator", knobs, _UNPORTED_KNOBS)
        if grad_compression is None:
            grad_compression = config_default("grad_compression", None)
        if grad_compression is not None:
            from ...parallel.util import GRAD_COMPRESSION
            if grad_compression not in GRAD_COMPRESSION:
                raise ValueError(
                    f"grad_compression must be one of {GRAD_COMPRESSION} "
                    f"or None, got {grad_compression!r}")
            if grad_compression != "none" and grad_accum > 1:
                raise ValueError(
                    "grad_compression='bf16'/'int8' requires grad_accum=1 "
                    "(the compressed collective already decomposes the "
                    "batch per shard)")
            if grad_compression != "none" and self._sparse:
                raise ValueError(
                    "grad_compression='bf16'/'int8' is not supported with "
                    f"ShardedEmbedding tables (found {list(self._sparse)}):"
                    " sparse row gradients always travel f32 and never "
                    "enter the quantized collective.  Use "
                    "grad_compression=None (or 'none' for wire metering of "
                    "the dense leaves).")
        self.grad_compression = grad_compression
        self.sharding = sharding
        mesh = current_mesh()
        if emb_lib.is_row_rules(sharding):
            sharding = "dp"  # one process: every table whole on its device
        if self._sparse and mesh is not None and mesh.size > 1:
            raise NotImplementedError(
                f"ShardedEmbedding tables over {mesh.size} processes are "
                f"not ported yet ({_Q1} 19 (row-sharded tables across "
                "processes)); one process trains them on its device")
        self.embedding_lr = embedding_lr
        self._learning_rate = learning_rate
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
        sparse = {id(p) for p in self._sparse.values()}
        # frozen=: the matched parameters leave the optimizer (and the
        # gradient) altogether, as optax.multi_transform's set_to_zero
        # leaves them unmoved and undecayed; buffers (batch norm's running
        # statistics) still update
        self.frozen = frozen
        self._frozen_names = _frozen_names(self.model, frozen, sparse)
        if frozen is not None:
            if not self._frozen_names:
                logger.warning("frozen=%r matched no parameters", frozen)
            self.optimizer = opt_lib.Masked(self.optimizer)
        dense = [(n, p) for n, p in self.model.named_parameters()
                 if id(p) not in sparse and n not in self._frozen_names]
        self._params: List[nn.Parameter] = [p for _, p in dense]
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
        self._dense_names = [n for n, _ in dense]
        self._table_path = {id(p): tp for tp, p in self._sparse.items()}
        # several processes, a strategy or a compressed wire: the mesh's
        # half of the step (scaleout.py); None is the one-process step
        self._scale: Optional[Scaleout] = None
        self.capture_refused: Optional[str] = None
        one_process(self.model)
        if ((mesh is not None and mesh.size > 1) or sharding != "dp"
                or grad_compression is not None):
            from ...core.context import make_mesh
            self._scale = Scaleout(self, mesh or make_mesh(None, 1),
                                   sharding, grad_compression)
            if self._scale.communicates and self.cuda_graphs:
                self.cuda_graphs = False
                self.capture_refused = (
                    f"the step all-reduces over {self._scale.mesh.size} "
                    f"processes ({self._scale.mesh.backend}); steps with "
                    f"collectives run eagerly ({_Q1} 18)")
                logger.warning("CUDA graphs off: %s", self.capture_refused)
        self._opt_params: List[torch.Tensor] = (
            self._scale.opt_params if self._scale is not None
            else self._params)
        self._grad_bytes_step = 0
        if grad_compression is not None:
            from ...parallel.util import grad_wire_bytes
            self._grad_bytes_step = grad_wire_bytes(self._params,
                                                    grad_compression)
        self._init_state_plane(model_dir, preemption_checkpoint,
                               preemption_sync_every, checkpoint_retries,
                               checkpoint_async, checkpoint_inflight,
                               checkpoint_keep_last, checkpoint_anchor_every,
                               checkpoint_delta, checkpoint_compact_every)
        self._init_knobs(nan_policy, nan_max_rollbacks, profile,
                         profile_dir, profile_steps, log_dir, app_name)

    def _init_knobs(self, nan_policy, nan_max_rollbacks, profile,
                    profile_dir, profile_steps, log_dir, app_name) -> None:
        """The JAX estimator's single-device knobs: the non-finite policy,
        the step profiler and the summaries."""
        if nan_policy is not None and nan_policy not in NAN_POLICIES:
            raise ValueError(f"nan_policy must be one of {NAN_POLICIES} "
                             f"or None, got {nan_policy!r}")
        self.nan_policy = nan_policy
        self.nan_max_rollbacks = max(0, nan_max_rollbacks)
        self.bad_steps = 0  # total non-finite steps seen (host mirror)
        self._rollbacks = 0
        # skip_step's counter, advanced inside the step; what a checkpoint
        # stores as bad_steps
        self._bad_steps = torch.zeros((), dtype=torch.int32,
                                      device=self.device)
        self._guarded: Optional[List[torch.Tensor]] = None
        self._guard_copies: List[torch.Tensor] = []
        from ...core.summary import SummaryWriter
        self._writer = SummaryWriter(log_dir, app_name) if log_dir else None
        self.profile_dir = profile_dir
        self.profile_steps = tuple(profile_steps)
        self._profiler = None
        self._profile_cfg: Optional[Dict[str, Any]] = None
        if profile:
            pcfg = {} if profile is True else dict(profile)
            self._profile_cfg = {
                "flops_per_sample": pcfg.get("flops_per_sample"),
                "peak_flops": pcfg.get("peak_flops")}
            if pcfg.get("trace_dir"):
                self.profile_dir = pcfg["trace_dir"]
                self.profile_steps = tuple(
                    pcfg.get("trace_steps", self.profile_steps))
        self._eager_keys: set = set()
        self.trace_files: List[str] = []

    def _init_state_plane(self, model_dir, preemption_checkpoint,
                          sync_every, retries, use_async, inflight,
                          keep_last, anchor_every, delta,
                          compact_every) -> None:
        """The JAX estimator's checkpoint knobs: the preemption guard, the
        async manager on ``model_dir`` and the touched-row masks."""
        self.model_dir = model_dir
        # transient write failures are retried with backoff before a save
        # gives up (the preemption window has no second chance)
        self.checkpoint_retries = max(1, retries)
        self._preempt = None
        if preemption_checkpoint:
            if model_dir is None:
                raise ValueError(
                    "preemption_checkpoint=True needs model_dir")
            from ...core.failover import PreemptionGuard
            self._preempt = PreemptionGuard(sync_every).install()
        self._ckpt_mgr = None
        mesh = current_mesh()
        if use_async and mesh is not None and mesh.size > 1:
            # saves over several processes are collective (each process
            # writes its pieces); a writer thread of one process cannot run
            # that protocol: the inline collective save instead
            logger.warning(
                "checkpoint_async=True is single-process only; the run over "
                "%d processes falls back to synchronous saves", mesh.size)
            use_async = False
        if use_async:
            if model_dir is None:
                raise ValueError("checkpoint_async=True needs model_dir")
            from ...core.ckpt_manager import CheckpointManager
            self._ckpt_mgr = CheckpointManager(
                model_dir, keep_last=keep_last, anchor_every=anchor_every,
                inflight=inflight, compact_every=compact_every,
                retries=self.checkpoint_retries, delta=delta)
        # delta checkpoints: one bool mask a ShardedEmbedding table of the
        # rows touched since the last accepted save, marked inside the
        # step (in its graph); one slot past the table takes the lookups'
        # padding.  Made here, so every capture sees them.
        self._touched: Dict[str, torch.Tensor] = {}
        if use_async and delta:
            self._touched = {
                tp: torch.zeros(t.shape[0] + 1, dtype=torch.bool,
                                device=self.device)
                for tp, t in self._sparse.items()}

    # -- steps ----------------------------------------------------------------

    def _embed_lr(self) -> float:
        """The sparse tables' learning rate: ``embedding_lr``, else a
        constant ``learning_rate``, else 1e-3 (the JAX package's rule)."""
        if self.embedding_lr is not None:
            return float(self.embedding_lr)
        if isinstance(self._learning_rate, (int, float)):
            return float(self._learning_rate)
        return 1e-3

    def _init_opt(self) -> Any:
        """The optimizer's state over the dense parameters, named by their
        paths in the JAX tree (LARS and LAMB exclude leaves by path)."""
        return self.optimizer.init(
            self._opt_params,
            [n.replace(".", "/") for n in self._dense_names])

    def _loss_and_grads(self, x: Any, y: Any) -> tuple:
        """One forward in training mode; returns its loss, the gradient of
        the loss over the dense parameters (None where the loss does not
        reach one) and the row gradients ``[(tap, g)]``.  The forward runs
        under ``inject_taps``, so the gradient is also taken over each
        ShardedEmbedding lookup's gathered unique rows, never over a table
        (a model without such tables has no taps)."""
        if self.augment is not None:
            x = self.augment(x, self._aug_gen, training=True)
        with emb_lib.inject_taps() as taps:
            loss = self.loss_fn(self.model(x), y)
        n = len(self._params)
        grads = torch.autograd.grad(
            loss, self._params + [t.rows for t in taps], allow_unused=True)
        return loss, grads[:n], list(zip(taps, grads[n:]))

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
            loss, grads, _ = self._loss_and_grads(micro["x"], micro["y"])
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

    def _guard_tensors(self) -> List[torch.Tensor]:
        """What ``nan_policy="skip_step"`` keeps at its pre-step value:
        the dense parameters, the model's buffers and every tensor of the
        optimizer's state (its lazy state made first), each once; the
        copies' buffers are made with the list, once."""
        if self._guarded is None:
            self.optimizer.materialize(self._opt_params, self._opt_state)
            seen, kept = set(), []
            ef = (self._scale.ef or []) if self._scale is not None else []
            for t in (list(self._params) + list(self._opt_params)
                      + list(self.model.buffers()) + list(ef)
                      + opt_lib.state_tensors(self._opt_state)):
                if id(t) not in seen:
                    seen.add(id(t))
                    kept.append(t)
            self._guarded = kept
            self._guard_copies = [torch.empty_like(t) for t in kept]
        return self._guarded

    def _step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step on ``batch`` (what a graph captures): the
        loss, on the device."""
        skip = self.nan_policy == "skip_step"
        if skip:
            with torch.no_grad():
                kept = self._guard_tensors()
                torch._foreach_copy_(self._guard_copies, kept)
        self.model.train()
        rows = []  # no sparse table with grad_accum > 1 (refused at init)
        if self.grad_accum > 1:
            loss, grads = self._accumulated(batch)
        else:
            loss, grads, rows = self._loss_and_grads(batch["x"], batch["y"])
        with torch.no_grad():
            # a parameter the loss does not reach has a zero gradient, as
            # in JAX
            grads = [torch.zeros_like(p) if g is None else g
                     for g, p in zip(grads, self._params)]
            if self._scale is not None:
                # the global batch's loss and gradients; the ranks' batch
                # norm statistics merged under a compressed wire
                loss, grads = self._scale.reduce(loss, grads)
                self._scale.merge_statistics()
            ok = None
            if self.nan_policy is not None:
                # the JAX step's grads_for_norm: the dense gradients and
                # the tables' row gradients
                finite = torch.isfinite(opt_lib.global_norm(
                    grads + [g for _, g in rows if g is not None]))
                if self._scale is not None:
                    finite = self._scale.agree(finite)
                if skip:
                    ok = torch.isfinite(loss) & finite
                else:
                    # the host policies read only the loss: a finite loss
                    # over a non-finite gradient reads as NaN
                    loss = torch.where(finite, loss.detach(),
                                       torch.full_like(loss, math.nan))
            if self._scale is not None:
                self._opt_state = self.optimizer.step(
                    self._opt_params, self._scale.opt_grads(grads),
                    self._opt_state)
                self._scale.gather(self._params)
            else:
                self._opt_state = self.optimizer.step(self._params, grads,
                                                      self._opt_state)
            # the tables: -embedding_lr x each lookup's row gradient added
            # on its unique ids (the JAX package's scatter-add); a skipped
            # step adds zeros (0 x NaN would be NaN)
            for tap, g in rows:
                if g is not None:
                    if ok is not None:
                        g = g.masked_fill(~ok, 0)
                    tap.table.index_add_(0, tap.uniq, g.to(tap.table.dtype),
                                         alpha=-self._embed_lr())
                    mask = self._touched.get(self._table_path[id(tap.table)])
                    if mask is not None:
                        # the padded slots land on the spare last slot
                        mask.index_fill_(0, torch.where(
                            tap.valid, tap.uniq, mask.shape[0] - 1), True)
            if ok is not None:
                for t, old in zip(self._guarded, self._guard_copies):
                    torch.where(ok, t, old, out=t)
                self._bad_steps.add_((~ok).to(torch.int32))
        return loss.detach()

    def _graph_for(self, batch: Dict[str, Any]) -> Tuple[
            "_StepGraph", List[torch.Tensor], Optional[torch.Tensor]]:
        """The step graph of ``batch``'s key and the batch's leaves; a new
        key runs its first step eagerly (the third item, its loss) and is
        captured."""
        if self._opt_state is None:
            self._opt_state = self._init_opt()
        flat = [to_device(a, self.device) if not isinstance(a, torch.Tensor)
                else a for a in leaves(batch)]
        key = _batch_key(batch, flat)
        graph = self._graphs.get(key)
        if graph is not None:
            return graph, flat, None
        with ZooEstimator._device_lock:  # the capture stream is shared
            graph = _StepGraph(self, batch, flat)
        self._graphs[key] = graph
        self.capture_count += 1
        return graph, flat, graph.first_loss

    def _train_step(self, batch: Dict[str, Any]) -> torch.Tensor:
        """One optimizer step on ``batch``; returns the loss (on the
        device, not synchronised).  On the card: a replay of the key's
        graph."""
        if self._scale is not None:
            batch = shard_batch(batch, self._scale.mesh)
        if not self.cuda_graphs:
            if self._opt_state is None:
                self._opt_state = self._init_opt()
            if self._profile_cfg is not None:
                self._eager_keys.add(_batch_key(batch, leaves(batch)))
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

    @_under_device_lock
    def fit(self, data: Any, epochs: int = 1, batch_size: int = 32,
            validation_data: Any = None, prefetch: Optional[int] = None,
            verbose: bool = True,
            feature_cols: Optional[Sequence[str]] = None,
            label_cols: Optional[Sequence[str]] = None,
            checkpoint_trigger: Any = None, auto_resume: bool = False
            ) -> Dict[str, List[float]]:
        """Train; returns ``{"loss": [...], "val_<metric>": [...]}``.

        ``data``: a feed (``DataFeed``, ``StreamingDataFeed``), an ``(x,
        y)`` tuple, an ``{"x", "y"}`` dict or an ``XShards`` (of numpy
        dicts, or of DataFrames with ``feature_cols``/``label_cols``);
        ``batch_size`` is the global batch.  As in the JAX package, a
        ``DataFeed(drop_remainder=False)`` trains on its last batch padded
        by wrapping to the first rows (the same shape, so the same graph);
        only a batch that carries a ``"mask"`` (a streaming feed's padded
        tail) is skipped.  The loss is read back once per epoch, not per
        step.

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
        ``train.step`` span under its epoch's ``train.epoch`` span.

        ``checkpoint_trigger``: a ``Trigger`` (or ``"every_epoch"``) that
        saves into ``model_dir`` after the steps and epoch ends it fires
        on (through the async manager with ``checkpoint_async=True``).
        ``auto_resume``: load ``model_dir``'s checkpoint first if there is
        one and this estimator has not trained yet; ``epochs`` is then the
        total target, and the next epoch's shuffle is the one the
        interrupted run would have drawn.  A mid-epoch checkpoint resumes
        by running its epoch again from the start, the step count carried
        on (the JAX package's semantics).  With
        ``preemption_checkpoint=True`` a SIGTERM or SIGINT during ``fit``
        checkpoints at the next ``preemption_sync_every``-th step and
        raises ``core.failover.Preempted``.

        With a ``nan_policy`` the history also has ``"bad_steps"`` (the
        epoch's non-finite steps); under ``"skip_step"`` the epoch loss is
        the mean over its finite steps.  An exception out of the steps
        (``NonFiniteLossError`` included) dumps the flight record into
        ``model_dir`` before it propagates."""
        if prefetch is None:
            prefetch = ZooConfig.prefetch
        if (auto_resume and self._opt_state is None and self.model_dir
                and self._ckpt_exists(self.model_dir)):
            self.load(self.model_dir)
            logger.info("auto-resumed from %s at step %d (epoch %d)",
                        self.model_dir, self._py_step, self._epoch)
            epochs = max(0, epochs - self._epoch)
        trigger = Trigger.get(checkpoint_trigger)
        data = _maybe_select_cols(data, feature_cols, label_cols)
        feed = as_feed(data, batch_size, seed=self.seed)
        reg = telemetry.get_registry()
        record_spans = trace_lib.enabled and reg.enabled
        fit_tid = trace_lib.new_trace_id() if record_spans else None
        fit_sid = trace_lib.new_span_id() if record_spans else None
        self.trace_id = fit_tid
        fit_t0 = time.monotonic()
        history: Dict[str, List[float]] = {"loss": []}
        start_epoch = self._epoch
        target_epoch = self._epoch + epochs
        if self._preempt is not None:
            self._preempt.active = True
        try:
            # while, not for: a rollback rewinds self._epoch to the
            # restored checkpoint's epoch and runs on from there
            while self._epoch < target_epoch:
                if not self._fit_epoch(feed, prefetch, trigger, history, reg,
                                       record_spans, fit_tid, fit_sid,
                                       verbose, validation_data, batch_size):
                    # rolled back: drop the entries of the epochs about to
                    # run again
                    keep = max(0, self._epoch - start_epoch)
                    for v in history.values():
                        del v[keep:]
        except Exception as e:
            # the flight record: recent spans, metric movement and
            # warnings beside the checkpoints (Preempted is a
            # BaseException, so a requested stop does not land here)
            from ...core import flightrec
            flightrec.dump(
                f"train.{type(e).__name__}", dump_dir=self.model_dir,
                extra={"step": self._py_step, "epoch": self._epoch,
                       "error": str(e)})
            raise
        finally:
            self._stop_profile()
            if self._preempt is not None:
                self._preempt.active = False
            if self._ckpt_mgr is not None:
                # fit returning means every accepted generation is
                # durable; a writer error was logged, counted
                # (ckpt.write_errors) and forced the next save full
                self._ckpt_mgr.flush(raise_error=False)
            if record_spans:
                trace_lib.record(
                    fit_tid, "train.fit",
                    {"epochs": self._epoch - start_epoch,
                     "steps": self._py_step},
                    span_id=fit_sid,
                    dur_ms=(time.monotonic() - fit_t0) * 1000.0)
        return history

    def _fit_epoch(self, feed, prefetch, trigger, history, reg,
                   record_spans, fit_tid, fit_sid, verbose,
                   validation_data, batch_size) -> bool:
        """One epoch of ``fit``: before each step the fault points and the
        profiler window, after each the non-finite check of the host
        policies, the preemption check and the trigger; then the epoch's
        loss, telemetry, summaries, validation and the epoch-end trigger.
        False when a rollback cut the epoch short."""
        m_step = reg.histogram("train.step_ms")
        m_wait = reg.histogram("train.data_wait_ms")
        m_steps = reg.counter("train.steps")
        m_samples = reg.counter("train.samples")
        m_bad = reg.counter("train.bad_steps")
        m_prefetch = reg.gauge("train.prefetch_depth")
        m_grad_bytes = reg.counter("train.grad_bytes") \
            if self.grad_compression is not None else None
        # the profiler's series exist only while it is on
        m_compiles = m_mfu = None
        if self._profile_cfg is not None:
            m_compiles = reg.counter("train.compiles")
            m_mfu = reg.gauge("train.mfu")
        faults = faults_lib.get_registry()
        host_nan_check = self.nan_policy in ("warn", "rollback", "raise")
        epoch_sid = trace_lib.new_span_id() if record_spans else None
        t0 = time.monotonic()
        losses: List[torch.Tensor] = []
        epoch_wait = 0.0
        bad_before = self.bad_steps
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
                if "mask" in batch:  # a stream's padded batch: skipped
                    continue
                # the gang supervisor's liveness beat (a no-op unless a
                # heartbeat file is configured), its payload a status
                heartbeat(step=self._py_step)
                # the worker fault seams (core/faults.py), disarmed no-ops
                # unless a test or a chaos schedule arms them
                if faults.fire("worker.crash"):
                    logger.error("injected worker.crash at step %d",
                                 self._py_step)
                    os._exit(1)
                faults.fire("worker.hang")  # an armed delay is the hang
                if faults.fire("step.nan"):
                    batch = _poison_batch(batch)
                self._maybe_profile()
                compiles_before = self.compile_count
                loss = self._train_step(batch)
                losses.append(loss)
                if m_compiles is not None:
                    grew = self.compile_count - compiles_before
                    if grew:
                        m_compiles.inc(grew)
                        if record_spans:
                            trace_lib.record(
                                fit_tid, "train.compile",
                                {"step": self._py_step, "compiles": grew},
                                parent=epoch_sid)
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
                if self._grad_bytes_step:
                    m_grad_bytes.inc(self._grad_bytes_step)
                if host_nan_check and not math.isfinite(float(loss)):
                    self.bad_steps += 1
                    m_bad.inc()
                    if self.nan_policy == "raise":
                        raise NonFiniteLossError(self._py_step)
                    if self.nan_policy == "warn":
                        logger.warning(
                            "non-finite loss at step %d (nan_policy="
                            "'warn'): training continues on possibly "
                            "poisoned parameters", self._py_step)
                    else:
                        self._rollback_to_checkpoint()
                        return False
                self._after_step(trigger)
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
                "fit got no batches to train on (every batch was a "
                "masked, padded one); reduce batch_size")
        self._epoch += 1
        # one host synchronisation an epoch; under skip_step the skipped
        # steps' NaN losses leave the mean, and the on-device counter is
        # read
        stacked = torch.stack(losses).float()
        if self.nan_policy == "skip_step":
            epoch_loss = float(torch.nanmean(stacked))
            self.bad_steps = int(self._bad_steps)
            if self.bad_steps > bad_before:
                m_bad.inc(self.bad_steps - bad_before)
        else:
            epoch_loss = float(stacked.mean())
        history["loss"].append(epoch_loss)
        if self.nan_policy is not None:
            history.setdefault("bad_steps", []).append(
                self.bad_steps - bad_before)
        dt = time.monotonic() - t0
        n = len(losses) * feed.global_batch
        step_ms = 1000.0 * dt / len(losses)
        wait_ms = 1000.0 * epoch_wait / len(losses)
        samples_per_sec = n / dt
        mfu = self._measure_mfu(samples_per_sec)
        if mfu is not None:
            m_mfu.set(mfu)
        comm_ms = self._measure_comm_ms()  # None unless configured
        if comm_ms is not None:
            reg.histogram("train.comm_ms").observe(comm_ms)
        hb_extra = {}
        if os.environ.get("ZOO_HEARTBEAT_METRICS"):
            # the supervisor folds every rank's registry snapshot into the
            # gang's (core/launcher.py)
            hb_extra["metrics"] = reg.snapshot()
        heartbeat(force=True, step=self._py_step, loss=epoch_loss,
                  samples_per_sec=round(samples_per_sec, 2), **hb_extra)
        if record_spans:
            trace_lib.record(
                fit_tid, "train.epoch",
                {"epoch": self._epoch, "loss": round(epoch_loss, 6),
                 "steps": len(losses), "step_ms": round(step_ms, 3),
                 "data_wait_ms": round(wait_ms, 3)},
                span_id=epoch_sid, parent=fit_sid, dur_ms=dt * 1000.0)
        if self._writer:
            for tag, value in (
                    ("loss", epoch_loss), ("throughput", samples_per_sec),
                    ("samples_per_sec", samples_per_sec),
                    ("step_time_ms", step_ms), ("data_wait_ms", wait_ms),
                    ("compute_ms", max(0.0, step_ms - wait_ms))):
                self._writer.add_scalar(tag, value, self._epoch)
            if self.nan_policy is not None:
                self._writer.add_scalar(
                    "bad_steps", self.bad_steps - bad_before, self._epoch)
        if verbose:
            logger.info("epoch %d: loss=%.4f (%.1f examples/s)",
                        self._epoch, epoch_loss, samples_per_sec)
        if validation_data is not None:
            for k, v in self.evaluate(validation_data,
                                      batch_size).items():
                history.setdefault(f"val_{k}", []).append(v)
                if self._writer:
                    self._writer.add_scalar(f"val_{k}", v, self._epoch)
        if trigger and self.model_dir and trigger.fires(
                step=self._py_step, epoch_end=True):
            self._trigger_save()
        return True

    def _measure_comm_ms(self) -> Optional[float]:
        """Wall ms of the gradient all-reduce alone at the configured wire
        width (``train.comm_ms``): gradient-shaped tensors filled on the
        device, reduced through the step's own reduce, synchronised; once
        an epoch (the first call warms and is discarded).  None without
        ``grad_compression``."""
        if self.grad_compression is None or self._scale is None:
            return None
        scale = self._scale

        def probe():
            probe_grads = [torch.zeros_like(p) for p in self._params]
            saved = [r.clone() for r in scale.ef] if scale.ef else None
            scale.reduce(torch.zeros((), device=self.device), probe_grads)
            if saved is not None:  # the probe must not move the residuals
                for r, old in zip(scale.ef, saved):
                    r.copy_(old)
            self._sync()

        if not getattr(self, "_comm_warm", False):
            probe()
            self._comm_warm = True
        t0 = time.monotonic()
        probe()
        return (time.monotonic() - t0) * 1000.0

    @property
    def compile_count(self) -> int:
        """Step keys seen so far: captures on the card, distinct batch
        keys of the eager step (counted while the profiler is on)."""
        return self.capture_count + len(self._eager_keys)

    def _measure_mfu(self, samples_per_sec: float) -> Optional[float]:
        """``flops_per_sample x samples/s / (peak x devices)`` for the
        ``train.mfu`` gauge; None unless the profiler is on and the model
        (or the profile dict) declares ``flops_per_sample``.  The peak is
        ``profile["peak_flops"]``, else ``ZooConfig.device_peak_flops``,
        else ``nominal_peak_flops`` of the device and the model's compute
        dtype; None where none of them gives one."""
        if self._profile_cfg is None:
            return None
        fps = (self._profile_cfg.get("flops_per_sample")
               or getattr(self.model, "flops_per_sample", None))
        if not fps:
            return None
        peak = self._profile_cfg.get("peak_flops")
        if peak is None:
            peak = ZooConfig.device_peak_flops
        if peak is None:
            peak = nominal_peak_flops(self.device, _compute_dtype(self.model))
        if peak is None:
            return None
        return float(fps) * samples_per_sec / float(peak)  # one device

    def _rollback_to_checkpoint(self) -> None:
        """``nan_policy="rollback"``: load the newest ``model_dir``
        checkpoint in place (parameters, buffers, optimizer, step, epoch;
        the captured graphs replay on), and let ``fit`` run on from it.
        At most ``nan_max_rollbacks`` times: a deterministic NaN would
        loop for ever."""
        self._rollbacks += 1
        if self._rollbacks > self.nan_max_rollbacks:
            raise NonFiniteLossError(
                self._py_step,
                f"non-finite loss at step {self._py_step}: rollback budget "
                f"({self.nan_max_rollbacks}) exhausted - the fault is "
                f"deterministic, not transient")
        if self._ckpt_mgr is not None:
            # an accepted snapshot still being written is a valid target
            # once it lands
            self._ckpt_mgr.flush(raise_error=False)
        if not (self.model_dir and self._ckpt_exists(self.model_dir)):
            raise NonFiniteLossError(
                self._py_step,
                f"non-finite loss at step {self._py_step}: nan_policy="
                "'rollback' found no checkpoint in model_dir (configure "
                "model_dir and a checkpoint_trigger)")
        logger.warning(
            "non-finite loss at step %d: rolling back to the last "
            "checkpoint in %s (rollback %d/%d)", self._py_step,
            self.model_dir, self._rollbacks, self.nan_max_rollbacks)
        self.load(self.model_dir)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _maybe_profile(self) -> None:
        """Open the trace window at step ``start`` and close it at
        ``end``, between steps (the card synchronised first, so the window
        holds whole replays)."""
        if self.profile_dir is None:
            return
        start, end = self.profile_steps
        if self._profiler is None and start <= self._py_step < end:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            self._sync()
            self._profiler = profile(activities=acts)
            self._profiler.start()
            self._trace_start = self._py_step
        elif self._profiler is not None and self._py_step >= end:
            self._stop_profile()

    def _stop_profile(self) -> None:
        """Close an open trace window: wait for the card, stop the
        profiler and write its Chrome trace into ``profile_dir``."""
        if self._profiler is None:
            return
        prof, self._profiler = self._profiler, None
        self._sync()
        prof.stop()
        os.makedirs(self.profile_dir, exist_ok=True)
        path = os.path.join(
            self.profile_dir,
            f"train_{os.getpid()}_steps{self._trace_start}-"
            f"{self._py_step}.pt.trace.json")
        prof.export_chrome_trace(path)
        self.trace_files.append(path)
        logger.info("wrote the profiler trace to %s", path)

    def _after_step(self, trigger: Optional[Trigger]) -> None:
        """After each step: a preemption checkpoint and ``Preempted`` when
        the guard was signalled, else the trigger's mid-epoch save."""
        if (self._preempt is not None
                and self._preempt.should_checkpoint(self._py_step)):
            from ...core.failover import Preempted, checkpoint_for_exit
            if self._ckpt_mgr is not None:
                # bounded time to exit: an in-flight snapshot is reused
                saved = checkpoint_for_exit(
                    self._ckpt_mgr, self._save_tree(), self._py_step,
                    extra={"epoch": int(self._epoch)},
                    touched=self._collect_touched())
                raise Preempted(saved if saved is not None
                                else self._py_step, self.model_dir,
                                durable=saved is not None)
            path = self.save(self.model_dir)
            raise Preempted(self._py_step, path)
        if trigger and self.model_dir and trigger.fires(
                step=self._py_step, epoch_end=False):
            self._trigger_save()

    # -- evaluation -----------------------------------------------------------

    @_under_device_lock
    def evaluate(self, data: Any, batch_size: int = 32,
                 feature_cols: Optional[Sequence[str]] = None,
                 label_cols: Optional[Sequence[str]] = None
                 ) -> Dict[str, float]:
        """Exact metrics over every row: the last partial batch is padded
        to the batch shape and its padding weighted out by a mask (a
        stream's own ``"mask"`` where its batch carries one)."""
        data = _maybe_select_cols(data, feature_cols, label_cols)
        feed = as_feed(data, batch_size, shuffle=False, seed=self.seed,
                       drop_remainder=False)
        totals: Optional[List[torch.Tensor]] = None

        def accumulate(totals, batch, mask):
            if not isinstance(mask, torch.Tensor):
                mask = to_device(mask, self.device)
            if self._scale is not None:  # this rank's rows of the batch
                batch, mask = shard_batch((batch, mask), self._scale.mesh)
            heartbeat()  # a long validation sweep is progress too
            stats = self._eval_step(batch, mask)
            return stats if totals is None else \
                [a + b for a, b in zip(totals, stats)]

        self.model.eval()
        with torch.no_grad():
            for step, batch in enumerate(feed.epoch(self.device, 0)):
                mask = batch["mask"] if "mask" in batch \
                    else feed.step_mask(step)
                totals = accumulate(totals, batch, mask)
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
        if self._scale is not None and self._scale.batch_group is not None:
            # the global sums: the ranks' rows make the global batch
            import torch.distributed as dist
            totals = [t.clone() for t in totals]
            for t in totals:
                dist.all_reduce(t, group=self._scale.batch_group)
        out = {"loss": float(totals[0][0] / torch.clamp(totals[0][1],
                                                        min=1.0))}
        for m, stat in zip(self.metrics, totals[1:]):
            out[m.name] = float(m.result(stat))
        return out

    # -- inference ------------------------------------------------------------

    @_under_device_lock
    def predict(self, data: Any, batch_size: int = 32,
                feature_cols: Optional[Sequence[str]] = None) -> np.ndarray:
        """Forward over all rows, in order: exactly one output row per
        input row (the last batch padded, then trimmed)."""
        data = _maybe_select_cols(data, feature_cols, None)
        feed = as_feed(data, batch_size, shuffle=False, drop_remainder=False)
        if feed.shuffle:
            raise ValueError("predict needs row order preserved: construct "
                             "the feed with shuffle=False")
        outs: List[np.ndarray] = []
        self.model.eval()
        scale = self._scale if (self._scale is not None
                                and self._scale.batch_size > 1) else None
        with torch.no_grad():
            for step, batch in enumerate(feed.epoch(self.device, 0)):
                heartbeat()  # a long prediction sweep is progress too
                if scale is None:
                    outs.append(_to_numpy(self._forward_eval(batch["x"])))
                    continue
                # this process's rows: its block of each global batch,
                # the padding past the last row left out
                x = shard_batch(batch["x"], scale.mesh)
                out = _to_numpy(self._forward_eval(x))
                if "mask" in batch:  # a stream's padded rows
                    real = _to_numpy(shard_batch(batch["mask"],
                                                 scale.mesh)) > 0
                    outs.append(out[real])
                    continue
                m = nrows(x)
                first = step * feed._local_batch + scale.batch_index * m
                outs.append(out[:max(0, min(m, feed.num_rows - first))])
            if feed.drop_remainder and (scale is None
                                        or scale.batch_index == 0):
                rem = feed.remainder()
                if rem is not None:  # tail rows the epoch skipped
                    outs.append(_to_numpy(self._forward_eval(tree_map(
                        lambda a: to_device(a, self.device), rem["x"]))))
        if scale is not None:
            return np.concatenate(outs, axis=0)
        return np.concatenate(outs, axis=0)[:feed.num_rows]

    # -- state ----------------------------------------------------------------

    def get_train_summary(self, tag: str = "loss") -> List[Tuple[int, float]]:
        """``[(epoch, value)]`` of a scalar from ``log_dir`` (the
        reference's ``Estimator.get_train_summary``)."""
        if self._writer is None:
            raise ValueError("no log_dir configured")
        return self._writer.read_scalar(tag)

    def get_validation_summary(self, tag: str) -> List[Tuple[int, float]]:
        return self.get_train_summary(tag if tag.startswith("val_")
                                      else f"val_{tag}")

    def get_model(self) -> Dict[str, Any]:
        """The current variables as the JAX tree ``{"params", "state"}``
        of numpy arrays (``convert.to_jax_variables``): parameters under
        ``"params"``, buffers (batch norm's running statistics) under
        ``"state"``."""
        return to_jax_variables(self.model.state_dict(),
                                buffer_names(self.model))

    def _optax_state(self) -> Any:
        """The optimizer's state in optax's layout over the dense
        parameters (made first if no step ran yet), leaves live."""
        if self._opt_state is None:
            self._opt_state = self._init_opt()
        return self.optimizer.optax_state(
            self._opt_params, self._opt_state, self._opt_tree)

    def _opt_tree(self, ts: List[Any]) -> Dict[str, Any]:
        """Per-parameter optimizer state as the JAX params tree: a sharded
        leaf's piece as its ``ShardedLeaf`` (already in the JAX layout),
        the rest through ``jax_tree``."""
        if self._scale is None:
            return jax_tree(zip(self._dense_names, ts))
        out = self._scale.opt_layout(ts)
        tree = jax_tree((n, t) for n, t in zip(self._dense_names, out)
                        if isinstance(t, torch.Tensor))
        for n, t in zip(self._dense_names, out):
            if not isinstance(t, torch.Tensor):
                *path, leaf = n.split(".")
                node = tree
                for k in path:
                    node = node.setdefault(k, {})
                node[leaf] = t
        return tree

    def _generators_list(self) -> List[torch.Generator]:
        """The dropout generators (each once, in module order)."""
        gens = {id(m.generator): m.generator for m in self.model.modules()
                if isinstance(m, Dropout) and m.generator is not None}
        return list(gens.values())

    def _save_tree(self) -> Dict[str, Any]:
        """The checkpointable train state, the JAX estimator's tree (live
        tensors; the touched-row masks are not part of it) plus the port's
        generator states under a key the JAX estimator ignores."""
        seed = int(self.seed) & 0xFFFFFFFFFFFFFFFF
        tree = {
            **jax_variables(self.model.state_dict(),
                            buffer_names(self.model)),
            "opt_state": opt_lib.snapshot(self._optax_state()),
            "step": np.asarray(self._py_step, np.int32),
            # jax.random.PRNGKey(seed): a JAX step folds the step into it
            # and never advances it
            "rng": np.asarray([seed >> 32, seed & 0xFFFFFFFF], np.uint32),
            "bad_steps": self._bad_steps,
            _GENERATORS: {
                "dropout": [g.get_state() for g in self._generators_list()],
                "augment": self._aug_gen.get_state()},
        }
        if self._scale is not None:
            self._scale.save_tree(tree)
        return tree

    def _ckpt_exists(self, path: str) -> bool:
        """A resumable checkpoint at ``path``: the sync layout, or an async
        manager's manifest with a visible generation."""
        if ckpt_io.exists(path):
            return True
        from ...core import ckpt_manager as ckpt_mgr_lib
        return ckpt_mgr_lib.has_manifest(path)

    def _collect_touched(self) -> Optional[Dict[str, np.ndarray]]:
        """The touched-row ids of each table since the last accepted save,
        keyed by the full tree's path (``params/...``); reads the masks
        back to the host."""
        if not self._touched:
            return None
        return {"params/" + tp: np.nonzero(m[:-1].cpu().numpy())[0]
                for tp, m in self._touched.items()}

    def _reset_touched(self) -> None:
        for m in self._touched.values():
            m.zero_()  # in place: the captured step marks these tensors

    @_under_device_lock
    def _trigger_save(self) -> None:
        """One trigger firing: async through the manager (the touched rows
        reset only when the snapshot was accepted: one the ``skip`` policy
        drops keeps them for the next save), else the inline save."""
        if self._ckpt_mgr is None:
            self.save(self.model_dir)
            return
        accepted = self._ckpt_mgr.save_async(
            self._save_tree(), step=self._py_step,
            extra={"epoch": int(self._epoch)},
            touched=self._collect_touched())
        if accepted:
            self._reset_touched()

    @_under_device_lock
    def save(self, path: Optional[str] = None) -> str:
        """Write the train state to ``path`` (default ``model_dir``) in
        ``core/checkpoint.py``'s format; with ``checkpoint_async=True`` and
        ``path == model_dir`` a blocking full generation of the manager.
        Returns the directory."""
        path = path or self.model_dir
        if path is None:
            raise ValueError("no path given and no model_dir configured")
        if self._ckpt_mgr is not None and path == self.model_dir:
            # the manager owns model_dir: MANIFEST.jsonl stays the one
            # source of truth
            self._ckpt_mgr.save(self._save_tree(), step=self._py_step,
                                extra={"epoch": int(self._epoch)},
                                touched=self._collect_touched())
            self._reset_touched()
            return path
        return ckpt_io.save(path, self._save_tree(), step=self._py_step,
                            extra={"epoch": int(self._epoch)},
                            retries=self.checkpoint_retries)

    @_under_device_lock
    def load(self, path: Optional[str] = None) -> None:
        """Load a checkpoint of either package (``save``'s format, or the
        newest restorable generation of a manager directory) into this
        estimator, in place: parameters and buffers, the optimizer's state
        (made first if no step ran; a layout that does not fit raises,
        naming the leaf), the step and epoch, the generators' states."""
        path = path or self.model_dir
        if path is None:
            raise ValueError("no path given and no model_dir configured")
        if self._ckpt_mgr is not None and path == self.model_dir:
            from ...core import ckpt_manager as ckpt_mgr_lib
            if (not ckpt_mgr_lib.has_manifest(path)
                    and ckpt_io.exists(path)):
                # a sync checkpoint from before checkpoint_async was on:
                # the next trigger save starts the manifest with a full
                tree = ckpt_io.restore(path)
                extra = ckpt_io.load_extra(path)
            else:
                tree = self._ckpt_mgr.restore()
                extra = (self._ckpt_mgr.last_restored or {}).get(
                    "extra") or {}
        else:
            tree = ckpt_io.restore(path)
            extra = ckpt_io.load_extra(path)
        # copy_ into the live tensors: a captured step replays on them
        self.model.load_state_dict(from_jax_variables(
            {"params": tree["params"], "state": tree.get("state") or {}}),
            strict=True)
        opt_lib.load_optax(self._optax_state(), tree["opt_state"])
        if self._scale is not None:
            # the master pieces from the loaded parameters, and this rank's
            # residuals
            self._scale.reload_pieces(self._params)
            self._scale.load_tree(tree)
        self._py_step = int(np.asarray(tree["step"]))
        bad = np.asarray(tree.get("bad_steps", 0), np.int32)
        self._bad_steps.copy_(torch.from_numpy(bad.reshape(())))
        if self.nan_policy == "skip_step":
            # the host mirror follows the restored counter, so the next
            # epoch reports only its own bad steps; the host policies keep
            # theirs (a rollback's load must not erase the step that
            # triggered it)
            self.bad_steps = int(bad)
        self._epoch = int(extra.get("epoch", self._epoch))
        self._load_generators(tree.get(_GENERATORS))
        # fresh masks: rows diverge from the restored generation only once
        # a step touches them again
        self._reset_touched()

    def _load_generators(self, saved: Optional[Dict[str, Any]]) -> None:
        """Set the dropout and augment generators' states through the
        generators themselves (a CUDA graph registered with a generator
        reads its seed and offset at each replay); a checkpoint without
        them (the JAX package's) reseeds them from ``seed``."""
        gens = self._generators_list()
        states = None
        if saved is not None:
            states = list(saved.get("dropout") or []) + [saved["augment"]]
        targets = gens + [self._aug_gen]
        if states is not None and len(states) == len(targets) and all(
                np.asarray(st).size == g.get_state().numel()
                for st, g in zip(states, targets)):
            for g, st in zip(targets, states):
                g.set_state(torch.from_numpy(
                    np.ascontiguousarray(st, dtype=np.uint8)))
            return
        if states is not None:
            logger.warning(
                "the checkpoint's generator states do not fit this "
                "estimator's generators (another device or model); "
                "reseeding them from seed=%d", self.seed)
        for g in targets:
            g.manual_seed(int(self.seed))


def _frozen_predicate(frozen: Any) -> Callable[[str], bool]:
    """``frozen=`` as a test of a ``/``-joined parameter path: a callable
    as it is, else a list of path prefixes matched on component
    boundaries (``["enc"]`` freezes ``enc/...`` but not ``enc_head/...``),
    the JAX package's rule."""
    if callable(frozen):
        return frozen
    pre = tuple(frozen)
    return lambda p: any(p == x or p.startswith(x + "/") for x in pre)


def _frozen_names(model: nn.Module, frozen: Any, skip: set) -> set:
    """The ``named_parameters`` names that ``frozen=`` matches (none of
    the ids in ``skip``)."""
    if frozen is None:
        return set()
    pred = _frozen_predicate(frozen)
    return {n for n, p in model.named_parameters()
            if id(p) not in skip and pred(n.replace(".", "/"))}


def _check_sparse_support(tables: Dict[str, nn.Parameter], grad_accum: int,
                          frozen: Any) -> None:
    """The JAX package's guardrails for ShardedEmbedding models, raised as
    it raises them: ``grad_accum > 1`` and ``frozen=`` on a table."""
    if not tables:
        return
    if grad_accum > 1:
        raise ValueError(
            "grad_accum > 1 is not supported with ShardedEmbedding "
            f"tables (found {list(tables)}): the accumulation would need a "
            "dense [rows, dim] gradient carry, defeating the sparse "
            "update.  Use grad_accum=1 (the deduped gather already keeps "
            "the per-step embedding traffic small).")
    if frozen is not None:
        pred = _frozen_predicate(frozen)
        hit = [p for p in tables if pred(p)]
        if hit:
            raise ValueError(
                f"frozen= matches a ShardedEmbedding table ({hit}); sparse "
                "tables bypass the optimizer's freeze machinery - remove "
                "them from frozen= (they can be excluded from updates by "
                "setting embedding_lr=0.0).")


def _maybe_select_cols(data: Any, feature_cols: Optional[Sequence[str]],
                       label_cols: Optional[Sequence[str]]) -> Any:
    """XShards of DataFrames with feature/label columns -> numpy-dict
    XShards (the JAX package's rule); anything else as it is."""
    if feature_cols is None or not isinstance(data, XShards):
        return data
    first = data.collect()[0]
    if hasattr(first, "iloc"):
        return data.to_numpy_dict(feature_cols, label_cols)
    return data


def _batch_key(batch: Dict[str, Any], flat: Sequence[Any]) -> tuple:
    """A batch's step key from its nesting and its leaves ``flat``:
    their shapes and dtypes (what a new capture, or a JAX retrace, is
    made for)."""
    return (_structure(batch),
            tuple((tuple(a.shape), str(a.dtype)) for a in flat))


def _poison_batch(batch: Dict[str, Any]) -> Dict[str, Any]:
    """``step.nan``: every float leaf of the batch NaN-filled, so the
    non-finite value runs through the real forward and backward (loss and
    gradients), the guard path a numerical blow-up takes; integer leaves
    (token ids, labels) pass through.  Same shapes and dtypes, so the same
    step graph."""
    def nan_fill(a):
        if isinstance(a, torch.Tensor):
            return a * math.nan if a.is_floating_point() else a
        a = np.asarray(a)
        return (a * a.dtype.type(np.nan)
                if np.issubdtype(a.dtype, np.floating) else a)

    return tree_map(nan_fill, batch)


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


# One capture stream a device, shared by every estimator's captures (made
# under the device lock): cuBLAS keeps a workspace for each stream it runs
# on (64 MiB on the H100), so a new stream a capture held one more for
# every estimator made (an AutoTS search makes one a trial) until the
# process cleared them, up to the size of torch's stream pool.
_CAPTURE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


def _capture_stream(device: torch.device) -> "torch.cuda.Stream":
    device = _indexed(device)
    stream = _CAPTURE_STREAMS.get(device)
    if stream is None:
        stream = _CAPTURE_STREAMS[device] = torch.cuda.Stream(device)
    return stream


class _StepGraph:
    """One (batch shapes, dtypes) key's captured train step: static input
    buffers, the step's graph in the estimator's memory pool, its loss as
    a static output, and the kernel launches its capture recorded
    (``ops._launches``), made again at each replay.

    Made from the key's first batch: the batch is copied into the static
    inputs, the step runs once eagerly on a side stream as a real step
    (``first_loss``), and the same step is captured on that stream with
    the model's dropout generator and the augment generator registered, so
    that each replay draws the random numbers the next eager step would.
    The side stream is the device's one capture stream
    (``_capture_stream``)."""

    def __init__(self, est: "ZooEstimator", batch: Dict[str, Any],
                 flat: List[torch.Tensor]):
        device = est.device
        current = torch.cuda.current_stream(device)
        self.static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                       for t in flat]
        self.load(flat)
        static_batch = _rebuild(batch, self.static)
        side = _capture_stream(device)
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
            with collector_held(), _launches.recording(side) as self.launches:
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
    gens = est._generators_list() + (
        [est._aug_gen] if est.augment is not None else [])
    return [g for g in gens if g.device.type == "cuda"]


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
