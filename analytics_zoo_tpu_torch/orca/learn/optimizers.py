"""Optimizers (port of ``analytics_zoo_tpu/orca/learn/optimizers.py``).

The JAX package maps optimizer names onto optax transformations; the port
reproduces optax's numbers.  ``get`` returns an ``Optimizer``: ``init``
makes the state, ``step`` updates the parameters in place.  sgd, momentum,
adam and adamw are ``torch.optim``'s optimizers (fused on the card)
configured to optax's formula and defaults (``optax.adamw`` decays weights
by 1e-4, ``torch.optim.AdamW`` by 0.01).  rmsprop and adagrad, where
torch's eps sits elsewhere and its accumulators start elsewhere, are
written out as plain functions on lists of tensors with optax's
structure: a ``GradientTransformation`` is an ``(init, update)`` pair,
``chain`` composes them, and ``apply_updates`` adds the result to the
parameters.

Learning rates are a float or a schedule (a callable of the update count,
0 for the first update, as in optax), or a dict spec resolved by
``resolve_learning_rate``, e.g. ``{"schedule": "warmup_cosine", "peak":
1e-3, "warmup_steps": 100, "decay_steps": 1000}``.  As optax does inside
``jit``, every optimizer keeps its update count as an int32 tensor on the
parameters' device, and a schedule maps that tensor to an f32 learning
rate there: a step reads nothing from the device and writes no host
state, so a CUDA graph of it replays (``estimator.py``) and the CPU runs
the same formulation.  LARS and LAMB are not ported yet.

Checkpoints hold the state in optax's layout, the tree the JAX package's
``tx.init`` gives for the same name and options (``Optimizer.optax_state``:
e.g. adam's ``((count, mu, nu), EmptyState | (count,))``, with ``mu`` and
``nu`` trees shaped like the parameters).  Its leaves are the live state
tensors themselves (views for conv kernels, whose layout differs), or a
:class:`Tied` leaf where optax keeps one number and the port several
(torch's per-parameter Adam ``step`` tensors and the port's update count):
``snapshot`` reads it, ``load_optax`` copies a saved tree back into the
tensors in place (a captured step keeps replaying against them) and
raises, naming the leaf, where the saved layout differs.  torch.optim
makes its state at the first ``step()``; ``optax_state`` makes it first
as torch would, so a load before any step has somewhere to go.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

Tensors = List[torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``, all on lists of tensors in one order."""
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Optional[Tensors]], Tuple[Tensors, Any]]


# -- schedules ----------------------------------------------------------------
#
# optax's schedules, op for op on an int32 count tensor: f32 arithmetic,
# Python constants rounded to f32 as JAX's weak types are.

def _count(count: Any) -> torch.Tensor:
    """``count`` as an int32 tensor (a host int is made one)."""
    if isinstance(count, torch.Tensor):
        return count
    return torch.tensor(count, dtype=torch.int32)


def constant_schedule(value: float) -> Schedule:
    def schedule(count):
        count = _count(count)
        return torch.full(count.shape, value, dtype=torch.float32,
                          device=count.device)
    return schedule


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int,
                        transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return constant_schedule(init_value)
    transition_begin = max(0, transition_begin)

    def schedule(count):
        c = torch.clamp(_count(count) - transition_begin, 0,
                        transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac ** power + end_value
    return schedule


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int,
                    transition_begin: int = 0) -> Schedule:
    return polynomial_schedule(init_value, end_value, 1, transition_steps,
                               transition_begin)


def exponential_decay(init_value: float, transition_steps: int,
                      decay_rate: float, transition_begin: int = 0,
                      staircase: bool = False,
                      end_value: Optional[float] = None) -> Schedule:
    if transition_steps <= 0 or decay_rate == 0:
        return constant_schedule(init_value)
    transition_begin = max(0, transition_begin)

    def schedule(count):
        dec = _count(count) - transition_begin
        p = dec / transition_steps
        if staircase:
            p = torch.floor(p)
        value = torch.where(dec <= 0, init_value,
                            init_value * torch.pow(decay_rate, p))
        if end_value is not None:
            value = (torch.clamp(value, min=end_value) if decay_rate < 1.0
                     else torch.clamp(value, max=end_value))
        return value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")
    decay_steps = float(decay_steps)

    def schedule(count):
        c = torch.clamp(_count(count), max=decay_steps)
        cosine = 0.5 * (1 + torch.cos(math.pi * c / decay_steps))
        return init_value * ((1 - alpha) * cosine ** exponent + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0,
                                 exponent: float = 1.0) -> Schedule:
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha, exponent)

    def schedule(count):  # optax.join_schedules: both sides evaluated
        count = _count(count)
        return torch.where(count < warmup_steps, warm(count),
                           decay(count - warmup_steps))
    return schedule


_SCHEDULES = {
    # reference Poly(power, maxIteration)
    "poly": lambda lr, decay_steps, power=1.0, end_lr=0.0, **kw:
        polynomial_schedule(lr, end_lr, power, decay_steps, **kw),
    # reference Exponential(decayStep, decayRate)
    "exponential": lambda lr, decay_steps, decay_rate=0.96, **kw:
        exponential_decay(lr, decay_steps, decay_rate, **kw),
    # reference Warmup(delta) + cosine tail
    "warmup_cosine": lambda lr, warmup_steps, decay_steps, end_lr=0.0, **kw:
        warmup_cosine_decay_schedule(0.0, lr, warmup_steps, decay_steps,
                                     end_lr, **kw),
    "warmup_linear": lambda lr, warmup_steps, **kw:
        linear_schedule(0.0, lr, warmup_steps, **kw),
    "cosine": lambda lr, decay_steps, **kw:
        cosine_decay_schedule(lr, decay_steps, **kw),
    "constant": lambda lr, **kw: constant_schedule(lr),
}


def resolve_learning_rate(learning_rate: Any) -> Any:
    """float/callable pass through; dict specs become schedules."""
    if not isinstance(learning_rate, dict):
        return learning_rate
    spec = dict(learning_rate)
    name = spec.pop("schedule", None)
    if name is None:
        raise ValueError("schedule spec needs a 'schedule' entry, e.g. "
                         f"{{'schedule': 'warmup_cosine', ...}}; known: "
                         f"{sorted(_SCHEDULES)}")
    if name not in _SCHEDULES:
        raise ValueError(f"unknown schedule {name!r}; known: "
                         f"{sorted(_SCHEDULES)}")
    lr = spec.pop("peak", spec.pop("lr", None))
    if lr is None:
        raise ValueError("schedule spec needs a 'peak' (or 'lr') entry")
    return _SCHEDULES[name](lr, **spec)


# -- transformations ----------------------------------------------------------

def _f32(x: float) -> float:
    """``x`` rounded to float32, as optax's scalar arithmetic is."""
    return float(np.float32(x))


def _new_count(params: Tensors) -> torch.Tensor:
    """An update count of 0 on the parameters' device."""
    return torch.zeros((), dtype=torch.int32, device=params[0].device)


def scale_by_learning_rate(learning_rate: Any) -> GradientTransformation:
    """Multiply by ``-learning_rate`` (a schedule at the update count, from
    0).  The count is a device tensor, advanced in place."""
    def init(params):
        return {"count": _new_count(params)}

    def update(grads, state, params=None):
        if callable(learning_rate):
            updates = torch._foreach_mul(grads, -learning_rate(state["count"]))
        else:
            updates = torch._foreach_mul(grads, -_f32(learning_rate))
        state["count"].add_(1)
        return updates, state

    return GradientTransformation(init, update)


def trace(decay: float, nesterov: bool = False) -> GradientTransformation:
    """Momentum: ``trace = g + decay * trace``; the update is the trace, or
    ``g + decay * trace`` with Nesterov."""
    def init(params):
        return {"trace": [torch.zeros_like(p) for p in params]}

    def update(grads, state, params=None):
        tr = state["trace"]
        torch._foreach_mul_(tr, decay)
        torch._foreach_add_(tr, grads)
        if nesterov:
            updates = torch._foreach_mul(tr, decay)
            torch._foreach_add_(updates, grads)
        else:
            updates = [t.clone() for t in tr]
        return updates, {"trace": tr}

    return GradientTransformation(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> GradientTransformation:
    """optax's rmsprop scaling: ``nu`` starts at ``initial_scale`` (0), and
    eps sits inside the square root: ``g / sqrt(nu + eps)``."""
    def init(params):
        return {"nu": [torch.full_like(p, initial_scale) for p in params]}

    def update(grads, state, params=None):
        nu = state["nu"]
        torch._foreach_mul_(nu, decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - decay)
        denom = torch._foreach_add(nu, eps)
        torch._foreach_sqrt_(denom)
        return torch._foreach_div(grads, denom), {"nu": nu}

    return GradientTransformation(init, update)


def scale_by_rss(initial_accumulator_value: float = 0.1,
                 eps: float = 1e-7) -> GradientTransformation:
    """optax's adagrad scaling: the sum of squares starts at
    ``initial_accumulator_value`` (0.1), and the update is
    ``g / sqrt(sum + eps)`` (0 where the sum is 0)."""
    def init(params):
        return {"sum": [torch.full_like(p, initial_accumulator_value)
                        for p in params]}

    def update(grads, state, params=None):
        acc = state["sum"]
        torch._foreach_addcmul_(acc, grads, grads)
        updates = []
        for g, s in zip(grads, acc):
            inv = torch.where(s > 0, torch.rsqrt(s + eps),
                              torch.zeros((), dtype=s.dtype, device=s.device))
            updates.append(inv * g)
        return updates, {"sum": acc}

    return GradientTransformation(init, update)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32."""
    return torch.linalg.vector_norm(
        torch.stack([n.float() for n in torch._foreach_norm(list(tensors))]))


def clip_by_global_norm(max_norm: float) -> GradientTransformation:
    """Scale the updates by ``max_norm / norm`` when their global norm is
    ``max_norm`` or more (decided on the device, no host sync)."""
    def update(grads, state, params=None):
        norm = global_norm(grads)
        clipped = norm >= max_norm
        return [torch.where(clipped, g / norm.to(g.dtype) * max_norm, g)
                for g in grads], state

    return GradientTransformation(lambda params: {}, update)


def chain(*txs: GradientTransformation) -> GradientTransformation:
    def init(params):
        return [tx.init(params) for tx in txs]

    def update(grads, state, params=None):
        new_state = []
        for tx, st in zip(txs, state):
            grads, st = tx.update(grads, st, params)
            new_state.append(st)
        return grads, new_state

    return GradientTransformation(init, update)


def apply_updates(params: Tensors, updates: Tensors) -> None:
    """``params += updates``, in place (the parameters are leaves that
    autograd tracks, so under ``no_grad``)."""
    with torch.no_grad():
        torch._foreach_add_(params, updates)


# -- the optimizers -----------------------------------------------------------

# -- optax's layout of the state -------------------------------------------------

Layout = Callable[[Tensors], Any]  # per-parameter tensors -> the params tree


class Tied:
    """One leaf of optax's state held by several tensors of the port's:
    read from the first (as ``dtype``), written to all."""

    def __init__(self, tensors: Tensors, dtype: torch.dtype = torch.int32):
        self.tensors, self.dtype = list(tensors), dtype

    def read(self) -> torch.Tensor:
        return self.tensors[0].detach().to(self.dtype)

    def write(self, value: Any) -> None:
        for t in self.tensors:
            t.fill_(value.item() if hasattr(value, "item") else value)


def snapshot(tree: Any) -> Any:
    """An optax-layout tree with each :class:`Tied` leaf read into a tensor
    (the rest as they are): what a checkpoint stores."""
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree.read() if isinstance(tree, Tied) else tree


def load_optax(live: Any, saved: Any) -> None:
    """Copy ``saved`` (an optax-layout tree of arrays) into ``live``'s
    tensors in place.  Raises ``ValueError`` naming the first leaf where
    the two layouts differ (a missing or extra leaf, another shape): a
    state that does not fit is never dropped quietly."""
    from ...core import checkpoint as ckpt_io
    # leaf paths, not the whole structure: the JAX package keeps an empty
    # subtree where a ShardedEmbedding table left the dense tree
    lp, sp = ckpt_io.leaf_paths(live), ckpt_io.leaf_paths(saved)
    if lp != sp:
        diff = next((f"{a!r} (saved) vs {b!r} (optimizer)"
                     for a, b in zip(sp, lp) if a != b),
                    f"{(sp + lp)[min(len(sp), len(lp))]!r}: the saved "
                    f"state has {len(sp)} leaves, the optimizer {len(lp)}")
        raise ValueError(
            "optimizer state in the checkpoint does not match the "
            f"configured optimizer's layout at leaf {diff}")
    with torch.no_grad():
        for path, dst, src in zip(lp, ckpt_io.flatten(live)[0],
                                  ckpt_io.flatten(saved)[0]):
            src = torch.as_tensor(np.asarray(src)) \
                if not isinstance(src, torch.Tensor) else src
            if isinstance(dst, Tied):
                dst.write(src)
                continue
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(
                    f"optimizer state leaf {path!r}: the checkpoint's shape "
                    f"{tuple(src.shape)} is not the optimizer's "
                    f"{tuple(dst.shape)}")
            dst.copy_(src.to(dst.dtype))


def _schedule_state(learning_rate: Any, count: torch.Tensor) -> tuple:
    """optax's ``scale_by_learning_rate`` state: ``(count,)`` under a
    schedule, the empty state for a constant."""
    return (Tied([count]),) if callable(learning_rate) else ()


class Optimizer:
    """An update rule over a list of parameters: ``init(params)`` makes its
    state; ``step(params, grads, state)`` updates ``params`` in place (they
    may be leaves that autograd tracks) and returns the new state;
    ``optax_state(params, state, layout)`` gives the state in optax's
    layout (see the module docstring)."""

    def init(self, params: Tensors) -> Any:
        raise NotImplementedError

    def step(self, params: Tensors, grads: Tensors, state: Any) -> Any:
        raise NotImplementedError

    def optax_state(self, params: Tensors, state: Any,
                    layout: Layout) -> Any:
        raise NotImplementedError(
            f"{type(self).__name__} has no optax layout: only the named "
            f"optimizers ({sorted(_FACTORIES)}) checkpoint their state")


class Transformed(Optimizer):
    """A ``GradientTransformation``, its updates added to the parameters.
    ``layout(state, layout)``, given by the named factories, maps its state
    to optax's layout."""

    def __init__(self, tx: GradientTransformation,
                 layout: Optional[Callable[[Any, Layout], Any]] = None):
        self.tx, self._layout = tx, layout

    def init(self, params):
        return self.tx.init(params)

    def step(self, params, grads, state):
        updates, state = self.tx.update(grads, state, params)
        apply_updates(params, updates)
        return state

    def optax_state(self, params, state, layout):
        if self._layout is None:
            return super().optax_state(params, state, layout)
        return self._layout(state, layout)


class TorchOptim(Optimizer):
    """A ``torch.optim`` optimizer configured to optax's formula, fused on
    the card.  A schedule's learning rate is an f32 tensor on the device,
    written before each step from the schedule at the update count (0 for
    the first update, as in optax) and read by the step where it lies;
    Adam and AdamW are ``capturable`` on the card (their step counts on
    the device too), so the whole update replays in a CUDA graph.  A
    constant float learning rate stays a float."""

    def __init__(self, cls: type, learning_rate: Any, **options: Any):
        self.cls, self.learning_rate, self.options = \
            cls, learning_rate, options

    def init(self, params):
        fused = all(p.is_cuda for p in params)
        lr = self.learning_rate
        if callable(lr):
            lr = torch.zeros((), dtype=torch.float32,
                             device=params[0].device)
        options = dict(self.options)
        if fused and self.cls is not torch.optim.SGD:
            options["capturable"] = True
        return {"count": _new_count(params), "lr": lr, "optim": self.cls(
            params, lr=lr, fused=fused or None, **options)}

    def step(self, params, grads, state):
        optim = state["optim"]
        if callable(self.learning_rate):
            state["lr"].copy_(self.learning_rate(state["count"]))
        for p, g in zip(params, grads):
            # the fused step wants each gradient in its parameter's layout;
            # a conv kernel's gradient comes back channels_last
            p.grad = g if g.stride() == p.stride() \
                else torch.empty_like(p).copy_(g)
        optim.step()
        for p in params:
            p.grad = None
        state["count"].add_(1)
        return state

    def optax_state(self, params, state, layout):
        optim = state["optim"]
        group = optim.param_groups[0]
        sched = _schedule_state(self.learning_rate, state["count"])
        if self.cls is torch.optim.SGD:
            if not group["momentum"]:
                return ((), sched)  # optax.sgd: identity, then the lr
            bufs = []
            for p in params:
                st = optim.state[p]
                if st.get("momentum_buffer") is None:
                    # torch's first step sets the buffer to the gradient,
                    # as 0 * momentum + gradient does
                    st["momentum_buffer"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format)
                bufs.append(st["momentum_buffer"])
            return ((layout(bufs),), sched)
        on_device = group["capturable"] or group["fused"]
        for p in params:  # torch.optim.Adam's lazy state, made now
            st = optim.state[p]
            if not st:
                st["step"] = (torch.zeros((), dtype=torch.float32,
                                          device=p.device) if on_device
                              else torch.tensor(0.0, dtype=torch.float32))
                st["exp_avg"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
                st["exp_avg_sq"] = torch.zeros_like(
                    p, memory_format=torch.preserve_format)
        sts = [optim.state[p] for p in params]
        adam = (Tied([st["step"] for st in sts] + [state["count"]]),
                layout([st["exp_avg"] for st in sts]),
                layout([st["exp_avg_sq"] for st in sts]))
        if self.cls is torch.optim.AdamW:  # + add_decayed_weights' state
            return (adam, (), sched)
        return (adam, sched)


class Clipped(Optimizer):
    """``inner`` after global-norm clipping of the gradients, which
    ``optax.chain`` puts first in the JAX package."""

    def __init__(self, inner: Optimizer, max_norm: float):
        self.inner, self.clip = inner, clip_by_global_norm(max_norm)

    def init(self, params):
        return self.inner.init(params)

    def step(self, params, grads, state):
        grads, _ = self.clip.update(grads, {}, None)
        return self.inner.step(params, grads, state)

    def optax_state(self, params, state, layout):
        # optax.chain(clip_by_global_norm, tx): the clip's state is empty
        return ((), self.inner.optax_state(params, state, layout))


class Masked(Optimizer):
    """``inner`` over the trainable parameters of an estimator with
    ``frozen=``, which leaves the frozen ones out of ``params``: they get
    no update and no weight decay, as under the JAX package's
    ``optax.multi_transform({"train": tx, "freeze": set_to_zero()},
    labels)``.  Its optax layout is that transform's state as a checkpoint
    stores it: ``MultiTransformState(inner_states={"freeze":
    MaskedState(EmptyState()), "train": MaskedState(<inner's state>)})``
    as tuples, the inner state over the trainable parameters only (optax
    puts an empty ``MaskedNode`` where a frozen one was: no leaf)."""

    def __init__(self, inner: Optimizer):
        self.inner = inner

    def init(self, params):
        return self.inner.init(params)

    def step(self, params, grads, state):
        return self.inner.step(params, grads, state)

    def optax_state(self, params, state, layout):
        return ({"freeze": ((),),
                 "train": (self.inner.optax_state(params, state, layout),)},)


# sgd, momentum, adam and adamw are torch.optim's rules under optax's
# defaults (optax.adamw decays weights by 1e-4, torch.optim.AdamW by 0.01);
# optax's rmsprop and adagrad place eps and start their accumulators
# differently from torch's, so they are written out above.

def sgd(learning_rate: Any, momentum: Optional[float] = None,
        nesterov: bool = False) -> Optimizer:
    return TorchOptim(torch.optim.SGD, learning_rate,
                      momentum=momentum or 0.0,
                      nesterov=bool(nesterov and momentum))


def adam(learning_rate: Any, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Optimizer:
    return TorchOptim(torch.optim.Adam, learning_rate, betas=(b1, b2),
                      eps=eps)


def adamw(learning_rate: Any, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-8, weight_decay: float = 1e-4) -> Optimizer:
    return TorchOptim(torch.optim.AdamW, learning_rate, betas=(b1, b2),
                      eps=eps, weight_decay=weight_decay)


def rmsprop(learning_rate: Any, decay: float = 0.9, eps: float = 1e-8,
            initial_scale: float = 0.0, momentum: Optional[float] = None,
            nesterov: bool = False) -> Optimizer:
    tail = [trace(momentum, nesterov)] if momentum is not None else []

    def layout(state, tree):
        # optax.rmsprop: (ScaleByRmsState(nu), lr state, TraceState(trace)
        # or the identity's empty state)
        traced = ((tree(state[2]["trace"]),) if momentum is not None
                  else ())
        return ((tree(state[0]["nu"]),),
                _schedule_state(learning_rate, state[1]["count"]), traced)

    return Transformed(chain(scale_by_rms(decay, eps, initial_scale),
                             scale_by_learning_rate(learning_rate), *tail),
                       layout)


def adagrad(learning_rate: Any, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Optimizer:
    def layout(state, tree):
        # optax.adagrad: (ScaleByRssState(sum_of_squares), lr state)
        return ((tree(state[0]["sum"]),),
                _schedule_state(learning_rate, state[1]["count"]))

    return Transformed(chain(scale_by_rss(initial_accumulator_value, eps),
                             scale_by_learning_rate(learning_rate)), layout)


_FACTORIES = {
    "sgd": lambda lr, **kw: sgd(lr, **kw),
    "momentum": lambda lr, **kw: sgd(lr, momentum=kw.pop("momentum", 0.9),
                                     **kw),
    "adam": lambda lr, **kw: adam(lr, **kw),
    "adamw": lambda lr, **kw: adamw(lr, **kw),
    "rmsprop": lambda lr, **kw: rmsprop(lr, **kw),
    "adagrad": lambda lr, **kw: adagrad(lr, **kw),
}
_NOT_PORTED = ("lamb", "lars")


def get(optimizer: Any, learning_rate: Optional[Any] = None,
        grad_clip_norm: Optional[float] = None,
        **kwargs: Any) -> Optimizer:
    """Resolve an optimizer spec: an ``Optimizer`` or a
    ``GradientTransformation`` (used as is), a name, or None (adam, lr
    1e-3).  ``grad_clip_norm`` clips the gradients' global norm first, as
    ``optax.chain`` does in the JAX package."""
    if optimizer is None:
        optimizer = "adam"
    learning_rate = resolve_learning_rate(learning_rate)
    if isinstance(optimizer, str):
        name = optimizer.lower()
        if name in _NOT_PORTED:
            raise NotImplementedError(
                f"optimizer {optimizer!r} is not ported yet (ROADMAP "
                f"Queue 1 item 14); ported: {sorted(_FACTORIES)}")
        if name not in _FACTORIES:
            raise ValueError(f"unknown optimizer {optimizer!r}; known: "
                             f"{sorted(_FACTORIES)}")
        opt = _FACTORIES[name](learning_rate if learning_rate is not None
                               else 1e-3, **kwargs)
    elif isinstance(optimizer, GradientTransformation):
        opt = Transformed(optimizer)
    elif isinstance(optimizer, Optimizer):
        opt = optimizer
    else:
        raise TypeError(f"optimizer must be a name, an Optimizer or a "
                        f"GradientTransformation, not {type(optimizer)}")
    if grad_clip_norm is not None:
        opt = Clipped(opt, grad_clip_norm)
    return opt
