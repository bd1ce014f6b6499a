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
1e-3, "warmup_steps": 100, "decay_steps": 1000}``.  LARS and LAMB are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

Tensors = List[torch.Tensor]
Schedule = Callable[[int], float]


class GradientTransformation(NamedTuple):
    """``init(params) -> state``; ``update(grads, state, params) ->
    (updates, state)``, all on lists of tensors in one order."""
    init: Callable[[Tensors], Any]
    update: Callable[[Tensors, Any, Optional[Tensors]], Tuple[Tensors, Any]]


# -- schedules ----------------------------------------------------------------

def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int,
                        transition_begin: int = 0) -> Schedule:
    if transition_steps <= 0:
        return lambda count: init_value
    transition_begin = max(0, transition_begin)

    def schedule(count: int) -> float:
        c = min(max(count - transition_begin, 0), transition_steps)
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
        return lambda count: init_value
    transition_begin = max(0, transition_begin)

    def schedule(count: int) -> float:
        dec = count - transition_begin
        p = dec / transition_steps
        if staircase:
            p = math.floor(p)
        value = init_value if dec <= 0 else init_value * decay_rate ** p
        if end_value is not None:
            value = (max if decay_rate < 1.0 else min)(value, end_value)
        return value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0,
                          exponent: float = 1.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule needs positive decay_steps, "
                         f"got {decay_steps}")

    def schedule(count: int) -> float:
        c = min(count, decay_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / decay_steps))
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

    def schedule(count: int) -> float:
        return warm(count) if count < warmup_steps else \
            decay(count - warmup_steps)
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
    "constant": lambda lr, **kw: (lambda count: lr),
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


def scale_by_learning_rate(learning_rate: Any) -> GradientTransformation:
    """Multiply by ``-learning_rate`` (at the update count, from 0, for a
    schedule)."""
    def init(params):
        return {"count": 0}

    def update(grads, state, params=None):
        lr = learning_rate(state["count"]) if callable(learning_rate) \
            else learning_rate
        return torch._foreach_mul(grads, -_f32(lr)), \
            {"count": state["count"] + 1}

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

class Optimizer:
    """An update rule over a list of parameters: ``init(params)`` makes its
    state; ``step(params, grads, state)`` updates ``params`` in place (they
    may be leaves that autograd tracks) and returns the new state."""

    def init(self, params: Tensors) -> Any:
        raise NotImplementedError

    def step(self, params: Tensors, grads: Tensors, state: Any) -> Any:
        raise NotImplementedError


class Transformed(Optimizer):
    """A ``GradientTransformation``, its updates added to the parameters."""

    def __init__(self, tx: GradientTransformation):
        self.tx = tx

    def init(self, params):
        return self.tx.init(params)

    def step(self, params, grads, state):
        updates, state = self.tx.update(grads, state, params)
        apply_updates(params, updates)
        return state


class TorchOptim(Optimizer):
    """A ``torch.optim`` optimizer configured to optax's formula, fused on
    the card.  Its learning rate is set before each step from the schedule
    at the update count (0 for the first update, as in optax)."""

    def __init__(self, cls: type, learning_rate: Any, **options: Any):
        self.cls, self.learning_rate, self.options = \
            cls, learning_rate, options

    def _lr(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count) if callable(lr) else lr)

    def init(self, params):
        fused = all(p.is_cuda for p in params)
        return {"count": 0, "optim": self.cls(
            params, lr=self._lr(0), fused=fused or None, **self.options)}

    def step(self, params, grads, state):
        optim, count = state["optim"], state["count"]
        for group in optim.param_groups:
            group["lr"] = self._lr(count)
        for p, g in zip(params, grads):
            # the fused step wants each gradient in its parameter's layout;
            # a conv kernel's gradient comes back channels_last
            p.grad = g if g.stride() == p.stride() \
                else torch.empty_like(p).copy_(g)
        optim.step()
        for p in params:
            p.grad = None
        return {"count": count + 1, "optim": optim}


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
    return Transformed(chain(scale_by_rms(decay, eps, initial_scale),
                             scale_by_learning_rate(learning_rate), *tail))


def adagrad(learning_rate: Any, initial_accumulator_value: float = 0.1,
            eps: float = 1e-7) -> Optimizer:
    return Transformed(chain(scale_by_rss(initial_accumulator_value, eps),
                             scale_by_learning_rate(learning_rate)))


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
                f"Queue 1 item 7); ported: {sorted(_FACTORIES)}")
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
