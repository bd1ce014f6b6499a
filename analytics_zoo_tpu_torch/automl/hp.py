# Port of analytics_zoo_tpu/automl/hp.py: a copy (numpy only).
"""Search-space DSL (reference: zoo.orca.automl.hp —
pyzoo/zoo/orca/automl/hp.py wrapped Ray Tune's sample primitives).

Same API surface: ``hp.choice/uniform/quniform/loguniform/randint/grid_search``
— self-contained sampling objects, no Tune dependency.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Sequence

import numpy as np


class Sampler:
    def sample(self, rng: np.random.Generator) -> Any:
        raise NotImplementedError

    def grid_values(self) -> List[Any]:
        """Discretization for grid search (continuous: a small linspace)."""
        raise NotImplementedError


@dataclass
class Choice(Sampler):
    options: Sequence[Any]

    def sample(self, rng):
        return self.options[int(rng.integers(0, len(self.options)))]

    def grid_values(self):
        return list(self.options)


@dataclass
class Uniform(Sampler):
    lower: float
    upper: float

    def sample(self, rng):
        return float(rng.uniform(self.lower, self.upper))

    def grid_values(self):
        return list(np.linspace(self.lower, self.upper, 3))


@dataclass
class QUniform(Sampler):
    lower: float
    upper: float
    q: float = 1.0

    def sample(self, rng):
        v = rng.uniform(self.lower, self.upper)
        return float(np.round(v / self.q) * self.q)

    def grid_values(self):
        vals = np.arange(self.lower, self.upper + self.q / 2, self.q)
        return [float(v) for v in vals[:10]]


@dataclass
class LogUniform(Sampler):
    lower: float
    upper: float

    def sample(self, rng):
        return float(np.exp(rng.uniform(np.log(self.lower),
                                        np.log(self.upper))))

    def grid_values(self):
        return list(np.exp(np.linspace(np.log(self.lower),
                                       np.log(self.upper), 3)))


@dataclass
class RandInt(Sampler):
    lower: int
    upper: int  # exclusive, Tune semantics

    def sample(self, rng):
        return int(rng.integers(self.lower, self.upper))

    def grid_values(self):
        step = max(1, (self.upper - self.lower) // 3)
        return list(range(self.lower, self.upper, step))


@dataclass
class GridSearch(Sampler):
    options: Sequence[Any]

    def sample(self, rng):  # random engines treat grid like choice
        return self.options[int(rng.integers(0, len(self.options)))]

    def grid_values(self):
        return list(self.options)


def choice(options: Sequence[Any]) -> Choice:
    return Choice(list(options))


def uniform(lower: float, upper: float) -> Uniform:
    return Uniform(lower, upper)


def quniform(lower: float, upper: float, q: float = 1.0) -> QUniform:
    return QUniform(lower, upper, q)


def loguniform(lower: float, upper: float) -> LogUniform:
    return LogUniform(lower, upper)


def randint(lower: int, upper: int) -> RandInt:
    return RandInt(lower, upper)


def grid_search(options: Sequence[Any]) -> GridSearch:
    return GridSearch(list(options))


def sample(space: Dict[str, Any], rng: np.random.Generator) -> Dict[str, Any]:
    """One concrete config from a {name: Sampler-or-literal} space."""
    return {k: (v.sample(rng) if isinstance(v, Sampler) else v)
            for k, v in space.items()}


def grid(space: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Cartesian product over grid_values of every Sampler in the space."""
    import itertools
    keys, value_lists = [], []
    for k, v in space.items():
        keys.append(k)
        value_lists.append(v.grid_values() if isinstance(v, Sampler) else [v])
    return [dict(zip(keys, combo))
            for combo in itertools.product(*value_lists)]
