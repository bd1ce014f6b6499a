"""The Estimator and its optimizers (port of ``analytics_zoo_tpu.orca.learn``,
single-device core)."""

from . import optimizers
from .estimator import Estimator, ZooEstimator

__all__ = ["Estimator", "ZooEstimator", "optimizers"]
