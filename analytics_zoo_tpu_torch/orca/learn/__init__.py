"""The Estimator, its optimizers and checkpoint triggers (port of
``analytics_zoo_tpu.orca.learn``, single-device core)."""

from . import optimizers
from .estimator import Estimator, ZooEstimator
from .gan import GANEstimator
from .trigger import EveryEpoch, SeveralIteration, Trigger

__all__ = ["Estimator", "ZooEstimator", "GANEstimator", "EveryEpoch",
           "SeveralIteration", "Trigger", "optimizers"]
