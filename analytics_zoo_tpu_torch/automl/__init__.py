"""AutoML of the port (``analytics_zoo_tpu/automl``): the search-space
DSL, the search engines with ASHA early stopping, trial timeouts and
retries, and ``AutoEstimator`` over the port's Estimator.  Trials are
Python callables run in-process, sequentially or from a thread pool."""

from . import hp
from .search import (ASHAScheduler, GridSearchEngine, RandomSearchEngine,
                     SearchEngine, StopTrial, Trial, TrialTimeout)
from .auto_estimator import AutoEstimator

__all__ = ["hp", "AutoEstimator", "SearchEngine", "RandomSearchEngine",
           "GridSearchEngine", "ASHAScheduler", "Trial", "StopTrial",
           "TrialTimeout"]
