# Port of analytics_zoo_tpu/automl/search.py: a copy with its imports pointed
# at the port (the trial metrics go to its core/metrics.py registry).
"""Search engines + ASHA early stopping.

Reference (SURVEY.md §2.5): ``SearchEngine`` abstraction with a
``RayTuneSearchEngine`` implementation (pyzoo/zoo/orca/automl/search/) —
Tune workers trained one trial each, the ASHA scheduler killed stragglers.

A trial is ``fn(config, report) -> result``; ``report(metric, step)``
streams intermediate results so ASHA can stop a trial early (the callback
raises StopTrial).  Engines run trials in-process — sequential by default
(one card = one trial at a time; the reference's parallelism came from
having a CPU cluster), optional thread pool for host-bound trials (the
Estimator's device lock serialises their fit/evaluate/predict bodies).
"""

from __future__ import annotations

import logging
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from . import hp as hp_mod

logger = logging.getLogger("analytics_zoo_tpu_torch")


class StopTrial(Exception):
    """Raised inside report() when the scheduler prunes the trial."""


class TrialTimeout(Exception):
    """A trial exceeded its wall-clock budget (``trial_timeout_s``)."""


@dataclass
class Trial:
    trial_id: int
    config: Dict[str, Any]
    metric: Optional[float] = None     # best reported (per mode)
    history: List[float] = field(default_factory=list)
    status: str = "pending"            # pending | done | pruned | error
    #                                  # | timeout
    error: Optional[str] = None
    duration_s: float = 0.0
    retries: int = 0                   # transient-failure retries used


class ASHAScheduler:
    """Asynchronous Successive Halving: at each rung (step budget
    grace_period * reduction_factor^k), a trial continues only if its metric
    is in the top 1/reduction_factor of completed rung results."""

    def __init__(self, metric_mode: str = "min", grace_period: int = 1,
                 reduction_factor: int = 3, max_t: int = 100):
        self.mode = metric_mode
        self.grace = grace_period
        self.rf = reduction_factor
        self.max_t = max_t
        self._rungs: Dict[int, List[float]] = {}
        self._lock = threading.Lock()

    def _rung_of(self, step: int) -> Optional[int]:
        t = self.grace
        while t <= self.max_t:
            if step == t:
                return t
            t *= self.rf
        return None

    def on_report(self, trial: Trial, metric: float, step: int) -> bool:
        """Returns False if the trial should be pruned now."""
        rung = self._rung_of(step)
        if rung is None:
            return True
        key = metric if self.mode == "min" else -metric
        with self._lock:
            peers = self._rungs.setdefault(rung, [])
            peers.append(key)
            if len(peers) < self.rf:      # not enough evidence yet
                return True
            cutoff = np.quantile(peers, 1.0 / self.rf)
            return key <= cutoff


class SearchEngine:
    """Base: subclasses yield configs; run_trials executes + tracks them."""

    def __init__(self, metric_mode: str = "min",
                 scheduler: Optional[ASHAScheduler] = None,
                 max_concurrent: int = 1, seed: int = 0,
                 trial_timeout_s: Optional[float] = None,
                 trial_retries: int = 0):
        """``trial_timeout_s``: per-trial wall-clock budget — a trial past
        it is marked ``status="timeout"`` (keeping any partial metric from
        its reports) instead of wedging the whole search.  Enforced
        cooperatively at every ``report()`` call AND by a hard wall (the
        trial runs on an abandonable daemon thread; a trial that never
        reports and never returns leaks that thread — acceptable for
        host-bound trial bodies, the only kind that wedges).

        ``trial_retries``: transient trial failures (any exception) are
        retried up to this many times before the trial is marked
        ``error``; the count used is recorded on ``Trial.retries``."""
        self.mode = metric_mode
        self.scheduler = scheduler
        self.max_concurrent = max_concurrent
        self.trial_timeout_s = trial_timeout_s
        self.trial_retries = max(0, trial_retries)
        self.rng = np.random.default_rng(seed)
        self.trials: List[Trial] = []

    def configs(self, space: Dict[str, Any], n_trials: int
                ) -> List[Dict[str, Any]]:
        raise NotImplementedError

    def run(self, trial_fn: Callable, space: Dict[str, Any],
            n_trials: int = 8) -> Trial:
        """trial_fn(config, report) → final metric (float) or dict with
        'metric'.  Returns the best Trial."""
        configs = self.configs(space, n_trials)
        self.trials = [Trial(i, c) for i, c in enumerate(configs)]

        def execute(trial: Trial) -> None:
            t0 = time.monotonic()
            deadline = (t0 + self.trial_timeout_s
                        if self.trial_timeout_s else None)

            def report(metric: float, step: int) -> None:
                if deadline is not None and time.monotonic() > deadline:
                    raise TrialTimeout()  # cooperative wall-clock stop
                trial.history.append(float(metric))
                # retry attempts do not re-feed the shared ASHA rungs: the
                # first attempt already contributed this trial's evidence
                # there, and duplicate samples would skew every sibling's
                # promotion cutoff.  (They also forgo pruning — a retried
                # transient failure should run out its budget.)
                if (self.scheduler and trial.retries == 0
                        and not self.scheduler.on_report(
                            trial, float(metric), step)):
                    raise StopTrial()

            def partial_metric() -> None:
                if trial.history:
                    trial.metric = (min(trial.history) if self.mode == "min"
                                    else max(trial.history))

            trial.status = "running"
            while True:
                trial.history.clear()  # fresh attempt, fresh reports
                try:
                    out = _call_with_deadline(
                        trial_fn, (dict(trial.config), report), deadline)
                    metric = out["metric"] if isinstance(out, dict) else out
                    trial.metric = float(metric)
                    trial.status = "done"
                    trial.error = None  # a retried failure that healed
                except StopTrial:
                    trial.status = "pruned"
                    partial_metric()
                except TrialTimeout:
                    trial.status = "timeout"
                    partial_metric()  # partial evidence is still evidence
                    logger.warning("trial %d timed out after %.1fs",
                                   trial.trial_id, self.trial_timeout_s)
                except Exception as e:  # noqa: BLE001 — trials fail freely
                    trial.error = f"{type(e).__name__}: {e}"
                    if trial.retries < self.trial_retries:
                        trial.retries += 1
                        logger.warning(
                            "trial %d failed transiently (%s); retry %d/%d",
                            trial.trial_id, trial.error, trial.retries,
                            self.trial_retries)
                        continue
                    trial.status = "error"
                    logger.warning("trial %d failed: %s", trial.trial_id,
                                   trial.error)
                break
            trial.duration_s = time.monotonic() - t0
            # per-trial telemetry (core/metrics.py): search throughput
            # and outcome mix, without holding the engine object
            from ..core import metrics as metrics_lib
            reg = metrics_lib.get_registry()
            reg.observe("automl.trial_ms", trial.duration_s * 1000.0)
            reg.inc("automl.trials", status=trial.status)

        if self.max_concurrent > 1:
            with ThreadPoolExecutor(self.max_concurrent) as pool:
                list(pool.map(execute, self.trials))
        else:
            for t in self.trials:
                execute(t)

        scored = [t for t in self.trials if t.metric is not None]
        if not scored:
            errs = [t.error for t in self.trials if t.error]
            raise RuntimeError(f"all {len(self.trials)} trials failed; "
                               f"first error: {errs[0] if errs else '?'}")
        best = (min if self.mode == "min" else max)(
            scored, key=lambda t: t.metric)
        logger.info("search done: best trial %d metric=%.5f config=%s",
                    best.trial_id, best.metric, best.config)
        return best


def _call_with_deadline(fn: Callable, args: tuple,
                        deadline: Optional[float]) -> Any:
    """Run ``fn(*args)`` with a hard wall clock: past ``deadline`` the
    caller gets ``TrialTimeout`` while the work runs out its course on an
    abandoned daemon thread (Python cannot kill a thread; the cooperative
    ``report()`` deadline check is what actually stops well-behaved
    trials)."""
    if deadline is None:
        return fn(*args)
    box: Dict[str, Any] = {}

    def run() -> None:
        try:
            box["out"] = fn(*args)
        except BaseException as e:  # noqa: BLE001 — re-raised by caller
            box["exc"] = e

    th = threading.Thread(target=run, daemon=True, name="zoo-trial")
    th.start()
    th.join(timeout=max(0.0, deadline - time.monotonic()))
    if th.is_alive():
        raise TrialTimeout()
    if "exc" in box:
        raise box["exc"]
    return box["out"]


class RandomSearchEngine(SearchEngine):
    def configs(self, space, n_trials):
        return [hp_mod.sample(space, self.rng) for _ in range(n_trials)]


class GridSearchEngine(SearchEngine):
    def configs(self, space, n_trials):
        grid = hp_mod.grid(space)
        if n_trials and len(grid) > n_trials:
            idx = self.rng.permutation(len(grid))[:n_trials]
            grid = [grid[i] for i in idx]
        return grid
