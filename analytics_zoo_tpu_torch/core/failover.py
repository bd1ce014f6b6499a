# Port of analytics_zoo_tpu/core/failover.py: the flag's consensus is an
# allgather over the context's host group (torch.distributed) instead of
# jax.experimental.multihost_utils.
"""Preemption-safe training: SIGTERM → checkpoint → resume.

Reference (SURVEY.md §5.3): failure recovery ran through Spark — lost
executors were rescheduled and training restarted from the last BigDL
``set_checkpoint`` snapshot; Ray actors were respawned by RayContext.

The platform preempts a machine by SIGTERM with a grace window and
restarts the job itself; the framework's job is only (1) to get a
checkpoint written inside the window and (2) to resume from it on
restart.  The guard checks its flag every ``sync_every`` steps, and over
several processes allgathers it there over the host group
(``core/context.py``), so that every process saves at one step; in one
process the flag alone decides.

Usage (wired into ZooEstimator via ``preemption_checkpoint=True``):

    est = Estimator.from_keras(model, loss=..., model_dir="ckpt",
                               preemption_checkpoint=True)
    # (analytics_zoo_tpu_torch.orca.learn.Estimator)
    try:
        est.fit(data, epochs=100, auto_resume=True)
    except Preempted:
        sys.exit(143)   # platform restarts the job; next run auto-resumes
"""

from __future__ import annotations

import logging
import signal
import threading
from typing import Optional

logger = logging.getLogger("analytics_zoo_tpu_torch")


class Preempted(BaseException):
    """Raised (after the checkpoint is safely written) when training was
    interrupted by SIGTERM/SIGINT.  BaseException so generic ``except
    Exception`` retry loops don't swallow a shutdown request.

    ``step`` is the recovery point: the step made durable by the exit
    save when one landed (``durable=True``), else the step training
    stopped at.  ``durable=False`` means the grace-window save did NOT
    land — resume falls back to an older generation, so callers must
    not assume ``step`` is on disk."""

    def __init__(self, step: int, path: Optional[str],
                 durable: bool = True):
        state = "checkpoint" if durable else "checkpoint NOT durable; dir"
        super().__init__(f"preempted at step {step}; {state}: {path}")
        self.step = step
        self.path = path
        self.durable = durable


class PreemptionGuard:
    """Signal flag + cross-host consensus.

    ``should_checkpoint(step)`` is cheap between sync points (a bool read);
    at every ``sync_every``-th step it allgathers the flag so all hosts
    agree on the save step.  Single-process: the flag alone decides."""

    def __init__(self, sync_every: int = 10,
                 signals=(signal.SIGTERM, signal.SIGINT)):
        self.sync_every = max(1, sync_every)
        self.active = False   # True only inside fit(): flag-and-continue
        # Plain bool, NO lock: the handler runs on the main thread between
        # bytecodes, so a lock shared with main-thread readers can deadlock
        # the process exactly during preemption.  A bool store/load is atomic
        # under the GIL.
        self._flag = False
        self._pending_signum = 0  # logged lazily, outside the handler
        self._prev_handlers = {}
        self._installed = False
        self._signals = signals

    def install(self) -> "PreemptionGuard":
        if self._installed:
            return self
        if threading.current_thread() is not threading.main_thread():
            logger.warning(
                "PreemptionGuard.install() called off the main thread: "
                "signal handlers CANNOT be registered — preemption "
                "checkpointing is disabled for this estimator")
            return self
        for sig in self._signals:
            self._prev_handlers[sig] = signal.signal(sig, self._on_signal)
        self._installed = True
        return self

    def uninstall(self) -> None:
        if not self._installed:
            return
        for sig, prev in self._prev_handlers.items():
            try:
                signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_handlers.clear()
        self._installed = False

    def _on_signal(self, signum, frame) -> None:
        if not self.active:
            # not inside fit(): nothing to checkpoint — behave like the
            # original handler (Ctrl+C raises KeyboardInterrupt, SIGTERM
            # terminates) instead of silently swallowing the signal
            prev = self._prev_handlers.get(signum)
            if callable(prev):
                prev(signum, frame)
                return
            if prev == signal.SIG_DFL:
                signal.signal(signum, signal.SIG_DFL)
                signal.raise_signal(signum)
            return
        # Async-signal-safe body: no locks (incl. the logging module's) —
        # just two atomic stores.  The warning is emitted from flagged/
        # should_checkpoint on the next ordinary read.
        self._pending_signum = signum
        self._flag = True

    def _drain_log(self) -> None:
        signum, self._pending_signum = self._pending_signum, 0
        if signum:
            logger.warning(
                "received signal %d: checkpoint at next sync point", signum)

    @property
    def flagged(self) -> bool:
        self._drain_log()
        return self._flag

    def should_checkpoint(self, step: int) -> bool:
        """At every ``sync_every``-th step: was a signal received by any
        process?  (The flags allgathered over the host group; in one
        process the local flag.)"""
        if step % self.sync_every != 0:
            return False
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()) or \
                dist.get_world_size() == 1:
            return self.flagged
        import torch
        from .context import OrcaContext
        group = OrcaContext.host_group
        if group is None and dist.get_backend() == "gloo":
            group = dist.group.WORLD
        flag = torch.tensor([int(self.flagged)], dtype=torch.int32)
        flags = [torch.zeros_like(flag)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(flags, flag, group=group)
        return bool(any(int(f.item()) for f in flags))


def checkpoint_for_exit(manager, tree, step: int, extra=None,
                        touched=None, grace_s: float = 30.0
                        ) -> Optional[int]:
    """The SIGTERM save, via an async :class:`CheckpointManager`
    (core/ckpt_manager.py): bounded time-to-exit inside the platform's
    grace window.

    When a snapshot is already in flight its host copy exists — the
    expensive device sync already happened BEFORE the signal — so the
    fastest consistent exit is to drain the writer and report that
    snapshot's step, accepting a slightly older recovery point.  Only
    when nothing is in flight does this take a fresh (blocking) save.
    Returns the step made durable, or None when nothing landed inside
    ``grace_s`` (the caller exits anyway; resume falls back to the
    previous visible generation — crash consistency does not depend on
    this save landing).
    """
    saved = manager.save_for_exit(tree, step, extra=extra,
                                  touched=touched, timeout=grace_s)
    if saved is None:
        logger.warning(
            "preemption save did not land within the %.1fs grace "
            "window; resume will use the previous generation", grace_s)
    elif saved != step:
        logger.info(
            "preemption exit reused the in-flight snapshot of step %d "
            "(current step %d)", saved, step)
    return saved
