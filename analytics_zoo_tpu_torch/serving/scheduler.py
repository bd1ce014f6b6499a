# Port of analytics_zoo_tpu/serving/scheduler.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Pluggable batching schedulers for the serving assembly stage.

Before schedulers the batching *policy* WAS the assembly stage: a fixed
batch window hard-coded in ``ClusterServing._assembly_loop``.  That
couples two decisions that production TPU serving keeps separate (the
TensorFlow systems paper in PAPERS.md treats the scheduler as a
first-class dataflow component; the Gemma-on-Cloud-TPU serving playbook
pairs shape-bucketed AOT executables with *continuous admission*): HOW
requests become device batches is now a :class:`Scheduler` the server
is configured with, and the assembly thread just runs it.

Two policies ship:

- :class:`WindowScheduler` (``"window"``, the default) — the
  pre-refactor behavior, verbatim: wait for one request, then hold the
  batch open for ``batch_timeout_ms`` or until ``batch_size`` fills.
  Byte-identical to the old loop for bisection.
- :class:`ContinuousScheduler` (``"continuous"``) — continuous
  batching: admit whatever has *arrived* into the very next device
  step.  The loop blocks only when the system is empty or every
  inference worker is busy (``_assemble_and_dispatch`` backpressures on
  the tiny internal batch queue); the moment a worker frees, everything
  queued since the last step dispatches.  No fixed window tail: at
  light load a lone request's latency is the inference time, not
  inference + window; at saturation batches fill from the backlog, so
  throughput is >= the window batcher's.  Requests pad to
  ``InferenceModel``'s batch buckets exactly as before — with the
  buckets AOT-precompiled at startup (``InferenceModel.warm``), no
  admission decision ever waits on an XLA compile.  Across models, the
  continuous scheduler dequeues **weighted-fair** from per-model
  backlogs (strict ``priority`` tiers, proportional ``weight`` shares
  inside a tier — both from the :class:`~.model_registry.ModelRegistry`).

Every scheduler reports rows admitted per dispatch round into the
``scheduler.admitted_rows`` histogram (labeled by scheduler name).
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Union

from analytics_zoo_tpu_torch.core import metrics as metrics_lib


class Scheduler:
    """Assembly-stage batching policy.

    ``run(server)`` is the assembly thread's whole body: the scheduler
    owns popping the server's native queue (via ``server._take``) and
    MUST route every gathered round through ``_finish_round`` so the
    pipeline's ordering contract holds — the ``serving.model_latency``
    fault point fires in this single ordered stage, health pings are
    answered here (a wedged scheduler fails the probe), deadline sheds
    happen before staging, and ``server._assemble_and_dispatch`` stages
    and hands off to the inference workers.

    A scheduler instance binds to ONE server (``attach``); configure
    each ``ClusterServing`` with its own instance (or a policy name,
    which constructs one)."""

    name = "abstract"

    def attach(self, server: Any) -> None:
        # one instance per server: run()/backlog()/drain_rows() share
        # mutable per-instance state (the continuous backlog), so two
        # servers' assembly threads on one scheduler would interleave —
        # rows admitted through server A could reply through server B
        cur = getattr(self, "server", None)
        if cur is not None and cur is not server:
            raise ValueError(
                f"scheduler instance {self.name!r} is already attached "
                "to another ClusterServing — construct one scheduler "
                "per server (or pass the policy name)")
        self.server = server
        self._m_admitted = server._metrics.histogram(
            "scheduler.admitted_rows", buckets=metrics_lib.SIZE_BUCKETS,
            scheduler=self.name)

    def run(self, server: Any) -> None:
        raise NotImplementedError

    def backlog(self) -> int:
        """Rows admitted from the native queue but not yet dispatched —
        counted into ``stats()['pending']`` so the requests ==
        replies + errors + pending invariant survives scheduler-held
        rows."""
        return 0

    def drain_rows(self) -> List[Any]:
        """Hand back every held row at ``stop()`` time so the server's
        drain can reply ``server shutting down`` instead of silently
        dropping them.  Called after the assembly thread exits."""
        return []

    def held_rows(self) -> List[Any]:
        """NON-destructive view of the rows ``drain_rows`` would hand
        back — the flight recorder reads this to name the in-flight
        work a dying replica holds without disturbing the backlog."""
        return []

    def _finish_round(self, server: Any, batch: List[Any]) -> None:
        # injected latency (armed spec's ``delay``) lands HERE, in the
        # single ordered stage, before shedding — so an armed delay
        # holds the queue (and expires queued deadlines) exactly as the
        # pre-pipeline batcher did, regardless of idle workers
        server._faults.fire("serving.model_latency")
        batch = [p for p in batch if p is not None]
        # health probes are answered from this single ordered stage,
        # after any armed latency — a wedged scheduler fails the probe
        for p in batch:
            if p.ping:
                server._answer_ping(p)
        batch = server._shed_expired([p for p in batch if not p.ping])
        if not batch:
            return
        # per-class ordering: within a round, batch-class
        # rows stage AFTER interactive/unclassified ones, so when a
        # round splits across (model, shape) groups the interactive
        # groups dispatch to a worker first.  The sort is STABLE with a
        # boolean key: a round with no batch-class rows (all klass=None
        # pre-klass traffic) keeps its exact arrival order — bisection.
        if any(p.klass == "batch" for p in batch):
            batch = sorted(batch, key=lambda p: p.klass == "batch")
        self._m_admitted.observe(len(batch))
        server._assemble_and_dispatch(batch)


class WindowScheduler(Scheduler):
    """Fixed batch window — the original assembly loop, moved: wait for
    the first request, then keep the batch open until ``batch_size``
    rows or ``batch_timeout_ms`` elapse.  The bisection baseline: with
    ``scheduler="window"`` the server behaves exactly as before this
    subsystem existed."""

    name = "window"

    def run(self, server: Any) -> None:
        while not server._stop.is_set():
            batch: List[Any] = []
            try:
                item = server._queue.pop(timeout=0.5)
            except RuntimeError:
                return
            if item is None:
                continue
            batch.append(server._take(item[0]))
            # monotonic, not wall-clock: an NTP step backwards would
            # hold the window open (starving the batch) and a step
            # forwards would close it instantly on every iteration
            deadline = time.monotonic() + server.batch_timeout_ms / 1000.0
            while len(batch) < server.batch_size:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    item = server._queue.pop(timeout=left)
                except RuntimeError:
                    break
                if item is None:
                    break
                batch.append(server._take(item[0]))
            self._finish_round(server, batch)


class ContinuousScheduler(Scheduler):
    """Continuous batching with weighted-fair multi-model dequeue.

    Each round: (1) **fill** — drain whatever the native queue holds
    into per-model backlogs (blocking only when the system is idle;
    bounded at ``backlog_factor × batch_size`` rows PER MODEL, so one
    model flooding cannot monopolize the backlog — its rows park at
    the cap while every admit round re-opens fill headroom, other
    models' rows keep flowing through, and ``_admit``'s weight quanta
    then apportion a backlog that actually contains every demanding
    model; the native queue — and from there the ``queue full`` seam —
    stays the backpressure boundary); (2) **admit** — pick up to ``batch_size``
    rows across models: strict priority tiers first, proportional
    ``weight`` shares inside a tier, rotating who goes first so equal
    weights alternate; (3) **dispatch** — stage and hand to a worker.
    The dispatch blocks while every worker is busy, which is the pacing:
    rows arriving during step k are in the backlog when a worker frees
    and ride step k+1 — never a fixed window tail."""

    name = "continuous"

    #: native-queue poll slice while the backlog is empty (idle server)
    _IDLE_POLL = 0.25

    def __init__(self, backlog_factor: int = 4):
        if backlog_factor < 1:
            raise ValueError(
                f"backlog_factor must be >= 1, got {backlog_factor}")
        self.backlog_factor = backlog_factor
        self._backlog: Dict[Optional[str], Deque[Any]] = {}
        self._pings: List[Any] = []
        self._rr = 0  # rotates which model dequeues first
        # a popped row whose model's backlog is at cap: held (never
        # dropped) until an admit round frees room, pausing the fill —
        # head-of-line pressure from ONE flooding model is thereby
        # limited to cap+1 of its rows, not the whole backlog
        self._held: Optional[Any] = None

    def backlog(self) -> int:
        # snapshot the dict: stats() calls this from client/HTTP
        # threads while the assembly thread's _fill may be inserting a
        # first-seen model key (setdefault) — iterating the live dict
        # would intermittently raise "dict changed size during
        # iteration"
        return (sum(len(d) for d in list(self._backlog.values()))
                + (self._held is not None))

    def drain_rows(self) -> List[Any]:
        rows = list(self._pings)
        self._pings.clear()
        if self._held is not None:
            rows.append(self._held)
            self._held = None
        for d in list(self._backlog.values()):
            rows.extend(d)
            d.clear()
        return rows

    def held_rows(self) -> List[Any]:
        # best-effort: the assembly thread may be mutating these deques
        # concurrently (the flight recorder reads this mid-kill); a torn
        # snapshot is retried once, then whatever was gathered is enough
        for _ in range(2):
            try:
                rows = list(self._pings)
                if self._held is not None:
                    rows.append(self._held)
                for d in list(self._backlog.values()):
                    rows.extend(list(d))
                return rows
            except RuntimeError:
                continue  # mutated during iteration: try once more
        return []

    def run(self, server: Any) -> None:
        while not server._stop.is_set():
            if not self._fill(server):
                return  # queue closed: server is stopping
            batch = self._admit(server)
            if batch is None:
                continue  # idle poll slice expired with nothing arrived
            self._finish_round(server, batch)

    def _fill(self, server: Any) -> bool:
        """Move arrived requests into the per-model backlogs (each
        bounded at ``batch_size × backlog_factor`` rows — the per-model
        cap is what makes the weighted-fair admission real under a
        one-model flood); False when the native queue closed."""
        cap = server.batch_size * self.backlog_factor
        if self._held is not None:
            name = (self._held.model if self._held.model is not None
                    else server._default_name)
            d = self._backlog.setdefault(name, deque())
            if len(d) >= cap:
                return True  # still no room: admit first, fill later
            d.append(self._held)
            self._held = None
        block = self.backlog() == 0 and not self._pings
        while True:
            try:
                item = server._queue.pop(
                    timeout=self._IDLE_POLL if block else 0.0)
            except RuntimeError:
                return False
            if item is None:
                return True  # nothing (more) arrived in this slice
            block = False
            p = server._take(item[0])
            if p is None:
                continue
            if p.ping:
                self._pings.append(p)
                continue
            name = p.model if p.model is not None else server._default_name
            d = self._backlog.setdefault(name, deque())
            if len(d) >= cap:
                self._held = p  # this model's backlog is full
                return True
            d.append(p)

    def _admit(self, server: Any) -> Optional[List[Any]]:
        """Up to ``batch_size`` rows across the model backlogs —
        weighted-fair inside strict priority tiers.  Pings always ride
        (they never consume batch room)."""
        out: List[Any] = list(self._pings)
        self._pings.clear()
        live = [n for n, d in self._backlog.items() if d]
        if not live:
            return out or None
        # one registry lock hold per round, not one per model per pass:
        # the conn threads' routing checks contend on the same lock
        fair = server.registry.fairness(live)
        room = server.batch_size
        tiers: Dict[int, List[Optional[str]]] = {}
        for n in live:
            tiers.setdefault(fair[n][1], []).append(n)
        for prio in sorted(tiers, reverse=True):
            names = sorted(tiers[prio], key=lambda n: n or "")
            # rotate who dequeues first so equal-weight models
            # alternate instead of the alphabetically-first one always
            # taking the head of the batch
            self._rr += 1
            k = self._rr % len(names)
            names = names[k:] + names[:k]
            while room > 0 and any(self._backlog[n] for n in names):
                active = [n for n in names if self._backlog[n]]
                wsum = sum(fair[n][0] for n in active)
                pass_room = room
                for n in active:
                    if room <= 0:
                        break
                    # proportional quantum of the room REMAINING at
                    # pass start, so one pass through a backlogged tier
                    # realizes the weight ratio; min 1 keeps
                    # light-weight models from starving on rounding
                    quantum = max(1, int(pass_room
                                         * fair[n][0] / wsum))
                    d = self._backlog[n]
                    take = min(quantum, room, len(d))
                    for _ in range(take):
                        out.append(d.popleft())
                    room -= take
            if room <= 0:
                break
        return out


#: policy-name -> class, for ``ClusterServing(scheduler="...")`` and the
#: ``zoo-serving --scheduler`` flag
SCHEDULERS = {WindowScheduler.name: WindowScheduler,
              ContinuousScheduler.name: ContinuousScheduler}


def make(spec: Union[str, Scheduler]) -> Scheduler:
    """A Scheduler from a policy name or a prebuilt instance."""
    if isinstance(spec, Scheduler):
        return spec
    cls = SCHEDULERS.get(spec)
    if cls is None:
        raise ValueError(f"unknown scheduler {spec!r} "
                         f"(available: {sorted(SCHEDULERS)})")
    return cls()
