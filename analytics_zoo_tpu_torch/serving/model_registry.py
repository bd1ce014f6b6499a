# Port of analytics_zoo_tpu/serving/model_registry.py: a copy with its imports pointed at
# the port, changed where it reaches the model (see "Port" below).
"""Multi-model serving registry: named models × versions with
zero-downtime hot version swap.

The reference's model-update flow (SURVEY.md §2.8: a new model version
replaced the loaded one between batches) assumed ONE model per serving
process; an upgrade was therefore a whole-replica event, and serving two
models meant two deployments.  Production serving stacks treat a model
as a NAME instead: traffic routes to the name's *active version*, and an
upgrade is load → warm → atomic flip → drain rather than a restart
(TF-Serving's servable/version-policy split is the closest analog — the
TensorFlow systems paper in PAPERS.md makes the broader point that such
policies belong in a first-class component, not a loop body).

:class:`ModelRegistry` is that component for ``ClusterServing``:

- **names × versions** — ``register(name, model, version=...)`` holds
  any number of models, each with any number of loaded versions; one
  version per name is *active* and serves requests that don't pin a
  version explicitly (canary clients may pin ``version=`` to keep
  reading an old one).
- **fairness metadata** — per-name ``weight`` (proportional share) and
  ``priority`` (strict tiers), consumed by the continuous scheduler's
  weighted-fair dequeue across per-model backlogs
  (serving/scheduler.py).
- **hot version swap** — ``swap(name, model)`` rides the server's drain
  machinery: the incoming model is **warmed first**
  (``InferenceModel.warm_from`` AOT-compiles the active version's
  realized (shape, dtype) buckets, so no post-swap request waits on a
  fresh XLA compile), the active pointer then flips atomically, and the
  old version's in-flight batches drain to zero (``begin``/``done``
  accounting incremented by the server per dispatched batch) — zero
  downtime, zero cold compiles, zero dropped requests.

Swaps count into the process metrics registry (``registry.swaps``).

Port: ``swap(warm=True)`` calls the port's ``InferenceModel.warm_from``,
which captures the incoming version's CUDA graphs (one a key) on the
swapping thread while the old version's graphs replay on the server's
workers; each instance has its own serving stream and graph pool.
``swap_from_checkpoint`` restores through the port's
``core/ckpt_manager.restore_path`` (a manager directory of either
package).
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Any, Dict, List, Optional

from analytics_zoo_tpu_torch.core import faults as faults_lib
from analytics_zoo_tpu_torch.core import metrics as metrics_lib

logger = logging.getLogger("analytics_zoo_tpu")


class _Entry:
    """One model name: its loaded versions (insertion-ordered), the
    active version, per-version in-flight batch counts, and the
    scheduler-facing fairness metadata."""

    __slots__ = ("name", "weight", "priority", "versions", "active",
                 "inflight", "seq")

    def __init__(self, name: str, weight: float, priority: int):
        self.name = name
        self.weight = weight
        self.priority = priority
        self.versions: Dict[str, Any] = {}
        self.active: Optional[str] = None
        self.inflight: Dict[str, int] = {}
        self.seq = 0  # auto-version counter; NEVER reused after unload


class ModelRegistry:
    """Named models × versions with atomic active-version swap.

    Thread-safety: every read and write happens under one RLock; the
    hot-path read (``resolve``) is a dict hit, and the swap's flip is a
    single pointer assignment under the same lock — a request assembled
    one instant before the flip runs on the old version, one instant
    after on the new one, and both complete (the drain waits for the
    former)."""

    #: the name ``ClusterServing(model=...)`` registers its single model
    #: under, and the name requests without a ``model`` header route to
    DEFAULT = "default"

    def __init__(self,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None):
        self._lock = threading.RLock()
        # serializes whole swap() calls: warm → register → flip →
        # drain → unload must not interleave between two upgraders of
        # the same name (an interleaving leaks a never-active resident
        # version).  Separate from _lock: resolve() must keep serving
        # while a swap warms/drains.
        self._swap_lock = threading.Lock()
        self._entries: Dict[str, _Entry] = {}
        self._metrics = metrics or metrics_lib.get_registry()
        # True only when the CONSTRUCTOR wired a registry explicitly —
        # ensure()'s server-injection repoint must not flip it, or a
        # second server with a different injected registry could never
        # repoint after the first one did
        self._metrics_injected = metrics is not None
        self._m_swaps = self._metrics.counter("registry.swaps")
        # unload observers (fn(name, version), called outside the
        # lock): the server retires its per-(model, version) labeled
        # metric series here, so refresh-style swaps (monotone v1, v2,
        # ... version strings) don't grow the scrape without bound
        self._unload_hooks: List[Any] = []
        # swap observers (fn(name, old_version, new_version), called
        # right after the atomic flip, before the drain): serving-side
        # caches keyed by (model, version) invalidate here, so a
        # hot-swapped version can never serve rows cached from its
        # predecessor
        self._swap_hooks: List[Any] = []

    def on_unload(self, fn: Any) -> None:
        """Register ``fn(name, version)`` to run after a version is
        unloaded (directly or via ``swap(keep_old=False)``)."""
        self._unload_hooks.append(fn)

    def off_unload(self, fn: Any) -> None:
        """Deregister an ``on_unload`` observer (no-op when absent).
        ``ClusterServing.stop()`` calls this — a long-lived registry
        reused across server lifecycles must not accumulate hooks that
        retain every stopped server."""
        try:
            self._unload_hooks.remove(fn)
        except ValueError:
            pass

    def on_swap(self, fn: Any) -> None:
        """Register ``fn(name, old_version, new_version)`` to run right
        after a ``swap()``'s atomic flip (before the old version drains).
        ``serving.EmbedCache.attach`` subscribes here to drop the
        outgoing version's cached rows the moment it stops being
        active."""
        self._swap_hooks.append(fn)

    def off_swap(self, fn: Any) -> None:
        """Deregister an ``on_swap`` observer (no-op when absent)."""
        try:
            self._swap_hooks.remove(fn)
        except ValueError:
            pass

    @classmethod
    def ensure(cls, models: Any = None,
               metrics: Optional[metrics_lib.MetricsRegistry] = None
               ) -> "ModelRegistry":
        """``models`` as a registry (returned as-is), a ``{name: model}``
        dict, or None (empty registry)."""
        if isinstance(models, ModelRegistry):
            # custom-registry injection (as the client.* metrics do): a
            # prebuilt registry that did NOT choose its own metrics at
            # construction follows the server's injected registry, so a
            # custom-registry scrape contains registry.swaps.  The flag
            # (not an `is get_registry()` check) keeps a registry
            # re-hosted by a SECOND server repointable — the first
            # server's repoint must not read as "deliberately wired".
            if (metrics is not None
                    and models._metrics is not metrics
                    and not models._metrics_injected):
                models._metrics = metrics
                models._m_swaps = metrics.counter("registry.swaps")
            return models
        reg = cls(metrics=metrics)
        for name, m in (models or {}).items():
            reg.register(name, m)
        return reg

    # -- registration ---------------------------------------------------------

    def register(self, name: str, model: Any,
                 version: Optional[str] = None, weight: float = 1.0,
                 priority: int = 0, make_active: bool = True) -> str:
        """Load ``model`` as a version of ``name`` (auto-numbered
        ``v1, v2, ...`` when ``version`` is omitted); returns the
        version string.  ``weight``/``priority`` apply on the entry's
        FIRST registration (they are per-name, not per-version)."""
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        with self._lock:
            e = self._entries.get(name)
            if e is None:
                e = self._entries[name] = _Entry(name, float(weight),
                                                 int(priority))
            if version is None:
                # a monotone counter, not len(versions)+1: unloading v1
                # and swapping again must mint v3, not collide on v2
                e.seq += 1
                while f"v{e.seq}" in e.versions:
                    e.seq += 1
                version = f"v{e.seq}"
            version = str(version)
            if version in e.versions:
                raise ValueError(
                    f"model {name!r} already has a version {version!r}")
            e.versions[version] = model
            e.inflight.setdefault(version, 0)
            if make_active or e.active is None:
                e.active = version
        return version

    def unload(self, name: str, version: str) -> None:
        """Drop a non-active version (frees its executables/HBM).  The
        active version cannot be unloaded — swap first."""
        with self._lock:
            e = self._entries.get(name)
            if e is None or str(version) not in e.versions:
                return
            if e.active == str(version):
                raise ValueError(
                    f"version {version!r} of model {name!r} is active; "
                    "swap to another version before unloading it")
            e.versions.pop(str(version))
            e.inflight.pop(str(version), None)
        for fn in list(self._unload_hooks):
            fn(name, str(version))

    # -- lookup ---------------------------------------------------------------

    def names(self) -> List[str]:
        with self._lock:
            return list(self._entries)

    def models(self) -> List[Any]:
        """Every loaded model object across all names and versions."""
        with self._lock:
            return [m for e in self._entries.values()
                    for m in e.versions.values()]

    def has(self, name: str) -> bool:
        with self._lock:
            return name in self._entries

    def versions(self, name: str) -> List[str]:
        with self._lock:
            e = self._entries.get(name)
            return list(e.versions) if e is not None else []

    def active_version(self, name: str) -> Optional[str]:
        with self._lock:
            e = self._entries.get(name)
            return e.active if e is not None else None

    def weight(self, name: str) -> float:
        with self._lock:
            e = self._entries.get(name)
            return e.weight if e is not None else 1.0

    def priority(self, name: str) -> int:
        with self._lock:
            e = self._entries.get(name)
            return e.priority if e is not None else 0

    def fairness(self, names) -> Dict[Optional[str],
                                      "tuple[float, int]"]:
        """``{name: (weight, priority)}`` for ``names`` in ONE lock
        hold — the continuous scheduler's admission loop reads these
        per model per pass, and per-read locking would contend with the
        conn threads' routing checks on every dispatch round.  Unknown
        names get the defaults (1.0, 0)."""
        with self._lock:
            out = {}
            for n in names:
                e = self._entries.get(n)
                out[n] = ((e.weight, e.priority) if e is not None
                          else (1.0, 0))
            return out

    def set_weight(self, name: str, weight: float,
                   priority: Optional[int] = None) -> None:
        if weight <= 0:
            raise ValueError(f"weight must be > 0, got {weight}")
        with self._lock:
            e = self._entries[name]
            e.weight = float(weight)
            if priority is not None:
                e.priority = int(priority)

    def resolve(self, name: Optional[str],
                version: Optional[str] = None, begin: bool = False):
        """``(model, name, version)`` for a routable request — the
        entry's active version unless the request pins one.  Raises
        ``KeyError`` with a client-presentable message otherwise.

        ``begin=True`` increments the version's in-flight count in the
        SAME lock hold — the assembly stage uses this so a concurrent
        ``swap(drain=True)`` can never observe zero in-flight between a
        batch resolving to the old version and registering itself
        (resolve-then-``begin()`` as two calls has exactly that window,
        and with ``keep_old=False`` the drain's caller may unload a
        version a resolved batch was about to run on).  The caller owns
        the matching ``done()``."""
        with self._lock:
            e = self._entries.get(name) if name is not None else None
            if e is None:
                raise KeyError(
                    f"unknown model {name!r} "
                    f"(hosted: {sorted(self._entries)})")
            ver = str(version) if version is not None else e.active
            m = e.versions.get(ver) if ver is not None else None
            if m is None:
                raise KeyError(
                    f"unknown version {version!r} of model {name!r} "
                    f"(loaded: {list(e.versions)})")
            if begin:
                e.inflight[ver] = e.inflight.get(ver, 0) + 1
            return m, e.name, ver

    def route_error(self, name: Optional[str],
                    version: Optional[str] = None) -> Optional[str]:
        """None when ``(name, version)`` is routable, else the error
        text the server replies with — evaluated at request arrival so
        an unroutable request costs a reply, not a queue slot."""
        with self._lock:
            if name is None:
                return ("no model specified: this server hosts "
                        f"{sorted(self._entries)} — set the request's "
                        "'model' field")
            e = self._entries.get(name)
            if e is None:
                return (f"unknown model {name!r} "
                        f"(hosted: {sorted(self._entries)})")
            if version is not None and str(version) not in e.versions:
                return (f"unknown version {version!r} of model {name!r} "
                        f"(loaded: {list(e.versions)})")
            return None

    # -- in-flight accounting (the drain substrate) ---------------------------

    def begin(self, name: str, version: str) -> None:
        """A batch for (name, version) was dispatched to a worker."""
        with self._lock:
            e = self._entries.get(name)
            if e is not None:
                e.inflight[version] = e.inflight.get(version, 0) + 1

    def done(self, name: str, version: str) -> None:
        """That batch concluded (replied, errored, or drained)."""
        with self._lock:
            e = self._entries.get(name)
            if e is not None and e.inflight.get(version, 0) > 0:
                e.inflight[version] -= 1

    def inflight(self, name: str, version: str) -> int:
        with self._lock:
            e = self._entries.get(name)
            return e.inflight.get(str(version), 0) if e is not None else 0

    # -- hot swap -------------------------------------------------------------

    def swap(self, name: str, model: Any, version: Optional[str] = None,
             warm: bool = True, drain: bool = True,
             drain_timeout: float = 30.0, keep_old: bool = True) -> str:
        """Hot-swap ``name``'s active version to ``model`` — the
        zero-downtime upgrade path:

        1. **warm**: AOT-compile the incoming model's executables for
           every (shape, dtype) bucket the outgoing version realized
           (``InferenceModel.warm_from``), BEFORE any traffic can reach
           it — post-swap batches never wait on a fresh XLA compile;
        2. **flip**: register the new version and atomically repoint
           the active version (one assignment under the lock — requests
           assembled after the flip use the new model);
        3. **drain**: wait for the old version's in-flight batches to
           finish (they complete on the old model and reply normally).

        With ``keep_old`` (the default) the old version stays loaded
        (canaries may pin it; ``unload`` frees it later);
        ``keep_old=False`` unloads it right after the flip (and the
        drain, when requested) — repeated refresh-style swaps then hold
        ONE resident model instead of accumulating every version's
        weights and executables.  In-flight batches are safe either
        way: each assembled batch holds its own model reference.
        Returns the new version string; with ``drain``, a WARNING is
        logged if the old version failed to drain within
        ``drain_timeout``.

        Whole swaps are serialized (per registry): two concurrent
        upgraders of the same name run one after the other instead of
        interleaving warm/flip/unload (which would leak a never-active
        resident version).  ``resolve`` keeps serving throughout."""
        with self._swap_lock:
            with self._lock:
                e = self._entries.get(name)
                if e is None:
                    raise KeyError(f"unknown model {name!r} "
                                   f"(hosted: {sorted(self._entries)})")
                old_ver = e.active
                old_model = (e.versions.get(old_ver)
                             if old_ver is not None else None)
            # ``registry.swap_fail`` (core/faults.py): an injected
            # mid-warm failure — the incoming model blows up BEFORE the
            # new version is registered or the active pointer moves, so
            # the raise propagates to the upgrader while the old version
            # stays active, routable, and untouched (no ``registry.swaps``
            # increment, in-flight batches on the old version complete).
            # Deliberately OUTSIDE the warn-only except below: a real
            # ``warm_from`` hiccup degrades to cold compiles, but this
            # point simulates a broken candidate that must abort the
            # upgrade atomically.
            faults_lib.get_registry().raise_if("registry.swap_fail")
            if warm and old_model is not None and hasattr(model,
                                                          "warm_from"):
                try:
                    n = model.warm_from(old_model)
                    logger.info("model %s: warmed %d executable(s) for "
                                "the incoming version", name, n)
                except Exception as err:  # noqa: BLE001 — warming is an
                    # optimization; a failure means cold compiles, not
                    # an aborted upgrade — but say so loudly, because
                    # the whole point of the swap path is zero cold
                    # compiles
                    logger.warning("model %s: warming the incoming "
                                   "version failed (%s); first "
                                   "post-swap batches will compile "
                                   "cold", name, err)
            version = self.register(name, model, version=version,
                                    make_active=False)
            with self._lock:
                self._entries[name].active = version  # THE atomic flip
            self._m_swaps.inc()
            logger.info("model %s: active version %s -> %s", name,
                        old_ver, version)
            # observers see the flip before the drain: anything cached
            # against the outgoing version is stale the moment requests
            # can no longer be assembled against it
            for fn in list(self._swap_hooks):
                fn(name, old_ver, version)
            if drain and old_ver is not None and old_ver != version:
                if not self.drain_version(name, old_ver,
                                          timeout=drain_timeout):
                    logger.warning(
                        "model %s: version %s still has %d in-flight "
                        "batch(es) after %.1fs", name, old_ver,
                        self.inflight(name, old_ver), drain_timeout)
            if not keep_old and old_ver is not None \
                    and old_ver != version:
                self.unload(name, old_ver)
            return version

    def swap_from_checkpoint(self, name: str, loader: Any, ckpt_dir: str,
                             version: Optional[str] = None,
                             **swap_kwargs: Any) -> str:
        """Hot-swap ``name`` from the newest VISIBLE generation of an
        async-checkpoint directory (``core/ckpt_manager.py``): the serving
        half of train-to-serve refresh.  The manifest decides what is
        loadable — an in-flight or torn write is never served, because
        its generation has no committed manifest line yet.

        ``loader`` is called as ``loader(tree, record)`` with the
        restored train-state tree and its manifest record, and must
        return the servable model (e.g. an ``InferenceModel`` loaded with
        the tree's ``params``/``state``).  ``version`` defaults to
        ``ckpt-<generation>``, so repeated refreshes against an
        unchanged checkpoint collide loudly instead of silently
        re-serving identical weights.  All other keywords forward to
        :meth:`swap`."""
        from ..core import ckpt_manager as ckpt_mgr_lib
        tree, rec = ckpt_mgr_lib.restore_path(ckpt_dir)
        model = loader(tree, rec)
        if version is None:
            version = f"ckpt-{rec['gen']}"
        logger.info("model %s: swapping in checkpoint generation %s "
                    "(step %s) from %s", name, rec.get("gen"),
                    rec.get("step"), ckpt_dir)
        return self.swap(name, model, version=version, **swap_kwargs)

    def promote(self, name: str, version: str, warm: bool = True,
                drain: bool = True, drain_timeout: float = 30.0) -> str:
        """Flip ``name``'s active pointer to an ALREADY-LOADED version —
        the promotion half of shadow validation (serving/batch.py): a
        candidate registered with ``make_active=False`` serves pinned
        canary/shadow traffic until its offline deltas clear the gate,
        then promotes here without a second load.  Same serialization,
        warm, counter, observer, and drain semantics as :meth:`swap`;
        the only difference is that no new version is registered.
        Promoting the already-active version is a no-op.  Returns
        ``version``."""
        version = str(version)
        with self._swap_lock:
            with self._lock:
                e = self._entries.get(name)
                if e is None:
                    raise KeyError(f"unknown model {name!r} "
                                   f"(hosted: {sorted(self._entries)})")
                model = e.versions.get(version)
                if model is None:
                    raise KeyError(
                        f"unknown version {version!r} of model {name!r} "
                        f"(loaded: {list(e.versions)})")
                old_ver = e.active
                old_model = (e.versions.get(old_ver)
                             if old_ver is not None else None)
            if old_ver == version:
                return version
            if warm and old_model is not None and hasattr(model,
                                                          "warm_from"):
                try:
                    n = model.warm_from(old_model)
                    logger.info("model %s: warmed %d executable(s) for "
                                "promoted version %s", name, n, version)
                except Exception as err:  # noqa: BLE001 — same contract
                    # as swap(): warming is an optimization, not a gate
                    logger.warning("model %s: warming promoted version "
                                   "%s failed (%s); first post-promotion "
                                   "batches will compile cold", name,
                                   version, err)
            with self._lock:
                self._entries[name].active = version  # THE atomic flip
            self._m_swaps.inc()
            logger.info("model %s: promoted active version %s -> %s",
                        name, old_ver, version)
            for fn in list(self._swap_hooks):
                fn(name, old_ver, version)
            if drain and old_ver is not None:
                if not self.drain_version(name, old_ver,
                                          timeout=drain_timeout):
                    logger.warning(
                        "model %s: version %s still has %d in-flight "
                        "batch(es) after %.1fs", name, old_ver,
                        self.inflight(name, old_ver), drain_timeout)
            return version

    def drain_version(self, name: str, version: str,
                      timeout: float = 30.0) -> bool:
        """Block until (name, version) has zero in-flight batches or
        ``timeout`` elapses; True iff fully drained."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.inflight(name, version) == 0:
                return True
            time.sleep(0.005)
        return self.inflight(name, version) == 0

    # -- introspection --------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        """Per-name view: active version, loaded versions, in-flight
        batch counts, fairness metadata."""
        with self._lock:
            return {e.name: {"active": e.active,
                             "versions": list(e.versions),
                             "inflight": dict(e.inflight),
                             "weight": e.weight,
                             "priority": e.priority}
                    for e in self._entries.values()}
