# Port of analytics_zoo_tpu/core/context.py: the heartbeat, the context
# singleton and init_orca_context over torch.distributed instead of
# jax.distributed; the mesh is this module's Mesh of process ranks.
"""Cluster bootstrap: ``init_orca_context`` over ``torch.distributed``.

The JAX package runs one process per TPU host and a ``jax.sharding.Mesh``
over every chip.  The port runs one process per device: the mesh is a
grid of process ranks (:class:`Mesh`) whose axes are the JAX mesh's, in
``MeshConfig.AXIS_ORDER``, with the axes of size 1 dropped, and rank ``r``
sits at ``np.unravel_index(r, shape)``, where ``jax.sharding.Mesh`` puts
device ``r`` of ``jax.devices()``.  So the JAX reference of a port run at
world size N is the JAX package on an N-device mesh of the same axes.

``"local"`` is one process (a mesh of size 1 over the ``data`` axis).
``"multihost"`` reads the launcher's contract (``ZOO_COORDINATOR``,
``ZOO_NUM_PROCESSES``, ``ZOO_PROCESS_ID``; see ``core/launcher.py``) into
``torch.distributed.init_process_group``.  The backend follows from the
topology and is logged: ``gloo`` when the ranks compute on the CPU,
``nccl`` when each rank has a card of its own, ``gloo`` over CUDA tensors
when several ranks share one card (NCCL refuses two ranks on one
device); each rank's card becomes its current CUDA device.  A collective that fails raises; the backend never changes after
a failure.  Beside the device group the context keeps one host ``gloo``
group for flags, CRCs and barriers (the default group itself where that
is gloo already).

Init order, as in the JAX package: the process group, the fault
configuration, the trace and flight-recorder knobs, then the first
heartbeat beat, then the mesh.
"""

from __future__ import annotations

import atexit
import itertools
import json
import logging
import os
import threading
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

from .config import MeshConfig, ZooConfig

logger = logging.getLogger("analytics_zoo_tpu_torch")


class _Heartbeat:
    """Progress-based worker liveness: ``beat()`` rewrites the heartbeat
    file (a small JSON payload: ``step``, ``loss``, ``samples_per_sec``,
    ``wall``, whatever the caller last reported) at most once per
    ``interval``, atomically (tmp + rename).  Not a daemon thread: a worker
    whose steps stop stops beating, which is what the ``zoo-launch``
    supervisor detects."""

    def __init__(self, path: str, interval: float):
        self.path = path
        self.interval = max(0.05, float(interval))
        self._last = 0.0
        self._payload: Dict[str, Any] = {}

    def update(self, **fields: Any) -> None:
        """Merge status fields into the payload the next beat writes."""
        self._payload.update(fields)

    def beat(self, force: bool = False) -> None:
        now = time.monotonic()
        if not force and now - self._last < self.interval:
            return
        self._last = now
        try:
            payload = dict(self._payload, wall=time.time())
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(json.dumps(payload))
            os.replace(tmp, self.path)  # atomic: no torn reads, fresh mtime
        except OSError:  # liveness reporting must never kill training
            logger.debug("heartbeat touch failed for %s", self.path)


_HEARTBEAT: Optional[_Heartbeat] = None


def heartbeat(force: bool = False, **status: Any) -> None:
    """Report training progress to the gang supervisor (a no-op unless a
    heartbeat file is configured).  Keyword arguments become the JSON
    payload the supervisor folds into its gang-status line; ``force``
    bypasses the rate limit (epoch-end beats)."""
    hb = _HEARTBEAT
    if hb is not None:
        if status:
            hb.update(**status)
        hb.beat(force=force)


# -- the mesh of process ranks ------------------------------------------------

class Mesh:
    """A grid of process ranks over named axes: the port's counterpart of
    ``jax.sharding.Mesh`` (one process a device).

    ``axis_names`` and ``shape`` (an ordered ``{axis: size}``) read as the
    JAX mesh's; ``devices`` is the array of ranks.  ``rank``, ``coords``
    (``{axis: index}``) and ``group(axes)`` describe this process: the
    process group of the ranks that differ from it only along ``axes``
    (``None`` where that group is this process alone, so callers skip the
    collective).  ``index(axes)`` is this rank's position in that group, in
    the row-major order of ``axes``' coordinates."""

    def __init__(self, axis_names: Sequence[str], shape: Sequence[int],
                 rank: int = 0, groups: Optional[Dict[Any, Any]] = None,
                 backend: Optional[str] = None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(s) for s in shape)))
        self.size = int(np.prod(list(self.shape.values()) or [1]))
        self.devices = np.arange(self.size).reshape(
            tuple(self.shape.values()))
        self.rank = int(rank)
        self.coords = dict(zip(self.axis_names, (int(c) for c in np.unravel_index(
            self.rank, self.devices.shape))))
        self._groups = groups or {}
        self.backend = backend

    def axis_size(self, axes: Sequence[str]) -> int:
        """The product of the sizes of those of ``axes`` the mesh has."""
        return int(np.prod([self.shape.get(a, 1) for a in axes] or [1]))

    def _key(self, axes: Sequence[str]) -> Tuple[str, ...]:
        return tuple(a for a in self.axis_names
                     if a in axes and self.shape[a] > 1)

    def group(self, axes: Sequence[str]) -> Any:
        """The process group of the ranks that share this rank's
        coordinates on every axis but ``axes``; ``None`` if that is this
        process alone."""
        key = self._key(axes)
        if not key:
            return None
        return self._groups[key]

    def index(self, axes: Sequence[str]) -> int:
        """This rank's position among the ranks of ``group(axes)``: its
        coordinates on ``axes`` raveled in the mesh's axis order."""
        key = self._key(axes)
        if not key:
            return 0
        return int(np.ravel_multi_index(
            tuple(self.coords[a] for a in key),
            tuple(self.shape[a] for a in key)))

    def ranks(self, axes: Sequence[str]) -> list:
        """The global ranks of ``group(axes)``, in ``index`` order."""
        key = self._key(axes)
        fixed = {a: self.coords[a] for a in self.axis_names if a not in key}
        out = []
        for combo in itertools.product(*(range(self.shape[a])
                                         for a in key)):
            c = dict(fixed, **dict(zip(key, combo)))
            out.append(int(np.ravel_multi_index(
                tuple(c[a] for a in self.axis_names), self.devices.shape)))
        return out

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _axis_groups(axis_names: Tuple[str, ...], shape: Tuple[int, ...],
                 rank: int, backend: Optional[str]) -> Dict[Any, Any]:
    """One process group for every set of sized axes and every fixing of
    the other coordinates; every rank makes every group, in one order (as
    ``torch.distributed.new_group`` requires), and keeps the groups it is
    in, keyed by the axis set."""
    import torch.distributed as dist
    sized = [a for a, s in zip(axis_names, shape) if s > 1]
    devices = np.arange(int(np.prod(shape))).reshape(shape)
    mine: Dict[Any, Any] = {}
    for n in range(1, len(sized) + 1):
        for key in itertools.combinations(sized, n):
            moving = [axis_names.index(a) for a in key]
            fixed = [i for i in range(len(axis_names)) if i not in moving]
            arr = np.transpose(devices, fixed + moving).reshape(
                -1, int(np.prod([shape[i] for i in moving])))
            for ranks in arr:
                g = dist.new_group([int(r) for r in ranks], backend=backend)
                if rank in ranks:
                    mine[key] = g
    return mine


class _ZooContextMeta(type):
    """Process-global knobs as class attributes (the reference's
    OrcaContext metaclass pattern)."""

    _config: Optional[ZooConfig] = None
    _mesh: Optional[Mesh] = None
    _host_group: Any = None
    _owns_group = False  # init_orca_context started the process group
    _lock = threading.RLock()

    @property
    def config(cls) -> ZooConfig:
        if cls._config is None:
            raise RuntimeError(
                "context not initialized - call init_orca_context() first")
        return cls._config

    @property
    def initialized(cls) -> bool:
        return cls._config is not None

    @property
    def mesh(cls) -> Mesh:
        if cls._mesh is None:
            raise RuntimeError(
                "context not initialized - call init_orca_context() first")
        return cls._mesh

    @property
    def host_group(cls) -> Any:
        """The gloo group of every process (flags, CRCs, barriers); None
        in one process."""
        return cls._host_group

    @property
    def pandas_read_backend(cls) -> str:
        return cls.config.pandas_read_backend

    @pandas_read_backend.setter
    def pandas_read_backend(cls, value: str) -> None:
        cls.config.pandas_read_backend = value


class OrcaContext(metaclass=_ZooContextMeta):
    """Process-global context singleton (reference: pyzoo/zoo/orca/common.py)."""


def config_default(field: str, fallback: Any) -> Any:
    """``ZooConfig.<field>`` when a context is initialized, else
    ``fallback``."""
    if OrcaContext.initialized:
        return getattr(OrcaContext.config, field, fallback)
    return fallback


def _world() -> Tuple[int, int]:
    """(rank, world size): ``data.readers.process_grid``, the one source."""
    from ..data.readers import process_grid
    return process_grid()


def make_mesh(mesh_shape: Optional[str | Dict[str, int] | MeshConfig] = None,
              n_devices: Optional[int] = None) -> Mesh:
    """A :class:`Mesh` over the process group's ranks (or ``n_devices``
    ranks), as the JAX package's ``make_mesh`` lays out devices:
    ``mesh_shape`` a MeshConfig, an ``{axis: size}`` dict (one axis may be
    0 to absorb the rest) or a strategy name (``"dp"``, ``"fsdp"``,
    ``"tp"``, ``"2d"``); the axes of size 1 dropped (one ``data`` axis of
    size 1 where none is left).  Every rank must be in the mesh: a subset
    mesh over several processes raises (its collectives would hang).  Over
    several processes the axis groups are made here, collectively."""
    rank, world = _world()
    n = world if n_devices is None else int(n_devices)
    if isinstance(mesh_shape, MeshConfig):
        cfg = mesh_shape
    elif isinstance(mesh_shape, str):
        cfg = MeshConfig.for_strategy(mesh_shape, n_devices=n)
    else:
        cfg = MeshConfig(**(mesh_shape or {"data": 0}))
    sizes = cfg.resolved(n)
    axes = [a for a in MeshConfig.AXIS_ORDER if sizes[a] > 1] or ["data"]
    shape = tuple(sizes[a] for a in axes)
    used = int(np.prod(shape))
    if used < n:
        if world > 1:
            raise ValueError(
                f"mesh covers {used} of {n} processes; subset meshes are "
                "not allowed over several processes (every process must "
                "own a place in the mesh). Use a wildcard axis (size 0) to "
                "cover all.")
        logger.warning("mesh covers %d of %d available devices; the rest "
                       "are idle", used, n)
    groups: Dict[Any, Any] = {}
    backend = None
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        backend = dist.get_backend()
    # a mesh over the process group's ranks; one of another size (a layout
    # computed without processes) is this process's view at rank 0
    spans_world = world > 1 and n == world
    if spans_world:
        groups = _axis_groups(tuple(axes), shape, rank, backend)
    return Mesh(axes, shape, rank=rank if spans_world else 0, groups=groups,
                backend=backend)


def local_topology(process_id: int, num_processes: int
                   ) -> Tuple[int, int, Optional[int]]:
    """This process's place on its host: ``(local rank, processes on the
    host, cards a process)`` from the launcher's contract
    (``ZOO_LOCAL_RANK``, ``ZOO_LOCAL_WORLD_SIZE``, ``ZOO_DEVICES_PER_PROC``;
    see ``core/launcher.py``), else one host that runs every process:
    ``(process_id, num_processes, None)``."""
    env = os.environ
    per_proc = int(env.get("ZOO_DEVICES_PER_PROC", "0")) or None
    return (int(env.get("ZOO_LOCAL_RANK", process_id)),
            int(env.get("ZOO_LOCAL_WORLD_SIZE", num_processes)), per_proc)


def choose_backend(local_rank: int, local_world: int,
                   devices_per_proc: Optional[int] = None
                   ) -> Tuple[str, Optional[int]]:
    """The process group's backend for this topology and the card this
    rank computes on (an index among its visible cards; None without
    cards): ``gloo`` for CPU ranks; ``nccl`` when the launcher gave each
    rank cards of its own (``devices_per_proc``: its first visible card)
    or when the host's ranks are no more than its cards (rank ``i`` takes
    card ``i``); ``gloo`` when ranks share a card (gloo moves CUDA tensors
    through the host, NCCL refuses two ranks on one device)."""
    import torch
    if not torch.cuda.is_available():
        return "gloo", None
    if devices_per_proc:
        return "nccl", 0
    cards = torch.cuda.device_count()
    if local_world <= cards:
        return "nccl", local_rank
    return "gloo", local_rank % cards


def init_orca_context(cluster_mode: str = "local",
                      mesh_shape: Optional[str | Dict[str, int]
                                           | MeshConfig] = None,
                      config: Optional[ZooConfig] = None,
                      coordinator_address: Optional[str] = None,
                      num_processes: Optional[int] = None,
                      process_id: Optional[int] = None,
                      log_level: Optional[str] = None,
                      **extra: Any) -> Mesh:
    """Initialize the process-global context and its mesh; returns the
    mesh.

    cluster_mode:
      - ``"local"``: this process alone.
      - ``"multihost"``: ``torch.distributed.init_process_group`` over
        ``tcp://<coordinator>`` with the world size and rank given here or
        by the launcher's environment (``ZOO_COORDINATOR``,
        ``ZOO_NUM_PROCESSES``, ``ZOO_PROCESS_ID``).  ``extra["backend"]``
        names the backend; by default :func:`choose_backend` picks it
        from :func:`local_topology`, and the rank's card becomes the
        current CUDA device.
    """
    global _HEARTBEAT
    with _ZooContextMeta._lock:
        if OrcaContext.initialized:
            logger.warning("init_orca_context called twice; reusing context")
            return OrcaContext.mesh

        cfg = config or ZooConfig()
        cfg.cluster_mode = cluster_mode
        if mesh_shape and not isinstance(mesh_shape, str):
            cfg.mesh = (mesh_shape if isinstance(mesh_shape, MeshConfig)
                        else MeshConfig(**mesh_shape))
        if coordinator_address:
            cfg.coordinator_address = coordinator_address
        if num_processes is not None:
            cfg.num_processes = num_processes
        if process_id is not None:
            cfg.process_id = process_id
        if log_level:
            cfg.log_level = log_level
        backend = extra.pop("backend", None)
        cfg.extra.update(extra)

        logging.basicConfig(level=getattr(logging, cfg.log_level, logging.INFO))
        logger.setLevel(getattr(logging, cfg.log_level, logging.INFO))

        host_group = None
        if cluster_mode == "multihost":
            import torch.distributed as dist
            if cfg.coordinator_address is None:
                cfg.coordinator_address = os.environ.get("ZOO_COORDINATOR")
            if cfg.num_processes is None and "ZOO_NUM_PROCESSES" in os.environ:
                cfg.num_processes = int(os.environ["ZOO_NUM_PROCESSES"])
            if cfg.process_id is None and "ZOO_PROCESS_ID" in os.environ:
                cfg.process_id = int(os.environ["ZOO_PROCESS_ID"])
            if (cfg.coordinator_address is None or cfg.num_processes is None
                    or cfg.process_id is None):
                raise ValueError(
                    "init_orca_context('multihost') needs the coordinator "
                    "address, the process count and this process's id "
                    "(arguments, or ZOO_COORDINATOR / ZOO_NUM_PROCESSES / "
                    "ZOO_PROCESS_ID as zoo-launch sets them)")
            chosen, card = choose_backend(*local_topology(
                cfg.process_id, cfg.num_processes))
            backend = backend or chosen
            if card is not None:  # bare "cuda" is this rank's card
                import torch
                torch.cuda.set_device(card)
            if dist.is_initialized():
                backend = dist.get_backend()
            else:
                _ZooContextMeta._owns_group = True
                dist.init_process_group(
                    backend=backend,
                    init_method=f"tcp://{cfg.coordinator_address}",
                    world_size=cfg.num_processes, rank=cfg.process_id)
            logger.info("process %d of %d joined %s over %s (card %s)",
                        cfg.process_id, cfg.num_processes,
                        cfg.coordinator_address, backend, card)
            if cfg.num_processes > 1:
                host_group = (dist.group.WORLD if backend == "gloo"
                              else dist.new_group(backend="gloo"))
        elif cluster_mode != "local":
            raise ValueError(
                f"unknown cluster_mode {cluster_mode!r}; the reference's "
                "yarn/k8s/standalone modes map to 'multihost' here")

        if cfg.faults:
            from .faults import get_registry
            get_registry().configure(cfg.faults)
            logger.warning("fault injection armed from config: %s",
                           sorted(cfg.faults))
        if cfg.trace_slow_ms is not None or cfg.trace_ring is not None:
            from . import trace as trace_lib
            trace_lib.configure(slow_ms=cfg.trace_slow_ms,
                                max_records=cfg.trace_ring)
        if cfg.flightrec_dir or os.environ.get("ZOO_FLIGHTREC_DIR"):
            from . import flightrec
            if cfg.flightrec_dir:
                flightrec.configure(cfg.flightrec_dir)
            flightrec.install_signal_dump()

        # the supervisor's liveness contract: "import + init finished" is
        # the first beat, then the training loop beats on progress
        if cfg.heartbeat_file is None:
            cfg.heartbeat_file = os.environ.get("ZOO_HEARTBEAT_FILE")
        if cfg.heartbeat_interval is None:
            cfg.heartbeat_interval = float(
                os.environ.get("ZOO_HEARTBEAT_INTERVAL", "1.0"))
        if cfg.heartbeat_file:
            _HEARTBEAT = _Heartbeat(cfg.heartbeat_file,
                                    cfg.heartbeat_interval)
            _HEARTBEAT.beat(force=True)

        if isinstance(mesh_shape, str):  # the world is up: size it now
            cfg.mesh = MeshConfig.for_strategy(mesh_shape,
                                               n_devices=_world()[1])
        _ZooContextMeta._mesh = make_mesh(cfg.mesh)
        _ZooContextMeta._host_group = host_group
        _ZooContextMeta._config = cfg
        logger.info("initialized context: %d process(es), mesh %s",
                    _world()[1], OrcaContext.mesh.shape)
        atexit.register(stop_orca_context)
        return OrcaContext.mesh


def stop_orca_context() -> None:
    """Forget the context; a process group that ``init_orca_context``
    started is destroyed (one the caller started stays)."""
    global _HEARTBEAT
    with _ZooContextMeta._lock:
        owned = _ZooContextMeta._owns_group
        _ZooContextMeta._config = None
        _ZooContextMeta._mesh = None
        _ZooContextMeta._host_group = None
        _ZooContextMeta._owns_group = False
        _HEARTBEAT = None
        if owned:
            import torch.distributed as dist
            if dist.is_initialized():
                dist.destroy_process_group()


def get_mesh() -> Mesh:
    """The global mesh, initializing a local default context if needed."""
    if not OrcaContext.initialized:
        init_orca_context("local")
    return OrcaContext.mesh


def current_mesh() -> Optional[Mesh]:
    """The context's mesh if one is initialized, else None (no default
    context is made)."""
    return OrcaContext._mesh


init_nncontext = init_orca_context

__all__ = ["Mesh", "OrcaContext", "choose_backend", "config_default",
           "current_mesh", "get_mesh", "heartbeat",
           "init_nncontext", "init_orca_context", "local_topology",
           "make_mesh", "stop_orca_context"]
