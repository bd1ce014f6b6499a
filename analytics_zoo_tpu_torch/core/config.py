# Port of analytics_zoo_tpu/core/config.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Typed configuration for the whole framework.

The reference spreads configuration over five ad-hoc layers (SURVEY.md §5.6):
spark-analytics-zoo.conf defaults, native-threading env vars set by SparkRunner
(pyzoo/zoo/util/spark.py), ``init_orca_context(**kwargs)``, ``OrcaContext``
global attributes (pyzoo/zoo/orca/common.py), and the Cluster Serving
config.yaml (zoo/.../serving/utils/ConfigParser).  Here all of it collapses
into one dataclass that can be built programmatically or from a YAML/JSON file.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass, field
from typing import Any, Dict, Optional


@dataclass
class MeshConfig:
    """Logical device-mesh layout.

    Axis names are the framework-wide contract (also used by sharding rules in
    ``analytics_zoo_tpu.parallel``):

    - ``data``  : pure data parallelism (batch sharding, gradient psum)
    - ``fsdp``  : data parallelism with parameter/optimizer sharding
    - ``seq``   : sequence/context parallelism (ring attention)
    - ``pipe``  : pipeline parallelism (GPipe stages over shard_map)
    - ``model`` : tensor parallelism (sharded matmuls)
    - ``expert``: expert parallelism (MoE)

    A value of 0 means "absorb all remaining devices" (at most one axis may
    use it); 1 disables the axis.
    """

    data: int = 0
    fsdp: int = 1
    seq: int = 1
    pipe: int = 1
    model: int = 1
    expert: int = 1

    AXIS_ORDER = ("data", "fsdp", "seq", "pipe", "model", "expert")

    #: sharding-strategy names that resolve to a mesh layout via
    #: :meth:`for_strategy` — the Estimator-facing vocabulary.
    STRATEGIES = ("dp", "fsdp", "tp", "2d")

    @classmethod
    def for_strategy(cls, strategy: str, n_devices: Optional[int] = None,
                     model: int = 2) -> "MeshConfig":
        """Mesh layout for an Estimator sharding strategy by name — the
        one-knob path from ``Estimator(sharding=...)`` vocabulary to a
        concrete mesh, so scripts need not hand-pick axis sizes:

        - ``"dp"``   → all devices on ``data`` (batch sharding only)
        - ``"fsdp"`` → all devices on ``fsdp`` (ZeRO-3 batch+param axis)
        - ``"tp"``   → all devices on ``model`` (pure tensor parallelism)
        - ``"2d"``   → ``data × model``: ``model`` inner axis of size
          ``model`` (default 2, the ICI-neighbor dimension), ``data``
          absorbs the rest — the MLPerf-pod layout where the gradient
          all-reduce rides ``data`` and sharded matmuls ride ``model``.

        ``n_devices`` (when given) degrades gracefully: a ``2d`` request
        whose ``model`` axis doesn't fit the device count falls back to
        pure dp instead of erroring (with a warning), so the same script
        runs on one chip and on a pod slice."""
        name = strategy.replace(" ", "")
        if name == "dp":
            return cls(data=0)
        if name == "fsdp":
            return cls(data=1, fsdp=0)
        if name == "tp":
            return cls(data=1, model=0)
        if name == "2d":
            if n_devices is not None and (n_devices < 2 * model
                                          or n_devices % model != 0):
                import logging
                logging.getLogger("analytics_zoo_tpu").warning(
                    "mesh strategy '2d' wants a model axis of %d but only "
                    "%d device(s) fit; degrading to pure data parallelism",
                    model, n_devices or 0)
                return cls(data=0)
            return cls(data=0, model=model)
        raise ValueError(f"unknown mesh strategy {strategy!r}; known: "
                         f"{cls.STRATEGIES}")

    def resolved(self, n_devices: int) -> Dict[str, int]:
        """Return a concrete {axis: size} dict.

        Covers exactly n_devices when a wildcard (0) axis is present;
        otherwise the fixed product may be smaller than n_devices (a subset
        mesh, e.g. debugging on one chip of a multi-chip host) but never
        larger.  Callers that need full coverage must check the product."""
        sizes = {a: getattr(self, a) for a in self.AXIS_ORDER}
        wild = [a for a, s in sizes.items() if s == 0]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be 0 (auto), got {wild}")
        fixed = 1
        for a, s in sizes.items():
            if s > 0:
                fixed *= s
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"fixed mesh axes {sizes} (product {fixed}) do not divide "
                    f"{n_devices} devices")
            sizes[wild[0]] = n_devices // fixed
        else:
            if fixed > n_devices:
                raise ValueError(
                    f"mesh axes {sizes} need {fixed} devices but only "
                    f"{n_devices} are available")
            # fixed < n_devices is allowed: run on a subset (e.g. debugging
            # with {"data": 1} on a multi-chip host)
        return sizes


@dataclass
class ZooConfig:
    """Process-global framework configuration.

    Replaces the reference's OrcaContext knobs (pyzoo/zoo/orca/common.py:
    ``pandas_read_backend``, ``serialize_data_creation``, ``train_data_store``)
    and the SparkRunner env-var plumbing with explicit fields.
    """

    # cluster bootstrap (reference: init_orca_context cluster_mode/cores/...)
    cluster_mode: str = "local"          # "local" | "multihost"
    coordinator_address: Optional[str] = None
    num_processes: Optional[int] = None  # jax.distributed world size
    process_id: Optional[int] = None

    mesh: MeshConfig = field(default_factory=MeshConfig)

    # data layer (reference: OrcaContext.pandas_read_backend)
    pandas_read_backend: str = "pandas"
    shard_size: Optional[int] = None

    # training
    default_dtype: str = "float32"
    compute_dtype: str = "bfloat16"      # matmul/conv dtype on the MXU
    remat: bool = False                  # jax.checkpoint the model fn
    # input-pipeline lookahead (orca/learn/estimator.py fit(prefetch=)):
    # background-thread double buffering between the feed and the train
    # step — host batch assembly + device_put of step k+1 overlap the
    # device compute of step k.  0 = iterate the feed inline (the
    # pre-pipeline behavior, for bisection).
    prefetch: int = 2
    # gradient-collective compression (orca/learn/estimator.py
    # grad_compression=): None = feature off (today's implicit-psum path,
    # zero overhead); "none" = uncompressed but metered
    # (train.comm_ms/train.grad_bytes); "bf16"/"int8" = per-shard
    # quantized all-reduce compiled into the train step (int8 carries
    # error-feedback residuals in the train state).
    grad_compression: Optional[str] = None
    # streaming input pipeline (data/stream.py): decode-worker backend —
    # "thread" (default; bisection-safe, byte-identical batches) or
    # "process" (multi-process decode writing into a shared-memory slot
    # pool; scales GIL-bound decode/augment across host cores) — and the
    # default worker count (None = 4).  Per-feed overrides:
    # StreamingDataFeed(workers=..., num_workers=...).
    feed_backend: str = "thread"
    feed_workers: Optional[int] = None

    # serving hot path (serving/server.py pipeline)
    # concurrent model-call threads pulling assembled batches; bounded
    # by InferenceModel.concurrent_num.  1 = strictly ordered inference
    # (the pre-pipeline behavior, for bisection).
    inference_workers: int = 2
    # per-shape-bucket staging buffers kept for reuse by batch assembly
    # (None = inference_workers + 2)
    staging_pool: Optional[int] = None
    # assembly batching policy (serving/scheduler.py): "window" = fixed
    # batch window (the bisection baseline) | "continuous" = admit
    # arrived requests into the very next device step (no window tail,
    # weighted-fair across models)
    scheduler: str = "window"
    # multi-model serving (serving/model_registry.py): {name: saved-model
    # dir}, loaded by the zoo-serving launcher (--config) into a
    # ModelRegistry; in code, pass ClusterServing(models=...) directly
    models: Optional[Dict[str, str]] = None

    # per-class admission (serving/server.py): requests tagged
    # klass="batch" face a TIGHTER admission gate than interactive /
    # unclassified traffic, so overload sheds batch first.  The wait
    # margin multiplies the queue-wait EWMA in the deadline
    # attainability check (2.0 = a batch request needs 2x the current
    # wait of headroom); the depth fraction scales the queue-depth
    # limit (0.5 = batch is rejected once the queue is half full).
    # 1.0/1.0 restores classless admission for every class.
    admission_batch_wait_margin: float = 2.0
    admission_batch_depth_frac: float = 0.5

    # serving control plane (serving/controller.py): the
    # autoscaler knobs behind `zoo-serving --autoscale` and
    # ServingController's default HysteresisPolicy.  The SLO is on the
    # per-tick windowed client p99; replicas bounds bracket the pool.
    controller_slo_p99_ms: float = 100.0
    controller_min_replicas: int = 1
    controller_max_replicas: int = 4
    controller_interval_s: float = 1.0
    # scale-UP queue high-water mark (None = p99-only policy) and the
    # up/down cooldowns + consecutive-calm-tick requirement guarding
    # scale-down (hysteresis: a noisy minute never flaps the pool)
    controller_queue_high: Optional[float] = None
    controller_up_cooldown_s: float = 5.0
    controller_down_cooldown_s: float = 30.0
    controller_down_ticks: int = 3

    # offline batch scoring (serving/batch.py BatchScorer): rows per
    # journaled shard and the bounded in-flight shard window.  The window
    # caps how much klass="batch" work can pile onto the replica pool at
    # once, so interactive traffic keeps its admission headroom; shard
    # size trades journal granularity (resume wastes at most one shard of
    # work) against per-shard manifest overhead.
    batch_shard_size: int = 1024
    batch_max_inflight: int = 4

    # logging / summaries (reference: set_tensorboard, TrainSummary)
    log_dir: str = "/tmp/analytics_zoo_tpu"
    log_level: str = "INFO"

    # request tracing (core/trace.py): slow-request WARNING threshold in
    # ms and span-ring capacity.  None keeps the module defaults
    # (trace.DEFAULT_SLOW_MS / trace.DEFAULT_MAX_RECORDS); applied by
    # init_orca_context via trace.configure().
    trace_slow_ms: Optional[float] = None
    trace_ring: Optional[int] = None
    # flight recorder (core/flightrec.py): directory for
    # flightrec_<pid>.json crash dumps.  None (default) disables
    # dumping; the ZOO_FLIGHTREC_DIR env var (set by the zoo-launch
    # supervisor next to --metrics-dir) is the fallback.
    flightrec_dir: Optional[str] = None
    # step profiler (orca/learn/estimator.py Estimator(profile=)): the
    # per-device peak FLOP/s the train.mfu gauge divides by.  None falls
    # back to a nominal per-platform constant — set this to your
    # hardware's real peak for an honest MFU.
    device_peak_flops: Optional[float] = None

    # worker liveness (core/launcher.py gang supervision): a file this
    # process touches at init and then on training progress, so a
    # supervisor can tell a hung worker from a slow one.  ``None`` falls
    # back to the ZOO_HEARTBEAT_FILE / ZOO_HEARTBEAT_INTERVAL env vars the
    # zoo-launch supervisor sets; unset both = no heartbeat.
    heartbeat_file: Optional[str] = None
    heartbeat_interval: Optional[float] = None

    # fault injection (core/faults.py): {point: enable-kwargs}, e.g.
    # {"serving.queue_reject": {"times": 3, "seed": 7}} — armed on the
    # global registry by init_orca_context.  Empty = everything disabled.
    faults: Dict[str, Any] = field(default_factory=dict)

    extra: Dict[str, Any] = field(default_factory=dict)

    @classmethod
    def from_file(cls, path: str) -> "ZooConfig":
        """Load from a JSON or YAML file (Cluster Serving config.yaml parity)."""
        with open(path) as f:
            text = f.read()
        data: Dict[str, Any]
        if path.endswith((".yaml", ".yml")):
            try:
                import yaml  # type: ignore
                data = yaml.safe_load(text)
            except ImportError:
                data = _parse_simple_yaml(text)
        else:
            data = json.loads(text)
        return cls.from_dict(data)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "ZooConfig":
        mesh = MeshConfig(**data.get("mesh", {}))
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in data.items() if k in known and k != "mesh"}
        extra = {k: v for k, v in data.items() if k not in known}
        cfg = cls(mesh=mesh, **kwargs)
        cfg.extra.update(extra)
        return cfg

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def _parse_simple_yaml(text: str) -> Dict[str, Any]:
    """Tiny fallback parser for flat ``key: value`` YAML (no pyyaml dep)."""
    out: Dict[str, Any] = {}
    stack = [out]
    indents = [0]
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("#"):
            continue
        indent = len(raw) - len(raw.lstrip())
        key, _, value = raw.strip().partition(":")
        value = value.split(" #", 1)[0].strip()
        while indent < indents[-1]:
            stack.pop()
            indents.pop()
        if not value:
            child: Dict[str, Any] = {}
            stack[-1][key] = child
            stack.append(child)
            indents.append(indent + 2)
        else:
            stack[-1][key] = _coerce(value)
    return out


def _coerce(value: str) -> Any:
    for cast in (int, float):
        try:
            return cast(value)
        except ValueError:
            pass
    if value.lower() in ("true", "false"):
        return value.lower() == "true"
    return value.strip("'\"")
