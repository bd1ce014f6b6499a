"""InferenceModel (port of ``analytics_zoo_tpu/serving/inference_model.py``).

Same serving rules as the JAX package: a request batch is padded to the
nearest batch bucket by repeating its last row, a batch beyond the largest
bucket is served in chunks, the result is trimmed to the request, and
``concurrent_num`` bounds the host threads in flight.

Precision (``load(dtype=, calibrate=)``): the variables as given; a float
dtype, cast once at load; or int8 (``"int8"``, ``"w8"``, ``np.int8``,
``torch.int8``): every float leaf of at least ``_Q_MIN_SIZE`` elements
stored int8 with per-last-axis symmetric scales (the JAX package's
``_quantize_tree``, bit for bit), the smaller ones cast to bf16.  Serving
dequantizes each int8 weight to bf16 on every forward (``nn.quant``: the
counterpart of ``_dequantize_tree``), unless ``calibrate`` was given: then
one float forward over that batch records each ``Dense`` and plain
``Conv2D`` input's range, and those layers quantize their inputs with the
frozen scales and run int8 x int8 -> int32 products.

Executables.  The JAX package compiles one executable per (batch shape,
dtype) key ahead of time.  On the card the counterpart is one CUDA graph
per key: ``_fn_for`` runs one eager forward (the kernels built, cuBLAS's
workspace made), then captures the forward, reading a static input buffer
fed from pinned host staging and writing a static output; ``predict``
replays it, and once a key has a graph nothing of it runs eagerly.  Every
graph of an instance replays on one serving stream, so they share one
memory pool and never replay at the same time; a per-key lock guards each
graph's buffers around copy-in, replay and copy-out, and the caller waits
on an event recorded after its own copy-out (not on the whole stream).
Captures (on their own stream) are serialised.
A capture that fails raises.  ``load`` drops every graph (they hold the
parameters' addresses).  A kernel wrapper's launch count is recorded at
capture and added at each replay (``ops._launches``).  On the CPU, and on
the card with ``cuda_graphs=False``, a key is prepared by one eager
forward and served eagerly.

``compile_count`` counts the keys this instance prepared fresh (a capture,
or a first eager forward); ``load_executables`` prepares its keys without
counting them, as the JAX package's artifact loads do not count.  A CUDA
graph cannot be serialized, so ``save_executables`` writes the manifest
alone: the configuration's fingerprint and, for each key, a hash of the
model code (``_computation_hash``); ``load_executables`` captures the
manifest's keys.  ``enable_aot_cache`` moves the kernels' build directory,
so that a restart skips the ``nvcc`` build.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import inspect
import json
import marshal
import os
import threading
from pathlib import Path
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from .. import DeviceLike, collector_held, resolve_device
from ..convert import buffer_names, from_jax_variables, to_jax_variables
from ..nn import quant
from ..ops import _build, _launches

_Q_MARKER = quant.MARKER
_Q_MIN_SIZE = 4096  # leaves smaller than this stay float (bf16)

Key = Tuple[Tuple[int, ...], str]


def _is_int8_request(dtype: Any) -> bool:
    """True for any spelling of int8 serving ("int8", "w8", np.int8,
    torch.int8): casting float weights to an integer dtype is never what a
    caller wants, so every int8 spelling means int8 quantization."""
    if isinstance(dtype, str):
        return dtype in ("int8", "w8")
    if isinstance(dtype, torch.dtype):
        return dtype == torch.int8
    try:
        return np.dtype(dtype) == np.int8
    except TypeError:
        return False


def _quantize_tree(variables: Any) -> Any:
    """Weight-only int8 of a JAX-layout tree of numpy arrays, as the JAX
    package's ``_quantize_tree`` computes it (numpy, the same statements):
    float leaves of at least ``_Q_MIN_SIZE`` elements become {marker,
    q (int8), scale (f32)} with per-last-axis symmetric scales, smaller
    float leaves bf16 tensors (numpy has no bf16), others stay."""
    def q(leaf):
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            return leaf
        arr = arr.astype(np.float32)
        if arr.size < _Q_MIN_SIZE:
            return torch.from_numpy(arr).to(quant.COMPUTE_DTYPE)
        axes = tuple(range(arr.ndim - 1)) or None
        scale = (np.max(np.abs(arr), axis=axes, keepdims=True)
                 / 127.0).astype(np.float32)
        scale = np.maximum(scale, 1e-12)
        qarr = np.clip(np.round(arr / scale), -127, 127).astype(np.int8)
        return {_Q_MARKER: np.int8(1), "q": qarr, "scale": scale}

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return q(node)

    return walk(variables)


def enable_aot_cache(path: str) -> None:
    """Build and load the kernels' libraries under ``path`` (``ops._build``'s
    ``BUILD_DIR``), so a restart that points here skips the ``nvcc`` build:
    the cold start the JAX package's persistent compilation cache skips.
    Applies process-wide; safe to call more than once."""
    _build.BUILD_DIR = Path(path)


def _describe(v: Any) -> str:
    """A value of a module's configuration as text that is the same in
    every process (no addresses)."""
    if v is None or isinstance(v, (bool, int, float, str, torch.dtype)):
        return repr(v)
    if isinstance(v, (tuple, list)):
        return "(" + ",".join(_describe(e) for e in v) + ")"
    if isinstance(v, dict):
        return "{" + ",".join(f"{k!r}:{_describe(e)}"
                              for k, e in sorted(v.items())) + "}"
    if callable(v) and hasattr(v, "__qualname__"):
        return f"{getattr(v, '__module__', '')}.{v.__qualname__}"
    return type(v).__qualname__


_CLASS_CODE: Dict[type, bytes] = {}


def _class_code(cls: type) -> bytes:
    """The source of ``cls`` and of its bases up to ``nn.Module`` (every
    method, ``forward`` among them); the compiled code where the source
    cannot be read."""
    code = _CLASS_CODE.get(cls)
    if code is None:
        parts = []
        for c in cls.__mro__:
            if c is nn.Module or not issubclass(c, nn.Module):
                break
            try:
                parts.append(inspect.getsource(c).encode())
            except (OSError, TypeError):
                parts.extend(marshal.dumps(f.__code__)
                             for _, f in sorted(vars(c).items())
                             if hasattr(f, "__code__"))
        code = _CLASS_CODE[cls] = b"\0".join(parts)
    return code


class _Graph:
    """One key's captured forward: pinned host staging -> static input ->
    graph -> static output -> pinned host output, under the key's lock, on
    the serving stream; the caller waits on an event recorded after its
    output copy, so threads replaying other keys do not wait for each
    other's later replays."""

    def __init__(self, im: "InferenceModel", shape: Tuple[int, ...],
                 dtype: torch.dtype):
        self.lock = threading.Lock()
        self.stream = im._stream
        self.staging = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.static_in = torch.zeros(shape, dtype=dtype, device=im.device)
        capture = torch.cuda.Stream(device=im.device)
        capture.wait_stream(torch.cuda.current_stream(im.device))
        with torch.cuda.stream(capture):
            im._forward(self.static_in)  # kernels built, workspaces made
        capture.synchronize()
        self.graph = torch.cuda.CUDAGraph()
        with collector_held(), _launches.recording(capture) as self.launches:
            with torch.cuda.graph(self.graph, pool=im._pool, stream=capture,
                                  capture_error_mode="thread_local"):
                self.static_out = im._forward(self.static_in)
        self.host_out = torch.empty(self.static_out.shape,
                                    dtype=self.static_out.dtype,
                                    pin_memory=True)
        self.done = torch.cuda.Event()

    def __call__(self, xp: np.ndarray) -> np.ndarray:
        with self.lock:
            self.staging.numpy()[...] = xp
            with torch.cuda.stream(self.stream):
                self.static_in.copy_(self.staging, non_blocking=True)
                self.graph.replay()
                self.host_out.copy_(self.static_out, non_blocking=True)
                self.done.record(self.stream)
            # this replay and what was queued before it; not the replays
            # other threads queued on the stream since
            self.done.synchronize()
            _launches.replay(self.launches)
            return self.host_out.numpy().copy()


class InferenceModel:
    def __init__(self, concurrent_num: int = 4,
                 batch_buckets: Sequence[int] = (1, 4, 16, 64),
                 device: DeviceLike = None, cuda_graphs: bool = True):
        self.device = resolve_device(device)
        self.concurrent_num = concurrent_num
        self.batch_buckets = sorted(batch_buckets)
        # False serves the card eagerly too (a yardstick for the graphs)
        self.cuda_graphs = cuda_graphs and self.device.type == "cuda"
        self._model: Optional[nn.Module] = None
        self._paths: Dict[int, str] = {}
        self._quantized = False
        self._compute_dtype: Optional[torch.dtype] = None
        self._quant_ctx: Optional[quant.QuantApply] = None
        self._compiled: Dict[Key, Callable[[np.ndarray], np.ndarray]] = {}
        self._sema = threading.Semaphore(concurrent_num)
        self._lock = threading.Lock()
        self._stream = self._pool = None
        # keys prepared fresh by THIS instance (a capture, or a first eager
        # forward); artifact loads through load_executables do not count
        self.compile_count = 0

    # -- loaders ---------------------------------------------------------------

    def load(self, model: nn.Module, variables: Mapping[str, Any],
             dtype: Any = None, calibrate: Any = None) -> "InferenceModel":
        """Load ``variables`` (a ``state_dict``, or a JAX ``{"params",
        "state"}`` tree of arrays) into ``model``, move it to the device
        and set its precision: ``dtype`` a float dtype (e.g.
        ``torch.bfloat16``) casts the floating parameters once; an int8
        spelling serves weight-only int8, and with ``calibrate`` (a
        representative input batch) calibrated int8.  Integer inputs such
        as token ids are never cast.  The model is put in eval mode and
        owned by this object; every prepared key is dropped."""
        int8 = dtype is not None and _is_int8_request(dtype)
        if calibrate is not None and not int8:
            raise ValueError(
                "calibrate= only applies to dtype='int8' serving; got "
                f"dtype={dtype!r} - a silently ignored calibration batch "
                "would leave you believing you deployed calibrated int8")
        with self._lock:
            self._compiled.clear()  # graphs hold the old parameters
            self._stream = self._pool = None
        self._quantized = False
        self._quant_ctx = self._compute_dtype = None
        state = from_jax_variables(variables) if "params" in variables \
            else dict(variables)
        quant.uninstall(model)  # a model an earlier int8 load changed
        model.float()
        model.load_state_dict(state, strict=True)
        self._model = model.to(device=self.device).eval()
        self._paths = quant.module_paths(model)
        if int8:
            if calibrate is not None:
                collector = quant.Calibrator()
                self._forward(torch.from_numpy(np.asarray(calibrate)).to(
                    self.device), collector)
                self._quant_ctx = quant.QuantApply(collector.amax)
            tree = _quantize_tree(to_jax_variables(state,
                                                   buffer_names(model)))
            quant.install(model, from_jax_variables(tree))
            model.to(device=self.device)
            self._paths = quant.module_paths(model)
            self._quantized = True
            self._compute_dtype = quant.COMPUTE_DTYPE
        elif dtype is not None:
            model.to(dtype=dtype)  # floating parameters only
        return self

    def load_zoo_model(self, path: str, dtype: Any = None
                       ) -> "InferenceModel":
        """Load a ``ZooModel.save_model`` directory of either package."""
        from ..models import ZooModel
        m = ZooModel.load_model(path)
        return self.load(m, m._loaded_variables, dtype=dtype)

    def load_estimator(self, est: Any, dtype: Any = None
                       ) -> "InferenceModel":
        """Serve a copy of a trained ``Estimator``'s model with its current
        variables (the estimator's own model is left as it is)."""
        return self.load(copy.deepcopy(est.model), est.get_model(),
                         dtype=dtype)

    def parameter_bytes(self) -> int:
        """The bytes of the loaded model's parameters and buffers as they
        are stored (int8 weights at one byte an element)."""
        return sum(t.numel() * t.element_size()
                   for t in self._model.state_dict().values())

    # -- the forward and its keys ----------------------------------------------

    def _forward(self, x: torch.Tensor, ctx: Any = None) -> torch.Tensor:
        """The serving forward on a device batch, under ``ctx`` (default:
        this load's int8 context, if any); bf16 outputs come back f32."""
        ctx = self._quant_ctx if ctx is None else ctx
        scope = quant.using(ctx, self._paths) if ctx is not None \
            else contextlib.nullcontext()
        with scope, torch.inference_mode():
            out = self._model(x)
            return out.float() if out.dtype == torch.bfloat16 else out

    def _run_eager(self, xp: np.ndarray) -> np.ndarray:
        return self._forward(torch.from_numpy(xp).to(self.device)).cpu().numpy()

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        return self.batch_buckets[-1]

    def _prepare(self, key: Key) -> Callable[[np.ndarray], np.ndarray]:
        shape, dtype_str = key
        dtype = torch.from_numpy(np.zeros(0, dtype_str)).dtype
        if not self.cuda_graphs:
            self._forward(torch.zeros(shape, dtype=dtype, device=self.device))
            return self._run_eager
        if self._stream is None:
            self._stream = torch.cuda.Stream(device=self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return _Graph(self, shape, dtype)

    def _fn_for(self, shape: Tuple[int, ...], dtype: Any,
                count: bool = True) -> Callable[[np.ndarray], np.ndarray]:
        key = (tuple(int(s) for s in shape), str(np.dtype(dtype)))
        fn = self._compiled.get(key)
        if fn is None:
            with self._lock:
                fn = self._compiled.get(key)
                if fn is None:
                    fn = self._prepare(key)
                    self._compiled[key] = fn
                    if count:
                        self.compile_count += 1
        return fn

    # -- warmup (the hot-swap seam: prepare BEFORE traffic arrives) -------------

    def warm(self, shapes: Sequence[Tuple[int, ...]],
             dtype: Any = np.float32,
             buckets: Optional[Sequence[int]] = None) -> int:
        """Prepare (capture, on the card) each per-row shape x batch bucket
        (``buckets`` defaults to every ``batch_buckets`` entry), so no
        request waits on a capture; returns the number of (shape, bucket)
        keys now resident."""
        use = self.batch_buckets if buckets is None else sorted(
            int(b) for b in buckets)
        n = 0
        for shape in shapes:
            for b in use:
                self._fn_for((int(b),) + tuple(int(s) for s in shape),
                             np.dtype(dtype))
                n += 1
        return n

    def warm_from(self, other: "InferenceModel") -> int:
        """Warm this model for the traffic ``other`` has realized (the
        version hot-swap path).  Each of ``other``'s keys is re-bucketed:
        its row counts were anywhere in (0, its bucket], so every one of
        OUR buckets such a count could pad to is warmed.  Returns the
        number of keys warmed."""
        n = 0
        seen = set()
        for (shape, dtype_str) in list(getattr(other, "_compiled", {})):
            row = tuple(shape[1:])
            cap = self._bucket(int(shape[0]))
            for b in self.batch_buckets:
                if b > cap:
                    break
                key = ((b,) + row, dtype_str)
                if key in seen:
                    continue
                seen.add(key)
                self._fn_for((b,) + row, np.dtype(dtype_str))
                n += 1
        return n

    # -- the executables' manifest ----------------------------------------------

    def _config_fingerprint(self) -> str:
        """Identity of the serving configuration a manifest is valid for:
        precision, whether quantized, the calibration ranges, and the
        ``state_dict``'s keys, dtypes and shapes."""
        qctx = self._quant_ctx
        leaves = sorted((key, str(t.dtype), str(tuple(t.shape)))
                        for key, t in self._model.state_dict().items())
        parts = [str(self._compute_dtype), str(self._quantized),
                 repr(sorted(qctx.amax.items())) if qctx else "none",
                 repr(leaves)]
        return hashlib.sha256("|".join(parts).encode()).hexdigest()[:16]

    def _computation_hash(self, shape: Sequence[int], dtype: Any) -> str:
        """Hash of the serving computation for one key: the module tree
        (each submodule's qualified name, class, configuration and the
        source of its class), so a model-code edit that leaves the
        parameters alike (an activation swap, a stride) changes it."""
        h = hashlib.sha256(repr((tuple(int(s) for s in shape),
                                 str(np.dtype(dtype)))).encode())
        for name, m in self._model.named_modules():
            cls = quant.base_class(m)
            config = ",".join(f"{k}={_describe(v)}"
                              for k, v in sorted(vars(m).items())
                              if not k.startswith("_") and k != "training")
            h.update(f"\0{name}|{cls.__module__}.{cls.__qualname__}|"
                     f"{config}".encode())
            h.update(_class_code(cls))
        return h.hexdigest()[:16]

    def save_executables(self, path: str) -> int:
        """Write the manifest of the keys prepared so far (a CUDA graph
        cannot be serialized: ``load_executables`` captures them again);
        returns the number of keys."""
        os.makedirs(path, exist_ok=True)
        keys = [{"shape": list(shape), "dtype": dtype_str,
                 "hash": self._computation_hash(shape, dtype_str)}
                for shape, dtype_str in list(self._compiled)]
        with open(os.path.join(path, "manifest.json"), "w") as f:
            json.dump({"fingerprint": self._config_fingerprint(),
                       "keys": keys}, f)
        return len(keys)

    def load_executables(self, path: str, verify: bool = True) -> int:
        """Prepare the keys of a manifest ``save_executables`` wrote,
        without counting them in ``compile_count``.  Nothing is prepared
        when the serving configuration differs from the one saved; with
        ``verify`` (default) a key whose model-code hash differs from the
        current model's is skipped.  Returns the number prepared."""
        mf = os.path.join(path, "manifest.json")
        if not os.path.exists(mf):
            return 0
        with open(mf) as f:
            manifest = json.load(f)
        if manifest.get("fingerprint") != self._config_fingerprint():
            return 0
        n = 0
        for item in manifest["keys"]:
            shape, dtype_str = tuple(item["shape"]), item["dtype"]
            if verify and item.get("hash") != self._computation_hash(
                    shape, dtype_str):
                continue  # the model code changed: leave it to _fn_for
            self._fn_for(shape, dtype_str, count=False)
            n += 1
        return n

    # -- predict ---------------------------------------------------------------

    def predict(self, x: np.ndarray) -> np.ndarray:
        """Batched forward: pads to the nearest bucket, chunks beyond the
        largest, trims the result to the request's rows."""
        if self._model is None:
            raise ValueError("no model loaded")
        x = np.asarray(x)
        n = x.shape[0]
        bucket = self._bucket(n)
        if n > bucket:  # larger than the largest bucket: chunk
            return np.concatenate([self.predict(x[i:i + bucket])
                                   for i in range(0, n, bucket)], axis=0)
        if n < bucket:
            x = np.concatenate([x, np.repeat(x[-1:], bucket - n, axis=0)])
        xp = np.ascontiguousarray(x)
        fn = self._fn_for(xp.shape, xp.dtype)
        with self._sema:  # bound in-flight host threads
            out = fn(xp)
        return out[:n]

    # reference-parity aliases
    do_predict = predict
    do_load = load
