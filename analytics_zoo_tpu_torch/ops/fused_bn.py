"""Channel-last training batch norm, forward and backward: hand-written CUDA
kernels for Hopper and their plain PyTorch versions.

Port of ``analytics_zoo_tpu/ops/fused_bn.py``.  The TPU package runs
``bn_train`` as a ``jax.custom_vjp``: the forward takes f32 moments over
every axis but the last in one shifted pass (``_moments``) and normalizes in
x's dtype with the bf16 mean's rounding residual folded into the
per-channel shift (``_normalize``); the backward takes ``s1 = Σdy`` and
``s2 = Σdy·x̂`` in f32 and one element pass for dx that includes the
``dmean``/``dvar`` cotangent terms.  Here, for a tensor on the card:

- ``bn_train_fwd`` launches ``csrc/fused_bn.cu``'s forward kernel (one
  persistent cooperative launch: shifted sums, a grid-wide barrier, the
  per-channel scalars and y, with as much of the map as fits kept in
  shared memory between the two);
- ``bn_train_bwd`` launches its backward kernel (the same shape: s1 and
  s2, the barrier, dgamma, dbeta and dx);
- ``bn_train`` ties them together in a ``torch.autograd.Function`` that
  returns ``(y, mean, var)`` and saves ``(x, gamma, mean, var)``, as the
  ``custom_vjp`` does.

Over a batch split across processes (``bn_train(..., group=)``: the data
group of ``torch.distributed`` ranks whose local rows make one global
batch) the moments are the global batch's, as the JAX package's
``_moments`` over a sharded batch: one grid barrier cannot span processes,
so each direction splits at its reduction (``bn_train_split``):

- forward: the first rank's row 0 is broadcast as the shift; a kernel
  writes the per-channel f32 ``Σ(x - shift)`` and ``Σ(x - shift)²`` of the
  local rows (``split_fwd_stats``); the ``[2, C]`` sums are all-reduced
  over the group; a kernel finalizes mean and var over the global n and
  normalizes with the same rounding-compensated arithmetic
  (``split_fwd_apply``);
- backward: a kernel writes the local ``s1 = Σdy`` and ``s2 = Σdy·x̂``
  (``split_bwd_stats``); ``[s1, s2, dmean, dvar]`` are all-reduced; a
  kernel writes dx from the global sums (``split_bwd_apply``).  dgamma and
  dbeta are the local sums: the estimator's gradient all-reduce adds the
  ranks' up, as it adds every other parameter's.

The one-launch cooperative kernels stay the path of one process.

For a tensor on the CPU the wrappers use ``bn_train_fwd_reference`` and
``bn_train_bwd_reference``, which repeat the JAX package's arithmetic.
There is no fallback from the card to the plain versions: a kernel that
fails to build or launch raises.  ``bn_train_plain`` is the same
``autograd.Function`` over the plain versions on any device, the yardstick
the kernels are held against on the card; the port's layers never call it.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Any, NamedTuple, Tuple

import torch

from . import _launches

SOURCE = "fused_bn"  # csrc/<source>.cu
_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}
PASSES = ("fwd", "bwd")
SPLIT_PASSES = ("split_fwd_stats", "split_fwd_apply", "split_bwd_stats",
                "split_bwd_apply")
# launches of each kernel by dtype ("fwd_bf16", ...): each entry call
# launches its direction's kernel once; bn_train_fwd.launches and
# bn_train_bwd.launches count the entries' calls
KERNEL_LAUNCHES = {f"{p}_{s}": 0 for s in _SUFFIX.values() for p in PASSES}
# the split entries' launches by dtype ("split_fwd_stats_bf16", ...)
SPLIT_KERNEL_LAUNCHES = {f"{p}_{s}": 0 for s in _SUFFIX.values()
                         for p in SPLIT_PASSES}
_count_lock = threading.Lock()
# the launch (as csrc/fused_bn.cu derives it): blocks of 512 threads, one
# an SM, over tiles of up to 512 channel vectors (whole rows of every
# ResNet-50 map); at least 4 rows a thread;
# up to 200 KB of each block's rows kept in shared memory between the
# kernel's two phases (the card allows 227 KB a block, the kernel's
# reduction buffer takes 16 KB of it)
THREADS = 512
MIN_ROWS_PER_THREAD = 4
RESIDENT_BYTES = 200 * 1024
SMEM_PER_BLOCK = 232_448


class Plan(NamedTuple):
    """One launch over ``[rows, c]``: blocks of ``tx`` x ``ty`` threads
    (channel vectors x row groups) over ``ctiles`` channel tiles, each
    tile's rows split among ``blocks`` as evenly as the counts allow (at
    most ``splits`` a tile); each block keeps ``keep`` of its at most
    ``rows_per_block`` rows in ``smem_bytes`` of shared memory; the
    workspace is ``work_floats`` f32 (two [c] outputs, the partials, four
    [c] per-channel scalars, the barrier's counter)."""
    tx: int
    ty: int
    ctiles: int
    blocks: int
    splits: int
    rows_per_block: int
    keep: int
    smem_bytes: int
    work_floats: int


@functools.lru_cache(maxsize=None)
def plan(rows: int, c: int, itemsize: int, vec: bool, direction: str,
         sm_count: int) -> Plan:
    """The launch of ``direction``'s kernel ("fwd" keeps x on chip, "bwd"
    dy and x) over ``[rows, c]`` on a card of ``sm_count`` SMs."""
    v = 16 // itemsize if vec else 1
    nvec = c // v
    tx = min(nvec, THREADS)
    ty = THREADS // tx
    ctiles = -(-nvec // tx)
    per_tile = max(1, min(-(-sm_count // ctiles),
                          -(-rows // (ty * MIN_ROWS_PER_THREAD))))
    blocks = min(sm_count, ctiles * per_tile)
    # more tiles than blocks: a block takes several, none kept on chip
    units = max(blocks, ctiles)
    rows_per_block = -(-rows // (units // ctiles))
    row_bytes = tx * v * itemsize * (1 if direction == "fwd" else 2)
    keep = (min(rows_per_block, RESIDENT_BYTES // row_bytes)
            if vec and units == blocks else 0)
    splits = -(-units // ctiles)
    return Plan(tx, ty, ctiles, blocks, splits, rows_per_block, keep,
                keep * row_bytes, 6 * c + 2 * splits * c + 1)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _rows(x: torch.Tensor) -> int:
    return math.prod(x.shape[:-1])


def bn_train_fwd_reference(x: torch.Tensor, gamma: torch.Tensor,
                           beta: torch.Tensor, eps: float
                           ) -> Tuple[torch.Tensor, ...]:
    """``(y, mean, var)`` of batch norm over every axis of ``x`` but the
    last: the JAX package's ``_moments`` (f32 sums shifted by the first
    sample ``x[0, ..., 0, :]``, ``var = max(m2 - m1², 0)``) and
    ``_normalize`` (``(x - T(mean)) * T(inv) + T(shift)`` in x's dtype
    ``T``, with ``inv = rsqrt(var + eps) * gamma`` and the f32 rounding
    residual ``(T(mean) - mean) * inv + beta`` as the shift).  Runs on any
    device; it is what the kernels are held against."""
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    n = x2.shape[0]
    shift = x2[0].detach().float()
    xc = x2.float() - shift
    m1 = xc.sum(dim=0) / n
    m2 = xc.square().sum(dim=0) / n
    mean = m1 + shift
    var = torch.clamp_min(m2 - m1.square(), 0.0)
    inv = torch.rsqrt(var + eps) * gamma
    mean_c = mean.to(x.dtype)
    sh = (mean_c.float() - mean) * inv + beta
    y = (x - mean_c) * inv.to(x.dtype) + sh.to(x.dtype)
    return y, mean, var


def bn_train_bwd_reference(x: torch.Tensor, gamma: torch.Tensor,
                           mean: torch.Tensor, var: torch.Tensor,
                           dy: torch.Tensor, dmean: torch.Tensor,
                           dvar: torch.Tensor, eps: float
                           ) -> Tuple[torch.Tensor, ...]:
    """``(dx, dgamma, dbeta)``: the JAX package's ``_bn_train_bwd``.
    ``s1 = Σdy``, ``s2 = Σdy·(x - mean)·inv`` in f32; ``dx = dy·k - c1 -
    (x - mean)·c2 + x·cv`` in f32, cast to x's dtype, where ``k = gamma·inv``,
    ``c1 = (s1/n)k - dmean/n + (dvar/n)·2·mean``, ``c2 = (s2/n)·k·inv`` and
    ``cv = (dvar/n)·2`` carry the mean and var cotangents.  Runs on any
    device."""
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    dyf = dy.reshape(-1, c).float()
    n = xf.shape[0]
    inv = torch.rsqrt(var + eps)
    s1 = dyf.sum(dim=0)
    s2 = (dyf * ((xf - mean) * inv)).sum(dim=0)
    k = gamma * inv
    c1 = (s1 / n) * k - dmean / n + (dvar / n) * 2.0 * mean
    c2 = (s2 / n) * k * inv
    cv = (dvar / n) * 2.0
    dx = dyf * k - c1 - (xf - mean) * c2 + xf * cv
    return dx.to(x.dtype).reshape(x.shape), s2, s1


def _on_cpu(x: torch.Tensor, name: str) -> bool:
    """True for a CPU tensor (the plain version), False for a CUDA one
    (the kernel); raises for any other device."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu tensors, not "
                         f"{x.device.type}")
    return False


def _check(x: torch.Tensor, *per_channel: torch.Tensor) -> None:
    if x.dim() < 2:
        raise ValueError(f"batch norm wants x of shape [..., C], not "
                         f"{tuple(x.shape)}")
    c = x.shape[-1]
    if _rows(x) < 1 or c < 1:
        raise ValueError(f"batch norm over an empty x {tuple(x.shape)}")
    for t in per_channel:
        if t.shape != (c,):
            raise ValueError(f"per-channel tensors must be [{c}], got "
                             f"{tuple(t.shape)}")


def _vectorized(c: int, itemsize: int, *maps: torch.Tensor) -> bool:
    """16-byte vectors of channels: C a whole number of them and every map
    16-byte aligned (a view at an odd offset takes the scalar path)."""
    return c % (16 // itemsize) == 0 and all(
        t.data_ptr() % 16 == 0 for t in maps)


_ENTRY_ARGS = {
    # pointers, then rows (long long), C, blocks, keep, vec (int), eps, stream
    "fwd": 5,
    "bwd": 9,
}
_entries: dict = {}


def _entry(direction: str, dtype: torch.dtype):
    """The C entry point ``fused_bn_<direction>_<dtype>`` (built at first
    use) and its library, with its argument types set."""
    key = (direction, dtype)
    if key not in _entries:
        from . import _build
        lib = _build.load(SOURCE)
        fn = getattr(lib, f"fused_bn_{direction}_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * _ENTRY_ARGS[direction] + [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int  # ints would cut 64-bit pointers
        _entries[key] = lib, fn
    return _entries[key]


def _on_stream(device: torch.device, call):
    """``call(stream)`` on ``device``'s current stream, with ``device``
    made current for the launch where it is not."""
    if device.index == torch.cuda.current_device():
        return call(torch.cuda.current_stream().cuda_stream)
    with torch.cuda.device(device):
        return call(torch.cuda.current_stream().cuda_stream)


def _raise_on_error(lib, entry: str, err: int) -> None:
    if err != 0:
        es = lib.fused_bn_error_string
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{entry} launch failed: CUDA error {err} "
                           f"({es(err).decode()})")


def _check_launch(x: torch.Tensor, *others: torch.Tensor) -> None:
    if x.dtype not in _SUFFIX:
        raise ValueError(f"the CUDA kernels take float32 or bfloat16, not "
                         f"{x.dtype}")
    if any(t.device != x.device for t in others):
        raise ValueError("the kernels' tensors must lie on one device")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().float().contiguous()


def _count(fn, *names: str) -> None:
    if _launches.deferred(_count, fn, *names):
        return  # a CUDA graph capture: each replay counts it
    with _count_lock:
        fn.launches += 1
        for name in names:
            if name in KERNEL_LAUNCHES:
                KERNEL_LAUNCHES[name] += 1
            else:
                SPLIT_KERNEL_LAUNCHES[name] += 1


def _launch_fwd(x, gamma, beta, eps):
    _check_launch(x, gamma, beta)
    x = x.contiguous()
    c, rows = x.shape[-1], _rows(x)
    y = torch.empty_like(x)
    vec = _vectorized(c, x.element_size(), x, y)
    p = plan(rows, c, x.element_size(), vec, "fwd", _sm_count(x.device.index))
    work = torch.empty(p.work_floats, dtype=torch.float32, device=x.device)
    gamma, beta = _f32(gamma), _f32(beta)
    lib, fn = _entry("fwd", x.dtype)
    err = _on_stream(x.device, lambda stream: fn(
        x.data_ptr(), y.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
        work.data_ptr(), rows, c, p.blocks, p.keep, int(vec), float(eps),
        stream))
    _raise_on_error(lib, "fused_bn forward", err)
    _count(bn_train_fwd, f"fwd_{_SUFFIX[x.dtype]}")
    return y, work[:c], work[c:2 * c]


def _launch_bwd(x, gamma, mean, var, dy, dmean, dvar, eps):
    _check_launch(x, gamma, mean, var, dy, dmean, dvar)
    if dy.dtype != x.dtype:
        raise ValueError(f"dy must have x's dtype {x.dtype}, not {dy.dtype}")
    x, dy = x.contiguous(), dy.contiguous()
    c, rows = x.shape[-1], _rows(x)
    dx = torch.empty_like(x)
    vec = _vectorized(c, x.element_size(), x, dy, dx)
    p = plan(rows, c, x.element_size(), vec, "bwd", _sm_count(x.device.index))
    work = torch.empty(p.work_floats, dtype=torch.float32, device=x.device)
    gamma, mean, var, dmean, dvar = (_f32(t) for t in
                                     (gamma, mean, var, dmean, dvar))
    lib, fn = _entry("bwd", x.dtype)
    err = _on_stream(x.device, lambda stream: fn(
        dy.data_ptr(), x.data_ptr(), gamma.data_ptr(), mean.data_ptr(),
        var.data_ptr(), dmean.data_ptr(), dvar.data_ptr(), dx.data_ptr(),
        work.data_ptr(), rows, c, p.blocks, p.keep, int(vec), float(eps),
        stream))
    _raise_on_error(lib, "fused_bn backward", err)
    _count(bn_train_bwd, f"bwd_{_SUFFIX[x.dtype]}")
    return dx, work[:c], work[c:2 * c]


def bn_train_fwd(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 eps: float) -> Tuple[torch.Tensor, ...]:
    """Training batch norm forward over the last axis of ``x``: ``(y in x's
    dtype, mean f32 [C], var f32 [C])``.

    A CUDA tensor goes to ``csrc/fused_bn.cu`` (f32 or bf16, any shape
    ``[..., C]``), anything else raises; a CPU tensor takes the plain
    version.  ``bn_train_fwd.launches`` counts calls that launched the
    kernel, ``KERNEL_LAUNCHES`` each kernel's launches by dtype."""
    _check(x, gamma, beta)
    if _on_cpu(x, "bn_train_fwd"):
        return bn_train_fwd_reference(x, gamma, beta, eps)
    return _launch_fwd(x, gamma, beta, eps)


bn_train_fwd.launches = 0


def bn_train_bwd(x: torch.Tensor, gamma: torch.Tensor, mean: torch.Tensor,
                 var: torch.Tensor, dy: torch.Tensor, dmean: torch.Tensor,
                 dvar: torch.Tensor, eps: float) -> Tuple[torch.Tensor, ...]:
    """Training batch norm backward: ``(dx in x's dtype, dgamma f32,
    dbeta f32)`` from the forward's ``mean``/``var`` and the cotangents of
    ``y``, ``mean`` and ``var``.

    A CUDA tensor goes to ``csrc/fused_bn.cu``, anything else raises; a
    CPU tensor takes the plain version.  ``bn_train_bwd.launches`` counts
    calls that launched the kernel."""
    _check(x, gamma, mean, var, dmean, dvar)
    if dy.shape != x.shape:
        raise ValueError(f"dy {tuple(dy.shape)} does not match x "
                         f"{tuple(x.shape)}")
    if _on_cpu(x, "bn_train_bwd"):
        return bn_train_bwd_reference(x, gamma, mean, var, dy, dmean, dvar,
                                      eps)
    return _launch_bwd(x, gamma, mean, var, dy, dmean, dvar, eps)


bn_train_bwd.launches = 0


class _FusedBatchNorm(torch.autograd.Function):
    """``bn_train_fwd`` with ``bn_train_bwd`` as its gradient (or, with
    ``plain``, their plain versions on any device): outputs ``(y, mean,
    var)``, residuals ``(x, gamma, mean, var)``, as the JAX package's
    ``custom_vjp``.  Unused output cotangents arrive as zeros."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, plain):
        fwd = bn_train_fwd_reference if plain else bn_train_fwd
        y, mean, var = fwd(x, gamma, beta, eps)
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.eps, ctx.plain = eps, plain
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, var = ctx.saved_tensors
        bwd = bn_train_bwd_reference if ctx.plain else bn_train_bwd
        dx, dgamma, dbeta = bwd(x, gamma, mean, var, dy.contiguous(),
                                dmean, dvar, ctx.eps)
        return dx, dgamma, dbeta, None, None


def bn_train(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
             eps: float, group: Any = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One training-step batch norm over the last axis of ``x``: ``(y in
    x's dtype, f32 batch mean, f32 biased batch var)``, differentiable in
    all three.  On the card both directions run in ``csrc/fused_bn.cu``.
    With a ``group`` (a ``torch.distributed`` process group, even of one
    rank) the batch is the global one its ranks hold: the split form
    (``bn_train_split``)."""
    if group is not None:
        return bn_train_split(x, gamma, beta, eps, group)
    return _FusedBatchNorm.apply(x, gamma, beta, float(eps), False)


def bn_train_plain(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float, group: Any = None) -> Tuple[torch.Tensor, ...]:
    """``bn_train`` through the plain versions on any device: the yardstick
    the kernels are held against (``chip_smoke.py``); no layer calls it."""
    if group is not None:
        return bn_train_split(x, gamma, beta, eps, group, plain=True)
    return _FusedBatchNorm.apply(x, gamma, beta, float(eps), True)


# -- the split form: one batch over several processes -------------------------

#: row ranges a channel tile in the split kernels' grids: about two
#: 512-thread blocks an SM, at least 4 rows a thread
SPLIT_BLOCKS_PER_SM = 2


def split_plan(rows: int, c: int, itemsize: int, vec: bool,
               sm_count: int) -> int:
    """The split kernels' row ranges a channel tile over ``[rows, c]``."""
    v = 16 // itemsize if vec else 1
    nvec = c // v
    tx = min(nvec, THREADS)
    ty = THREADS // tx
    ctiles = -(-nvec // tx)
    return max(1, min(-(-SPLIT_BLOCKS_PER_SM * sm_count // ctiles),
                      -(-rows // (ty * MIN_ROWS_PER_THREAD))))


def split_fwd_stats_reference(x: torch.Tensor, shift: torch.Tensor
                              ) -> torch.Tensor:
    """``[Σ(x - shift), Σ(x - shift)²]`` of x's rows per channel, f32
    ``[2, C]``."""
    xc = x.reshape(-1, x.shape[-1]).float() - shift
    return torch.stack([xc.sum(dim=0), xc.square().sum(dim=0)])


def split_fwd_apply_reference(x, gamma, beta, sums, shift, n, eps):
    """``(y, mean, var)`` from the global sums over ``n`` rows: the plain
    forward's finalize and normalize."""
    m1 = sums[0] / n
    m2 = sums[1] / n
    mean = m1 + shift
    var = torch.clamp_min(m2 - m1.square(), 0.0)
    inv = torch.rsqrt(var + eps) * gamma
    mean_c = mean.to(x.dtype)
    sh = (mean_c.float() - mean) * inv + beta
    y = (x - mean_c) * inv.to(x.dtype) + sh.to(x.dtype)
    return y, mean, var


def split_bwd_stats_reference(x, mean, var, dy, eps) -> torch.Tensor:
    """``[Σdy, Σdy·(x - mean)·rsqrt(var + eps)]`` of the local rows, f32
    ``[2, C]``."""
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    dyf = dy.reshape(-1, c).float()
    inv = torch.rsqrt(var + eps)
    return torch.stack([dyf.sum(dim=0),
                        (dyf * ((xf - mean) * inv)).sum(dim=0)])


def split_bwd_apply_reference(x, gamma, mean, var, dy, sums, n, eps):
    """dx from the global ``[s1, s2, dmean, dvar]`` over ``n`` rows: the
    plain backward's element pass."""
    c = x.shape[-1]
    xf = x.reshape(-1, c).float()
    dyf = dy.reshape(-1, c).float()
    s1, s2, dmean, dvar = sums
    inv = torch.rsqrt(var + eps)
    k = gamma * inv
    c1 = (s1 / n) * k - dmean / n + (dvar / n) * 2.0 * mean
    c2 = (s2 / n) * k * inv
    cv = (dvar / n) * 2.0
    dx = dyf * k - c1 - (xf - mean) * c2 + xf * cv
    return dx.to(x.dtype).reshape(x.shape)


_SPLIT_ARGS = {
    # (pointers, then the integer and float arguments after them)
    "split_fwd_stats": ([ctypes.c_void_p] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int]),
    "split_fwd_apply": ([ctypes.c_void_p] * 8 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float]),
    "split_bwd_stats": ([ctypes.c_void_p] * 6 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float]),
    "split_bwd_apply": ([ctypes.c_void_p] * 7 + [
        ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float]),
}


def _split_entry(name: str, dtype: torch.dtype):
    key = (name, dtype)
    if key not in _entries:
        from . import _build
        lib = _build.load(SOURCE)
        fn = getattr(lib, f"fused_bn_{name}_{_SUFFIX[dtype]}")
        fn.argtypes = _SPLIT_ARGS[name] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _entries[key] = lib, fn
    return _entries[key]


def _split_call(entry, x: torch.Tensor, *args) -> None:
    """Launch split entry ``entry`` (one of the ``split_*`` wrappers) on
    ``x``'s stream and count it."""
    name = entry.__name__
    lib, fn = _split_entry(name, x.dtype)
    err = _on_stream(x.device, lambda stream: fn(*args, stream))
    _raise_on_error(lib, f"fused_bn {name}", err)
    _count(entry, f"{name}_{_SUFFIX[x.dtype]}")


def split_launches() -> dict:
    """Launches of each split entry (stats and apply of each direction)."""
    return {name: globals()[name].launches for name in SPLIT_PASSES}


def _split_geometry(x: torch.Tensor, *maps: torch.Tensor):
    c, rows = x.shape[-1], _rows(x)
    vec = _vectorized(c, x.element_size(), x, *maps)
    splits = split_plan(rows, c, x.element_size(), vec,
                        _sm_count(x.device.index))
    return c, rows, vec, splits


def split_fwd_stats(x: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """The local sums of the split forward, f32 ``[2, C]``: the kernel for
    a CUDA tensor, the plain version for a CPU one."""
    if _on_cpu(x, "split_fwd_stats"):
        return split_fwd_stats_reference(x, shift)
    _check_launch(x, shift)
    x = x.contiguous()
    c, rows, vec, splits = _split_geometry(x)
    work = torch.empty(splits * 2 * c, dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    shift = _f32(shift)
    _split_call(split_fwd_stats, x, x.data_ptr(), shift.data_ptr(),
                work.data_ptr(), out.data_ptr(), rows, c, splits, int(vec))
    return out


def split_fwd_apply(x, gamma, beta, sums, shift, n: int, eps: float):
    """``(y, mean, var)`` of the split forward from the global sums over
    ``n`` rows."""
    if _on_cpu(x, "split_fwd_apply"):
        return split_fwd_apply_reference(x, gamma, beta, sums, shift, n, eps)
    _check_launch(x, gamma, beta, sums, shift)
    x = x.contiguous()
    y = torch.empty_like(x)
    c, rows, vec, splits = _split_geometry(x, y)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty(c, dtype=torch.float32, device=x.device)
    gamma, beta, sums, shift = (_f32(t) for t in (gamma, beta, sums, shift))
    _split_call(split_fwd_apply, x, x.data_ptr(), y.data_ptr(),
                gamma.data_ptr(), beta.data_ptr(), sums.data_ptr(),
                shift.data_ptr(), mean.data_ptr(), var.data_ptr(), rows,
                int(n), c, splits, int(vec), float(eps))
    return y, mean, var


def split_bwd_stats(x, mean, var, dy, eps: float) -> torch.Tensor:
    """The local ``[s1, s2]`` of the split backward, f32 ``[2, C]``."""
    if _on_cpu(x, "split_bwd_stats"):
        return split_bwd_stats_reference(x, mean, var, dy, eps)
    _check_launch(x, mean, var, dy)
    x, dy = x.contiguous(), dy.contiguous()
    c, rows, vec, splits = _split_geometry(x, dy)
    work = torch.empty(splits * 2 * c, dtype=torch.float32, device=x.device)
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    mean, var = _f32(mean), _f32(var)
    _split_call(split_bwd_stats, x, dy.data_ptr(), x.data_ptr(),
                mean.data_ptr(), var.data_ptr(), work.data_ptr(),
                out.data_ptr(), rows, c, splits, int(vec), float(eps))
    return out


def split_bwd_apply(x, gamma, mean, var, dy, sums, n: int, eps: float):
    """dx of the split backward from the global ``[s1, s2, dmean, dvar]``
    over ``n`` rows."""
    if _on_cpu(x, "split_bwd_apply"):
        return split_bwd_apply_reference(x, gamma, mean, var, dy, sums, n,
                                         eps)
    _check_launch(x, gamma, mean, var, dy, sums)
    x, dy = x.contiguous(), dy.contiguous()
    dx = torch.empty_like(x)
    c, rows, vec, splits = _split_geometry(x, dy, dx)
    gamma, mean, var, sums = (_f32(t) for t in (gamma, mean, var, sums))
    _split_call(split_bwd_apply, x, dy.data_ptr(), x.data_ptr(),
                gamma.data_ptr(), mean.data_ptr(), var.data_ptr(),
                sums.data_ptr(), dx.data_ptr(), rows, int(n), c, splits,
                int(vec), float(eps))
    return dx


for _fn in (split_fwd_stats, split_fwd_apply, split_bwd_stats,
            split_bwd_apply):
    _fn.launches = 0


def _group_size(group: Any) -> int:
    import torch.distributed as dist
    return dist.get_world_size(group)


def _all_reduce(t: torch.Tensor, group: Any) -> torch.Tensor:
    import torch.distributed as dist
    dist.all_reduce(t, group=group)
    return t


class _SplitBatchNorm(torch.autograd.Function):
    """Batch norm over the global batch whose rows ``group``'s ranks hold
    in equal parts: ``(y, mean, var)`` as ``_FusedBatchNorm``, through the
    split entries (or, with ``plain``, their plain versions on any
    device)."""

    @staticmethod
    def forward(ctx, x, gamma, beta, eps, group, plain):
        import torch.distributed as dist
        c = x.shape[-1]
        # a copy: the broadcast writes it (row 0 of an f32 x is a view)
        shift = x.reshape(-1, c)[0].detach().float().clone()
        dist.broadcast(shift, src=dist.get_global_rank(group, 0),
                       group=group)
        n = _rows(x) * _group_size(group)
        stats = split_fwd_stats_reference if plain else split_fwd_stats
        apply = split_fwd_apply_reference if plain else split_fwd_apply
        sums = _all_reduce(stats(x, shift).contiguous(), group)
        y, mean, var = apply(x, gamma, beta, sums, shift, n, eps)
        ctx.save_for_backward(x, gamma, mean, var)
        ctx.eps, ctx.group, ctx.plain, ctx.n = eps, group, plain, n
        return y, mean, var

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy, dmean, dvar):
        x, gamma, mean, var = ctx.saved_tensors
        dy = dy.contiguous()
        stats = split_bwd_stats_reference if ctx.plain else split_bwd_stats
        apply = split_bwd_apply_reference if ctx.plain else split_bwd_apply
        local = stats(x, mean, var, dy, ctx.eps)
        sums = _all_reduce(torch.cat([local, dmean.float()[None],
                                      dvar.float()[None]]).contiguous(),
                           ctx.group)
        dx = apply(x, gamma, mean, var, dy, sums, ctx.n, ctx.eps)
        return dx, local[1].clone(), local[0].clone(), None, None, None


def bn_train_split(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   eps: float, group: Any, plain: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Training batch norm over the global batch that ``group``'s ranks
    hold in equal local parts ``x``: ``(y, mean, var)`` with the global
    moments, differentiable (dx through the global sums; dgamma and dbeta
    the local rows' share).  On the card the split entries of
    ``csrc/fused_bn.cu``; ``plain`` takes their plain versions on any
    device."""
    return _SplitBatchNorm.apply(x, gamma, beta, float(eps), group,
                                 bool(plain))


def reset_launches() -> None:
    """Set every launch count of this module to 0."""
    with _count_lock:
        bn_train_fwd.launches = bn_train_bwd.launches = 0
        for name in SPLIT_PASSES:
            globals()[name].launches = 0
        for name in SPLIT_KERNEL_LAUNCHES:
            SPLIT_KERNEL_LAUNCHES[name] = 0
        for name in KERNEL_LAUNCHES:
            KERNEL_LAUNCHES[name] = 0


__all__ = ["SPLIT_KERNEL_LAUNCHES", "SPLIT_PASSES", "bn_train_split", "split_bwd_apply",
           "split_bwd_stats", "split_fwd_apply", "split_fwd_stats",
           "split_launches",
           "bn_train", "bn_train_plain", "bn_train_fwd", "bn_train_bwd",
           "bn_train_fwd_reference", "bn_train_bwd_reference",
           "KERNEL_LAUNCHES", "Plan", "plan", "reset_launches"]
