# Port of analytics_zoo_tpu/parallel/sharding.py: the rules, the trim to
# the mesh, the fallback counter and warning, and infer_param_specs, over
# the port's PartitionSpec and Mesh (core/context.py) instead of JAX's.
"""Parameter-sharding rules: path patterns -> ``PartitionSpec``.

The rules are the JAX package's, one for one, and stay the single source
of truth for where each leaf lives: ``infer_param_specs`` gives the spec
of every leaf of a ``{"params"}`` tree in the JAX layout (conv kernels
HWIO), trimmed to the mesh exactly as the JAX package trims it (axes the
mesh lacks or has at size 1 dropped silently; a dim the axis does not
divide, or a spec longer than the tensor, falls back to replication with
a once-per-site warning and a ``train.sharding_fallbacks`` count).

A spec places a leaf over the mesh of process ranks: the piece of rank
``r`` along a dim sharded over axes ``A`` is block ``index(A)`` of
``size(A)`` equal blocks (:func:`piece_index`), the piece a ``DTensor``
with the spec's :func:`placements` holds.  The Estimator keeps each
sharded leaf's piece (its optimizer state and master copy) on the rank
that owns it, and the checkpoint writes the pieces (``core/checkpoint.py``).

Conventions the default rules rely on: Dense kernels ``[in, out]``,
attention projections ``wq/wk/wv`` ``[d_model, heads * d_head]`` and
``wo`` ``[heads * d_head, d_model]``, embedding tables ``[vocab, d]``.
"""

from __future__ import annotations

import logging
import re
import threading
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..core import metrics as _telemetry

logger = logging.getLogger("analytics_zoo_tpu_torch")

_FALLBACK_WARNED: set = set()
_FALLBACK_LOCK = threading.Lock()


class PartitionSpec(tuple):
    """``jax.sharding.PartitionSpec``'s value: one entry a dim, each
    ``None`` (replicated), an axis name or a tuple of axis names.  Equal,
    as a tuple, to the JAX spec of the same placement."""

    def __new__(cls, *entries: Any) -> "PartitionSpec":
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


def _reset_fallback_warnings() -> None:
    """Test hook: re-arm the one-time replication-fallback warnings."""
    with _FALLBACK_LOCK:
        _FALLBACK_WARNED.clear()


def _note_fallback(path: Optional[str], dim: int, axes: Tuple[str, ...],
                   shape: Sequence[int], size: int, reason: str) -> None:
    """Count every fallback (``train.sharding_fallbacks``), warn once per
    (path, dim, axes)."""
    _telemetry.get_registry().counter("train.sharding_fallbacks").inc()
    key = (path, dim, axes)
    with _FALLBACK_LOCK:
        if key in _FALLBACK_WARNED:
            return
        _FALLBACK_WARNED.add(key)
    logger.warning(
        "sharding rule for %s: dim %d of shape %s %s mesh axes %s "
        "(size %d) - falling back to replication for that dim",
        path or "<unnamed param>", dim, tuple(shape), reason, axes, size)


def _entry_axes(entry: Any) -> Tuple[str, ...]:
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,) if entry else ()


def _trim_spec_to_mesh(spec: Sequence[Any], mesh: Any, shape: Sequence[int],
                       path: Optional[str] = None) -> PartitionSpec:
    """Drop axis names the mesh lacks (or has at size 1) silently; a dim
    the kept axes do not divide, or past the tensor's rank, falls back to
    replication with a warning and a count."""
    out: List[Any] = []
    for i, entry in enumerate(spec):
        kept = tuple(n for n in _entry_axes(entry)
                     if n in mesh.axis_names and mesh.shape[n] > 1)
        size = 1
        for n in kept:
            size *= mesh.shape[n]
        if size <= 1:
            out.append(None)
        elif i >= len(shape):
            _note_fallback(path, i, kept, shape, size, "has no such dim for")
            out.append(None)
        elif shape[i] % size != 0:
            _note_fallback(path, i, kept, shape, size, "does not divide")
            out.append(None)
        else:
            out.append(kept if len(kept) > 1 else kept[0])
    while out and out[-1] is None:  # canonical: P(None, None) == P()
        out.pop()
    return PartitionSpec(*out)


@dataclass
class ShardingRule:
    """The first regex (searched in a ``/``-joined parameter path) that
    matches wins; ``spec`` may name axes the mesh lacks: they are
    dropped."""
    pattern: str
    spec: Any

    def matches(self, path: str) -> bool:
        return re.search(self.pattern, path) is not None


def tensor_parallel_rules(axis: str = "model",
                          fsdp_axis: Optional[str] = None
                          ) -> List[ShardingRule]:
    """Megatron-style: column-parallel QKV / FFN-in, row-parallel
    attention-out / FFN-out, vocab-sharded embeddings; ``fsdp_axis``
    shards the other dim of each over the fsdp axis."""
    f = fsdp_axis
    return [
        ShardingRule(r"moe.*wi$", P("expert", f, axis)),
        ShardingRule(r"moe.*wo$", P("expert", axis, f)),
        ShardingRule(r"(wq|wk|wv)$", P(f, axis)),
        ShardingRule(r"wo$", P(axis, f)),
        ShardingRule(r"ffn1/kernel$", P(f, axis)),
        ShardingRule(r"ffn2/kernel$", P(axis, f)),
        ShardingRule(r"embeddings$", P(axis, f)),
    ]


def fsdp_rules(axis: str = "fsdp") -> List[ShardingRule]:
    """ZeRO-3-style: every large kernel's first dim over ``fsdp``."""
    return [ShardingRule(r"kernel$|embeddings$|(wq|wk|wv|wo)$",
                         P(axis, None))]


def spec_for(path: str, shape: Sequence[int],
             rules: Sequence[ShardingRule], mesh: Any) -> PartitionSpec:
    """The trimmed spec of one leaf (``P()`` where no rule matches)."""
    for rule in rules:
        if rule.matches(path):
            return _trim_spec_to_mesh(rule.spec, mesh, shape, path=path)
    return PartitionSpec()


def infer_param_specs(params: Any, rules: Sequence[ShardingRule],
                      mesh: Any) -> Any:
    """A ``PartitionSpec`` tree for a params tree (nested dicts of arrays
    or tensors, JAX layout); unmatched leaves are replicated."""
    def walk(node: Any, prefix: str) -> Any:
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}/{k}" if prefix else str(k))
                    for k, v in node.items()}
        return spec_for(prefix, tuple(node.shape), rules, mesh)

    return walk(params, "")


def spec_axes(spec: Sequence[Any]) -> Tuple[str, ...]:
    """Every axis a spec names, in order."""
    return tuple(a for e in spec for a in _entry_axes(e))


def piece_index(spec: Sequence[Any], shape: Sequence[int], mesh: Any,
                coords: Optional[Dict[str, int]] = None) -> Tuple[slice, ...]:
    """The slices of the global leaf that the rank at ``coords`` (default
    this rank's) holds under ``spec``."""
    coords = mesh.coords if coords is None else coords
    out = []
    for i, dim in enumerate(shape):
        axes = _entry_axes(spec[i]) if i < len(spec) else ()
        size, at = 1, 0
        for a in axes:
            at = at * mesh.shape[a] + coords[a]
            size *= mesh.shape[a]
        block = dim // size
        out.append(slice(at * block, (at + 1) * block))
    return tuple(out)


def placements(spec: Sequence[Any], mesh: Any) -> List[Any]:
    """``spec`` as ``torch.distributed.tensor`` placements, one a mesh axis
    in the mesh's order: ``Shard(d)`` where the axis shards dim ``d``,
    ``Replicate()`` where it shards none (the same pieces ``piece_index``
    gives, for a ``DTensor`` over a ``DeviceMesh`` of these axes; a dim
    sharded over several axes is split over them in the spec's order, as
    ``Shard`` placements of consecutive mesh dims are)."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {a: d for d, e in enumerate(spec) for a in _entry_axes(e)}
    return [Shard(by_axis[a]) if a in by_axis else Replicate()
            for a in mesh.axis_names]


def index_key(idx: Sequence[slice], shape: Sequence[int]) -> str:
    """The JAX checkpoint's canonical key of a piece: ``"s0:e0,s1:e1"``
    (``":"`` for a scalar)."""
    parts = []
    for sl, dim in zip(idx, shape):
        start = 0 if sl.start is None else int(sl.start)
        stop = dim if sl.stop is None else int(sl.stop)
        parts.append(f"{start}:{stop}")
    return ",".join(parts) if parts else ":"


def owners(spec: Sequence[Any], shape: Sequence[int], mesh: Any
           ) -> Dict[str, int]:
    """``{piece key: owner rank}``: each distinct piece written by the
    lowest rank holding it (the JAX package's ownership rule)."""
    import numpy as np
    out: Dict[str, int] = {}
    for r in range(mesh.size):
        c = dict(zip(mesh.axis_names, (int(v) for v in np.unravel_index(
            r, mesh.devices.shape))))
        key = index_key(piece_index(spec, shape, mesh, c), shape)
        if key not in out:
            out[key] = r
    return out


__all__ = ["P", "PartitionSpec", "ShardingRule", "fsdp_rules",
           "index_key", "infer_param_specs", "owners", "piece_index",
           "placements",
           "spec_axes", "spec_for", "tensor_parallel_rules"]
