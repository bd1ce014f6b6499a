"""Sharded embedding engine: deduped gather and sparse row updates (port of
``analytics_zoo_tpu/parallel/embedding.py``).

A ``ShardedEmbedding`` table registers under the leaf ``"sharded_embeddings"``
(``SPARSE_LEAF``).  Its lookup (``dedup_lookup``) makes the batch's ids
unique before it touches the table, so one row is read per distinct id,
then spreads the rows back over the batch; multi-hot ids reduce through the
``"sum"``/``"mean"`` combiners, and negative ids are masked out.

Sparse gradients.  Under the Estimator's sparse train path
(``inject_taps``), each lookup gathers its unique rows from the table
without autograd and makes them a leaf that requires grad, the port's
counterpart of the JAX package's zero "tap" on those rows: the Estimator
differentiates the loss over the dense parameters and these rows, and adds
``-embedding_lr`` times each row gradient into the table at the unique ids.
No ``[rows, dim]`` gradient of a table is ever made, and no optimizer state
shadows a table.

Shapes are static, so the lookup runs inside a CUDA graph capture:
``static_unique`` is ``jnp.unique(flat, size=, fill_value=0,
return_inverse=True)`` (values, inverse and order) built from a sort, a
first-of-run flag, a cumulative sum and scatters into fixed buffers, with no
host synchronisation.  The spread back over the batch is ``F.embedding``
over the unique rows, whose backward is deterministic on the card (it runs
under ``torch.use_deterministic_algorithms``), so a captured step gives the
eager step's bits.

In one process, row sharding (``embedding_row_rules``) keeps every table
whole on its device.  Over several processes (:func:`shard_tables`, which
the Estimator calls before it moves the model to its device) each rank
keeps its block of rows of every table, as the rules place them over the
sized axes, and no rank holds a whole table.  A lookup keeps the static
shapes: each rank's unique ids are gathered over the table's group, each
owner gathers the rows it holds for every rank (zeros for ids it does not
own) and sends them back (``all_to_all``), and the rows' gradients are
gathered to the owners, who add ``-embedding_lr`` times their own ids'
rows (:func:`apply_row_update`).  A table that the rules leave whole on
every rank of several batch shards is looked up locally, and its row
gradients are gathered over the batch group the same way.  The row
gradients are the local batch's; the update scales them by one over the
batch shards (and over the ranks of the group that share a batch shard),
so the step is the global batch's, as the JAX package's.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List, NamedTuple, Optional, \
    Sequence, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..core import metrics as metrics_lib
from ..nn import initializers
from .sharding import P, ShardingRule

#: The parameter leaf every ShardedEmbedding table registers under: the
#: marker the Estimator's sparse train path and the row rule key on.
SPARSE_LEAF = "sharded_embeddings"

_COMBINERS = (None, "sum", "mean")


def embedding_row_rules(axes: Sequence[str] = ("data", "fsdp", "model")
                        ) -> List[ShardingRule]:
    """Row-shard every ShardedEmbedding table over all the mesh's axes
    (dimension 0 over ``axes``).  On one card the table stays whole."""
    return [ShardingRule(SPARSE_LEAF + "$", P(tuple(axes)))]


def is_row_rules(sharding: Any) -> bool:
    """True for a list of rules that only row-shard ShardedEmbedding tables
    (what ``embedding_row_rules`` returns, for any axes)."""
    return isinstance(sharding, (list, tuple)) and bool(sharding) and all(
        isinstance(r, ShardingRule) and r.pattern == SPARSE_LEAF + "$"
        and len(r.spec) == 1 for r in sharding)


# -- the per-thread sparse context --------------------------------------------

@dataclass
class RowShard:
    """A table over a process group: ``serve`` (its rows split, block
    ``index`` of ``size``: global rows ``[offset, offset + block)`` on this
    rank) or not (whole on every rank; only the row gradients travel, over
    the batch group).  ``rows`` is the whole table's row count, ``spec``
    its placement (the checkpoint's), ``scale`` the row gradients' factor
    (one over the batch shards times the group's ranks a batch shard)."""
    group: Any
    size: int
    index: int
    offset: int
    block: int
    rows: int
    spec: Any
    scale: float
    serve: bool


class Tap(NamedTuple):
    """One lookup's application under ``inject_taps``: the table it read,
    its unique ids (``[size]``, padded with 0), its gathered unique rows
    (``[size, dim]``, a leaf that requires grad) and which slots hold a
    looked-up id (``[size]`` bool: the padding is False, so a touched-row
    mask marks no row for it); over several processes the table's
    ``RowShard`` and, for a served table, every rank's unique ids
    (``[size of group, size]``)."""
    table: nn.Parameter
    uniq: torch.Tensor
    rows: torch.Tensor
    valid: Optional[torch.Tensor] = None
    shard: Optional[RowShard] = None
    uniq_all: Optional[torch.Tensor] = None


class _SparseCtx(threading.local):
    """``taps`` is None (plain autograd: eval, predict, serving, a user's
    own loop) or the list the current ``inject_taps`` collects into."""

    def __init__(self) -> None:
        self.taps: Optional[List[Tap]] = None


_CTX = _SparseCtx()


@contextmanager
def inject_taps() -> Iterator[List[Tap]]:
    """Grad-pass context: every lookup in it gathers its unique rows as a
    leaf that requires grad and appends its ``Tap``, in application order
    (a table looked up twice gives two taps)."""
    prev = _CTX.taps
    _CTX.taps = []
    try:
        yield _CTX.taps
    finally:
        _CTX.taps = prev


# -- params-tree split/merge --------------------------------------------------

def is_sparse_path(path: str) -> bool:
    return path == SPARSE_LEAF or path.endswith("/" + SPARSE_LEAF)


def split_sparse(params: Any) -> Tuple[Any, Dict[str, Any]]:
    """Partition a params tree (nested dicts) into (dense tree, ``{path:
    table}``), the dense tree keeping its nesting minus the table leaves."""
    tables: Dict[str, Any] = {}

    def walk(node: Any, prefix: Tuple[str, ...]) -> Any:
        if not isinstance(node, dict):
            return node
        out = {}
        for k, v in node.items():
            p = prefix + (str(k),)
            if isinstance(v, dict):
                out[k] = walk(v, p)
            elif str(k) == SPARSE_LEAF:
                tables["/".join(p)] = v
            else:
                out[k] = v
        return out

    return walk(params, ()), tables


def merge_sparse(dense: Any, tables: Dict[str, Any]) -> Any:
    """Inverse of :func:`split_sparse`."""
    def copy(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: copy(v) for k, v in node.items()}
        return node

    out = copy(dense)
    for path, leaf in tables.items():
        node = out
        *parents, leaf_name = path.split("/")
        for part in parents:
            node = node.setdefault(part, {})
        node[leaf_name] = leaf
    return out


def sparse_paths(params: Any) -> Tuple[str, ...]:
    """The ShardedEmbedding table paths present in a params tree."""
    return tuple(split_sparse(params)[1])


def sparse_parameters(model: nn.Module) -> Dict[str, nn.Parameter]:
    """``model``'s ShardedEmbedding tables by ``/``-joined path."""
    return {name.replace(".", "/"): p
            for name, p in model.named_parameters()
            if is_sparse_path(name.replace(".", "/"))}


# -- the lookup ---------------------------------------------------------------

def static_unique(flat: torch.Tensor, size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jnp.unique(flat, size=size, fill_value=0, return_inverse=True)``
    from capturable ops: ``uniq`` ``[size]``, the sorted distinct values
    padded with 0 or cut at ``size``, and ``inv`` ``[N]``, each element's
    slot (``size`` or more for a value cut off)."""
    vals, perm = torch.sort(flat, stable=True)
    first = torch.ones_like(vals, dtype=torch.bool)
    first[1:] = vals[1:] != vals[:-1]
    slot = torch.cumsum(first, 0) - 1
    uniq = torch.zeros(size + 1, dtype=flat.dtype, device=flat.device)
    uniq.scatter_(0, slot.clamp(max=size), vals)  # slot size: a cut value
    inv = torch.empty_like(slot).scatter_(0, perm, slot)
    return uniq[:size], inv


def _served_rows(table: torch.Tensor, uniq_all: torch.Tensor,
                 shard: RowShard) -> torch.Tensor:
    """The rows of every rank's unique ids (``uniq_all`` ``[n, size]``)
    that this rank holds, zeros elsewhere, sent to their requesters;
    returns this rank's ``[size, dim]`` rows summed over the owners (one
    owner an id)."""
    own = (uniq_all >= shard.offset) & (uniq_all < shard.offset
                                        + shard.block)
    local = torch.where(own, uniq_all - shard.offset, 0)
    served = table.index_select(0, local.reshape(-1)).reshape(
        uniq_all.shape + (table.shape[-1],)) * own[..., None]
    from . import comm
    return comm.all_to_all(served, shard.group).sum(0)


def apply_row_update(tap: Tap, g: torch.Tensor, lr: float) -> None:
    """``table -= lr x`` the row gradient ``g`` (``[size, dim]``) of one
    lookup, at its unique ids: in place on this process's table, or over
    the table's group, where every rank's ids and gradients are gathered
    and each rank adds those of the rows it holds, scaled by
    ``shard.scale``.  No ``[rows, dim]`` gradient is made."""
    table, shard = tap.table, tap.shard
    if shard is None:
        table.index_add_(0, tap.uniq, g.to(table.dtype), alpha=-lr)
        return
    from . import comm
    ids_all = tap.uniq_all if tap.uniq_all is not None else torch.stack(
        comm.all_gather(tap.uniq, shard.group, shard.size))
    g_all = torch.stack(comm.all_gather(g, shard.group, shard.size))
    own = (ids_all >= shard.offset) & (ids_all < shard.offset + shard.block)
    idx = torch.where(own, ids_all - shard.offset, 0).reshape(-1)
    upd = (g_all * own[..., None]).reshape(-1, g.shape[-1])
    table.index_add_(0, idx, upd.to(table.dtype), alpha=-lr * shard.scale)


def dedup_lookup(table: torch.Tensor, ids: torch.Tensor,
                 combiner: Optional[str] = None,
                 max_unique: Optional[int] = None,
                 shard: Optional[RowShard] = None) -> torch.Tensor:
    """Dedup-before-gather lookup.  ``ids``: any int shape; negative ids
    are masked (a zero vector, a zero weight in the combiners).  Without
    ``combiner`` returns ``ids.shape + (dim,)``; with ``"sum"``/``"mean"``
    the trailing ids axis is the multi-hot axis and reduces away.
    ``max_unique`` caps the unique buffer (default: the flat batch size);
    ids past the cap come back as NaN rows, as in the reference.  With a
    serving ``shard`` ``table`` is this rank's block, and the rows come
    from their owners (collective: every rank of the group looks up
    together); their gradient reaches the table only through the
    Estimator's sparse path (``inject_taps``)."""
    if combiner not in _COMBINERS:
        raise ValueError(f"combiner must be one of {_COMBINERS}, "
                         f"got {combiner!r}")
    dim = table.shape[-1]
    if combiner is not None and ids.dim() < 1:
        raise ValueError("combiners need a trailing multi-hot axis")
    mask = ids >= 0
    flat = torch.where(mask, ids, 0).reshape(-1).long()
    size = int(max_unique) if max_unique else int(flat.numel())
    uniq, inv = static_unique(flat, size)
    taps = _CTX.taps
    uniq_all = None
    if shard is not None and shard.serve:
        from . import comm
        uniq_all = torch.stack(comm.all_gather(uniq, shard.group,
                                               shard.size))
        rows = _served_rows(table.detach(), uniq_all, shard)
    if taps is not None:
        if uniq_all is None:
            rows = table.detach().index_select(0, uniq)
        rows = rows.requires_grad_(True)
        # the distinct values fill the first slots; the rest is padding
        distinct = torch.zeros(size + 1, dtype=torch.bool,
                               device=uniq.device)
        distinct.index_fill_(0, inv.clamp(max=size), True)
        taps.append(Tap(table, uniq, rows, distinct[:size], shard,
                        uniq_all))
    elif uniq_all is None:
        rows = table.index_select(0, uniq)
    # a slot at or past ``size`` reads a NaN row (the reference's
    # ``jnp.take`` fill), whose gradient is dropped
    spare = torch.full((1, dim), float("nan"), dtype=rows.dtype,
                       device=rows.device)
    gathered = F.embedding(inv.clamp(max=size),
                           torch.cat([rows, spare]))  # [N, dim]
    w = mask.reshape(-1).to(table.dtype)
    out = gathered * w[:, None]
    if combiner is None:
        return out.reshape(ids.shape + (dim,))
    hot = ids.shape[-1]
    out = out.reshape(-1, hot, dim).sum(1)
    if combiner == "mean":
        cnt = w.reshape(-1, hot).sum(1)
        out = out / torch.clamp(cnt, min=1.0)[:, None]
    return out.reshape(ids.shape[:-1] + (dim,))


class ShardedEmbedding(nn.Module):
    """``nn.Embedding``'s call shape (ids in, vectors out) over a table
    registered as ``sharded_embeddings``: deduped gather, multi-hot
    combiners and the sparse-gradient protocol."""

    def __init__(self, input_dim: int, output_dim: int,
                 combiner: Optional[str] = None,
                 max_unique: Optional[int] = None,
                 embeddings_init: Any = "normal"):
        super().__init__()
        if combiner not in _COMBINERS:
            raise ValueError(f"combiner must be one of {_COMBINERS}, "
                             f"got {combiner!r}")
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.combiner = combiner
        self.max_unique = max_unique
        self.embeddings_init = initializers.get(embeddings_init)
        self.sharded_embeddings = nn.Parameter(
            torch.empty(input_dim, output_dim))
        self.shard: Optional[RowShard] = None  # set by shard_tables
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        self.embeddings_init(self.sharded_embeddings, generator)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return dedup_lookup(self.sharded_embeddings, ids,
                            combiner=self.combiner,
                            max_unique=self.max_unique, shard=self.shard)


def shard_tables(model: nn.Module, mesh: Any, sharding: Any
                 ) -> Dict[str, RowShard]:
    """Place ``model``'s ShardedEmbedding tables over the processes of
    ``mesh``, in place: under row rules (``embedding_row_rules``) each
    table keeps only this rank's block of rows (its parameter's data
    replaced) and looks up over its group; a table left whole on several
    batch shards gets the batch group for its row gradients.  Returns
    ``{table path: RowShard}`` of the tables that travel (none in one
    process).  The row axes must cover the mesh's sized batch axes, or a
    batch shard's gradients would miss rows' owners."""
    from ..data.feed import BATCH_AXES, batch_axis_size
    from .sharding import spec_axes, spec_for
    out: Dict[str, RowShard] = {}
    if mesh is None or mesh.size <= 1:
        return out
    rules = list(sharding) if is_row_rules(sharding) else None
    n_batch = batch_axis_size(mesh)
    batch_sized = {a for a in BATCH_AXES if mesh.shape.get(a, 1) > 1}
    for name, m in model.named_modules():
        if not isinstance(m, ShardedEmbedding):
            continue
        path = (name.replace(".", "/") + "/" if name else "") + SPARSE_LEAF
        table = m.sharded_embeddings
        if m.shard is not None and m.shard.serve:
            # an earlier estimator's cut: the table already holds its rows
            out[path] = m.shard
            continue
        rows = int(table.shape[0])
        spec = spec_for(path, tuple(table.shape), rules, mesh) if rules \
            else P()
        axes = tuple(a for a in spec_axes(spec) if mesh.shape.get(a, 1) > 1)
        if axes:
            if not batch_sized <= set(axes):
                raise ValueError(
                    f"the rows of {path} are sharded over {axes}, which "
                    f"do not cover the mesh's batch axes "
                    f"{sorted(batch_sized)}: shard the rows over every "
                    "batch axis (embedding_row_rules() does)")
            from .sharding import piece_index
            size = mesh.axis_size(axes)
            sl = piece_index(spec, tuple(table.shape), mesh)[0]
            dup = mesh.axis_size([a for a in axes if a not in BATCH_AXES])
            shard = RowShard(mesh.group(axes), size, mesh.index(axes),
                             int(sl.start), rows // size, rows, spec,
                             1.0 / (n_batch * dup), True)
            with torch.no_grad():
                table.data = table.data[sl].clone()
        elif n_batch > 1:
            shard = RowShard(mesh.group(BATCH_AXES), n_batch,
                             mesh.index(BATCH_AXES), 0, rows, rows, spec,
                             1.0 / n_batch, False)
        else:
            continue
        m.shard = shard
        out[path] = shard
    return out


# -- host-side gather accounting ----------------------------------------------

def lookup_stats(ids: Any, dim: int, itemsize: int = 4,
                 metrics: Optional[metrics_lib.MetricsRegistry] = None
                 ) -> Tuple[int, int]:
    """Host-side dedup accounting for one lookup batch: bumps the
    ``embed.gather_rows`` / ``embed.gather_rows_naive`` (and the matching
    ``embed.gather_bytes`` / ``embed.gather_bytes_naive``) counters, and
    returns ``(deduped_rows, naive_rows)``."""
    flat = np.asarray(ids).reshape(-1)
    flat = flat[flat >= 0]
    deduped = int(np.unique(flat).size)
    naive = int(flat.size)
    reg = metrics or metrics_lib.get_registry()
    reg.counter("embed.gather_rows").inc(deduped)
    reg.counter("embed.gather_rows_naive").inc(naive)
    reg.counter("embed.gather_bytes").inc(deduped * dim * itemsize)
    reg.counter("embed.gather_bytes_naive").inc(naive * dim * itemsize)
    return deduped, naive


__all__ = ["RowShard", "SPARSE_LEAF", "ShardingRule", "ShardedEmbedding",
           "Tap", "apply_row_update", "dedup_lookup", "embedding_row_rules",
           "inject_taps", "is_row_rules", "is_sparse_path", "lookup_stats",
           "merge_sparse", "shard_tables", "sparse_parameters",
           "sparse_paths", "split_sparse", "static_unique"]
