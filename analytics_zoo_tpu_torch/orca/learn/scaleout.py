"""The Estimator over several processes: strategies, the gradient
all-reduce, ``grad_compression`` and the sharded train state.

Port of the multi-device half of ``analytics_zoo_tpu/orca/learn/
estimator.py``.  There one process drives a mesh and GSPMD places every
leaf by the sharding rules; here one process is one rank of the context's
:class:`~analytics_zoo_tpu_torch.core.context.Mesh`, and :class:`Scaleout`
does what GSPMD does for the train step:

- **the batch**: each rank takes its batch shard's rows of every global
  batch (``data.feed.shard_batch``, over the ``data`` and ``fsdp`` axes);
  ranks that differ only along ``model`` take the same rows;
- **batch norm**: every ``BatchNormalization`` gets the batch axes' group,
  so training normalizes by the global batch's moments (the split form of
  ``ops/fused_bn.py``), as the JAX package's batch norm over a sharded
  batch does;
- **gradients**: after the backward each gradient is all-reduced over the
  batch group and divided by its size (the mean over the global batch);
  the loss is the ranks' mean;
- **sharded leaves** (``sharding="fsdp"``, ``"tp"``, ``"tp+fsdp"``,
  ``"2d"`` or a rule list): the rules of ``parallel/sharding.py`` give each
  dense parameter's spec over the mesh (JAX layout: conv kernels HWIO).
  A sharded parameter's optimizer state and master copy live only as this
  rank's piece: the optimizer steps the piece with its piece of the
  reduced gradient, and the pieces are all-gathered into the parameter
  the forward reads.  An optimizer whose update needs whole-leaf norms
  (gradient clipping, LARS, LAMB) keeps its state whole on every rank,
  with a warning;
- **tensor-parallel compute**: over a ``model`` axis, every
  ``TransformerLayer`` whose ``wq``/``wk``/``wv``/``ffn1`` the rules shard
  by columns and whose ``wo``/``ffn2`` by rows over ``model`` computes
  only this rank's block (its heads, through the flash kernel on local
  tensors; its ffn columns), the partial outputs summed over the model
  group (``parallel/tensor_parallel.py``); the gradients of what a block
  computes but the optimizer keeps whole (``ffn1``'s bias; every block
  weight under a whole-leaf optimizer) are summed over the model group.
  Other layers compute whole on every model rank (their leaves still
  stored as pieces);
- **``grad_compression``** ``"bf16"``/``"int8"``: each rank's gradient goes
  through ``parallel.util.allreduce_compressed`` (int8 codes and f32
  scales on the wire, error-feedback residuals kept per rank); batch norm
  is then per shard, as under the JAX step's per-shard vmap, and the
  running statistics are merged after the step as ``_merge_shard_leaf``
  merges them (the mean of float buffers, shard 0's of the others).
  ``"none"`` meters the wire and keeps the uncompressed step bit for bit.

A step with a collective in it runs eagerly: gloo's collectives cannot be
captured in a CUDA graph, and no capture of NCCL collectives is attempted
yet (ROADMAP Queue 1 item 18).  The estimator logs that and records it as
``capture_refused``.  At world size 1 nothing here communicates: every
strategy is the one-process step, captured as before.
"""

from __future__ import annotations

import logging
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ...convert import _is_conv_kernel, _to_jax_layout
from ...data.feed import BATCH_AXES, batch_axis_size
from ...parallel import sharding as sharding_lib
from ...parallel import util as util_lib
from . import optimizers as opt_lib

logger = logging.getLogger("analytics_zoo_tpu_torch")


def resolve_sharding_rules(sharding: Any) -> Optional[List[Any]]:
    """``"dp"`` -> None; ``"tp"``/``"fsdp"``/``"tp+fsdp"``/``"2d"`` -> the
    rule presets (``"2d"`` is the tensor-parallel rules: its data half is
    the batch sharding every strategy gets); a list as it is (the JAX
    package's ``_resolve_sharding_rules``)."""
    if sharding is None or sharding == "dp":
        return None
    if isinstance(sharding, str):
        rules: List[Any] = []
        parts = set(sharding.replace(" ", "").split("+"))
        unknown = parts - {"tp", "fsdp", "dp", "2d"}
        if unknown:
            raise ValueError(f"unknown sharding strategy {sharding!r}")
        if parts & {"tp", "2d"}:
            rules += sharding_lib.tensor_parallel_rules(
                fsdp_axis="fsdp" if "fsdp" in parts else None)
        if "fsdp" in parts:
            rules += sharding_lib.fsdp_rules()
        return rules or None
    return list(sharding)


def warn_strategy_mesh_mismatch(sharding: Any, mesh: Any) -> None:
    """One warning when a named strategy asks for mesh axes the mesh does
    not have (the rules trim to replication and training proceeds
    data-parallel)."""
    if not isinstance(sharding, str):
        return
    parts = set(sharding.replace(" ", "").split("+"))

    def size(ax: str) -> int:
        return mesh.shape.get(ax, 1)

    missing = []
    if parts & {"tp", "2d"} and size("model") <= 1:
        missing.append("model")
    if "fsdp" in parts and size("fsdp") <= 1:
        missing.append("fsdp")
    if "2d" in parts and size("data") <= 1:
        missing.append("data")
    if missing:
        hint = {"fsdp": 0} if "fsdp" in missing else {"data": 0}
        if "model" in missing:
            hint["model"] = 2
        logger.warning(
            "sharding=%r but the mesh has no sized %s axis (mesh %s): "
            "affected rules trim to replication and training proceeds "
            "data-parallel.  Build the mesh with init_orca_context("
            "mesh_shape=%r) to get the requested layout (needs a device "
            "count the fixed axes divide).", sharding, "/".join(missing),
            dict(mesh.shape), hint)


def one_process(model: nn.Module) -> None:
    """Take any process group an earlier estimator handed ``model``'s
    layers (batch norm's ``group``, the transformer blocks' ``tp``) back:
    the model computes whole, in this process alone."""
    for m in model.modules():
        if getattr(m, "tp", None) is not None:
            m.tp = None
        if hasattr(m, "train_fn") and getattr(m, "group", None) is not None:
            m.group = None


def _innermost(opt: Any) -> Any:
    while hasattr(opt, "inner"):
        if isinstance(opt, opt_lib.Clipped):
            return opt
        opt = opt.inner
    return opt


def _jax_view(name: str, p: torch.Tensor) -> torch.Tensor:
    """``p`` in the JAX layout (a view: conv kernels HWIO)."""
    path = tuple(name.split("."))
    return _to_jax_layout(p) if _is_conv_kernel(path, p) else p


class ShardedLeaf(opt_lib.Tied):
    """A leaf of the train state held as this rank's piece: ``read()``
    gives the checkpoint's ``core.checkpoint.Sharded`` record, ``write``
    copies this rank's piece of a whole array in (how ``load_optax`` and
    ``load`` fill it)."""

    def __init__(self, local: torch.Tensor, shape: Sequence[int],
                 spec: Any, mesh: Any):
        super().__init__([local], local.dtype)
        self.local, self.shape, self.spec, self.mesh = \
            local, tuple(shape), spec, mesh

    def read(self) -> Any:
        from ...core.checkpoint import Sharded
        own = sharding_lib.index_key(
            sharding_lib.piece_index(self.spec, self.shape, self.mesh),
            self.shape)
        return Sharded(self.shape, self.local.dtype,
                       {own: self.local.detach()},
                       sharding_lib.owners(self.spec, self.shape, self.mesh),
                       spec=self.spec)

    def write(self, value: Any) -> None:
        src = torch.as_tensor(value) if not isinstance(value, torch.Tensor) \
            else value
        if tuple(src.shape) != self.shape:
            raise ValueError(f"a sharded leaf of shape {self.shape} cannot "
                             f"take an array of shape {tuple(src.shape)}")
        idx = sharding_lib.piece_index(self.spec, self.shape, self.mesh)
        self.local.copy_(src[idx].to(self.local.dtype))


class Scaleout:
    """The multi-process half of one estimator (see the module's doc)."""

    def __init__(self, est: Any, mesh: Any, sharding: Any,
                 grad_compression: Optional[str]):
        self.mesh = mesh
        self.comp = grad_compression
        self.compress_wire = grad_compression in ("bf16", "int8")
        self.rules = resolve_sharding_rules(sharding)
        warn_strategy_mesh_mismatch(sharding, mesh)
        self.batch_size = batch_axis_size(mesh)
        self.batch_group = mesh.group(BATCH_AXES)
        self.batch_index = mesh.index(BATCH_AXES)
        names = est._dense_names
        params = est._params
        self.names = names
        self.specs = []
        for name, p in zip(names, params):
            view = _jax_view(name, p)
            self.specs.append(
                sharding_lib.spec_for(name.replace(".", "/"),
                                      tuple(view.shape), self.rules, mesh)
                if self.rules else sharding_lib.P())
        self.sharded = [bool(sharding_lib.spec_axes(s)) for s in self.specs]
        inner = _innermost(est.optimizer)
        self.shard_opt = any(self.sharded) and not isinstance(
            inner, (opt_lib.Clipped, opt_lib.Layerwise))
        if any(self.sharded) and not self.shard_opt:
            logger.warning(
                "the optimizer %s needs whole-leaf norms: its state stays "
                "whole on every rank; the checkpoint still writes each "
                "rank's pieces", type(inner).__name__)
        # the optimizer's parameters: a sharded leaf's piece (in the JAX
        # layout, contiguous), every other parameter itself
        self.opt_params: List[torch.Tensor] = []
        for name, p, spec, sh in zip(names, params, self.specs,
                                     self.sharded):
            if sh and self.shard_opt:
                view = _jax_view(name, p)
                idx = sharding_lib.piece_index(spec, view.shape, mesh)
                self.opt_params.append(view[idx].detach().clone())
            else:
                self.opt_params.append(p)
        self.groups = [mesh.group(sharding_lib.spec_axes(s))
                       if sh else None
                       for s, sh in zip(self.specs, self.sharded)]
        self.ef: Optional[List[torch.Tensor]] = None
        if grad_compression == "int8":
            self.ef = [torch.zeros_like(p, dtype=torch.float32)
                       for p in params]
        self.model_group, self.tp_layers, self.model_reduced = \
            self._tensor_parallel(est.model, mesh)
        self.bn_layers = [m for m in est.model.modules()
                          if hasattr(m, "group") and hasattr(m, "train_fn")]
        bn_group = None if self.compress_wire else self.batch_group
        for m in self.bn_layers:
            m.group = bn_group

    def _tensor_parallel(self, model: nn.Module, mesh: Any):
        """Hand every TransformerLayer whose block weights the specs shard
        over ``model`` (whole heads a rank) its ``ModelParallel``; returns
        (the model group or None, the layers' names, the indices of the
        parameters whose gradients are summed over the model group)."""
        size = mesh.shape.get("model", 1)
        if not self.rules or size <= 1:
            return None, [], set()
        from ...nn.attention import TransformerLayer
        from ...parallel.tensor_parallel import ModelParallel
        group = mesh.group(("model",))
        mp = ModelParallel(group, size, mesh.index(("model",)))
        where = {n: i for i, n in enumerate(self.names)}
        layers, reduced = [], set()
        for prefix, m in model.named_modules():
            if not isinstance(m, TransformerLayer):
                continue
            p = f"{prefix}." if prefix else ""
            dims = {f"{p}mha.wq": 1, f"{p}mha.wk": 1, f"{p}mha.wv": 1,
                    f"{p}mha.wo": 0, f"{p}ffn1.kernel": 1,
                    f"{p}ffn2.kernel": 0}
            bias = f"{p}ffn1.bias"

            def on_model(name: str, dim: int) -> bool:
                spec = self.specs[where[name]]
                return dim < len(spec) and "model" in \
                    sharding_lib._entry_axes(spec[dim])

            if (any(n not in where for n in dims) or bias not in where
                    or m.mha.num_heads % size or m.ffn1.units % size
                    or not all(on_model(n, d) for n, d in dims.items())):
                continue
            m.tp = m.mha.tp = mp
            layers.append(prefix)
            reduced.add(where[bias])
            if not self.shard_opt:
                reduced |= {where[n] for n in dims}
        return (group if layers else None), layers, reduced

    def agree(self, flag: torch.Tensor) -> torch.Tensor:
        """A boolean every rank of the model group agrees on (all of them
        true), where the layers compute blocks: each rank's gradients then
        hold only its blocks."""
        if self.model_group is None:
            return flag
        import torch.distributed as dist
        t = flag.to(torch.int32).reshape(1).clone()
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.model_group)
        return t[0].bool()

    # -- the step -------------------------------------------------------------

    @property
    def communicates(self) -> bool:
        """Whether the step runs a collective (then it runs eagerly)."""
        return (self.batch_group is not None or self.model_group is not None
                or any(g is not None for g in self.groups))

    def reduce(self, loss: torch.Tensor, grads: List[torch.Tensor]
               ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The global mean loss and this rank's gradients reduced to the
        global batch's (through the compressed wire where configured)."""
        import torch.distributed as dist
        g, s = self.batch_group, self.batch_size
        if self.model_reduced:
            # what a rank's blocks computed, summed over the model group
            grads = list(grads)
            for i in self.model_reduced:
                t = grads[i].contiguous().clone()
                dist.all_reduce(t, group=self.model_group)
                grads[i] = t
        if self.compress_wire:
            # one shard quantizes its own gradient too, as the JAX step
            # does at S = 1
            grads_f, new_ef = util_lib.allreduce_compressed(
                grads, self.comp, g, s, ef=self.ef)
            if new_ef is not None:
                for r, n in zip(self.ef, new_ef):
                    r.copy_(n)  # in place: a captured step holds them
            grads = [r.to(p.dtype) for r, p in zip(grads_f, grads)]
        if g is None:
            return loss, grads
        loss = loss.detach().float().clone()
        dist.all_reduce(loss, group=g)
        loss = loss / s
        if not self.compress_wire:
            out = []
            for t in grads:
                t = t.contiguous().clone()
                dist.all_reduce(t, group=g)
                out.append(t.div_(s))
            grads = out
        return loss, grads

    def merge_statistics(self) -> None:
        """Under compression: merge the ranks' batch-norm running
        statistics (the mean of float buffers, batch shard 0's of the
        others), as the JAX step merges its per-shard states."""
        import torch.distributed as dist
        g = self.batch_group
        if g is None or not self.compress_wire:
            return
        first = dist.get_global_rank(g, 0)
        for m in self.bn_layers:
            for b in m.buffers():
                if b.is_floating_point():
                    dist.all_reduce(b, group=g)
                    b.div_(self.batch_size)
                else:
                    dist.broadcast(b, src=first, group=g)

    def opt_grads(self, grads: List[torch.Tensor]) -> List[torch.Tensor]:
        """The gradients of the optimizer's parameters: a sharded leaf's
        piece of its reduced gradient, the others as they are."""
        if not self.shard_opt:
            return grads
        out = []
        for name, g, spec, sh, p in zip(self.names, grads, self.specs,
                                        self.sharded, self.opt_params):
            if sh:
                view = _jax_view(name, g)
                idx = sharding_lib.piece_index(spec, view.shape, self.mesh)
                out.append(view[idx].contiguous())
            else:
                out.append(g)
        return out

    def gather(self, params: List[torch.Tensor]) -> None:
        """Every rank's updated pieces into the whole parameters the next
        forward computes with."""
        import torch.distributed as dist
        if not self.shard_opt:
            return
        for name, p, piece, spec, sh, g in zip(
                self.names, params, self.opt_params, self.specs,
                self.sharded, self.groups):
            if not sh:
                continue
            view = _jax_view(name, p)
            ranks = self.mesh.ranks(sharding_lib.spec_axes(spec))
            if g is None:
                parts = [piece]
            else:
                parts = [torch.empty_like(piece) for _ in ranks]
                dist.all_gather(parts, piece.contiguous(), group=g)
            for r, part in zip(ranks, parts):
                coords = self._coords(r)
                idx = sharding_lib.piece_index(spec, view.shape, self.mesh,
                                               coords)
                view[idx].copy_(part)

    def _coords(self, rank: int) -> Dict[str, int]:
        import numpy as np
        return dict(zip(self.mesh.axis_names, (int(c) for c in np.unravel_index(
            rank, self.mesh.devices.shape))))

    def reload_pieces(self, params: List[torch.Tensor]) -> None:
        """Refill the optimizer's pieces from the whole parameters (after a
        load wrote them)."""
        if not self.shard_opt:
            return
        with torch.no_grad():
            for name, p, piece, spec, sh in zip(self.names, params,
                                                self.opt_params, self.specs,
                                                self.sharded):
                if sh:
                    view = _jax_view(name, p)
                    idx = sharding_lib.piece_index(spec, view.shape,
                                                   self.mesh)
                    piece.copy_(view[idx])

    # -- the state a checkpoint writes -------------------------------------------

    def opt_layout(self, ts: List[Any]) -> List[Any]:
        """The optimizer's per-parameter state tensors ``ts`` (one a
        parameter, shaped like the optimizer's parameter) as the leaves a
        checkpoint writes: a piece as a :class:`ShardedLeaf` of the whole
        leaf's JAX-layout shape, the rest as they are."""
        if not self.shard_opt:
            return ts
        out = []
        for name, t, spec, sh, p in zip(self.names, ts, self.specs,
                                        self.sharded, self.opt_params):
            if sh and isinstance(t, torch.Tensor) and t.shape == p.shape:
                shape = self._whole_shape(name)
                out.append(ShardedLeaf(t, shape, spec, self.mesh))
            else:
                out.append(t)
        return out

    def _whole_shape(self, name: str) -> Tuple[int, ...]:
        i = self.names.index(name)
        spec, piece = self.specs[i], self.opt_params[i]
        shape = []
        for d, n in enumerate(piece.shape):
            axes = sharding_lib._entry_axes(spec[d]) if d < len(spec) else ()
            shape.append(n * self.mesh.axis_size(axes))
        return tuple(shape)

    def ef_leaves(self) -> List[Any]:
        """The int8 residuals as the checkpoint's ``[S, ...]`` leaves (JAX
        layout), one slice a batch shard: each rank's slice its own."""
        out = []
        spec = util_lib.batch_shard_spec(self.mesh, 1)
        for name, r in zip(self.names, self.ef or []):
            local = _jax_view(name, r).contiguous()[None]
            shape = (self.batch_size,) + tuple(local.shape[1:])
            full_spec = sharding_lib.P(*(tuple(spec) + (None,) * (
                len(shape) - 1))) if len(spec) else sharding_lib.P()
            out.append(ShardedLeaf(local, shape, full_spec, self.mesh))
        return out

    def save_tree(self, tree: Dict[str, Any]) -> None:
        """Make ``tree`` (the estimator's checkpoint tree) the layout this
        mesh writes, in place: over several processes each rule-sharded
        parameter a ``Sharded`` record of this rank's piece; the int8
        residuals under ``"ef"`` (``[S, ...]`` a parameter, JAX layout)."""
        multi = self.mesh.size > 1
        if multi:
            for name, spec, sh in zip(self.names, self.specs, self.sharded):
                if not sh:
                    continue
                node, *rest = _path(tree["params"], name)
                leaf = node[rest[0]]
                idx = sharding_lib.piece_index(spec, leaf.shape, self.mesh)
                node[rest[0]] = ShardedLeaf(leaf[idx], leaf.shape, spec,
                                            self.mesh).read()
        if self.ef is not None:
            ef: Dict[str, Any] = {}
            for name, leaf in zip(self.names, self.ef_leaves()):
                *path, last = name.split(".")
                node = ef
                for k in path:
                    node = node.setdefault(k, {})
                node[last] = leaf.read() if multi else leaf.local
            tree["ef"] = ef

    def load_tree(self, tree: Dict[str, Any]) -> None:
        """This rank's residuals from a loaded tree (zeros where it has
        none: a checkpoint of an uncompressed run)."""
        if self.ef is None:
            return
        saved = tree.get("ef")
        if saved is None:
            with torch.no_grad():
                for r in self.ef:
                    r.zero_()
            return
        leaves = []
        for name in self.names:
            node, *rest = _path(saved, name)
            leaves.append(node[rest[0]])
        self.load_ef(leaves)

    def load_ef(self, saved: Sequence[Any]) -> None:
        """This rank's residuals from a checkpoint's ``[S, ...]`` leaves."""
        if self.ef is None:
            return
        with torch.no_grad():
            for name, r, leaf in zip(self.names, self.ef, saved):
                arr = torch.as_tensor(leaf)
                if arr.shape[0] != self.batch_size:
                    raise ValueError(
                        f"the checkpoint's residuals have {arr.shape[0]} "
                        f"shards, the mesh {self.batch_size}")
                _jax_view(name, r).copy_(arr[self.batch_index])


def _path(tree: Dict[str, Any], name: str) -> Tuple[Any, str]:
    """``(node, key)`` of a ``.``-joined name's leaf in a nested dict."""
    *path, last = name.split(".")
    node = tree
    for k in path:
        node = node[k]
    return node, last


__all__ = ["Scaleout", "ShardedLeaf", "one_process",
           "resolve_sharding_rules",
           "warn_strategy_mesh_mismatch"]
