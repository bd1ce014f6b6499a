"""Ring attention: sequence parallelism over the mesh's ``seq`` axis (port
of ``analytics_zoo_tpu/parallel/ring_attention.py``).

The JAX package shards the sequence over the ``seq`` devices inside
``shard_map``: each device attends its query chunk to the key/value chunk
it holds, with an online softmax in f32 einsums, while the K/V chunks
rotate around the ring (``ppermute`` rank -> rank + 1).  Here one rank of
the ``seq`` group is one process, and :class:`_RingAttention` is one
``torch.autograd.Function`` over the group:

- **forward**: each held K/V chunk goes through the flash forward
  (``ops.flash_attention_fwd``: the CUDA kernel on the card, its plain
  version on the CPU), which returns the chunk's output and lse; the
  chunks' outputs merge by their lse in f32.  The next chunk's exchange
  (``comm.Exchange``: the send to rank + 1 and the receive from rank - 1
  posted together) is posted before the chunk's kernel, so the transfer
  overlaps the compute.  Under ``causal`` this rank's own chunk runs
  causal, a chunk of a lower rank unmasked, and a chunk of a higher rank
  (all masked) is skipped: its lse would be -inf;
- **backward**: with the global ``out`` and ``lse`` kept from the
  forward, each held chunk goes through the flash backward
  (``ops.flash_attention_bwd``), which gives this chunk's share of dQ and
  the chunk's dK and dV from this rank's queries.  The dK/dV
  accumulators (f32) travel around the ring with their K/V and are home
  after ``size`` hops.

:func:`ring_self_attention` takes the global ``[B, T, H, D]`` tensors, which
are replicated over the ``seq`` group outside attention (the batch is
sharded over ``data``/``fsdp`` only): each rank slices its ``T/n`` chunk
of q, k and v, runs the ring, and all-gathers the outputs; in the
backward the gathered output's gradient is sliced to this rank's chunk,
and the inputs' chunk gradients are gathered back over the group (the sum
of each rank's zero-padded chunk gradient).  So every rank ends the
backward with the same whole gradients, and the Estimator's reduce over
the batch axes does not count the ``seq`` ranks as batch shards.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch

from . import comm


def _seq_group(mesh: Any, axis: str) -> Tuple[Any, int, int]:
    """(group, size, this rank's index) of ``mesh``'s ``axis``; (None, 1,
    0) where the mesh lacks it or has it at size 1."""
    if mesh is None or axis not in mesh.axis_names \
            or mesh.shape[axis] == 1:
        return None, 1, 0
    return mesh.group((axis,)), mesh.shape[axis], mesh.index((axis,))


def _kernels(plain: bool):
    from ..ops.flash_attention import (flash_attention_bwd,
                                       flash_attention_bwd_reference,
                                       flash_attention_fwd,
                                       flash_attention_fwd_reference)
    if plain:
        return flash_attention_fwd_reference, flash_attention_bwd_reference
    return flash_attention_fwd, flash_attention_bwd


def _visible(owner: int, my: int, causal: bool) -> Optional[bool]:
    """Whether this rank's queries see chunk ``owner``: None (skip: all
    masked), else the kernel's ``causal`` flag."""
    if not causal or owner < my:
        return False
    if owner == my:
        return True
    return None


class _RingAttention(torch.autograd.Function):
    """Ring attention over ``[BH, T/n, D]`` chunks (see the module doc)."""

    @staticmethod
    def forward(ctx, q3, k3, v3, group, size, my, causal, plain):
        fwd, _ = _kernels(plain)
        nxt, prv = (my + 1) % size, (my - 1) % size
        kv = torch.stack([k3, v3])
        outs, lses = [], []
        for step in range(size):
            ex = comm.Exchange(kv, nxt, prv, group) if step < size - 1 \
                else None
            flag = _visible((my - step) % size, my, causal)
            if flag is not None:
                o, lse = fwd(q3, kv[0], kv[1], flag)
                outs.append(o)
                lses.append(lse)
            if ex is not None:
                kv = ex.wait()
        if len(outs) == 1:
            out, lse = outs[0], lses[0]
        else:
            lse = torch.logsumexp(torch.stack(lses), dim=0)
            acc = None
            for o, l_j in zip(outs, lses):
                part = torch.exp(l_j - lse)[..., None] * o.float()
                acc = part if acc is None else acc + part
            out = acc.to(q3.dtype)
        ctx.save_for_backward(q3, k3, v3, out, lse)
        ctx.ring = (group, size, my, causal, plain)
        return out

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dout):
        q3, k3, v3, out, lse = ctx.saved_tensors
        group, size, my, causal, plain = ctx.ring
        _, bwd = _kernels(plain)
        nxt, prv = (my + 1) % size, (my - 1) % size
        dout = dout.contiguous()
        kv = torch.stack([k3, v3])
        dq = torch.zeros(q3.shape, dtype=torch.float32, device=q3.device)
        # the held chunk's dK/dV accumulator travels with it
        acc = torch.zeros((2,) + tuple(k3.shape), dtype=torch.float32,
                          device=k3.device)
        for step in range(size):
            ex = comm.Exchange(kv, nxt, prv, group) if step < size - 1 \
                else None
            flag = _visible((my - step) % size, my, causal)
            if flag is not None:
                dq_j, dk_j, dv_j = bwd(q3, kv[0], kv[1], out, lse, dout,
                                       flag)
                dq += dq_j.float()
                acc[0] += dk_j.float()
                acc[1] += dv_j.float()
            if size > 1:
                acc = comm.Exchange(acc, nxt, prv, group).wait()
            if ex is not None:
                kv = ex.wait()
        return (dq.to(q3.dtype), acc[0].to(k3.dtype), acc[1].to(v3.dtype),
                None, None, None, None, None)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis_name: str = "seq", causal: bool = False,
                   mesh: Any = None, plain: bool = False) -> torch.Tensor:
    """Attention over a ring, from this rank's chunks: q, k, v ``[B,
    T_local, H, D]``, the chunk at global positions ``index * T_local``
    on of the ``axis_name`` group of ``mesh`` (default the context's; a
    ring of one without that axis).  Returns ``[B, T_local, H, D]``;
    softmax scale ``1/sqrt(D)``.  ``plain`` runs the kernels' plain
    PyTorch versions, also on the card (what the kernels are held
    against)."""
    if mesh is None:
        from ..core.context import current_mesh
        mesh = current_mesh()
    group, size, my = _seq_group(mesh, axis_name)
    b, t, h, d = q.shape

    def flat(x: torch.Tensor) -> torch.Tensor:
        return x.permute(0, 2, 1, 3).reshape(b * h, x.shape[1], d) \
            .contiguous()

    out = _RingAttention.apply(flat(q), flat(k), flat(v), group, size, my,
                               causal, plain)
    return out.reshape(b, h, t, d).permute(0, 2, 1, 3)


class _SeqSlice(torch.autograd.Function):
    """This rank's chunk of dim 1 of a tensor replicated over the group;
    the backward gathers the chunks' gradients back into the whole
    tensor's (each rank's zero-padded chunk gradient, summed)."""

    @staticmethod
    def forward(ctx, x, group, size, my):
        ctx.ring = (group, size)
        t = x.shape[1] // size
        return x[:, my * t:(my + 1) * t].contiguous()

    @staticmethod
    def backward(ctx, g):
        group, size = ctx.ring
        return (torch.cat(comm.all_gather(g, group, size), dim=1),
                None, None, None)


class _SeqGather(torch.autograd.Function):
    """The chunks of the group concatenated along dim 1; the backward
    keeps this rank's chunk of the gradient (the same on every rank: what
    follows is replicated)."""

    @staticmethod
    def forward(ctx, x, group, size, my):
        ctx.ring = (my, x.shape[1])
        return torch.cat(comm.all_gather(x, group, size), dim=1)

    @staticmethod
    def backward(ctx, g):
        my, t = ctx.ring
        return g[:, my * t:(my + 1) * t].contiguous(), None, None, None


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        mesh: Any = None, causal: bool = False,
                        seq_axis: str = "seq",
                        plain: bool = False) -> torch.Tensor:
    """Self-attention of the global ``[B, T, H, D]`` q, k, v (replicated
    over the ``seq`` group) as a ring over that group; plain attention
    (``nn.attention.dot_product_attention``, with the causal mask) where
    the mesh (default the context's) has no ``seq`` axis or one of size
    1.  ``T`` must divide over the group."""
    if mesh is None:
        from ..core.context import current_mesh
        mesh = current_mesh()
    group, size, my = _seq_group(mesh, seq_axis)
    if group is None:
        from ..nn.attention import causal_mask, dot_product_attention
        mask = causal_mask(q.shape[1], device=q.device) if causal else None
        return dot_product_attention(q, k, v, mask)
    t = q.shape[1]
    if t % size or k.shape[1] != t:
        raise ValueError(f"sequence length {t} (keys {k.shape[1]}) does "
                         f"not split into {size} equal chunks over the "
                         f"{seq_axis!r} axis")
    chunks = [_SeqSlice.apply(x, group, size, my) for x in (q, k, v)]
    out = ring_attention(*chunks, axis_name=seq_axis, causal=causal,
                         mesh=mesh, plain=plain)
    return _SeqGather.apply(out, group, size, my)


__all__ = ["ring_attention", "ring_self_attention"]
