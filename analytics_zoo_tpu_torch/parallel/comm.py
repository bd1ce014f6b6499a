"""The traffic of the parallel modules (ring attention, MoE, the
pipeline, the row-sharded tables) over a process group of the mesh: one
place for the neighbour exchange and the gathers.

With NCCL every call moves device tensors.  gloo's collectives on CUDA
tensors are all-reduce and broadcast only; so where a group's backend is
gloo and a tensor lies on the card, the point-to-point calls, the gathers
and the all-to-all go through host tensors: a copy to the host, the call
on the host, a copy back (``broadcast`` moves the card's tensor as it
is).  The compute stays
on the card.  ``STAGED`` counts those copies and their bytes (each
direction one copy), so that a run can print them; a failed send raises,
as any failed call does.
"""

from __future__ import annotations

from typing import Any, Dict, List

import torch

#: Host copies made for gloo on CUDA tensors: ``copies`` (to the host
#: and back each count one) and their ``bytes``.
STAGED: Dict[str, int] = {"copies": 0, "bytes": 0}


def reset_staged() -> None:
    STAGED["copies"] = STAGED["bytes"] = 0


def _staged(group: Any, t: torch.Tensor) -> bool:
    import torch.distributed as dist
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _to_host(t: torch.Tensor) -> torch.Tensor:
    STAGED["copies"] += 1
    STAGED["bytes"] += t.numel() * t.element_size()
    return t.cpu()


def _to_device(t: torch.Tensor, device: torch.device) -> torch.Tensor:
    STAGED["copies"] += 1
    STAGED["bytes"] += t.numel() * t.element_size()
    return t.to(device)


def peer(group: Any, index: int) -> int:
    """The global rank of the group's member at ``index``."""
    import torch.distributed as dist
    return dist.get_global_rank(group, index)


class Exchange:
    """One posted neighbour exchange: ``tensor`` goes to the member at
    group index ``dst`` while a tensor of its shape and dtype comes from
    ``src``, both posted together (``batch_isend_irecv``), so neither
    side waits on the other's order and the transfer overlaps what the
    caller computes before ``wait``."""

    def __init__(self, tensor: torch.Tensor, dst: int, src: int,
                 group: Any):
        import torch.distributed as dist
        self.device = tensor.device
        self.stage = _staged(group, tensor)
        send = tensor.contiguous()
        if self.stage:
            send = _to_host(send)
        self.recv = torch.empty_like(send)
        self.works = dist.batch_isend_irecv([
            dist.P2POp(dist.isend, send, peer(group, dst), group),
            dist.P2POp(dist.irecv, self.recv, peer(group, src), group)])
        self._send = send  # alive until the send completes

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        if self.stage:
            return _to_device(self.recv, self.device)
        return self.recv


class Posted:
    """Posted point-to-point calls (``isend``/``irecv``); ``wait`` ends
    them and returns the received tensors, on the device asked for."""

    def __init__(self, group: Any):
        self.group = group
        self.works: List[Any] = []
        self.keep: List[torch.Tensor] = []
        self.recvs: List[Any] = []

    def send(self, tensor: torch.Tensor, dst: int, tag: int = 0) -> None:
        import torch.distributed as dist
        t = tensor.contiguous()
        if _staged(self.group, t):
            t = _to_host(t)
        self.keep.append(t)  # alive until the send completes
        self.works.append(dist.isend(t, peer(self.group, dst),
                                     self.group, tag))

    def recv(self, like: torch.Tensor, src: int, tag: int = 0) -> None:
        import torch.distributed as dist
        stage = _staged(self.group, like)
        buf = torch.empty_like(like, device="cpu" if stage else like.device)
        self.recvs.append((buf, like.device, stage))
        self.works.append(dist.irecv(buf, peer(self.group, src),
                                     self.group, tag))

    def wait(self) -> List[torch.Tensor]:
        for w in self.works:
            w.wait()
        out = [_to_device(b, d) if stage else b
               for b, d, stage in self.recvs]
        self.works, self.keep, self.recvs = [], [], []
        return out


def send(tensor: torch.Tensor, dst: int, group: Any, tag: int = 0) -> None:
    """A blocking send to the member at group index ``dst``."""
    import torch.distributed as dist
    t = tensor.contiguous()
    if _staged(group, t):
        t = _to_host(t)
    dist.send(t, peer(group, dst), group, tag)


def recv(like: torch.Tensor, src: int, group: Any,
         tag: int = 0) -> torch.Tensor:
    """A blocking receive, from the member at group index ``src``, of a
    tensor shaped and typed as ``like``, on ``like``'s device."""
    import torch.distributed as dist
    stage = _staged(group, like)
    buf = torch.empty_like(like, device="cpu" if stage else like.device)
    dist.recv(buf, peer(group, src), group, tag)
    return _to_device(buf, like.device) if stage else buf


def all_gather(tensor: torch.Tensor, group: Any, size: int
               ) -> List[torch.Tensor]:
    """Every member's ``tensor`` (same shape), in group order."""
    import torch.distributed as dist
    t = tensor.contiguous()
    stage = _staged(group, t)
    if stage:
        t = _to_host(t)
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    if stage:
        return [_to_device(p, tensor.device) for p in parts]
    return parts


def all_to_all(tensor: torch.Tensor, group: Any) -> torch.Tensor:
    """``tensor[j]`` goes to member ``j``; returns what each member sent
    this one, stacked in group order (``all_to_all_single`` over dim
    0)."""
    import torch.distributed as dist
    t = tensor.contiguous()
    stage = _staged(group, t)
    if stage:
        t = _to_host(t)
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return _to_device(out, tensor.device) if stage else out


def broadcast(tensor: torch.Tensor, src: int, group: Any) -> torch.Tensor:
    """The member at group index ``src``'s ``tensor``, in place on every
    member (gloo takes CUDA tensors here: no staging)."""
    import torch.distributed as dist
    dist.broadcast(tensor, peer(group, src), group=group)
    return tensor


__all__ = ["Exchange", "Posted", "STAGED", "all_gather", "all_to_all",
           "broadcast", "peer", "recv", "reset_staged", "send"]
