# Port of analytics_zoo_tpu/serving/protocol.py: a copy with its imports pointed at
# the port, which imports nothing of the JAX package.
"""Wire protocol for ClusterServing: length-prefixed msgpack-free frames.

Frame = 4-byte big-endian length + payload.  Payload = header json (utf-8)
+ b"\\0" + raw ndarray bytes.  Replaces the reference's
ndarray→Arrow→base64→Redis encoding (pyzoo/zoo/serving/client.py) with
zero-copy binary framing:

- **send**: ``encode_parts`` + ``send_frame_parts`` scatter-gather the
  frame as ``[len+header, memoryview(tensor)]`` through ``sendmsg`` — the
  tensor payload is never copied into a joined bytes object (the old
  ``ascontiguousarray(arr).tobytes()`` + two concatenations cost three
  copies per reply).  ``encode`` still returns one ``bytes`` for callers
  that must hold the full frame (the resilient client records it for
  idempotent resend).
- **recv**: ``recv_frame`` reads into a single preallocated buffer via
  ``recv_into`` (the old chunk list + ``b"".join`` copied every payload
  once more), and ``decode`` wraps the tensor bytes in a ``memoryview``
  so ``np.frombuffer`` aliases the receive buffer instead of copying.

``MAX_FRAME_BYTES`` guards the 4-byte length against corrupt or
malicious values: without it a bad length triggers an up-to-4 GiB
allocation attempt before any validation.  Oversized frames raise
``ValueError`` — both the server's connection loop and the client's
reader treat that as a dead connection.
"""

from __future__ import annotations

import json
import socket
import struct
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np

from analytics_zoo_tpu_torch.core import faults as faults_lib

#: ``serving.slow_wire`` (core/faults.py): seeded per-frame send/recv
#: jitter.  Armed with a ``delay``, every firing hit sleeps inside the
#: fault registry BEFORE the syscall — a degraded-network storm
#: (core/chaos.py) slows both directions of every connection without
#: touching sockets.  Disarmed (always, in production) a hit costs one
#: lock + two dict ops, the same budget as the other per-request seams.

#: Upper bound on a single frame's payload (default 256 MiB).  A length
#: prefix above this is treated as protocol corruption, not a request.
#: Module-level so deployments (and tests) can raise/lower it.
MAX_FRAME_BYTES = 256 * 1024 * 1024

#: Header ``type`` for a health probe.  A ping frame is header-only
#: (``{"uuid": ..., "type": PING}``, no tensor); the server answers it
#: from the ASSEMBLY stage with ``{"uuid": ..., "pong": True,
#: "state": ..., "queue_depth": ...}`` — so a wedged-but-connected
#: backend (assembly stalled, queue jammed) fails the probe by timeout
#: even though its socket still accepts writes.
PING = "ping"

#: Header ``type`` for a telemetry scrape.  A metrics frame is
#: header-only; the server answers it straight from the connection loop
#: with ``{"uuid": ..., "metrics": registry.snapshot()}`` — the TCP
#: analog of the HTTP frontend's ``GET /metrics``, so a router (or the
#: frontend's ``/metrics?scope=cluster``) can fold every replica's
#: registry into one cluster view without each replica running HTTP.
METRICS = "metrics"


def encode_ping(uid: str) -> bytes:
    """A health-probe frame for ``uid`` (header-only, no tensor)."""
    return encode({"uuid": uid, "type": PING})


def encode_metrics_request(uid: str) -> bytes:
    """A telemetry-scrape frame for ``uid`` (header-only, no tensor)."""
    return encode({"uuid": uid, "type": METRICS})


#: Request classes the per-class admission gate understands.  Requests
#: carrying any other value (or none) are treated as unclassified —
#: admitted exactly like pre-klass traffic.
KLASSES = ("interactive", "batch")


def request_header(uid: str, trace: Optional[str] = None,
                   span: Optional[str] = None,
                   model: Optional[str] = None,
                   version: Optional[str] = None,
                   deadline_ms: Optional[int] = None,
                   klass: Optional[str] = None) -> Dict[str, Any]:
    """The standard request header.  All fields beyond ``uuid`` are
    OPTIONAL and absent fields are simply omitted from the wire, so a
    pre-multi-model client's frames are unchanged byte for byte:

    - ``trace``: end-to-end trace id (core/trace.py);
    - ``span``: the SENDER's span id for this attempt — the parent the
      server-side stage spans attach under, so ``trace.tree`` can hang
      a hedged request's two server executions beneath their respective
      client attempt spans;
    - ``model``: route to this named model in a multi-model server
      (``ClusterServing(models=...)``); absent = the server's default
      model;
    - ``version``: pin a specific loaded version of that model (canary
      reads across a hot swap); absent = the model's ACTIVE version at
      batch-assembly time;
    - ``deadline_ms``: relative latency budget, re-anchored server-side;
    - ``klass``: request class for per-class admission
      (``"interactive"`` | ``"batch"``): under pressure the server sheds
      batch-class requests first so interactive traffic holds its SLO.
      Absent = unclassified (admitted like pre-klass traffic).
    """
    header: Dict[str, Any] = {"uuid": uid}
    if trace is not None:
        header["trace"] = trace
    if span is not None:
        header["span"] = span
    if model is not None:
        header["model"] = str(model)
    if version is not None:
        header["version"] = str(version)
    if deadline_ms is not None:
        header["deadline_ms"] = int(deadline_ms)
    if klass is not None:
        header["klass"] = str(klass)
    return header

Frame = Union[bytes, bytearray]


def encode(header: Dict[str, Any], arr: Optional[np.ndarray] = None
           ) -> bytes:
    """One contiguous frame (length prefix included).  Costs one copy of
    the tensor payload — use ``encode_parts`` on hot reply paths where
    the frame does not need to outlive the send."""
    return b"".join(encode_parts(header, arr))


def encode_parts(header: Dict[str, Any],
                 arr: Optional[np.ndarray] = None) -> List[memoryview]:
    """The frame as scatter-gather buffers ``[len+header+\\0, tensor]``
    with NO copy of the tensor payload (a ``memoryview`` over the
    array's buffer; ``ascontiguousarray`` is a no-op for the contiguous
    arrays the serving path produces).  Pass to ``send_frame_parts``."""
    if arr is not None:
        a = np.ascontiguousarray(arr)
        header = dict(header, dtype=str(a.dtype), shape=list(a.shape))
        body = memoryview(a).cast("B")
    else:
        body = memoryview(b"")
    head = json.dumps(header).encode() + b"\0"
    parts = [memoryview(struct.pack(">I", len(head) + len(body)) + head)]
    if len(body):
        parts.append(body)
    return parts


def send_frame(sock: socket.socket, data: Frame) -> None:
    faults_lib.get_registry().fire("serving.slow_wire")
    sock.sendall(data)


def send_frame_parts(sock: socket.socket, parts: List[memoryview]) -> None:
    """Scatter-gather send via ``sendmsg`` (one syscall, no join copy),
    handling partial sends; falls back to ``sendall`` of the joined
    frame where ``sendmsg`` is unavailable."""
    faults_lib.get_registry().fire("serving.slow_wire")
    if not hasattr(sock, "sendmsg"):  # pragma: no cover - exotic platform
        sock.sendall(b"".join(parts))
        return
    bufs = [p if isinstance(p, memoryview) else memoryview(p)
            for p in parts]
    while bufs:
        sent = sock.sendmsg(bufs)
        # a partial scatter-gather send is legal: drop fully-sent
        # buffers, slice the straddled one, and go again
        while bufs and sent >= len(bufs[0]):
            sent -= len(bufs[0])
            bufs.pop(0)
        if bufs and sent:
            bufs[0] = bufs[0][sent:]


def decode(payload: Frame) -> Tuple[Dict[str, Any], Optional[np.ndarray]]:
    sep = payload.index(b"\0")
    mv = memoryview(payload)
    header = json.loads(bytes(mv[:sep]).decode())
    arr = None
    if "dtype" in header:
        # zero-copy: the array aliases the receive buffer (recv_frame
        # allocates one buffer per frame, so aliasing is safe)
        arr = np.frombuffer(mv[sep + 1:], dtype=header["dtype"]).reshape(
            header["shape"])
    return header, arr


def recv_frame(sock: socket.socket) -> Optional[bytearray]:
    """One frame's payload into a single preallocated buffer (None on
    clean EOF).  Raises ValueError when the length prefix exceeds
    ``MAX_FRAME_BYTES`` — validate before allocating, so a corrupt or
    malicious 4-byte length cannot demand gigabytes."""
    hdr = bytearray(4)
    if not _recv_into_exact(sock, memoryview(hdr)):
        return None
    # jitter lands between the length prefix and the payload read: the
    # frame is committed on the wire, so an armed delay stretches the
    # receiver's assembly (the slow-consumer half of a degraded network)
    # without ever tearing a frame
    faults_lib.get_registry().fire("serving.slow_wire")
    (length,) = struct.unpack(">I", hdr)
    if length > MAX_FRAME_BYTES:
        raise ValueError(
            f"frame length {length} exceeds MAX_FRAME_BYTES "
            f"({MAX_FRAME_BYTES}): corrupt or malicious peer")
    buf = bytearray(length)
    if not _recv_into_exact(sock, memoryview(buf)):
        return None
    return buf


def _recv_into_exact(sock: socket.socket, mv: memoryview) -> bool:
    got, n = 0, len(mv)
    while got < n:
        k = sock.recv_into(mv[got:])
        if not k:
            return False
        got += k
    return True
