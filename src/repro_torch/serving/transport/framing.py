"""Framing layer: length-prefixed frames over a stream socket.

Every frame is ``[8-byte BE payload length][payload]``. Two payload
formats coexist on the same stream, distinguished by the first payload
byte:

* ``\\x00`` / ``\\x01`` — a bare control message (legacy single-part
  frame; the byte is the codec tag)
* ``\\x02`` — a multi-part frame: ``\\x02 [4-byte BE control length]
  [control bytes] [segment bytes…]``. The control message references
  arrays inside the trailing segment region via ``("seg", off, n)``
  locators, and the send path gathers the arrays' own memory into a
  ``sendmsg`` iovec — **no userspace copy, no concatenation** of
  tensor bytes on the stream path (the kernel copies once into the
  socket buffer; that is the floor for a socket).

The frames are the JAX package's (``repro.serving.transport.framing``)
byte for byte. One difference, which changes no byte on the wire:
:func:`sendmsg_gather` hands ``sendmsg`` at most :data:`IOV_MAX`
buffers a call. The JAX package passes the whole gather list to one
call, which Linux refuses (``OSError: [Errno 90] Message too long``)
past 1,024 entries: a multi-part frame of more than 1,022 segments.

The framing layer carries *control* messages; bulk tensor bytes either
ride as in-frame segments (stream channel) or bypass the socket
entirely via a shared-memory arena — see ``transport.channel``.
"""

from __future__ import annotations

import os
import socket
import struct
import time
from typing import Optional

import numpy as np

from repro_torch.serving.transport import codec

_LEN = struct.Struct(">Q")
_CTL = struct.Struct(">I")
PARTS_MAGIC = b"\x02"

LEN_SIZE = _LEN.size


# the most buffers one ``sendmsg`` call takes (1024 on Linux)
IOV_MAX = os.sysconf("SC_IOV_MAX")


class SegmentSink:
    """Collects ndarray payloads as out-of-band frame segments.

    ``put`` registers the array's (contiguous) memory as the next
    segment and returns its ``("seg", off, n)`` locator; the buffers
    are later handed straight to ``sendmsg`` — each array is copied at
    most once (``ascontiguousarray`` when the source is strided), never
    serialized or concatenated. Arrays under ``min_bytes`` are declined
    (inline encoding is cheaper than an iovec entry)."""

    __slots__ = ("bufs", "nbytes", "min_bytes")

    def __init__(self, min_bytes: int = 64):
        self.bufs: list = []
        self.nbytes = 0
        self.min_bytes = min_bytes

    def put(self, arr: np.ndarray) -> Optional[tuple]:
        if arr.nbytes < self.min_bytes:
            return None
        a = np.ascontiguousarray(arr)
        # the memoryview keeps ``a`` alive until the frame is sent
        self.bufs.append(memoryview(a).cast("B"))
        loc = ("seg", self.nbytes, a.nbytes)
        self.nbytes += a.nbytes
        return loc


def frame_buffers(control: bytes, seg_sink: Optional[SegmentSink]) \
        -> list:
    """Assemble the gather list for one frame (header + control +
    segment buffers), ready for :func:`sendmsg_gather`."""
    seg_bytes = 0 if seg_sink is None else seg_sink.nbytes
    if seg_bytes == 0:
        return [_LEN.pack(len(control)), control]
    if len(control) > 0xFFFFFFFF:
        raise ValueError("control message exceeds the 4 GiB limit")
    head = (_LEN.pack(1 + _CTL.size + len(control) + seg_bytes)
            + PARTS_MAGIC + _CTL.pack(len(control)))
    return [head, control, *seg_sink.bufs]


def sendmsg_gather(sock: socket.socket, bufs: list) -> int:
    """writev-style gather send with partial-write handling; returns
    total bytes written. Each ``sendmsg`` call takes the next
    :data:`IOV_MAX` unsent buffers at most, so a frame of any number of
    segments goes out; the bytes on the wire are those of one call over
    the whole list."""
    total = sum(len(b) for b in bufs)
    views = [b if isinstance(b, memoryview) else memoryview(b)
             for b in bufs]
    i = 0                                 # first buffer not wholly sent
    while i < len(views):
        n = sock.sendmsg(views[i:i + IOV_MAX])
        # step over fully-sent buffers, trim the partially-sent head
        while i < len(views) and n >= len(views[i]):
            n -= len(views[i])
            i += 1
        if n:
            views[i] = views[i][n:]
    return total


def parse_payload(payload, arena_resolver=None):
    """One frame's payload → decoded message.

    ``("seg", …)`` locators resolve against the frame's own segment
    region (copied out — the recv buffer is transient); any other
    locator kind is delegated to ``arena_resolver``."""
    mv = memoryview(payload)
    if bytes(mv[:1]) != PARTS_MAGIC:
        return codec.decode_control(payload, arena_resolver)
    (clen,) = _CTL.unpack(mv[1:1 + _CTL.size])
    base = 1 + _CTL.size
    control = bytes(mv[base:base + clen])
    segs = mv[base + clen:]

    def resolver(kind, d, s, fields):
        if kind == "seg":
            off, n = fields
            return np.frombuffer(segs[off:off + n],
                                 dtype=np.dtype(d)).reshape(s).copy()
        if arena_resolver is None:
            raise ValueError(f"no resolver for {kind!r} ndarray locator")
        return arena_resolver(kind, d, s, fields)

    return codec.decode_control(control, resolver)


# ---------------------------------------------------------------------------
# legacy blocking helpers (single-part frames, everything inline)
# ---------------------------------------------------------------------------

def send_msg(sock: socket.socket, obj) -> int:
    """Encode inline + length-prefix + sendall. Returns bytes written."""
    payload = codec.encode(obj)
    sock.sendall(_LEN.pack(len(payload)) + payload)
    return _LEN.size + len(payload)


def _recv_exact(sock: socket.socket, n: int,
                deadline: Optional[float]) -> bytes:
    chunks = []
    got = 0
    while got < n:
        if deadline is not None:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise socket.timeout("RPC recv deadline exceeded")
            sock.settimeout(min(remaining, 1.0))
        try:
            chunk = sock.recv(min(n - got, 1 << 20))
        except socket.timeout:
            continue                 # re-check the deadline
        if not chunk:
            raise ConnectionError("RPC peer closed the connection")
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def recv_msg(sock: socket.socket, timeout: Optional[float] = None):
    """Read one length-prefixed message; ``timeout`` is the whole-message
    deadline (None = block forever)."""
    deadline = None if timeout is None else time.monotonic() + timeout
    head = _recv_exact(sock, _LEN.size, deadline)
    (n,) = _LEN.unpack(head)
    return parse_payload(_recv_exact(sock, n, deadline))
