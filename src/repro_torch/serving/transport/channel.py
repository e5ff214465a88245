"""Channel layer: one seam for the transports that carry whole RPC
messages over one stream socket.

A channel owns one stream socket and moves whole RPC *messages*; the
codec and framing layers above it never see which transport carries the
tensor bytes. :class:`StreamChannel` is the portable socketpair (or
TCP) path: control bytes and tensor segments travel on the socket as
one multi-part frame via a ``sendmsg`` gather, so each array is copied
at most once in userspace (``ascontiguousarray`` for strided sources;
the kernel's copy into the socket buffer is the floor).

A shared-memory transport subclasses :class:`_FramedChannel` through its
two seams: ``_make_sink`` (a sink that places tensors past the socket
and reports their bytes as ``arena_bytes``) and ``_arena_resolver``
(maps an ``("arena", …)`` locator back to an array).

Every channel counts ``bytes_copied`` (tensor bytes that crossed the
socket or were memcpy'd) vs ``bytes_zero_copy`` (tensor bytes that
crossed via an arena mapping; always 0 on a :class:`StreamChannel`),
surfaced through ``stats()`` so the transport win is observable.

Channels are not internally locked: a client serialises sends under
its send lock and pumps under its recv lock; a worker is
single-threaded. ``pump`` keeps partial frames in a persistent buffer
across slices and paces with ``select`` — never ``sock.settimeout``,
which is socket-wide and would spuriously fail concurrent sends when a
busy worker lets the pipe fill (a blocked send is backpressure, not
death).

Frames and counters are the JAX package's
(``repro.serving.transport.channel``): either package's channel
decodes the other's.
"""

from __future__ import annotations

import select
import socket
import time
from typing import Optional

from repro_torch.serving.transport import codec, framing

_LEN = framing.LEN_SIZE


class _FramedChannel:
    """Shared machinery: frame assembly/gather on send, persistent
    partial-frame buffer + select pacing on receive."""

    transport = "?"

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.bytes_sent = 0          # socket bytes out (incl. headers)
        self.bytes_recv = 0          # socket bytes in
        self.bytes_copied = 0        # tensor bytes that were memcpy'd
        self.bytes_zero_copy = 0     # tensor bytes mapped, not copied
        self._rx = bytearray()       # partial-frame receive buffer

    # subclasses override the two transport-specific seams
    def _make_sink(self):
        return None, None            # (sink, seg_sink)

    def _arena_resolver(self, kind, dtype_str, shape, fields):
        raise ValueError(f"no resolver for {kind!r} ndarray locator on "
                         f"a {self.transport} channel")

    # -- send --------------------------------------------------------------
    def send(self, obj) -> int:
        sink, seg_sink = self._make_sink()
        control = codec.encode_control(obj, sink)
        bufs = framing.frame_buffers(control, seg_sink)
        n = framing.sendmsg_gather(self.sock, bufs)
        self.bytes_sent += n
        self.bytes_copied += (0 if seg_sink is None else seg_sink.nbytes)
        # an arena sink reports the tensor bytes it mapped past the
        # socket; a segment sink has none
        self.bytes_zero_copy += getattr(sink, "arena_bytes", 0)
        return n

    # -- receive -----------------------------------------------------------
    def pump(self, slice_timeout: float):
        """Complete at most one frame within ``slice_timeout``; returns
        the decoded message or None. Partially received bytes persist in
        the buffer across slices — a timeout mid-frame must never
        discard them, or the length-prefixed stream desynchronises and
        a healthy worker looks dead."""
        deadline = time.monotonic() + slice_timeout
        while True:
            if len(self._rx) >= _LEN:
                (n,) = framing._LEN.unpack(bytes(self._rx[:_LEN]))
                if len(self._rx) >= _LEN + n:
                    payload = bytes(self._rx[_LEN:_LEN + n])
                    del self._rx[:_LEN + n]
                    return framing.parse_payload(payload,
                                                 self._arena_resolver)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            readable, _, _ = select.select([self.sock], [], [],
                                           remaining)
            if not readable:
                return None
            chunk = self.sock.recv(1 << 20)   # readable: won't block
            if not chunk:
                raise ConnectionError("RPC peer closed the connection")
            self._rx += chunk
            self.bytes_recv += len(chunk)

    def recv(self, timeout: Optional[float] = None):
        """Blocking single-message receive (a worker's serve loop and a
        spawn handshake); ``timeout`` is the whole-message deadline."""
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            if deadline is None:
                slice_s = 1.0
            else:
                slice_s = deadline - time.monotonic()
                if slice_s <= 0:
                    raise socket.timeout("RPC recv deadline exceeded")
                slice_s = min(slice_s, 1.0)
            msg = self.pump(slice_s)
            if msg is not None:
                return msg

    def stats(self) -> dict:
        return {"transport": self.transport,
                "bytes_sent": self.bytes_sent,
                "bytes_recv": self.bytes_recv,
                "bytes_copied": self.bytes_copied,
                "bytes_zero_copy": self.bytes_zero_copy}

    def close(self):
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass
            self.sock = None


class StreamChannel(_FramedChannel):
    """Socketpair stream transport (portable fallback): tensors ride as
    in-frame segments gathered into the ``sendmsg`` iovec."""

    transport = "socket"

    def _make_sink(self):
        seg = framing.SegmentSink()
        return seg, seg
