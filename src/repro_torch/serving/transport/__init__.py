"""Layered shard transport: codec ⇄ framing ⇄ channel.

* :mod:`~repro_torch.serving.transport.errors` — the transport's error
  taxonomy (worker died vs. op failed inside a healthy worker).
* :mod:`~repro_torch.serving.transport.codec` — message values ⇄
  control bytes, ndarrays as ``(dtype, shape, locator)`` with pluggable
  sink/resolver seams (msgpack + dependency-free fallback).
* :mod:`~repro_torch.serving.transport.framing` — length-prefixed
  frames; multi-part frames gather tensor segments into a ``sendmsg``
  iovec.
* :mod:`~repro_torch.serving.transport.channel` —
  :class:`StreamChannel` (socketpair or TCP) on the shared
  :class:`_FramedChannel` machinery.
* :mod:`~repro_torch.serving.transport.client` —
  :class:`ShardWorkerClient`: spawns a shard worker process
  (``repro_torch.serving.worker``) and pipelines its RPCs over a
  :class:`StreamChannel`.

Host code on numpy arrays; every byte on the wire is the JAX package's
(``repro.serving.transport``), so processes of the two packages talk to
each other. The shared-memory ring arena and its channel and fault
injection are not part of this package yet.
"""

from repro_torch.serving.transport.channel import (StreamChannel,
                                                   _FramedChannel)
from repro_torch.serving.transport.client import ShardWorkerClient
from repro_torch.serving.transport.codec import (HAVE_MSGPACK, decode,
                                                 decode_control, encode,
                                                 encode_control)
from repro_torch.serving.transport.errors import (ArenaDead,
                                                  DeadlineExceeded,
                                                  ShardUnavailable,
                                                  ShardWorkerDied,
                                                  ShardWorkerError)
from repro_torch.serving.transport.framing import (SegmentSink,
                                                   frame_buffers,
                                                   parse_payload, recv_msg,
                                                   send_msg, sendmsg_gather)

__all__ = [
    "ArenaDead", "DeadlineExceeded", "HAVE_MSGPACK", "SegmentSink",
    "ShardUnavailable", "ShardWorkerClient", "ShardWorkerDied",
    "ShardWorkerError", "StreamChannel", "_FramedChannel", "decode",
    "decode_control", "encode", "encode_control", "frame_buffers",
    "parse_payload", "recv_msg", "send_msg", "sendmsg_gather",
]
