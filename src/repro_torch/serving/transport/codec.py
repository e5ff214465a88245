"""Codec layer: RPC message values ⇄ control bytes + ndarray locators.

Two interchangeable codecs cover the same value space (None/bool/int/
float/str/bytes/list/dict/ndarray): msgpack when available, and a
dependency-free fallback with one tag byte per value. Both are lossless
for numpy dtypes — scores travel as raw dtype bytes, which is what
makes process-group results bitwise-identical to the in-process shard
group. The leading control byte selects the codec (``\\x01`` msgpack,
``\\x00`` fallback), so a msgpack coordinator can talk to a fallback
worker and vice versa.

The bytes are the JAX package's (``repro.serving.transport.codec``) for
every value, with either codec, so a process of either package decodes
the other's messages. Tensors travel as numpy arrays: a
``torch.Tensor`` is unencodable (``TypeError``) like any other foreign
value; a sender converts with ``.cpu().numpy()``.

The layering seam is the **ndarray locator**: tensor payloads are
``(dtype, shape, locator)``, where the locator is decided by a pluggable
*sink* at encode time and resolved by a *resolver* at decode time:

* ``None``            — inline: raw bytes embedded in the control
  message (the legacy format; tiny arrays stay here, it is cheaper
  than any indirection)
* ``("seg", off, n)`` — out-of-band segment inside the same frame; the
  framing layer gathers the array's own memory into the ``sendmsg``
  iovec, so the stream path copies tensor bytes at most once
* ``("arena", gen, start, span, n)`` — a span in a shared-memory ring
  arena; neither side serializes tensor bytes, the consumer maps the
  span directly

``encode``/``decode`` (no sink) keep the legacy inline wire format for
back-compat and for control-only messages.

Length guard: every 4-byte count/length field raises before encoding a
value over 4 GiB — a silent ``struct`` wrap would desynchronise the
stream, the one corruption a length-prefixed protocol can't recover
from. Arrays dodge the limit via 8-byte raw lengths and locators.
"""

from __future__ import annotations

import json
import struct
from typing import Callable, Optional

import numpy as np

try:
    import msgpack
    HAVE_MSGPACK = True
except ImportError:                                   # pragma: no cover
    msgpack = None
    HAVE_MSGPACK = False

_ND_EXT = 42       # msgpack ExtType: inline ndarray (dtype, shape, raw)
_ND_SEG = 43       # msgpack ExtType: frame-segment locator
_ND_ARENA = 44     # msgpack ExtType: shm-arena locator

_U32_MAX = 0xFFFFFFFF

# resolver(kind, dtype_str, shape, fields) -> ndarray
NdResolver = Callable[[str, str, list, tuple], np.ndarray]


def _check_u32(n: int, what: str) -> int:
    """4-byte length-field guard (the >4 GiB header check)."""
    if n > _U32_MAX:
        raise ValueError(
            f"{what} of {n} bytes exceeds the 4 GiB RPC field limit")
    return n


def _nd_to_wire(arr: np.ndarray) -> tuple:
    a = np.ascontiguousarray(arr)
    # shape from the *original*: ascontiguousarray promotes 0-d to (1,)
    return (a.dtype.str, list(arr.shape), a.tobytes())


def _nd_from_wire(dtype_str: str, shape, raw: bytes) -> np.ndarray:
    # copy: frombuffer views are read-only and may alias the recv buffer
    return np.frombuffer(raw, dtype=np.dtype(dtype_str)) \
        .reshape(shape).copy()


def _locate(arr: np.ndarray, sink) -> Optional[tuple]:
    """Offer ``arr`` to the sink; None means "inline it"."""
    return None if sink is None else sink.put(arr)


# ---------------------------------------------------------------------------
# msgpack codec
# ---------------------------------------------------------------------------

def _msgpack_default(sink):
    def default(obj):
        if isinstance(obj, np.ndarray):
            loc = _locate(obj, sink)
            if loc is None:
                d, s, b = _nd_to_wire(obj)
                return msgpack.ExtType(_ND_EXT, msgpack.packb((d, s, b)))
            kind, fields = loc[0], list(loc[1:])
            code = _ND_SEG if kind == "seg" else _ND_ARENA
            return msgpack.ExtType(code, msgpack.packb(
                (obj.dtype.str, list(obj.shape), fields)))
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, tuple):
            return list(obj)
        raise TypeError(f"unencodable RPC value: {type(obj)!r}")
    return default


def _msgpack_ext_hook(resolver):
    def hook(code, data):
        if code == _ND_EXT:
            d, s, b = msgpack.unpackb(data)
            return _nd_from_wire(d, s, b)
        if code in (_ND_SEG, _ND_ARENA):
            d, s, fields = msgpack.unpackb(data)
            kind = "seg" if code == _ND_SEG else "arena"
            if resolver is None:
                raise ValueError(
                    f"message carries a {kind!r} ndarray locator but "
                    f"this decoder has no resolver for it")
            return resolver(kind, d, s, tuple(fields))
        return msgpack.ExtType(code, data)          # pragma: no cover
    return hook


# ---------------------------------------------------------------------------
# fallback codec (no msgpack on the host)
# ---------------------------------------------------------------------------
# One tag byte per value; ints are 8-byte signed, floats are doubles,
# containers carry a 4-byte count. Locator tags G (frame segment) and
# H (arena span) carry a json header [dtype, shape, fields], written by
# json.dumps with its default separators (other separators write other
# bytes).

def _enc_py(obj, out: list, sink=None):
    if obj is None:
        out.append(b"N")
    elif isinstance(obj, (bool, np.bool_)):
        out.append(b"T" if obj else b"F")
    elif isinstance(obj, (int, np.integer)):
        out.append(b"I" + struct.pack(">q", int(obj)))
    elif isinstance(obj, (float, np.floating)):
        out.append(b"D" + struct.pack(">d", float(obj)))
    elif isinstance(obj, str):
        raw = obj.encode()
        out.append(b"S" + struct.pack(
            ">I", _check_u32(len(raw), "str")) + raw)
    elif isinstance(obj, bytes):
        out.append(b"B" + struct.pack(
            ">I", _check_u32(len(obj), "bytes")) + obj)
    elif isinstance(obj, np.ndarray):
        loc = _locate(obj, sink)
        if loc is None:
            d, s, raw = _nd_to_wire(obj)
            head = json.dumps([d, s]).encode()
            out.append(b"A" + struct.pack(
                ">I", _check_u32(len(head), "ndarray header")) + head
                + struct.pack(">Q", len(raw)) + raw)
        else:
            kind, fields = loc[0], list(loc[1:])
            head = json.dumps([obj.dtype.str, list(obj.shape),
                               fields]).encode()
            out.append((b"G" if kind == "seg" else b"H")
                       + struct.pack(">I", _check_u32(
                           len(head), "ndarray header")) + head)
    elif isinstance(obj, (list, tuple)):
        out.append(b"L" + struct.pack(
            ">I", _check_u32(len(obj), "list")))
        for x in obj:
            _enc_py(x, out, sink)
    elif isinstance(obj, dict):
        out.append(b"M" + struct.pack(
            ">I", _check_u32(len(obj), "dict")))
        for k, v in obj.items():
            _enc_py(str(k), out, sink)
            _enc_py(v, out, sink)
    else:
        raise TypeError(f"unencodable RPC value: {type(obj)!r}")


def _dec_py(buf: memoryview, pos: int, resolver=None):
    tag = bytes(buf[pos:pos + 1])
    pos += 1
    if tag == b"N":
        return None, pos
    if tag == b"T":
        return True, pos
    if tag == b"F":
        return False, pos
    if tag == b"I":
        return struct.unpack(">q", buf[pos:pos + 8])[0], pos + 8
    if tag == b"D":
        return struct.unpack(">d", buf[pos:pos + 8])[0], pos + 8
    if tag in (b"S", b"B"):
        n = struct.unpack(">I", buf[pos:pos + 4])[0]
        raw = bytes(buf[pos + 4:pos + 4 + n])
        return (raw.decode() if tag == b"S" else raw), pos + 4 + n
    if tag == b"A":
        hn = struct.unpack(">I", buf[pos:pos + 4])[0]
        d, s = json.loads(bytes(buf[pos + 4:pos + 4 + hn]).decode())
        pos += 4 + hn
        rn = struct.unpack(">Q", buf[pos:pos + 8])[0]
        arr = _nd_from_wire(d, s, bytes(buf[pos + 8:pos + 8 + rn]))
        return arr, pos + 8 + rn
    if tag in (b"G", b"H"):
        hn = struct.unpack(">I", buf[pos:pos + 4])[0]
        d, s, fields = json.loads(bytes(buf[pos + 4:pos + 4 + hn])
                                  .decode())
        kind = "seg" if tag == b"G" else "arena"
        if resolver is None:
            raise ValueError(
                f"message carries a {kind!r} ndarray locator but this "
                f"decoder has no resolver for it")
        return resolver(kind, d, s, tuple(fields)), pos + 4 + hn
    if tag == b"L":
        n = struct.unpack(">I", buf[pos:pos + 4])[0]
        pos += 4
        out = []
        for _ in range(n):
            v, pos = _dec_py(buf, pos, resolver)
            out.append(v)
        return out, pos
    if tag == b"M":
        n = struct.unpack(">I", buf[pos:pos + 4])[0]
        pos += 4
        out = {}
        for _ in range(n):
            k, pos = _dec_py(buf, pos, resolver)
            v, pos = _dec_py(buf, pos, resolver)
            out[k] = v
        return out, pos
    raise ValueError(f"bad RPC tag {tag!r}")


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def encode_control(obj, sink=None, *, force_fallback: bool = False) \
        -> bytes:
    """Message → control bytes; every ndarray is first offered to
    ``sink.put(arr)`` (a locator tuple replaces its bytes in the
    control message; None inlines it)."""
    if HAVE_MSGPACK and not force_fallback:
        return b"\x01" + msgpack.packb(obj, default=_msgpack_default(sink),
                                       use_bin_type=True)
    out: list = []
    _enc_py(obj, out, sink)
    return b"\x00" + b"".join(out)


def decode_control(raw, resolver: Optional[NdResolver] = None):
    """Control bytes → message; locator-typed ndarrays are resolved via
    ``resolver(kind, dtype_str, shape, fields)``."""
    raw = bytes(raw) if not isinstance(raw, (bytes, bytearray)) else raw
    if raw[:1] == b"\x01":
        if not HAVE_MSGPACK:
            raise RuntimeError("peer sent msgpack but msgpack is not "
                               "installed here")
        return msgpack.unpackb(raw[1:],
                               ext_hook=_msgpack_ext_hook(resolver),
                               raw=False, strict_map_key=False)
    val, pos = _dec_py(memoryview(raw), 1, resolver)
    if pos != len(raw):
        raise ValueError(f"trailing RPC bytes ({len(raw) - pos})")
    return val


def encode(obj, *, force_fallback: bool = False) -> bytes:
    """Message → wire bytes, everything inline (legacy format)."""
    return encode_control(obj, None, force_fallback=force_fallback)


def decode(raw: bytes):
    """Wire bytes → message (codec chosen by the leading byte)."""
    return decode_control(raw, None)
