"""The port's shard transport (``repro_torch.serving.transport``: errors,
codec, framing, ``StreamChannel``) against the JAX package's
(``repro.serving.transport``).

* Same bytes: for every value, with both codecs, the port's ``encode``,
  ``encode_control`` (no sink, ``SegmentSink``) and ``frame_buffers``
  write the JAX package's bytes, and the same segment buffers come out
  in the same order.
* Each package decodes the other's frames over a ``socket.socketpair()``:
  single-part and multi-part frames, a frame of several MB with a
  concurrent reader (its sender has a timeout, so the kernel takes the
  frame in parts: ``sendmsg_gather``'s partial-write path), and a frame
  delivered in pieces across ``pump`` slices.
* The JAX transport tests' contracts, held on the port: edge arrays,
  deep nesting, the 4 GiB guard, the sink/resolver seam, a locator
  with no resolver, ``SegmentSink``'s tiny arrays, the gather
  roundtrip, legacy single-part frames, copy accounting.
* The one difference: the port sends a frame of any number of segments
  (``IOV_MAX`` entries a ``sendmsg`` call at most); the JAX package's
  one call refuses past 1,024 entries, which a test pins.

Equality is the same dtype, shape and bytes for arrays, the same bits
for floats (NaN and ±inf included). Every socket wait has a timeout;
every send that could block on a full socket buffer runs on a thread of
its own, and every reader and sender thread is joined with one, so a
side that fails fails the test instead of hanging it.
"""

import importlib.util
import math
import pathlib
import socket
import struct
import sys
import threading
import time

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.serving.transport as J
import repro_torch.serving.transport as P
from repro.serving.transport import codec as jcodec
from repro_torch.core.sharded import merge_topk
from repro_torch.serving.transport import codec as pcodec
from repro_torch.serving.transport import framing as pframing

WAIT = 10.0                       # seconds: the bound on every socket wait
CODECS = pytest.mark.parametrize("force", [False, True],
                                 ids=["msgpack", "fallback"])



def _load_chip_smoke():
    """``chip_smoke.py`` as a module, for phase 4k's helpers: the tests
    hold messages with the phase's own rules. Listed in ``sys.modules``
    (its dataclasses look their module up); ``sys.path`` as it was."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_transport",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    saved = list(sys.path)
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path[:] = saved
    return module


CS = _load_chip_smoke()
CountingSocket = CS.CountingSocket


# ---------------------------------------------------------------------------
# equality
# ---------------------------------------------------------------------------

def same(a, b):
    """Two decodes agree: the same types, arrays of the same dtype, shape
    and bytes, floats of the same bits. Stricter than phase 4k's
    ``same_message``, which holds a sent value against its decode and so
    lets a tuple come back a list and a numpy scalar a Python one: two
    decoders of the same bytes must give the very same types."""
    assert type(a) is type(b), (type(a), type(b))
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, list):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, float):
        assert struct.pack(">d", a) == struct.pack(">d", b)
    else:
        assert a == b


def same_arrays(sent, got):
    """Every array crossed bit for bit, as a writable array of its own,
    by phase 4k's rule. Only the arrays: the fallback codec writes int
    dict keys as strings, so the other leaves of some values come back
    changed (the codecs' asymmetries, pinned in tests of their own)."""
    CS.same_message(CS.message_arrays(sent), CS.message_arrays(got),
                    "message")


# ---------------------------------------------------------------------------
# values
# ---------------------------------------------------------------------------

_EDGE_ARRAYS = [
    np.array(3.5, dtype=np.float32),                  # 0-d
    np.zeros((), dtype=np.int64),                     # 0-d int
    np.arange(24, dtype=np.float32).reshape(4, 6)[::2, ::3],  # strided
    np.arange(10)[::-1],                              # negative stride
    np.array([True, False, True]),                    # bool
    np.arange(6, dtype=np.float16),                   # float16
    np.arange(-3, 3, dtype=np.int8),                  # int8
    np.zeros((0,), dtype=np.float64),                 # empty 1-d
    np.zeros((3, 0, 2), dtype=np.int32),              # empty mid-axis
]

_SPECIAL = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-30, -7.25]


def _deep(levels: int = 40):
    val = {"leaf": None}
    for i in range(levels):
        val = {"level": i, "inner": val, "sib": [i, str(i), float(i)]}
    return val


def _values() -> dict:
    rng = np.random.default_rng(0)
    pids = np.where(rng.random((4, 24)) < 0.2, -1,
                    rng.integers(0, 1000, (4, 24)))
    # k wider than the lists: merge_topk pads with (-1, -inf)
    m_pids, m_scores = merge_topk(pids, rng.normal(size=(4, 24))
                                  .astype(np.float32), 32)
    q = rng.normal(size=(8, 32, 128)).astype(np.float32)
    return {
        "edge_arrays": {"a": _EDGE_ARRAYS,
                        "nested": [_EDGE_ARRAYS, {"x": _EDGE_ARRAYS}]},
        "specials": {"f64": np.array(_SPECIAL),
                     "f32": np.array(_SPECIAL, np.float32),
                     "f16": np.array(_SPECIAL, np.float16),
                     "merge_topk": {"pids": m_pids, "scores": m_scores},
                     "floats": [float(x) for x in _SPECIAL]},
        "worker_reply": {"ok": True, "result": {
            "cand": rng.integers(-1, 5000, (8, 64)).astype(np.int32),
            "approx": rng.normal(size=(8, 64)).astype(np.float32),
            "n_real": rng.integers(0, 64, 8)}},
        "request": {"op": "score_tokens", "payload": {
            "sel": rng.integers(-1, 900, (8, 40)), "q": q,
            "q_valid": rng.random((8, 32)) < 0.8,
            "q_strided": q[:, ::2, 1::3]}},
        "multi_reply": {"ok": True, "result": {"replies": [
            {"ok": True, "result": {"scores": np.full((2, 3), -np.inf,
                                                      np.float32)}},
            {"ok": False, "error": "Traceback (most recent call last):\n"
                                   "ValueError: bad op"}]}},
        "scalars": [None, True, False, 0, -1, 2 ** 62, -2 ** 63,
                    2 ** 63 - 1, 1.5, -0.0, "", "ünïcødé ✓", b"",
                    b"\x00\xff" * 40, np.float32(1.1), np.int64(-7),
                    np.bool_(True)],
        "containers": {"empty_list": [], "empty_dict": {},
                       "tuple": (1, (2, 3)), "int_keys": {1: "a", -2: [3]},
                       "tiny": np.arange(3, dtype=np.int8)},
        "deep": _deep(),
        "big_segments": [rng.normal(size=(64, 50)).astype(np.float32)
                         for _ in range(6)],
    }


VALUES = _values()


# ---------------------------------------------------------------------------
# same bytes
# ---------------------------------------------------------------------------

def _frame_bytes(pkg, value, force):
    """One package's bytes for ``value``: inline, control with no sink,
    control with a SegmentSink and its segments, and both frames."""
    sink = pkg.SegmentSink()
    control = pkg.encode_control(value, sink, force_fallback=force)
    inline = pkg.encode_control(value, None, force_fallback=force)
    return {
        "encode": pkg.encode(value, force_fallback=force),
        "control": inline,
        "control_seg": control,
        "segments": [bytes(b) for b in sink.bufs],
        "seg_nbytes": sink.nbytes,
        "frame": [bytes(b) for b in pkg.frame_buffers(inline, None)],
        "frame_seg": [bytes(b) for b in pkg.frame_buffers(control, sink)],
    }


@CODECS
@pytest.mark.parametrize("name", list(VALUES))
def test_the_port_writes_the_jax_bytes(name, force):
    value = VALUES[name]
    mine, ref = _frame_bytes(P, value, force), _frame_bytes(J, value, force)
    assert mine.keys() == ref.keys()
    for key in mine:
        assert mine[key] == ref[key], key
    assert mine["encode"][:1] == (b"\x00" if force else b"\x01")
    # each package decodes the frames, to the same values
    for frame in ("frame", "frame_seg"):
        payload = b"".join(mine[frame])[pframing.LEN_SIZE:]
        got, want = P.parse_payload(payload), J.parse_payload(payload)
        same(got, want)
        same_arrays(value, got)
    same(P.decode(mine["encode"]), J.decode(mine["encode"]))


@pytest.mark.parametrize("scalar", [
    np.float16(-0.1), np.float32(1.1), np.float64(2.2), np.int8(-5),
    np.int32(7), np.int64(-(2 ** 40)), np.uint64(2 ** 63 - 1),
    np.bool_(False)],
    ids=lambda x: type(x).__name__)
def test_numpy_scalars_write_the_jax_bytes(scalar):
    """msgpack packs what it knows and calls ``default`` for the rest:
    ``np.float64`` subclasses ``float``, the other kinds subclass nothing
    msgpack knows. Both packages write the same bytes for each kind, and
    a scalar decodes to the Python type of its kind."""
    kind = {"f": float, "i": int, "u": int, "b": bool}[scalar.dtype.kind]
    for force in (False, True):
        raw = P.encode({"x": scalar}, force_fallback=force)
        assert raw == J.encode({"x": scalar}, force_fallback=force)
        got = P.decode(raw)["x"]
        assert type(got) is kind and got == kind(scalar)
    assert (P.encode(np.float32(1.1)) == P.encode(float(np.float32(1.1)))
            == b"\x01" + b"\xcb" + struct.pack(">d", float(np.float32(1.1))))
    assert (P.encode(np.float64(2.2)) == P.encode(2.2)
            == b"\x01" + b"\xcb" + struct.pack(">d", 2.2))


@CODECS
def test_the_codecs_asymmetries_are_the_jax_packages(force):
    """The fallback writes dict keys as ``str(k)``, msgpack keeps int
    keys; both turn a tuple into a list; an int outside int64 packs
    under msgpack and raises ``struct.error`` in the fallback. The port
    does what the JAX package does."""
    value = {1: (2, (3,)), "s": (), -4: None}
    got = P.decode(P.encode(value, force_fallback=force))
    assert got == J.decode(J.encode(value, force_fallback=force))
    keys = ["1", "s", "-4"] if force else [1, "s", -4]
    assert list(got) == keys and got[keys[0]] == [2, [3]]
    assert got["s"] == []
    huge = 2 ** 63
    if force:
        for pkg in (P, J):
            with pytest.raises(struct.error):
                pkg.encode({"n": huge}, force_fallback=True)
    else:
        raw = P.encode({"n": huge})
        assert raw == J.encode({"n": huge}) and P.decode(raw) == {"n": huge}


@CODECS
def test_unencodable_values_raise_type_error(force):
    """A ``torch.Tensor`` is unencodable like any foreign value: the
    sender converts with ``.cpu().numpy()``."""
    import torch
    for bad in (torch.arange(4), object(), {1.5, 2.5}):
        with pytest.raises(TypeError, match="unencodable RPC value"):
            P.encode({"t": bad}, force_fallback=force)
    arr = torch.arange(4).cpu().numpy()
    assert (P.encode({"t": arr}, force_fallback=force)
            == J.encode({"t": arr}, force_fallback=force))


def test_decode_errors_are_the_jax_packages(monkeypatch):
    raw = P.encode({"a": 1}, force_fallback=True)
    for pkg in (P, J):
        with pytest.raises(ValueError, match=r"trailing RPC bytes \(1\)"):
            pkg.decode(raw + b"N")
        with pytest.raises(ValueError, match="bad RPC tag"):
            pkg.decode(b"\x00Z")
    monkeypatch.setattr(pcodec, "HAVE_MSGPACK", False)
    with pytest.raises(RuntimeError, match="msgpack is not installed"):
        P.decode(J.encode({"a": 1}))
    # without msgpack the port encodes the fallback, which JAX decodes
    assert P.encode({"a": 1}) == raw
    assert J.decode(P.encode({"a": 1})) == {"a": 1}


# ---------------------------------------------------------------------------
# the JAX transport tests' contracts, on the port
# ---------------------------------------------------------------------------

def test_codec_length_guard_over_4gib():
    """4-byte count/length fields refuse values over 4 GiB — a silent
    struct wrap would desynchronise the stream."""
    with pytest.raises(ValueError, match="4 GiB"):
        pcodec._check_u32((4 << 30) + 1, "bytes")
    assert pcodec._check_u32(4096, "bytes") == 4096
    assert pcodec._check_u32(0xFFFFFFFF, "str") == 0xFFFFFFFF

    class _FakeBig(bytes):
        def __len__(self):
            return 5 << 30

    with pytest.raises(ValueError, match="4 GiB"):
        P.encode({"b": _FakeBig()}, force_fallback=True)
    sink = P.SegmentSink()
    sink.put(np.zeros(64, np.uint8))
    with pytest.raises(ValueError, match="4 GiB"):
        P.frame_buffers(_FakeBig(), sink)


@CODECS
def test_codec_locator_roundtrip_via_sink_resolver(force):
    """The layering seam: a sink replaces tensor bytes with locators at
    encode time; a resolver materialises them at decode time. Without a
    resolver a locator-bearing message refuses to half-decode."""
    stash = {}

    class Sink:
        def put(self, arr):
            key = len(stash)
            stash[key] = np.ascontiguousarray(arr)
            return ("arena", 7, key, 0, arr.nbytes)

    def resolver(kind, dtype_str, shape, fields):
        assert kind == "arena" and fields[0] == 7
        return stash[fields[1]].reshape(shape)

    big = np.random.default_rng(0).random((50, 8)).astype(np.float32)
    msg = {"big": big, "tiny": 3}
    control = P.encode_control(msg, Sink(), force_fallback=force)
    assert len(control) < big.nbytes          # bytes did NOT inline
    stash.clear()
    assert control == J.encode_control(msg, Sink(), force_fallback=force)
    got = P.decode_control(control, resolver)
    same(got["big"], big)
    for pkg in (P, J):
        with pytest.raises(ValueError, match="locator"):
            pkg.decode_control(control, None)
    # a multi-part frame with an arena locator: parse_payload has no
    # resolver for it, and a stream channel has none either
    seg = P.SegmentSink()
    seg.put(np.zeros(16, np.float32))
    payload = b"".join(P.frame_buffers(control, seg))[8:]
    with pytest.raises(ValueError, match="no resolver for 'arena'"):
        P.parse_payload(payload)
    a, b = socket.socketpair()
    rx = P.StreamChannel(b)
    try:
        a.sendall(b"".join(P.frame_buffers(control, seg)))
        with pytest.raises(ValueError, match="on a socket channel"):
            rx.recv(timeout=WAIT)
    finally:
        a.close()
        rx.close()


def test_segment_sink_declines_tiny_and_copies_strided():
    for pkg in (P, J):
        sink = pkg.SegmentSink(min_bytes=64)
        assert sink.put(np.arange(3, dtype=np.int8)) is None   # tiny
        assert sink.put(np.zeros(15, np.float32)) is None      # 60 bytes
        strided = np.arange(64, dtype=np.float64).reshape(8, 8)[:, ::2]
        assert sink.put(strided) == ("seg", 0, strided.nbytes)
        contig = np.arange(32, dtype=np.float64)
        assert sink.put(contig) == ("seg", strided.nbytes, contig.nbytes)
        assert sink.nbytes == strided.nbytes + contig.nbytes
        assert bytes(sink.bufs[0]) == strided.tobytes()
        # a contiguous source is not copied: its segment is its memory
        assert np.shares_memory(np.frombuffer(sink.bufs[1], np.float64),
                                contig)
    assert P.SegmentSink().min_bytes == 64


@pytest.mark.parametrize("sender,receiver", [(P, J), (J, P)],
                         ids=["port_to_jax", "jax_to_port"])
def test_frame_gather_roundtrip_over_socketpair(sender, receiver):
    """Multi-part frame: control + segments gathered via sendmsg on one
    package's side, parsed back to bitwise-equal arrays by the other's."""
    a, b = socket.socketpair()
    b.settimeout(WAIT)
    try:
        sink = sender.SegmentSink()
        msg = {"q": np.random.default_rng(1).random(
                   (37, 16)).astype(np.float32),
               "sel": np.arange(100, dtype=np.int64).reshape(4, 25)[:, ::5],
               "small": np.int32(7), "tag": "x"}
        bufs = sender.frame_buffers(sender.encode_control(msg, sink), sink)
        n = sender.sendmsg_gather(a, bufs)
        assert n == sum(len(x) for x in bufs)
        raw = b""
        while len(raw) < n:
            raw += b.recv(n - len(raw))
        (length,) = struct.unpack(">Q", raw[:8])
        assert length == len(raw) - 8 and raw[8:9] == b"\x02"
        got = receiver.parse_payload(raw[8:])
        same_arrays(msg, got)
        assert got["small"] == 7 and got["tag"] == "x"
    finally:
        a.close()
        b.close()


@pytest.mark.parametrize("sender,receiver", [(P, J), (J, P)],
                         ids=["port_to_jax", "jax_to_port"])
def test_legacy_single_part_frames_still_decode(monkeypatch, sender,
                                                receiver):
    """``send_msg`` → ``recv_msg`` across the packages, with each codec
    of the sender's (the fallback by hiding msgpack from its encoder)."""
    codec_mod = pcodec if sender is P else jcodec
    for have in (True, False):
        monkeypatch.setattr(codec_mod, "HAVE_MSGPACK", have)
        a, b = socket.socketpair()
        try:
            msg = {"op": "ping", "payload": {"x": np.arange(5),
                                             "nan": np.array([np.nan])}}
            n = sender.send_msg(a, msg)
            got = receiver.recv_msg(b, timeout=WAIT)
            same_arrays(msg, got)
            assert got["op"] == "ping"
            assert n == 8 + len(sender.encode(msg))
            with pytest.raises(socket.timeout, match="deadline"):
                receiver.recv_msg(b, timeout=0.05)
            a.close()
            with pytest.raises(ConnectionError, match="closed"):
                receiver.recv_msg(b, timeout=WAIT)
        finally:
            a.close()
            b.close()


@pytest.mark.parametrize("sender,receiver", [(P, P), (P, J), (J, P)],
                         ids=["port", "port_to_jax", "jax_to_port"])
def test_channel_roundtrip_and_copy_accounting(sender, receiver):
    """The JAX socket case: a 256 KB array crosses as a segment; the
    sender counts it in ``bytes_copied``, never in ``bytes_zero_copy``.
    Both packages' counters agree on the same message."""
    a, b = socket.socketpair()
    tx, rx = sender.StreamChannel(a), receiver.StreamChannel(b)
    try:
        big = np.random.default_rng(3).random((2048, 32)).astype(np.float32)
        msg = {"op": "score", "payload": {"q": big, "k": 10, "alpha": 0.5}}
        t = threading.Thread(target=tx.send, args=(msg,), daemon=True)
        t.start()
        got = rx.recv(timeout=WAIT)
        t.join(timeout=WAIT)
        assert not t.is_alive()
        same_arrays(msg, got)
        assert got["payload"]["k"] == 10 and got["payload"]["alpha"] == 0.5
        ts, rs = tx.stats(), rx.stats()
        assert ts["transport"] == rs["transport"] == "socket"
        assert ts["bytes_copied"] == big.nbytes
        assert ts["bytes_zero_copy"] == rs["bytes_zero_copy"] == 0
        assert ts["bytes_sent"] >= big.nbytes
        assert rs["bytes_recv"] == ts["bytes_sent"]
        assert list(ts) == ["transport", "bytes_sent", "bytes_recv",
                            "bytes_copied", "bytes_zero_copy"]
    finally:
        tx.close()
        rx.close()
        tx.close()                           # close twice: a no-op
    assert tx.sock is None


# ---------------------------------------------------------------------------
# channels across the packages
# ---------------------------------------------------------------------------

def _sender_codec(monkeypatch, pkg, force):
    """Make ``pkg``'s channels encode with the fallback (``force``) by
    hiding msgpack from its encoder; channels take no codec argument."""
    if force:
        monkeypatch.setattr(pcodec if pkg is P else jcodec, "HAVE_MSGPACK",
                            False)


class Reader:
    """Receives ``n`` messages on ``channel`` on a thread of its own."""

    def __init__(self, channel, n: int):
        self.got, self.error = [], None
        self.thread = threading.Thread(target=self._run,
                                       args=(channel, n), daemon=True)
        self.thread.start()

    def _run(self, channel, n):
        try:
            for _ in range(n):
                self.got.append(channel.recv(timeout=WAIT))
        except BaseException as e:
            self.error = e

    def join(self):
        self.thread.join(WAIT * 2)
        assert not self.thread.is_alive()
        if self.error is not None:
            raise self.error
        return self.got


class Sender:
    """Sends ``msgs`` on ``channel`` on a thread of its own: a send that
    blocks on a full buffer, because the reader failed, then fails the
    test at :meth:`join` (closing the reader's socket ends the send)."""

    def __init__(self, channel, msgs):
        self.sizes, self.error = [], None
        self.thread = threading.Thread(target=self._run,
                                       args=(channel, msgs), daemon=True)
        self.thread.start()

    def _run(self, channel, msgs):
        try:
            for m in msgs:
                self.sizes.append(channel.send(m))
        except BaseException as e:
            self.error = e

    def join(self):
        self.thread.join(WAIT * 2)
        assert not self.thread.is_alive()
        if self.error is not None:
            raise self.error
        return self.sizes


DIRECTIONS = pytest.mark.parametrize(
    "sender,receiver", [(P, J), (J, P)], ids=["port_to_jax", "jax_to_port"])


@CODECS
@DIRECTIONS
def test_channels_decode_each_others_frames(monkeypatch, sender, receiver,
                                            force):
    """Single-part frames (no array of 64 bytes or more) and multi-part
    frames, in one FIFO stream, both ways, with either codec."""
    _sender_codec(monkeypatch, sender, force)
    a, b = socket.socketpair()
    tx, rx = sender.StreamChannel(a), receiver.StreamChannel(b)
    msgs = [{"op": "health", "payload": {}},
            VALUES["worker_reply"], VALUES["specials"],
            {"op": "tiny", "payload": {"x": np.arange(3, dtype=np.int8),
                                       "f": np.float32(0.5)}},
            VALUES["request"], VALUES["multi_reply"], VALUES["edge_arrays"]]
    try:
        reader = Reader(rx, len(msgs))
        sending = Sender(tx, msgs)
        got = reader.join()
        sizes = sending.join()
        for m, g in zip(msgs, got):
            same_arrays(m, g)
            same(g, J.decode(J.encode(m, force_fallback=force)))
        assert tx.stats()["bytes_sent"] == sum(sizes)
        assert rx.stats()["bytes_recv"] == sum(sizes)
        # which frames went out single-part: no array of 64 bytes or more
        sink = P.SegmentSink()
        P.encode_control(msgs[3], sink)
        assert sink.nbytes == 0
    finally:
        tx.close()
        rx.close()


@DIRECTIONS
def test_a_frame_larger_than_the_socket_buffer(sender, receiver):
    """A frame of 8 MB, read concurrently. The sender's socket has a
    timeout, so each ``sendmsg`` call returns after what fits in the
    buffer: the frame goes out in many calls, through the partial-write
    path. A blocking socket takes it whole in one call, as a rule.
    Either way the sends run on a thread joined with a bound."""
    rng = np.random.default_rng(5)
    msg = {"ok": True, "result": {
        "scores": rng.normal(size=(1024, 1024)).astype(np.float32),
        "pids": rng.integers(0, 1 << 40, (1024, 512)),
        "mask": rng.random((1024, 1000)) < 0.5}}
    for timeout in (WAIT, None):
        a, b = socket.socketpair()
        a.settimeout(timeout)
        assert a.getsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF) < (8 << 20)
        counting = CountingSocket(a)
        tx, rx = sender.StreamChannel(counting), receiver.StreamChannel(b)
        try:
            reader = Reader(rx, 2)
            sending = Sender(tx, [msg, {"after": 1}])
            got = reader.join()
            n, _ = sending.join()
            same_arrays(msg, got[0])
            assert got[1] == {"after": 1}
            assert n > 9_000_000
            assert counting.sendmsg_calls > (4 if timeout else 1)
        finally:
            tx.close()
            rx.close()


@DIRECTIONS
def test_a_frame_in_pieces_across_pump_slices(sender, receiver):
    """A frame delivered in pieces: ``pump`` returns None while it is
    partial and keeps the bytes it read; the frame decodes when whole.
    Two frames in one piece: the second decodes from the buffer without
    a byte more from the socket."""
    sink = sender.SegmentSink()
    msg = VALUES["request"]
    bufs = sender.frame_buffers(sender.encode_control(msg, sink), sink)
    raw = b"".join(bytes(x) for x in bufs)
    second = b"".join(bytes(x) for x in sender.frame_buffers(
        sender.encode_control({"seq": 2}), None))
    a, b = socket.socketpair()
    a.settimeout(WAIT)
    rx = receiver.StreamChannel(b)
    try:
        cuts = [0, 3, 8, 9, 100, len(raw) // 2, len(raw) - 1, len(raw)]
        for lo, hi in zip(cuts, cuts[1:]):
            assert rx.pump(0.01) is None
            a.sendall(raw[lo:hi])
            if hi < len(raw):
                # slices until the piece is read (a loaded host may end a
                # slice before its first read): each returns None
                deadline = time.monotonic() + WAIT
                while (rx.stats()["bytes_recv"] < hi
                       and time.monotonic() < deadline):
                    assert rx.pump(0.01) is None
                assert rx.stats()["bytes_recv"] == hi
        got = rx.pump(WAIT)
        same_arrays(msg, got)
        assert rx.stats()["bytes_recv"] == len(raw)
        a.sendall(raw + second)
        same_arrays(msg, rx.pump(WAIT))
        a.close()                     # nothing more reaches the socket
        assert rx.pump(WAIT) == {"seq": 2}
        with pytest.raises(ConnectionError, match="closed"):
            rx.pump(WAIT)
    finally:
        a.close()
        rx.close()


def test_recv_deadline_raises_socket_timeout():
    a, b = socket.socketpair()
    rx = P.StreamChannel(b)
    try:
        t0 = time.monotonic()
        with pytest.raises(socket.timeout, match="deadline"):
            rx.recv(timeout=0.2)
        assert 0.15 < time.monotonic() - t0 < WAIT
        assert rx.pump(0.0) is None
        a.sendall(b"".join(P.frame_buffers(P.encode({"x": 1}), None))[:5])
        with pytest.raises(socket.timeout):
            rx.recv(timeout=0.1)
        a.sendall(b"".join(P.frame_buffers(P.encode({"x": 1}), None))[5:])
        assert rx.recv(timeout=WAIT) == {"x": 1}
    finally:
        a.close()
        rx.close()


# ---------------------------------------------------------------------------
# the repair: IOV_MAX
# ---------------------------------------------------------------------------

def _segments(n: int) -> dict:
    return {"segs": [np.full(16, i, np.float32) for i in range(n)]}


@pytest.mark.parametrize("n_segments", [1022, 1023, 1100, 2049])
def test_the_port_sends_any_number_of_segments(n_segments):
    """The port's ``sendmsg_gather`` hands ``sendmsg`` at most
    ``IOV_MAX`` buffers a call; the JAX channel decodes the frame bit
    for bit, and the bytes are the ones the JAX package would write."""
    assert pframing.IOV_MAX == 1024
    msg = _segments(n_segments)
    a, b = socket.socketpair()
    counting = CountingSocket(a)
    tx, rx = P.StreamChannel(counting), J.StreamChannel(b)
    try:
        reader = Reader(rx, 1)
        sending = Sender(tx, [msg])
        (got,) = reader.join()
        sending.join()
        same_arrays(msg, got)
        assert counting.sendmsg_calls == math.ceil((n_segments + 2)
                                                   / pframing.IOV_MAX)
        assert tx.stats()["bytes_copied"] == n_segments * 64
    finally:
        tx.close()
        rx.close()
    sink, jsink = P.SegmentSink(), J.SegmentSink()
    frame = P.frame_buffers(P.encode_control(msg, sink), sink)
    jframe = J.frame_buffers(J.encode_control(msg, jsink), jsink)
    assert [bytes(x) for x in frame] == [bytes(x) for x in jframe]


def test_the_jax_package_refuses_more_than_1022_segments():
    """The fault the port repairs, pinned: the JAX ``sendmsg_gather``
    passes the whole gather list to one ``sendmsg`` call, which Linux
    caps at 1,024 entries (header, control and 1,022 segments)."""
    for n, fails in ((1022, False), (1023, True)):
        a, b = socket.socketpair()
        tx, rx = J.StreamChannel(a), P.StreamChannel(b)
        try:
            if fails:
                with pytest.raises(OSError) as e:
                    tx.send(_segments(n))
                assert e.value.errno == 90     # EMSGSIZE
                assert rx.pump(0.05) is None   # nothing reached the wire
            else:
                reader = Reader(rx, 1)
                sending = Sender(tx, [_segments(n)])
                same_arrays(_segments(n), reader.join()[0])
                sending.join()
        finally:
            tx.close()
            rx.close()


# ---------------------------------------------------------------------------
# property tests
# ---------------------------------------------------------------------------

_LEAVES = st.one_of(
    st.none(), st.booleans(),
    st.integers(min_value=-2 ** 63, max_value=2 ** 63 - 1),
    st.floats(width=64), st.text(max_size=16), st.binary(max_size=24))


@settings(max_examples=50, deadline=None)
@given(st.recursive(
    _LEAVES,
    lambda leaf: st.one_of(
        st.lists(leaf, max_size=4),
        st.dictionaries(st.text(max_size=6), leaf, max_size=4)),
    max_leaves=16))
def test_property_nested_values_write_the_jax_bytes(value):
    for force in (False, True):
        raw = P.encode(value, force_fallback=force)
        assert raw == J.encode(value, force_fallback=force)
        same(P.decode(raw), J.decode(raw))


@settings(max_examples=50, deadline=None)
@given(st.sampled_from(["|b1", "<f2", "|i1", "<f4", "<i8", "<u2", "<f8"]),
       st.lists(st.integers(min_value=0, max_value=5), min_size=0,
                max_size=3),
       st.integers(min_value=0, max_value=2 ** 31),
       st.booleans())
def test_property_ndarray_frames_write_the_jax_bytes(dtype_str, shape, seed,
                                                     transpose):
    rng = np.random.default_rng(seed)
    arr = rng.integers(-100, 100, size=shape).astype(np.dtype(dtype_str))
    if transpose and arr.ndim >= 2:
        arr = arr.T                             # non-contiguous
    value = {"arr": arr, "pad": np.full(9, -np.inf, np.float64)}
    for force in (False, True):
        mine, ref = _frame_bytes(P, value, force), _frame_bytes(J, value,
                                                                force)
        assert mine == ref
        got = P.parse_payload(b"".join(mine["frame_seg"])[8:])
        same_arrays(value, got)


# ---------------------------------------------------------------------------
# errors and the package's surface
# ---------------------------------------------------------------------------

def test_errors_keep_the_jax_bases():
    for name in ("ShardWorkerDied", "ShardWorkerError", "ArenaDead",
                 "DeadlineExceeded", "ShardUnavailable"):
        mine, ref = getattr(P, name), getattr(J, name)
        assert [c.__name__ for c in mine.__mro__] == \
            [c.__name__ for c in ref.__mro__]
    assert issubclass(P.ArenaDead, ConnectionError)
    assert issubclass(P.DeadlineExceeded, ConnectionError)
    assert issubclass(P.ShardUnavailable, P.ShardWorkerDied)
    cause = P.ArenaDead("gone")
    e = P.ShardUnavailable("no replica", shard=3, last_error=cause)
    assert (str(e), e.shard, e.last_error) == ("no replica", 3, cause)
    e = P.ShardUnavailable("x")
    assert (e.shard, e.last_error) == (-1, None)


def test_the_package_holds_the_socket_half_alone():
    """The shared-memory ring, its channel and fault injection are later
    slices: nothing of them is exported or stubbed. The worker client
    (over the socket channel) is the package's."""
    root = pathlib.Path(P.__file__).parent
    assert sorted(p.name for p in root.glob("*.py")) == [
        "__init__.py", "channel.py", "client.py", "codec.py", "errors.py",
        "framing.py"]
    for name in ("ShmChannel", "ShmArena", "ArenaSink", "FaultSpec"):
        assert not hasattr(P, name)
    assert "ShardWorkerClient" in P.__all__
    assert set(P.__all__) <= set(J.__all__)
    assert P.HAVE_MSGPACK == J.HAVE_MSGPACK


# ---------------------------------------------------------------------------
# chip_smoke.py phase 4k, on small arrays
# ---------------------------------------------------------------------------

def test_chip_smoke_transport_roundtrips_on_small_arrays(monkeypatch):
    """Phase 4k's round-trip function on the CPU at a small size: every
    codec of the host, each message bit for bit, the burst in FIFO
    order, a frame larger than the socket's buffer in more than one
    ``sendmsg`` call, the counters."""
    monkeypatch.setattr(CS, "TRANSPORT_WAIT", WAIT)
    v = VALUES
    messages = {"worker_reply": v["worker_reply"], "request": v["request"],
                "specials": {"ok": True, "result": v["specials"]}}
    out = CS.transport_roundtrips(messages, big_bytes=2 << 20, burst=9,
                                  reps=2)
    assert out["have_msgpack"] == P.HAVE_MSGPACK
    assert list(out["codecs"]) == (["msgpack", "fallback"]
                                   if P.HAVE_MSGPACK else ["fallback"])
    want = 2 * sum(CS.segment_bytes(m) for m in messages.values())
    want += sum(CS.segment_bytes(messages[k]) for k in
                [list(messages)[i % 3] for i in range(9)])
    want += 2 << 20
    for fig in out["codecs"].values():
        assert list(fig["messages"]) == list(messages)
        assert fig["burst"] == {"frames": 9, "fifo": True,
                                "ms": fig["burst"]["ms"]}
        assert fig["big"]["sendmsg_calls"] > 1
        assert fig["tensor_bytes_64_or_more"] == want
        assert fig["sender"]["bytes_copied"] == want
    assert pcodec.HAVE_MSGPACK == J.HAVE_MSGPACK      # restored
    # a message that does not cross bit for bit fails the phase
    with pytest.raises(AssertionError, match="an array differs"):
        CS.same_message({"a": np.zeros(3, np.float32)},
                        {"a": np.zeros(3, np.float64)}, "x")
    with pytest.raises(AssertionError, match="keys differ"):
        CS.same_message({"a": 1}, {"b": 1}, "x")
    view = np.frombuffer(np.zeros(3, np.float32).tobytes(), np.float32)
    with pytest.raises(AssertionError, match="an array differs"):
        CS.same_message({"a": np.zeros(3, np.float32)}, {"a": view}, "x")
