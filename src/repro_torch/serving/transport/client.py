"""Coordinator-side handle of one shard worker process.

:class:`ShardWorkerClient` spawns a shard worker
(``repro_torch.serving.worker``) and talks to it through a
:class:`~repro_torch.serving.transport.channel.StreamChannel` over a
socketpair. The request/response discipline is the JAX package's
(``repro.serving.transport.client``):

* requests are **pipelined**: ``call_async`` sends at once and returns a
  handle; replies are FIFO per connection, so an abandoned handle's
  reply is still consumed by the next waiter and the stream never
  desynchronises;
* liveness is exact: a worker's death is socket EOF, not a guessed
  timeout;
* soft deadlines (``kill_on_timeout=False``) never kill a merely busy
  worker, and a per-op ``timeout_ms`` tears the connection down
  (:class:`DeadlineExceeded`);
* every transport failure marks the client dead and fails every
  outstanding handle with :class:`ShardWorkerDied`.

The worker runs its shard on ``device`` (default ``cuda``, passed to the
child as ``--device``); without a GPU the default makes the child fail
at start-up, and ``spawn`` raises. The signature keeps the JAX client's
``transport="shm"`` default, but the shared-memory ring is ROADMAP item
3b-i-b and not ported yet: ``transport="shm"`` raises, and callers pass
``transport="socket"``. A remote ``endpoint`` and a ``fault_spec`` are
ROADMAP item 3b-vi and raise too.
"""

from __future__ import annotations

import collections
import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import threading
import time
from typing import Any, Optional

from repro_torch.serving.transport.channel import StreamChannel
from repro_torch.serving.transport.errors import (DeadlineExceeded,
                                                  ShardWorkerDied,
                                                  ShardWorkerError)


class _Reply:
    """One outstanding pipelined request's reply slot."""

    __slots__ = ("event", "value", "error", "deadline")

    def __init__(self):
        self.event = threading.Event()
        self.value = None
        self.error: Optional[BaseException] = None
        # absolute monotonic per-op deadline (None = only the waiter's
        # own timeout applies)
        self.deadline: Optional[float] = None

    def resolve(self, value=None, error: Optional[BaseException] = None):
        self.value = value
        self.error = error
        self.event.set()


def _src_pythonpath() -> str:
    """PYTHONPATH entry that makes ``repro_torch`` importable in the
    child, ahead of the parent's own entries."""
    import repro_torch

    src = str(pathlib.Path(repro_torch.__file__).resolve().parent.parent)
    existing = os.environ.get("PYTHONPATH", "")
    return src if not existing else f"{src}{os.pathsep}{existing}"


class ShardWorkerClient:
    """Spawn and talk to one shard worker process over a channel."""

    def __init__(self, shard_index: int, shard_dir, *, mode: str = "mmap",
                 plaid_params: Optional[dict] = None,
                 ms_params: Optional[dict] = None,
                 env: Optional[dict] = None,
                 spawn_timeout_s: float = 180.0,
                 call_timeout_s: float = 300.0,
                 transport: str = "shm",
                 endpoint: Optional[str] = None,
                 fault_spec=None,
                 device="cuda"):
        if transport == "shm":
            raise NotImplementedError(
                "transport='shm': the shared-memory ring (ROADMAP item "
                "3b-i-b) is not ported yet; pass transport='socket'")
        if transport != "socket":
            raise ValueError(f"unknown shard transport {transport!r}")
        if endpoint is not None or fault_spec is not None:
            raise NotImplementedError(
                "endpoint= and fault_spec=: remote workers and fault "
                "injection (ROADMAP item 3b-vi) are not ported yet")
        self.shard_index = shard_index
        self.shard_dir = str(shard_dir)
        self.mode = mode
        self.plaid_params = plaid_params or {}
        self.ms_params = ms_params or {}
        self.env = env
        self.spawn_timeout_s = spawn_timeout_s
        self.call_timeout_s = call_timeout_s
        self.transport = transport
        self.device = str(device)
        self.proc: Optional[subprocess.Popen] = None
        self.channel: Optional[StreamChannel] = None
        self.dead = False
        # RLock: a send failure marks the client dead from *inside* the
        # send critical section (_mark_dead re-enters to fail pending)
        self._send_lock = threading.RLock()
        self._recv_lock = threading.Lock()
        self._pending: collections.deque[_Reply] = collections.deque()

    # -- channel plumbing ------------------------------------------------
    @property
    def sock(self) -> Optional[socket.socket]:
        return None if self.channel is None else self.channel.sock

    @sock.setter
    def sock(self, s: Optional[socket.socket]):
        # legacy seam (tests drive a bare socketpair end through the
        # client): wrapping in a stream channel preserves it
        self.channel = None if s is None else StreamChannel(s)

    @property
    def bytes_sent(self) -> int:
        return 0 if self.channel is None else self.channel.bytes_sent

    @property
    def bytes_recv(self) -> int:
        return 0 if self.channel is None else self.channel.bytes_recv

    def transport_stats(self) -> dict:
        if self.channel is None:
            return {"transport": self.transport, "bytes_sent": 0,
                    "bytes_recv": 0, "bytes_copied": 0,
                    "bytes_zero_copy": 0}
        return self.channel.stats()

    def outstanding(self) -> int:
        return len(self._pending)

    # -- lifecycle -------------------------------------------------------
    def spawn(self):
        """Start the worker and wait for its first ping, the readiness
        barrier: the worker answers only after loading its shard on its
        device. A worker that dies or hangs before that answer is
        killed, reaped and reported as :class:`ShardWorkerDied` with
        its exit code. → the ping's result."""
        parent, child = socket.socketpair()
        cmd = [sys.executable, "-m", "repro_torch.serving.worker",
               "--shard-dir", self.shard_dir,
               "--shard-index", str(self.shard_index),
               "--mode", self.mode,
               "--fd", str(child.fileno()),
               "--transport", self.transport,
               "--device", self.device,
               "--plaid-json", json.dumps(self.plaid_params),
               "--ms-json", json.dumps(self.ms_params)]
        env = dict(os.environ if self.env is None else self.env)
        env["PYTHONPATH"] = _src_pythonpath()
        try:
            self.proc = subprocess.Popen(cmd, pass_fds=(child.fileno(),),
                                         env=env, stdin=subprocess.DEVNULL)
        except BaseException:
            parent.close()
            raise
        finally:
            child.close()
        self.channel = StreamChannel(parent)
        self.dead = False
        try:
            return self.call("ping", {}, timeout=self.spawn_timeout_s)
        except BaseException as e:
            # a worker that hung or died during start-up is reaped here:
            # the caller has no handle on it yet, so an unreaped child
            # would be an orphan
            try:
                self.proc.kill()
            except OSError:
                pass
            self.proc.wait()
            self.dead = True
            self._close_channel()
            if isinstance(e, ShardWorkerDied):
                raise self._died_error("did not start") from e
            raise

    @property
    def pid(self) -> Optional[int]:
        return self.proc.pid if self.proc is not None else None

    def alive(self) -> bool:
        return (not self.dead and self.proc is not None
                and self.proc.poll() is None)

    # -- request/response ------------------------------------------------
    def call_async(self, op: str, payload: Any,
                   timeout_ms: Optional[float] = None) -> _Reply:
        rep = _Reply()
        if timeout_ms is not None:
            rep.deadline = time.monotonic() + timeout_ms / 1e3
        with self._send_lock:
            if self.dead or self.channel is None:
                raise self._died_error("is not running")
            try:
                self.channel.send({"op": op, "payload": payload})
            except OSError as e:
                self._mark_dead()
                raise self._died_error(f"send failed ({e})") from e
            self._pending.append(rep)
        return rep

    def wait(self, rep: _Reply, timeout: Optional[float] = None,
             kill_on_timeout: bool = True):
        """Wait for one handle; any waiter pumps the shared channel, and
        frames resolve pending handles strictly in FIFO order.

        ``kill_on_timeout=False`` makes the deadline *soft*: expiry
        raises :class:`ShardWorkerError` without marking the worker
        dead (the discipline of health polls, which queue behind real
        work and must never kill a worker that is merely busy). The
        abandoned reply stays pending and is consumed, in order, by the
        next waiter."""
        deadline = time.monotonic() + (timeout if timeout is not None
                                       else self.call_timeout_s)
        while not rep.event.is_set():
            if not self._recv_lock.acquire(timeout=0.02):
                continue
            try:
                if rep.event.is_set():
                    break
                now = time.monotonic()
                if rep.deadline is not None and rep.deadline <= now \
                        and rep.deadline <= deadline:
                    # the per-op deadline: the worker is hung or the
                    # request was lost. Tear the connection down, since
                    # replies queued behind the expired one would
                    # desequence the FIFO
                    self._mark_dead()
                    raise DeadlineExceeded(
                        f"shard {self.shard_index} per-op deadline "
                        f"exceeded")
                remaining = deadline - now
                if rep.deadline is not None:
                    remaining = min(remaining, rep.deadline - now)
                if remaining <= 0:
                    if not kill_on_timeout:
                        raise ShardWorkerError(
                            f"shard {self.shard_index} soft RPC "
                            f"deadline expired (worker busy)")
                    self._mark_dead()
                    raise self._died_error("RPC timed out")
                ch = self.channel
                if ch is None:
                    # a concurrent _mark_dead (a send failure on another
                    # thread) dropped the channel; the pending replies
                    # are already resolved with errors
                    raise self._died_error(
                        "died while a reply was pending")
                try:
                    msg = ch.pump(min(remaining, 1.0))
                except (OSError, ConnectionError, ValueError,
                        RuntimeError) as e:
                    self._mark_dead()
                    raise self._died_error(f"recv failed ({e})") from e
                if msg is None:
                    continue               # slice expired; frame intact
                try:
                    head = self._pending.popleft()
                except IndexError:
                    # a concurrent _mark_dead drained the deque between
                    # the pump and this pop: the client is dead, not
                    # corrupted
                    raise self._died_error(
                        "reply arrived after the client was marked "
                        "dead")
                head.resolve(value=msg)
            finally:
                self._recv_lock.release()
        if rep.error is not None:
            raise rep.error
        msg = rep.value
        if not msg.get("ok", False):
            raise ShardWorkerError(
                f"shard {self.shard_index} op failed:\n{msg.get('error')}")
        return msg.get("result")

    def call(self, op: str, payload: Any,
             timeout: Optional[float] = None,
             kill_on_timeout: bool = True,
             timeout_ms: Optional[float] = None):
        return self.wait(self.call_async(op, payload,
                                         timeout_ms=timeout_ms),
                         timeout=timeout,
                         kill_on_timeout=kill_on_timeout)

    # -- failure / shutdown ----------------------------------------------
    def _mark_dead(self):
        self.dead = True
        # wake a sender blocked in a socket send on a full pipe *before*
        # taking the send lock it holds: the shutdown errors the send out
        sock = self.sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        err = self._died_error("died mid-conversation")
        with self._send_lock:
            while self._pending:
                self._pending.popleft().resolve(error=err)

    def _died_error(self, why: str) -> ShardWorkerDied:
        code = self.proc.poll() if self.proc is not None else None
        tail = "" if code is None else f"; exit code {code}"
        return ShardWorkerDied(
            f"shard {self.shard_index} worker (pid {self.pid}) {why}"
            f"{tail}")

    def _close_channel(self):
        if self.channel is not None:
            self.channel.close()
            self.channel = None

    def terminate(self, grace_s: float = 5.0) -> Optional[int]:
        """Graceful shutdown escalation: ``shutdown`` RPC → SIGTERM →
        SIGKILL. Always reaps; returns the exit code."""
        if self.proc is None:
            return None
        if self.proc.poll() is None and not self.dead:
            try:
                self.call("shutdown", {}, timeout=grace_s)
            except (ShardWorkerDied, ShardWorkerError):
                pass
        try:
            self.proc.wait(timeout=grace_s)
        except subprocess.TimeoutExpired:
            try:
                self.proc.send_signal(signal.SIGTERM)
                self.proc.wait(timeout=grace_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        self.dead = True
        self._close_channel()
        return self.proc.returncode
