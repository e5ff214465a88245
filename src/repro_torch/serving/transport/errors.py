"""Shard-transport error taxonomy.

Two failure classes cross the RPC seam, and the distinction is
load-bearing for the heal logic of a process shard group:

* :class:`ShardWorkerDied` — the *transport* failed (EOF, reset,
  timeout, arena peer gone, nonzero exit). The worker process behind
  the shard is unusable; the group heals by respawning it on next use.
* :class:`ShardWorkerError` — a stage op raised *inside* a healthy
  worker (or a soft deadline expired while it was merely busy). The
  worker keeps serving; nothing is respawned.

The classes and their bases are the JAX package's
``serving/transport/errors.py``: callers catch by these bases.
"""

from __future__ import annotations


class ShardWorkerDied(RuntimeError):
    """The worker process behind a shard is gone (EOF, reset, timeout,
    or a nonzero exit) — the current batch has no answer for that
    shard. The group heals by respawning the worker on next use."""


class ShardWorkerError(RuntimeError):
    """A stage op raised *inside* a healthy worker; the worker keeps
    serving. Carries the remote traceback text."""


class ArenaDead(ConnectionError):
    """A shared-memory arena operation cannot complete because the peer
    is gone (or the ring stayed full past its deadline). Subclasses
    ConnectionError so every transport-death path maps to
    :class:`ShardWorkerDied` in the client."""


class DeadlineExceeded(ConnectionError):
    """A per-op deadline (``timeout_ms``) expired before the worker
    answered. Subclasses ConnectionError: a worker that blows an
    explicit deadline is indistinguishable from a hung transport, so
    the replica router treats it as a failover trigger. The connection
    is torn down (replies behind the expired one would desequence the
    FIFO otherwise)."""


class ShardUnavailable(ShardWorkerDied):
    """Every replica of a shard is dead or quarantined — there is no
    sibling left to fail over to. Subclasses :class:`ShardWorkerDied`
    so existing broad handlers keep working; carries the shard index
    and the last per-replica error for diagnostics."""

    def __init__(self, message: str, *, shard: int = -1,
                 last_error: BaseException | None = None):
        super().__init__(message)
        self.shard = shard
        self.last_error = last_error
