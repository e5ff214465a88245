"""Typed per-request context and the coordinator cache hierarchy.

``RequestContext`` carries what the serving layers need to know about
one request beyond its tensors: identity, deadline, admission class
(full / degraded / shed), the cache keys it resolves to, and how far
down the degradation ladder it may be pushed.

Cache keys are built from exact byte digests of the query's numpy
arrays — no canonicalisation, no term reordering, no dtype cast — so a
cache hit is *bitwise* the answer the same request would have computed
cold. The keys are byte for byte the JAX package's strings for the same
arrays. Both caches are bounded LRUs with hit/miss/eviction counters,
invalidated by index generation: every entry records the generation it
was computed under and ``purge_below()`` drops stale ones when the index
advances. Cached values are frozen (read-only) host arrays.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional, Tuple

import numpy as np

# Admission classes, in degradation-ladder order.
ADMIT_FULL = "full"          # serve the request's own method, full quality
ADMIT_DEGRADED = "degraded"  # serve the cheap splade-only plan instead
ADMIT_SHED = "shed"          # reject before it enters the queue


@dataclass(frozen=True)
class RequestContext:
    """Immutable per-request lifecycle record threaded through the stack."""

    qid: int
    method: str
    k: int
    alpha: Optional[float] = None
    t_arrival: float = 0.0
    deadline_ms: Optional[float] = None
    admission: str = ADMIT_FULL
    admit_reason: str = ""
    cache_key: Optional[str] = None   # exact result cache key
    stage1_key: Optional[str] = None  # stage-1/candidate cache key
    degrade_budget: int = 1           # how many ladder steps remain

    def degraded(self, reason: str) -> "RequestContext":
        return replace(
            self,
            admission=ADMIT_DEGRADED,
            admit_reason=reason,
            degrade_budget=max(0, self.degrade_budget - 1),
        )

    def shed(self, reason: str) -> "RequestContext":
        return replace(self, admission=ADMIT_SHED, admit_reason=reason)


def _digest(*parts: Optional[np.ndarray]) -> str:
    """blake2b over the exact bytes of the given arrays.

    The arrays are digested as they are (dtype tag, shape and raw bytes,
    no sorting or dedup), so two requests share a key only when their
    arrays are byte-identical — the precondition for a bitwise hit."""
    h = hashlib.blake2b(digest_size=16)
    for a in parts:
        if a is None:
            h.update(b"\x00none")
            continue
        arr = np.ascontiguousarray(a)
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()


def query_digest(
    q_emb: Optional[np.ndarray],
    term_ids: Optional[np.ndarray],
    term_weights: Optional[np.ndarray],
) -> str:
    """Digest of one query's arrays (dense embedding + sparse terms)."""
    return _digest(q_emb, term_ids, term_weights)


def exact_cache_key(
    digest: str, method: str, k: int, alpha: Optional[float], salt: str
) -> str:
    """Key for the exact result cache.

    ``salt`` carries every retriever-config component that changes the
    answer (backends, first_k, normalizer, PLAID knobs, index
    generation), so a config or index change never aliases onto a stale
    entry."""
    return f"x|{digest}|m={method}|k={k}|a={alpha!r}|{salt}"


def stage1_cache_key(digest: str, salt: str) -> str:
    """Key for the stage-1/candidate cache.

    Method-independent for the SPLADE-first methods: a ``splade``
    request warms the entry a later ``hybrid``/``rerank`` request
    reuses."""
    return f"s1|{digest}|{salt}"


class LRUCache:
    """Thread-safe bounded LRU with generation-scoped invalidation.

    Capacity is counted in entries; ``capacity <= 0`` disables the cache
    (gets return None without counting, puts do nothing). Values are
    stored as given: callers store read-only arrays, so a hit is served
    without a defensive copy."""

    def __init__(self, capacity: int, name: str = "lru"):
        self.capacity = int(capacity)
        self.name = name
        self._lock = threading.Lock()
        self._data: "OrderedDict[str, Tuple[int, Any]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, key: Optional[str], count_miss: bool = True) -> Optional[Any]:
        """``count_miss=False`` makes a miss free: the server's
        submit-time probe uses it, so that a request probed again at
        process time does not count the same miss twice."""
        if self.capacity <= 0 or key is None:
            return None
        with self._lock:
            ent = self._data.get(key)
            if ent is None:
                if count_miss:
                    self.misses += 1
                return None
            self._data.move_to_end(key)
            self.hits += 1
            return ent[1]

    def put(self, key: Optional[str], value: Any, generation: int = 0) -> None:
        if self.capacity <= 0 or key is None:
            return
        with self._lock:
            if key in self._data:
                self._data.move_to_end(key)
                self._data[key] = (generation, value)
                return
            self._data[key] = (generation, value)
            while len(self._data) > self.capacity:
                self._data.popitem(last=False)
                self.evictions += 1

    def purge_below(self, generation: int) -> int:
        """Drop the entries computed under an older index generation."""
        with self._lock:
            stale = [k for k, (g, _) in self._data.items() if g < generation]
            for k in stale:
                del self._data[k]
            self.invalidations += len(stale)
            return len(stale)

    def clear(self) -> None:
        with self._lock:
            self._data.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._data)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "capacity": self.capacity,
                "size": len(self._data),
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
            }


def freeze(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Read-only host copies, safe to share between the cache and its
    callers."""
    out = []
    for a in arrays:
        c = np.array(a, copy=True)
        c.setflags(write=False)
        out.append(c)
    return tuple(out)


class CacheHierarchy:
    """The coordinator's two-level cache: exact results + stage-1 rows.

    * ``exact`` — full (pids, scores) answers keyed on the exact query
      bytes + method + k + alpha + retriever salt. A hit is bitwise the
      cold answer.
    * ``stage1`` — per-query stage-1 rows: SPLADE candidates
      ``(pids_b_row, s_scores_row)`` for the SPLADE-first methods, or
      PLAID survivors ``(pids_row, n_real)`` for ``colbert``. Reused
      across the methods that share the same stage 1.
    """

    def __init__(self, exact_entries: int = 0, stage1_entries: int = 0):
        self.exact = LRUCache(exact_entries, name="exact")
        self.stage1 = LRUCache(stage1_entries, name="stage1")

    @property
    def enabled(self) -> bool:
        return self.exact.capacity > 0 or self.stage1.capacity > 0

    def purge_stale(self, current_generation: int) -> int:
        return self.exact.purge_below(current_generation) + self.stage1.purge_below(
            current_generation
        )

    def clear(self) -> None:
        self.exact.clear()
        self.stage1.clear()

    def stats(self) -> Dict[str, Dict[str, int]]:
        return {"exact": self.exact.stats(), "stage1": self.stage1.stats()}
