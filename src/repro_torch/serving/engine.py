"""Scoring engine: the per-request work unit behind the server.

The engine is stateless per request and thread-safe: the only mutable
state (the served count) is guarded. ``process_batch`` scores a
micro-batch with one batched retriever call, grouped by method.

With a :class:`~repro_torch.serving.context.CacheHierarchy` the engine
answers exact-cache hits itself (bitwise the cold answer, no kernel
launched) and runs only the misses; the retriever's plans consult the
stage-1 cache through the per-request contexts.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.multistage import MultiStageRetriever
from repro_torch.serving.context import (
    ADMIT_DEGRADED,
    ADMIT_FULL,
    CacheHierarchy,
    RequestContext,
    exact_cache_key,
    freeze,
    query_digest,
    stage1_cache_key,
)


@dataclasses.dataclass
class Request:
    qid: int
    method: str                      # colbert | splade | rerank | hybrid
    q_emb: Optional[np.ndarray] = None
    term_ids: Optional[np.ndarray] = None
    term_weights: Optional[np.ndarray] = None
    k: int = 100
    alpha: Optional[float] = None
    t_arrival: float = 0.0
    deadline_ms: Optional[float] = None   # per-request latency budget
    trace_id: Optional[int] = None        # load-trace identity (repeats)
    # typed lifecycle record (cache keys, admission class); built by
    # the engine or server on demand, carried with the request after that
    ctx: Optional[RequestContext] = None


@dataclasses.dataclass
class Result:
    qid: int
    pids: np.ndarray
    scores: np.ndarray
    t_arrival: float
    t_start: float
    t_done: float
    # admission control downgraded the request to the splade-only plan;
    # the reason code says why
    degraded: bool = False
    degrade_reason: str = ""
    cache_hit: bool = False          # answered from the exact cache

    @property
    def latency(self) -> float:
        """Client-observed latency (includes queueing) — what the paper
        reports at p95."""
        return self.t_done - self.t_arrival

    @property
    def service_time(self) -> float:
        return self.t_done - self.t_start


class ServeEngine:
    def __init__(self, retriever: MultiStageRetriever,
                 splade_backend: Optional[str] = None,
                 caches: Optional[CacheHierarchy] = None):
        """``splade_backend`` (host | device) switches the retriever's
        stage-1 scorer at construction time — a convenience for
        retrievers built elsewhere, NOT a per-engine scope: the
        retriever owns the setting, so a later ``set_splade_backend``
        (or another engine constructed over the same retriever) wins.
        ``device`` also builds the padded-postings device cache here, so
        the first request does not pay the transfer.

        ``caches``: optional :class:`CacheHierarchy`. The engine reads
        and fills the exact result cache itself; the stage-1 cache is
        attached to the retriever, whose plans consult it through the
        per-request contexts passed with each batch."""
        self.retriever = retriever
        self.caches = caches
        if caches is not None:
            retriever.attach_caches(caches)
        if splade_backend is not None:
            retriever.set_splade_backend(splade_backend)
            if splade_backend != "host":
                retriever.splade_device_cache()
        self._lock = threading.Lock()
        self.served = 0

    # -- request context & caching ---------------------------------------
    def context_for(self, req: Request) -> RequestContext:
        """Resolve a request into its typed lifecycle record.

        Cache keys are digests of the request's exact array bytes plus
        the retriever's config salt; they stay ``None`` when the engine
        has no caches, which turns off every cache path for the
        request."""
        retr = self.retriever
        alpha = req.alpha
        if alpha is None:
            alpha = retr.params.alpha
        cache_key = stage1_key = None
        if self.caches is not None and self.caches.enabled:
            exact_salt, stage1_salt = retr.cache_salts(req.method)
            digest = query_digest(req.q_emb, req.term_ids,
                                  req.term_weights)
            cache_key = exact_cache_key(digest, req.method, req.k,
                                        alpha, exact_salt)
            if req.method == "colbert":
                s1_digest = query_digest(req.q_emb, None, None)
            else:
                s1_digest = query_digest(None, req.term_ids,
                                         req.term_weights)
            stage1_key = stage1_cache_key(s1_digest, stage1_salt)
        return RequestContext(
            qid=req.qid, method=req.method, k=req.k, alpha=alpha,
            t_arrival=req.t_arrival, deadline_ms=req.deadline_ms,
            cache_key=cache_key, stage1_key=stage1_key)

    def _ensure_ctxs(self, reqs: list[Request]) -> None:
        if self.caches is None or not self.caches.enabled:
            return
        for r in reqs:
            if r.ctx is None:
                r.ctx = self.context_for(r)

    def _counter(self, name: str, delta: int = 1) -> None:
        self.retriever.pipeline_stats.counter(name, delta)

    def cache_lookup(self, req: Request,
                     count_miss: bool = True) -> Optional[Result]:
        """Exact-cache probe; a hit IS the answer (bitwise the cold
        result, frozen arrays) and counts as served. ``count_miss=False``
        for advisory probes (the server's submit fast path), so that the
        process-time probe stays the one that counts a miss."""
        caches = self.caches
        if caches is None or caches.exact.capacity <= 0:
            return None
        if req.ctx is None:
            req.ctx = self.context_for(req)
        hit = caches.exact.get(req.ctx.cache_key, count_miss=count_miss)
        if hit is None:
            return None
        pids, scores = hit
        self._counter("cache_exact_hits")
        now = time.perf_counter()
        with self._lock:
            self.served += 1
        return Result(qid=req.qid, pids=pids, scores=scores,
                      t_arrival=req.t_arrival, t_start=now, t_done=now,
                      cache_hit=True)

    def _cache_store(self, req: Request, res: Result) -> None:
        """Fill the exact cache from a full-quality answer. A degraded
        answer (the splade plan serving a hybrid or rerank request) is
        never stored under the request's key."""
        caches = self.caches
        ctx = req.ctx
        if (caches is None or caches.exact.capacity <= 0
                or ctx is None or ctx.cache_key is None
                or res.degraded or res.cache_hit
                or ctx.admission != ADMIT_FULL):
            return
        caches.exact.put(ctx.cache_key, freeze(res.pids, res.scores),
                         self.retriever.index_generation)
        self._counter("cache_exact_stores")

    @staticmethod
    def _effective_method(req: Request) -> str:
        """Admission-degraded hybrid/rerank requests run the cheap
        splade-only plan; everything else keeps its own method."""
        ctx = req.ctx
        if (ctx is not None and ctx.admission == ADMIT_DEGRADED
                and req.method in ("hybrid", "rerank")
                and req.term_ids is not None and len(req.term_ids) > 0):
            return "splade"
        return req.method

    @staticmethod
    def _degrade_info(req: Request) -> tuple:
        """(degraded, reason) of an admission downgrade."""
        ctx = req.ctx
        if ctx is not None and ctx.admission == ADMIT_DEGRADED:
            return True, ctx.admit_reason
        return False, ""

    # -- request execution -----------------------------------------------
    def process(self, req: Request) -> Result:
        hit = self.cache_lookup(req)
        if hit is not None:
            return hit
        t_start = time.perf_counter()
        pids, scores = self.retriever.search(
            self._effective_method(req), q_emb=req.q_emb,
            term_ids=req.term_ids, term_weights=req.term_weights,
            alpha=req.alpha, k=req.k)
        t_done = time.perf_counter()
        with self._lock:
            self.served += 1
        degraded, reason = self._degrade_info(req)
        res = Result(qid=req.qid, pids=pids, scores=scores,
                     t_arrival=req.t_arrival, t_start=t_start,
                     t_done=t_done, degraded=degraded,
                     degrade_reason=reason)
        self._cache_store(req, res)
        return res

    def process_batch(self, reqs: list[Request]) -> list[Result]:
        """Score a micro-batch in one batched retriever call per method
        group. Requests keep their own ``k``/``alpha``; each result
        equals what :meth:`process` returns for the request.

        Exact-cache hits are peeled off first; only the misses run the
        retriever."""
        if len(reqs) == 1:
            return [self.process(reqs[0])]
        self._ensure_ctxs(reqs)
        results: list = [None] * len(reqs)
        miss_idx = []
        for i, r in enumerate(reqs):
            hit = self.cache_lookup(r)
            if hit is not None:
                results[i] = hit
            else:
                miss_idx.append(i)
        if not miss_idx:
            return results
        miss = [reqs[i] for i in miss_idx]
        if len(miss) == 1:
            results[miss_idx[0]] = self.process(miss[0])
            return results

        t_start = time.perf_counter()
        alphas = [r.alpha for r in miss]
        pids, scores = self.retriever.search_batch(
            [self._effective_method(r) for r in miss],
            q_embs=[r.q_emb for r in miss],
            term_ids=[r.term_ids for r in miss],
            term_weights=[r.term_weights for r in miss],
            alpha=None if all(a is None for a in alphas) else alphas,
            k=max(r.k for r in miss), ctxs=[r.ctx for r in miss])
        t_done = time.perf_counter()
        with self._lock:
            self.served += len(miss)
        for j, r in enumerate(miss):
            degraded, reason = self._degrade_info(r)
            res = Result(qid=r.qid, pids=pids[j][:r.k],
                         scores=scores[j][:r.k], t_arrival=r.t_arrival,
                         t_start=t_start, t_done=t_done,
                         degraded=degraded, degrade_reason=reason)
            self._cache_store(r, res)
            results[miss_idx[j]] = res
        return results
