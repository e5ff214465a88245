"""Scoring engine: the per-request work unit behind the server.

The engine is stateless per request and thread-safe: the only mutable
state (the served count) is guarded. ``process_batch`` scores a
micro-batch with one batched retriever call, grouped by method.

With a :class:`~repro_torch.serving.context.CacheHierarchy` the engine
answers exact-cache hits itself (bitwise the cold answer, no kernel
launched) and runs only the misses; the retriever's plans consult the
stage-1 cache through the per-request contexts.

With ``pipeline_depth >= 2`` the engine runs micro-batches through the
stage pipeline (:class:`~repro_torch.serving.pipeline.PipelineExecutor`,
one per method, each on its own CUDA stream on the card), so that
micro-batch N+1's host mmap gather overlaps micro-batch N's device
work. ``process_batch_async`` feeds the pipeline head and returns a
Future resolved at the tail; ``pipeline_depth=1`` (default) keeps the
synchronous path. Both give the same answers bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from concurrent.futures import Future
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
from repro_torch.serving.pipeline import (
    WORKER_MODES,
    PipelineExecutor,
    PipelineStopped,
    gather_futures,
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
                 caches: Optional[CacheHierarchy] = None,
                 pipeline_depth: int = 1,
                 pipeline_workers: str = "single"):
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
        per-request contexts passed with each batch.

        ``pipeline_depth``: 1 = synchronous batches; >= 2 = the stage
        pipeline with that many batches in flight per method.
        ``pipeline_workers``: the executors' scheduling mode,
        ``"single"`` (software pipelining) or ``"kind"`` (a host and a
        device worker thread; see ``PipelineExecutor``)."""
        if pipeline_workers not in WORKER_MODES:
            raise ValueError(f"pipeline_workers {pipeline_workers!r} not "
                             f"in {WORKER_MODES}")
        self.retriever = retriever
        self.caches = caches
        if caches is not None:
            retriever.attach_caches(caches)
        if splade_backend is not None:
            retriever.set_splade_backend(splade_backend)
            if splade_backend != "host":
                retriever.splade_device_cache()
        self.pipeline_depth = max(1, pipeline_depth)
        self.pipeline_workers = pipeline_workers
        self._pipelines: dict = {}
        self._plock = threading.Lock()
        self._closed = False
        self._lock = threading.Lock()
        self.served = 0

    # -- pipelining ------------------------------------------------------
    @property
    def pipelined(self) -> bool:
        # a live (mutable) retriever must stay synchronous: executors
        # hold compiled plans across batches, and a mutation mid-flight
        # would race the stage graph
        return (self.pipeline_depth > 1
                and getattr(self.retriever, "live", None) is None)

    def _pipeline(self, method: str) -> PipelineExecutor:
        """Per-method executor over the method's compiled plan, built
        lazily and rebuilt if the plan changed (a stage-1 or rerank
        backend switch compiles another plan). The stale executor is
        stopped OUTSIDE the registry lock — stop() joins worker threads,
        and holding ``_plock`` across that would stall health() and
        every concurrent dispatch."""
        plan = self.retriever.compile_plan(method)   # validates method
        stale = None
        try:
            with self._plock:
                if self._closed:
                    raise PipelineStopped("engine closed")
                px = self._pipelines.get(method)
                if px is not None and (px.plan is not plan
                                       or not px.running):
                    stale, px = px, None
                if px is None:
                    px = PipelineExecutor(
                        plan, depth=self.pipeline_depth,
                        stats=self.retriever.pipeline_stats,
                        workers=self.pipeline_workers,
                        device=self.retriever.device)
                    self._pipelines[method] = px
                return px
        finally:
            if stale is not None and stale.running:
                stale.stop()

    def drain_pipelines(self, timeout: Optional[float] = None) -> bool:
        """Wait until no micro-batch is in flight in any executor;
        False if ``timeout`` (seconds, for all of them) ran out."""
        with self._plock:
            pipes = list(self._pipelines.values())
        deadline = None if timeout is None else time.perf_counter() + timeout
        for px in pipes:
            left = (None if deadline is None
                    else max(0.0, deadline - time.perf_counter()))
            if not px.drain(left):
                return False
        return True

    def stop_pipelines(self):
        """Stop the stage workers; in-flight micro-batches resolve or
        fail their futures (PipelineStopped). The engine stays usable —
        the next pipelined batch builds its executor anew — so a server
        can stop() and start() again over the same engine."""
        with self._plock:
            pipes = list(self._pipelines.values())
            self._pipelines.clear()
        for px in pipes:
            px.stop()

    def close(self):
        """stop_pipelines() and refuse to build new executors. Terminal."""
        with self._plock:
            self._closed = True
        self.stop_pipelines()

    def pipeline_health(self) -> dict:
        """Executor vitals: queue depths per stage, per method. (Per-stage
        timing, queue waits, pages and overlap live in the retriever's
        ``pipeline_stats`` snapshot, which ``RetrievalServer.health``
        reports.)"""
        with self._plock:            # _pipeline() inserts concurrently
            pipes = dict(self._pipelines)
        return {"depth": self.pipeline_depth,
                "queues": {m: px.queue_depths()
                           for m, px in pipes.items()}}

    # -- live index ------------------------------------------------------
    def live_upsert(self, doc_emb, term_ids, term_weights,
                    doc_len=None) -> int:
        """Append one document to the live index → its global pid. The
        retriever refuses while its index is frozen."""
        return self.retriever.live_upsert(doc_emb, term_ids, term_weights,
                                          doc_len)

    def live_delete(self, pid: int) -> bool:
        return self.retriever.live_delete(pid)

    def live_compact(self):
        return self.retriever.compact_live()

    def live_stats(self):
        return self.retriever.live_stats()

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

    def process_batch_async(self, reqs: list[Request]) -> Future:
        """Feed a micro-batch to the stage pipeline; the returned Future
        resolves with the ``list[Result]`` at the pipeline tail.

        Per-request results equal :meth:`process_batch`'s bit for bit: a
        single-method batch runs its plan as one CandidateBatch; a mixed
        batch is grouped per method, each group submitted to its
        method's executor, and the results scattered back into request
        order as the synchronous mixed path does. Exact-cache hits are
        peeled off first; a batch of hits only resolves at once and runs
        no stage. ``submit`` blocks while an executor is full, so callers
        are backpressured by ``pipeline_depth``."""
        out: Future = Future()
        out.set_running_or_notify_cancel()
        if not self.pipelined:
            try:
                out.set_result(self.process_batch(reqs))
            except Exception as e:
                out.set_exception(e)
            return out

        self._ensure_ctxs(reqs)
        hits: list = [None] * len(reqs)
        miss_idx = []
        for i, r in enumerate(reqs):
            hit = self.cache_lookup(r)
            if hit is not None:
                hits[i] = hit
            else:
                miss_idx.append(i)
        if not miss_idx:
            out.set_result(hits)
            return out
        miss = [reqs[i] for i in miss_idx]

        t_start = time.perf_counter()
        n = len(miss)
        k_max = max(r.k for r in miss)
        retr = self.retriever
        methods = [self._effective_method(r) for r in miss]
        raw_alphas = [r.alpha for r in miss]
        alphas = retr._alpha_array(
            None if all(a is None for a in raw_alphas) else raw_alphas, n)
        groups = []                      # (method, idx, CandidateBatch)
        for m in dict.fromkeys(methods):
            idx = [i for i, mi in enumerate(methods) if mi == m]
            cb = retr.build_batch(
                m, q_embs=[miss[i].q_emb for i in idx],
                term_ids=[miss[i].term_ids for i in idx],
                term_weights=[miss[i].term_weights for i in idx],
                alphas=alphas[idx], k=k_max,
                ctxs=[miss[i].ctx for i in idx])
            groups.append((m, idx, cb))

        futs = []
        try:
            # resolve every group's executor BEFORE submitting any work:
            # an unknown method then fails the batch without first
            # running (and throwing away) the valid groups' retrieval
            pipes = [self._pipeline(m) for m, _, _ in groups]
            for px, (_, _, cb) in zip(pipes, groups):
                futs.append(px.submit(cb))
        except Exception as e:
            # submit-time failure (unknown method, stopped pipeline):
            # fail the whole batch; the server retries request by request
            out.set_exception(e)
            return out

        def finish(f: Future):
            e = f.exception()
            if e is not None:
                out.set_exception(e)
                return
            try:
                assembled = self._assemble(miss, groups, f.result(), n,
                                           k_max, t_start)
            except Exception as err:
                out.set_exception(err)
                return
            for j, res in enumerate(assembled):
                hits[miss_idx[j]] = res
            out.set_result(hits)

        gather_futures(futs).add_done_callback(finish)
        return out

    def _assemble(self, reqs, groups, cbs, n: int, k_max: int,
                  t_start: float) -> list[Result]:
        """The tail of :meth:`process_batch_async`: the groups' answers
        in request order, cut to each request's k, stored in the exact
        cache where they are full quality."""
        if len(groups) == 1:
            pids, scores = cbs[0].pids, cbs[0].scores
        else:
            pids = np.full((n, k_max), -1, np.int64)
            scores = np.full((n, k_max), -np.inf, np.float32)
            for (_, idx, _), cb in zip(groups, cbs):
                MultiStageRetriever.scatter_group(pids, scores, idx,
                                                  cb.pids, cb.scores)
        t_done = time.perf_counter()
        with self._lock:
            self.served += n
        out = []
        for i, r in enumerate(reqs):
            degraded, reason = self._degrade_info(r)
            res = Result(qid=r.qid, pids=pids[i][:r.k],
                         scores=scores[i][:r.k], t_arrival=r.t_arrival,
                         t_start=t_start, t_done=t_done,
                         degraded=degraded, degrade_reason=reason)
            self._cache_store(r, res)
            out.append(res)
        return out
