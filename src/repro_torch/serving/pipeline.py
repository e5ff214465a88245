"""Stage graph of one retrieval method, run synchronously or pipelined.

Each method compiles to a :class:`StagePlan` — an ordered tuple of typed
:class:`Stage` steps (``splade_stage1``, ``host_gather``, the device
tail and its sync) that pass an immutable :class:`CandidateBatch`
carrier. :class:`PipelineStats` is the per-stage instrumentation record:
wall time, dispatches, queries, queue wait, mmap pages and tokens
touched (folded in from ``AccessStats``), the host/device overlap
fraction, and named counters (cache hits and misses, admission
outcomes).

:class:`PipelineExecutor` runs a plan with ``depth`` micro-batches in
flight, so that micro-batch N+1's host mmap gather overlaps micro-batch
N's device work. On a CUDA device it owns one stream: every stage it
runs launches there, and a batch's closing stage waits for the event
its launching stage recorded, not for the younger batches' work queued
on the stream behind it.

This module is a leaf: it imports nothing from ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from concurrent.futures import Future
from types import MappingProxyType
from typing import Any, Callable, Mapping, Optional

import numpy as np
import torch

from repro_torch.common import resolve_device

HOST = "host"
DEVICE = "device"

STAGE_KINDS = (HOST, DEVICE)
EWMA_ALPHA = 0.25       # weight of the newest sample in a stage's EWMA


class PipelineStopped(RuntimeError):
    """Raised into futures whose CandidateBatch was still in flight (or
    still queued) when the executor stopped, and by ``submit`` on a
    stopped executor."""


# ---------------------------------------------------------------------------
# carrier
# ---------------------------------------------------------------------------

_EMPTY_STATE: Mapping[str, Any] = MappingProxyType({})


@dataclasses.dataclass(frozen=True)
class CandidateBatch:
    """Immutable carrier passed between stages.

    Stages never mutate a batch: they return a new instance via
    :meth:`evolve` / :meth:`with_state`. ``state`` holds named
    intermediate products (candidate sets, gathered codes/residuals,
    device scores); ``pids``/``scores`` are the final per-query results
    filled in by the terminal stage.

    ``shard_states`` is the batch's *shard axis*: under a sharded index
    each fanout stage writes one state mapping per shard, read back by
    the next fanout stage (same shard slot) or by a ``merge_topk`` stage
    that combines the shards' candidates into global results.
    """

    method: str
    k: int
    q_embs: Optional[tuple] = None          # per-query (Lq_i, d) arrays
    term_ids: Optional[tuple] = None        # per-query (Qt_i,) arrays
    term_weights: Optional[tuple] = None
    alphas: Optional[np.ndarray] = None     # (B,) hybrid interpolation
    ctxs: Optional[tuple] = None            # per-query RequestContext
    state: Mapping[str, Any] = _EMPTY_STATE
    shard_states: Optional[tuple] = None    # per-shard state mappings
    pids: Optional[np.ndarray] = None       # (B, k) final, -1 padded
    scores: Optional[np.ndarray] = None     # (B, k) final, desc

    @property
    def n_queries(self) -> int:
        for seq in (self.q_embs, self.term_ids):
            if seq is not None:
                return len(seq)
        return 0

    def evolve(self, **fields) -> "CandidateBatch":
        return dataclasses.replace(self, **fields)

    def with_state(self, **kv) -> "CandidateBatch":
        merged = dict(self.state)
        merged.update(kv)
        return dataclasses.replace(self, state=MappingProxyType(merged))


# ---------------------------------------------------------------------------
# stages and plans
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Stage:
    """One typed step of a plan. ``kind`` declares what the stage binds
    on (``host``: mmap gathers / numpy passes; ``device``: kernel
    launches and device syncs) — used for worker placement by the
    executor's ``kind`` workers, overlap accounting and AccessStats
    attribution.

    ``opens_async`` marks a stage whose device launch returns before the
    device finishes (the async window opens when the stage ends): it
    enqueues the copy of its result to the host and records an event
    after it. ``closes_async`` marks the downstream stage whose first
    host touch waits for that event (the window closes when it starts).
    The executor's single worker parks a batch at its ``closes_async``
    stage while younger batches still have stages to run before theirs,
    so the device works on batch N while the host works on batch N+1.

    ``fanout > 0`` declares a *sharded* stage: ``fn(cb, shard)`` runs
    once per shard and returns that shard's new state mapping, and the
    plan assembles the results into ``cb.shard_states``. With ``pooled``
    (and a plan ``pool``) the per-shard calls run concurrently on the
    pool's threads: only host stages are pooled (the mmap gathers, whose
    copies and page faults release the GIL), since a pool thread's
    current CUDA stream is not the executor's. Device fanout stages run
    the shards in order on the calling thread."""

    name: str                                  # unique within the plan
    kind: str                                  # HOST | DEVICE
    fn: Callable[..., Any]
    opens_async: bool = False
    closes_async: bool = False
    fanout: int = 0                            # >0: per-shard execution
    pooled: bool = False                       # fanout on the plan's pool
    device_dispatches: Optional[int] = None    # declared launches/run

    def __post_init__(self):
        if self.kind not in STAGE_KINDS:
            raise ValueError(f"stage kind {self.kind!r} not in "
                             f"{STAGE_KINDS}")

    @property
    def device_dispatch_count(self) -> int:
        """Device launches this stage makes per execution, declared at
        plan-build time; defaults to 1 for device stages and 0 for host
        stages."""
        if self.device_dispatches is not None:
            return self.device_dispatches
        return 1 if self.kind == DEVICE else 0


@dataclasses.dataclass(frozen=True)
class StagePlan:
    """An ordered stage graph for one retrieval method.

    ``access_stats``, when set (the mmap store's ``AccessStats``), is
    snapshotted around host-kind stages so pages/tokens touched are
    attributed per stage.

    ``pool`` (duck-typed: needs ``.map``) runs the per-shard calls of
    ``pooled`` fanout stages concurrently; without one they run in shard
    order.
    """

    method: str
    stages: tuple
    access_stats: Any = None   # duck-typed: needs .snapshot() -> dict
    pool: Any = None           # duck-typed: needs .map (fanout stages)

    def stage_names(self) -> tuple:
        return tuple(s.name for s in self.stages)

    def run_stage(self, stage: Stage, cb: CandidateBatch,
                  stats: Optional["PipelineStats"] = None,
                  queue_wait_s: float = 0.0) -> CandidateBatch:
        acc = self.access_stats if stage.kind == HOST else None
        before = acc.snapshot() if acc is not None else None
        if stats is not None:
            if stage.closes_async:
                stats.async_close()
            stats.stage_begin()
        t0 = time.perf_counter()
        try:
            out = self._call_stage(stage, cb)
        finally:
            wall = time.perf_counter() - t0
            if stats is not None:
                stats.stage_end()
        if stats is not None:
            if stage.opens_async:
                stats.async_open()
            pages = tokens = 0
            if before is not None:
                after = acc.snapshot()
                pages = after["pages_touched"] - before["pages_touched"]
                tokens = after["tokens_read"] - before["tokens_read"]
            stats.record(stage.name, stage.kind, wall,
                         queries=cb.n_queries, pages_touched=pages,
                         tokens_read=tokens, queue_wait_s=queue_wait_s,
                         device_dispatches=stage.device_dispatch_count
                         * max(1, stage.fanout))
        return out

    def _call_stage(self, stage: Stage, cb: CandidateBatch):
        """Plain stages run ``fn(cb)``; fanout stages run ``fn(cb, shard)``
        once per shard (on the pool when the stage is ``pooled`` and the
        plan has one) and put the returned mappings on the batch's shard
        axis. A shard that raises fails this batch only: the executor
        fails its future and the other batches in flight go on."""
        if not stage.fanout:
            return stage.fn(cb)
        shards = range(stage.fanout)
        if stage.pooled and self.pool is not None:
            outs = list(self.pool.map(lambda i: stage.fn(cb, i), shards))
        else:
            outs = [stage.fn(cb, i) for i in shards]
        return cb.evolve(shard_states=tuple(outs))

    def run(self, cb: CandidateBatch,
            stats: Optional["PipelineStats"] = None) -> CandidateBatch:
        """Synchronous execution of every stage in order.

        A batch that dies between its ``opens_async`` and
        ``closes_async`` stages (a failed device sync) must balance the
        async window on the way out, or the shared overlap accounting
        would count "dispatch in flight" forever after one failure."""
        window_open = False
        try:
            for stage in self.stages:
                if stage.closes_async:
                    window_open = False    # run_stage closes it up front
                cb = self.run_stage(stage, cb, stats)
                if stage.opens_async:
                    window_open = True
            return cb
        except BaseException:
            if window_open and stats is not None:
                stats.async_close()
            raise


# ---------------------------------------------------------------------------
# instrumentation: per-stage timing + AccessStats record
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StageRecord:
    kind: str = HOST
    wall_s: float = 0.0
    dispatches: int = 0
    queries: int = 0
    queue_wait_s: float = 0.0            # waited for a worker, summed
    pages_touched: int = 0
    tokens_read: int = 0
    device_dispatches: int = 0           # declared device launches
    ewma_ms: Optional[float] = None      # EWMA of per-dispatch wall time

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


class PipelineStats:
    """Thread-safe per-stage instrumentation shared by every thread
    that runs a plan.

    Overlap accounting: each stage is bracketed by
    ``stage_begin``/``stage_end``, and device launches open an *async
    window* (``async_open`` when the launching stage ends,
    ``async_close`` when the consuming sync stage starts). Time accrues
    to ``overlap_s`` whenever >= 2 stages execute simultaneously or a
    stage executes while a launch is in flight. The *overlap fraction*
    is overlapped time over any-stage-busy time: 0.0 when execution is
    strictly serial.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._stages: dict[str, StageRecord] = {}
        self._busy = 0
        self._async = 0
        self._t_mark: Optional[float] = None
        self._busy_any_s = 0.0
        self._overlap_s = 0.0
        self._counters: dict[str, int] = {}

    def reset(self):
        with self._lock:
            self._stages.clear()
            self._counters.clear()
            self._busy = 0
            self._async = 0
            self._t_mark = None
            self._busy_any_s = 0.0
            self._overlap_s = 0.0

    # -- overlap ---------------------------------------------------------
    def _tick(self, now: float):
        if self._t_mark is not None and self._busy > 0:
            dt = now - self._t_mark
            self._busy_any_s += dt
            if self._busy >= 2 or self._async >= 1:
                self._overlap_s += dt
        self._t_mark = now

    def stage_begin(self):
        with self._lock:
            self._tick(time.perf_counter())
            self._busy += 1

    def stage_end(self):
        with self._lock:
            self._tick(time.perf_counter())
            self._busy = max(0, self._busy - 1)

    def async_open(self):
        """A device dispatch went in flight (lazy results outstanding)."""
        with self._lock:
            self._tick(time.perf_counter())
            self._async += 1

    def async_close(self):
        """The consuming stage is about to block on those results."""
        with self._lock:
            self._tick(time.perf_counter())
            self._async = max(0, self._async - 1)

    # -- records ---------------------------------------------------------
    def record(self, name: str, kind: str, wall_s: float, *,
               queries: int = 0, dispatches: int = 1,
               pages_touched: int = 0, tokens_read: int = 0,
               queue_wait_s: float = 0.0, device_dispatches: int = 0):
        with self._lock:
            rec = self._stages.get(name)
            if rec is None:
                rec = self._stages[name] = StageRecord(kind=kind)
            rec.kind = kind
            rec.wall_s += wall_s
            rec.dispatches += dispatches
            rec.queries += queries
            rec.pages_touched += pages_touched
            rec.tokens_read += tokens_read
            rec.queue_wait_s += queue_wait_s
            rec.device_dispatches += device_dispatches
            ms = wall_s * 1e3
            rec.ewma_ms = (ms if rec.ewma_ms is None
                           else EWMA_ALPHA * ms
                           + (1 - EWMA_ALPHA) * rec.ewma_ms)

    def counter(self, name: str, delta: int = 1):
        """Bump a named monotonic counter (cache hits and misses,
        admission outcomes); surfaced in :meth:`snapshot` under
        ``"counters"``."""
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + delta

    def snapshot(self) -> dict:
        """Atomic copy: {"stages": {name: record-dict}, "busy_s": ...,
        "overlap_s": ..., "overlap_fraction": ..., "counters": ...}."""
        with self._lock:
            stages = {n: r.as_dict() for n, r in self._stages.items()}
            busy, over = self._busy_any_s, self._overlap_s
            counters = dict(self._counters)
        return {"stages": stages, "busy_s": busy, "overlap_s": over,
                "overlap_fraction": over / busy if busy > 0 else 0.0,
                "counters": counters}


# ---------------------------------------------------------------------------
# executor
# ---------------------------------------------------------------------------

class _Job:
    __slots__ = ("cb", "future", "idx", "t_enq", "async_open")

    def __init__(self, cb: CandidateBatch, future: Future, t_enq: float):
        self.cb = cb
        self.future = future
        self.idx = 0                       # next stage to run
        self.t_enq = t_enq
        self.async_open = False            # opened an unclosed async window


WORKER_MODES = ("single", "kind")


class PipelineExecutor:
    """Runs a :class:`StagePlan` with ``depth`` micro-batches in flight.

    ``submit`` feeds the pipeline head and returns a Future resolved at
    the tail with the finished :class:`CandidateBatch`. At most
    ``depth`` batches are admitted: when the pipeline is full,
    ``submit`` *blocks* — producers are backpressured and in-flight
    memory is bounded.

    Two scheduling modes (``workers``):

    * ``"single"`` (default) — one worker thread, software-pipelined:
      it runs every stage, but *parks* a batch at its ``closes_async``
      stage (the wait for its device result) while younger batches
      still have stages to run before theirs, so the device works on
      batch N while the worker gathers batch N+1.
    * ``"kind"`` — one worker per stage *kind* (host-gather worker +
      device worker) connected by FIFO queues; the host gathers (numpy
      fancy indexing and page faults, which release the GIL) then run
      beside the device stages. Queue occupancy is capped by the
      admission semaphore, so the hand-off cannot deadlock.

    ``device``: where the plan's device stages run. On a CUDA device the
    executor owns one ``torch.cuda.Stream`` (:attr:`stream`), made to
    wait at creation for the work queued on the creating thread's
    current stream (the device state the engine built), and every stage
    runs with it as the worker thread's current stream. On the CPU
    :attr:`stream` is None and the same scheduling code runs.

    ``stop()`` fails still-queued batches with :class:`PipelineStopped`;
    the batch a worker is mid-stage on finishes that stage and then
    fails (or resolves, if it was the last stage) — every submitted
    future resolves or fails, none hangs. :attr:`stopped` is set as
    ``stop()`` begins.
    """

    def __init__(self, plan: StagePlan, depth: int = 2,
                 stats: Optional[PipelineStats] = None, workers: str = "single",
                 device="cuda"):
        if not plan.stages:
            raise ValueError("empty StagePlan")
        if workers not in WORKER_MODES:
            raise ValueError(f"workers {workers!r} not in {WORKER_MODES}")
        self.plan = plan
        self.depth = max(1, int(depth))
        self.stats = stats
        self.mode = workers
        self.device = resolve_device(device)
        self.stream = None
        if self.device.type == "cuda":
            self.stream = torch.cuda.Stream(device=self.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.device))
        self.stopped = threading.Event()
        self._sem = threading.Semaphore(self.depth)   # admission permits
        self._cond = threading.Condition()
        self._inflight = 0
        self._qlock = threading.Lock()
        self._queued = {st.name: 0 for st in plan.stages}
        label = plan.method
        self.workers: list[threading.Thread] = []
        if workers == "single":
            self._intake: queue.Queue = queue.Queue()
            targets = [(self._worker_single, (), f"pipe-{label}")]
        else:
            kinds = list(dict.fromkeys(st.kind for st in plan.stages))
            self._queues = {kind: queue.Queue() for kind in kinds}
            targets = [(self._worker_kind, (kind,), f"pipe-{label}-{kind}")
                       for kind in kinds]
        for target, args, tname in targets:
            t = threading.Thread(target=target, args=args, name=tname,
                                 daemon=True)
            t.start()
            self.workers.append(t)

    @property
    def running(self) -> bool:
        return not self.stopped.is_set()

    # -- producer side ---------------------------------------------------
    def submit(self, cb: CandidateBatch) -> Future:
        if not self.running:
            raise PipelineStopped("executor is stopped")
        while not self._sem.acquire(timeout=0.05):   # backpressure
            if not self.running:
                raise PipelineStopped("executor stopped")
        if not self.running:
            self._sem.release()
            raise PipelineStopped("executor stopped")
        fut: Future = Future()
        fut.set_running_or_notify_cancel()   # internal: never cancelled
        job = _Job(cb, fut, time.perf_counter())
        with self._cond:
            self._inflight += 1
        self._mark_queued(job.idx, +1)
        if self.mode == "single":
            self._intake.put(job)
        else:
            self._queues[self.plan.stages[job.idx].kind].put(job)
        if not self.running:
            # raced stop(): its drain may already have passed this queue,
            # so drain again — get_nowait makes each job fail exactly once
            self._fail_queued()
        return fut

    def _mark_queued(self, idx: int, delta: int):
        with self._qlock:
            self._queued[self.plan.stages[idx].name] += delta

    # -- single-worker software pipelining -------------------------------
    def _next_job(self, jobs: list) -> _Job:
        """Lookahead schedule: advance the oldest batch that is NOT
        parked at its device-result wait; if every admitted batch is
        parked (or there is just one), advance the oldest — by then its
        device work has had the younger batches' stages to complete.
        Plans without ``closes_async`` stages run FIFO."""
        for job in jobs:
            if not self.plan.stages[job.idx].closes_async:
                return job
        return jobs[0]

    def _admit(self, jobs: list):
        """Admit available batches. When every admitted batch is parked
        at its device-result wait (and there is admission room), wait a
        moment for fresh work before blocking on a wait: under load the
        producer's next batch arrives within microseconds, and running
        its stages first keeps the parked batches' device work hidden."""
        while True:
            if not jobs:
                block, timeout = True, 0.05
            elif (len(jobs) < self.depth
                  and all(self.plan.stages[j.idx].closes_async
                          for j in jobs)):
                block, timeout = True, 0.002
            else:
                block, timeout = False, None
            try:
                jobs.append(self._intake.get(block=block, timeout=timeout))
            except queue.Empty:
                return

    def _worker_single(self):
        jobs: list[_Job] = []
        while True:
            self._admit(jobs)
            if not jobs:
                if not self.running:
                    return
                continue
            if not self.running:
                for job in jobs:
                    self._mark_queued(job.idx, -1)
                    self._finish(job, exc=PipelineStopped(
                        "executor stopped mid-flight"))
                jobs.clear()
                continue
            job = self._next_job(jobs)
            if self._advance(job):
                jobs.remove(job)

    # -- shared stage step -----------------------------------------------
    def _advance(self, job: _Job) -> bool:
        """Run the job's next stage on the calling worker, on the
        executor's stream (queued-count, queue-wait and async-window
        bookkeeping included). Returns True when the job left the
        pipeline (finished or failed); False when it advanced to the
        next stage — already marked queued, but not yet handed to a
        worker queue."""
        stage = self.plan.stages[job.idx]
        self._mark_queued(job.idx, -1)
        wait_s = time.perf_counter() - job.t_enq
        if stage.closes_async:
            job.async_open = False         # run_stage closes the window
        try:
            with torch.cuda.stream(self.stream):   # no-op on the CPU
                cb = self.plan.run_stage(stage, job.cb, self.stats,
                                         queue_wait_s=wait_s)
        except Exception as e:
            self._finish(job, exc=e)
            return True
        if stage.opens_async:
            job.async_open = True
        job.idx += 1
        if job.idx == len(self.plan.stages):
            self._finish(job, cb=cb)
            return True
        job.cb = cb
        job.t_enq = time.perf_counter()
        self._mark_queued(job.idx, +1)
        return False

    # -- kind-threaded workers -------------------------------------------
    def _worker_kind(self, kind: str):
        q = self._queues[kind]
        while True:
            try:
                job = q.get(timeout=0.05)
            except queue.Empty:
                if not self.running:
                    return
                continue
            if not self.running:
                self._mark_queued(job.idx, -1)
                self._finish(job, exc=PipelineStopped(
                    "executor stopped before stage "
                    f"{self.plan.stages[job.idx].name!r}"))
                continue
            if not self._advance(job):
                self._queues[self.plan.stages[job.idx].kind].put(job)
                if not self.running:
                    # raced stop(): a worker that outlived the join (a
                    # long mid-stage gather) must not strand the job in
                    # a queue nobody reads — drain-and-fail it now
                    self._fail_queued()

    def _finish(self, job: _Job, cb: Optional[CandidateBatch] = None,
                exc: Optional[BaseException] = None):
        if job.async_open and self.stats is not None:
            # the batch dies between its opens_async and closes_async
            # stages (stage error / shutdown): balance the window so the
            # shared overlap accounting cannot stick at "in flight"
            job.async_open = False
            self.stats.async_close()
        if exc is not None:
            job.future.set_exception(exc)
        else:
            job.future.set_result(cb)
        self._sem.release()
        with self._cond:
            self._inflight -= 1
            self._cond.notify_all()

    # -- lifecycle / introspection --------------------------------------
    def drain(self, timeout: Optional[float] = None) -> bool:
        """Wait until no batches are in flight; False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: self._inflight == 0,
                                       timeout)

    def queue_depths(self) -> dict:
        """Batches currently waiting per stage (not executing)."""
        with self._qlock:
            return dict(self._queued)

    def stop(self):
        """Stop workers; every in-flight future resolves (if its last
        stage already ran) or fails with :class:`PipelineStopped`."""
        self.stopped.set()
        for t in self.workers:
            t.join(timeout=5.0)
        self.workers.clear()
        self._fail_queued()

    def _fail_queued(self):
        """Fail whatever still sits in the queues (shared by ``stop``
        and a ``submit`` that raced it; ``get_nowait`` guarantees each
        job is finished exactly once)."""
        leftovers = ([self._intake] if self.mode == "single"
                     else list(self._queues.values()))
        for q in leftovers:
            while True:
                try:
                    job = q.get_nowait()
                except queue.Empty:
                    break
                self._mark_queued(job.idx, -1)
                self._finish(job, exc=PipelineStopped(
                    "executor stopped with the batch still queued"))


def gather_futures(futs: list) -> Future:
    """Aggregate Futures into one resolving with the list of results
    (in order) once all complete, or failing with the first exception."""
    out: Future = Future()
    out.set_running_or_notify_cancel()
    if not futs:
        out.set_result([])
        return out
    remaining = [len(futs)]
    lock = threading.Lock()

    def on_done(_f):
        with lock:
            remaining[0] -= 1
            if remaining[0]:
                return
        for f in futs:
            e = f.exception()
            if e is not None:
                out.set_exception(e)
                return
        out.set_result([f.result() for f in futs])

    for f in futs:
        f.add_done_callback(on_done)
    return out
