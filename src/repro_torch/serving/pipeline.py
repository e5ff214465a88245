"""Stage graph of one retrieval method, run synchronously.

Each method compiles to a :class:`StagePlan` — an ordered tuple of typed
:class:`Stage` steps (``splade_stage1``, ``host_gather``, the device
tail and its sync) that pass an immutable :class:`CandidateBatch`
carrier. :class:`PipelineStats` is the per-stage instrumentation record:
wall time, dispatches, queries, mmap pages and tokens touched (folded in
from ``AccessStats``) and the host/device overlap fraction.

This module is a leaf: it imports nothing from ``repro_torch.core``.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from types import MappingProxyType
from typing import Any, Callable, Mapping, Optional

import numpy as np

HOST = "host"
DEVICE = "device"

STAGE_KINDS = (HOST, DEVICE)
EWMA_ALPHA = 0.25       # weight of the newest sample in a stage's EWMA


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
    """

    method: str
    k: int
    q_embs: Optional[tuple] = None          # per-query (Lq_i, d) arrays
    term_ids: Optional[tuple] = None        # per-query (Qt_i,) arrays
    term_weights: Optional[tuple] = None
    alphas: Optional[np.ndarray] = None     # (B,) hybrid interpolation
    state: Mapping[str, Any] = _EMPTY_STATE
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
    launches and device syncs) — used for overlap accounting and
    AccessStats attribution.

    ``opens_async`` marks a stage whose device launch returns before the
    device finishes (the async window opens when the stage ends);
    ``closes_async`` marks the downstream stage whose first host touch
    waits for that work (the window closes when it starts)."""

    name: str                                  # unique within the plan
    kind: str                                  # HOST | DEVICE
    fn: Callable[..., Any]
    opens_async: bool = False
    closes_async: bool = False
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
    """

    method: str
    stages: tuple
    access_stats: Any = None   # duck-typed: needs .snapshot() -> dict

    def run_stage(self, stage: Stage, cb: CandidateBatch,
                  stats: Optional["PipelineStats"] = None) -> CandidateBatch:
        acc = self.access_stats if stage.kind == HOST else None
        before = acc.snapshot() if acc is not None else None
        if stats is not None:
            if stage.closes_async:
                stats.async_close()
            stats.stage_begin()
        t0 = time.perf_counter()
        try:
            out = stage.fn(cb)
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
                         tokens_read=tokens,
                         device_dispatches=stage.device_dispatch_count)
        return out

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

    def reset(self):
        with self._lock:
            self._stages.clear()
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
               device_dispatches: int = 0):
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
            rec.device_dispatches += device_dispatches
            ms = wall_s * 1e3
            rec.ewma_ms = (ms if rec.ewma_ms is None
                           else EWMA_ALPHA * ms
                           + (1 - EWMA_ALPHA) * rec.ewma_ms)

    def snapshot(self) -> dict:
        """Atomic copy: {"stages": {name: record-dict}, "busy_s": ...,
        "overlap_s": ..., "overlap_fraction": ...}."""
        with self._lock:
            stages = {n: r.as_dict() for n, r in self._stages.items()}
            busy, over = self._busy_any_s, self._overlap_s
        return {"stages": stages, "busy_s": busy, "overlap_s": over,
                "overlap_fraction": over / busy if busy > 0 else 0.0}
