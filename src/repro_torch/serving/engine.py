"""Scoring engine: the per-request work unit behind the server.

The engine is stateless per request and thread-safe: the only mutable
state (the served count) is guarded. ``process_batch`` scores a
micro-batch with one batched retriever call, grouped by method.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np

from repro_torch.core.multistage import MultiStageRetriever


@dataclasses.dataclass
class Request:
    qid: int
    method: str                      # splade | rerank | hybrid
    q_emb: Optional[np.ndarray] = None
    term_ids: Optional[np.ndarray] = None
    term_weights: Optional[np.ndarray] = None
    k: int = 100
    alpha: Optional[float] = None
    t_arrival: float = 0.0


@dataclasses.dataclass
class Result:
    qid: int
    pids: np.ndarray
    scores: np.ndarray
    t_arrival: float
    t_start: float
    t_done: float

    @property
    def latency(self) -> float:
        """Client-observed latency (includes queueing) — what the paper
        reports at p95."""
        return self.t_done - self.t_arrival

    @property
    def service_time(self) -> float:
        return self.t_done - self.t_start


class ServeEngine:
    def __init__(self, retriever: MultiStageRetriever):
        self.retriever = retriever
        self._lock = threading.Lock()
        self.served = 0

    def process(self, req: Request) -> Result:
        t_start = time.perf_counter()
        pids, scores = self.retriever.search(
            req.method, q_emb=req.q_emb, term_ids=req.term_ids,
            term_weights=req.term_weights, alpha=req.alpha, k=req.k)
        t_done = time.perf_counter()
        with self._lock:
            self.served += 1
        return Result(qid=req.qid, pids=pids, scores=scores,
                      t_arrival=req.t_arrival, t_start=t_start,
                      t_done=t_done)

    def process_batch(self, reqs: list[Request]) -> list[Result]:
        """Score a micro-batch in one batched retriever call per method
        group. Requests keep their own ``k``/``alpha``; each result
        equals what :meth:`process` returns for the request."""
        if len(reqs) == 1:
            return [self.process(reqs[0])]
        t_start = time.perf_counter()
        alphas = [r.alpha for r in reqs]
        pids, scores = self.retriever.search_batch(
            [r.method for r in reqs],
            q_embs=[r.q_emb for r in reqs],
            term_ids=[r.term_ids for r in reqs],
            term_weights=[r.term_weights for r in reqs],
            alpha=None if all(a is None for a in alphas) else alphas,
            k=max(r.k for r in reqs))
        t_done = time.perf_counter()
        with self._lock:
            self.served += len(reqs)
        return [Result(qid=r.qid, pids=pids[j][:r.k], scores=scores[j][:r.k],
                       t_arrival=r.t_arrival, t_start=t_start, t_done=t_done)
                for j, r in enumerate(reqs)]
