"""Concurrent serving: bounded queue + worker pool with cross-query
micro-batching.

Clients submit queries that are queued and served by ``n_threads``
workers. Latency is measured from arrival (enqueue) to completion, so
queueing delay is included. With ``max_batch > 1`` a worker that pops a
request keeps collecting queued requests for up to
``batch_timeout_ms`` (or until ``max_batch``) and serves the group
through ``ServeEngine.process_batch`` — one batched kernel launch per
method group and deduplicated mmap gathers across co-batched queries.

Fault tolerance: ``drain()`` completes queued work; a failing batch is
retried request by request so one poisoned query cannot fail its
co-batched neighbours; ``stop()`` fails still-queued futures instead of
leaving clients waiting forever.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

from repro_torch.serving.engine import Request, ServeEngine


class RetrievalServer:
    def __init__(self, engine: ServeEngine, n_threads: int = 1,
                 max_queue: int = 4096, max_batch: int = 1,
                 batch_timeout_ms: float = 2.0):
        self.engine = engine
        self.n_threads = n_threads
        self.max_batch = max(1, max_batch)
        self.batch_timeout_ms = batch_timeout_ms
        self.queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self.workers: list[threading.Thread] = []
        self.running = False
        self.failed = 0
        self.batches = 0
        self._lock = threading.Lock()

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self.running = True
        for i in range(self.n_threads):
            t = threading.Thread(target=self._worker, name=f"worker-{i}",
                                 daemon=True)
            t.start()
            self.workers.append(t)

    def _collect_batch(self, first):
        """Coalesce queued requests behind ``first`` until ``max_batch``
        or ``batch_timeout_ms`` elapses."""
        batch = [first]
        deadline = time.perf_counter() + self.batch_timeout_ms / 1e3
        while len(batch) < self.max_batch:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _worker(self):
        while self.running:
            try:
                item = self.queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = (self._collect_batch(item) if self.max_batch > 1
                     else [item])
            try:
                with self._lock:
                    self.batches += 1
                if len(batch) == 1:
                    self._serve_one(*batch[0])
                else:
                    self._serve_batch(batch)
            finally:
                for _ in batch:
                    self.queue.task_done()

    def _serve_one(self, req, fut, claimed: bool = False):
        # claim the future before any work: once RUNNING, a concurrent
        # client cancel() can no longer race set_result/set_exception
        if not claimed and not fut.set_running_or_notify_cancel():
            return                       # cancelled while queued
        try:
            res = self.engine.process(req)
        except Exception as e:  # the failure goes to this client only
            with self._lock:
                self.failed += 1
            fut.set_exception(e)
            return
        fut.set_result(res)

    def _serve_batch(self, batch):
        claimed = [(req, fut) for req, fut in batch
                   if fut.set_running_or_notify_cancel()]
        if not claimed:
            return
        try:
            results = self.engine.process_batch([req for req, _ in claimed])
        except Exception:
            # isolate the poisoned request: retry individually so one bad
            # query cannot fail its co-batched neighbours
            for req, fut in claimed:
                self._serve_one(req, fut, claimed=True)
            return
        for (_, fut), res in zip(claimed, results):
            fut.set_result(res)

    def stop(self):
        self.running = False
        for t in self.workers:
            t.join(timeout=2.0)
        self.workers.clear()
        # fail whatever never got served — clients must not hang forever
        while True:
            try:
                req, fut = self.queue.get_nowait()
            except queue.Empty:
                break
            if fut.set_running_or_notify_cancel():
                fut.set_exception(
                    RuntimeError(f"server stopped before serving "
                                 f"qid={req.qid}"))
            self.queue.task_done()

    def drain(self):
        """Complete all queued work."""
        self.queue.join()

    # -- client API -------------------------------------------------------
    def submit(self, req: Request) -> Future:
        req.t_arrival = time.perf_counter()
        fut: Future = Future()
        self.queue.put((req, fut))
        return fut

    def health(self) -> dict:
        """Server vitals and the retriever's per-stage instrumentation."""
        with self._lock:
            failed, batches = self.failed, self.batches
        h = {"queue_depth": self.queue.qsize(),
             "served": self.engine.served,
             "failed": failed,
             "batches": batches,
             "workers": sum(t.is_alive() for t in self.workers),
             "max_batch": self.max_batch}
        snap = self.engine.retriever.pipeline_stats.snapshot()
        h["stages"] = {
            name: {"ewma_ms": r["ewma_ms"], "wall_s": r["wall_s"],
                   "dispatches": r["dispatches"],
                   "device_dispatches": r["device_dispatches"],
                   "pages_touched": r["pages_touched"]}
            for name, r in snap["stages"].items()}
        h["overlap_fraction"] = snap["overlap_fraction"]
        return h
