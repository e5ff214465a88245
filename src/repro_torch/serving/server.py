"""Concurrent serving: bounded queue + worker pool with cross-query
micro-batching, plus a TCP front.

Clients submit queries that are queued and served by ``n_threads``
workers. Latency is measured from arrival (enqueue) to completion, so
queueing delay is included. With ``max_batch > 1`` a worker that pops a
request keeps collecting queued requests for up to
``batch_timeout_ms`` (or until ``max_batch``) and serves the group
through ``ServeEngine.process_batch`` — one batched kernel launch per
method group and deduplicated mmap gathers across co-batched queries.
With ``latency_slo_ms`` set, the effective batch cap adapts: an EWMA of
batch service time shrinks it under SLO pressure and grows it back when
there is headroom.

Pipelining: when the engine has ``pipeline_depth >= 2`` a worker no
longer owns a batch end to end — it feeds the engine's stage pipeline
and goes straight on to collecting the next micro-batch while the
pipeline's tail resolves the futures, so that batch N+1's host mmap
gather overlaps batch N's device work.

Front door: ``submit`` answers an exact-cache hit at once, without the
queue; an :class:`~repro_torch.serving.admission.AdmissionController`
then admits the request at full quality, degrades it to the splade-only
plan, or sheds it before it is queued.

Fault tolerance: ``drain()`` completes queued and in-flight work; a
failing batch is retried request by request so one poisoned query
cannot fail its co-batched neighbours; ``stop()`` fails still-queued
futures instead of leaving clients waiting forever.

TCP front: ``serve_tcp`` attaches a newline-delimited JSON front
(:class:`TCPRetrievalServer`; one reply line per request line, on one
connection or many) with admin lines (``op``) beside the queries, and
``shutdown_gracefully`` (also the SIGTERM path) stops accepting
connections, drains and stops. The wire format is the JAX package's
line for line.
"""

from __future__ import annotations

import json
import queue
import signal
import socket
import socketserver
import threading
import time
from concurrent.futures import Future
from typing import Optional

import numpy as np

from repro_torch.serving.admission import AdmissionController, RequestShed
from repro_torch.serving.context import ADMIT_DEGRADED, ADMIT_SHED
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.pipeline import PipelineStopped


class RetrievalServer:
    def __init__(self, engine: ServeEngine, n_threads: int = 1,
                 max_queue: int = 4096, max_batch: int = 1,
                 batch_timeout_ms: float = 2.0,
                 latency_slo_ms: Optional[float] = None,
                 slo_ewma_alpha: float = 0.25, grow_patience: int = 3,
                 admission: Optional[AdmissionController] = None):
        """``latency_slo_ms`` switches on adaptive micro-batch sizing:
        the effective batch cap halves (floor 1) when the EWMA of batch
        service time exceeds the SLO, and doubles back (ceiling
        ``max_batch``) after ``grow_patience`` consecutive observations
        under ~70 % of the SLO from batches that *fill* the current cap
        — growth needs evidence at the current operating point, or the
        cap hunts between sizes. ``None`` keeps the cap fixed.

        ``admission``: optional :class:`AdmissionController`. Each
        ``submit`` is classified against the live per-stage EWMAs: full
        quality, degraded to the splade-only plan, or shed (the future
        fails with :class:`RequestShed` before the request enters the
        queue)."""
        self.engine = engine
        self.admission = admission
        self.sheds = 0
        self.n_threads = n_threads
        self.max_batch = max(1, max_batch)
        self.batch_timeout_ms = batch_timeout_ms
        self.latency_slo_ms = latency_slo_ms
        self.slo_ewma_alpha = slo_ewma_alpha
        self.grow_patience = max(1, grow_patience)
        self.ewma_latency_ms: Optional[float] = None
        self.batch_cap = self.max_batch      # effective (adaptive) cap
        self._grow_streak = 0
        self.queue: queue.Queue = queue.Queue(maxsize=max_queue)
        self.workers: list[threading.Thread] = []
        self.running = False
        self.failed = 0
        self.batches = 0
        self._lock = threading.Lock()
        self._retry_cond = threading.Condition()
        self._retries = 0                # pipelined failure retries live
        self.tcp: Optional["TCPRetrievalServer"] = None
        self.tcp_port: Optional[int] = None
        self._shutdown_once = threading.Lock()
        self._shut_down = False

    # -- lifecycle -------------------------------------------------------
    def start(self):
        self.running = True
        for i in range(self.n_threads):
            t = threading.Thread(target=self._worker, name=f"worker-{i}",
                                 daemon=True)
            t.start()
            self.workers.append(t)

    def _collect_batch(self, first):
        """Coalesce queued requests behind ``first`` until the current
        (possibly adapted) batch cap or ``batch_timeout_ms`` elapses."""
        batch = [first]
        # one locked read: _observe_latency resizes the cap under the
        # lock from whichever thread served the last batch
        with self._lock:
            cap = self.batch_cap
        deadline = time.perf_counter() + self.batch_timeout_ms / 1e3
        while len(batch) < cap:
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            try:
                batch.append(self.queue.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _observe_latency(self, results):
        """Adaptive micro-batch sizing: feed the served group's service
        time into an EWMA and resize the effective cap against
        ``latency_slo_ms`` (shrink fast, grow cautiously).

        Service time, not client-observed latency, on purpose: queueing
        delay rises exactly when the server is saturated, i.e. when
        larger batches are needed; feeding it back into the shrink
        decision would pin the cap at 1 under overload."""
        if self.latency_slo_ms is None or not results:
            return
        obs_ms = max(r.service_time for r in results) * 1e3
        with self._lock:
            a = self.slo_ewma_alpha
            self.ewma_latency_ms = (obs_ms if self.ewma_latency_ms is None
                                    else a * obs_ms
                                    + (1 - a) * self.ewma_latency_ms)
            if self.ewma_latency_ms > self.latency_slo_ms:
                self.batch_cap = max(1, self.batch_cap // 2)
                self._grow_streak = 0
            elif (self.ewma_latency_ms < 0.7 * self.latency_slo_ms
                  and len(results) >= self.batch_cap
                  and self.batch_cap < self.max_batch):
                self._grow_streak += 1
                if self._grow_streak >= self.grow_patience:
                    self.batch_cap = min(self.max_batch,
                                         self.batch_cap * 2)
                    self._grow_streak = 0
            else:
                # dead band, or a batch that did not fill the cap: no
                # evidence about the current operating point
                self._grow_streak = 0

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
                # read per batch, not once at start(): an engine whose
                # depth changes at run time moves new batches to the
                # other dispatch path (engines without a pipeline stay
                # synchronous)
                if getattr(self.engine, "pipelined", False):
                    # feed the stage pipeline and move on: its tail
                    # resolves the futures while this worker collects
                    # the next micro-batch
                    self._dispatch_pipelined(batch)
                elif len(batch) == 1:
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
        self._observe_latency([res])

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
        self._observe_latency(results)

    def _dispatch_pipelined(self, batch):
        """Feed the claimed micro-batch to the engine's stage pipeline.
        Blocks only on backpressure (an executor full); completion is
        handled at the pipeline's tail by :meth:`_resolve_pipelined`."""
        claimed = [(req, fut) for req, fut in batch
                   if fut.set_running_or_notify_cancel()]
        if not claimed:
            return
        try:
            agg = self.engine.process_batch_async(
                [req for req, _ in claimed])
        except Exception as e:
            for _, fut in claimed:
                fut.set_exception(e)
            with self._lock:
                self.failed += len(claimed)
            return
        agg.add_done_callback(
            lambda f: self._resolve_pipelined(claimed, f))

    def _resolve_pipelined(self, claimed, agg):
        """Tail of the pipeline (runs on a stage worker thread): set the
        per-request futures, or — keeping the synchronous path's
        isolation — retry a failed batch request by request, so that
        one poisoned query cannot fail its co-batched neighbours."""
        exc = agg.exception()
        if exc is None:
            results = agg.result()
            for (_, fut), res in zip(claimed, results):
                fut.set_result(res)
            self._observe_latency(results)
            return
        if isinstance(exc, PipelineStopped) and not self.running:
            # server shutdown: fail at once instead of serving again.
            # (A PipelineStopped while the server runs — an executor
            # rebuilt by a backend switch — takes the retry below.)
            with self._lock:
                self.failed += len(claimed)
            for req, fut in claimed:
                fut.set_exception(RuntimeError(
                    f"server stopped mid-flight for qid={req.qid}"))
            return
        # retry on a thread of its own: this callback runs on a pipeline
        # stage worker, and synchronous retrievals here would stall every
        # batch in flight behind it. Counted, so that drain() waits for
        # the retries as well as the pipeline.
        with self._retry_cond:
            self._retries += 1

        def retry():
            try:
                for req, fut in claimed:
                    self._serve_one(req, fut, claimed=True)
            finally:
                with self._retry_cond:
                    self._retries -= 1
                    self._retry_cond.notify_all()

        threading.Thread(target=retry, name="pipeline-retry",
                         daemon=True).start()

    def stop(self):
        self.running = False
        for t in self.workers:
            t.join(timeout=2.0)
        self.workers.clear()
        # stop the stage pipelines: batches in flight resolve or fail
        # their futures (none hangs) before the queued ones are failed.
        # stop_pipelines, not close: the engine is the caller's and
        # must survive a stop() and start()
        if hasattr(self.engine, "stop_pipelines"):
            self.engine.stop_pipelines()
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

    def drain(self, timeout: Optional[float] = None) -> bool:
        """Complete all queued work: the queue, the micro-batches in
        flight in the stage pipelines (the queue empties once they are
        fed) and the retries of failed pipelined batches. False if
        ``timeout`` (seconds, for all of it) ran out first."""
        deadline = None if timeout is None else time.perf_counter() + timeout

        def left():
            return (None if deadline is None
                    else max(0.0, deadline - time.perf_counter()))

        q = self.queue
        with q.all_tasks_done:
            if not q.all_tasks_done.wait_for(
                    lambda: q.unfinished_tasks == 0, left()):
                return False
        if (getattr(self.engine, "pipelined", False)
                and not self.engine.drain_pipelines(left())):
            return False
        with self._retry_cond:
            return self._retry_cond.wait_for(lambda: self._retries == 0,
                                             left())

    # -- TCP front / graceful shutdown ------------------------------------
    def serve_tcp(self, host: str = "0.0.0.0", port: int = 0
                  ) -> "TCPRetrievalServer":
        """Attach the TCP front. ``port=0`` binds an ephemeral port (the
        kernel picks a free one) and the *real* port is reported in
        :attr:`tcp_port`, ``health()`` and on stdout. The caller runs
        ``.serve_forever()`` (or puts it on a thread)."""
        self.tcp = TCPRetrievalServer((host, port), self)
        self.tcp_port = self.tcp.server_address[1]
        print(f"RETRIEVAL_PORT={self.tcp_port}", flush=True)
        return self.tcp

    def shutdown_gracefully(self):
        """Drain, then stop — the SIGTERM path. Stops accepting new TCP
        connections and closes the listening socket first, completes
        everything queued (batches in flight in the pipelines and
        failure retries too), then stops the workers. Idempotent, and
        the lock is held for the *whole* drain: a second caller blocks
        until the drain is done instead of returning while batches are
        still in flight. ``stop()``, not ``close()``: the engine is the
        caller's."""
        with self._shutdown_once:
            if self._shut_down:
                return
            if self.tcp is not None:
                self.tcp.stop_accepting()
            self.drain()
            self.stop()
            self._shut_down = True

    def install_sigterm_handler(self):
        """Route SIGTERM to :meth:`shutdown_gracefully` on a thread of
        its own, ``sigterm-drain`` (``TCPServer.shutdown`` deadlocks if
        called from the thread running ``serve_forever``, which is where
        the signal may land). Returns the previous handler. Main thread
        only: signal registration is a CPython restriction."""
        def handler(signum, frame):
            threading.Thread(target=self.shutdown_gracefully,
                             name="sigterm-drain", daemon=True).start()

        return signal.signal(signal.SIGTERM, handler)

    # -- client API -------------------------------------------------------
    def submit(self, req: Request) -> Future:
        """Front door: exact-cache fast path → admission → queue.

        A cache hit resolves the future at once without touching the
        queue (bitwise the cold answer). The admission controller then
        classifies the request against the live per-stage EWMAs: a shed
        fails the future with :class:`RequestShed`; a degrade stamps the
        request's context so the engine runs the splade-only plan."""
        req.t_arrival = time.perf_counter()
        fut: Future = Future()
        engine = self.engine
        caches = getattr(engine, "caches", None)
        if req.ctx is None and (self.admission is not None
                                or caches is not None):
            req.ctx = engine.context_for(req)
        hit = (engine.cache_lookup(req, count_miss=False)
               if caches is not None else None)
        if hit is not None:
            fut.set_running_or_notify_cancel()
            fut.set_result(hit)
            return fut
        if self.admission is not None:
            stats = engine.retriever.pipeline_stats
            degradable = (req.method in ("hybrid", "rerank")
                          and req.term_ids is not None
                          and len(req.term_ids) > 0)
            with self._lock:
                cap = self.batch_cap
            d = self.admission.decide(
                req.method, degradable, stats.snapshot()["stages"],
                queue_depth=self.queue.qsize(), batch_cap=cap,
                deadline_ms=req.deadline_ms)
            if d.admission == ADMIT_SHED:
                with self._lock:
                    self.sheds += 1
                stats.counter("admission_sheds")
                fut.set_running_or_notify_cancel()
                fut.set_exception(RequestShed(d.reason,
                                              d.predicted_full_ms))
                return fut
            if d.admission == ADMIT_DEGRADED:
                req.ctx = req.ctx.degraded(d.reason)
                stats.counter("admission_degraded")
        self.queue.put((req, fut))
        return fut

    def health(self) -> dict:
        """Server vitals (queue depth, served/failed/shed counts, the
        adaptive batch cap and its latency EWMA, the retriever's shard
        count: 1 for a single index) and, where the engine
        has a retriever, its per-stage instrumentation and counters
        (and, on a live index, its live statistics and generation); the
        admission controller's and the caches' statistics where
        they are set; the executors' queue depths when the engine is
        pipelined."""
        with self._lock:
            failed, batches, sheds = self.failed, self.batches, self.sheds
            cap, ewma = self.batch_cap, self.ewma_latency_ms
        retr = getattr(self.engine, "retriever", None)
        h = {"queue_depth": self.queue.qsize(),
             "served": self.engine.served,
             "failed": failed,
             "sheds": sheds,
             "batches": batches,
             "workers": sum(t.is_alive() for t in self.workers),
             "max_batch": self.max_batch,
             "batch_cap": cap,
             "ewma_latency_ms": ewma,
             "port": self.tcp_port,
             "n_shards": getattr(retr, "n_shards", 1)}
        if retr is not None:
            snap = retr.pipeline_stats.snapshot()
            h["stages"] = {
                name: {"ewma_ms": r["ewma_ms"], "wall_s": r["wall_s"],
                       "dispatches": r["dispatches"],
                       "device_dispatches": r["device_dispatches"],
                       "queue_wait_s": r["queue_wait_s"],
                       "pages_touched": r["pages_touched"]}
                for name, r in snap["stages"].items()}
            h["overlap_fraction"] = snap["overlap_fraction"]
            h["counters"] = snap["counters"]
            live = retr.live_stats()
            if live is not None:
                h["live"] = live
                h["index_generation"] = retr.index_generation
        if self.admission is not None:
            h["admission"] = self.admission.stats()
        caches = getattr(self.engine, "caches", None)
        if caches is not None:
            h["caches"] = caches.stats()
        if getattr(self.engine, "pipelined", False):
            h["pipeline"] = self.engine.pipeline_health()
        return h


# ---------------------------------------------------------------------------
# The TCP front: newline-delimited JSON, one reply line per request line.
# ---------------------------------------------------------------------------

def wire_request(msg: dict) -> Request:
    """The request a query line asks for: ``method`` defaults to
    ``hybrid`` and ``k`` to 10, absent terms are empty, and the wire
    carries no α (the retriever's applies)."""
    return Request(
        qid=msg["qid"], method=msg.get("method", "hybrid"),
        q_emb=np.asarray(msg["q_emb"], np.float32)
        if "q_emb" in msg else None,
        term_ids=np.asarray(msg.get("term_ids", []), np.int32),
        term_weights=np.asarray(msg.get("term_weights", []), np.float32),
        k=msg.get("k", 10))


class _Handler(socketserver.StreamRequestHandler):
    def _admin(self, msg, op):
        """Control-plane ops share the query socket, dispatched on an
        explicit ``op`` key so that plain query lines stay
        wire-compatible: live mutations (upsert/delete), compaction,
        and health/stats. Mutations go through the engine's
        pass-throughs; on a frozen index they fail cleanly, as an
        ``error`` reply, not a dropped connection."""
        rs = self.server.retrieval
        engine = rs.engine
        if op == "upsert":
            pid = engine.live_upsert(
                np.asarray(msg["doc_emb"], np.float32),
                np.asarray(msg.get("term_ids", []), np.int32),
                np.asarray(msg.get("term_weights", []), np.float32),
                msg.get("doc_len"))
            return {"ok": True, "pid": int(pid)}
        if op == "delete":
            return {"ok": bool(engine.live_delete(int(msg["pid"])))}
        if op == "compact":
            out = engine.live_compact()
            return {"ok": True,
                    "compacted": 0 if not out else int(out["compacted"])}
        if op == "live_stats":
            return {"ok": True, "live": engine.live_stats()}
        if op == "health":
            return {"ok": True, "health": rs.health()}
        raise ValueError(f"unknown op {op!r}")

    def handle(self):
        for line in self.rfile:
            qid = None
            try:
                msg = json.loads(line)
                qid = msg.get("qid")
                op = msg.get("op")
                if op is not None:
                    out = self._admin(msg, op)
                    self.wfile.write((json.dumps(out) + "\n").encode())
                    self.wfile.flush()
                    continue
                req = wire_request(msg)
                res = self.server.retrieval.submit(req).result(timeout=60)
                out = {"qid": res.qid, "pids": res.pids.tolist(),
                       "scores": [float(s) for s in res.scores],
                       "latency": res.latency}
                if res.cache_hit:
                    out["cache_hit"] = True
                if res.degraded:
                    # a downgraded answer: the reason code says that
                    # admission control ran the cheap plan. No shard is
                    # ever missing from an unsharded index, but the key
                    # stays, so that the reply is the JAX package's
                    out["degraded"] = True
                    out["degrade_reason"] = res.degrade_reason
                    out["missing_shards"] = []
            except RequestShed as e:
                out = {"error": str(e), "shed": True, "reason": e.reason}
                if qid is not None:
                    out["qid"] = qid
            except Exception as e:
                out = {"error": str(e)}
                if qid is not None:
                    out["qid"] = qid
            self.wfile.write((json.dumps(out) + "\n").encode())
            self.wfile.flush()


class TCPRetrievalServer(socketserver.ThreadingTCPServer):
    """The newline-JSON front. It listens with a backlog of
    ``socket.SOMAXCONN`` (the kernel caps it at ``net.core.somaxconn``),
    not ``socketserver``'s 5: a burst of connections beyond the backlog
    would have its SYNs dropped and wait a second to connect. The JAX
    package's front keeps 5; no reply differs."""
    allow_reuse_address = True
    daemon_threads = True
    request_queue_size = socket.SOMAXCONN

    def __init__(self, addr, retrieval_server: RetrievalServer):
        super().__init__(addr, _Handler)
        self.retrieval = retrieval_server
        self._state = threading.Lock()
        self._serving = False            # serve_forever was entered
        self._stopped = False

    def serve_forever(self, poll_interval: float = 0.5):
        with self._state:
            if self._stopped:
                return
            self._serving = True
        super().serve_forever(poll_interval)

    def stop_accepting(self):
        """End ``serve_forever`` if it ever started and close the
        listening socket; a new connection is then refused. Idempotent.
        ``shutdown()`` alone waits forever on a front that was never
        served (it waits for ``serve_forever`` to acknowledge), so it is
        called only on one that was. Connections already open keep
        their handler threads until the client closes them."""
        with self._state:
            if self._stopped:
                return
            self._stopped = True
            serving = self._serving
        if serving:
            self.shutdown()
        self.server_close()


def tcp_query(host: str, port: int, payload: dict) -> dict:
    """Send one request line on a connection of its own; → the reply."""
    with socket.create_connection((host, port), timeout=60) as s:
        s.sendall((json.dumps(payload) + "\n").encode())
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    return json.loads(buf)
