"""The port's pipelined stage executor, ``ServeEngine.process_batch_async``
and the server's pipelined dispatch, with ``device="cpu"`` on an index
the JAX builder wrote.

Bit for bit within the port: ``PipelineExecutor`` at depth 1-3 with
single and kind workers equals ``StagePlan.run`` for the four methods
(mmap and resident pools, fused and split tails); the pipelined engine
and server equal the synchronous engine on the same micro-batches; and
both meet the parity bar against the JAX package's synchronous
``process_batch`` (ids equal up to tie groups, scores
``allclose(rtol=1e-5, atol=1e-5)``).

The scheduling tests run synthetic plans whose stages wait on
``threading.Event``s: thread order is forced by those events, never by
sleeping, and overlap is shown as an order of events. Every wait has a
timeout of at most ``TIMEOUT`` seconds, every executor, engine and
server is stopped in a ``finally``, and a fixture checks that no
pipeline thread outlives its test.
"""

import threading

import numpy as np
import pytest
import torch

from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import (SpladeIndex as JSplade,
                                      build_splade_index as j_build_splade)
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.common import HostCopy
from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.pipeline import (DEVICE, HOST, CandidateBatch,
                                          PipelineExecutor, PipelineStats,
                                          PipelineStopped, Stage, StagePlan,
                                          gather_futures)
from repro_torch.serving.server import RetrievalServer
from repro_torch.testing import REF_MARGIN, assert_topk_match

TIMEOUT = 30.0          # seconds: the bound on every wait in this file
MS = dict(first_k=50, k=20)
WORKERS = ("single", "kind")


@pytest.fixture(autouse=True)
def no_pipeline_thread_left():
    """No executor worker (``pipe-*``), retry thread (``pipeline-retry``)
    or server worker (``worker-*``) started by the test outlives it."""
    before = set(threading.enumerate())
    yield
    left = []
    for t in threading.enumerate():
        if t in before or not t.name.startswith(
                ("pipe-", "pipeline-retry", "worker-")):
            continue
        t.join(timeout=TIMEOUT)
        if t.is_alive():
            left.append(t.name)
    assert not left, f"threads left running: {left}"


@pytest.fixture(scope="module")
def splade_dir(small_corpus, tmp_path_factory):
    c = small_corpus
    path = tmp_path_factory.mktemp("splade_pipeline")
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(path)
    return path


def _retr(built_index, splade_dir, resident=False, rerank="fused"):
    r = MultiStageRetriever(
        SpladeIndex.load(splade_dir, mmap=True),
        PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"),
                      device_resident=resident, device="cpu"),
        MultiStageParams(**MS), device="cpu")
    r.set_rerank_backend(rerank)
    return r


@pytest.fixture(scope="module")
def retr(built_index, splade_dir):
    return _retr(built_index, splade_dir)


@pytest.fixture(scope="module")
def jax_engine(built_index, splade_dir):
    return JEngine(JRetriever(JSplade.load(splade_dir, mmap=True),
                              JSearcher(JIndex(built_index, mode="mmap")),
                              JParams(**MS)))


def _requests(corpus, methods, ks, alphas, lo=0):
    return [Request(qid=lo + i, method=m, q_emb=corpus["q_embs"][lo + i],
                    term_ids=corpus["q_term_ids"][lo + i],
                    term_weights=corpus["q_term_weights"][lo + i], k=k,
                    alpha=a)
            for i, (m, k, a) in enumerate(zip(methods, ks, alphas))]


# a mixed stream: per-query k and α, every method in several groups
MIXED = (["hybrid", "hybrid", "colbert", "rerank", "splade", "rerank"]
         + ["colbert", "colbert", "hybrid", "splade", "rerank", "hybrid"]
         + ["rerank", "splade", "splade", "colbert", "hybrid", "rerank"])
MIXED_K = [20, 1, 30, 50, 7, 20, 10, 20, 13, 50, 5, 20, 1, 20, 30, 7, 50,
           10]
MIXED_ALPHA = [0.0, None, None, None, None, None, None, None, 0.7, None,
               None, 1.0, None, None, None, None, 0.3, None]


def _mixed(corpus):
    return _requests(corpus, MIXED, MIXED_K, MIXED_ALPHA, lo=3)


def _chunks(seq, n):
    return [seq[i:i + n] for i in range(0, len(seq), n)]


def _same_bits(want, got, what=""):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert a.qid == b.qid, what
        np.testing.assert_array_equal(a.pids, b.pids, err_msg=what)
        np.testing.assert_array_equal(
            np.asarray(a.scores).view(np.uint32),
            np.asarray(b.scores).view(np.uint32), err_msg=what)


def _meets_jax_bar(jax_engine, reqs, results):
    """Each result against the JAX package's synchronous
    ``process_batch``, asked ``REF_MARGIN`` places deeper so that ties
    at an answer's last place are visible."""
    want = jax_engine.process_batch([
        JRequest(qid=r.qid, method=r.method, q_emb=r.q_emb,
                 term_ids=r.term_ids, term_weights=r.term_weights,
                 k=r.k + REF_MARGIN, alpha=r.alpha) for r in reqs])
    for req, res, ref in zip(reqs, results, want):
        assert res.qid == ref.qid == req.qid
        assert res.pids.shape == (req.k,) and res.scores.shape == (req.k,)
        assert_topk_match(ref.scores, ref.pids, res.scores, res.pids,
                          what=f"qid {req.qid} {req.method} k={req.k}")


# ---------------------------------------------------------------------------
# the executor on the retriever's plans == StagePlan.run
# ---------------------------------------------------------------------------

def _plan_batch(retr, corpus, method, bi, B=4, k=15):
    idx = [(bi * B + j) % 40 for j in range(B)]
    return retr.build_batch(
        method, q_embs=[corpus["q_embs"][i] for i in idx],
        term_ids=[corpus["q_term_ids"][i] for i in idx],
        term_weights=[corpus["q_term_weights"][i] for i in idx],
        alphas=np.linspace(0.1, 0.9, B).astype(np.float32), k=k)


def _executor_equals_run(retr, corpus, method, depth, workers,
                         n_batches=3):
    plan = retr.compile_plan(method)
    sync = [plan.run(_plan_batch(retr, corpus, method, bi))
            for bi in range(n_batches)]
    px = PipelineExecutor(plan, depth=depth, stats=retr.pipeline_stats,
                          workers=workers, device="cpu")
    try:
        futs = [px.submit(_plan_batch(retr, corpus, method, bi))
                for bi in range(n_batches)]
        piped = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        px.stop()
    assert px.stream is None and not px.workers
    for s, p in zip(sync, piped):
        np.testing.assert_array_equal(s.pids, p.pids)
        np.testing.assert_array_equal(s.scores.view(np.uint32),
                                      p.scores.view(np.uint32))


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("depth", [1, 2, 3])
@pytest.mark.parametrize("method", METHODS)
def test_executor_equals_plan_run(retr, small_corpus, method, depth,
                                  workers):
    _executor_equals_run(retr, small_corpus, method, depth, workers)


@pytest.mark.parametrize("workers", WORKERS)
@pytest.mark.parametrize("pool,tail", [("resident", "fused"),
                                       ("mmap", "split")])
@pytest.mark.parametrize("method", ["colbert", "hybrid"])
def test_executor_equals_plan_run_other_pools_and_tails(
        built_index, splade_dir, small_corpus, method, pool, tail, workers):
    """A resident pool gathers on the device (the kind workers then run
    every stage on the device worker); the split tail hands its score
    tensor's host copy to its sync stage."""
    r = _retr(built_index, splade_dir, resident=pool == "resident",
              rerank=tail)
    _executor_equals_run(r, small_corpus, method, 2, workers)


# ---------------------------------------------------------------------------
# the engine and the server: pipelined == synchronous, and the JAX bar
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("depth,workers", [(1, "single"), (2, "single"),
                                           (2, "kind"), (3, "single"),
                                           (3, "kind")])
def test_process_batch_async_equals_process_batch(
        retr, jax_engine, small_corpus, depth, workers):
    reqs = _mixed(small_corpus)
    batches = _chunks(reqs, 6)
    want = [r for b in batches for r in ServeEngine(retr).process_batch(b)]
    eng = ServeEngine(retr, pipeline_depth=depth, pipeline_workers=workers)
    try:
        futs = [eng.process_batch_async(b) for b in batches]
        got = [r for f in futs for r in f.result(timeout=TIMEOUT)]
    finally:
        eng.close()
    assert eng.pipelined == (depth > 1)
    _same_bits(want, got)
    _meets_jax_bar(jax_engine, reqs, got)
    if depth > 1:
        with pytest.raises(PipelineStopped, match="engine closed"):
            eng.process_batch_async(batches[0]).result(timeout=TIMEOUT)


def _serve(engine, reqs, max_batch):
    """Serve ``reqs`` queued before the server starts, so that its
    micro-batches are the consecutive ``max_batch`` chunks."""
    srv = RetrievalServer(engine, max_batch=max_batch,
                          batch_timeout_ms=1000.0)
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    try:
        results = [f.result(timeout=TIMEOUT) for f in futs]
        assert srv.drain(timeout=TIMEOUT)
        health = srv.health()
    finally:
        srv.stop()
    return results, health


@pytest.mark.parametrize("workers", WORKERS)
def test_server_pipelined_equals_synchronous(retr, jax_engine, small_corpus,
                                             workers):
    reqs = _mixed(small_corpus)
    sync, _ = _serve(ServeEngine(retr), reqs, 6)
    eng = ServeEngine(retr, pipeline_depth=2, pipeline_workers=workers)
    try:
        piped, health = _serve(eng, reqs, 6)
    finally:
        eng.close()
    _same_bits(sync, piped)
    _meets_jax_bar(jax_engine, reqs, piped)
    assert health["served"] == len(reqs) and health["failed"] == 0
    assert health["batches"] == 3


@pytest.mark.parametrize("workers", WORKERS)
def test_server_isolates_a_poisoned_request(retr, small_corpus, workers):
    """An unknown method fails its batch at submit; the retry thread
    serves the batch request by request, so only the poisoned request
    fails and its neighbours get the synchronous answers."""
    reqs = _requests(small_corpus, ["rerank", "dense", "hybrid", "colbert"],
                     [5, 5, 7, 9], [None, None, 0.4, None])
    eng = ServeEngine(retr, pipeline_depth=2, pipeline_workers=workers)
    srv = RetrievalServer(eng, max_batch=4, batch_timeout_ms=1000.0)
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    try:
        with pytest.raises(ValueError, match="dense"):
            futs[1].result(timeout=TIMEOUT)
        good = [futs[i].result(timeout=TIMEOUT) for i in (0, 2, 3)]
        assert srv.drain(timeout=TIMEOUT)
        assert srv.health()["failed"] == 1
    finally:
        srv.stop()
        eng.close()
    plain = ServeEngine(retr)
    _same_bits([plain.process(reqs[i]) for i in (0, 2, 3)], good)


def test_drain_waits_for_the_retries(retr, small_corpus):
    reqs = _requests(small_corpus, ["rerank", "dense"], [5, 5], [None] * 2)
    eng = ServeEngine(retr, pipeline_depth=2)
    entered, release = threading.Event(), threading.Event()
    process = eng.process

    def held(req):
        if req.qid == reqs[0].qid:
            entered.set()
            release.wait(TIMEOUT)
        return process(req)

    eng.process = held
    srv = RetrievalServer(eng, max_batch=2, batch_timeout_ms=1000.0)
    futs = [srv.submit(r) for r in reqs]
    srv.start()
    try:
        assert entered.wait(TIMEOUT)
        # the retry of the batch's good request is held: drain cannot end
        assert srv.drain(timeout=0.2) is False
        assert not futs[0].done()
        release.set()
        assert srv.drain(timeout=TIMEOUT)
        assert futs[0].done() and futs[1].done()
        assert futs[0].result(timeout=TIMEOUT).pids.shape == (5,)
    finally:
        release.set()
        srv.stop()
        eng.close()


def test_server_stop_fails_unserved_requests(retr, small_corpus):
    """A pipelined server that never started: stop() fails every queued
    request, none pending."""
    eng = ServeEngine(retr, pipeline_depth=2)
    srv = RetrievalServer(eng)
    futs = [srv.submit(r) for r in _mixed(small_corpus)[:3]]
    srv.stop()
    eng.close()
    for fut in futs:
        assert fut.done()
        with pytest.raises(RuntimeError, match="server stopped"):
            fut.result(timeout=TIMEOUT)


@pytest.mark.parametrize("workers", WORKERS)
def test_server_stop_mid_flight_leaves_none_pending(built_index, splade_dir,
                                                    small_corpus, workers):
    """stop() while a batch is held inside its residual gather, one more
    admitted and one blocked at the full pipeline's head: every request
    fails with PipelineStopped or RuntimeError (none resolves late, none
    hangs), and the engine serves again after it."""
    r = _retr(built_index, splade_dir)
    eng = ServeEngine(r, pipeline_depth=2, pipeline_workers=workers)
    entered = threading.Event()
    gather = r.searcher.gather_tokens_batch

    def held(pids_b):
        px = eng._pipelines["rerank"]
        entered.set()
        px.stopped.wait(TIMEOUT)
        return gather(pids_b)

    r.searcher.gather_tokens_batch = held
    reqs = _requests(small_corpus, ["rerank"] * 8, [5] * 8, [None] * 8)
    srv = RetrievalServer(eng, max_batch=2, batch_timeout_ms=1000.0)
    futs = [srv.submit(q) for q in reqs]
    srv.start()
    try:
        assert entered.wait(TIMEOUT)
    finally:
        srv.stop()
    for fut in futs:
        exc = fut.exception(timeout=TIMEOUT)
        assert isinstance(exc, (PipelineStopped, RuntimeError)), exc
    del r.searcher.gather_tokens_batch
    try:
        again = eng.process_batch_async(reqs[:2]).result(timeout=TIMEOUT)
    finally:
        eng.close()
    _same_bits(ServeEngine(r).process_batch(reqs[:2]), again)


def test_server_restarts_over_the_same_engine(retr, small_corpus):
    eng = ServeEngine(retr, pipeline_depth=2)
    reqs = _mixed(small_corpus)
    try:
        first, _ = _serve(eng, reqs[:1], 4)
        second, health = _serve(eng, reqs[1:5], 4)
    finally:
        eng.close()
    plain = ServeEngine(retr)
    _same_bits([plain.process(reqs[0])], first)
    _same_bits(plain.process_batch(reqs[1:5]), second)
    assert health["batches"] == 1


# ---------------------------------------------------------------------------
# health, the exact cache, and the executor rebuilt on a plan change
# ---------------------------------------------------------------------------

def test_health_reports_the_pipeline_and_queue_waits(retr, small_corpus):
    retr.reset_stage_stats()
    eng = ServeEngine(retr, pipeline_depth=2)
    try:
        _, h = _serve(eng, _requests(small_corpus, ["hybrid"] * 8, [10] * 8,
                                     [None] * 8), 4)
    finally:
        eng.close()
    assert h["pipeline"]["depth"] == 2
    q = h["pipeline"]["queues"]["hybrid"]
    assert set(q) == {"splade_stage1", "host_gather:residuals",
                      "fused_rerank", "fused_rerank:sync"}
    assert all(depth == 0 for depth in q.values())   # drained
    st = h["stages"]
    assert set(st) == set(q)
    assert all(s["queue_wait_s"] >= 0 and s["dispatches"] == 2
               for s in st.values())
    assert sum(s["queue_wait_s"] for s in st.values()) > 0
    assert st["fused_rerank"]["device_dispatches"] == 2
    assert st["fused_rerank:sync"]["device_dispatches"] == 0
    assert 0.0 <= h["overlap_fraction"] <= 1.0


def test_exact_hits_through_process_batch_async_run_no_stage(
        built_index, splade_dir, small_corpus):
    r = _retr(built_index, splade_dir)
    eng = ServeEngine(r, caches=CacheHierarchy(64, 64), pipeline_depth=2)
    reqs = _mixed(small_corpus)[:8]

    def fresh():
        return [Request(qid=q.qid, method=q.method, q_emb=q.q_emb,
                        term_ids=q.term_ids, term_weights=q.term_weights,
                        k=q.k, alpha=q.alpha) for q in reqs]

    try:
        cold = eng.process_batch_async(fresh()).result(timeout=TIMEOUT)
        r.reset_stage_stats()
        fut = eng.process_batch_async(fresh())
        assert fut.done()                  # resolved at once
        hot = fut.result(timeout=TIMEOUT)
    finally:
        eng.close()
    assert not any(x.cache_hit for x in cold)
    assert all(x.cache_hit for x in hot)
    _same_bits(cold, hot)
    snap = r.pipeline_stats.snapshot()
    assert snap["stages"] == {}
    assert snap["counters"] == {"cache_exact_hits": len(reqs)}
    _same_bits(ServeEngine(_retr(built_index, splade_dir)).process_batch(
        fresh()), cold)


def test_executor_rebuilt_after_set_splade_backend(built_index, splade_dir,
                                                   small_corpus):
    r = _retr(built_index, splade_dir)
    eng = ServeEngine(r, pipeline_depth=2)
    reqs = _requests(small_corpus, ["hybrid"] * 4, [10] * 4, [None] * 4)
    try:
        host = eng.process_batch_async(reqs).result(timeout=TIMEOUT)
        px_host = eng._pipelines["hybrid"]
        r.set_splade_backend("device")
        dev = eng.process_batch_async(reqs).result(timeout=TIMEOUT)
        px_dev = eng._pipelines["hybrid"]
    finally:
        eng.close()
    assert px_dev is not px_host and not px_host.running
    assert px_host.plan.stages[0].kind == HOST
    assert px_dev.plan.stages[0].kind == DEVICE
    assert px_dev.plan is r.compile_plan("hybrid")
    # untruncated postings: the device stage 1 is the host's bit for bit
    _same_bits(host, dev)


# ---------------------------------------------------------------------------
# scheduling on synthetic plans, ordered by events
# ---------------------------------------------------------------------------

def _cb(i=0):
    return CandidateBatch(method="x", k=1, term_ids=(np.asarray([i]),))


def _id(cb):
    return int(cb.term_ids[0][0])


def _done(cb):
    return cb.evolve(pids=np.full((1, 1), _id(cb), np.int64))


class _Watched:
    """An executor's admission semaphore that sets ``blocked`` when an
    acquire with a timeout times out."""

    def __init__(self, sem):
        self.sem = sem
        self.blocked = threading.Event()

    def acquire(self, blocking=True, timeout=None):
        got = self.sem.acquire(blocking, timeout)
        if not got:
            self.blocked.set()
        return got

    def release(self):
        self.sem.release()


@pytest.mark.parametrize("workers", WORKERS)
def test_full_pipeline_backpressures_the_producer(workers):
    """depth=1 with a batch held in its first stage: the next submit
    blocks at the head until that batch has left the pipeline."""
    gate, order = threading.Event(), []

    def first(cb):
        if _id(cb) == 0:
            gate.wait(TIMEOUT)
        return cb

    def last(cb):
        order.append(("done", _id(cb)))
        return _done(cb)

    plan = StagePlan("x", (Stage("host_gather", HOST, first),
                           Stage("device_score", DEVICE, last)))
    px = PipelineExecutor(plan, depth=1, workers=workers, device="cpu")
    px._sem = _Watched(px._sem)
    second = {}

    def produce():
        second["fut"] = px.submit(_cb(1))
        order.append(("submitted", 1))

    producer = threading.Thread(target=produce)
    try:
        f0 = px.submit(_cb(0))
        producer.start()
        assert px._sem.blocked.wait(TIMEOUT)
        assert "fut" not in second             # held at the head
        assert sum(px.queue_depths().values()) <= 1
        gate.set()
        producer.join(TIMEOUT)
        assert not producer.is_alive()
        assert f0.result(timeout=TIMEOUT).pids[0, 0] == 0
        assert second["fut"].result(timeout=TIMEOUT).pids[0, 0] == 1
    finally:
        gate.set()
        px.stop()
    assert order.index(("done", 0)) < order.index(("submitted", 1))


def test_kind_workers_overlap_host_and_device_stages():
    """Batch 1's host stage starts while batch 0's device stage is still
    running: batch 0's device stage waits for it."""
    b1_started = threading.Event()

    def gather(cb):
        if _id(cb) == 1:
            b1_started.set()
        return cb

    def score(cb):
        seen = b1_started.wait(TIMEOUT) if _id(cb) == 0 else None
        return _done(cb).with_state(overlapped=seen)

    plan = StagePlan("x", (Stage("host_gather", HOST, gather),
                           Stage("device_score", DEVICE, score)))
    px = PipelineExecutor(plan, depth=2, workers="kind", device="cpu")
    try:
        f0, f1 = px.submit(_cb(0)), px.submit(_cb(1))
        assert f0.result(timeout=TIMEOUT).state["overlapped"] is True
        f1.result(timeout=TIMEOUT)
    finally:
        px.stop()


def test_single_worker_runs_a_younger_launch_before_a_parked_sync():
    """Software pipelining: batch 1's launch runs before batch 0's sync
    stage (batch 0 parks there while a younger batch has a stage to run
    before its own), and each batch still launches before it syncs."""
    go, order = threading.Event(), []

    def launch(cb):
        if _id(cb) == 0:
            go.wait(TIMEOUT)
        order.append(("launch", _id(cb)))
        return cb

    def sync(cb):
        order.append(("sync", _id(cb)))
        return _done(cb)

    plan = StagePlan("x", (
        Stage("fused_rerank", DEVICE, launch, opens_async=True),
        Stage("fused_rerank:sync", DEVICE, sync, closes_async=True)))
    px = PipelineExecutor(plan, depth=2, workers="single", device="cpu")
    try:
        futs = [px.submit(_cb(0)), px.submit(_cb(1))]
        go.set()
        futs.append(px.submit(_cb(2)))
        for f in futs:
            f.result(timeout=TIMEOUT)
    finally:
        go.set()
        px.stop()
    assert order.index(("launch", 1)) < order.index(("sync", 0)), order
    for i in range(3):
        assert order.index(("launch", i)) < order.index(("sync", i))


@pytest.mark.parametrize("workers", WORKERS)
def test_stage_exception_fails_only_its_batch(workers):
    def boom(cb):
        if _id(cb) == 1:
            raise RuntimeError("injected")
        return _done(cb)

    plan = StagePlan("x", (Stage("host_gather", HOST, lambda cb: cb),
                           Stage("device_score", DEVICE, boom)))
    px = PipelineExecutor(plan, depth=2, workers=workers, device="cpu")
    try:
        futs = [px.submit(_cb(i)) for i in range(3)]
        with pytest.raises(RuntimeError, match="injected"):
            futs[1].result(timeout=TIMEOUT)
        assert futs[0].result(timeout=TIMEOUT).pids[0, 0] == 0
        assert futs[2].result(timeout=TIMEOUT).pids[0, 0] == 2
        assert px.drain(timeout=TIMEOUT)
    finally:
        px.stop()


@pytest.mark.parametrize("workers", WORKERS)
def test_stop_fails_every_batch_in_flight(workers):
    """stop() while batch 0 is mid-stage and batch 1 waits: both fail
    with PipelineStopped, none hangs, and submit then refuses."""
    entered = threading.Event()
    holder = {}

    def first(cb):
        if _id(cb) == 0:
            entered.set()
            holder["px"].stopped.wait(TIMEOUT)
        return cb

    plan = StagePlan("x", (Stage("host_gather", HOST, first),
                           Stage("device_score", DEVICE, _done)))
    px = holder["px"] = PipelineExecutor(plan, depth=2, workers=workers,
                                         device="cpu")
    try:
        futs = [px.submit(_cb(0)), px.submit(_cb(1))]
        assert entered.wait(TIMEOUT)
    finally:
        px.stop()
    for f in futs:
        assert isinstance(f.exception(timeout=TIMEOUT), PipelineStopped)
    assert not px.running
    with pytest.raises(PipelineStopped):
        px.submit(_cb(2))
    assert px.drain(timeout=TIMEOUT)


def test_stop_with_parked_async_windows_balances_the_overlap():
    """Two batches stopped between their launch and their sync (one
    parked, one mid-launch) close their async windows: the shared
    accounting holds none open, and a serial run reads no overlap."""
    stats = PipelineStats()
    go, entered = threading.Event(), threading.Event()
    holder = {}

    def launch(cb):
        if _id(cb) == 0:
            go.wait(TIMEOUT)
        else:
            entered.set()
            holder["px"].stopped.wait(TIMEOUT)
        return cb

    plan = StagePlan("x", (
        Stage("fused_rerank", DEVICE, launch, opens_async=True),
        Stage("fused_rerank:sync", DEVICE, _done, closes_async=True)))
    px = holder["px"] = PipelineExecutor(plan, depth=2, stats=stats,
                                         workers="single", device="cpu")
    try:
        futs = [px.submit(_cb(0)), px.submit(_cb(1))]
        go.set()
        assert entered.wait(TIMEOUT)
    finally:
        go.set()
        px.stop()
    for f in futs:
        assert isinstance(f.exception(timeout=TIMEOUT), PipelineStopped)
    assert stats._async == 0
    stats.reset()
    plan.run(_cb(3), stats=stats)
    assert stats.snapshot()["overlap_fraction"] == 0.0


def test_sync_run_balances_the_async_window_on_error():
    stats = PipelineStats()

    def boom(cb):
        raise RuntimeError("dies while the async window is open")

    plan = StagePlan("x", (
        Stage("launch", DEVICE, lambda cb: cb, opens_async=True),
        Stage("mid", HOST, boom),
        Stage("wait", DEVICE, _done, closes_async=True)))
    with pytest.raises(RuntimeError):
        plan.run(_cb(), stats=stats)
    assert stats._async == 0


def test_executor_rejects_bad_options():
    plan = StagePlan("x", (Stage("s", HOST, _done),))
    with pytest.raises(ValueError, match="workers"):
        PipelineExecutor(plan, workers="threads", device="cpu")
    with pytest.raises(ValueError, match="empty"):
        PipelineExecutor(StagePlan("x", ()), device="cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        PipelineExecutor(plan, device="meta")
    if not torch.cuda.is_available():
        # the default device is the card: no quiet CPU executor
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PipelineExecutor(plan)


def test_engine_rejects_an_unknown_worker_mode(retr):
    """A bad mode fails at construction, not at every batch (where the
    server's retries would serve it synchronously)."""
    with pytest.raises(ValueError, match="pipeline_workers"):
        ServeEngine(retr, pipeline_depth=2, pipeline_workers="threads")


def test_gather_futures_keeps_order_and_fails_on_the_first_error():
    from concurrent.futures import Future
    futs = [Future() for _ in range(3)]
    agg = gather_futures(futs)
    for i in (2, 0, 1):
        futs[i].set_result(i)
    assert agg.result(timeout=TIMEOUT) == [0, 1, 2]
    bad = [Future() for _ in range(2)]
    agg = gather_futures(bad)
    bad[1].set_exception(KeyError("b"))
    assert not agg.done()
    bad[0].set_result(0)
    with pytest.raises(KeyError):
        agg.result(timeout=TIMEOUT)
    assert gather_futures([]).result(timeout=TIMEOUT) == []


def test_host_copy_on_the_cpu_keeps_the_bits():
    s = torch.tensor([[1.5, -float("inf")], [0.1, 2.0]])
    i = torch.tensor([[3, -1], [0, 1]], dtype=torch.int32)
    hc = HostCopy(s, i)
    assert hc.event is None
    got_s, got_i = hc.wait()
    np.testing.assert_array_equal(got_s.view(np.uint32),
                                  s.numpy().view(np.uint32))
    np.testing.assert_array_equal(got_i, i.numpy())
    got_s[0, 0] = 9.0                      # a copy, not a view
    assert s[0, 0].item() == 1.5


def test_padded_ivf_is_built_once_under_concurrent_callers(built_index):
    searcher = PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"),
                             device="cpu")
    barrier = threading.Barrier(4)
    got = []

    def ask():
        barrier.wait(TIMEOUT)
        got.append(searcher.ivf_padded)

    threads = [threading.Thread(target=ask) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(TIMEOUT)
        assert not t.is_alive()
    assert len(got) == 4 and all(g is got[0] for g in got)
    assert vars(searcher)["ivf_padded"] is got[0]
