"""The port's front door against the JAX package's, with
``device="cpu"``: ``AdmissionController.decide`` gives equal decisions
and statistics over a grid of inputs; the stage names of the port's plans
include the JAX plans' and bucket the same way in the cost model;
through ``RetrievalServer`` admission degrades hybrid/rerank to the
``splade`` plan (the JAX server's answers, and bitwise the port's own
``splade`` answers) and sheds before a request is queued; the adaptive
batch cap shrinks under a tight SLO and grows back under a slack one;
an exact-cache hit is answered at ``submit`` without the queue."""

import itertools
import time

import numpy as np
import pytest

from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.core.plaid import PlaidParams as JPlaidParams
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import (SpladeIndex as JSplade,
                                      build_splade_index as j_build_splade)
from repro.serving import admission as jadm
from repro.serving.engine import (Request as JRequest,
                                  ServeEngine as JEngine)
from repro.serving.server import RetrievalServer as JServer
from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving import admission as tadm
from repro_torch.serving.admission import AdmissionController, RequestShed
from repro_torch.serving.context import (ADMIT_DEGRADED, ADMIT_FULL,
                                         ADMIT_SHED, CacheHierarchy)
from repro_torch.serving.engine import Request, Result, ServeEngine
from repro_torch.serving.pipeline import DEVICE, HOST
from repro_torch.serving.server import RetrievalServer

PLAID = dict(nprobe=8, candidate_cap=512, ndocs=128, k=50)
MS = dict(first_k=50, k=20)


@pytest.fixture(scope="module")
def splade_dir(small_corpus, tmp_path_factory):
    c = small_corpus
    path = tmp_path_factory.mktemp("splade_admission")
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(path)
    return path


def _retr(built_index, splade_dir, resident=False):
    return MultiStageRetriever(
        SpladeIndex.load(splade_dir, mmap=True),
        PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"),
                      PlaidParams(**PLAID), device_resident=resident,
                      device="cpu"),
        MultiStageParams(**MS), device="cpu")


def _jretr(built_index, splade_dir, resident=False):
    return JRetriever(JSplade.load(splade_dir, mmap=True),
                      JSearcher(JIndex(built_index, mode="mmap"),
                                JPlaidParams(**PLAID),
                                device_resident=resident),
                      JParams(**MS))


def _req(corpus, method, i, k=20, cls=Request, **kw):
    return cls(qid=i, method=method, q_emb=corpus["q_embs"][i],
               term_ids=corpus["q_term_ids"][i],
               term_weights=corpus["q_term_weights"][i], k=k, **kw)


def _assert_bitwise(ref, got):
    np.testing.assert_array_equal(ref.pids, got.pids)
    np.testing.assert_array_equal(np.asarray(ref.scores).view(np.uint32),
                                  np.asarray(got.scores).view(np.uint32))


# -- the controller against the JAX package's ------------------------------

def _snap(stage1_ms, tail_ms, dispatches=10):
    return {"splade_stage1": {"ewma_ms": stage1_ms,
                              "dispatches": dispatches},
            "device_score:maxsim": {"ewma_ms": tail_ms,
                                    "dispatches": dispatches}}


SNAPSHOTS = [{}, _snap(10, 20), _snap(10, 500), _snap(150, 500),
             _snap(5000, 5000), _snap(50, 60, dispatches=0),
             {"plaid_probe": {"ewma_ms": 3.0, "dispatches": 2},
              "host_gather:codes": {"ewma_ms": 40.0, "dispatches": 2},
              "fuse_splade": {"ewma_ms": 0.5, "dispatches": 4},
              "unknown_stage": {"ewma_ms": 1e6, "dispatches": 9}}]


@pytest.mark.parametrize("method", METHODS)
def test_decide_equals_the_jax_packages(method):
    ours = AdmissionController(100.0, shed_factor=3.0)
    theirs = jadm.AdmissionController(100.0, shed_factor=3.0)
    for snap, degradable, depth, cap, deadline in itertools.product(
            SNAPSHOTS, (False, True), (0, 1, 7, 64), (0, 1, 8),
            (None, 0.001, 30.0, 1e4)):
        args = (method, degradable, snap)
        kw = dict(queue_depth=depth, batch_cap=cap, deadline_ms=deadline)
        d, j = ours.decide(*args, **kw), theirs.decide(*args, **kw)
        assert (d.admission, d.reason) == (j.admission, j.reason), (args, kw)
        assert d.predicted_full_ms == j.predicted_full_ms
        assert d.predicted_cheap_ms == j.predicted_cheap_ms
        assert ours.stats() == theirs.stats()
    assert ours.stage_costs(SNAPSHOTS[-1]) == theirs.stage_costs(
        SNAPSHOTS[-1])


def test_admission_ladder():
    ac = AdmissionController(latency_slo_ms=100.0, shed_factor=3.0)
    assert ac.decide("hybrid", True, {}).reason == "cold_start"
    assert ac.decide("hybrid", True, _snap(10, 20)).admission == ADMIT_FULL
    d = ac.decide("hybrid", True, _snap(10, 500))
    assert (d.admission, d.reason) == (ADMIT_DEGRADED, "slo_tail")
    d = ac.decide("hybrid", True, _snap(150, 500))
    assert (d.admission, d.reason) == (ADMIT_DEGRADED, "slo_overload")
    d = ac.decide("colbert", False, _snap(10, 200))
    assert (d.admission, d.reason) == (ADMIT_FULL, "slo_best_effort")
    d = ac.decide("hybrid", True, _snap(5000, 5000))
    assert (d.admission, d.reason) == (ADMIT_SHED, "overload")
    assert ac.decide("splade", False,
                     _snap(50, 9000)).admission == ADMIT_FULL
    d = ac.decide("hybrid", True, _snap(50, 60), deadline_ms=1.0)
    assert (d.admission, d.reason) == (ADMIT_SHED, "deadline")
    s = ac.stats()
    assert (s["full_admits"], s["degraded_admits"], s["sheds"]) == (4, 2, 2)
    with pytest.raises(ValueError):
        AdmissionController(0.0)
    e = RequestShed("overload", 12.5)
    assert str(e) == str(jadm.RequestShed("overload", 12.5))


@pytest.mark.parametrize("pool", ["mmap", "resident"])
@pytest.mark.parametrize("tail", ["fused", "split"])
@pytest.mark.parametrize("method", METHODS)
def test_plan_stage_names_bucket_as_the_jax_packages(
        built_index, splade_dir, method, tail, pool):
    """The cost model reads stage names by prefix: the port's plans must
    keep producing the JAX plans' names (the port's colbert fused tail
    adds its sync stage, ``fused_rerank:sync``, as its rerank tail has),
    each in a bucket."""
    resident = pool == "resident"
    tr = _retr(built_index, splade_dir, resident)
    jr = _jretr(built_index, splade_dir, resident)
    tr.set_rerank_backend(tail)
    jr.set_rerank_backend(tail)
    names = [s.name for s in tr.compile_plan(method).stages]
    assert set(s.name for s in jr.compile_plan(method).stages) <= set(names)
    for name in names:
        assert tadm._bucket(name) == jadm._bucket(name)
        assert tadm._bucket(name) == ("stage1" if name in (
            "splade_stage1", "fuse_splade") else "tail"), name


# -- through the server ------------------------------------------------------

def _poison(retr, stage1_s, tail_s):
    for _ in range(4):                   # drive the EWMA, not one sample
        retr.pipeline_stats.record("splade_stage1", HOST, wall_s=stage1_s)
        retr.pipeline_stats.record("device_score:maxsim", DEVICE,
                                   wall_s=tail_s)


@pytest.mark.parametrize("method", ["hybrid", "rerank"])
def test_admission_degrades_to_splade(built_index, splade_dir, small_corpus,
                                      method):
    """A stalled tail degrades hybrid/rerank to the splade plan: the
    answer is the port's own splade answer bit for bit and the JAX
    server's degraded answer, flagged with the reason, and never lands in
    the exact cache."""
    caches = CacheHierarchy(exact_entries=64, stage1_entries=64)
    retr = _retr(built_index, splade_dir)
    srv = RetrievalServer(ServeEngine(retr, caches=caches),
                          admission=AdmissionController(50.0))
    jretr = _jretr(built_index, splade_dir)
    jsrv = JServer(JEngine(jretr), admission=jadm.AdmissionController(50.0))
    srv.start()
    jsrv.start()
    try:
        _poison(retr, stage1_s=0.001, tail_s=10.0)
        _poison(jretr, stage1_s=0.001, tail_s=10.0)
        res = srv.submit(_req(small_corpus, method, 7)).result(timeout=60)
        jres = jsrv.submit(_req(small_corpus, method, 7, cls=JRequest)
                           ).result(timeout=60)
        h = srv.health()
    finally:
        srv.stop()
        jsrv.stop()
    assert res.degraded and res.degrade_reason == "slo_tail"
    assert (jres.degraded, jres.degrade_reason) == (True, "slo_tail")
    np.testing.assert_array_equal(res.pids, np.asarray(jres.pids))
    np.testing.assert_allclose(res.scores, np.asarray(jres.scores),
                               rtol=1e-5, atol=1e-5)
    want = ServeEngine(_retr(built_index, splade_dir)).process(
        _req(small_corpus, "splade", 7))
    _assert_bitwise(want, res)
    assert len(caches.exact) == 0
    assert h["admission"]["degraded_admits"] == 1
    assert h["counters"]["admission_degraded"] == 1
    assert h["caches"]["exact"]["size"] == 0


@pytest.mark.parametrize("deadline_ms,reason", [(None, "overload"),
                                                (0.001, "deadline")])
def test_shed_happens_before_queueing(built_index, splade_dir, small_corpus,
                                      deadline_ms, reason):
    retr = _retr(built_index, splade_dir)
    srv = RetrievalServer(ServeEngine(retr),
                          admission=AdmissionController(50.0))
    # never started: a request that were queued would stay in the queue
    if deadline_ms is None:
        _poison(retr, stage1_s=10.0, tail_s=10.0)   # even splade hopeless
    else:
        _poison(retr, stage1_s=0.001, tail_s=0.001)
    fut = srv.submit(_req(small_corpus, "hybrid", 3,
                          deadline_ms=deadline_ms))
    with pytest.raises(RequestShed) as ei:
        fut.result(timeout=10)
    assert ei.value.reason == reason
    h = srv.health()
    assert h["sheds"] == 1 and h["served"] == 0 and h["queue_depth"] == 0
    assert h["admission"]["sheds"] == 1
    assert h["counters"]["admission_sheds"] == 1
    srv.stop()


def test_exact_hit_is_answered_at_submit(built_index, splade_dir,
                                         small_corpus):
    caches = CacheHierarchy(exact_entries=16)
    eng = ServeEngine(_retr(built_index, splade_dir), caches=caches)
    cold = eng.process(_req(small_corpus, "colbert", 4, k=9))
    srv = RetrievalServer(eng)                      # never started
    fut = srv.submit(_req(small_corpus, "colbert", 4, k=9))
    assert fut.done()
    hit = fut.result()
    assert hit.cache_hit and srv.queue.qsize() == 0
    _assert_bitwise(cold, hit)
    miss = srv.submit(_req(small_corpus, "colbert", 5, k=9))
    assert not miss.done() and srv.queue.qsize() == 1
    # the submit-time probe counts no miss
    assert caches.exact.misses == 1
    srv.stop()


class _PacedEngine:
    """Engine stub whose service time is settable at run time."""

    def __init__(self):
        self.served = 0
        self.delay_s = 0.0

    def _result(self, req):
        now = time.perf_counter()
        return Result(qid=req.qid, pids=np.array([0]),
                      scores=np.array([1.0]), t_arrival=req.t_arrival,
                      t_start=now, t_done=now + self.delay_s)

    def process(self, req):
        time.sleep(self.delay_s)
        self.served += 1
        return self._result(req)

    def process_batch(self, reqs):
        time.sleep(self.delay_s)
        self.served += len(reqs)
        return [self._result(r) for r in reqs]


def _drain(srv, n):
    futs = [srv.submit(Request(qid=i, method="splade")) for i in range(n)]
    for f in futs:
        f.result(timeout=30)


def test_batch_cap_shrinks_then_grows_back():
    eng = _PacedEngine()
    srv = RetrievalServer(eng, max_batch=8, batch_timeout_ms=1.0,
                          latency_slo_ms=20.0, slo_ewma_alpha=1.0)
    srv.start()
    try:
        assert srv.batch_cap == 8
        eng.delay_s = 0.06                      # 60 ms ≫ the 20 ms SLO
        _drain(srv, 12)
        assert srv.batch_cap < 8
        assert srv.health()["ewma_latency_ms"] > 20.0
        eng.delay_s = 0.06
        _drain(srv, 6)
        assert srv.batch_cap == 1
        eng.delay_s = 0.0
        _drain(srv, 60)
        assert srv.batch_cap > 1
        h = srv.health()
        assert h["batch_cap"] == srv.batch_cap and h["failed"] == 0
    finally:
        srv.stop()


def test_batch_cap_stays_fixed_without_an_slo():
    eng = _PacedEngine()
    eng.delay_s = 0.03
    srv = RetrievalServer(eng, max_batch=4, batch_timeout_ms=1.0)
    srv.start()
    try:
        _drain(srv, 8)
        h = srv.health()
        assert srv.batch_cap == 4 and h["batch_cap"] == 4
        assert h["ewma_latency_ms"] is None
    finally:
        srv.stop()


def test_health_reports_the_front_door(built_index, splade_dir,
                                       small_corpus):
    caches = CacheHierarchy(exact_entries=8, stage1_entries=8)
    srv = RetrievalServer(ServeEngine(_retr(built_index, splade_dir),
                                      caches=caches),
                          max_batch=4, batch_timeout_ms=20.0,
                          latency_slo_ms=1e4,
                          admission=AdmissionController(1e4))
    srv.start()
    try:
        futs = [srv.submit(_req(small_corpus, m, i))
                for i, m in enumerate(("splade", "hybrid", "colbert",
                                       "rerank"))]
        for f in futs:
            f.result(timeout=60)
        hit = srv.submit(_req(small_corpus, "hybrid", 1)).result(timeout=60)
        srv.drain()
        h = srv.health()
    finally:
        srv.stop()
    assert hit.cache_hit
    assert h["sheds"] == 0 and h["batch_cap"] >= 1
    assert h["ewma_latency_ms"] > 0
    assert h["admission"]["full_admits"] == 4
    assert h["caches"]["exact"]["hits"] == 1
    assert h["caches"]["exact"]["size"] == 4
    assert h["counters"]["cache_exact_hits"] == 1
    assert h["counters"]["cache_exact_stores"] == 4
