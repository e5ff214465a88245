"""The port's load generators against the JAX package's, on the CPU.

The generators are host code, so each is held to ``repro.serving.loadgen``
on the same inputs:

* ``zipf_trace`` and ``load_trace`` return the JAX arrays element for
  element, and raise the same error on an empty trace;
* ``_trace_counts``, ``LoadResult``'s percentiles and ``summary()`` give
  the JAX values on the same latencies (``nan`` where it has ``nan``);
* ``_run_scheduled``, through ``run_poisson_load`` and ``run_open_loop``,
  sleeps the same sequence of delays and submits the same qids in the
  same groups under a fake clock, and a late submitter skips its sleep;
  the schedules ``chip_smoke.py`` measures lateness against are these
  submit instants;
* sheds, failures, ``tolerate_failures`` and the cap of 8 kept errors
  are counted alike, and ``run_closed_loop`` keeps going after a failed
  request and raises the first error only when nothing succeeded — each
  package's stub raising its own package's ``RequestShed``;
* ``run_closed_loop(concurrency=1)`` through the port's
  ``RetrievalServer(device="cpu")`` and the JAX ``RetrievalServer`` on
  the ``built_index`` fixture, with an exact cache, counts the same
  served, failed and cache-hit requests; the answers, read through
  ``run_poisson_load``'s ``on_result``, meet the parity bar.

No assertion reads the wall clock: the schedule tests patch the
modules' ``time`` with a fake clock and use stub servers whose futures
are resolved at submit. Every server is stopped in a ``finally``, and a
fixture fails a test that leaves a closed-loop client, server worker or
pipeline thread alive.
"""

import dataclasses
import importlib.util
import math
import pathlib
import sys
import threading
import types
from concurrent.futures import Future

import numpy as np
import pytest

from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.core.plaid import PlaidParams as JPlaidParams
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import (SpladeIndex as JSplade,
                                      build_splade_index as j_build_splade)
from repro.serving import admission as j_admission
from repro.serving import engine as j_engine
from repro.serving import loadgen as j_loadgen
from repro.serving.context import CacheHierarchy as JCaches
from repro.serving.server import RetrievalServer as JServer
from repro_torch.core.multistage import MultiStageParams, MultiStageRetriever
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving import admission, engine, loadgen
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.server import RetrievalServer
from repro_torch.testing import REF_MARGIN, assert_topk_match

TIMEOUT = 30.0          # seconds: the bound on every join in this file
PLAID = dict(nprobe=8, candidate_cap=512, ndocs=128, k=50)
MS = dict(first_k=50, k=20)
# each package with the names its stubs use
PORT = types.SimpleNamespace(lg=loadgen, Request=engine.Request,
                             Result=engine.Result,
                             RequestShed=admission.RequestShed)
JAX = types.SimpleNamespace(lg=j_loadgen, Request=j_engine.Request,
                            Result=j_engine.Result,
                            RequestShed=j_admission.RequestShed)
PACKAGES = (PORT, JAX)


def _ours(t: threading.Thread) -> bool:
    return (t.name.startswith(("pipe-", "pipeline-retry", "worker-"))
            or t.name.endswith("(client)"))


@pytest.fixture(autouse=True)
def no_thread_left():
    """No closed-loop client, server worker or pipeline thread started by
    the test outlives it."""
    before = set(threading.enumerate())
    yield
    left = []
    for t in threading.enumerate():
        if t in before or not _ours(t):
            continue
        t.join(timeout=TIMEOUT)
        if t.is_alive():
            left.append(t.name)
    assert not left, f"threads left running: {left}"


def _same(a, b) -> bool:
    """Equal, ``nan`` equal to ``nan``."""
    if isinstance(a, float) and isinstance(b, float):
        return a == b or (math.isnan(a) and math.isnan(b))
    return a == b


def _same_summary(ours: dict, theirs: dict) -> None:
    assert ours.keys() == theirs.keys()
    for key in ours:
        assert _same(ours[key], theirs[key]), (key, ours[key], theirs[key])


# -- traces ------------------------------------------------------------------

@pytest.mark.parametrize("n_requests,n_unique,skew,seed", [
    (4000, 50, 1.1, 7), (512, 64, 1.1, 0), (300, 10, 0.5, 3),
    (100, 17, 0.0, 1), (64, 8, -1.0, 2), (1, 1, 1.1, 5), (0, 4, 1.1, 6)])
def test_zipf_trace_equals_jax(n_requests, n_unique, skew, seed):
    ours = loadgen.zipf_trace(n_requests, n_unique, skew=skew, seed=seed)
    theirs = j_loadgen.zipf_trace(n_requests, n_unique, skew=skew, seed=seed)
    assert ours.dtype == theirs.dtype and ours.shape == (n_requests,)
    np.testing.assert_array_equal(ours, theirs)
    assert ((0 <= ours) & (ours < n_unique)).all()


def test_zipf_trace_defaults_equal_jax():
    np.testing.assert_array_equal(loadgen.zipf_trace(200, 30),
                                  j_loadgen.zipf_trace(200, 30))


def test_load_trace_equals_jax(tmp_path):
    path = tmp_path / "trace.txt"
    path.write_text("# replay trace\n3\n\n  1  # a comment\n2\n#\n\n40\n")
    ours, theirs = loadgen.load_trace(path), j_loadgen.load_trace(path)
    assert ours.dtype == theirs.dtype == np.int64
    np.testing.assert_array_equal(ours, theirs)
    np.testing.assert_array_equal(ours, [3, 1, 2, 40])


def test_load_trace_reads_back_a_zipf_trace(tmp_path):
    trace = loadgen.zipf_trace(128, 16, seed=4)
    path = tmp_path / "zipf.txt"
    path.write_text("# zipf s=1.1\n\n" + "\n".join(map(str, trace)) + "\n")
    np.testing.assert_array_equal(loadgen.load_trace(path), trace)
    np.testing.assert_array_equal(j_loadgen.load_trace(path), trace)


@pytest.mark.parametrize("text", ["", "\n\n", "# only comments\n  # \n"])
def test_load_trace_rejects_an_empty_trace_as_jax_does(tmp_path, text):
    path = tmp_path / "empty.txt"
    path.write_text(text)
    with pytest.raises(ValueError) as ours:
        loadgen.load_trace(path)
    with pytest.raises(ValueError) as theirs:
        j_loadgen.load_trace(path)
    assert str(ours.value) == str(theirs.value)


# -- counts and summaries ----------------------------------------------------

@pytest.mark.parametrize("ids", [
    [], [(0, None)], [(0, None), (1, None), (2, None)],
    [(0, 7), (1, 7), (2, 3), (3, None), (4, 3)],
    [(5, None), (5, None), (6, 5)]])
def test_trace_counts_equal_jax(ids):
    counts = [pkg.lg._trace_counts([pkg.Request(qid=q, method="splade",
                                                trace_id=t)
                                    for q, t in ids])
              for pkg in PACKAGES]
    assert counts[0] == counts[1]
    assert sum(counts[0]) == len(ids)


@pytest.mark.parametrize("lat", [
    [], [0.004], [0.003, 0.001, 0.002], list(np.linspace(0.001, 0.2, 101))])
def test_load_result_summary_equals_jax(lat):
    kw = dict(latencies=np.asarray(lat), service_times=np.asarray(lat) / 2,
              wall_time=0.5 if lat else 0.0, offered_qps=123.0, failed=2,
              errors=[RuntimeError("x")], shed=3, degraded=1, cache_hits=4,
              unique_queries=5, repeat_queries=6)
    ours, theirs = loadgen.LoadResult(**kw), j_loadgen.LoadResult(**kw)
    _same_summary(ours.summary(), theirs.summary())
    for p in (0, 50, 90, 95, 99, 100):
        assert _same(ours.percentile(p), theirs.percentile(p))
    for name in ("p50", "p95", "p99", "achieved_qps"):
        assert _same(getattr(ours, name), getattr(theirs, name))
    if not lat:
        assert math.isnan(ours.p99) and math.isnan(
            ours.summary()["mean_service"])
        assert ours.achieved_qps == 0.0


# -- the schedule, under a fake clock ----------------------------------------

class FakeClock:
    """``perf_counter`` and ``sleep`` of a clock that only moves when the
    code sleeps or a stub submit spends its cost; every sleep is
    logged."""

    def __init__(self):
        self.t = 1000.0
        self.sleeps = []

    def perf_counter(self):
        return self.t

    def sleep(self, d):
        self.sleeps.append(d)
        self.t += d


class StubServer:
    """Submits resolve at once: with the shed or the error their qid is
    set up for (the stub's own package's ``RequestShed``), else with a
    result whose times follow from the qid. Each submit is logged at
    the clock's time and moves the clock by ``cost`` seconds."""

    def __init__(self, pkg, clock, cost=0.0, shed=(), fail=(),
                 degraded=(), hits=()):
        self.pkg, self.clock, self.cost = pkg, clock, cost
        self.shed, self.fail = set(shed), set(fail)
        self.degraded, self.hits = set(degraded), set(hits)
        self.log = []
        self.lock = threading.Lock()

    def submit(self, req):
        with self.lock:
            t = self.clock.perf_counter()
            self.log.append((t, req.qid))
            self.clock.t += self.cost
        fut = Future()
        q = req.qid
        if q in self.shed:
            fut.set_exception(self.pkg.RequestShed("queue", 1.5))
        elif q in self.fail:
            fut.set_exception(RuntimeError(f"request {q} failed"))
        else:
            fut.set_result(self.pkg.Result(
                qid=q, pids=np.array([q]), scores=np.ones(1, np.float32),
                t_arrival=t, t_start=t + 0.001 * (q % 3),
                t_done=t + 0.004 + 0.001 * q, degraded=q in self.degraded,
                cache_hit=q in self.hits))
        return fut


def _faked(monkeypatch, pkg):
    clock = FakeClock()
    monkeypatch.setattr(pkg.lg, "time", clock)
    return clock


def _requests(pkg, n, trace=None):
    return [pkg.Request(qid=i, method="splade",
                        trace_id=None if trace is None else int(trace[i]))
            for i in range(n)]


def _drive(monkeypatch, pkg, run, n=40, cost=0.0, trace=None, **stub):
    """Run ``run(server, requests)`` under a fake clock on a stub server
    → (LoadResult or the exception raised, the sleeps, the submits as
    (time since the first, qid), results handed to ``on_result``)."""
    clock = _faked(monkeypatch, pkg)
    srv = StubServer(pkg, clock, cost=cost, **stub)
    seen = []
    try:
        res = run(srv, _requests(pkg, n, trace), seen.append)
    except Exception as e:      # noqa: BLE001 — compared across packages
        res = e
    t0 = srv.log[0][0] if srv.log else 0.0
    return (res, clock.sleeps, [(t - t0, q) for t, q in srv.log],
            [r.qid for r in seen])


SCHEDULES = {
    "poisson": lambda s, r, on: s.pkg.lg.run_poisson_load(
        s, r, qps=200.0, seed=3, on_result=on),
    "poisson_burst3": lambda s, r, on: s.pkg.lg.run_poisson_load(
        s, r, qps=200.0, seed=4, burst=3, on_result=on),
    "poisson_scaled": lambda s, r, on: s.pkg.lg.run_poisson_load(
        s, r, qps=50.0, seed=5, time_scale=4.0, on_result=on),
    "open_loop": lambda s, r, on: s.pkg.lg.run_open_loop(
        s, r, arrival_rate=300.0, seed=6),
}


@pytest.mark.parametrize("cost", [0.0, 0.004])
@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_equals_jax(monkeypatch, schedule, cost):
    """The same sleeps, the same submit instants and groups, the same
    summary; with ``cost`` per submit the submitter runs late and skips
    the sleeps it is behind on."""
    run = SCHEDULES[schedule]
    ours, theirs = (_drive(monkeypatch, pkg, run, cost=cost)
                    for pkg in PACKAGES)
    assert ours[1] == theirs[1]
    assert ours[2] == theirs[2]
    assert ours[3] == theirs[3]
    _same_summary(ours[0].summary(), theirs[0].summary())
    res, sleeps, submits, seen = ours
    assert [q for _, q in submits] == list(range(40))
    burst = 3 if schedule == "poisson_burst3" else 1
    arrivals = -(-40 // burst)
    assert len(sleeps) <= arrivals and all(d > 0 for d in sleeps)
    if cost == 0.0:
        # each group of `burst` qids enters at one instant, after a sleep
        assert len(sleeps) == arrivals
        assert [t for t, _ in submits] == [submits[i - i % burst][0]
                                           for i in range(40)]
    else:
        assert len(sleeps) < arrivals       # late: some sleeps skipped
    assert res.summary()["n"] == 40
    assert seen == ([] if schedule == "open_loop" else list(range(40)))


def test_schedule_is_absolute(monkeypatch):
    """The submit instants are the cumulative gaps from the start: a
    late submit does not push the later ones back."""
    rng = np.random.default_rng(3)
    gaps = rng.exponential(1 / 200.0, 40)
    _, sleeps, submits, _ = _drive(
        monkeypatch, PORT, SCHEDULES["poisson"], cost=0.0)
    np.testing.assert_allclose([t for t, _ in submits],
                               np.cumsum(gaps) - gaps[0], rtol=0,
                               atol=1e-9)
    _, sleeps, late, _ = _drive(monkeypatch, PORT, SCHEDULES["poisson"],
                                cost=0.05)
    # a submit costs 50 ms, 10 mean gaps: after its first sleep the
    # submitter runs behind the whole way and never sleeps again
    assert len(sleeps) == 1
    np.testing.assert_allclose([t for t, _ in late], 0.05 * np.arange(40),
                               rtol=0, atol=1e-9)


def _chip_smoke(monkeypatch):
    """``chip_smoke.py`` as a module, listed in ``sys.modules`` for the
    test only: its top level imports host code only."""
    path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_schedules",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, spec.name, mod)
    monkeypatch.setattr(sys, "path", list(sys.path))
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("n", [40, 41])
@pytest.mark.parametrize("how,rate,seed,burst", [
    ("open_loop", 300.0, 6, 1), ("open_loop", 45.5, 11, 1),
    ("poisson", 200.0, 3, 1), ("poisson", 200.0, 4, 3),
    ("poisson", 97.0, 8, 8)])
def test_chip_smoke_schedules_are_the_generators(monkeypatch, how, rate,
                                                 seed, burst, n):
    """The due instants ``chip_smoke.py`` measures the submitter's
    lateness against are the instants at which the port's generators
    submit under a fake clock, through its ``LoadProxy``: each request
    0 s late, in order."""
    cs = _chip_smoke(monkeypatch)
    clock = _faked(monkeypatch, PORT)
    monkeypatch.setattr(cs, "time", clock)
    proxy = cs.LoadProxy(StubServer(PORT, clock))
    reqs = _requests(PORT, n)
    t_call = clock.perf_counter()
    if how == "open_loop":
        loadgen.run_open_loop(proxy, reqs, arrival_rate=rate, seed=seed)
        due = cs.open_loop_schedule(n, rate, seed)
    else:
        loadgen.run_poisson_load(proxy, reqs, qps=rate, seed=seed,
                                 burst=burst)
        due = cs.poisson_schedule(n, rate, seed, burst=burst)
    assert [r.qid for r, _, _ in proxy.sent] == list(range(n))
    np.testing.assert_allclose([t - t_call for _, _, t in proxy.sent], due,
                               rtol=0, atol=1e-9)


OUTCOMES = dict(shed={1, 5, 9}, fail={2, 3, 11, 13, 17, 19, 23, 29, 31, 37},
                degraded={4, 6}, hits={7, 8, 10})


@pytest.mark.parametrize("schedule", ["poisson", "poisson_burst3"])
def test_tolerated_failures_are_counted_as_jax_does(monkeypatch, schedule):
    """Sheds are counted, never failures; with ``tolerate_failures``
    every failure is counted and the first 8 kept; degraded and cache-hit
    answers are in the latencies and counted apart."""
    def run(s, r, on):
        burst = 3 if schedule == "poisson_burst3" else 1
        return s.pkg.lg.run_poisson_load(s, r, qps=200.0, seed=4,
                                         burst=burst, on_result=on,
                                         tolerate_failures=True)
    trace = loadgen.zipf_trace(40, 12, seed=1)
    ours, theirs = (_drive(monkeypatch, pkg, run, trace=trace, **OUTCOMES)
                    for pkg in PACKAGES)
    _same_summary(ours[0].summary(), theirs[0].summary())
    res = ours[0]
    s = res.summary()
    assert (s["n"], s["shed"], s["failed"]) == (27, 3, 10)
    assert (s["degraded"], s["cache_hits"]) == (2, 3)
    assert s["unique_queries"] + s["repeat_queries"] == 40
    assert (s["unique_queries"], s["repeat_queries"]) == \
        loadgen._trace_counts(_requests(PORT, 40, trace))
    assert [str(e) for e in res.errors] == [
        f"request {q} failed" for q in (2, 3, 11, 13, 17, 19, 23, 29)]
    assert [str(e) for e in res.errors] == [str(e) for e in
                                            theirs[0].errors]
    assert ours[3] == theirs[3] == [q for q in range(40) if q not in
                                    OUTCOMES["shed"] | OUTCOMES["fail"]]


@pytest.mark.parametrize("schedule", ["poisson", "open_loop"])
def test_a_failure_aborts_an_intolerant_run_as_jax_does(monkeypatch,
                                                        schedule):
    """Without ``tolerate_failures`` the first failed future raises its
    exception; a shed before it does not."""
    ours, theirs = (_drive(monkeypatch, pkg, SCHEDULES[schedule],
                           shed={0, 1}, fail={5, 6}) for pkg in PACKAGES)
    for got in (ours[0], theirs[0]):
        assert isinstance(got, RuntimeError) and str(got) == \
            "request 5 failed"
    assert ours[2] == theirs[2]                 # every request submitted


def test_each_package_counts_only_its_own_shed(monkeypatch):
    """A stub raising the other package's ``RequestShed`` is a failure
    to the loadgen, not a shed: each module catches its own class."""
    clock = _faked(monkeypatch, PORT)
    srv = StubServer(JAX, clock, shed={0, 1, 2})
    res = loadgen.run_poisson_load(srv, _requests(PORT, 6), qps=100.0,
                                   tolerate_failures=True)
    assert (res.shed, res.failed) == (0, 3)
    srv = StubServer(PORT, clock, shed={0, 1, 2})
    res = loadgen.run_poisson_load(srv, _requests(PORT, 6), qps=100.0,
                                   tolerate_failures=True)
    assert (res.shed, res.failed) == (3, 0)


# -- the closed loop ----------------------------------------------------------

def _closed(concurrency):
    return lambda s, r, on: s.pkg.lg.run_closed_loop(
        s, r, concurrency=concurrency)


@pytest.mark.parametrize("concurrency", [1, 3, 8])
def test_closed_loop_counts_equal_jax(monkeypatch, concurrency):
    """Every request is submitted once; a failed request does not end
    its client; sheds, failures (the first 8 kept), degraded answers and
    cache hits are counted as the JAX loadgen counts them."""
    trace = loadgen.zipf_trace(40, 12, seed=2)
    ours, theirs = (_drive(monkeypatch, pkg, _closed(concurrency),
                           trace=trace, **OUTCOMES) for pkg in PACKAGES)
    a, b = ours[0].summary(), theirs[0].summary()
    for key in ("n", "failed", "shed", "degraded", "cache_hits",
                "unique_queries", "repeat_queries"):
        assert a[key] == b[key], key
    assert (a["n"], a["shed"], a["failed"]) == (27, 3, 10)
    assert sorted(q for _, q in ours[2]) == list(range(40))
    assert len(ours[0].errors) == len(theirs[0].errors) == 8
    np.testing.assert_array_equal(np.sort(ours[0].latencies),
                                  np.sort(theirs[0].latencies))
    if concurrency == 1:
        assert ours[2] == theirs[2]               # in order, one at a time
        assert [str(e) for e in ours[0].errors] == [
            str(e) for e in theirs[0].errors]
        np.testing.assert_array_equal(ours[0].latencies,
                                      theirs[0].latencies)


@pytest.mark.parametrize("concurrency", [1, 4])
def test_closed_loop_raises_only_when_nothing_succeeded(monkeypatch,
                                                        concurrency):
    every = set(range(10))
    ours, theirs = (_drive(monkeypatch, pkg, _closed(concurrency), n=10,
                           fail=every) for pkg in PACKAGES)
    for got in (ours[0], theirs[0]):
        assert isinstance(got, RuntimeError)
        assert str(got).startswith("request ") and \
            str(got).endswith(" failed")
    assert sorted(q for _, q in ours[2]) == list(range(10))
    # one success is enough to report instead of raising
    ours, theirs = (_drive(monkeypatch, pkg, _closed(concurrency), n=10,
                           fail=every - {7}) for pkg in PACKAGES)
    for got in (ours[0], theirs[0]):
        assert (got.summary()["n"], got.failed, len(got.errors)) == \
            (1, 9, 8)
    # sheds alone are not failures: nothing raised, nothing served
    ours, theirs = (_drive(monkeypatch, pkg, _closed(concurrency), n=10,
                           shed=every) for pkg in PACKAGES)
    for got in (ours[0], theirs[0]):
        assert (got.summary()["n"], got.shed, got.failed) == (0, 10, 0)
        assert math.isnan(got.p50)


def test_closed_loop_offered_rate_is_what_it_served(monkeypatch):
    """Its offered rate is the requests over the run's wall time (the
    fake clock moves only by the submits' cost)."""
    ours, theirs = (_drive(monkeypatch, pkg, _closed(1), n=20, cost=0.01)
                    for pkg in PACKAGES)
    for got in (ours[0], theirs[0]):
        assert got.wall_time == pytest.approx(0.2, abs=1e-9)
        assert got.offered_qps == pytest.approx(100.0)
        assert got.achieved_qps == pytest.approx(100.0)


# -- through the real servers, on the CPU ------------------------------------

@pytest.fixture(scope="module")
def splade_dir(small_corpus, tmp_path_factory):
    c = small_corpus
    path = tmp_path_factory.mktemp("splade_loadgen")
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(path)
    return path


@pytest.fixture(scope="module")
def retrievers(built_index, splade_dir):
    ours = MultiStageRetriever(
        SpladeIndex.load(splade_dir, mmap=True),
        PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"),
                      PlaidParams(**PLAID), device="cpu"),
        MultiStageParams(**MS), device="cpu")
    theirs = JRetriever(JSplade.load(splade_dir, mmap=True),
                        JSearcher(JIndex(built_index, mode="mmap"),
                                  JPlaidParams(**PLAID)),
                        JParams(**MS))
    return ours, theirs


METHODS = ("hybrid", "colbert", "rerank", "splade")


def _trace_requests(pkg, corpus, trace, deeper=0):
    """One request per trace entry: distinct request ``j`` asks the
    corpus's query ``j`` by method ``j % 4`` at k 5 or 10; repeats are
    equal requests (``trace_id`` = j) under their own qids."""
    out = []
    for i, j in enumerate(trace.tolist()):
        out.append(pkg.Request(
            qid=i, method=METHODS[j % 4], q_emb=corpus["q_embs"][j],
            term_ids=corpus["q_term_ids"][j],
            term_weights=corpus["q_term_weights"][j],
            k=(5, 10)[j % 2] + deeper, trace_id=j))
    return out


def _servers(retrievers):
    """A port and a JAX server, each with fresh exact and stage-1 caches,
    over retrievers whose stage records and counters are cleared."""
    ours, theirs = retrievers
    ours.reset_stage_stats()
    theirs.reset_stage_stats()
    return (RetrievalServer(engine.ServeEngine(
                ours, caches=CacheHierarchy(64, 64)), max_batch=4),
            JServer(j_engine.ServeEngine(theirs, caches=JCaches(64, 64)),
                    max_batch=4))


def test_closed_loop_through_the_servers_equals_jax(retrievers,
                                                    small_corpus):
    """run_closed_loop(concurrency=1) on both servers, with an exact
    cache: the same served, failed and cache-hit counts; then the same
    trace through run_poisson_load on fresh caches, every answer read
    through ``on_result`` held to the JAX answer ``REF_MARGIN`` places
    deeper. (Whether a repeat hits there depends on timing: a repeat
    queued before its first answer is stored misses.)"""
    trace = loadgen.zipf_trace(24, 10, skew=1.1, seed=9)
    unique = len(set(trace.tolist()))
    servers = _servers(retrievers)
    try:
        for srv in servers:
            srv.start()
        results = [pkg.lg.run_closed_loop(
            srv, _trace_requests(pkg, small_corpus, trace), concurrency=1)
            for pkg, srv in zip(PACKAGES, servers)]
        health = [srv.health() for srv in servers]
    finally:
        for srv in servers:
            srv.stop()
    ours, theirs = (r.summary() for r in results)
    for key in ("n", "failed", "shed", "degraded", "cache_hits",
                "unique_queries", "repeat_queries"):
        assert ours[key] == theirs[key], key
    assert (ours["n"], ours["failed"], ours["cache_hits"]) == (
        24, 0, 24 - unique)
    assert (ours["unique_queries"], ours["repeat_queries"]) == (
        unique, 24 - unique)
    for key in ("served", "failed", "sheds"):
        assert health[0][key] == health[1][key], key
    assert health[0]["counters"]["cache_exact_hits"] == \
        health[1]["counters"]["cache_exact_hits"] == 24 - unique

    answers = ([], [])
    servers = _servers(retrievers)
    try:
        for srv in servers:
            srv.start()
        for pkg, srv, seen, deeper in zip(PACKAGES, servers, answers,
                                          (0, REF_MARGIN)):
            res = pkg.lg.run_poisson_load(
                srv, _trace_requests(pkg, small_corpus, trace, deeper),
                qps=2000.0, seed=1, burst=2, on_result=seen.append)
            assert (res.summary()["n"], res.failed) == (24, 0)
    finally:
        for srv in servers:
            srv.stop()
    assert [r.qid for r in answers[0]] == [r.qid for r in answers[1]] == \
        list(range(24))
    for got, want, j in zip(*answers, trace.tolist()):
        assert_topk_match(want.scores, want.pids, got.scores, got.pids,
                          what=f"qid {got.qid} {METHODS[j % 4]}")


def test_open_loop_through_the_server_answers_every_request(retrievers,
                                                            small_corpus):
    """run_open_loop through the port's server: every request answered,
    none failed, the trace's identity mix counted (timing not read)."""
    trace = loadgen.zipf_trace(16, 16, skew=0.0, seed=3)
    srv = _servers(retrievers)[0]
    srv.start()
    try:
        res = loadgen.run_open_loop(
            srv, [dataclasses.replace(r, trace_id=None) for r in
                  _trace_requests(PORT, small_corpus, trace)],
            arrival_rate=4000.0, seed=2)
        health = srv.health()
    finally:
        srv.stop()
    s = res.summary()
    assert (s["n"], s["failed"], s["shed"]) == (16, 0, 0)
    assert (s["unique_queries"], s["repeat_queries"]) == (16, 0)
    assert s["cache_hits"] == health["counters"].get("cache_exact_hits", 0)
    assert health["served"] == 16 and health["failed"] == 0
    assert s["p50"] <= s["p95"] <= s["p99"]
