"""The port's TCP front against the JAX package's, with ``device="cpu"``.

Wire parity: the JAX ``RetrievalServer`` and the port's each serve
behind their own ``TCPRetrievalServer`` on ``127.0.0.1:0``, over the
same index, with an exact cache and an admission controller, and get
the same lines: the four methods, k 5 and 10, the defaults, a repeat
that hits the exact cache, an admission degrade and a shed, malformed
JSON, a missing ``qid``, an unknown method, an unknown op, the live
admin ops with and without their arguments, ``live_stats`` and
``health``, on one persistent connection and in one-shot
``tcp_query`` calls. Each reply has the JAX reply's keys; pids and
scores meet the parity bar (``assert_topk_match`` against the JAX
engine's answer ``REF_MARGIN`` places deeper); errors from the same code
have the same text.

The admin ops on a live index: a port front and a JAX front, each over
a live retriever on its own copy of the index, get the same upserts,
deletes, compactions, ``live_stats`` and ``health`` lines: every admin
reply equals the JAX reply (``health``'s ``live`` and
``index_generation``), and the queries after each mutation meet the
parity bar against the JAX front's answers ``REF_MARGIN`` places deeper.

Port only: ``serve_tcp`` on port 0; ``shutdown_gracefully`` idempotent,
its second caller returning only after the drain; a front that was
never served shutting down; the SIGTERM handler draining queued
requests; a pipelined server's replies over TCP equal the synchronous
server's bit for bit; a shed reply.

Every wait is bounded by ``TIMEOUT``; thread order is forced by
``threading.Event``s, never by sleeping; every server is shut down in
a ``finally``, and a fixture checks that no serve, handler, drain,
pipeline or worker thread outlives its test.
"""

import json
import os
import shutil
import signal
import socket
import threading

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
from repro.serving.context import CacheHierarchy as JCaches
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro.serving.pipeline import DEVICE as J_DEVICE
from repro.serving.pipeline import HOST as J_HOST
from repro.serving.server import RetrievalServer as JServer
from repro_torch.core.multistage import MultiStageParams, MultiStageRetriever
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, Result, ServeEngine
from repro_torch.serving.pipeline import DEVICE, HOST
from repro_torch.serving.server import (RetrievalServer, tcp_query,
                                        wire_request)
from repro_torch.testing import REF_MARGIN, assert_topk_match

TIMEOUT = 30.0          # seconds: the bound on every wait in this file
HOST_ADDR = "127.0.0.1"
PLAID = dict(nprobe=8, candidate_cap=512, ndocs=128, k=50)
MS = dict(first_k=50, k=20)
LIVE_OFF = "live index not enabled (enable_live / --live)"


def _ours(t: threading.Thread) -> bool:
    return (t.name.startswith(("tcp-serve", "sigterm-drain", "pipe-",
                               "pipeline-retry", "worker-"))
            or "process_request_thread" in t.name)


@pytest.fixture(autouse=True)
def no_server_thread_left():
    """No serve_forever thread (``tcp-serve*``), connection handler,
    ``sigterm-drain``, pipeline or server worker thread started by the
    test outlives it."""
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


@pytest.fixture(scope="module")
def splade_dir(small_corpus, tmp_path_factory):
    c = small_corpus
    path = tmp_path_factory.mktemp("splade_tcp")
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(path)
    return path


def _retr(built_index, splade_dir):
    return MultiStageRetriever(
        SpladeIndex.load(splade_dir, mmap=True),
        PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"),
                      PlaidParams(**PLAID), device="cpu"),
        MultiStageParams(**MS), device="cpu")


def _jretr(built_index, splade_dir):
    return JRetriever(JSplade.load(splade_dir, mmap=True),
                      JSearcher(JIndex(built_index, mode="mmap"),
                                JPlaidParams(**PLAID)),
                      JParams(**MS))


@pytest.fixture(scope="module")
def retr(built_index, splade_dir):
    return _retr(built_index, splade_dir)


def _line(payload) -> bytes:
    return (payload if isinstance(payload, bytes)
            else (json.dumps(payload) + "\n").encode())


class _Client:
    """One persistent connection: a request line out, its reply in."""

    def __init__(self, port: int):
        self.sock = socket.create_connection((HOST_ADDR, port),
                                             timeout=TIMEOUT)
        self.rfile = self.sock.makefile("rb")

    def ask(self, payload) -> dict:
        self.sock.sendall(_line(payload))
        return json.loads(self.rfile.readline())

    def close(self):
        self.rfile.close()
        self.sock.close()


def _serve(srv, name="tcp-serve"):
    """Attach the front on an ephemeral port and run it on a thread."""
    tcp = srv.serve_tcp(HOST_ADDR, 0)
    t = threading.Thread(target=tcp.serve_forever, name=name, daemon=True)
    t.start()
    return tcp, t


def _refused(port: int) -> bool:
    try:
        socket.create_connection((HOST_ADDR, port), timeout=TIMEOUT).close()
    except ConnectionRefusedError:
        return True
    return False


def _query(corpus, qid, i, method=None, k=None):
    """A query line for the corpus's query ``i``; ``None`` leaves the
    field out (the front's defaults: hybrid, k=10)."""
    msg = {"qid": qid, "q_emb": corpus["q_embs"][i].tolist(),
           "term_ids": corpus["q_term_ids"][i].tolist(),
           "term_weights": corpus["q_term_weights"][i].tolist()}
    if method is not None:
        msg["method"] = method
    if k is not None:
        msg["k"] = k
    return msg


def _poison(stats, host, device, stage1_s, tail_s):
    for _ in range(4):                   # drive the EWMA, not one sample
        stats.record("splade_stage1", host, wall_s=stage1_s)
        stats.record("device_score:maxsim", device, wall_s=tail_s)


# -- wire parity -------------------------------------------------------------

def _lines(corpus):
    """(name, payload, how it goes: "conn" on the persistent connection
    or "once" through ``tcp_query``, the corpus query and method of its
    reference answer or None), in the order sent. The ``degrade`` and
    ``shed`` lines follow a change of admission (see ``wire``)."""
    upsert = {"op": "upsert", "doc_emb": corpus["q_embs"][0][:3].tolist(),
              "term_ids": [1, 2], "term_weights": [0.5, 0.25]}
    return [
        ("hybrid_k10", _query(corpus, 0, 0, "hybrid", 10), "conn",
         (0, "hybrid", 10)),
        ("rerank_k5", _query(corpus, 1, 1, "rerank", 5), "conn",
         (1, "rerank", 5)),
        ("splade_k10", _query(corpus, 2, 2, "splade", 10), "conn",
         (2, "splade", 10)),
        ("colbert_k5", _query(corpus, 3, 3, "colbert", 5), "conn",
         (3, "colbert", 5)),
        ("colbert_k10_once", _query(corpus, 4, 4, "colbert", 10), "once",
         (4, "colbert", 10)),
        ("repeat_exact_hit", _query(corpus, 5, 0, "hybrid", 10), "conn",
         (0, "hybrid", 10)),
        ("defaults", _query(corpus, 6, 6), "conn", (6, "hybrid", 10)),
        ("splade_k5_once", _query(corpus, 7, 7, "splade", 5), "once",
         (7, "splade", 5)),
        ("malformed_json", b"{\"qid\": 8, oops\n", "conn", None),
        ("missing_qid", {k: v for k, v in _query(corpus, 9, 9, "splade",
                                                 5).items() if k != "qid"},
         "conn", None),
        ("unknown_method", _query(corpus, 10, 10, "bogus", 5), "conn", None),
        ("unknown_op", {"op": "frobnicate", "qid": 11}, "conn", None),
        ("upsert", upsert, "conn", None),
        ("upsert_no_doc", {"op": "upsert", "qid": 12}, "conn", None),
        ("delete", {"op": "delete", "pid": 3}, "conn", None),
        ("delete_no_pid", {"op": "delete"}, "once", None),
        ("compact", {"op": "compact"}, "conn", None),
        ("live_stats", {"op": "live_stats"}, "conn", None),
        ("health", {"op": "health"}, "conn", None),
        ("degrade", _query(corpus, 13, 13, "hybrid", 10), "conn",
         (13, "splade", 10)),
        ("shed", _query(corpus, 14, 14, "rerank", 10), "conn", None),
    ]


LINE_NAMES = ("hybrid_k10", "rerank_k5", "splade_k10", "colbert_k5",
              "colbert_k10_once", "repeat_exact_hit", "defaults",
              "splade_k5_once", "malformed_json", "missing_qid",
              "unknown_method", "unknown_op", "upsert", "upsert_no_doc",
              "delete", "delete_no_pid", "compact", "live_stats", "health",
              "degrade", "shed")
# the exact error text is the same code's in both packages
SAME_TEXT = ("malformed_json", "missing_qid", "unknown_op", "upsert",
             "upsert_no_doc", "delete", "delete_no_pid", "compact")


def _converse(srv, port, lines, stats, host, device, admission):
    """Send ``lines`` to one front; → {name: reply}. Before ``degrade``
    the admission controller's SLO drops to 50 ms with a stalled tail;
    before ``shed`` stage 1 stalls too."""
    out = {}
    conn = _Client(port)
    try:
        for name, payload, how, _ in lines:
            if name == "degrade":
                srv.admission = admission(50.0)
                _poison(stats, host, device, stage1_s=0.001, tail_s=10.0)
            elif name == "shed":
                _poison(stats, host, device, stage1_s=10.0, tail_s=10.0)
            out[name] = (conn.ask(payload) if how == "conn"
                         else tcp_query(HOST_ADDR, port, payload))
    finally:
        conn.close()
    return out


@pytest.fixture(scope="module")
def wire(built_index, splade_dir, small_corpus):
    """Both fronts' replies to the same lines, the JAX engine's deeper
    reference answers, and each front's bound port."""
    lines = _lines(small_corpus)
    assert tuple(name for name, *_ in lines) == LINE_NAMES
    retr = _retr(built_index, splade_dir)
    srv = RetrievalServer(ServeEngine(retr, caches=CacheHierarchy(64, 64)),
                          max_batch=4,
                          admission=AdmissionController(1e9))
    jretr = _jretr(built_index, splade_dir)
    jsrv = JServer(JEngine(jretr, caches=JCaches(64, 64)), max_batch=4,
                   admission=jadm.AdmissionController(1e9))
    threads = []
    srv.start()
    jsrv.start()
    try:
        _, t = _serve(srv, "tcp-serve-port")
        threads.append(t)
        _, t = _serve(jsrv, "tcp-serve-jax")
        threads.append(t)
        ours = _converse(srv, srv.tcp_port, lines, retr.pipeline_stats,
                         HOST, DEVICE, AdmissionController)
        theirs = _converse(jsrv, jsrv.tcp_port, lines, jretr.pipeline_stats,
                           J_HOST, J_DEVICE, jadm.AdmissionController)
    finally:
        srv.shutdown_gracefully()
        jsrv.shutdown_gracefully()
        jsrv.tcp.server_close()
        for t in threads:
            t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    plain = JEngine(_jretr(built_index, splade_dir))
    refs = {}
    for name, _, _, ref in lines:
        if ref is not None:
            i, method, k = ref
            refs[name] = plain.process(JRequest(
                qid=i, method=method, q_emb=small_corpus["q_embs"][i],
                term_ids=small_corpus["q_term_ids"][i],
                term_weights=small_corpus["q_term_weights"][i],
                k=k + REF_MARGIN))
    return {"ours": ours, "theirs": theirs, "refs": refs,
            "ports": (srv.tcp_port, jsrv.tcp_port)}


@pytest.mark.parametrize("name", LINE_NAMES)
def test_reply_equals_the_jax_fronts(wire, name):
    ours, theirs = wire["ours"][name], wire["theirs"][name]
    if name == "health":
        assert ours["ok"] is theirs["ok"] is True
        assert set(theirs["health"]) <= set(ours["health"])
        assert ours["health"]["port"] == wire["ports"][0]
        assert theirs["health"]["port"] == wire["ports"][1]
        assert ours["health"]["n_shards"] == theirs["health"]["n_shards"]
        return
    assert set(ours) == set(theirs), (ours, theirs)
    if name in wire["refs"]:
        ref = wire["refs"][name]
        for key in ("qid", "cache_hit", "degraded", "degrade_reason",
                    "missing_shards"):
            assert ours.get(key) == theirs.get(key), key
        for got in (ours, theirs):
            assert_topk_match(ref.scores, ref.pids,
                              np.asarray(got["scores"], np.float32),
                              np.asarray(got["pids"]), what=name)
        return
    if name in SAME_TEXT or "error" not in theirs:
        assert ours == theirs
    else:
        assert ours["error"] and theirs["error"]
        assert {k: v for k, v in ours.items() if k != "error"} == \
            {k: v for k, v in theirs.items() if k != "error"}


def test_wire_covers_the_front_doors_outcomes(wire):
    """The conversation reached every outcome it was built for."""
    ours = wire["ours"]
    assert ours["repeat_exact_hit"]["cache_hit"] is True
    assert "cache_hit" not in ours["hybrid_k10"]
    assert ours["repeat_exact_hit"]["pids"] == ours["hybrid_k10"]["pids"]
    assert ours["repeat_exact_hit"]["scores"] == ours["hybrid_k10"]["scores"]
    assert (ours["degrade"]["degraded"], ours["degrade"]["degrade_reason"],
            ours["degrade"]["missing_shards"]) == (True, "slo_tail", [])
    assert ours["shed"]["shed"] is True and ours["shed"]["qid"] == 14
    assert ours["shed"]["reason"] == "overload"
    assert ours["live_stats"] == {"ok": True, "live": None}
    for name in ("upsert", "delete", "compact"):
        assert ours[name] == {"error": LIVE_OFF}
    assert ours["upsert_no_doc"] == {"error": "'doc_emb'", "qid": 12}
    assert ours["delete_no_pid"] == {"error": "'pid'"}
    assert ours["missing_qid"] == {"error": "'qid'"}
    assert ours["unknown_op"] == {"error": "unknown op 'frobnicate'",
                                  "qid": 11}
    assert ours["unknown_method"]["qid"] == 10
    assert ours["malformed_json"]["error"].startswith("Expecting")
    assert len(ours["defaults"]["pids"]) == 10
    assert len(ours["rerank_k5"]["pids"]) == 5


# -- the port's own front ----------------------------------------------------

def test_serve_tcp_on_port_zero_reports_the_port(retr, capsys):
    srv = RetrievalServer(ServeEngine(retr))
    assert srv.health()["port"] is None
    tcp, t = _serve(srv)
    try:
        port = srv.tcp_port
        assert port == tcp.server_address[1] and port > 0
        assert f"RETRIEVAL_PORT={port}\n" in capsys.readouterr().out
        h = srv.health()
        assert h["port"] == port and h["n_shards"] == 1
        srv.start()
        out = tcp_query(HOST_ADDR, port, {"qid": 3, "method": "splade",
                                          "term_ids": [1, 5, 9],
                                          "term_weights": [1.0, 0.5, 2.0],
                                          "k": 4})
        assert out["qid"] == 3 and len(out["pids"]) == len(out["scores"]) == 4
    finally:
        srv.shutdown_gracefully()
        t.join(timeout=TIMEOUT)
    assert not t.is_alive()
    assert _refused(port)


def test_a_front_never_served_shuts_down(retr):
    """``TCPServer.shutdown`` alone would wait forever here."""
    srv = RetrievalServer(ServeEngine(retr))
    srv.start()
    srv.serve_tcp(HOST_ADDR, 0)
    port = srv.tcp_port
    done = threading.Event()

    def shut():
        srv.shutdown_gracefully()
        done.set()

    t = threading.Thread(target=shut, name="tcp-serve-shutdown",
                         daemon=True)
    t.start()
    assert done.wait(TIMEOUT), "shutdown_gracefully hung"
    t.join(timeout=TIMEOUT)
    assert srv.health()["workers"] == 0
    assert _refused(port)
    srv.tcp.serve_forever()              # after the stop: returns at once


class _GatedEngine:
    """Engine stub whose ``process`` waits for ``release``."""

    def __init__(self, log):
        self.served = 0
        self.log = log
        self.entered = threading.Event()
        self.release = threading.Event()

    def process(self, req):
        self.entered.set()
        assert self.release.wait(TIMEOUT)
        self.served += 1
        self.log.append("served")
        return Result(qid=req.qid, pids=np.array([0]),
                      scores=np.array([1.0], np.float32), t_arrival=0.0,
                      t_start=0.0, t_done=0.0)


class _WatchedLock:
    """A lock that sets the event ``<thread name>_waiting`` (where there
    is one) when a thread asks for it and ``<thread name>_in`` once it
    holds it."""

    def __init__(self, events):
        self.lock = threading.Lock()
        self.events = events

    def _mark(self, what):
        ev = self.events.get(f"{threading.current_thread().name}_{what}")
        if ev is not None:
            ev.set()

    def __enter__(self):
        self._mark("waiting")
        self.lock.acquire()
        self._mark("in")

    def __exit__(self, *exc):
        self.lock.release()


def test_shutdown_gracefully_is_idempotent_and_a_second_caller_waits():
    log = []
    engine = _GatedEngine(log)
    srv = RetrievalServer(engine)
    events = {f"{n}_{s}": threading.Event()
              for n in ("first", "second") for s in ("waiting", "in")}
    srv._shutdown_once = _WatchedLock(events)
    srv.start()
    tcp, serving = _serve(srv)
    port = srv.tcp_port
    callers = []
    try:
        fut = srv.submit(Request(qid=1, method="splade"))
        assert engine.entered.wait(TIMEOUT)
        for name in ("first", "second"):
            t = threading.Thread(
                target=lambda n=name: (srv.shutdown_gracefully(),
                                       log.append(f"{n} returned")),
                name=name, daemon=True)
            callers.append(t)
            t.start()
            assert events[f"{name}_waiting"].wait(TIMEOUT)
            if name == "first":
                assert events["first_in"].wait(TIMEOUT)
        # the first caller holds the lock for the whole drain
        assert not events["second_in"].is_set()
        assert log == []
        engine.release.set()
        for t in callers:
            t.join(timeout=TIMEOUT)
        assert fut.result(timeout=TIMEOUT).qid == 1
    finally:
        engine.release.set()
        srv.shutdown_gracefully()        # a third call returns at once
        serving.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in callers + [serving])
    assert log[0] == "served"
    assert sorted(log[1:]) == ["first returned", "second returned"]
    assert engine.served == 1
    assert srv.health()["workers"] == 0
    assert _refused(port)


def test_sigterm_handler_drains_queued_requests(retr, small_corpus):
    srv = RetrievalServer(ServeEngine(retr))
    srv.start()
    tcp, serving = _serve(srv)
    port = srv.tcp_port
    old = srv.install_sigterm_handler()
    try:
        handler = signal.getsignal(signal.SIGTERM)
        assert callable(handler) and handler is not old
        futs = [srv.submit(Request(
            qid=i, method="splade", term_ids=small_corpus["q_term_ids"][i],
            term_weights=small_corpus["q_term_weights"][i], k=10))
            for i in range(6)]
        os.kill(os.getpid(), signal.SIGTERM)
        for f in futs:
            assert f.result(timeout=TIMEOUT).pids.shape == (10,)
        # serve_forever returns once the drain thread stopped the front
        serving.join(timeout=TIMEOUT)
        assert not serving.is_alive()
        for t in threading.enumerate():
            if t.name == "sigterm-drain":
                t.join(timeout=TIMEOUT)
                assert not t.is_alive()
        assert srv.health()["workers"] == 0
        assert srv.health()["served"] == 6
    finally:
        signal.signal(signal.SIGTERM, old)
        srv.shutdown_gracefully()
        serving.join(timeout=TIMEOUT)
    assert signal.getsignal(signal.SIGTERM) is old
    assert _refused(port)


MIXED = ["hybrid", "colbert", "rerank", "splade", "hybrid", "rerank",
         "colbert", "splade", "hybrid", "colbert", "rerank", "hybrid"]
MIXED_K = [10, 5, 10, 7, 3, 10, 10, 5, 10, 7, 5, 10]


def _queued_over_tcp(srv, corpus):
    """Send MIXED's lines one connection each, in order, each submitted
    before the next is sent; then start the server. Its micro-batches
    are the consecutive ``max_batch`` chunks. → replies by qid."""
    submitted = threading.Condition()
    count = [0]
    submit = srv.submit

    def counted(req):
        fut = submit(req)
        with submitted:
            count[0] += 1
            submitted.notify_all()
        return fut

    srv.submit = counted
    replies, clients = {}, []
    tcp, serving = _serve(srv)
    try:
        for i, (m, k) in enumerate(zip(MIXED, MIXED_K)):
            msg = _query(corpus, i, 20 + i, m, k)
            t = threading.Thread(
                target=lambda msg=msg: replies.__setitem__(
                    msg["qid"], tcp_query(HOST_ADDR, srv.tcp_port, msg)),
                name=f"tcp-serve-client-{i}", daemon=True)
            clients.append(t)
            t.start()
            with submitted:
                assert submitted.wait_for(lambda: count[0] == i + 1,
                                          TIMEOUT)
        assert srv.queue.qsize() == len(MIXED)
        srv.start()
        for t in clients:
            t.join(timeout=TIMEOUT)
    finally:
        srv.shutdown_gracefully()
        serving.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in clients + [serving])
    return replies


def _bits(reply):
    return (reply["pids"],
            np.asarray(reply["scores"], np.float32).view(np.uint32).tolist())


@pytest.mark.parametrize("workers", ["single", "kind"])
def test_pipelined_front_equals_the_synchronous_front(retr, small_corpus,
                                                      workers):
    sync = _queued_over_tcp(RetrievalServer(ServeEngine(retr), max_batch=4),
                            small_corpus)
    piped = _queued_over_tcp(RetrievalServer(
        ServeEngine(retr, pipeline_depth=2, pipeline_workers=workers),
        max_batch=4), small_corpus)
    assert sorted(sync) == sorted(piped) == list(range(len(MIXED)))
    for qid in sync:
        assert "error" not in sync[qid], sync[qid]
        assert _bits(piped[qid]) == _bits(sync[qid]), qid
    # and the engine's own answers on the same micro-batches
    reqs = [wire_request(_query(small_corpus, i, 20 + i, m, k))
            for i, (m, k) in enumerate(zip(MIXED, MIXED_K))]
    engine = ServeEngine(retr)
    for lo in range(0, len(reqs), 4):
        for res in engine.process_batch(reqs[lo:lo + 4]):
            assert _bits(sync[res.qid]) == (
                res.pids.tolist(), res.scores.view(np.uint32).tolist())


def test_a_shed_reply_says_why(built_index, splade_dir, small_corpus):
    retr = _retr(built_index, splade_dir)
    srv = RetrievalServer(ServeEngine(retr),
                          admission=AdmissionController(50.0))
    _poison(retr.pipeline_stats, HOST, DEVICE, stage1_s=10.0, tail_s=10.0)
    tcp, serving = _serve(srv)
    try:
        out = tcp_query(HOST_ADDR, srv.tcp_port,
                        _query(small_corpus, 5, 5, "hybrid", 10))
    finally:
        srv.shutdown_gracefully()
        serving.join(timeout=TIMEOUT)
    assert out["shed"] is True and out["reason"] == "overload"
    assert out["qid"] == 5
    assert out["error"].startswith(
        "request shed by admission control: overload (predicted ")
    assert srv.health()["sheds"] == 1 and srv.health()["served"] == 0


# -- the admin ops on a live index -------------------------------------------

def _live_lines(corpus):
    """(name, payload, corpus query or None) in the order sent to a live
    front: two upserts (copies of docs 0 and 1, with their own terms),
    deletes of a base pid, a delta pid, an unknown pid and a repeat,
    ``live_stats`` and ``health`` around a compaction, an empty
    compaction, and a query after each mutation, each asked at k and at
    k + ``REF_MARGIN`` (the reference's depth)."""
    n = corpus["cfg"].n_docs

    def upsert(j):
        return {"op": "upsert", "doc_emb": corpus["doc_embs"][j].tolist(),
                "doc_len": int(corpus["doc_lens"][j]),
                "term_ids": corpus["doc_term_ids"][j].tolist(),
                "term_weights": corpus["doc_term_weights"][j].tolist()}

    def queries(tag, i):
        return [(f"{tag}_{m}{deep}", _query(corpus, 100 + i, i, m,
                                            10 + deep), i)
                for m in ("hybrid", "colbert", "splade")
                for deep in (0, REF_MARGIN)]

    return ([("upsert_0", upsert(0), None), ("upsert_1", upsert(1), None)]
            + queries("after_upserts", 0)
            + [("delete_base", {"op": "delete", "pid": 3}, None),
               ("delete_delta", {"op": "delete", "pid": n + 1}, None),
               ("delete_again", {"op": "delete", "pid": 3}, None),
               ("delete_unknown", {"op": "delete", "pid": n + 99}, None)]
            + queries("after_deletes", 1)
            + [("live_stats_dirty", {"op": "live_stats"}, None),
               ("health_dirty", {"op": "health"}, None),
               ("compact", {"op": "compact"}, None),
               ("compact_empty", {"op": "compact"}, None),
               ("live_stats_compacted", {"op": "live_stats"}, None),
               ("health_compacted", {"op": "health"}, None)]
            + queries("after_compact", 2))


LIVE_ADMIN = ("upsert_0", "upsert_1", "delete_base", "delete_delta",
              "delete_again", "delete_unknown", "live_stats_dirty",
              "health_dirty", "compact", "compact_empty",
              "live_stats_compacted", "health_compacted")
LIVE_QUERIES = tuple(f"{tag}_{m}" for tag in ("after_upserts",
                                              "after_deletes",
                                              "after_compact")
                     for m in ("hybrid", "colbert", "splade"))


@pytest.fixture(scope="module")
def live_wire(built_index, splade_dir, small_corpus, tmp_path_factory):
    """The live lines sent to a port front and a JAX front, each over a
    live retriever on its own copy of the index (a compaction writes
    beside the index it compacts). → {"ours", "theirs"}: name → reply."""
    lines = _live_lines(small_corpus)
    root = tmp_path_factory.mktemp("live_tcp")
    out = {}
    for name, make in (("ours", _retr), ("theirs", _jretr)):
        shutil.copytree(built_index, root / name / "colbert")
        shutil.copytree(splade_dir, root / name / "splade")
        retr = make(root / name / "colbert", root / name / "splade")
        retr.enable_live()
        server = (RetrievalServer if name == "ours" else JServer)(
            (ServeEngine if name == "ours" else JEngine)(retr), max_batch=4)
        server.start()
        t = None
        try:
            _, t = _serve(server, f"tcp-serve-live-{name}")
            conn = _Client(server.tcp_port)
            try:
                out[name] = {n: conn.ask(payload) for n, payload, _ in lines}
            finally:
                conn.close()
        finally:
            server.shutdown_gracefully()
            if name == "theirs":
                server.tcp.server_close()
            if t is not None:
                t.join(timeout=TIMEOUT)
        assert t is not None and not t.is_alive()
    return out


@pytest.mark.parametrize("name", LIVE_ADMIN)
def test_live_admin_reply_equals_the_jax_fronts(live_wire, name):
    ours, theirs = live_wire["ours"][name], live_wire["theirs"][name]
    if name.startswith("health"):
        assert ours["ok"] is theirs["ok"] is True
        for key in ("live", "index_generation"):
            assert ours["health"][key] == theirs["health"][key], key
        assert set(theirs["health"]) <= set(ours["health"])
        return
    assert ours == theirs


@pytest.mark.parametrize("name", LIVE_QUERIES)
def test_live_query_reply_matches_the_jax_fronts(live_wire, name):
    ours = live_wire["ours"][f"{name}0"]
    ref = live_wire["theirs"][f"{name}{REF_MARGIN}"]
    assert "error" not in ours, ours
    assert set(ours) == set(live_wire["theirs"][f"{name}0"])
    assert_topk_match(np.asarray(ref["scores"], np.float32),
                      np.asarray(ref["pids"]),
                      np.asarray(ours["scores"], np.float32),
                      np.asarray(ours["pids"]), what=name)


def test_live_wire_saw_each_mutation(live_wire, small_corpus):
    """The conversation did what it was built for: pids appended after
    the base, the deletes' outcomes, a compaction of both docs, the
    deleted pids gone from the answers after it."""
    ours = live_wire["ours"]
    n = small_corpus["cfg"].n_docs
    assert ours["upsert_0"]["pid"] == n and ours["upsert_1"]["pid"] == n + 1
    assert [ours[f"delete_{w}"]["ok"] for w in
            ("base", "delta", "again", "unknown")] == [True, True, False,
                                                       False]
    assert ours["compact"]["compacted"] == 2
    assert ours["compact_empty"]["compacted"] == 0
    st = ours["live_stats_compacted"]["live"]
    assert st["delta_docs"] == 0 and st["tombstones"] == 2
    assert ours["health_compacted"]["health"]["index_generation"] == \
        st["generation"]
    for m in ("hybrid", "colbert", "splade"):
        pids = ours[f"after_compact_{m}0"]["pids"]
        assert 3 not in pids and n + 1 not in pids
