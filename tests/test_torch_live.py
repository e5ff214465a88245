"""The port's live index against the JAX package's, with ``device="cpu"``,
on indexes the JAX builder wrote, at the JAX package's own live-test
size (240 docs, dim 32, vocab 512; ``candidate_cap=4096`` binds on no
query, ``first_k=64``).

Bars: ``encode_doc`` equals the JAX ``encode_doc`` and the base index's
rows byte for byte, with the same errors; a clean live retriever equals
the frozen one bit for bit; a tombstone is filtered and backfilled. The
canonical trace (upsert the 8 held-out docs, tombstone 4 base docs and
one delta doc): for the four methods, the port's live answers against
the JAX live retriever's (ids equal up to tie groups, scores
``allclose(rtol=1e-5, atol=1e-5)``, ``repro_torch.testing``), and equal
bit for bit to the port's pinned rebuild of the surviving corpus, dirty
and compacted; the compacted directories equal the JAX compaction's
byte for byte (``meta.json`` as parsed JSON). A mutation bumps the
generation, so a cached answer holding a deleted doc is not served;
readers during a compaction see one answer throughout; ``RWGate``'s
writer preference and re-entry; ``AutoCompactor`` at its threshold;
``LiveView`` against the JAX one; ``enable_live`` on a resident pool.

Every wait is bounded by ``TIMEOUT``; thread order is forced by
``threading.Event``s and bounded polls of the gate's state, and every
thread is joined.
"""

import json
import pathlib
import shutil
import threading

import numpy as np
import pytest

from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.core.plaid import PlaidParams as JPlaidParams
from repro.data.synth import SynthCfg, make_corpus
from repro.index import live as jlive
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.builder import build_colbert_index as j_build_colbert
from repro.index.splade_index import SpladeIndex as JSplade
from repro.index.splade_index import build_splade_index as j_build_splade
from repro_torch.core.multistage import MultiStageParams, MultiStageRetriever
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.index import live
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.live import map_global_to_ref
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.testing import REF_MARGIN, assert_topk_match

TIMEOUT = 30.0        # seconds: the bound on every wait in this file
# the JAX package's live tests' parameters (tests/test_live_index.py):
# the candidate cap must not bind, or a rebuild's candidate sets differ
PLAID = dict(nprobe=4, candidate_cap=4096, ndocs=128, k=10)
MS = dict(first_k=64, k=10)
METHODS = ("splade", "colbert", "rerank", "hybrid")
STATES = ("dirty", "compacted")
HOLD = 8                      # held-out docs, upserted by the trace
DELETED = (5, 17, 100, 201)   # base pids tombstoned by the trace
K = 10
COLBERT_FILES = ("residuals.bin", "codes.bin", "centroids.npy",
                 "bucket_cutoffs.npy", "bucket_weights.npy", "doclens.npy",
                 "doc_offsets.npy", "ivf_pids.bin", "ivf_offsets.npy",
                 "tombstones.npy")
SPLADE_FILES = ("term_offsets.npy", "postings_pids.bin", "postings_imps.bin")


@pytest.fixture(scope="module")
def corpus():
    return make_corpus(SynthCfg(n_docs=240, n_queries=16, vocab=512,
                                dim=32, n_topics=12, doc_maxlen=20,
                                query_maxlen=6, seed=3))


def _base_n(corpus):
    return corpus["cfg"].n_docs - HOLD


@pytest.fixture(scope="module")
def base_tree(tmp_path_factory, corpus):
    """The base index (all but the held-out docs), built by the JAX
    builder: ``colbert/`` and ``splade/``."""
    base = tmp_path_factory.mktemp("live_base")
    n = _base_n(corpus)
    j_build_colbert(base / "colbert", corpus["doc_embs"][:n],
                    corpus["doc_lens"][:n], nbits=4, n_centroids=64,
                    kmeans_iters=4)
    j_build_splade(corpus["doc_term_ids"][:n], corpus["doc_term_weights"][:n],
                   corpus["cfg"].vocab, n).save(base / "splade")
    return base


def _copy(base_tree, where):
    """A private copy of the base tree: a compaction writes its new
    generation beside the index it compacts."""
    shutil.copytree(base_tree, where)
    return where


def _port(base, resident=False):
    return MultiStageRetriever(
        SpladeIndex.load(base / "splade", mmap=True),
        PLAIDSearcher(ColBERTIndex(base / "colbert"), PlaidParams(**PLAID),
                      device_resident=resident, device="cpu"),
        MultiStageParams(**MS), device="cpu")


def _jax(base):
    return JRetriever(JSplade.load(base / "splade", mmap=True),
                      JSearcher(JIndex(base / "colbert"),
                                JPlaidParams(**PLAID)),
                      JParams(**MS))


def _queries(corpus):
    return dict(q_embs=list(corpus["q_embs"]),
                term_ids=list(corpus["q_term_ids"]),
                term_weights=list(corpus["q_term_weights"]))


def _mutate(retr, corpus):
    """The canonical trace: upsert the held-out docs, tombstone a few
    base docs and one delta doc. Returns the deleted pids."""
    n = _base_n(corpus)
    new_pids = [retr.live_upsert(corpus["doc_embs"][j],
                                 corpus["doc_term_ids"][j],
                                 corpus["doc_term_weights"][j],
                                 corpus["doc_lens"][j])
                for j in range(n, corpus["cfg"].n_docs)]
    assert new_pids == list(range(n, n + HOLD))   # append-only global pids
    deleted = list(DELETED) + [new_pids[2]]
    for g in deleted:
        assert retr.live_delete(g)
    return deleted


def _survivors(corpus):
    deleted = set(DELETED) | {_base_n(corpus) + 2}
    return np.array([g for g in range(corpus["cfg"].n_docs)
                     if g not in deleted], np.int64)


def _answers(retr, corpus, k=K):
    q = _queries(corpus)
    return {m: retr.search_batch(m, **q, k=k) for m in METHODS}


@pytest.fixture(scope="module")
def rebuild(tmp_path_factory, corpus, base_tree):
    """The port's from-scratch rebuild of the trace's surviving corpus,
    the base geometry pinned, and its frozen answers."""
    survivors = _survivors(corpus)
    idx = ColBERTIndex(base_tree / "colbert")
    rd = tmp_path_factory.mktemp("live_rebuild")
    live.build_reference_indexes(
        rd / "colbert", rd / "splade", corpus["doc_embs"][survivors],
        corpus["doc_lens"][survivors], corpus["doc_term_ids"][survivors],
        corpus["doc_term_weights"][survivors], corpus["cfg"].vocab,
        centroids=idx.centroids, bucket_cutoffs=idx.bucket_cutoffs,
        bucket_weights=idx.bucket_weights, nbits=idx.nbits,
        quantum=SpladeIndex.load(base_tree / "splade").quantum,
        device="cpu")
    return survivors, _answers(_port(rd), corpus)


@pytest.fixture(scope="module")
def traces(tmp_path_factory, corpus, base_tree):
    """The canonical trace run on the port's live retriever and on the
    JAX package's, each on its own copy of the base tree: both answers
    (the JAX package's ``REF_MARGIN`` places deeper) dirty and after a
    compaction, each compaction's reply and directories."""
    root = tmp_path_factory.mktemp("live_traces")
    out = {}
    for name, make, k in (("port", _port, K), ("jax", _jax, K + REF_MARGIN)):
        retr = make(_copy(base_tree, root / name))
        retr.enable_live()
        _mutate(retr, corpus)
        dirty = _answers(retr, corpus, k)
        gen = retr.index_generation
        compacted = retr.compact_live()
        out[name] = {"dirty": dirty, "compacted": _answers(retr, corpus, k),
                     "reply": compacted, "again": retr.compact_live(),
                     "gen_before": gen, "retr": retr}
    return out


# ---------------------------------------------------------------------------
# the delta codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pid", [0, 7, 100])
def test_encode_doc_equals_jax_and_the_base_rows(corpus, base_tree, pid):
    ours = _port(base_tree).enable_live()
    theirs = _jax(base_tree).enable_live()
    idx = ColBERTIndex(base_tree / "colbert")
    cids, packed, L = ours.encode_doc(corpus["doc_embs"][pid],
                                      corpus["doc_lens"][pid])
    j_cids, j_packed, j_L = theirs.encode_doc(corpus["doc_embs"][pid],
                                              corpus["doc_lens"][pid])
    lo, hi = idx.doc_offsets[pid], idx.doc_offsets[pid + 1]
    assert L == j_L == idx.doclens[pid] == hi - lo
    assert cids.dtype == np.int32 and packed.dtype == np.uint8
    np.testing.assert_array_equal(cids, j_cids)
    np.testing.assert_array_equal(packed, j_packed)
    np.testing.assert_array_equal(cids, np.asarray(idx.store.codes[lo:hi]))
    np.testing.assert_array_equal(packed,
                                  np.asarray(idx.store.residuals[lo:hi]))


@pytest.mark.parametrize("bad", ["wrong_dim", "empty", "too_long", "flat"])
def test_encode_doc_refuses_as_jax_does(corpus, base_tree, bad):
    emb = corpus["doc_embs"][0]
    args = {"wrong_dim": (emb[:, :-1], None), "empty": (emb, 0),
            "too_long": (emb, emb.shape[0] + 1), "flat": (emb[0], None)}[bad]
    errors = []
    for state in (_port(base_tree).enable_live(),
                  _jax(base_tree).enable_live()):
        with pytest.raises(ValueError) as e:
            state.encode_doc(*args)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# ---------------------------------------------------------------------------
# clean state, tombstones
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_clean_live_equals_frozen(corpus, base_tree, method):
    retr = _port(base_tree)
    q = _queries(corpus)
    before = retr.search_batch(method, **q, k=K)
    retr.enable_live()
    assert not retr.live.dirty and retr.index_generation == 0
    assert retr.live_stats() == {
        "upserts": 0, "deletes": 0, "compactions": 0, "docs_compacted": 0,
        "delta_docs": 0, "delta_tokens": 0, "tombstones": 0,
        "generation": 0}
    after = retr.search_batch(method, **q, k=K)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1], after[1])


def test_tombstone_filtered_and_backfilled(corpus, base_tree):
    """A deleted doc leaves every method's top-k and its place is taken
    by the next doc: k stays full."""
    retr = _port(base_tree)
    retr.enable_live()
    q = _queries(corpus)
    p0, _ = retr.search_batch("splade", **q, k=K)
    victim = int(p0[0, 0])
    assert retr.live_delete(victim)
    assert not retr.live_delete(victim)          # double delete: no-op
    assert not retr.live_delete(10 ** 9)         # unknown pid
    assert not retr.live_delete(-1)
    assert retr.index_generation == 1            # only the real delete
    for m in METHODS:
        p, s = retr.search_batch(m, **q, k=K)
        assert victim not in p
        assert (p >= 0).all() and np.isfinite(np.asarray(s)).all()


def test_frozen_retriever_refuses_mutations(corpus, base_tree):
    retr = _port(base_tree)
    assert retr.live_stats() is None
    for call in (lambda: retr.live_upsert(corpus["doc_embs"][0], [1], [1.0]),
                 lambda: retr.live_delete(0), retr.compact_live):
        with pytest.raises(RuntimeError, match="live index not enabled"):
            call()


# ---------------------------------------------------------------------------
# the canonical trace: the JAX package's answers, the rebuild's, the files
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("method", METHODS)
def test_live_matches_the_jax_live_retriever(traces, method, state):
    want_p, want_s = traces["jax"][state][method]
    got_p, got_s = traces["port"][state][method]
    assert got_p.shape == (len(want_p), K)
    assert_topk_match(want_s, want_p, got_s, got_p,
                      what=f"{method} {state}")


@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("method", METHODS)
def test_live_equals_the_pinned_rebuild_bitwise(traces, rebuild, method,
                                                state):
    survivors, expected = rebuild
    got_p, got_s = traces["port"][state][method]
    want_p, want_s = expected[method]
    np.testing.assert_array_equal(map_global_to_ref(got_p, survivors),
                                  want_p, err_msg=f"{method} {state} pids")
    np.testing.assert_array_equal(got_s, want_s,
                                  err_msg=f"{method} {state} scores")


def test_compaction_bookkeeping(traces, corpus):
    t = traces["port"]
    retr = t["retr"]
    assert t["reply"]["compacted"] == HOLD
    assert t["again"] is None                    # nothing left to merge
    assert retr.index_generation == t["gen_before"] + 1
    assert retr.live.n_delta == 0 and retr.live.base_n == \
        corpus["cfg"].n_docs
    assert retr.searcher.index.n_docs == corpus["cfg"].n_docs
    steps = t["reply"]["seconds"]
    assert set(steps) == {"colbert_dir", "splade_dir", "load", "gate_wait",
                          "swap", "total"}
    jretr = traces["jax"]["retr"]
    assert retr.live_stats() == jretr.live_stats()
    assert retr.live_stats()["tombstones"] == len(DELETED) + 1
    assert t["reply"]["colbert_dir"].endswith(
        traces["jax"]["reply"]["colbert_dir"].rsplit("/", 1)[1])


@pytest.mark.parametrize("kind", ["colbert", "splade"])
def test_compacted_files_equal_the_jax_compaction(traces, kind):
    ours = traces["port"]["reply"][f"{kind}_dir"]
    theirs = traces["jax"]["reply"][f"{kind}_dir"]
    names = COLBERT_FILES if kind == "colbert" else SPLADE_FILES
    ours, theirs = pathlib.Path(ours), pathlib.Path(theirs)
    for name in names:
        assert (ours / name).read_bytes() == (theirs / name).read_bytes(), \
            name
    assert json.loads((ours / "meta.json").read_text()) == \
        json.loads((theirs / "meta.json").read_text())
    assert sorted(p.name for p in ours.iterdir()) == \
        sorted(p.name for p in theirs.iterdir())


# ---------------------------------------------------------------------------
# caches, concurrency
# ---------------------------------------------------------------------------

def test_deleted_doc_cached_answer_is_not_served(corpus, base_tree):
    """A mutation bumps the index generation, which every cache key
    embeds: an answer cached before a delete is not served after it."""
    retr = _port(base_tree)
    retr.enable_live()
    engine = ServeEngine(retr, caches=CacheHierarchy(exact_entries=64,
                                                     stage1_entries=64))

    def req(qid):
        return Request(qid=qid, method="hybrid", q_emb=corpus["q_embs"][0],
                       term_ids=corpus["q_term_ids"][0],
                       term_weights=corpus["q_term_weights"][0], k=5)

    r0 = engine.process(req(0))
    r1 = engine.process(req(1))                  # warm: exact-cache hit
    assert r1.cache_hit and list(r1.pids) == list(r0.pids)
    victim = int(r0.pids[0])
    assert engine.live_delete(victim)
    r2 = engine.process(req(2))
    assert not r2.cache_hit                      # the bump missed
    assert victim not in list(r2.pids) and len(r2.pids) == 5


def test_readers_during_compaction(corpus, base_tree, tmp_path):
    """Three reader threads query while ``compact_live`` builds and
    swaps: every answer equals the one before the compaction."""
    retr = _port(_copy(base_tree, tmp_path / "base"))
    retr.enable_live()
    _mutate(retr, corpus)
    q = _queries(corpus)
    want_p, want_s = retr.search_batch("hybrid", **q, k=K)
    errors, stop, started = [], threading.Event(), threading.Barrier(4)
    answered = [0, 0, 0]

    def reader(i):
        started.wait(timeout=TIMEOUT)
        while not stop.is_set():
            try:
                p, s = retr.search_batch("hybrid", **q, k=K)
                np.testing.assert_array_equal(p, want_p)
                np.testing.assert_array_equal(s, want_s)
                answered[i] += 1
            except Exception as e:   # surfaced below
                errors.append(e)
                return

    threads = [threading.Thread(target=reader, args=(i,), name=f"reader-{i}")
               for i in range(3)]
    for t in threads:
        t.start()
    try:
        started.wait(timeout=TIMEOUT)
        assert retr.compact_live()["compacted"] == HOLD
        p, s = retr.search_batch("hybrid", **q, k=K)
        np.testing.assert_array_equal(p, want_p)
        np.testing.assert_array_equal(s, want_s)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert all(answered)


def _until(pred) -> bool:
    """Poll ``pred`` every millisecond for at most ``TIMEOUT`` seconds."""
    tick = threading.Event()
    for _ in range(int(TIMEOUT * 1000)):
        if pred():
            return True
        tick.wait(0.001)
    return pred()


def test_rwgate_prefers_the_waiting_writer():
    """A reader that arrives while a writer waits queues behind it; the
    writer goes as soon as the reader in flight leaves."""
    gate = live.RWGate()
    order, r1_in, r1_leave = [], threading.Event(), threading.Event()
    r2_in = threading.Event()

    def first_reader():
        with gate.read():
            r1_in.set()
            r1_leave.wait(timeout=TIMEOUT)
            order.append("r1")

    def writer():
        with gate.write():
            order.append("w")

    def second_reader():
        with gate.read():
            r2_in.set()
            order.append("r2")

    threads = [threading.Thread(target=first_reader)]
    threads[0].start()
    assert r1_in.wait(timeout=TIMEOUT)
    threads.append(threading.Thread(target=writer))
    threads[1].start()
    assert _until(lambda: gate._writers_waiting == 1)
    threads.append(threading.Thread(target=second_reader))
    threads[2].start()
    assert not r2_in.wait(timeout=0.2)     # queued behind the writer
    r1_leave.set()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert order == ["r1", "w", "r2"]


def test_rwgate_reentrant_read_passes_a_waiting_writer():
    """A thread inside ``read()`` re-enters it while a writer waits (a
    mixed batch recursing), so the gate never deadlocks it."""
    gate = live.RWGate()
    inside, nested_done = threading.Event(), threading.Event()
    wrote = threading.Event()

    def reader():
        with gate.read():
            inside.set()
            if _until(lambda: gate._writers_waiting == 1):
                with gate.read():        # a writer waits: must not block
                    nested_done.set()
            assert not wrote.is_set()

    def writer():
        inside.wait(timeout=TIMEOUT)
        with gate.write():
            wrote.set()

    threads = [threading.Thread(target=reader),
               threading.Thread(target=writer)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert nested_done.is_set() and wrote.is_set()


def test_mixed_batch_on_a_dirty_live_index(corpus, base_tree, traces,
                                           tmp_path):
    """A mixed-method batch re-enters ``search_batch`` under the gate
    and answers each request as its method's group does."""
    retr = _port(_copy(base_tree, tmp_path / "base"))
    retr.enable_live()
    _mutate(retr, corpus)
    q = _queries(corpus)
    methods = [METHODS[i % 4] for i in range(len(q["q_embs"]))]
    p, s = retr.search_batch(methods, **q, k=K)
    for m in METHODS:
        idx = [i for i, mi in enumerate(methods) if mi == m]
        gp, gs = traces["port"]["dirty"][m]
        w = gp.shape[1]
        np.testing.assert_array_equal(p[idx, :w], gp[idx])
        np.testing.assert_array_equal(s[idx, :w], gs[idx])


def test_autocompactor_compacts_at_its_threshold(corpus, base_tree,
                                                 tmp_path):
    retr = _port(_copy(base_tree, tmp_path / "base"))
    retr.enable_live()
    compacted = threading.Event()
    inner = retr.compact_live

    def compact_live():
        out = inner()
        if out is not None:
            compacted.set()
        return out

    retr.compact_live = compact_live
    auto = live.AutoCompactor(retr, every=3, interval_s=0.01)
    auto.start()
    try:
        n = _base_n(corpus)
        for j in range(n, n + 2):
            retr.live_upsert(corpus["doc_embs"][j], corpus["doc_term_ids"][j],
                             corpus["doc_term_weights"][j],
                             corpus["doc_lens"][j])
        assert not compacted.is_set() or retr.live.n_delta == 0
        retr.live_upsert(corpus["doc_embs"][n + 2],
                         corpus["doc_term_ids"][n + 2],
                         corpus["doc_term_weights"][n + 2],
                         corpus["doc_lens"][n + 2])
        assert compacted.wait(timeout=TIMEOUT)
    finally:
        assert auto.stop(timeout=TIMEOUT)
    assert not auto.is_alive() and auto.failures == 0
    st = retr.live_stats()
    assert st["compactions"] == 1 and st["docs_compacted"] == 3
    assert st["delta_docs"] == 0 and retr.searcher.index.n_docs == n + 3


def test_live_view_equals_the_jax_view():
    ours = live.LiveView([9, 2, 5], generation=3, counters={"upserts": 1})
    theirs = jlive.LiveView([9, 2, 5], generation=3, counters={"upserts": 1})
    for v in (ours, theirs):
        assert v.gate is None
    np.testing.assert_array_equal(ours.base_exclude, theirs.base_exclude)
    assert ours.dirty and ours.stats() == theirs.stats()
    for v in (ours, theirs):
        v.update([], generation=4, counters={"deletes": 2})
    assert not ours.dirty and not theirs.dirty
    assert ours.stats() == theirs.stats()
    assert ours.base_exclude.dtype == theirs.base_exclude.dtype == np.int64


def test_enable_live_refuses_a_resident_pool(base_tree):
    with pytest.raises(ValueError) as ours:
        _port(base_tree, resident=True).enable_live()
    j = JRetriever(JSplade.load(base_tree / "splade"),
                   JSearcher(JIndex(base_tree / "colbert"),
                             JPlaidParams(**PLAID), device_resident=True),
                   JParams(**MS))
    with pytest.raises(ValueError) as theirs:
        j.enable_live()
    assert str(ours.value) == str(theirs.value)


def test_enable_live_is_idempotent_and_on_the_retrievers_device(base_tree):
    retr = _port(base_tree)
    state = retr.enable_live()
    assert retr.enable_live() is state
    assert state.device == retr.device
    assert state._centroids.device == retr.device


def test_stage1_follows_the_routing_of_its_batch(corpus, base_tree):
    """``run_splade_batch(live=...)`` scores as its batch was routed: a
    frozen plan's stage 1 keeps the base scorer even when a mutation
    lands mid-batch and makes the state dirty; ``live=None`` decides by
    the state at the call."""
    retr = _port(base_tree)
    retr.enable_live()
    q = _queries(corpus)
    args = (q["term_ids"], q["term_weights"], K)
    frozen = retr.run_splade_batch(*args)
    victim = int(frozen[0][0, 0])
    assert retr.live_delete(victim)
    pinned = retr.run_splade_batch(*args, live=False)
    np.testing.assert_array_equal(pinned[0], frozen[0])
    np.testing.assert_array_equal(pinned[1], frozen[1])
    dirty = retr.run_splade_batch(*args)
    assert victim not in dirty[0]
    again = retr.run_splade_batch(*args, live=True)
    np.testing.assert_array_equal(again[0], dirty[0])
