"""The port's cache hierarchy against the JAX package's, with
``device="cpu"``, on an index the JAX builder wrote.

Across the packages: the cache keys are equal strings for the same numpy
arrays; the retriever salts are equal (the stage-1 backend token aside);
one LRU op sequence gives equal results and counters; one request stream
served with the same caches gives equal ids, scores
``allclose(rtol=1e-5, atol=1e-5)`` and equal hit and miss counters.

Within the port, bit for bit: an exact hit equals the cold answer for all
four methods; a mixed batch with partial hits, a SPLADE stage-1 partial
hit and a colbert survivor hit (mmap and resident pools) equal an engine
without caches. Hits are frozen arrays, the exact cache evicts at
capacity, a generation bump purges both caches, and a degraded answer is
never stored.
"""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.core.plaid import PlaidParams as JPlaidParams
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import (SpladeIndex as JSplade,
                                      build_splade_index as j_build_splade)
from repro.serving import context as jctx
from repro.serving.engine import (Request as JRequest,
                                  ServeEngine as JEngine)
from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving import context as tctx
from repro_torch.serving.context import (ADMIT_DEGRADED, CacheHierarchy,
                                         LRUCache)
from repro_torch.serving.engine import Request, ServeEngine

PLAID = dict(nprobe=8, candidate_cap=512, ndocs=128, k=50)
MS = dict(first_k=50, k=20)


@pytest.fixture(scope="module")
def splade_dir(small_corpus, tmp_path_factory):
    c = small_corpus
    path = tmp_path_factory.mktemp("splade_cache")
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


def _jretr(built_index, splade_dir):
    return JRetriever(JSplade.load(splade_dir, mmap=True),
                      JSearcher(JIndex(built_index, mode="mmap"),
                                JPlaidParams(**PLAID)),
                      JParams(**MS))


@pytest.fixture(scope="module")
def reference(built_index, splade_dir):
    """Cache-free engine: the cold-answer oracle."""
    return ServeEngine(_retr(built_index, splade_dir))


def _reqs(corpus, method, idxs, k=20, alpha=None, qid0=0, cls=Request):
    return [cls(qid=qid0 + j, method=method, q_emb=corpus["q_embs"][i],
                term_ids=corpus["q_term_ids"][i],
                term_weights=corpus["q_term_weights"][i], k=k, alpha=alpha)
            for j, i in enumerate(idxs)]


def _assert_bitwise(ref, got):
    np.testing.assert_array_equal(ref.pids, got.pids)
    np.testing.assert_array_equal(np.asarray(ref.scores).view(np.uint32),
                                  np.asarray(got.scores).view(np.uint32))


# -- keys, salts and the LRU against the JAX package -----------------------

_DTYPES = ["float32", "float64", "float16", "int32", "int64", "uint8"]


@st.composite
def _arrays(draw):
    if draw(st.booleans()):
        return None
    dtype = draw(st.sampled_from(_DTYPES))
    shape = tuple(draw(st.lists(st.integers(0, 5), min_size=0, max_size=3)))
    seed = draw(st.integers(0, 2 ** 31 - 1))
    a = np.random.default_rng(seed).normal(size=shape) * 50
    if draw(st.booleans()) and a.ndim == 2:
        a = a.T                      # a non-contiguous view
    return a.astype(dtype)


@settings(max_examples=60, deadline=None, database=None)
@given(q=_arrays(), tids=_arrays(), tw=_arrays(),
       method=st.sampled_from(METHODS + ("dense",)),
       k=st.integers(0, 1000),
       alpha=st.one_of(st.none(), st.floats(allow_nan=False, width=32),
                       st.floats(0, 1)),
       salt=st.sampled_from(["", "fk200|nznorm|sbhost|rbfused|g0", "g7"]))
def test_cache_keys_equal_the_jax_packages(q, tids, tw, method, k, alpha,
                                           salt):
    d = tctx.query_digest(q, tids, tw)
    assert d == jctx.query_digest(q, tids, tw)
    assert (tctx.exact_cache_key(d, method, k, alpha, salt)
            == jctx.exact_cache_key(d, method, k, alpha, salt))
    assert tctx.stage1_cache_key(d, salt) == jctx.stage1_cache_key(d, salt)


def test_digest_is_byte_exact():
    a = np.arange(6, dtype=np.float32)
    b = a.copy()
    assert tctx.query_digest(a, None, None) == tctx.query_digest(b, None,
                                                                 None)
    b[0] = np.float32(-0.0)              # 0.0 vs -0.0: different bytes
    assert tctx.query_digest(a, None, None) != tctx.query_digest(b, None,
                                                                 None)
    assert (tctx.query_digest(a, None, None)
            != tctx.query_digest(a.astype(np.float64), None, None))
    assert (tctx.query_digest(None, a.astype(np.int32), None)
            != tctx.query_digest(a.astype(np.int32), None, None))
    # alpha is written as the JAX package writes it, not normalised
    assert (tctx.exact_cache_key("d", "hybrid", 5, 0.3, "s")
            != tctx.exact_cache_key("d", "hybrid", 5,
                                    float(np.float32(0.3)), "s"))


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("tail", ["fused", "split"])
@pytest.mark.parametrize("method", METHODS)
def test_cache_salts_equal_the_jax_packages(built_index, splade_dir, method,
                                            tail, backend):
    """Equal strings for the host stage 1; with the device stage 1 they
    differ only in the backend's name (the JAX package's is
    ``pallas``)."""
    tr, jr = _retr(built_index, splade_dir), _jretr(built_index, splade_dir)
    tr.set_rerank_backend(tail)
    jr.set_rerank_backend(tail)
    tr.set_splade_backend(backend)
    jr.set_splade_backend("host" if backend == "host" else "pallas")
    for r in (tr, jr):
        r.bump_index_generation()
    got = tr.cache_salts(method)
    want = jr.cache_salts(method)
    if backend == "device":
        want = tuple(s.replace("bpallas", "bdevice") for s in want)
        assert got != jr.cache_salts(method)
    assert got == want


@pytest.mark.parametrize("capacity", [0, 1, 3, 8])
def test_lru_equals_the_jax_packages(capacity):
    rng = np.random.default_rng(capacity)
    caches = (LRUCache(capacity), jctx.LRUCache(capacity))
    gen = 0
    for step in range(300):
        op = rng.integers(0, 10)
        key = None if rng.random() < 0.05 else f"k{rng.integers(0, 12)}"
        if op < 4:
            count = bool(rng.integers(0, 2))
            got = [c.get(key, count_miss=count) for c in caches]
            assert got[0] == got[1], step
        elif op < 8:
            for c in caches:
                c.put(key, step, generation=gen)
        elif op == 8:
            gen += 1
        else:
            assert caches[0].purge_below(gen) == caches[1].purge_below(gen)
        assert caches[0].stats() == caches[1].stats()
        assert len(caches[0]) == len(caches[1])
    assert caches[0].stats()["hits"] > 0 or capacity == 0


# -- exact cache -------------------------------------------------------------

@pytest.mark.parametrize("method", METHODS)
def test_exact_hit_is_the_cold_answer(built_index, splade_dir, small_corpus,
                                      method):
    caches = CacheHierarchy(exact_entries=256)
    eng = ServeEngine(_retr(built_index, splade_dir), caches=caches)
    cold = eng.process_batch(_reqs(small_corpus, method, range(4)))
    assert not any(r.cache_hit for r in cold)
    eng.retriever.reset_stage_stats()
    warm = eng.process_batch(_reqs(small_corpus, method, range(4)))
    assert all(r.cache_hit for r in warm)
    # a hit runs no stage
    assert eng.retriever.pipeline_stats.snapshot()["stages"] == {}
    for c, w in zip(cold, warm):
        _assert_bitwise(c, w)
        assert not w.pids.flags.writeable and not w.scores.flags.writeable
    assert caches.exact.hits == 4 and caches.exact.misses == 4
    # single requests go through process(): the same cache
    one = eng.process(_reqs(small_corpus, method, [2])[0])
    assert one.cache_hit
    _assert_bitwise(cold[2], one)


def test_exact_cache_keys_on_k_and_alpha(built_index, splade_dir,
                                         small_corpus):
    caches = CacheHierarchy(exact_entries=256)
    eng = ServeEngine(_retr(built_index, splade_dir), caches=caches)
    cold = eng.process_batch(_reqs(small_corpus, "hybrid", [0, 1],
                                   alpha=0.3))
    r_k = eng.process_batch(_reqs(small_corpus, "hybrid", [0, 1], k=10,
                                  alpha=0.3))
    assert not any(r.cache_hit for r in r_k)
    assert all(len(r.pids) == 10 for r in r_k)
    r_a = eng.process_batch(_reqs(small_corpus, "hybrid", [0, 1],
                                  alpha=0.7))
    assert not any(r.cache_hit for r in r_a)
    assert not np.array_equal(r_a[0].scores, cold[0].scores)
    # None takes the retriever's alpha: the same key as 0.3
    warm = eng.process_batch(_reqs(small_corpus, "hybrid", [0, 1]))
    assert all(r.cache_hit for r in warm)
    for c, w in zip(cold, warm):
        _assert_bitwise(c, w)


def test_mixed_batch_with_partial_hits_is_the_cold_batch(
        built_index, splade_dir, small_corpus, reference):
    caches = CacheHierarchy(exact_entries=256, stage1_entries=256)
    eng = ServeEngine(_retr(built_index, splade_dir), caches=caches)
    eng.process_batch(_reqs(small_corpus, "hybrid", [0, 5], alpha=0.6)
                      + _reqs(small_corpus, "colbert", [1, 6], k=7))
    eng.process_batch(_reqs(small_corpus, "splade", [2, 3]))

    def batch():
        return (_reqs(small_corpus, "hybrid", [0, 4], alpha=0.6)
                + _reqs(small_corpus, "colbert", [1, 7], k=7, qid0=2)
                + _reqs(small_corpus, "splade", [2, 8], qid0=4)
                + _reqs(small_corpus, "rerank", [3, 9], k=11, qid0=6))

    got = eng.process_batch(batch())
    assert [r.cache_hit for r in got] == [True, False, True, False,
                                          True, False, False, False]
    for r, g in zip(reference.process_batch(batch()), got):
        _assert_bitwise(r, g)


def test_exact_cache_evicts_at_capacity(built_index, splade_dir,
                                        small_corpus):
    caches = CacheHierarchy(exact_entries=2)
    eng = ServeEngine(_retr(built_index, splade_dir), caches=caches)
    for i in range(3):
        eng.process(_reqs(small_corpus, "splade", [i])[0])
    assert caches.exact.evictions == 1 and len(caches.exact) == 2
    assert not eng.process(_reqs(small_corpus, "splade", [0])[0]).cache_hit
    assert eng.process(_reqs(small_corpus, "splade", [2])[0]).cache_hit


def test_generation_bump_purges_both_caches(built_index, splade_dir,
                                            small_corpus):
    caches = CacheHierarchy(exact_entries=64, stage1_entries=64)
    retr = _retr(built_index, splade_dir)
    eng = ServeEngine(retr, caches=caches)
    cold = eng.process_batch(_reqs(small_corpus, "hybrid", range(3))
                             + _reqs(small_corpus, "colbert", range(3, 5)))
    n_exact, n_s1 = len(caches.exact), len(caches.stage1)
    assert (n_exact, n_s1) == (5, 5)
    assert retr.bump_index_generation() == 1
    assert len(caches.exact) == 0 and len(caches.stage1) == 0
    assert caches.exact.invalidations == n_exact
    assert caches.stage1.invalidations == n_s1
    again = eng.process_batch(_reqs(small_corpus, "hybrid", range(3))
                              + _reqs(small_corpus, "colbert", range(3, 5)))
    assert not any(r.cache_hit for r in again)
    for c, a in zip(cold, again):
        _assert_bitwise(c, a)
    assert all(r.cache_hit for r in eng.process_batch(
        _reqs(small_corpus, "hybrid", range(3))))


# -- stage-1 cache -----------------------------------------------------------

@pytest.mark.parametrize("method", ["hybrid", "rerank"])
def test_splade_batch_warms_the_stage1_of(built_index, splade_dir,
                                          small_corpus, reference, method):
    caches = CacheHierarchy(stage1_entries=256)     # exact cache off
    retr = _retr(built_index, splade_dir)
    eng = ServeEngine(retr, caches=caches)
    eng.process_batch(_reqs(small_corpus, "splade", range(4)))
    assert len(caches.stage1) == 4
    retr.reset_stage_stats()
    got = eng.process_batch(_reqs(small_corpus, method, range(4), k=9,
                                  alpha=0.8))
    assert not any(r.cache_hit for r in got)
    counters = retr.pipeline_stats.snapshot()["counters"]
    assert counters == {"cache_stage1_hits": 4, "cache_stage1_misses": 0}
    want = reference.process_batch(_reqs(small_corpus, method, range(4),
                                         k=9, alpha=0.8))
    for r, g in zip(want, got):
        _assert_bitwise(r, g)


@pytest.mark.parametrize("backend", ["host", "device"])
def test_stage1_partial_hit_dispatches_only_the_misses(
        built_index, splade_dir, small_corpus, reference, monkeypatch,
        backend):
    caches = CacheHierarchy(stage1_entries=256)
    retr = _retr(built_index, splade_dir)
    eng = ServeEngine(retr, splade_backend=backend, caches=caches)
    eng.process_batch(_reqs(small_corpus, "splade", [1, 3, 5]))
    rows = []
    run = retr.run_splade_batch

    def counted(term_ids, *args, **kw):
        rows.append(len(term_ids))
        return run(term_ids, *args, **kw)

    monkeypatch.setattr(retr, "run_splade_batch", counted)
    got = eng.process_batch(_reqs(small_corpus, "hybrid", range(6), k=15))
    assert rows == [3]
    want = reference.process_batch(_reqs(small_corpus, "hybrid", range(6),
                                         k=15))
    for r, g in zip(want, got):
        _assert_bitwise(r, g)


@pytest.mark.parametrize("pool", ["mmap", "resident"])
def test_colbert_survivor_hit_is_the_cold_answer(
        built_index, splade_dir, small_corpus, reference, monkeypatch, pool):
    """A batch whose survivors are all cached skips the probe, the codes
    gather and the approximate stage, and answers at another k as an
    engine without caches does."""
    caches = CacheHierarchy(stage1_entries=256)
    retr = _retr(built_index, splade_dir, resident=pool == "resident")
    eng = ServeEngine(retr, caches=caches)
    eng.process_batch(_reqs(small_corpus, "colbert", range(5), k=10))
    assert len(caches.stage1) == 5
    _, (pids_row, n_real) = next(iter(caches.stage1._data.values()))
    assert pids_row.dtype == np.int64 and not pids_row.flags.writeable
    assert 0 < n_real <= PLAID["candidate_cap"]

    def no_probe(*a, **kw):
        raise AssertionError("the probe ran on a survivor hit")

    monkeypatch.setattr(retr.searcher, "probe_batch", no_probe)
    monkeypatch.setattr(retr.searcher, "approx_select_batch", no_probe)
    retr.reset_stage_stats()
    got = eng.process_batch(_reqs(small_corpus, "colbert", range(5), k=40))
    snap = retr.pipeline_stats.snapshot()
    assert snap["counters"]["cache_stage1_hits"] == 5
    assert snap["stages"]["host_gather:codes"]["pages_touched"] == 0
    assert snap["stages"]["host_gather:codes"]["tokens_read"] == 0
    monkeypatch.undo()
    want = reference.process_batch(_reqs(small_corpus, "colbert", range(5),
                                         k=40))
    for r, g in zip(want, got):
        _assert_bitwise(r, g)


def test_colbert_partial_survivor_hit_runs_the_whole_batch(
        built_index, splade_dir, small_corpus, reference):
    caches = CacheHierarchy(stage1_entries=256)
    retr = _retr(built_index, splade_dir)
    eng = ServeEngine(retr, caches=caches)
    eng.process_batch(_reqs(small_corpus, "colbert", [0, 1]))
    retr.reset_stage_stats()
    got = eng.process_batch(_reqs(small_corpus, "colbert", range(4)))
    assert retr.pipeline_stats.snapshot()["counters"] == {
        "cache_stage1_misses": 2}
    assert len(caches.stage1) == 4
    for r, g in zip(reference.process_batch(
            _reqs(small_corpus, "colbert", range(4))), got):
        _assert_bitwise(r, g)


# -- degraded answers --------------------------------------------------------

def test_degraded_answers_are_never_stored(built_index, splade_dir,
                                           small_corpus, reference):
    caches = CacheHierarchy(exact_entries=64)
    eng = ServeEngine(_retr(built_index, splade_dir), caches=caches)
    reqs = _reqs(small_corpus, "hybrid", range(3))
    for r in reqs:
        r.ctx = eng.context_for(r).degraded("slo_tail")
        assert r.ctx.admission == ADMIT_DEGRADED
    got = eng.process_batch(reqs)
    assert all(r.degraded and r.degrade_reason == "slo_tail" for r in got)
    assert len(caches.exact) == 0
    want = reference.process_batch(_reqs(small_corpus, "splade", range(3)))
    for w, g in zip(want, got):
        _assert_bitwise(w, g)
    # the same requests at full quality miss, and are stored
    full = eng.process_batch(_reqs(small_corpus, "hybrid", range(3)))
    assert not any(r.cache_hit or r.degraded for r in full)
    assert len(caches.exact) == 3


# -- the same stream through both packages ----------------------------------

def _stream(corpus):
    """(method, query index, k, alpha) with repeats: exact hits, stage-1
    hits across methods, and a repeat at another k."""
    spec = [("splade", 0, 20, None), ("hybrid", 0, 20, None),
            ("rerank", 1, 10, None), ("colbert", 2, 20, None),
            ("hybrid", 3, 20, 0.7), ("splade", 1, 5, None),
            ("colbert", 2, 20, None), ("hybrid", 0, 20, None),
            ("rerank", 0, 15, None), ("colbert", 4, 8, None),
            ("hybrid", 3, 20, 0.7), ("splade", 3, 20, None)]
    return [spec[i:i + 4] for i in range(0, len(spec), 4)]


def test_one_stream_through_both_packages(built_index, splade_dir,
                                          small_corpus):
    t_caches = CacheHierarchy(exact_entries=64, stage1_entries=64)
    j_caches = jctx.CacheHierarchy(exact_entries=64, stage1_entries=64)
    tr = _retr(built_index, splade_dir)
    t_eng = ServeEngine(tr, caches=t_caches)
    jr = _jretr(built_index, splade_dir)
    j_eng = JEngine(jr, caches=j_caches)
    hits = []
    for batch in _stream(small_corpus) + [[("colbert", 2, 20, None)]]:
        reqs = {}
        for cls in (Request, JRequest):
            reqs[cls] = [cls(qid=q, method=m,
                             q_emb=small_corpus["q_embs"][q],
                             term_ids=small_corpus["q_term_ids"][q],
                             term_weights=small_corpus["q_term_weights"][q],
                             k=k, alpha=a) for m, q, k, a in batch]
        got = t_eng.process_batch(reqs[Request])
        want = j_eng.process_batch(reqs[JRequest])
        for g, w in zip(got, want):
            assert g.cache_hit == w.cache_hit
            np.testing.assert_array_equal(g.pids, np.asarray(w.pids))
            np.testing.assert_allclose(g.scores, np.asarray(w.scores),
                                       rtol=1e-5, atol=1e-5)
            hits.append(g.cache_hit)
    assert t_caches.stats() == j_caches.stats()
    assert sum(hits) >= 4
    tc = tr.pipeline_stats.snapshot()["counters"]
    jc = jr.pipeline_stats.snapshot()["counters"]
    names = ("cache_exact_hits", "cache_exact_stores", "cache_stage1_hits",
             "cache_stage1_misses")
    assert {n: tc.get(n, 0) for n in names} == {n: jc.get(n, 0)
                                                for n in names}
