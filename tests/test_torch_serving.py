"""The port's serving path against the JAX package's, with
``device="cpu"``, on an index the JAX builder wrote: ``splade``,
``rerank`` and ``hybrid`` through ``ServeEngine.process_batch`` and
``RetrievalServer`` match the JAX ``MultiStageRetriever`` (scores
``allclose(rtol=1e-5, atol=1e-5)``, ids equal up to tie groups), and
within the port the fused tail equals the split tail bit for bit."""

import numpy as np
import pytest

from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import (SpladeIndex as JSplade,
                                      build_splade_index as j_build_splade)
from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.server import RetrievalServer
from repro_torch.testing import REF_MARGIN, assert_topk_match

FIRST_K = 50


@pytest.fixture(scope="module")
def splade_dir(small_corpus, tmp_path_factory):
    c = small_corpus
    path = tmp_path_factory.mktemp("splade_serving")
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(path)
    return path


@pytest.fixture(scope="module")
def jax_retr(built_index, splade_dir):
    return JRetriever(JSplade.load(splade_dir, mmap=True),
                      JSearcher(JIndex(built_index, mode="mmap")),
                      JParams(first_k=FIRST_K, k=20))


@pytest.fixture(scope="module")
def retr(built_index, splade_dir):
    return MultiStageRetriever(
        SpladeIndex.load(splade_dir, mmap=True),
        PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"), device="cpu"),
        MultiStageParams(first_k=FIRST_K, k=20), device="cpu")


def _requests(corpus, methods, ks, alphas, lo=0):
    return [Request(qid=lo + i, method=m, q_emb=corpus["q_embs"][lo + i],
                    term_ids=corpus["q_term_ids"][lo + i],
                    term_weights=corpus["q_term_weights"][lo + i], k=k,
                    alpha=a)
            for i, (m, k, a) in enumerate(zip(methods, ks, alphas))]


def _jax_answer(jax_retr, reqs):
    """Per-request reference answers from the JAX retriever's batched
    path (one mixed batch, like the engine's call), ``REF_MARGIN``
    places deeper than the deepest request so that the last places'
    ties are visible."""
    alphas = [r.alpha for r in reqs]
    pids, scores = jax_retr.search_batch(
        [r.method for r in reqs], q_embs=[r.q_emb for r in reqs],
        term_ids=[r.term_ids for r in reqs],
        term_weights=[r.term_weights for r in reqs],
        alpha=None if all(a is None for a in alphas) else alphas,
        k=max(r.k for r in reqs) + REF_MARGIN)
    return list(zip(pids, scores))


def _check(results, reqs, want):
    for res, req, (wp, ws) in zip(results, reqs, want):
        assert res.qid == req.qid
        assert res.pids.shape == (req.k,) and res.scores.shape == (req.k,)
        assert_topk_match(ws, wp, res.scores, res.pids,
                          what=f"qid {req.qid} {req.method} k={req.k}")


@pytest.mark.parametrize("k", [1, 20, FIRST_K])
@pytest.mark.parametrize("method", METHODS)
def test_process_batch_matches_jax(retr, jax_retr, small_corpus, method, k):
    reqs = _requests(small_corpus, [method] * 10, [k] * 10, [None] * 10)
    results = ServeEngine(retr).process_batch(reqs)
    _check(results, reqs, _jax_answer(jax_retr, reqs))


def test_mixed_batch_per_query_alpha_matches_jax(retr, jax_retr,
                                                 small_corpus):
    methods = ["hybrid", "rerank", "splade", "hybrid", "hybrid", "rerank",
               "splade", "hybrid", "hybrid", "rerank", "hybrid", "splade"]
    ks = [20, 1, FIRST_K, 5, FIRST_K, 20, 7, 1, 20, FIRST_K, 13, 20]
    alphas = [0.0, None, 0.9, 1.0, 0.5, None, None, 0.1, None, 0.3, 0.7,
              None]
    reqs = _requests(small_corpus, methods, ks, alphas, lo=12)
    results = ServeEngine(retr).process_batch(reqs)
    _check(results, reqs, _jax_answer(jax_retr, reqs))


def test_padded_candidate_lists_match_jax(retr, jax_retr, small_corpus):
    """first_k beyond the corpus size pads every candidate list with -1
    pids, which the rerank mask and the hybrid normaliser's statistics
    must leave out."""
    first_k = retr.splade.n_docs + 40
    jr = JRetriever(jax_retr.splade, jax_retr.searcher,
                    JParams(first_k=first_k, k=20))
    tr = MultiStageRetriever(retr.splade, retr.searcher,
                             MultiStageParams(first_k=first_k, k=20),
                             device="cpu")
    reqs = _requests(small_corpus, ["hybrid", "rerank"] * 3, [first_k] * 6,
                     [None, None, 0.6] * 2, lo=40)
    want = _jax_answer(jr, reqs)
    assert all((p[:first_k] < 0).sum() == 40 for p, _ in want)
    _check(ServeEngine(tr).process_batch(reqs), reqs, want)


@pytest.mark.parametrize("method", METHODS)
def test_fused_equals_split_bitwise(retr, small_corpus, method):
    kw = dict(q_embs=small_corpus["q_embs"][:12],
              term_ids=small_corpus["q_term_ids"][:12],
              term_weights=small_corpus["q_term_weights"][:12],
              alpha=np.linspace(0, 1, 12), k=30)
    try:
        retr.set_rerank_backend("fused")
        fused = retr.search_batch(method, **kw)
        retr.set_rerank_backend("split")
        split = retr.search_batch(method, **kw)
    finally:
        retr.set_rerank_backend(retr.params.rerank_backend)
    np.testing.assert_array_equal(fused[0], split[0])
    np.testing.assert_array_equal(fused[1].view(np.uint32),
                                  split[1].view(np.uint32))


def test_single_query_is_batch_row(retr, small_corpus):
    c = small_corpus
    pids, scores = retr.search_batch(
        "hybrid", q_embs=c["q_embs"][:3], term_ids=c["q_term_ids"][:3],
        term_weights=c["q_term_weights"][:3], k=10)
    p1, s1 = retr.search("hybrid", q_emb=c["q_embs"][1],
                         term_ids=c["q_term_ids"][1],
                         term_weights=c["q_term_weights"][1], k=10)
    np.testing.assert_array_equal(p1, pids[1])
    np.testing.assert_allclose(s1, scores[1], rtol=1e-6, atol=1e-6)


def test_server_serves_mixed_requests(retr, jax_retr, small_corpus):
    methods = ["rerank", "hybrid", "splade"] * 6
    ks = [10, 20, 5] * 6
    alphas = [None, 0.25, None] * 6
    reqs = _requests(small_corpus, methods, ks, alphas, lo=20)
    server = RetrievalServer(ServeEngine(retr), max_batch=8,
                             batch_timeout_ms=20.0)
    server.start()
    try:
        futs = [server.submit(r) for r in reqs]
        results = [f.result(timeout=60) for f in futs]
        server.drain()
        h = server.health()
    finally:
        server.stop()
    _check(results, reqs, _jax_answer(jax_retr, reqs))
    assert h["served"] == len(reqs) and h["failed"] == 0
    assert 1 <= h["batches"] <= len(reqs)
    assert "host_gather:residuals" in h["stages"]
    assert all(r.latency >= r.service_time >= 0 for r in results)
    assert not any(t.is_alive() for t in server.workers)


def test_server_isolates_a_failing_request(retr, small_corpus):
    reqs = _requests(small_corpus, ["rerank", "colbert", "hybrid"],
                     [5, 5, 5], [None] * 3)
    server = RetrievalServer(ServeEngine(retr), max_batch=4,
                             batch_timeout_ms=50.0)
    server.start()
    try:
        futs = [server.submit(r) for r in reqs]
        with pytest.raises(ValueError, match="colbert"):
            futs[1].result(timeout=60)
        assert futs[0].result(timeout=60).pids.shape == (5,)
        assert futs[2].result(timeout=60).pids.shape == (5,)
        assert server.health()["failed"] == 1
    finally:
        server.stop()


def test_stop_fails_queued_requests(retr, small_corpus):
    server = RetrievalServer(ServeEngine(retr))     # never started
    fut = server.submit(_requests(small_corpus, ["splade"], [5], [None])[0])
    server.stop()
    with pytest.raises(RuntimeError, match="stopped before serving"):
        fut.result(timeout=5)


def test_retriever_rejects_bad_options(retr, built_index, splade_dir):
    with pytest.raises(ValueError):
        retr.set_rerank_backend("pallas")
    with pytest.raises(ValueError, match="unsupported device"):
        MultiStageRetriever(retr.splade, retr.searcher, device="meta")
    with pytest.raises(ValueError, match="normalizer"):
        MultiStageRetriever(retr.splade, retr.searcher,
                            MultiStageParams(normalizer="l2"), device="cpu")
