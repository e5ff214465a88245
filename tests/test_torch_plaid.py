"""PLAID ``colbert`` in the port against the JAX package, with
``device="cpu"``, on an index the JAX builder wrote: the IVF's padded
form byte for byte; the probe, the stage-2 candidates, the approximate
scores and the survivors equal (ragged queries, a binding candidate
cap); ``PLAIDSearcher`` and ``colbert`` through ``ServeEngine`` and
``RetrievalServer`` match the JAX retriever (scores ``allclose(rtol=1e-5,
atol=1e-5)``, ids equal up to tie groups). Within the port, bit for bit:
fused == split, a resident pool == the mmap pool, a single query == its
batch row. The codes-only gather touches no residual page, and the
probe refuses TF32."""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plaid as jplaid
from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import (SpladeIndex as JSplade,
                                      build_splade_index as j_build_splade)
from repro_torch.core import plaid
from repro_torch.core.multistage import MultiStageParams, MultiStageRetriever
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.kernels.fused_rerank.ref import stable_topk
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.server import RetrievalServer
from repro_torch.testing import (REF_MARGIN, assert_topk_match,
                                 colbert_tie_reference)

FIRST_K = 50
# 512 as the JAX package's own fused-tail tests use; 16 binds on every
# query of the small corpus
CAPS = [512, 16]


def _params(cap):
    return PlaidParams(nprobe=8, candidate_cap=cap, ndocs=min(128, cap),
                       k=50)


@pytest.fixture(scope="module")
def splade_dir(small_corpus, tmp_path_factory):
    c = small_corpus
    path = tmp_path_factory.mktemp("splade_plaid")
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(path)
    return path


@pytest.fixture(scope="module")
def jax_searchers(built_index):
    return {cap: jplaid.PLAIDSearcher(
        JIndex(built_index, mode="mmap"),
        jplaid.PlaidParams(**vars(_params(cap)))) for cap in CAPS}


@pytest.fixture(scope="module")
def searchers(built_index):
    return {cap: PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"),
                               _params(cap), device="cpu") for cap in CAPS}


@pytest.fixture(scope="module")
def resident(built_index):
    return PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"),
                         _params(512), device_resident=True, device="cpu")


def _retriever(splade_dir, searcher):
    return MultiStageRetriever(SpladeIndex.load(splade_dir, mmap=True),
                               searcher, MultiStageParams(first_k=FIRST_K,
                                                          k=20),
                               device="cpu")


@pytest.fixture(scope="module")
def retrs(splade_dir, searchers):
    return {cap: _retriever(splade_dir, s) for cap, s in searchers.items()}


@pytest.fixture(scope="module")
def jax_retrs(splade_dir, jax_searchers):
    return {cap: JRetriever(JSplade.load(splade_dir, mmap=True), s,
                            JParams(first_k=FIRST_K, k=20))
            for cap, s in jax_searchers.items()}


def _queries(corpus, lo, n):
    """n queries, every third cut to half its tokens (ragged batches)."""
    return [corpus["q_embs"][lo + i][:(3 if i % 3 == 2 else None)]
            for i in range(n)]


# -- IVF and store ---------------------------------------------------------

@pytest.mark.parametrize("pad_to", [None, 1, 5, 64])
def test_ivf_as_padded_is_byte_equal(built_index, pad_to):
    got = ColBERTIndex(built_index).ivf.as_padded(pad_to)
    want = JIndex(built_index).ivf.as_padded(pad_to)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_ivf_longest_list(built_index):
    got, want = ColBERTIndex(built_index).ivf, JIndex(built_index).ivf
    assert got.max_list_len() == want.max_list_len()


def test_padded_ivf_is_built_when_colbert_first_runs(built_index,
                                                     splade_dir,
                                                     small_corpus):
    """A retriever that serves only the SPLADE methods never builds the
    padded IVF; the first colbert batch builds it at the longest list."""
    index = ColBERTIndex(built_index, mode="mmap")
    retr = _retriever(splade_dir, PLAIDSearcher(index, _params(512),
                                                device="cpu"))
    qs = _queries(small_corpus, 0, 2)
    retr.search_batch("rerank", q_embs=qs,
                      term_ids=small_corpus["q_term_ids"][:2],
                      term_weights=small_corpus["q_term_weights"][:2], k=5)
    assert "ivf_padded" not in vars(retr.searcher)
    retr.search_batch("colbert", q_embs=qs, k=5)
    padded = vars(retr.searcher)["ivf_padded"]
    assert padded.shape == (index.ivf.n_centroids, index.ivf.max_list_len())


# -- stages 1-3 ------------------------------------------------------------

@pytest.mark.parametrize("seed,ties", [(0, False), (1, True), (2, True)])
def test_topk_ordered_is_stable_topk(seed, ties):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(40, 300)).astype(np.float32)
    if ties:      # few distinct values: ties everywhere, at the boundary too
        x = np.round(x * 2) / 2
    x = torch.from_numpy(x)
    for k in (1, 4, 9, 300):
        v, i = plaid.topk_ordered(x, k)
        wv, wi = stable_topk(x, k)
        assert torch.equal(i, wi) and torch.equal(v, wv), k


def _jax_probe(js, qs):
    q, qv = jplaid.pad_query_batch(qs)
    s, cids = jplaid.stage1_centroid_probe_batch(q, qv, js.centroids,
                                                 js.params.nprobe)
    lq = max(len(a) for a in qs)
    return np.asarray(s)[:, :lq], np.asarray(cids)[:, :lq], q, qv


@pytest.mark.parametrize("cap", CAPS)
def test_probe_and_candidates_match_jax(searchers, jax_searchers,
                                        small_corpus, cap):
    qs = _queries(small_corpus, 0, 9)
    ts, js = searchers[cap], jax_searchers[cap]
    st = ts.probe_batch(qs)
    s, cids, _, _ = _jax_probe(js, qs)
    np.testing.assert_allclose(st["scores_c"].numpy(), s, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(st["cids"].numpy(), cids)
    # stage 2 from equal probed centroids: exactly the reference's
    want = np.asarray(jplaid.stage2_candidates_batch(
        js.ivf_padded, jnp.asarray(cids), cap))
    np.testing.assert_array_equal(st["cand"].numpy(), want)
    real = (want >= 0).sum(axis=1)
    assert real.max() == cap if cap == 16 else real.max() < cap


@pytest.mark.parametrize("cap", CAPS)
def test_approx_scores_and_survivors_match_jax(searchers, jax_searchers,
                                               small_corpus, cap):
    qs = _queries(small_corpus, 9, 9)
    ts, js = searchers[cap], jax_searchers[cap]
    st = ts.probe_batch(qs)
    codes, valid = ts.to_device(*ts.gather_codes_batch(st["cand"].numpy()))
    got = plaid.stage3_approx_score_batch(st["scores_c"], codes, valid,
                                          st["q_valid"]).numpy()
    jst = js.probe_batch(qs)
    jc, jv = js.gather_codes_batch(jst["cand"])
    want = np.asarray(jplaid.stage3_approx_score_batch(
        jst["scores_c"], jc, jv, jst["q_valid"]))[:len(qs)]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    final = ts.approx_select_batch(st["scores_c"], codes, valid,
                                   st["q_valid"], st["cand"]).numpy()
    jfinal = np.asarray(js.approx_select_batch(
        jst["scores_c"], jc, jv, jst["q_valid"], jst["cand"]))[:len(qs)]
    for b in range(len(qs)):
        assert set(final[b]) == set(jfinal[b]), b


def test_approx_chunks_change_no_bit(searchers, small_corpus, monkeypatch):
    qs = _queries(small_corpus, 0, 7)
    ts = searchers[512]
    st = ts.probe_batch(qs)
    codes, valid = ts.to_device(*ts.gather_codes_batch(st["cand"].numpy()))
    args = (st["scores_c"], codes, valid, st["q_valid"])
    whole = plaid.stage3_approx_score_batch(*args)
    monkeypatch.setattr(plaid, "APPROX_CHUNK_BYTES", 1)    # one row a chunk
    assert torch.equal(plaid.stage3_approx_score_batch(*args).view(
        torch.int32), whole.view(torch.int32))


@pytest.mark.parametrize("flag", ["allow_tf32", "precision"])
def test_probe_refuses_tf32(searchers, small_corpus, flag):
    before = (torch.backends.cuda.matmul.allow_tf32,
              torch.get_float32_matmul_precision())
    try:
        if flag == "allow_tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
        else:
            torch.set_float32_matmul_precision("high")
        with pytest.raises(RuntimeError, match="TF32"):
            searchers[512].probe_batch(_queries(small_corpus, 0, 2))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before[0]
        torch.set_float32_matmul_precision(before[1])
    searchers[512].probe_batch(_queries(small_corpus, 0, 2))


@pytest.mark.parametrize("precision", ["tf32", "ieee"])
def test_probe_reads_fp32_precision(searchers, small_corpus, precision):
    """Through torch's newer per-backend setting, TF32 is refused with
    the port's own message (not torch's error about mixing the legacy
    and new APIs), and "ieee" passes."""
    matmul = torch.backends.cuda.matmul
    before = matmul.fp32_precision
    try:
        matmul.fp32_precision = precision
        if precision == "tf32":
            with pytest.raises(RuntimeError,
                               match="centroid probe.*fp32_precision='tf32'"):
                searchers[512].probe_batch(_queries(small_corpus, 0, 2))
        else:
            searchers[512].probe_batch(_queries(small_corpus, 0, 2))
    finally:
        matmul.fp32_precision = before


# -- the searcher ----------------------------------------------------------

@pytest.mark.parametrize("cap", CAPS)
def test_search_batch_matches_jax(searchers, jax_searchers, small_corpus,
                                  cap):
    qs = _queries(small_corpus, 20, 12)
    pids, scores, aux = searchers[cap].search_batch(qs, k=20)
    wp, ws, waux = jax_searchers[cap].search_batch(qs, k=20 + REF_MARGIN)
    assert pids.shape == scores.shape == (12, 20)
    assert_topk_match(ws, wp, scores, pids, what=f"cap={cap}")
    assert aux == waux


def test_search_pads_past_ndocs(searchers, small_corpus):
    ts = searchers[16]
    pids, scores, _ = ts.search(small_corpus["q_embs"][3], k=40)
    assert pids.shape == (40,) and (pids[16:] == -1).all()
    assert np.isneginf(scores[16:]).all() and (pids[:16] >= 0).all()


def test_single_query_is_batch_row(searchers, resident, small_corpus):
    qs = _queries(small_corpus, 30, 6)
    for ts in (searchers[512], resident):
        pids, scores, aux = ts.search_batch(qs, k=30)
        for b in (0, 2, 5):
            p1, s1, a1 = ts.search(qs[b], k=30)
            np.testing.assert_array_equal(p1, pids[b])
            np.testing.assert_array_equal(s1.view(np.uint32),
                                          scores[b].view(np.uint32))
            assert a1 == aux[b]


def test_rerank_matches_jax(searchers, jax_searchers, small_corpus):
    qs = _queries(small_corpus, 40, 5)
    rng = np.random.default_rng(3)
    pids = rng.integers(-1, 400, (5, 33))
    ts, js = searchers[512], jax_searchers[512]
    got = ts.rerank_batch(qs, pids)
    want = np.asarray(js.rerank_batch(qs, pids))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert np.isneginf(got[pids < 0]).all()
    one = ts.rerank(qs[2], pids[2])
    np.testing.assert_array_equal(one.view(np.uint32),
                                  got[2].view(np.uint32))


def test_codes_gather_touches_no_residual_page(searchers, small_corpus):
    ts = searchers[512]
    stats = ts.index.store.stats
    stats.reset()
    st = ts.probe_batch(_queries(small_corpus, 0, 8))
    codes, valid = ts.gather_codes_batch(st["cand"].numpy())
    snap = stats.snapshot()
    assert snap["tokens_read"] > 0 and valid.any()
    assert snap["pages_touched"] == snap["residual_gathers"] == 0


# -- colbert through the retriever and the server --------------------------

def _requests(corpus, methods, ks, lo=0):
    return [Request(qid=lo + i, method=m,
                    q_emb=corpus["q_embs"][lo + i][:(3 if i % 4 == 3
                                                     else None)],
                    term_ids=None if m == "colbert"
                    else corpus["q_term_ids"][lo + i],
                    term_weights=None if m == "colbert"
                    else corpus["q_term_weights"][lo + i], k=k)
            for i, (m, k) in enumerate(zip(methods, ks))]


def _jax_answer(jax_retr, reqs):
    pids, scores = jax_retr.search_batch(
        [r.method for r in reqs], q_embs=[r.q_emb for r in reqs],
        term_ids=[r.term_ids for r in reqs],
        term_weights=[r.term_weights for r in reqs],
        k=max(r.k for r in reqs) + REF_MARGIN)
    return list(zip(pids, scores))


def _check(results, reqs, want):
    for res, req, (wp, ws) in zip(results, reqs, want):
        assert res.qid == req.qid
        assert res.pids.shape == (req.k,) == res.scores.shape
        assert_topk_match(ws, wp, res.scores, res.pids,
                          what=f"qid {req.qid} {req.method} k={req.k}")


@pytest.mark.parametrize("k", [1, 20, FIRST_K])
@pytest.mark.parametrize("cap", CAPS)
def test_colbert_process_batch_matches_jax(retrs, jax_retrs, small_corpus,
                                           cap, k):
    reqs = _requests(small_corpus, ["colbert"] * 10, [k] * 10)
    results = ServeEngine(retrs[cap]).process_batch(reqs)
    _check(results, reqs, _jax_answer(jax_retrs[cap], reqs))


@pytest.mark.parametrize("cap", CAPS)
def test_colbert_mixed_with_hybrid_matches_jax(retrs, jax_retrs,
                                               small_corpus, cap):
    methods = ["colbert", "hybrid", "hybrid", "colbert", "colbert",
               "hybrid", "colbert", "hybrid"]
    ks = [20, 1, FIRST_K, 1, FIRST_K, 20, 7, 13]
    reqs = _requests(small_corpus, methods, ks, lo=10)
    results = ServeEngine(retrs[cap]).process_batch(reqs)
    _check(results, reqs, _jax_answer(jax_retrs[cap], reqs))


def test_server_serves_colbert(retrs, jax_retrs, small_corpus):
    methods = ["colbert", "hybrid", "colbert"] * 5
    ks = [1, 20, FIRST_K] * 5
    reqs = _requests(small_corpus, methods, ks, lo=20)
    retr = retrs[512]
    retr.reset_stage_stats()
    server = RetrievalServer(ServeEngine(retr), max_batch=6,
                             batch_timeout_ms=20.0)
    server.start()
    try:
        results = [f.result(timeout=60)
                   for f in [server.submit(r) for r in reqs]]
        server.drain()
        h = server.health()
    finally:
        server.stop()
    _check(results, reqs, _jax_answer(jax_retrs[512], reqs))
    assert h["served"] == len(reqs) and h["failed"] == 0
    stages = h["stages"]
    for name in ("plaid_probe", "host_gather:codes", "device_score:approx",
                 "host_gather:residuals", "fused_rerank",
                 "fused_rerank:sync"):
        assert stages[name]["dispatches"] > 0, name
    # the codes stage reads centroid ids and no residual page
    assert stages["host_gather:codes"]["pages_touched"] == 0
    assert stages["host_gather:residuals"]["pages_touched"] > 0
    codes = retr.pipeline_stats.snapshot()["stages"]["host_gather:codes"]
    assert codes["tokens_read"] > 0 and codes["kind"] == "host"


def _both_tails(retr, qs, k):
    try:
        retr.set_rerank_backend("fused")
        fused = retr.search_batch("colbert", q_embs=qs, k=k)
        retr.set_rerank_backend("split")
        split = retr.search_batch("colbert", q_embs=qs, k=k)
        names = set(retr.pipeline_stats.snapshot()["stages"])
    finally:
        retr.set_rerank_backend(retr.params.rerank_backend)
    return fused, split, names


def _bit_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1].view(np.uint32),
                                  b[1].view(np.uint32))


@pytest.mark.parametrize("pool", ["mmap", "resident"])
def test_colbert_fused_equals_split_bitwise(retrs, resident, splade_dir,
                                            small_corpus, pool):
    retr = retrs[512] if pool == "mmap" else _retriever(splade_dir,
                                                         resident)
    fused, split, names = _both_tails(retr, _queries(small_corpus, 5, 12),
                                      30)
    _bit_equal(fused, split)
    assert {"device_score:exact", "fuse_topk", "fused_rerank"} <= names


@pytest.mark.parametrize("backend", ["fused", "split"])
def test_colbert_resident_equals_mmap_bitwise(retrs, resident, splade_dir,
                                              small_corpus, backend):
    qs = _queries(small_corpus, 7, 10)
    got = []
    for retr in (retrs[512], _retriever(splade_dir, resident)):
        retr.set_rerank_backend(backend)
        try:
            retr.reset_stage_stats()
            got.append(retr.search_batch("colbert", q_embs=qs, k=25))
            got.append(retr.search_batch("rerank", q_embs=qs, k=25,
                                         term_ids=small_corpus[
                                             "q_term_ids"][7:17],
                                         term_weights=small_corpus[
                                             "q_term_weights"][7:17]))
            kinds = {n: r["kind"] for n, r in
                     retr.pipeline_stats.snapshot()["stages"].items()}
        finally:
            retr.set_rerank_backend(retr.params.rerank_backend)
    _bit_equal(got[0], got[2])
    _bit_equal(got[1], got[3])
    # a resident pool is gathered on the device
    assert kinds["host_gather:codes"] == kinds["host_gather:residuals"] \
        == "device"


def test_colbert_single_query_is_batch_row(retrs, small_corpus):
    qs = _queries(small_corpus, 3, 6)
    retr = retrs[512]
    pids, scores = retr.search_batch("colbert", q_embs=qs, k=15)
    for b in (0, 2, 5):
        p1, s1 = retr.search("colbert", q_emb=qs[b], k=15)
        np.testing.assert_array_equal(p1, pids[b])
        np.testing.assert_array_equal(s1.view(np.uint32),
                                      scores[b].view(np.uint32))


# -- the tie rule for answers from the card ----------------------------------

def _twin_probe(dev, lo, hi):
    """``dev.probe_batch`` with the tie at the first token's last probe
    broken the other way: that token probes ``hi`` for its twin ``lo``."""
    probe = dev.probe_batch

    def twin_probe(q_embs):
        st = probe(q_embs)
        cids = st["cids"].clone()
        cids[0, 0][cids[0, 0] == lo] = hi
        return dict(st, cids=cids, cand=plaid.stage2_candidates_batch(
            dev.ivf_padded, cids, dev.params.candidate_cap))

    return twin_probe


@pytest.fixture(scope="module")
def twin_index(built_index, small_corpus, tmp_path_factory):
    """The built index with one centroid made a copy of another, so that
    the two score equally against every query token, for the first query
    whose answer changes when the tie breaks the other way. Returns
    (path, query, lo, hi): ``lo`` is the query's first token's last
    probe, ``hi`` > ``lo`` its twin, the longest list that token does
    not probe."""
    ivf = ColBERTIndex(built_index).ivf
    lens = np.diff(ivf.offsets)
    for qi in range(20):
        path = tmp_path_factory.mktemp("twin") / "colbert"
        shutil.copytree(built_index, path)
        q = small_corpus["q_embs"][qi]
        ts = PLAIDSearcher(ColBERTIndex(path), _params(512), device="cpu")
        cids = ts.probe_batch([q])["cids"][0].numpy()
        lo = int(cids[0, -1])
        free = [c for c in range(lo + 1, ivf.n_centroids)
                if c not in set(cids[0])]
        hi = max(free, key=lambda c: lens[c])
        cent = np.load(path / "centroids.npy")
        cent[hi] = cent[lo]
        np.save(path / "centroids.npy", cent)
        ref = PLAIDSearcher(ColBERTIndex(path), _params(512), device="cpu")
        dev = PLAIDSearcher(ColBERTIndex(path), _params(512), device="cpu")
        dev.probe_batch = _twin_probe(dev, lo, hi)
        if not np.array_equal(ref.search(q, k=30)[0], dev.search(q, k=30)[0]):
            return path, q, lo, hi
    raise AssertionError("no query's answer changes with the tie")


def test_tie_reference_follows_a_tied_probe(twin_index):
    path, q, lo, hi = twin_index
    ref = PLAIDSearcher(ColBERTIndex(path), _params(512), device="cpu")
    dev = PLAIDSearcher(ColBERTIndex(path), _params(512), device="cpu")
    dev.probe_batch = _twin_probe(dev, lo, hi)
    want, got = ref.search(q, k=30), dev.search(q, k=30)
    with pytest.raises(AssertionError):
        assert_topk_match(want[1], want[0], got[1], got[0])
    pids, scores, route = colbert_tie_reference(ref, dev, q, 30)
    assert route.split("+")[0] == "probe"
    assert_topk_match(scores, pids, got[1], got[0], what="tied probe")


def test_tie_reference_refuses_answers_without_a_tie(searchers, built_index,
                                                     small_corpus, tmp_path):
    q = small_corpus["q_embs"][8]
    ref = searchers[512]
    with pytest.raises(AssertionError, match="equal the reference"):
        colbert_tie_reference(ref, ref, q, 10)
    # another centroid table probes other centroids, with no tie
    path = tmp_path / "colbert"
    shutil.copytree(built_index, path)
    cent = np.load(path / "centroids.npy")
    np.save(path / "centroids.npy", cent[::-1].copy())
    other = PLAIDSearcher(ColBERTIndex(path), _params(512), device="cpu")
    with pytest.raises(AssertionError, match="without a tie"):
        colbert_tie_reference(ref, other, q, 10)
