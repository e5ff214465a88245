"""The port's device SPLADE stage 1 against the JAX package's.

On the CPU the SPLADE kernel's wrapper runs its plain PyTorch version;
these tests hold that version, the padded postings it reads, the
``SpladeDeviceCache`` around it and the retriever's ``device`` backend
to the JAX package (``impl="ref"`` segment-sum, the Pallas kernel in
interpret mode, and the host CSR scorer), on the same numpy inputs.

Tolerances: kernel scores ``allclose(rtol=1e-4, atol=1e-5)``, the bar of
the JAX package's own SPLADE kernel tests (the one-hot matmul and the
segment-sum add in other orders); ranked answers meet the tie-group bar
of ``repro_torch.testing``. Against the port's own host scorer the
device backend is held bit for bit: it adds each doc's entries in the
host's order, with the host's roundings.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core.multistage import (MultiStageParams as JParams,
                                   MultiStageRetriever as JRetriever)
from repro.core.plaid import PLAIDSearcher as JSearcher
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_device import SpladeDeviceCache as JCache
from repro.index.splade_index import build_splade_index as j_build_splade
from repro.kernels.splade_score.ops import (
    splade_block_scores as j_scores,
    splade_block_scores_batch as j_scores_batch,
    splade_block_topk_batch as j_topk_batch,
)
from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_device import SpladeDeviceCache
from repro_torch.index.splade_index import SpladeIndex, build_splade_index
from repro_torch.kernels.fused_rerank.ref import stable_topk
from repro_torch.kernels.splade_score import ops as ops_module
from repro_torch.kernels.splade_score.ops import (
    SCORE_BLOCK_DOCS, TOPK_BLOCK_DOCS, sort_rows, splade_block_scores, splade_block_scores_batch,
    splade_block_topk_batch, splade_row_block_candidates,
    splade_row_topk_batch, splade_row_topk_packed)
from repro_torch.kernels.splade_score.ref import (block_topk_ref,
                                                  merge_block_topk_ref,
                                                  splade_block_scores_ref,
                                                  splade_row_scores_batch_ref)
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.testing import REF_MARGIN, assert_topk_match

KTOL = dict(rtol=1e-4, atol=1e-5)
FIRST_K = 50

# the methods with a SPLADE stage 1 (``colbert`` probes centroids)
SPLADE_METHODS = tuple(m for m in METHODS if m != "colbert")


@pytest.fixture(scope="module")
def jidx(small_corpus):
    c = small_corpus
    return j_build_splade(c["doc_term_ids"], c["doc_term_weights"],
                          c["cfg"].vocab, c["cfg"].n_docs)


@pytest.fixture(scope="module")
def tidx(small_corpus):
    c = small_corpus
    return build_splade_index(c["doc_term_ids"], c["doc_term_weights"],
                              c["cfg"].vocab, c["cfg"].n_docs)


@pytest.fixture(scope="module")
def queries(small_corpus):
    return (list(small_corpus["q_term_ids"]),
            list(small_corpus["q_term_weights"]))


# ---------------------------------------------------------------------------
# padded postings
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_df", [None, 4])
def test_as_padded_matches_jax_bytes(jidx, tidx, max_df):
    for name in ("term_offsets", "pids", "impacts"):
        np.testing.assert_array_equal(getattr(tidx, name),
                                      getattr(jidx, name))
    jc = JCache(jidx, max_df=max_df)
    tc = SpladeDeviceCache(tidx, max_df=max_df, device="cpu")
    assert tc.max_df == jc.max_df
    assert tc.truncated_terms == jc.truncated_terms
    assert (tc.truncated_terms > 0) == (max_df is not None)
    assert tc.nbytes() == jc.nbytes()
    jp, ji = jidx.as_padded(tc.max_df)
    tp, ti = tidx.as_padded(tc.max_df)
    assert tp.dtype == jp.dtype and ti.dtype == ji.dtype
    assert tp.tobytes() == jp.tobytes() and ti.tobytes() == ji.tobytes()
    assert tc.pids.dtype == torch.int32 and tc.imps.dtype == torch.uint8
    assert tc.pids.numpy().tobytes() == jp.tobytes()
    assert tc.imps.numpy().tobytes() == ji.tobytes()


# ---------------------------------------------------------------------------
# the plain version: values against JAX, order against np.add.at
# ---------------------------------------------------------------------------

def test_cpu_index_add_keeps_np_add_at_order():
    """A 1-D ``index_add_`` on the CPU adds in index order, as
    ``np.add.at`` does: the same float32 bits, duplicates included."""
    rng = np.random.default_rng(3)
    n, m = 2_000_000, 5_000
    idx = rng.integers(0, m, n)
    vals = (rng.random(n, dtype=np.float32)
            * rng.choice(np.float32([1e-3, 1.0, 1e3]), n))
    want = np.zeros(m, np.float32)
    np.add.at(want, idx, vals)
    got = torch.zeros(m).index_add_(0, torch.from_numpy(idx),
                                    torch.from_numpy(vals))
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def _postings(seed, lead, Qt, max_df, n_docs):
    """Random padded postings with −1 pads and repeated pids in a row."""
    rng = np.random.default_rng(seed)
    return (rng.integers(-1, n_docs, lead + (Qt, max_df)).astype(np.int32),
            rng.random(lead + (Qt, max_df), dtype=np.float32),
            rng.random(lead + (Qt,), dtype=np.float32))


@pytest.mark.parametrize("Qt,max_df,n_docs,block_d,chunk", [
    (8, 128, 500, 256, 128),
    (4, 64, 1000, 512, 256),
    (16, 32, 300, 128, 512),
])
def test_plain_scores_match_jax(Qt, max_df, n_docs, block_d, chunk):
    pids, imps, w = _postings(Qt + max_df, (), Qt, max_df, n_docs)
    got = splade_block_scores(torch.from_numpy(pids), torch.from_numpy(imps),
                              torch.from_numpy(w), n_docs=n_docs).numpy()
    assert got.shape == (n_docs,)
    plain = splade_block_scores_ref(torch.from_numpy(pids),
                                    torch.from_numpy(imps),
                                    torch.from_numpy(w), n_docs)
    np.testing.assert_array_equal(got, plain.numpy())
    for impl in ("ref", "interpret"):
        want = j_scores(jnp.asarray(pids), jnp.asarray(imps),
                        jnp.asarray(w), n_docs=n_docs, impl=impl,
                        block_d=block_d, chunk=chunk)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=impl,
                                   **KTOL)


@pytest.mark.parametrize("B,Qt,max_df,n_docs,block_d,chunk", [
    (3, 8, 64, 500, 256, 128),
    (1, 4, 32, 300, 128, 256),
    (5, 16, 16, 700, 512, 64),
])
def test_plain_batch_scores_match_jax(B, Qt, max_df, n_docs, block_d,
                                      chunk):
    pids, imps, w = _postings(B * 31 + Qt, (B,), Qt, max_df, n_docs)
    w[0, 1] = 0.0                           # a disabled term slot
    got = splade_block_scores_batch(
        torch.from_numpy(pids), torch.from_numpy(imps), torch.from_numpy(w),
        n_docs=n_docs).numpy()
    for impl in ("ref", "interpret"):
        want = j_scores_batch(jnp.asarray(pids), jnp.asarray(imps),
                              jnp.asarray(w), n_docs=n_docs, impl=impl,
                              block_d=block_d, chunk=chunk)
        np.testing.assert_allclose(got, np.asarray(want), err_msg=impl,
                                   **KTOL)


def test_plain_topk_matches_jax():
    B, Qt, max_df, n_docs, k = 3, 5, 40, 250, 17
    pids, imps, w = _postings(21, (B,), Qt, max_df, n_docs)
    tp, ts = splade_block_topk_batch(
        torch.from_numpy(pids), torch.from_numpy(imps), torch.from_numpy(w),
        n_docs=n_docs, k=k)
    assert tp.dtype == torch.int32 and tp.shape == (B, k)
    jp, js = j_topk_batch(jnp.asarray(pids), jnp.asarray(imps),
                          jnp.asarray(w), n_docs=n_docs, k=k + REF_MARGIN,
                          impl="ref")
    assert_topk_match(np.asarray(js), np.asarray(jp), ts.numpy(),
                      tp.numpy(), **KTOL)


@pytest.mark.parametrize("k", [50, 200])
def test_device_cache_equals_host_scorer_bitwise(tidx, queries, k):
    """The plain version sums in the host scorer's order: pids and score
    bits equal, ties at the last place included."""
    tids, tw = queries
    hp, hs = tidx.score_batch_host(tids, tw, k)
    dp, ds = SpladeDeviceCache(tidx, device="cpu").score_topk(tids, tw, k)
    np.testing.assert_array_equal(dp, hp)
    np.testing.assert_array_equal(ds.view(np.uint32), hs.view(np.uint32))


# ---------------------------------------------------------------------------
# the pid-sorted rows the kernel searches, and the top-k entry point
# ---------------------------------------------------------------------------

def _cache_rows(cache, tids, tw):
    rows, w = cache.scaled_weights(*cache.pad_queries(tids, tw))
    return torch.from_numpy(rows), torch.from_numpy(w)


@pytest.mark.parametrize("max_df", [None, 4])
def test_sorted_copy_scores_equal_padded_layout(tidx, queries, max_df):
    """The cache's pid-sorted rows give, through the plain version, the
    scores of the ``as_padded`` layout bit for bit: each doc's entries
    keep their (term slot, posting slot) order. With truncation the
    layout is unsorted and the copy differs from it."""
    cache = SpladeDeviceCache(tidx, max_df=max_df, device="cpu")
    def is_sorted(pids):
        key = pids.numpy().view(np.uint32).astype(np.int64)
        return bool((np.diff(key, axis=1) >= 0).all())

    assert is_sorted(cache.row_pids)
    assert is_sorted(cache.pids) == (max_df is None)
    assert (cache.row_pids is cache.pids) == (max_df is None)
    rows, w = _cache_rows(cache, *queries)
    got = splade_row_scores_batch_ref(cache.row_pids, cache.row_imps, rows,
                                      w, cache.n_docs)
    want = splade_row_scores_batch_ref(cache.pids, cache.imps, rows, w,
                                       cache.n_docs)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


def test_cache_sorts_unsorted_untruncated_rows(tidx, queries):
    """An index whose postings are not pid-sorted (each term's reversed)
    and not truncated: the cache sorts its rows for the kernel's search,
    and still equals the host scorer bit for bit."""
    off = tidx.term_offsets
    order = np.concatenate([np.arange(off[t + 1] - 1, off[t] - 1, -1)
                            for t in range(tidx.vocab)]).astype(np.int64)
    rev = dataclasses.replace(tidx, pids=tidx.pids[order],
                              impacts=tidx.impacts[order])
    cache = SpladeDeviceCache(rev, device="cpu")
    assert cache.truncated_terms == 0 and cache.row_pids is not cache.pids
    key = cache.row_pids.numpy().view(np.uint32).astype(np.int64)
    assert (np.diff(key, axis=1) >= 0).all()
    tids, tw = queries
    for k in (50, rev.n_docs + 5):
        dp, ds = cache.score_topk(tids, tw, k)
        hp, hs = rev.score_batch_host(tids, tw, k)
        np.testing.assert_array_equal(dp, hp)
        np.testing.assert_array_equal(ds.view(np.uint32), hs.view(np.uint32))


def test_sort_rows_is_stable_on_repeated_pids():
    """A hand-made row with repeated pids, −1 pads first and last, and
    impacts that make the order of additions visible: the sorted row
    keeps each pid's entries in posting order, −1 pads last, and scores
    as the unsorted row does, bit for bit."""
    pids = torch.tensor([[-1, 7, 3, 7, 0, 3, 7, -1, 2]], dtype=torch.int32)
    imps = torch.tensor([[9.0, 1e8, 1.0, -1e8, 5.0, 3.0, 1.0, 9.0, 2.0]])
    sp, si = sort_rows(pids, imps)
    assert sp.tolist() == [[0, 2, 3, 3, 7, 7, 7, -1, -1]]
    assert si.tolist() == [[5.0, 2.0, 1.0, 3.0, 1e8, -1e8, 1.0, 9.0, 9.0]]
    rows = torch.zeros((1, 1), dtype=torch.int32)
    w = torch.ones((1, 1))
    got = splade_row_scores_batch_ref(sp, si, rows, w, 8)
    want = splade_row_scores_batch_ref(pids, imps, rows, w, 8)
    assert got[0, 7].item() == 1.0          # (1e8 - 1e8) + 1, in order
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))


@pytest.mark.parametrize("k", [1, 50, 200, "n_docs", "n_docs+5"])
def test_topk_entry_matches_jax_and_host(tidx, queries, k):
    """The top-k entry point on the CPU (the plain version: the scores
    and one stable sort) against ``lax.top_k`` over the JAX reference
    scores, and bit for bit against the host scorer; the per-block
    candidates and their merge (the launch's two steps) give the same
    answer, at the kernel's block size and at sizes that cut this index
    into many blocks."""
    n_docs = tidx.n_docs
    k = {"n_docs": n_docs, "n_docs+5": n_docs + 5}.get(k, k)
    k_eff = min(k, n_docs)
    tids, tw = queries
    cache = SpladeDeviceCache(tidx, device="cpu")
    rows, w = _cache_rows(cache, tids, tw)
    args = (cache.row_pids, cache.row_imps, rows, w)
    tp, ts = splade_row_topk_batch(*args, n_docs=n_docs, k=k_eff)
    assert tp.dtype == torch.int32 and tp.shape == (len(tids), k_eff)
    hp, hs = tidx.score_batch_host(tids, tw, k)
    np.testing.assert_array_equal(tp.numpy(), hp[:, :k_eff])
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  hs[:, :k_eff].view(np.uint32))
    dp, ds = cache.score_topk(tids, tw, k)
    np.testing.assert_array_equal(dp, hp)
    np.testing.assert_array_equal(ds.view(np.uint32), hs.view(np.uint32))
    live = (rows >= 0).numpy()
    safe = np.where(live, rows.numpy(), 0)
    post_pids = np.where(live[..., None], cache.pids.numpy()[safe], -1)
    post_imps = cache.imps.numpy()[safe].astype(np.float32)
    jp, js = j_topk_batch(jnp.asarray(post_pids), jnp.asarray(post_imps),
                          jnp.asarray(w.numpy()), n_docs=n_docs,
                          k=min(k_eff + REF_MARGIN, n_docs), impl="ref")
    assert_topk_match(np.asarray(js), np.asarray(jp), ts.numpy(),
                      tp.numpy(), **KTOL)
    packed = splade_row_topk_packed(*args, n_docs=n_docs, k=k_eff)
    assert torch.equal(packed[0], tp)
    assert torch.equal(packed[1], ts.view(torch.int32))
    cs, cp = splade_row_block_candidates(*args, n_docs=n_docs, k=k_eff)
    n_blocks = -(-n_docs // TOPK_BLOCK_DOCS)
    assert cs.shape == cp.shape == (len(tids),
                                    n_blocks * min(k_eff, TOPK_BLOCK_DOCS))
    mp, ms = merge_block_topk_ref(cs, cp, k_eff)
    assert torch.equal(mp, tp) and torch.equal(ms, ts)
    scores = splade_row_scores_batch_ref(*args, n_docs)
    for block_d in (16, 100):
        mp, ms = merge_block_topk_ref(*block_topk_ref(scores, k_eff, block_d),
                                      k_eff)
        assert torch.equal(mp, tp) and torch.equal(ms, ts)


def test_block_sizes_match_kernel_source():
    """The wrappers size the top-k launch's buffers by the block sizes
    the kernel fixes: the two must agree."""
    src = (pathlib.Path(ops_module.__file__).parents[1] / "csrc"
           / "splade_score.cu").read_text()
    for const, name in ((SCORE_BLOCK_DOCS, "kScoreBlockD"),
                        (TOPK_BLOCK_DOCS, "kTopkBlockD")):
        assert re.search(rf"\b{name} = {const};", src), name


@pytest.mark.parametrize("n_docs,block_d,k", [
    (50, 16, 5), (50, 16, 16), (50, 16, 17), (64, 16, 3), (50, 16, 50),
])
def test_block_candidates_keep_ties_and_zeros(n_docs, block_d, k):
    """Per-block candidates over quantised scores that tie often, with
    most docs at zero and an all-zero query: each block emits its
    min(k, docs in block) best in pid order, then (−inf, −1), and the
    merge equals one stable sort of the whole rows — so the zero-score
    docs of lowest pid fill the top-k when fewer than k docs score."""
    rng = np.random.default_rng(n_docs + block_d + k)
    scores = np.where(rng.random((3, n_docs)) < 0.3,
                      rng.integers(1, 4, (3, n_docs)), 0).astype(np.float32)
    scores[1] = 0.0
    scores = torch.from_numpy(scores)
    cs, cp = block_topk_ref(scores, k, block_d)
    kb = min(k, block_d)
    cs = cs.view(3, -1, kb)
    cp = cp.view(3, -1, kb)
    for blk in range(cs.shape[1]):
        lo, hi = blk * block_d, min((blk + 1) * block_d, n_docs)
        n = min(k, hi - lo)
        _, idx = stable_topk(scores[:, lo:hi], n)
        want = idx.sort(dim=-1)[0] + lo
        assert torch.equal(cp[:, blk, :n].long(), want)
        assert torch.equal(cs[:, blk, :n], scores.gather(1, want))
        assert (cp[:, blk, n:] == -1).all()
        assert (cs[:, blk, n:] == float("-inf")).all()
    mp, ms = merge_block_topk_ref(cs.view(3, -1), cp.view(3, -1),
                                  min(k, n_docs))
    vals, idx = stable_topk(scores, min(k, n_docs))
    assert torch.equal(mp.long(), idx) and torch.equal(ms, vals)
    assert torch.equal(mp[1].long(), torch.arange(min(k, n_docs)))


def _pad_queries_loop(vocab, term_ids, term_weights):
    """The per-query loop ``pad_queries`` replaced, kept as the
    reference of its output."""
    B = len(term_ids)
    qt = max((len(np.atleast_1d(t)) for t in term_ids), default=1)
    tids = np.full((B, max(qt, 1)), -1, np.int32)
    w = np.zeros((B, max(qt, 1)), np.float32)
    for i in range(B):
        t = np.atleast_1d(np.asarray(term_ids[i], np.int32))
        tw = np.atleast_1d(np.asarray(term_weights[i], np.float32))
        if (t >= vocab).any():
            raise IndexError(f"term id {int(t.max())} out of range "
                             f"for vocab {vocab} (query {i})")
        tids[i, :len(t)] = t
        w[i, :len(tw)] = tw
    return tids, w


@pytest.mark.parametrize("case", ["ragged", "empty", "all_zero", "none",
                                  "scalar"])
def test_pad_queries_matches_loop(tidx, queries, case):
    cache = SpladeDeviceCache(tidx, device="cpu")
    tids, tw = (list(q[:7]) for q in queries)
    if case == "ragged":
        tids[2], tw[2] = tids[2][:1], tw[2][:1]
        tids[4] = np.asarray(tids[4], np.int64)       # other dtypes
        tw[4] = list(np.asarray(tw[4], np.float64))
    elif case == "empty":
        tids[1] = np.zeros(0, np.int32)
        tw[1] = np.zeros(0, np.float32)
        tids[6] = np.array([-1, 3], np.int32)         # a negative id
    elif case == "all_zero":
        tw = [np.zeros_like(t, np.float32) for t in tw]
    elif case == "none":
        tids, tw = [np.zeros(0, np.int32)] * 2, [np.zeros(0, np.float32)] * 2
    else:
        tids, tw = [np.int32(5), [1, 2]], [np.float32(0.5), [1.0, 2.0]]
    got = cache.pad_queries(tids, tw)
    want = _pad_queries_loop(tidx.vocab, tids, tw)
    for g, e in zip(got, want):
        assert g.dtype == e.dtype and g.shape == e.shape
        np.testing.assert_array_equal(g, e)
    for g, e in zip(cache.pad_queries([], []),
                    _pad_queries_loop(tidx.vocab, [], [])):
        assert g.dtype == e.dtype and g.shape == e.shape == (0, 1)


def test_pad_queries_rejects_out_of_vocabulary(tidx, queries):
    cache = SpladeDeviceCache(tidx, device="cpu")
    tids, tw = (list(q[:5]) for q in queries)
    tids[3] = np.array([1, tidx.vocab + 7, 2], np.int32)
    tw[3] = np.ones(3, np.float32)
    with pytest.raises(IndexError) as got:
        cache.pad_queries(tids, tw)
    with pytest.raises(IndexError) as want:
        _pad_queries_loop(tidx.vocab, tids, tw)
    assert str(got.value) == str(want.value)
    assert "query 3" in str(got.value)


# ---------------------------------------------------------------------------
# SpladeDeviceCache against the JAX cache and the host scorer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_df", [None, 4])
def test_device_cache_matches_jax(jidx, tidx, queries, max_df):
    tids, tw = queries
    tids, tw = tids[:24], tw[:24]
    k = 30
    tc = SpladeDeviceCache(tidx, max_df=max_df, device="cpu")
    got = tc.score_topk(tids, tw, k)
    assert got[0].shape == (24, k) and got[0].dtype == np.int64
    jp, js = JCache(jidx, max_df=max_df).score_topk(tids, tw, k + REF_MARGIN,
                                                    impl="ref")
    assert_topk_match(js, jp, got[1], got[0])
    if max_df is None:
        hp, hs = jidx.score_batch_host(tids, tw, k + REF_MARGIN)
        assert_topk_match(hs, hp, got[1], got[0])


def test_device_cache_edge_cases(jidx, tidx, queries):
    tids, tw = queries
    tc = SpladeDeviceCache(tidx, device="cpu")
    jc = JCache(jidx)
    # all-zero weights: every score 0, ids by ascending pid
    zp, zs = tc.score_topk([np.array([1, 2, 3], np.int32)],
                           [np.zeros(3, np.float32)], 5)
    assert (zs == 0).all()
    np.testing.assert_array_equal(zp[0], np.arange(5))
    # k > n_docs: (-1, 0) padding past n_docs, as the JAX cache pads
    k = tidx.n_docs + 13
    dp, ds = tc.score_topk(tids[:2], tw[:2], k)
    assert dp.shape == (2, k)
    assert (dp[:, tidx.n_docs:] == -1).all() and (ds[:, tidx.n_docs:] == 0).all()
    jp, js = jc.score_topk(tids[:2], tw[:2], k, impl="ref")
    assert_topk_match(js, jp, ds, dp)
    # out-of-vocabulary ids raise, as the JAX cache does
    bad = [np.array([tidx.vocab + 3], np.int32)]
    with pytest.raises(IndexError, match="out of range"):
        tc.score_topk(bad, [np.array([1.0], np.float32)], 5)
    with pytest.raises(IndexError, match="out of range"):
        jc.score_topk(bad, [np.array([1.0], np.float32)], 5, impl="ref")
    # negative ids and zero weights are skipped, not raised
    sp, ss = tc.score_topk([np.array([-1, tids[0][0]], np.int32)],
                           [np.array([1.0, tw[0][0]], np.float32)], 10)
    hp, hs = tidx.score_batch_host([np.array([-1, tids[0][0]], np.int32)],
                                   [np.array([1.0, tw[0][0]], np.float32)],
                                   10)
    np.testing.assert_array_equal(sp, hp)
    np.testing.assert_array_equal(ss, hs)


def test_truncated_postings_keep_top_impacts():
    n_docs = 12
    ids = np.zeros((n_docs, 1), np.int32)           # every doc has term 0
    w = np.arange(1, n_docs + 1, dtype=np.float32).reshape(n_docs, 1)
    idx = build_splade_index(ids, w, vocab=4, n_docs=n_docs)
    cache = SpladeDeviceCache(idx, max_df=4, device="cpu")
    assert cache.max_df == 4 and cache.truncated_terms == 1
    q = [np.array([0], np.int32)], [np.array([1.0], np.float32)]
    tp, ts = cache.score_topk(*q, k=n_docs)
    ep, es = idx.score_batch_host(*q, k=n_docs)
    np.testing.assert_array_equal(tp[0, :4], ep[0, :4])
    np.testing.assert_array_equal(ts[0, :4], es[0, :4])
    assert (ts[0, 4:] == 0).all() and (es[0, 4:] > 0).all()


# ---------------------------------------------------------------------------
# the retriever's device backend against the JAX retriever
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def splade_dir(jidx, tmp_path_factory):
    path = tmp_path_factory.mktemp("splade_device")
    jidx.save(path)
    return path


@pytest.fixture(scope="module")
def retr(built_index, splade_dir):
    return MultiStageRetriever(
        SpladeIndex.load(splade_dir, mmap=True),
        PLAIDSearcher(ColBERTIndex(built_index, mode="mmap"), device="cpu"),
        MultiStageParams(first_k=FIRST_K, k=20, splade_backend="device"),
        device="cpu")


@pytest.fixture(scope="module")
def jax_retrs(built_index, jidx):
    searcher = JSearcher(JIndex(built_index, mode="mmap"))
    return {b: JRetriever(jidx, searcher,
                          JParams(first_k=FIRST_K, k=20, splade_backend=b))
            for b in ("jax", "pallas")}


def _requests(corpus, methods, ks, alphas, lo=0):
    return [Request(qid=lo + i, method=m, q_emb=corpus["q_embs"][lo + i],
                    term_ids=corpus["q_term_ids"][lo + i],
                    term_weights=corpus["q_term_weights"][lo + i], k=k,
                    alpha=a)
            for i, (m, k, a) in enumerate(zip(methods, ks, alphas))]


def _jax_answer(jr, reqs):
    alphas = [r.alpha for r in reqs]
    pids, scores = jr.search_batch(
        [r.method for r in reqs], q_embs=[r.q_emb for r in reqs],
        term_ids=[r.term_ids for r in reqs],
        term_weights=[r.term_weights for r in reqs],
        alpha=None if all(a is None for a in alphas) else alphas,
        k=max(r.k for r in reqs) + REF_MARGIN)
    return list(zip(pids, scores))


@pytest.mark.parametrize("backend", ["jax", "pallas"])
@pytest.mark.parametrize("method", SPLADE_METHODS)
def test_device_backend_matches_jax(retr, jax_retrs, small_corpus, method,
                                    backend):
    reqs = _requests(small_corpus, [method] * 8, [20] * 8, [None] * 8)
    results = ServeEngine(retr).process_batch(reqs)
    for res, req, (wp, ws) in zip(results, reqs,
                                  _jax_answer(jax_retrs[backend], reqs)):
        assert_topk_match(ws, wp, res.scores, res.pids,
                          what=f"{backend} qid {req.qid} {req.method}")


@pytest.mark.parametrize("backend", ["jax", "pallas"])
def test_device_backend_mixed_batch_matches_jax(retr, jax_retrs,
                                                small_corpus, backend):
    methods = ["hybrid", "rerank", "splade", "hybrid", "rerank", "splade",
               "hybrid", "hybrid", "rerank", "splade"]
    ks = [20, 1, FIRST_K, 5, 20, 7, 1, FIRST_K, 13, 20]
    alphas = [0.0, None, 0.9, 1.0, None, None, 0.1, 0.5, 0.3, None]
    reqs = _requests(small_corpus, methods, ks, alphas, lo=20)
    results = ServeEngine(retr).process_batch(reqs)
    for res, req, (wp, ws) in zip(results, reqs,
                                  _jax_answer(jax_retrs[backend], reqs)):
        assert_topk_match(ws, wp, res.scores, res.pids,
                          what=f"{backend} qid {req.qid} {req.method}")


def test_device_stage1_equals_host_stage1(retr, small_corpus):
    tids = list(small_corpus["q_term_ids"])
    tw = list(small_corpus["q_term_weights"])
    assert retr.splade_backend == "device"
    dp, ds = retr.run_splade_batch(tids, tw)
    hp, hs = retr.run_splade_batch(tids, tw, backend="host")
    assert dp.shape == (len(tids), FIRST_K)
    np.testing.assert_array_equal(dp, hp)
    np.testing.assert_array_equal(ds.view(np.uint32), hs.view(np.uint32))
    with pytest.raises(ValueError, match="backend"):
        retr.run_splade_batch(tids, tw, backend="pallas")


@pytest.mark.parametrize("method", SPLADE_METHODS)
def test_device_backend_answers_equal_host_backend(retr, small_corpus,
                                                   method):
    """Stage 1 is bitwise equal, so whole answers are too."""
    kw = dict(q_embs=small_corpus["q_embs"][:12],
              term_ids=small_corpus["q_term_ids"][:12],
              term_weights=small_corpus["q_term_weights"][:12],
              alpha=np.linspace(0, 1, 12), k=30)
    try:
        retr.reset_stage_stats()
        dev = retr.search_batch(method, **kw)
        stages = retr.pipeline_stats.snapshot()["stages"]
        assert stages["splade_stage1"]["kind"] == "device"
        retr.set_splade_backend("host")
        host = retr.search_batch(method, **kw)
    finally:
        retr.set_splade_backend("device")
    np.testing.assert_array_equal(dev[0], host[0])
    np.testing.assert_array_equal(dev[1].view(np.uint32),
                                  host[1].view(np.uint32))


def test_engine_backend_override(built_index, splade_dir):
    r = MultiStageRetriever(
        SpladeIndex.load(splade_dir),
        PLAIDSearcher(ColBERTIndex(built_index), device="cpu"),
        MultiStageParams(first_k=FIRST_K), device="cpu")
    assert r.splade_backend == "host" and r._splade_device is None
    ServeEngine(r, splade_backend="device")
    assert r.splade_backend == "device"
    cache = r.splade_device_cache()
    assert cache.device == torch.device("cpu")
    assert r.splade_device_cache() is cache          # built once
    ServeEngine(r, splade_backend="host")
    assert r.splade_backend == "host"
    for bad in ("jax", "cuda", "pallas"):
        with pytest.raises(ValueError, match="'device'"):
            r.set_splade_backend(bad)
        with pytest.raises(ValueError, match="splade backend"):
            ServeEngine(r, splade_backend=bad)
    with pytest.raises(ValueError, match="splade backend"):
        MultiStageRetriever(r.splade, r.searcher,
                            MultiStageParams(splade_backend="jax"),
                            device="cpu")
