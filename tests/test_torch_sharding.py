"""Frozen in-process shard groups in the port, with ``device="cpu"``,
on an index the JAX package's ``build_colbert_index`` wrote.

Splitting: ``shard_boundaries`` equals the JAX function, errors
included; ``split_index_tree`` writes the JAX package's group byte for
byte. Against the JAX package's ``ShardedRetriever`` over the same
group directories: the four methods, a mixed batch with per-query α,
single queries and the plans' shapes (scores ``allclose(rtol=1e-5,
atol=1e-5)``, ids equal up to tie groups). Inside the port, bit for bit:
groups of 2 and 4 shards equal the unsharded retriever (both tails; for
colbert at a candidate cap that cannot bind), a one-shard group is the
unsharded path, a stage-1 cache hit equals the cold answer, and the
engine at depth 1 and 2 and the server give the same bits. The
``splade_max_df`` postings cap truncates each shard's postings on its
own, so the bit-for-bit bar is held with untruncated postings (the
default, ``None``), as the JAX package's is.
"""

import json
import threading

import numpy as np
import pytest

from repro.core.multistage import MultiStageParams as JParams
from repro.core.plaid import PlaidParams as JPlaid
from repro.core.sharded import build_sharded_retriever as j_build_group
from repro.core.sharded import compact_owned as j_compact_owned
from repro.index.builder import build_colbert_index as j_build_colbert
from repro.index.sharding import load_group as j_load_group
from repro.index.sharding import shard_boundaries as j_boundaries
from repro.index.sharding import split_index_tree as j_split
from repro.index.splade_index import build_splade_index as j_build_splade
from repro.serving.context import CacheHierarchy as JCaches
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServeEngine as JEngine
from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.core.sharded import (CombinedAccessStats, ShardedRetriever,
                                      build_sharded_retriever, compact_owned,
                                      scatter_scores)
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.sharding import (load_group, shard_boundaries,
                                        split_colbert_index, split_index_tree,
                                        split_splade_index)
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.pipeline import (DEVICE, HOST, CandidateBatch,
                                          PipelineExecutor, PipelineStats,
                                          Stage, StagePlan)
from repro_torch.serving.server import RetrievalServer
from repro_torch.testing import (REF_MARGIN, assert_same_up_to_exact_ties,
                                 assert_topk_match)

# 512 is above the small corpus's 400 docs, so the cap cannot bind and a
# group's candidates are the single index's; 16 binds on every query
PLAID = dict(nprobe=8, candidate_cap=512, ndocs=128, k=50)
BINDING = dict(nprobe=8, candidate_cap=16, ndocs=16, k=50)
MS = dict(first_k=50, k=20)
SHARDS = (2, 4)


@pytest.fixture(autouse=True)
def no_pipeline_thread_left():
    """No executor worker (``pipe-*``) or server worker (``worker-*``)
    outlives its test. The groups' pool threads (``shard_*``) idle until
    the process ends, like the JAX package's."""
    before = set(threading.enumerate())
    yield
    left = []
    for t in set(threading.enumerate()) - before:
        if t.name.startswith(("pipe-", "worker-", "pipeline-retry")):
            t.join(timeout=10)
            if t.is_alive():
                left.append(t.name)
    assert not left, f"threads left running: {left}"


@pytest.fixture(scope="module")
def base_dir(tmp_path_factory, small_corpus):
    """Serve-layout index (<base>/{colbert,splade}) that the JAX
    package built, and its groups of 2 and 4 shards beside it."""
    c = small_corpus
    base = tmp_path_factory.mktemp("torch_shard_base")
    j_build_colbert(base / "colbert", c["doc_embs"], c["doc_lens"], nbits=4,
                    n_centroids=128, kmeans_iters=4)
    j_build_splade(c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
                   c["cfg"].n_docs).save(base / "splade")
    for s in SHARDS:
        j_split(base, s, group_dir=base / f"jax{s}")
    return base


def _port_group(group_dir, plaid=PLAID, **ms):
    dirs, bounds = load_group(group_dir)
    return build_sharded_retriever(
        dirs, bounds, plaid_params=PlaidParams(**plaid),
        multistage_params=MultiStageParams(**dict(MS, **ms)), device="cpu")


def _jax_group(group_dir, plaid=PLAID):
    dirs, bounds = j_load_group(group_dir)
    return j_build_group(dirs, bounds, plaid_params=JPlaid(**plaid),
                         multistage_params=JParams(**MS))


def _unsharded(base, plaid=PLAID, rerank="fused", resident=False, **ms):
    return MultiStageRetriever(
        SpladeIndex.load(base / "splade", mmap=True),
        PLAIDSearcher(ColBERTIndex(base / "colbert", mode="mmap"),
                      PlaidParams(**plaid), device_resident=resident,
                      device="cpu"),
        MultiStageParams(**dict(MS, rerank_backend=rerank, **ms)),
        device="cpu")


@pytest.fixture(scope="module")
def groups(base_dir):
    """{n_shards: port group} over the groups the port split."""
    return {s: _port_group(split_index_tree(base_dir, s,
                                            group_dir=base_dir / f"port{s}"))
            for s in SHARDS}


@pytest.fixture(scope="module")
def unsharded(base_dir):
    return {tail: _unsharded(base_dir, rerank=tail)
            for tail in ("fused", "split")}


@pytest.fixture(scope="module")
def jax_groups(base_dir):
    return {s: _jax_group(base_dir / f"jax{s}") for s in SHARDS}


@pytest.fixture(scope="module")
def cross_groups(base_dir):
    """{n_shards: port group} over the directories the JAX package
    split."""
    return {s: _port_group(base_dir / f"jax{s}") for s in SHARDS}


def _batch(corpus, lo, hi):
    return dict(q_embs=corpus["q_embs"][lo:hi],
                term_ids=corpus["q_term_ids"][lo:hi],
                term_weights=corpus["q_term_weights"][lo:hi])


def _same_bits(want, got, what=""):
    np.testing.assert_array_equal(want[0], got[0], err_msg=f"{what} ids")
    np.testing.assert_array_equal(np.asarray(want[1]).view(np.uint32),
                                  np.asarray(got[1]).view(np.uint32),
                                  err_msg=f"{what} score bits")


def _meets_bar(want, got, what=""):
    for b in range(len(got[0])):
        assert_topk_match(want[1][b], want[0][b], got[1][b], got[0][b],
                          what=f"{what} row {b}")


# ---------------------------------------------------------------------------
# splitting
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_docs,n_shards", [
    (401, 4), (400, 2), (400, 4), (7, 7), (10, 3), (1, 1), (100, 1),
    (3, 5), (10, 0), (10, -1)])
def test_shard_boundaries_match_jax(n_docs, n_shards):
    try:
        want = j_boundaries(n_docs, n_shards)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            shard_boundaries(n_docs, n_shards)
        assert str(got.value) == str(e)
        return
    got = shard_boundaries(n_docs, n_shards)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_split_writes_the_jax_groups_bytes(base_dir, groups, n_shards):
    port, jax = base_dir / f"port{n_shards}", base_dir / f"jax{n_shards}"
    files = sorted(p.relative_to(jax) for p in jax.rglob("*")
                   if p.is_file())
    assert files == sorted(p.relative_to(port) for p in port.rglob("*")
                           if p.is_file())
    assert len(files) == 1 + n_shards * 14
    for rel in files:
        a, b = (jax / rel).read_bytes(), (port / rel).read_bytes()
        if rel.suffix == ".json":
            assert json.loads(a) == json.loads(b), rel
        else:
            assert a == b, rel


@pytest.mark.parametrize("n_shards", SHARDS)
def test_split_keeps_the_quantum_and_covers_the_pool(base_dir, groups,
                                                     n_shards):
    sidx = SpladeIndex.load(base_dir / "splade")
    meta = json.loads((base_dir / "colbert" / "meta.json").read_text())
    dirs, bounds = load_group(base_dir / f"port{n_shards}")
    parts = [SpladeIndex.load(d / "splade") for d in dirs]
    metas = [json.loads((d / "colbert" / "meta.json").read_text())
             for d in dirs]
    assert sum(m["n_tokens"] for m in metas) == meta["n_tokens"]
    assert sum(m["n_docs"] for m in metas) == meta["n_docs"]
    assert sum(len(p.pids) for p in parts) == len(sidx.pids)
    for p, m, lo, hi in zip(parts, metas, bounds[:-1], bounds[1:]):
        assert p.quantum == sidx.quantum
        assert p.n_docs == m["n_docs"] == hi - lo
        assert p.pids.min() >= 0 and p.pids.max() < p.n_docs
        assert m["nbits"] == meta["nbits"]
        assert m["n_centroids"] == meta["n_centroids"]
    # a term's postings glue back to the unsharded row
    t = int(np.argmax(np.diff(sidx.term_offsets)))
    glued = np.concatenate([p.pids[p.term_offsets[t]:p.term_offsets[t + 1]]
                            + lo for p, lo in zip(parts, bounds[:-1])])
    np.testing.assert_array_equal(
        glued, sidx.pids[sidx.term_offsets[t]:sidx.term_offsets[t + 1]])
    assert split_splade_index(sidx, bounds)[0].quantum == sidx.quantum


def test_split_is_idempotent_and_load_group_is_the_jaxs(base_dir, groups):
    group = base_dir / "port2"
    stamp = (group / "0" / "colbert" / "codes.bin").stat().st_mtime_ns
    assert split_index_tree(base_dir, 2, group_dir=group) == group
    assert (group / "0" / "colbert" / "codes.bin").stat().st_mtime_ns \
        == stamp
    dirs, bounds = load_group(group)
    j_dirs, j_bounds = j_load_group(group)
    assert dirs == j_dirs
    np.testing.assert_array_equal(bounds, j_bounds)
    with pytest.raises(ValueError, match="one output dir per shard"):
        split_colbert_index(base_dir / "colbert", dirs[:1], bounds)


# ---------------------------------------------------------------------------
# the merge helpers
# ---------------------------------------------------------------------------

def test_compact_owned_is_the_jax_slice_without_its_padding(rng):
    gpids = rng.permutation(400)[:6 * 50].reshape(6, 50).astype(np.int64)
    gpids[1, 30:] = -1
    gpids[4] = -1
    for lo, hi in ((0, 100), (100, 250), (250, 400), (390, 400)):
        cols, local = compact_owned(gpids, lo, hi)
        j_cols, j_local = j_compact_owned(gpids, lo, hi)
        w = cols.shape[1]
        owned = ((gpids >= lo) & (gpids < hi)).sum(axis=1)
        assert w == max(int(owned.max()), 1)
        # the JAX slice pads its width to a power of two with -1 columns
        np.testing.assert_array_equal(cols, j_cols[:, :w])
        np.testing.assert_array_equal(local, j_local[:, :w])
        assert (j_cols[:, w:] == -1).all()
        out = np.full(gpids.shape, np.nan, np.float32)
        scatter_scores(out, cols, local.astype(np.float32))
        mine = (gpids >= lo) & (gpids < hi)
        np.testing.assert_array_equal(out[mine], gpids[mine] - lo)
        assert np.isnan(out[~mine]).all()


def test_combined_access_stats_sums_its_parts(groups, small_corpus):
    retr = groups[2]
    stats = [sh.searcher.index.store.stats for sh in retr.shards]
    combined = CombinedAccessStats(stats)
    combined.reset()
    retr.search_batch("rerank", k=10, **_batch(small_corpus, 0, 4))
    snap, parts = combined.snapshot(), [s.snapshot() for s in stats]
    for key in snap:
        assert snap[key] == sum(p[key] for p in parts)
    assert snap["pages_touched"] > 0
    assert all(p["gathers"] > 0 for p in parts)
    combined.reset()
    assert combined.snapshot()["tokens_read"] == 0


def test_a_group_reads_the_unsharded_tokens(groups, unsharded,
                                            small_corpus):
    kw = _batch(small_corpus, 0, 8)
    read = []
    for retr in (unsharded["split"], groups[2], groups[4]):
        shards = getattr(retr, "shards", [retr])
        stats = CombinedAccessStats(
            [sh.searcher.index.store.stats for sh in shards])
        stats.reset()
        retr.search_batch("hybrid", k=10, **kw)
        read.append(stats.snapshot()["tokens_read"])
    assert read[0] > 0 and read == [read[0]] * 3


# ---------------------------------------------------------------------------
# against the JAX package's groups
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("method", METHODS)
def test_group_matches_jax(cross_groups, jax_groups, small_corpus, method,
                           n_shards):
    kw = _batch(small_corpus, 0, 8)
    want = jax_groups[n_shards].search_batch(method, k=15 + REF_MARGIN, **kw)
    got = cross_groups[n_shards].search_batch(method, k=15, **kw)
    assert got[0].shape == (8, 15)
    _meets_bar(want, got, f"{method} S={n_shards}")


@pytest.mark.parametrize("n_shards", SHARDS)
def test_mixed_batch_with_own_alphas_matches_jax(cross_groups, jax_groups,
                                                 small_corpus, n_shards):
    methods = [METHODS[i % 4] for i in range(12)]
    alphas = [None, 0.1, 0.9, None, 0.5, 0.3, None, 0.7, 0.0, 1.0, None,
              0.2]
    kw = _batch(small_corpus, 8, 20)
    want = jax_groups[n_shards].search_batch(methods, alpha=alphas,
                                             k=10 + REF_MARGIN, **kw)
    got = cross_groups[n_shards].search_batch(methods, alpha=alphas, k=10,
                                              **kw)
    _meets_bar(want, got, f"mixed S={n_shards}")


@pytest.mark.parametrize("method", METHODS)
def test_single_query_search_matches_jax(cross_groups, jax_groups,
                                         small_corpus, method):
    q = dict(q_emb=small_corpus["q_embs"][3],
             term_ids=small_corpus["q_term_ids"][3],
             term_weights=small_corpus["q_term_weights"][3])
    wp, ws = jax_groups[2].search(method, k=12 + REF_MARGIN, **q)
    gp, gs = cross_groups[2].search(method, k=12, **q)
    assert_topk_match(ws, wp, gs, gp, what=method)


@pytest.mark.parametrize("n_shards", SHARDS)
def test_colbert_at_a_binding_cap_matches_jax(base_dir, small_corpus,
                                              n_shards):
    """Each shard caps its own candidates (the group keeps more than the
    single index where the cap binds), in both packages alike."""
    kw = dict(q_embs=small_corpus["q_embs"][:10])
    want = _jax_group(base_dir / f"jax{n_shards}", BINDING).search_batch(
        "colbert", k=20 + REF_MARGIN, **kw)
    got = _port_group(base_dir / f"jax{n_shards}", BINDING).search_batch(
        "colbert", k=20, **kw)
    _meets_bar(want, got, f"binding cap S={n_shards}")


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("method", METHODS)
def test_plans_have_the_jax_shape(cross_groups, jax_groups, method,
                                  n_shards):
    got = cross_groups[n_shards].compile_plan(method)
    want = jax_groups[n_shards].compile_plan(method)
    assert got.stage_names() == want.stage_names()
    fields = ("name", "kind", "fanout", "pooled", "opens_async",
              "closes_async")
    assert [tuple(getattr(s, f) for f in fields) for s in got.stages] == \
        [tuple(getattr(s, f) for f in fields) for s in want.stages]
    assert got.pool is cross_groups[n_shards]._pool
    assert isinstance(got.access_stats, CombinedAccessStats)


# ---------------------------------------------------------------------------
# inside the port, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tail", ["fused", "split"])
@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("method", METHODS)
def test_group_equals_unsharded_bitwise(groups, unsharded, small_corpus,
                                        method, n_shards, tail):
    """colbert at a cap that cannot bind (512 over 400 docs), its ids up
    to exact-score ties (the group's final merge breaks them by pid)."""
    kw = _batch(small_corpus, 0, 12)
    want = unsharded[tail].search_batch(method, k=15, **kw)
    got = groups[n_shards].search_batch(method, k=15, **kw)
    assert got[0].shape == want[0].shape
    what = f"{method} S={n_shards} {tail}"
    if method == "colbert":
        assert_same_up_to_exact_ties(want, got, what=what)
    else:
        _same_bits(want, got, what)


def test_exact_tie_bar():
    scores = np.array([[3.0, 2.0, 2.0, 1.0]], np.float32)
    assert_same_up_to_exact_ties(([[7, 4, 9, 1]], scores),
                                 ([[7, 9, 4, 1]], scores))
    with pytest.raises(AssertionError,
                       match=r"ids \[4, 1\] at \[1:3\] are not \[4, 9\]"):
        assert_same_up_to_exact_ties(([[7, 4, 9, 1]], scores),
                                     ([[7, 4, 1, 9]], scores))
    with pytest.raises(AssertionError, match="score bits"):
        assert_same_up_to_exact_ties(([[7, 4, 9, 1]], scores),
                                     ([[7, 4, 9, 1]], scores + 1e-7))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_device_stage1_group_equals_unsharded_bitwise(base_dir, unsharded,
                                                      small_corpus, n_shards):
    """Each shard's SPLADE device cache (its plain version on the CPU),
    untruncated postings: the host stage 1's bits."""
    group = _port_group(base_dir / f"port{n_shards}",
                        splade_backend="device")
    caches = group.splade_device_cache()
    assert len(caches) == n_shards
    assert [c.n_docs for c in caches] == list(np.diff(group.offsets))
    kw = _batch(small_corpus, 0, 12)
    for method in ("splade", "rerank", "hybrid"):
        _same_bits(unsharded["fused"].search_batch(method, k=15, **kw),
                   group.search_batch(method, k=15, **kw), method)
    _same_bits(unsharded["fused"].run_splade_batch(kw["term_ids"],
                                                   kw["term_weights"]),
               group.run_splade_batch(kw["term_ids"], kw["term_weights"]),
               "run_splade_batch")


def test_resident_group_equals_unsharded_bitwise(base_dir, unsharded,
                                                 small_corpus):
    """Shards whose pools are resident on the device gather there, in
    shard order (no pooled stage touches a device tensor)."""
    dirs, bounds = load_group(base_dir / "port4")
    shards = [MultiStageRetriever(
        SpladeIndex.load(d / "splade"),
        PLAIDSearcher(ColBERTIndex(d / "colbert"), PlaidParams(**PLAID),
                      device_resident=True, device="cpu"),
        MultiStageParams(**MS), device="cpu") for d in dirs]
    group = ShardedRetriever(shards, bounds)
    for method in ("colbert", "hybrid"):
        plan = group.compile_plan(method)
        assert plan.access_stats is None
        assert not any(s.pooled for s in plan.stages)
        assert {s.kind for s in plan.stages if "gather" in s.name} == {DEVICE}
    kw = _batch(small_corpus, 0, 12)
    for method in METHODS:
        _same_bits(unsharded["fused"].search_batch(method, k=15, **kw),
                   group.search_batch(method, k=15, **kw), method)


def test_single_shard_group_is_the_unsharded_path(base_dir, small_corpus):
    solo = _unsharded(base_dir)
    group = ShardedRetriever([solo], [0, small_corpus["cfg"].n_docs])
    for method in METHODS:
        assert group.compile_plan(method) is solo.compile_plan(method)
    assert group.pipeline_stats is solo.pipeline_stats
    kw = _batch(small_corpus, 0, 6)
    twin = _unsharded(base_dir)
    for method in METHODS:
        _same_bits(twin.search_batch(method, k=10, **kw),
                   group.search_batch(method, k=10, **kw), method)
    q = {key: v[2] for key, v in zip(("q_emb", "term_ids", "term_weights"),
                                     kw.values())}
    _same_bits(twin.search("hybrid", k=10, **q),
               group.search("hybrid", k=10, **q), "search")
    caches = CacheHierarchy(exact_entries=0, stage1_entries=8)
    group.attach_caches(caches)
    assert solo._caches is caches
    assert group.bump_index_generation() == solo.index_generation == 1
    assert group.cache_salts("hybrid") == solo.cache_salts("hybrid")
    assert group.cache_salts("colbert") == solo.cache_salts("colbert")


def test_results_span_shard_boundaries(groups, small_corpus):
    retr = groups[4]
    pids, _ = retr.search_batch("splade", k=20, **_batch(small_corpus, 0,
                                                         12))
    real = pids[pids >= 0]
    assert real.max() < small_corpus["cfg"].n_docs
    owners = np.searchsorted(retr.offsets, real, side="right") - 1
    assert len(np.unique(owners)) >= 2


def test_k_above_the_docs_of_a_shard(base_dir, small_corpus):
    """first_k and k above any shard's 100 docs: the merge fills from
    every shard and pads (-1) only past the corpus."""
    n_docs = small_corpus["cfg"].n_docs
    k = n_docs // 4 + 37
    ms = dict(first_k=n_docs + 50, k=k)
    group = _port_group(base_dir / "port4", **ms)
    ref = _unsharded(base_dir, **ms)
    kw = _batch(small_corpus, 0, 3)
    for method in ("splade", "rerank", "hybrid"):
        got = group.search_batch(method, k=k, **kw)
        _same_bits(ref.search_batch(method, k=k, **kw), got, method)
        assert got[0].shape == (3, k)
    pids, scores = group.run_splade_batch(kw["term_ids"], kw["term_weights"])
    assert pids.shape == (3, n_docs + 50)
    assert (pids[:, n_docs:] == -1).all() and (scores[:, n_docs:] == 0).all()


def test_group_refuses_bad_input(base_dir):
    solo = _unsharded(base_dir)
    with pytest.raises(ValueError, match="empty shard group"):
        ShardedRetriever([], [0])
    with pytest.raises(ValueError, match="need 2 boundaries, got 3"):
        ShardedRetriever([solo], [0, 10, 20])
    other = _unsharded(base_dir, first_k=40)
    with pytest.raises(ValueError, match="share MultiStageParams"):
        ShardedRetriever([solo, other], [0, 200, 400])
    with pytest.raises(ValueError, match="splade backend 'jax'"):
        ShardedRetriever([solo, _unsharded(base_dir)],
                         [0, 200, 400]).set_splade_backend("jax")


@pytest.mark.parametrize("n_shards", SHARDS)
def test_per_shard_devices_place_each_shard(base_dir, groups, small_corpus,
                                            n_shards):
    """``devices`` places shard i on ``devices[i]`` and overrides
    ``device``: with ``device="cuda"`` and no card, a shard that fell back
    to it would raise. The answers are the group's on ``device="cpu"``."""
    dirs, bounds = load_group(base_dir / f"port{n_shards}")
    retr = build_sharded_retriever(
        dirs, bounds, plaid_params=PlaidParams(**PLAID),
        multistage_params=MultiStageParams(**MS),
        devices=["cpu"] * n_shards, device="cuda")
    assert [sh.device.type for sh in retr.shards] == ["cpu"] * n_shards
    assert [sh.searcher.device.type for sh in retr.shards] \
        == ["cpu"] * n_shards
    assert retr.device.type == "cpu"
    kw = _batch(small_corpus, 0, 8)
    for method in METHODS:
        _same_bits(groups[n_shards].search_batch(method, k=10, **kw),
                   retr.search_batch(method, k=10, **kw),
                   f"{method} S={n_shards}")


def test_group_knobs_reach_every_shard(groups):
    retr = groups[2]
    try:
        retr.set_rerank_backend("split")
        assert {sh.rerank_backend for sh in retr.shards} == {"split"}
        assert retr.rerank_backend == "split"
        split_plan = retr.compile_plan("rerank")
        retr.set_rerank_backend("fused")
        fused_plan = retr.compile_plan("rerank")
        # two keys, one split-shaped plan shape
        assert fused_plan is not split_plan
        assert fused_plan.stage_names() == split_plan.stage_names()
        retr.set_splade_backend("device")
        assert {sh.splade_backend for sh in retr.shards} == {"device"}
        assert retr.compile_plan("rerank").stages[0].kind == DEVICE
    finally:
        retr.set_rerank_backend("fused")
        retr.set_splade_backend("host")
    assert retr.compile_plan("rerank").stages[0].kind == HOST


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(corpus, n, methods=METHODS, k=10, lo=0):
    return [Request(qid=lo + i, method=methods[i % len(methods)],
                    q_emb=corpus["q_embs"][lo + i],
                    term_ids=corpus["q_term_ids"][lo + i],
                    term_weights=corpus["q_term_weights"][lo + i], k=k,
                    alpha=None if i % 3 else 0.6)
            for i in range(n)]


@pytest.mark.parametrize("n_shards,workers", [
    (1, "kind"), (2, "single"), (2, "kind"), (4, "single"), (4, "kind")])
def test_engine_depths_and_server_give_the_same_bits(base_dir, groups,
                                                     small_corpus, n_shards,
                                                     workers):
    retr = (groups[n_shards] if n_shards > 1 else ShardedRetriever(
        [_unsharded(base_dir)], [0, small_corpus["cfg"].n_docs]))
    reqs = _requests(small_corpus, 16)
    chunks = [reqs[i:i + 4] for i in range(0, 16, 4)]
    want = [r for c in chunks for r in ServeEngine(retr).process_batch(c)]
    eng = ServeEngine(retr, pipeline_depth=2, pipeline_workers=workers)
    try:
        assert eng.pipelined
        futs = [eng.process_batch_async(c) for c in chunks]
        got = [r for f in futs for r in f.result(timeout=120)]
    finally:
        eng.close()
    srv = RetrievalServer(ServeEngine(retr), n_threads=1, max_batch=4,
                          batch_timeout_ms=5.0)
    futs = [srv.submit(r) for r in reqs]    # queued before start: chunks
    srv.start()
    try:
        served = [f.result(timeout=120) for f in futs]
        assert srv.health()["n_shards"] == n_shards
    finally:
        srv.stop()
    for a, b, c in zip(want, got, served):
        assert a.qid == b.qid == c.qid
        _same_bits((a.pids, a.scores), (b.pids, b.scores), f"qid {a.qid}")
        _same_bits((a.pids, a.scores), (c.pids, c.scores), f"qid {a.qid}")


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_health_reports_the_groups_shards(base_dir, groups, small_corpus,
                                          n_shards):
    retr = (groups[n_shards] if n_shards > 1 else ShardedRetriever(
        [_unsharded(base_dir)], [0, small_corpus["cfg"].n_docs]))
    h = RetrievalServer(ServeEngine(retr)).health()
    assert h["n_shards"] == n_shards
    assert RetrievalServer(ServeEngine(_unsharded(base_dir))).health()[
        "n_shards"] == 1


def test_a_raising_shard_fails_only_its_batch(groups, small_corpus):
    """A shard that raises fails its own batch's requests; colbert, which
    never runs the SPLADE stage 1, serves meanwhile, and the server
    serves the healed path afterwards."""
    retr = groups[2]
    poisoned = retr.shards[1]

    def boom(*a, **k):
        raise RuntimeError("shard 1 down")

    srv = RetrievalServer(ServeEngine(retr, pipeline_depth=2), n_threads=1,
                          max_batch=4, batch_timeout_ms=5.0)
    srv.start()
    try:
        poisoned.run_splade_batch = boom
        bad = [srv.submit(r) for r in
               _requests(small_corpus, 4, methods=("rerank",))]
        for f in bad:
            with pytest.raises(RuntimeError, match="shard 1 down"):
                f.result(timeout=60)
        ok = [srv.submit(r) for r in
              _requests(small_corpus, 4, methods=("colbert",), lo=4)]
        assert all(f.result(timeout=60).pids.shape == (10,) for f in ok)
        del poisoned.run_splade_batch
        healed = [srv.submit(r) for r in
                  _requests(small_corpus, 4, methods=("rerank",), lo=8)]
        assert all(len(f.result(timeout=60).pids) == 10 for f in healed)
        h = srv.health()
        assert h["failed"] == 4 and h["n_shards"] == 2
    finally:
        vars(poisoned).pop("run_splade_batch", None)
        srv.stop()


def _stage1_batches(request_cls, corpus):
    """Three batches for an engine with a stage-1 cache: cold, the same
    terms again at another k (all hits), and half old, half new queries
    (each method group a partial hit, which misses as a whole)."""
    def batch(lo, hi, k):
        return [request_cls(qid=i, method=("rerank", "hybrid")[i % 2],
                            q_emb=corpus["q_embs"][i],
                            term_ids=corpus["q_term_ids"][i],
                            term_weights=corpus["q_term_weights"][i], k=k)
                for i in range(lo, hi)]
    return [batch(0, 6, 10), batch(0, 6, 7), batch(3, 9, 10)]


def _stage1_counts(retr):
    counters = retr.pipeline_stats.snapshot()["counters"]
    return {n: counters.get(n, 0)
            for n in ("cache_stage1_hits", "cache_stage1_misses")}


@pytest.mark.parametrize("n_shards", SHARDS)
def test_stage1_cache_is_all_or_nothing_and_bitwise(base_dir, small_corpus,
                                                    n_shards):
    group = _port_group(base_dir / f"port{n_shards}")
    cached = ServeEngine(group, caches=CacheHierarchy(exact_entries=0,
                                                      stage1_entries=64))
    cold = ServeEngine(_port_group(base_dir / f"port{n_shards}"))
    j_group = _jax_group(base_dir / f"jax{n_shards}")
    j_cached = JEngine(j_group, caches=JCaches(exact_entries=0,
                                               stage1_entries=64))
    for reqs, j_reqs in zip(_stage1_batches(Request, small_corpus),
                            _stage1_batches(JRequest, small_corpus)):
        got = cached.process_batch(reqs)
        for a, b in zip(cold.process_batch(reqs), got):
            _same_bits((a.pids, a.scores), (b.pids, b.scores),
                       f"qid {a.qid}")
        for a, b in zip(j_cached.process_batch(j_reqs), got):
            assert_topk_match(a.scores, a.pids, b.scores, b.pids)
    # batch 1: 6 misses; batch 2: 6 hits; batch 3: its rerank group (4,
    # 6, 8) and hybrid group (3, 5, 7) each hold a new query, so each runs
    # whole, counting its new rows as misses and its cached ones as no hit
    assert _stage1_counts(group) == _stage1_counts(j_group) == {
        "cache_stage1_hits": 6, "cache_stage1_misses": 9}


# ---------------------------------------------------------------------------
# fanout stages alone
# ---------------------------------------------------------------------------

def _fanout_plan(pool, fail_on=None):
    def per_shard(cb, i):
        if fail_on is not None and cb.k == fail_on:
            raise RuntimeError(f"shard {i} of batch {cb.k} failed")
        return {"shard": i, "k": cb.k, "sq": i * i + cb.k}

    def merge(cb):
        return cb.evolve(pids=np.array([[s["sq"] for s in cb.shard_states]]))

    return StagePlan(method="m", pool=pool, stages=(
        Stage("host_gather:x", HOST, per_shard, fanout=3, pooled=True),
        Stage("device_score:x", DEVICE, per_shard, fanout=3),
        Stage("merge_topk", HOST, merge)))


def test_pooled_and_sequential_fanout_agree(groups):
    stats = {m: PipelineStats() for m in ("pooled", "sequential")}
    outs = {}
    for mode, pool in (("pooled", groups[2]._pool), ("sequential", None)):
        cb = _fanout_plan(pool).run(CandidateBatch(method="m", k=5),
                                    stats=stats[mode])
        outs[mode] = cb
        assert cb.shard_states == tuple(
            {"shard": i, "k": 5, "sq": i * i + 5} for i in range(3))
        rec = stats[mode].snapshot()["stages"]
        assert rec["host_gather:x"]["device_dispatches"] == 0
        assert rec["device_score:x"]["device_dispatches"] == 3
        assert rec["merge_topk"]["device_dispatches"] == 0
    np.testing.assert_array_equal(outs["pooled"].pids,
                                  outs["sequential"].pids)


def test_a_failing_fanout_fails_its_own_batch_only(groups):
    px = PipelineExecutor(_fanout_plan(groups[2]._pool, fail_on=7), depth=2,
                          workers="kind", device="cpu")
    try:
        futs = [px.submit(CandidateBatch(method="m", k=k)) for k in (6, 7, 8)]
        assert futs[0].result(timeout=30).pids.tolist() == [[6, 7, 10]]
        with pytest.raises(RuntimeError, match="of batch 7 failed"):
            futs[1].result(timeout=30)
        assert futs[2].result(timeout=30).pids.tolist() == [[8, 9, 12]]
    finally:
        px.stop()
