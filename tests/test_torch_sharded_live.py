"""The live index of the port's in-process shard groups, with
``device="cpu"``, at the JAX package's live-test size (240 docs, 8 held
out and upserted, tombstones ``DELETED`` and one delta pid: at 4 shards
the third shard owns no tombstone; ``candidate_cap=4096`` binds on no
query).

Bars: at 1, 2 and 4 shards, for the four methods, dirty and after
``compact_live()``, the group equals the port's pinned rebuild of the
surviving corpus bit for bit (pids through ``map_global_to_ref``) and
the JAX package's group fed the same trace under the parity bar (ids up
to tie groups, scores ``allclose(rtol=1e-5, atol=1e-5)``); a clean live
group equals the frozen one bit for bit; a delete reaches its owning
shard's view alone; a compaction rewrites the last shard alone; readers
during a compaction see one answer; a cached answer holding a deleted
doc is not served. The trace helpers are ``test_torch_live``'s.

Every wait is bounded by ``TIMEOUT`` and every thread is joined.
"""

import pathlib
import threading

import numpy as np
import pytest

from repro.core.multistage import MultiStageParams as JParams
from repro.core.plaid import PlaidParams as JPlaidParams
from repro.core.sharded import build_sharded_retriever as j_build_group
from repro.index import live as jlive
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.sharding import load_group as j_load_group
from repro.index.sharding import split_index_tree as j_split
from repro.index.splade_index import SpladeIndex as JSplade
from repro_torch.core.multistage import MultiStageParams, MultiStageRetriever
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.core.sharded import ShardedRetriever, build_sharded_retriever
from repro_torch.index import live
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.live import map_global_to_ref
from repro_torch.index.sharding import load_group, split_index_tree
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.pipeline import HOST
from repro_torch.testing import REF_MARGIN, assert_topk_match
from test_torch_live import (DELETED, HOLD, K, METHODS, MS, PLAID, STATES,
                             TIMEOUT, _answers, _base_n, _copy, _mutate,
                             _port, _queries)
from test_torch_live import base_tree, corpus, rebuild  # noqa: F401 fixtures

SHARDS = (1, 2, 4)


def _port_group(base, n_shards, root=None, **ms):
    """The port's group of ``n_shards`` split from ``base`` into a group
    directory of its own under ``root`` (``base`` by default). A
    compaction writes its generation beside the last shard's index."""
    dirs, bounds = load_group(split_index_tree(
        base, n_shards, group_dir=(root or base) / f"port{n_shards}"))
    return build_sharded_retriever(
        dirs, bounds, plaid_params=PlaidParams(**PLAID),
        multistage_params=MultiStageParams(**dict(MS, **ms)), device="cpu")


def _jax_group(base, n_shards):
    dirs, bounds = j_load_group(j_split(base, n_shards,
                                        group_dir=base / f"jax{n_shards}"))
    return j_build_group(dirs, bounds, plaid_params=JPlaidParams(**PLAID),
                         multistage_params=JParams(**MS))


def _views(group):
    """Each shard's base tombstones, shard-local."""
    return [sh.live.base_exclude.tolist() for sh in group.shards]


@pytest.fixture(scope="module")
def traces(tmp_path_factory, corpus, base_tree):
    """The canonical trace on the port's group and the JAX package's at
    1, 2 and 4 shards, each on its own copy of the base tree: the
    answers (the JAX package's ``REF_MARGIN`` places deeper) dirty and
    after a compaction, a second compaction's reply, and the group's
    shards, views and boundaries around the compaction."""
    root = tmp_path_factory.mktemp("sharded_live")
    out = {}
    for n_shards in SHARDS:
        for name, make, k in (("port", _port_group, K),
                              ("jax", _jax_group, K + REF_MARGIN)):
            g = make(_copy(base_tree, root / f"{name}{n_shards}"), n_shards)
            g.enable_live()
            _mutate(g, corpus)
            t = {"dirty": _answers(g, corpus, k), "views": _views(g),
                 "shards": list(g.shards), "offsets": g.offsets.copy(),
                 "view_objects": [sh.live for sh in g.shards]}
            t["reply"] = g.compact_live()
            t["compacted"] = _answers(g, corpus, k)
            t["again"] = g.compact_live()
            t.update(group=g, views_after=_views(g))
            out[name, n_shards] = t
    return out


# ---------------------------------------------------------------------------
# the canonical trace: the rebuild, the JAX package's group
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("method", METHODS)
def test_group_equals_the_pinned_rebuild_bitwise(traces, rebuild, method,
                                                 state, n_shards):
    """colbert too: its cap cannot bind and no two survivors tie."""
    survivors, expected = rebuild
    got_p, got_s = traces["port", n_shards][state][method]
    want_p, want_s = expected[method]
    what = f"{method} {state} S={n_shards}"
    np.testing.assert_array_equal(map_global_to_ref(got_p, survivors),
                                  want_p, err_msg=f"{what} pids")
    np.testing.assert_array_equal(got_s.view(np.uint32),
                                  want_s.view(np.uint32),
                                  err_msg=f"{what} score bits")


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("state", STATES)
@pytest.mark.parametrize("method", METHODS)
def test_group_matches_the_jax_live_group(traces, method, state, n_shards):
    want_p, want_s = traces["jax", n_shards][state][method]
    got_p, got_s = traces["port", n_shards][state][method]
    assert got_p.shape == (len(want_p), K)
    assert_topk_match(want_s, want_p, got_s, got_p,
                      what=f"{method} {state} S={n_shards}")


@pytest.mark.parametrize("n_shards", SHARDS)
def test_live_stats_and_views_equal_the_jax_groups(traces, corpus,
                                                   n_shards):
    """``live_upsert`` and ``live_stats`` are the unsharded retriever's:
    pids appended past the last boundary (checked by the trace), the
    counters and generation the JAX group's. Each shard's view holds the
    JAX group's tombstones, before and after the compaction."""
    ours, theirs = traces["port", n_shards], traces["jax", n_shards]
    assert ours["group"].live_stats() == theirs["group"].live_stats()
    assert ours["group"].live_stats()["tombstones"] == len(DELETED) + 1
    assert ours["views"] == theirs["views"]
    assert ours["views_after"] == theirs["views_after"]
    assert ours["group"].n_docs == corpus["cfg"].n_docs


def test_a_delete_reaches_only_its_owning_shard(traces, corpus):
    """At 4 shards over 232 base docs (boundaries 0, 58, 116, 174, 232):
    shard 2 owns no tombstone and the delta pid reaches no view; after
    the compaction the last shard's range holds the delta, and its view
    the deleted delta doc."""
    t = traces["port", 4]
    assert t["offsets"].tolist() == [0, 58, 116, 174, 232]
    assert t["views"] == [[5, 17], [100 - 58], [], [201 - 174]]
    assert t["views_after"] == [[5, 17], [42], [],
                                [201 - 174, _base_n(corpus) + 2 - 174]]


def test_a_delete_syncs_the_view_under_the_groups_generation(base_tree,
                                                             tmp_path):
    g = _port_group(_copy(base_tree, tmp_path / "base"), 2)
    g.enable_live()
    assert g.live_delete(150)                   # shard 1: [116, 232)
    assert not g.live_delete(150) and not g.live_delete(10 ** 6)
    assert _views(g) == [[], [150 - 116]]
    assert g.shards[1].live.generation == 0     # synced before the bump
    assert g.index_generation == 1
    assert [sh.index_generation for sh in g.shards] == [1, 1]


def test_concurrent_deletes_keep_every_view_whole(base_tree, tmp_path,
                                                  monkeypatch):
    """More deleting threads than cores, the switch interval cut short
    and each view's write delayed after its tombstones were read: a
    view only grows (a write from a stale tombstone set would drop a
    concurrent delete), and every shard's view ends holding every
    tombstone in its range."""
    import sys
    import time
    update, shrunk = live.LiveView.update, []

    def late_update(view, tombstones, *a, **kw):
        time.sleep(0.0005)
        if not set(view.tombstones.tolist()) <= set(tombstones.tolist()):
            shrunk.append((view.tombstones.size, tombstones.size))
        update(view, tombstones, *a, **kw)

    monkeypatch.setattr(live.LiveView, "update", late_update)
    g = _port_group(base_tree, 2, root=tmp_path)
    g.enable_live()
    pids = np.random.default_rng(7).permutation(g.n_docs)[:96]
    errors, start = [], threading.Barrier(8)

    def deleter(part):
        try:
            start.wait(timeout=TIMEOUT)
            for p in part:
                assert g.live_delete(int(p))
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=deleter, args=(pids[i::8],))
               for i in range(8)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert not shrunk, f"views written from stale sets: {shrunk[:4]}"
    assert g.live_stats()["tombstones"] == len(pids)
    assert g.index_generation == len(pids)
    for j, sh in enumerate(g.shards):
        lo, hi = g.offsets[j], g.offsets[j + 1]
        np.testing.assert_array_equal(
            sh.live.tombstones, np.sort(pids[(pids >= lo) & (pids < hi)] - lo))


@pytest.mark.parametrize("lo,hi", [(0, 58), (58, 116), (116, 174),
                                   (174, 240), (0, 240)])
def test_local_tombstones_equal_the_jax_function(corpus, base_tree, lo, hi):
    ours = _port(base_tree).enable_live()
    theirs = jlive.LiveIndexState(JIndex(base_tree / "colbert"),
                                  JSplade.load(base_tree / "splade"))
    n = _base_n(corpus)
    for state in (ours, theirs):
        for j in range(n, corpus["cfg"].n_docs):
            state.upsert(corpus["doc_embs"][j], corpus["doc_term_ids"][j],
                         corpus["doc_term_weights"][j],
                         corpus["doc_lens"][j])
        for g in (*DELETED, n + 2, 57, 58):
            assert state.delete(g)
    got, want = ours.local_tombstones(lo, hi), theirs.local_tombstones(lo, hi)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# compaction
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
def test_compaction_rewrites_only_the_last_shard(traces, n_shards):
    t = traces["port", n_shards]
    g = t["group"]
    assert t["reply"]["compacted"] == HOLD
    assert t["again"] is None                    # nothing left to merge
    assert set(t["reply"]["seconds"]) == {"colbert_dir", "splade_dir",
                                          "load", "gate_wait", "swap",
                                          "total"}
    np.testing.assert_array_equal(g.offsets[:-1], t["offsets"][:-1])
    assert g.offsets[-1] == t["offsets"][-1] + HOLD == g.n_docs
    assert g.live.n_delta == 0 and g.live.base_n == g.n_docs
    assert all(a is b for a, b in zip(g.shards[:-1], t["shards"][:-1]))
    last = g.shards[-1]
    assert last.searcher.index.n_docs == last.splade.n_docs == \
        g.offsets[-1] - g.offsets[-2]
    if n_shards == 1:
        # the shard compacted itself: the same retriever, the same state
        assert last is t["shards"][0] and last.live is g.live
    else:
        assert last is not t["shards"][-1]
        assert all(sh.live is v for sh, v in zip(g.shards[:-1],
                                                 t["view_objects"][:-1]))
        # beside the last shard's index, in that shard's directory
        col = pathlib.Path(t["reply"]["colbert_dir"])
        assert col.parent.name == str(n_shards - 1)
        assert col.name == f"colbert.g{g.index_generation}"
    assert {sh.index_generation for sh in g.shards} == {g.index_generation}


def test_readers_during_a_group_compaction(corpus, base_tree, tmp_path):
    """Three reader threads query a 4-shard group while ``compact_live``
    builds the last shard and swaps it in: every answer equals the one
    before the compaction."""
    g = _port_group(_copy(base_tree, tmp_path / "base"), 4)
    g.enable_live()
    _mutate(g, corpus)
    q = _queries(corpus)
    want_p, want_s = g.search_batch("hybrid", **q, k=K)
    errors, stop, started = [], threading.Event(), threading.Barrier(4)
    answered = [0, 0, 0]

    def reader(i):
        started.wait(timeout=TIMEOUT)
        while not stop.is_set():
            try:
                p, s = g.search_batch("hybrid", **q, k=K)
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
        assert g.compact_live()["compacted"] == HOLD
        p, s = g.search_batch("hybrid", **q, k=K)
        np.testing.assert_array_equal(p, want_p)
        np.testing.assert_array_equal(s, want_s)
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]
    assert all(answered)


# ---------------------------------------------------------------------------
# clean state, enable_live, caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("method", METHODS)
def test_clean_live_group_equals_frozen(corpus, base_tree, tmp_path, method,
                                        n_shards):
    g = _port_group(base_tree, n_shards, root=tmp_path)
    q = _queries(corpus)
    before = g.search_batch(method, **q, k=K)
    g.enable_live()
    assert not g.live.dirty and g.index_generation == 0
    after = g.search_batch(method, **q, k=K)
    np.testing.assert_array_equal(before[0], after[0])
    np.testing.assert_array_equal(before[1].view(np.uint32),
                                  after[1].view(np.uint32))


@pytest.mark.parametrize("n_shards", SHARDS)
def test_enable_live_is_idempotent_and_on_the_groups_device(base_tree,
                                                            tmp_path,
                                                            n_shards):
    g = _port_group(base_tree, n_shards, root=tmp_path)
    state = g.enable_live()
    assert g.enable_live() is state and g.live is state
    assert state.device == g.device and state.base_n == g.n_docs
    if n_shards == 1:
        assert g.shards[0].live is state
    else:
        assert all(type(sh.live) is live.LiveView and not sh.live.dirty
                   for sh in g.shards)
    assert g.live_stats() == {
        "upserts": 0, "deletes": 0, "compactions": 0, "docs_compacted": 0,
        "delta_docs": 0, "delta_tokens": 0, "tombstones": 0,
        "generation": 0}


def test_enable_live_refuses_a_resident_group(base_tree, tmp_path):
    dirs, bounds = load_group(split_index_tree(
        _copy(base_tree, tmp_path / "base"), 2))
    shards = [MultiStageRetriever(
        SpladeIndex.load(d / "splade"),
        PLAIDSearcher(ColBERTIndex(d / "colbert"), PlaidParams(**PLAID),
                      device_resident=True, device="cpu"),
        MultiStageParams(**MS), device="cpu") for d in dirs]
    with pytest.raises(ValueError) as ours:
        ShardedRetriever(shards, bounds).enable_live()
    with pytest.raises(ValueError) as unsharded:
        _port(base_tree, resident=True).enable_live()
    assert str(ours.value) == str(unsharded.value)
    assert all(sh.live is None for sh in shards)


@pytest.mark.parametrize("n_shards", (2, 4))
def test_deleted_doc_cached_answer_is_not_served(corpus, base_tree,
                                                 tmp_path, n_shards):
    """A group's mutation bumps the generation its caches are scoped to:
    an answer cached before a delete is not served after it."""
    g = _port_group(_copy(base_tree, tmp_path / "base"), n_shards)
    g.enable_live()
    engine = ServeEngine(g, caches=CacheHierarchy(exact_entries=64,
                                                  stage1_entries=64))
    assert not engine.pipelined                  # a live group: depth 1

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


# ---------------------------------------------------------------------------
# stage 1 of a dirty group, the plans
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dirty_pair(tmp_path_factory, corpus, base_tree):
    """The canonical trace, not compacted, on an unsharded port retriever
    and on a 2-shard group with the device stage 1."""
    root = tmp_path_factory.mktemp("sharded_live_dirty")
    one = _port(_copy(base_tree, root / "one"))
    g = _port_group(_copy(base_tree, root / "two"), 2,
                    splade_backend="device")
    for r in (one, g):
        r.enable_live()
        _mutate(r, corpus)
    return one, g


@pytest.mark.parametrize("k", [K, MS["first_k"]])
def test_group_run_splade_batch_merges_the_delta(corpus, dirty_pair, k):
    """The group's stage 1 on a dirty index (the shards on the host with
    their tombstones, the delta's rows merged at the coordinator) equals
    the unsharded live retriever's bit for bit, with the device backend
    set."""
    one, g = dirty_pair
    q = _queries(corpus)
    want = one.run_splade_batch(q["term_ids"], q["term_weights"], k)
    got = g.run_splade_batch(q["term_ids"], q["term_weights"], k)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))
    assert (got[0] >= g.live.base_n).any()       # delta rows merged
    assert not np.isin(got[0], sorted(set(DELETED))).any()


def test_stage1_follows_the_routing_of_its_batch(corpus, base_tree,
                                                 tmp_path):
    """A frozen plan's stage 1 (``live=False``) keeps every shard's
    frozen scorer after a delete lands: no view is read, no delta row
    merged."""
    g = _port_group(_copy(base_tree, tmp_path / "base"), 2)
    g.enable_live()
    q = _queries(corpus)
    args = (q["term_ids"], q["term_weights"], K)
    frozen = g.run_splade_batch(*args)
    victim = int(frozen[0][0, 0])
    assert g.live_delete(victim)
    n = _base_n(corpus)
    g.live_upsert(corpus["doc_embs"][n], corpus["doc_term_ids"][n],
                  corpus["doc_term_weights"][n], corpus["doc_lens"][n])
    pinned = g.run_splade_batch(*args, live=False)
    np.testing.assert_array_equal(pinned[0], frozen[0])
    np.testing.assert_array_equal(pinned[1], frozen[1])
    dirty = g.run_splade_batch(*args)
    assert victim not in dirty[0]
    np.testing.assert_array_equal(g.run_splade_batch(*args, live=True)[0],
                                  dirty[0])


@pytest.mark.parametrize("method", METHODS)
def test_dirty_group_plans(corpus, dirty_pair, method):
    """A dirty group's plan: stage 1 on the host with no declared device
    launch whatever the backend; the delta's device stages beside the
    frozen plan's, which keeps its shape. Its answers equal the
    unsharded live retriever's."""
    one, g = dirty_pair
    frozen = g.compile_plan(method).stage_names()
    plan = g.compile_plan(method, live=True)
    extra = {"splade": (), "colbert": ("device_score:approx:delta",
                                       "device_score:exact:delta")
             }.get(method, ("device_score:delta",))
    assert sorted(plan.stage_names()) == sorted(frozen + extra)
    if method != "colbert":
        s1 = plan.stages[0]
        assert (s1.name, s1.kind, s1.device_dispatch_count) == \
            ("splade_stage1", HOST, 0)
        assert g.compile_plan(method).stages[0].kind != HOST
    q = _queries(corpus)
    want = one.search_batch(method, **q, k=K)
    got = g.search_batch(method, **q, k=K)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32),
                                  want[1].view(np.uint32))


def test_a_shard_view_stage1_returns_its_base_rows(corpus, base_tree):
    """A shard retriever holding a ``LiveView`` (tombstones, no delta)
    scores a dirty stage 1 as its base rows with its tombstones
    excluded."""
    retr = _port(base_tree)
    q = _queries(corpus)
    frozen = retr.run_splade_batch(q["term_ids"], q["term_weights"], K)
    gone = [int(frozen[0][0, 0]), int(frozen[0][1, 0])]
    retr.live = live.LiveView(gone)
    got = retr.run_splade_batch(q["term_ids"], q["term_weights"], K)
    want = retr.splade.score_batch_host(q["term_ids"], q["term_weights"], K,
                                        exclude=np.sort(gone))
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert not np.isin(got[0], gone).any()
