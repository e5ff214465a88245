"""Scatter-gather serving over a sharded SPLADE/PLAID/mmap index.

The corpus is partitioned into ``n_shards`` contiguous document ranges
(``repro_torch.index.sharding``); each shard owns its SPLADE postings
slice, PLAID IVF slice and mmap ``PagedStore`` segment, wrapped in an
ordinary :class:`MultiStageRetriever`. :class:`ShardedRetriever`
presents the same retriever interface over the whole group by compiling
*sharded* stage plans:

* per-shard work runs as ``fanout`` stages (``Stage.fanout``): the stage
  function runs once per shard. The mmap gathers (host stages) run
  concurrently on the group's thread pool, so independent segments fault
  independent page streams; device stages run the shards in order on the
  executor's thread and stream. The SPLADE stage 1 is a group stage on
  the device backend: every shard's top-k is launched before any is
  copied back.
* shard-local candidates are remapped to **global** doc ids
  (``local + shard_offset``) the moment they leave a shard, and the
  ``merge_topk`` stages combine the shards' lists into the global
  ranking.

Parity contract: a shard scores each of its documents exactly as the
single index does (shared quantum and geometry, and per-candidate
kernels whose bits do not depend on the candidate width), and every
top-k selection — per shard and at the merges — orders by (score desc,
pid asc). Top-k selection distributes over a partition under that total
order, so a group of 2 or 4 shards returns the single index's answers
bit for bit, for all four methods. Three documented deviations: a
per-shard ``candidate_cap`` truncates later than the global one (a
colbert group keeps more candidates where the cap binds, never fewer);
an exact-score tie at colbert's final merge resolves by global pid, not
by approximate rank; and a ``splade_max_df`` truncates each shard's
postings on its own, so the bit-for-bit bar holds with untruncated
postings (``splade_max_df=None``).

A live group (:meth:`ShardedRetriever.enable_live`) keeps one delta
segment and the tombstone set at the coordinator; each shard holds a
``LiveView`` of its own tombstones, which its host stage 1 excludes
before its top-k. A dirty group's plans merge the delta's SPLADE rows
into the shards', drop tombstoned colbert candidates before the
``ndocs`` cut and score the delta's candidates at the coordinator in
device stages of their own. A compaction merges the delta into the
last shard alone. Each answer equals a rebuild of the surviving corpus
bit for bit, as the unsharded live index's does.
"""

from __future__ import annotations

import os
import pathlib
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.common import HostCopy
from repro_torch.core import hybrid as hybrid_mod
from repro_torch.core.multistage import (MultiStageRetriever,
                                         check_splade_backend,
                                         compaction_reply, write_compacted)
from repro_torch.core.plaid import (PLAIDSearcher, PlaidParams,
                                    pad_query_batch_host,
                                    stage1_centroid_probe_batch,
                                    stage2_candidates_batch,
                                    stage3_approx_score_batch, topk_host)
from repro_torch.index import live as live_mod
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_device import SpladeDeviceCache
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.context import freeze
from repro_torch.serving.pipeline import (DEVICE, HOST, PipelineStats, Stage,
                                          StagePlan)

def merge_topk(pids: np.ndarray, scores: np.ndarray, k: int,
               pad_score: float = -np.inf):
    """Merge concatenated top-k lists of disjoint partitions into the
    top-k of their union.

    ``pids``/``scores``: (B, S·K) with -1 marking padding. Selection
    orders by (score desc, pid asc) — the same total order every input
    list was built with, so the merged prefix equals the single-index
    top-k even through score ties. Returns ((B, k) int64 pids -1-padded,
    (B, k) f32 scores ``pad_score``-padded)."""
    key = np.where(pids >= 0, scores, -np.inf).astype(np.float32)
    # lexsort: the last key is primary → score desc, then pid asc;
    # padding (-inf) sorts to the back whatever its pid
    order = np.lexsort((np.where(pids >= 0, pids, np.iinfo(np.int64).max),
                        -key.astype(np.float64)), axis=1)[:, :k]
    top = np.take_along_axis(key, order, axis=1)
    out_pids = np.where(top > -np.inf,
                        np.take_along_axis(pids, order, axis=1), -1)
    out_scores = np.where(top > -np.inf, top, pad_score).astype(np.float32)
    w = order.shape[1]
    if w < k:
        out_pids = np.pad(out_pids, ((0, 0), (0, k - w)),
                          constant_values=-1)
        out_scores = np.pad(out_scores, ((0, 0), (0, k - w)),
                            constant_values=np.float32(pad_score))
    return out_pids.astype(np.int64), out_scores


def compact_owned(gpids: np.ndarray, lo: int, hi: int):
    """Compact one shard's slice of a global candidate matrix.

    ``gpids``: (B, C) global pids (−1 pad). Returns (cols, local), both
    (B, W) with W the densest row's count of candidates in [lo, hi) (at
    least 1): ``local`` holds the shard-local pids of the candidates
    this shard owns (−1 pad) and ``cols`` the global column each came
    from, so that scores computed on the narrow slice scatter back into
    the global matrix (:func:`scatter_scores`). A shard's gather and
    scoring then cost O(owned) ≈ C/S, not O(C)."""
    owned = (gpids >= lo) & (gpids < hi)
    w = max(int(owned.sum(axis=1).max()) if owned.size else 0, 1)
    # a stable sort on ~owned moves the owned columns to the front in
    # their global order
    order = np.argsort(~owned, axis=1, kind="stable")[:, :w]
    ow = np.take_along_axis(owned, order, axis=1)
    cols = np.where(ow, order, -1)
    local = np.where(ow, np.take_along_axis(gpids, order, axis=1) - lo, -1)
    return cols, local


def scatter_scores(out: np.ndarray, cols: np.ndarray, scores: np.ndarray):
    """Scatter one shard's (B, W) scores back into the (B, C) global
    matrix at the columns ``compact_owned`` recorded (−1 skipped)."""
    m = cols >= 0
    rows = np.broadcast_to(np.arange(out.shape[0])[:, None], cols.shape)[m]
    out[rows, cols[m]] = scores[m]


# ---------------------------------------------------------------------------
# the merge and fuse stage bodies of the sharded plans
# ---------------------------------------------------------------------------

def _concat_shard_topk(shard_states):
    """Concatenate the shards' stage-1 lists (already global pids)
    along the candidate axis."""
    pids = np.concatenate([s["pids"] for s in shard_states], axis=1)
    scores = np.concatenate([s["scores"] for s in shard_states], axis=1)
    return pids, scores


def _append_splade_delta(term_ids, term_weights, pids, scores,
                         first_k: int, live):
    """Widen the shards' concatenated stage-1 rows with the live delta's
    top-k (global pids ≥ ``live.base_n``). Tombstoned base docs never
    reach here (each shard excluded its own before its top-k) and the
    delta's tombstoned docs are excluded inside ``splade_delta_topk``,
    so the merge sees surviving documents only."""
    if live is None or not live.n_delta:
        return pids, scores
    d_pids, d_scores = live.splade_delta_topk(list(term_ids),
                                              list(term_weights), first_k)
    return (np.concatenate([pids, d_pids], axis=1),
            np.concatenate([scores, d_scores], axis=1))


def _merged_stage1(cb, first_k: int, live):
    """The shards' stage-1 rows and the delta's merged to first_k."""
    pids, scores = _append_splade_delta(
        cb.term_ids, cb.term_weights, *_concat_shard_topk(cb.shard_states),
        first_k, live)
    return merge_topk(pids, scores, first_k, pad_score=0.0)


def fuse_splade_state(cb, first_k: int, live=None):
    """Terminal fuse of the splade method: merge the shards' stage-1
    lists (and a dirty group's delta rows) and cut to the request's k.
    The ``first_k``-wide merged rows stay in the state, so that the
    stage-1 cache can store them (a splade answer warms the entry a
    later rerank or hybrid request reads)."""
    pids_b, s_scores = _merged_stage1(cb, first_k, live)
    return cb.evolve(pids=pids_b[:, :cb.k], scores=s_scores[:, :cb.k]
                     ).with_state(pids_b=pids_b, s_scores=s_scores)


def stage1_state_from_rows(cb, pids_b, s_scores):
    """The state :func:`merge_stage1_state` makes, from merged rows (a
    stage-1 cache hit's too): the rows and the padded query batch the
    gather and scoring stages read."""
    q, q_valid = pad_query_batch_host(cb.q_embs)
    return cb.with_state(pids_b=pids_b, s_scores=s_scores, q=q,
                         q_valid=q_valid)


def merge_stage1_state(cb, first_k: int, live=None):
    """(B, first_k) global candidates — the single index's
    ``run_splade_batch`` rows, bit for bit, a dirty group's delta rows
    merged in — and the padded query batch."""
    return stage1_state_from_rows(cb, *_merged_stage1(cb, first_k, live))


def fuse_scatter_rerank(cb, method: str, normalizer: str, device):
    """Terminal rerank/hybrid fuse: wait for each shard's narrow score
    slice (its copy to the host behind an event), scatter it back into
    the global candidate columns (-inf where no candidate is), fill the
    columns of a dirty group's delta candidates with their scores
    (:func:`score_delta_state`), α-fuse for hybrid and take the (score
    desc, candidate index asc) top-k.

    Hybrid's normaliser needs statistics over a query's whole candidate
    list, so it runs after the scatter, on ``device`` (the current
    stream: the executor's) over the (B, first_k) matrix the unsharded
    tail normalises: the same operations on the same values."""
    st = cb.state
    pids_b = st["pids_b"]
    final = np.full(pids_b.shape, -np.inf, np.float32)
    for s in cb.shard_states:
        (c,) = s["c"].wait()                # this shard's event only
        scatter_scores(final, s["cols"], c)
    if "delta" in st:
        # the delta's candidates, owned by no shard
        (d,) = st["delta"].wait()
        final = np.where(st["delta_mask"], d, final)
    if method == "hybrid":
        s_scores, c_scores, mask = (
            torch.as_tensor(a, device=device)
            for a in (st["s_scores"], final, pids_b >= 0))
        fused = hybrid_mod.hybrid_scores(
            s_scores, c_scores, mask,
            alpha=torch.as_tensor(cb.alphas, device=device),
            normalizer=normalizer)
        (final,) = HostCopy(fused).wait()
    pids, scores = topk_host(final, pids_b, cb.k)
    return cb.evolve(pids=pids, scores=scores)


def merge_approx_state(cb, offsets, ndocs: int, live=None):
    """Global PLAID survivor selection: remap the shards' candidates to
    global pids, merge their approximate scores and make the ``ndocs``
    cut over the whole group (a cut per shard would not be the single
    index's). A dirty group's tombstoned base candidates drop out before
    the cut (pid -1, -inf: what a padded slot is) and the delta's
    candidates join with the approximate scores their device stage gave
    (``d_cand``, ``d_approx``)."""
    gpids = np.concatenate(
        [np.where(s["cand_np"] >= 0, s["cand_np"] + offsets[i], -1)
         for i, s in enumerate(cb.shard_states)], axis=1)
    ascore = np.concatenate([s["approx_np"] for s in cb.shard_states],
                            axis=1)
    if live is not None:
        drop = live.is_tombstoned(gpids) & (gpids >= 0)
        gpids = np.concatenate([np.where(drop, -1, gpids),
                                cb.state["d_cand"]], axis=1)
        ascore = np.concatenate([np.where(drop, -np.inf, ascore),
                                 cb.state["d_approx"]], axis=1)
    final_g, _ = merge_topk(gpids, ascore, ndocs)
    return cb.with_state(final_g=final_g)


def fuse_colbert_state(cb):
    """Terminal PLAID fuse: every base survivor is owned by exactly one
    shard; scatter each shard's narrow exact scores back into the
    survivor matrix, fill a dirty group's delta survivors with theirs
    (:func:`score_delta_state`) and merge to the request's k."""
    st = cb.state
    g = st["final_g"]
    ex = np.full(g.shape, -np.inf, np.float32)
    for s in cb.shard_states:
        scatter_scores(ex, s["cols"], s["exact"])
    if "delta_scores" in st:
        ex = np.where(st["delta_mask"], st["delta_scores"], ex)
    pids, scores = merge_topk(g, ex, cb.k)
    return cb.evolve(pids=pids, scores=scores)


def score_delta_state(cb, live, pids_key: str, wait: bool):
    """Device stage body of a dirty group: the exact scores of the
    delta's candidates in ``cb.state[pids_key]``, which no shard owns,
    by one decompress_maxsim launch at the coordinator (the unsharded
    live path's launch on the same (B, C) matrix). Their copy to the
    host is enqueued behind an event (``delta``) or, with ``wait``, for
    a host stage next, waited for (``delta_scores``). A batch without
    delta candidates launches nothing."""
    pids = cb.state[pids_key]
    mask = pids >= live.base_n
    if not mask.any():
        return cb
    q, q_valid = (torch.as_tensor(a, device=live.device)
                  for a in (cb.state["q"], cb.state["q_valid"]))
    copy = HostCopy(live.exact_scores(q, q_valid, np.where(mask, pids, -1)))
    if wait:
        (scores,) = copy.wait()
        return cb.with_state(delta_scores=scores, delta_mask=mask)
    return cb.with_state(delta=copy, delta_mask=mask)


class CombinedAccessStats:
    """``AccessStats`` view over a shard group: ``snapshot`` sums the
    segments' counters, so sharded plans report pages and tokens as one
    store would."""

    def __init__(self, parts: Sequence):
        self.parts = list(parts)

    def snapshot(self) -> dict:
        out: dict = {}
        for part in self.parts:
            for key, val in part.snapshot().items():
                out[key] = out.get(key, 0) + val
        return out

    def reset(self):
        for part in self.parts:
            part.reset()


# ---------------------------------------------------------------------------
# the per-shard stage bodies: one shard's retriever and the stage's
# inputs in, what the fanout stage keeps in the shard's state out. The
# in-process plans and a shard worker process
# (``repro_torch.serving.worker``) call the same functions on the same
# inputs, so a worker's reply is the in-process stage's, bit for bit.
# ---------------------------------------------------------------------------

def shard_gather(shard: MultiStageRetriever, sel) -> dict:
    """A shard's residual gather of its own candidates ``sel`` (B, W)
    shard-local pids, -1 pad (a host matrix; a tensor on the device for a
    resident pool) → {sel, g_codes, g_packed, g_valid}."""
    codes, packed, valid = shard.searcher.gather_tokens_batch(sel)
    return {"sel": sel, "g_codes": codes, "g_packed": packed,
            "g_valid": valid}


def shard_exact_scores(shard: MultiStageRetriever, q, q_valid,
                       s: dict) -> torch.Tensor:
    """A shard's exact scores of its gathered candidates (``s``, from
    :func:`shard_gather`) for the batch's queries ``q`` (B, Lq, d) and
    ``q_valid`` (B, Lq): one decompress_maxsim launch on the shard's
    device, -inf where the slot holds no candidate. Returns the device
    tensor as soon as the kernel is launched."""
    searcher = shard.searcher
    q, q_valid, codes, packed, valid, mask = searcher.to_device(
        q, q_valid, s["g_codes"], s["g_packed"], s["g_valid"],
        s["sel"] >= 0)
    return searcher.exact_score_gathered(q, q_valid, codes, packed, valid,
                                         mask)


def shard_candidates(shard: MultiStageRetriever, cids) -> dict:
    """PLAID stage 2 on a shard's IVF slice for the group's probe
    ``cids`` (B, Lq, nprobe), cut to the densest row's count of real
    candidates (at least 1; stage 2 puts the -1 fill at the back), so
    that the codes gather and the approximate stage run at the shard's
    width → {cand (device), cand_np (host)}, both (B, W) shard-local."""
    sr = shard.searcher
    (cids,) = sr.to_device(cids)
    cand = stage2_candidates_batch(sr.ivf_padded, cids,
                                   sr.params.candidate_cap)
    cand_np = cand.cpu().numpy()
    w = max(int((cand_np >= 0).sum(axis=1).max()), 1)
    return {"cand": cand[:, :w], "cand_np": cand_np[:, :w]}


def shard_gather_codes(shard: MultiStageRetriever, s: dict) -> dict:
    """The codes-only gather of a shard's candidates (``s``, from
    :func:`shard_candidates`): ``s`` with codes and c_valid added."""
    sr = shard.searcher
    codes, valid = sr.gather_codes_batch(
        s["cand"] if sr.device_resident else s["cand_np"])
    return dict(s, codes=codes, c_valid=valid)


def shard_approx(shard: MultiStageRetriever, scores_c, q_valid,
                 s: dict) -> dict:
    """PLAID stage 3 on a shard's candidates (``s``, from
    :func:`shard_gather_codes`) for the group's probe scores ``scores_c``
    (B, Lq, K): the raw approximate scores, -inf where no candidate is,
    not a per-shard top-ndocs (the survivors are chosen over the whole
    group) → {cand_np, approx_np}, host (B, W)."""
    scores_c, q_valid, codes, valid = shard.searcher.to_device(
        scores_c, q_valid, s["codes"], s["c_valid"])
    a = stage3_approx_score_batch(scores_c, codes, valid, q_valid)
    a = a.masked_fill(s["cand"] < 0, float("-inf"))
    return {"cand_np": s["cand_np"], "approx_np": a.cpu().numpy()}


class ShardedRetriever(MultiStageRetriever):
    """Scatter-gather retriever over per-shard ``MultiStageRetriever``s.

    ``shards``: one retriever per contiguous doc range; ``shard_offsets``:
    (n_shards+1,) global doc-id boundaries (shard i owns global pids
    [offsets[i], offsets[i+1])). All shards must share params. The
    pooled fanout stages run on the group's own threads, one per shard
    and at most one per core.

    With one shard every entry point delegates to it, so that group is
    the unsharded path bit for bit, down to the same plan object, and
    shares the shard's stage record.
    """

    def __init__(self, shards: Sequence[MultiStageRetriever],
                 shard_offsets):
        if not shards:
            raise ValueError("empty shard group")
        self.shards = list(shards)
        self.offsets = np.asarray(shard_offsets, np.int64)
        if len(self.offsets) != len(self.shards) + 1:
            raise ValueError(
                f"{len(self.shards)} shards need {len(self.shards) + 1} "
                f"boundaries, got {len(self.offsets)}")
        for sh in self.shards[1:]:
            if sh.params != self.shards[0].params:
                raise ValueError("shards must share MultiStageParams")
        self.params = self.shards[0].params
        self.n_shards = len(self.shards)
        self.n_docs = int(self.offsets[-1])
        # the executors' device: where the group's own device work (the
        # centroid probe, hybrid's normaliser) runs
        self.device = self.shards[0].device
        self._lock = threading.Lock()
        # one mutation of the group's live bookkeeping at a time (a
        # delete and its shard view, a compaction)
        self._live_mut = threading.Lock()
        self._plans: dict = {}
        self.pipeline_stats = (self.shards[0].pipeline_stats
                               if self.n_shards == 1 else PipelineStats())
        self._caches = None
        self.index_generation = 0
        self.live = None
        # gather concurrency capped at the core count: more threads than
        # cores only trade the GIL between the gathers' Python segments
        workers = min(self.n_shards, max(1, os.cpu_count() or 1))
        self._pool = ThreadPoolExecutor(
            max_workers=workers, thread_name_prefix="shard")
        self.set_splade_backend(self.params.splade_backend)
        self.set_rerank_backend(self.params.rerank_backend)

    # ------------------------------------------------------------------
    # group-wide knobs
    # ------------------------------------------------------------------
    def set_splade_backend(self, backend: str):
        """Switch every shard's stage-1 scorer (plans are keyed on the
        backend, so the next ``compile_plan`` compiles anew)."""
        check_splade_backend(backend)
        for sh in self.shards:
            sh.set_splade_backend(backend)
        self.splade_backend = backend

    def set_rerank_backend(self, backend: str):
        """Switch every shard's stage-4 tail and record it (the cache
        salts read it). The plans of more than one shard keep the split
        shape whatever the setting: hybrid's normaliser needs the whole
        cross-shard candidate list and the merges need each shard's
        narrow score slice. One shard delegates ``compile_plan``, so
        that group serves its shard's tail."""
        for sh in self.shards:
            sh.set_rerank_backend(backend)
        self.rerank_backend = self.shards[0].rerank_backend

    def splade_device_cache(self):
        """Every shard's padded-postings device cache, one per shard."""
        return [sh.splade_device_cache() for sh in self.shards]

    def _shard_stage1(self, term_ids, term_weights, k: int, backend: str,
                      live: bool = False):
        """Every shard's stage-1 top-k as (global pids, scores), in shard
        order. On the device every shard's top-k is launched before any
        is copied back, so the launches queue back to back. ``live``
        (the batch's routing): every shard scores on the host CSR with
        its own tombstones excluded before its top-k, whatever the
        backend; otherwise no shard does, whatever its view holds."""
        if backend == "host" or live:
            outs = [sh.run_splade_batch(term_ids, term_weights, k,
                                        backend="host", live=live)
                    for sh in self.shards]
        else:
            launched = [sh.splade_device_cache().dispatch_topk(
                term_ids, term_weights, k) for sh in self.shards]
            outs = [SpladeDeviceCache.finalize_topk(d) for d in launched]
        return [(np.where(p >= 0, p + self.offsets[i], -1), s)
                for i, (p, s) in enumerate(outs)]

    def run_splade_batch(self, term_ids, term_weights,
                         k: Optional[int] = None,
                         backend: Optional[str] = None,
                         live: Optional[bool] = None):
        """Group stage 1: every shard's top-k merged into the global one
        (a dirty group's delta rows merged in), the single index's rows
        bit for bit. ``live`` as for the unsharded retriever; one shard
        delegates. → host (pids (B, k) int64 −1 padded, scores (B, k)
        f32)."""
        if self.n_shards == 1:
            return self.shards[0].run_splade_batch(term_ids, term_weights,
                                                   k, backend, live)
        backend = check_splade_backend(backend or self.splade_backend)
        k = self.params.first_k if k is None else k
        live = self._live_dirty() if live is None else live
        outs = self._shard_stage1(list(term_ids), list(term_weights), k,
                                  backend, live)
        pids, scores = _append_splade_delta(
            term_ids, term_weights,
            np.concatenate([p for p, _ in outs], axis=1),
            np.concatenate([s for _, s in outs], axis=1), k,
            self.live if live else None)
        return merge_topk(pids, scores, k, pad_score=0.0)

    # ------------------------------------------------------------------
    # entry points (one shard delegates: the unsharded path bit for bit)
    # ------------------------------------------------------------------
    # search (a batch of one) is inherited: it runs through search_batch
    def search_batch(self, method, q_embs=None, term_ids=None,
                     term_weights=None, alpha=None, k: Optional[int] = None,
                     ctxs=None):
        if self.n_shards == 1:
            return self.shards[0].search_batch(
                method, q_embs=q_embs, term_ids=term_ids,
                term_weights=term_weights, alpha=alpha, k=k, ctxs=ctxs)
        return super().search_batch(method, q_embs=q_embs,
                                    term_ids=term_ids,
                                    term_weights=term_weights, alpha=alpha,
                                    k=k, ctxs=ctxs)

    def compile_plan(self, method: str, live: bool = False) -> StagePlan:
        if self.n_shards == 1:
            return self.shards[0].compile_plan(method, live)
        return super().compile_plan(method, live)

    def attach_caches(self, caches):
        """Group-level caches: the *merged* stage-1 rows are what is
        cached (a shard's rows hold shard-local pids and must never
        answer for the group). With one shard the plans are the shard's,
        and so are the caches."""
        self._caches = caches
        if self.n_shards == 1:
            self.shards[0].attach_caches(caches)

    def bump_index_generation(self):
        gen = super().bump_index_generation()
        for sh in self.shards:
            sh.index_generation = gen
        return gen

    def _plaid_salt(self) -> str:
        return self.shards[0]._plaid_salt()

    # ------------------------------------------------------------------
    # the live index of a group (live_upsert and live_stats are the
    # unsharded retriever's: the delta lives at the coordinator)
    # ------------------------------------------------------------------
    def enable_live(self) -> live_mod.LiveIndexState:
        """Attach the group's live state and return it. Idempotent. One
        shard delegates (the group and its shard share the state). More
        keep the delta segment and the tombstone set at the coordinator,
        on the group's device, with new pids appended past the last
        boundary; each shard gets a ``LiveView`` of its own tombstones,
        which its host stage 1 excludes before its top-k."""
        if self.live is not None:
            return self.live
        if self.n_shards == 1:
            self.live = self.shards[0].enable_live()
            return self.live
        if any(sh.searcher.device_resident for sh in self.shards):
            raise ValueError("live index requires the host (mmap) tier; "
                             "device_resident pools are frozen")
        live = live_mod.LiveIndexState(self.shards[0].searcher.index,
                                       self.shards[0].splade,
                                       device=self.device)
        # the geometry is every shard's; the pid space is the group's
        live.base_n = self.n_docs
        for sh in self.shards:
            sh.live = live_mod.LiveView()
        self.live = live
        return live

    def _sync_shard_view(self, j: int):
        """Shard ``j``'s view := the group's tombstones in its range,
        shard-local."""
        lo, hi = int(self.offsets[j]), int(self.offsets[j + 1])
        self.shards[j].live.update(self.live.local_tombstones(lo, hi),
                                   generation=self.index_generation)

    def live_delete(self, gpid: int) -> bool:
        """Tombstone a global pid; True if it was live before. A base
        pid also reaches the view of the shard that owns it, and only
        that one; a delta pid stays at the coordinator."""
        live = self._require_live()
        with self._live_mut:
            if not live.delete(gpid):
                return False
            gpid = int(gpid)
            if self.n_shards > 1 and gpid < live.base_n:
                self._sync_shard_view(int(np.searchsorted(
                    self.offsets, gpid, side="right") - 1))
            self.bump_index_generation()
        return True

    def compact_live(self):
        """Merge the delta prefix into the **last** shard: delta doc j's
        global pid ``base_n + j`` is ``offsets[-1] + j``, so appending it
        to the last shard keeps every pid. The last shard's new
        directories and retriever (its tables on that shard's device)
        are built outside the gate; the swap (replace ``shards[-1]``,
        grow the last boundary, drop the plans, rebase, the new shard's
        view, the generation) drains the readers under the write gate.
        The other shards, their device caches and views stay as they
        are. One shard delegates. → what the unsharded ``compact_live``
        returns: None when the delta is empty, else {"compacted",
        "colbert_dir", "splade_dir", "seconds": each step's wall}."""
        if self.n_shards == 1:
            out = self.shards[0].compact_live()
            self.index_generation = self.shards[0].index_generation
            if out is not None:
                self.offsets[-1] += out["compacted"]
                self.n_docs = int(self.offsets[-1])
                with self._lock:
                    self._plans.clear()
            return out
        live = self._require_live()
        with self._live_mut:
            n_take = live.snapshot_delta()
            if n_take == 0:
                return None
            marks = [time.perf_counter()]
            j = self.n_shards - 1
            last = self.shards[j]
            idx = last.searcher.index
            col_dir, spl_dir = write_compacted(idx, last.splade, live, n_take,
                                               self.index_generation + 1,
                                               marks)
            new = MultiStageRetriever(
                SpladeIndex.load(spl_dir),
                PLAIDSearcher(ColBERTIndex(col_dir, mode=idx.store.mode),
                              last.searcher.params, device=last.device),
                self.params, device=last.device)
            new.set_splade_backend(self.splade_backend)
            new.set_rerank_backend(last.rerank_backend)
            marks.append(time.perf_counter())
            with live.gate.write():
                marks.append(time.perf_counter())
                self.shards[j] = new
                self.offsets[j + 1] += n_take
                self.n_docs = int(self.offsets[-1])
                with self._lock:
                    self._plans.clear()
                live.rebase(n_take)
                new.live = live_mod.LiveView()
                self._sync_shard_view(j)
                self.bump_index_generation()
            marks.append(time.perf_counter())
        return compaction_reply(n_take, col_dir, spl_dir, marks)

    # ------------------------------------------------------------------
    # the group's stage-1 cache
    # ------------------------------------------------------------------
    def _stage1_group_lookup(self, cb):
        """All-or-nothing lookup of a batch's merged stage-1 rows: the
        shards score a batch's queries together, so a partial hit
        recomputes the whole batch. → stacked (pids_b, s_scores), or
        None."""
        keys = self._stage1_ctx_keys(cb)
        if keys is None:
            return None
        rows = [None if k is None else self._caches.stage1.get(k)
                for k in keys]
        n_hit = sum(r is not None for r in rows)
        if n_hit < len(rows):
            self.pipeline_stats.counter("cache_stage1_misses",
                                        len(rows) - n_hit)
            return None
        self.pipeline_stats.counter("cache_stage1_hits", n_hit)
        return (np.stack([r[0] for r in rows]),
                np.stack([r[1] for r in rows]))

    def _stage1_group_store(self, cb):
        """Store each query's merged stage-1 row (``first_k`` wide)."""
        keys = self._stage1_ctx_keys(cb)
        if keys is None:
            return
        pids_b, s_scores = cb.state["pids_b"], cb.state["s_scores"]
        gen = self.index_generation
        for i, key in enumerate(keys):
            if key is not None:
                self._caches.stage1.put(key, freeze(pids_b[i], s_scores[i]),
                                        gen)

    # ------------------------------------------------------------------
    # the sharded stage plans
    # ------------------------------------------------------------------
    def _build_plan(self, method: str, live: bool = False) -> StagePlan:
        """The scatter-gather stage graph of one method (more than one
        shard). The unsharded plans' discipline holds: host stages touch
        only numpy, device launches and syncs live in device stages.
        Per-shard stages carry ``fanout=n_shards`` and read and write the
        batch's shard axis; the ``merge_topk`` stages run on the host
        over the shards' host arrays.

        ``live``: the plan of a dirty live group. Stage 1 runs every
        shard on the host with its tombstones excluded; the merges take
        the delta's rows and drop tombstoned colbert candidates; the
        delta's candidates are scored at the coordinator by device
        stages the frozen plans lack: ``device_score:delta`` (rerank,
        hybrid), ``device_score:approx:delta`` and
        ``device_score:exact:delta`` (colbert)."""
        p = self.params
        S = self.n_shards
        offs = self.offsets
        shards = self.shards
        state = self.live if live else None
        dr = shards[0].searcher.device_resident
        gather_kind = DEVICE if dr else HOST
        access = None if dr else CombinedAccessStats(
            [sh.searcher.index.store.stats for sh in shards])

        def plan(*stages):
            return StagePlan(method=method, stages=stages,
                             access_stats=access, pool=self._pool)

        def gather(pids_key):
            # the shard's own candidates of a global pid matrix, gathered
            # from its segment (on the host, pooled; on the device for a
            # resident pool)
            def fn(cb, i):
                cols, sel = compact_owned(cb.state[pids_key], offs[i],
                                          offs[i + 1])
                return dict(shard_gather(shards[i], sel), cols=cols)
            return fn

        if method == "colbert":
            sp = shards[0].searcher.params
            ndocs = min(sp.ndocs, sp.candidate_cap)

            def probe(cb):
                # ONE centroid probe for the group: the centroid table is
                # replicated, so a probe per shard would repeat the same
                # matmul S times
                sr = shards[0].searcher
                q, q_valid = sr.to_device(*pad_query_batch_host(cb.q_embs))
                scores_c, cids = stage1_centroid_probe_batch(
                    q, q_valid, sr.centroids, sp.nprobe)
                return cb.with_state(q=q, q_valid=q_valid,
                                     scores_c=scores_c, cids=cids)

            def approx_delta(cb):
                # the delta's candidates (its docs holding a probed
                # centroid) and their approximate scores, from the probe
                # the shards used
                st = cb.state
                d_cand = state.delta_candidate_matrix(
                    st["cids"].cpu().numpy())
                return cb.with_state(d_cand=d_cand,
                                     d_approx=state.approx_scores(
                                         st["scores_c"], st["q_valid"],
                                         d_cand))

            def candidates(cb, i):
                return shard_candidates(shards[i], cb.state["cids"])

            def gather_codes(cb, i):
                return shard_gather_codes(shards[i], cb.shard_states[i])

            def approx(cb, i):
                return shard_approx(shards[i], cb.state["scores_c"],
                                    cb.state["q_valid"], cb.shard_states[i])

            def exact(cb, i):
                s = cb.shard_states[i]
                c = shard_exact_scores(shards[i], cb.state["q"],
                                       cb.state["q_valid"], s)
                (c,) = HostCopy(c).wait()          # this launch's event
                return {"cols": s["cols"], "exact": c}

            approx_d = exact_d = ()
            if live:
                approx_d = (Stage("device_score:approx:delta", DEVICE,
                                  approx_delta),)
                exact_d = (Stage("device_score:exact:delta", DEVICE,
                                 lambda cb: score_delta_state(
                                     cb, state, "final_g", wait=True)),)
            return plan(
                Stage("plaid_probe", DEVICE, probe),
                Stage("plaid_probe:ivf", DEVICE, candidates, fanout=S),
                Stage("host_gather:codes", gather_kind, gather_codes,
                      fanout=S, pooled=not dr),
                Stage("device_score:approx", DEVICE, approx, fanout=S),
                *approx_d,
                Stage("merge_topk:approx", HOST,
                      lambda cb: merge_approx_state(cb, offs, ndocs, state)),
                Stage("host_gather:residuals", gather_kind,
                      gather("final_g"), fanout=S, pooled=not dr),
                Stage("device_score:exact", DEVICE, exact, fanout=S),
                *exact_d,
                Stage("merge_topk", HOST, fuse_colbert_state))

        backend = self.splade_backend
        s1_kind = HOST if backend == "host" or live else DEVICE

        def splade_stage(cb):
            # the group's stage 1, writing the shard axis itself
            cached = self._stage1_group_lookup(cb)
            if cached is not None:
                # every query's merged rows are cached: no shard runs;
                # the merge stage rebuilds the state from them
                return cb.with_state(stage1_cached=cached)
            outs = self._shard_stage1(list(cb.term_ids),
                                      list(cb.term_weights), p.first_k,
                                      backend, live)
            return cb.evolve(shard_states=tuple(
                {"pids": pd, "scores": sc} for pd, sc in outs))

        # the dispatches are declared per run, as every stage's are: a
        # batch that the stage-1 cache answers whole records S as well,
        # as the unsharded stage 1 records its one
        stage1 = Stage("splade_stage1", s1_kind, splade_stage,
                       device_dispatches=S if s1_kind == DEVICE else None)

        if method == "splade":
            def fuse_splade(cb):
                cached = cb.state.get("stage1_cached")
                if cached is not None:
                    pids_b, s_scores = cached
                    return cb.evolve(pids=pids_b[:, :cb.k],
                                     scores=s_scores[:, :cb.k])
                cb = fuse_splade_state(cb, p.first_k, state)
                self._stage1_group_store(cb)
                return cb

            return plan(stage1, Stage("merge_topk", HOST, fuse_splade))

        # rerank / hybrid: merged SPLADE candidates → the shards' residual
        # gathers → a decompress_maxsim launch per shard → the global fuse
        def merge_stage1(cb):
            cached = cb.state.get("stage1_cached")
            if cached is not None:
                return stage1_state_from_rows(cb, *cached)
            cb = merge_stage1_state(cb, p.first_k, state)
            self._stage1_group_store(cb)
            return cb

        def score(cb, i):
            # launch, and enqueue the copy of the scores to the host
            # behind an event; the fuse stage waits for that event
            s = cb.shard_states[i]
            c = shard_exact_scores(shards[i], cb.state["q"],
                                   cb.state["q_valid"], s)
            return {"cols": s["cols"], "c": HostCopy(c)}

        # inside the open window: the fuse waits for its copy too
        delta = (Stage("device_score:delta", DEVICE,
                       lambda cb: score_delta_state(cb, state, "pids_b",
                                                    wait=False)),
                 ) if live else ()
        return plan(
            stage1,
            Stage("merge_topk:stage1", HOST, merge_stage1),
            Stage("host_gather:residuals", gather_kind, gather("pids_b"),
                  fanout=S, pooled=not dr),
            Stage("device_score:maxsim", DEVICE, score, fanout=S,
                  opens_async=True),
            *delta,
            Stage("fuse_topk", DEVICE,
                  lambda cb: fuse_scatter_rerank(cb, method, p.normalizer,
                                                 self.device),
                  closes_async=True, device_dispatches=0))


def load_shard(shard_dir, *, mode: str = "mmap", plaid_params=None,
               multistage_params=None, device="cuda") -> MultiStageRetriever:
    """One shard of a group written by ``split_index_tree``
    (``shard_dir`` holding ``colbert/`` + ``splade/``) as a retriever on
    ``device``: what :func:`build_sharded_retriever` loads a shard as,
    and what a shard worker process serves."""
    d = pathlib.Path(shard_dir)
    searcher = PLAIDSearcher(ColBERTIndex(d / "colbert", mode=mode),
                             plaid_params or PlaidParams(), device=device)
    kw = {} if multistage_params is None else {"params": multistage_params}
    return MultiStageRetriever(
        SpladeIndex.load(d / "splade", mmap=(mode == "mmap")), searcher,
        device=device, **kw)


def build_sharded_retriever(shard_dirs, boundaries, *, mode: str = "mmap",
                            plaid_params=None, multistage_params=None,
                            devices: Optional[Sequence] = None,
                            device="cuda") -> ShardedRetriever:
    """Load a shard group written by ``split_index_tree`` into a
    :class:`ShardedRetriever`. ``shard_dirs``: per-shard directories each
    holding ``colbert/`` + ``splade/``; ``devices``: one device per shard,
    else every shard on ``device`` (on one card every shard shares it)."""
    return ShardedRetriever(
        [load_shard(d, mode=mode, plaid_params=plaid_params,
                    multistage_params=multistage_params,
                    device=device if devices is None else devices[i])
         for i, d in enumerate(shard_dirs)], boundaries)
