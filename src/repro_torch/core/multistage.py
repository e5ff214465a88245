"""ColBERT-serve's multi-stage retrieval pipeline.

The paper's four systems:

  * ``colbert``  — full PLAID end to end (mmap pool, or resident on the
    device with ``PLAIDSearcher(device_resident=True)``)
  * ``splade``   — SPLADEv2 w/ PISA-style impact index only
  * ``rerank``   — SPLADE top-``first_k`` → MMAP ColBERT exact rescoring
  * ``hybrid``   — rerank + α-interpolated z-normed score fusion

Stage 1 of the SPLADE methods scores on the host CSR index
(``splade_backend="host"``) or on the device from padded postings
through the SPLADE kernel (``"device"``); ``colbert`` probes centroids,
generates and approximately scores IVF candidates on the device. The
gathers run on the host from the memory-mapped pool (on the device for
a resident pool); the exact tail runs on the searcher's device through
the CUDA kernels.

With a cache hierarchy attached (:meth:`MultiStageRetriever.attach_caches`)
the SPLADE stage 1 reads and fills per-query candidate rows, and
``colbert`` skips stages 1-3 when every query's survivors are cached.

With a live index (:meth:`MultiStageRetriever.enable_live`) a dirty
state — upserted documents in the delta segment or tombstoned pids — is
served by overlay plans: stage 1 on the host CSR with the tombstones
excluded, merged with the delta's top-k; colbert's candidates from the
base IVF and the delta's; the delta's rows scored beside the base's by
the same functions and kernel; always the split tail. Each answer
equals a rebuild of the surviving corpus bit for bit.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.common import HostCopy, resolve_device
from repro_torch.core import hybrid as hybrid_mod
from repro_torch.core.plaid import (PLAIDSearcher, pad_query_batch_host,
                                    pad_topk_host, stage3_approx_score_batch,
                                    topk_host)
from repro_torch.index import live as live_mod
from repro_torch.index.builder import ColBERTIndex
from repro_torch.index.splade_device import SpladeDeviceCache
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.context import freeze
from repro_torch.serving.pipeline import (
    DEVICE,
    HOST,
    CandidateBatch,
    PipelineStats,
    Stage,
    StagePlan,
)

# "device" is the counterpart of the JAX package's "pallas" stage 1; its
# "jax" backend (a plain segment-sum on the device) has none here
SPLADE_BACKENDS = ("host", "device")
RERANK_BACKENDS = ("fused", "split")
METHODS = ("colbert", "splade", "rerank", "hybrid")
# the JAX package's refusal of a mutation on a frozen index
LIVE_NOT_ENABLED = "live index not enabled (enable_live / --live)"


def write_compacted(index, splade, live, n_take: int, gen: int,
                    marks: list) -> tuple:
    """Write ``index`` and ``splade`` with the first ``n_take`` delta docs
    merged in as generation ``gen`` beside ``index`` (``<index>.g<gen>``,
    ``splade.g<gen>``), appending the clock to ``marks`` after each. →
    (colbert dir, splade dir)."""
    col_dir = index.path.with_name(f"{index.path.name}.g{gen}")
    spl_dir = index.path.with_name(f"splade.g{gen}")
    live_mod.compact_colbert_dir(index, live, n_take, col_dir)
    marks.append(time.perf_counter())
    live_mod.compact_splade_dir(splade, live, n_take, spl_dir)
    marks.append(time.perf_counter())
    return col_dir, spl_dir


def compaction_reply(n_take: int, col_dir, spl_dir, marks: list) -> dict:
    """``compact_live``'s reply: each step's wall from its six marks."""
    steps = ("colbert_dir", "splade_dir", "load", "gate_wait", "swap")
    seconds = {name: marks[i + 1] - marks[i]
               for i, name in enumerate(steps)}
    seconds["total"] = marks[-1] - marks[0]
    return {"compacted": n_take, "colbert_dir": str(col_dir),
            "splade_dir": str(spl_dir), "seconds": seconds}


def check_splade_backend(backend: str) -> str:
    if backend not in SPLADE_BACKENDS:
        raise ValueError(f"splade backend {backend!r} not in "
                         f"{SPLADE_BACKENDS} (the device stage 1 is "
                         "'device')")
    return backend


@dataclasses.dataclass(frozen=True)
class MultiStageParams:
    first_k: int = 200            # SPLADE candidates (paper: top-200)
    k: int = 100                  # final depth
    alpha: float = 0.3            # paper's MS MARCO-tuned value
    normalizer: str = "znorm"
    splade_backend: str = "host"  # stage-1 scorer: host | device
    splade_max_df: Optional[int] = None  # padded-postings df cap (None=exact)
    rerank_backend: str = "fused"  # stage-4 tail: fused | split


class MultiStageRetriever:
    def __init__(self, splade_index: SpladeIndex, searcher: PLAIDSearcher,
                 params: MultiStageParams = MultiStageParams(),
                 device="cuda"):
        """``device`` is where stage 4 (and a ``device`` stage 1) runs;
        the searcher must already hold its tables there."""
        self.device = resolve_device(device)
        if searcher.device != self.device:
            raise ValueError(f"searcher is on {searcher.device}, retriever "
                             f"asked for {self.device}")
        if params.normalizer not in hybrid_mod.NORMALIZERS:
            raise ValueError(f"normalizer {params.normalizer!r} not in "
                             f"{tuple(hybrid_mod.NORMALIZERS)}")
        self.splade = splade_index
        self.searcher = searcher
        self.params = params
        self._splade_device: Optional[SpladeDeviceCache] = None
        self._lock = threading.Lock()
        self._plans: dict = {}
        self.pipeline_stats = PipelineStats()
        # the cache hierarchy the engine attaches, and the index
        # generation its entries are scoped to
        self._caches = None
        self.index_generation = 0
        # None while the index is frozen; enable_live() attaches the
        # live state (delta segment, tombstones, compaction gate)
        self.live: Optional[live_mod.LiveIndexState] = None
        self._compact_lock = threading.Lock()
        self.set_splade_backend(params.splade_backend)
        self.set_rerank_backend(params.rerank_backend)
        if params.splade_backend != "host":
            self.splade_device_cache()    # pay the transfer up front

    def set_splade_backend(self, backend: str):
        """Stage-1 scorer: ``host`` (numpy CSR pass) or ``device`` (the
        SPLADE kernel over padded postings on this retriever's device).
        With untruncated postings both give the same candidates and
        scores bit for bit."""
        self.splade_backend = check_splade_backend(backend)

    def set_rerank_backend(self, backend: str):
        """Stage-4 tail selection: ``fused`` runs exact scoring, masking
        and top-k selection as ONE kernel launch for ``rerank`` (and
        scoring + fusion + selection on the device for ``hybrid``);
        ``split`` scores on the device and selects on the host. Results
        are bitwise identical."""
        if backend not in RERANK_BACKENDS:
            raise ValueError(f"rerank backend {backend!r} not in "
                             f"{RERANK_BACKENDS}")
        self.rerank_backend = backend

    def splade_device_cache(self) -> SpladeDeviceCache:
        """Padded-postings device tensors, materialised once and reused
        by every ``device`` stage-1 launch (locked: concurrent server
        workers must not each pay the host→device transfer)."""
        with self._lock:
            if self._splade_device is None:
                self._splade_device = SpladeDeviceCache(
                    self.splade, max_df=self.params.splade_max_df,
                    device=self.device)
            return self._splade_device

    def reset_stage_stats(self):
        self.pipeline_stats.reset()

    # ------------------------------------------------------------------
    # coordinator cache hierarchy + index-generation invalidation
    # ------------------------------------------------------------------
    def attach_caches(self, caches):
        """Attach a :class:`~repro_torch.serving.context.CacheHierarchy`
        (or detach with ``None``). Plans read ``self._caches`` per call,
        so caches can be attached after plans are compiled."""
        self._caches = caches

    def bump_index_generation(self):
        """Advance the index generation (the index changed) and purge
        every cache entry computed under an older one. New cache keys
        embed the new generation, so a stale entry is never served even
        before the purge completes."""
        self.index_generation = self.index_generation + 1
        caches = self._caches
        if caches is not None:
            caches.purge_stale(self.index_generation)
        return self.index_generation

    # ------------------------------------------------------------------
    # live (mutable) index: mutations and compaction; a dirty live index
    # is served by the overlay plans (``_build_plan(live=True)``)
    # ------------------------------------------------------------------
    def enable_live(self) -> live_mod.LiveIndexState:
        """Attach a :class:`~repro_torch.index.live.LiveIndexState` on
        this retriever's device and return it. Idempotent. Until the
        first mutation the state is clean and every answer is the frozen
        one, bit for bit."""
        if self.live is not None:
            return self.live
        if self.searcher.device_resident:
            raise ValueError("live index requires the host (mmap) tier; "
                             "device_resident pools are frozen")
        self.live = live_mod.LiveIndexState(self.searcher.index, self.splade,
                                            device=self.device)
        return self.live

    def _require_live(self) -> live_mod.LiveIndexState:
        if self.live is None:
            raise RuntimeError(LIVE_NOT_ENABLED)
        return self.live

    def _live_dirty(self) -> bool:
        return self.live is not None and self.live.dirty

    def live_upsert(self, doc_emb, term_ids, term_weights,
                    doc_len=None) -> int:
        """Append a document to the delta segment → its global pid.
        Bumps the index generation so the caches invalidate."""
        pid = self._require_live().upsert(doc_emb, term_ids, term_weights,
                                          doc_len)
        self.bump_index_generation()
        return pid

    def live_delete(self, gpid: int) -> bool:
        """Tombstone a global pid; True if it was live before."""
        ok = self._require_live().delete(gpid)
        if ok:
            self.bump_index_generation()
        return ok

    def live_stats(self):
        """None on a frozen index; else the live counters and sizes with
        the index ``generation``."""
        live = self.live
        if live is None:
            return None
        out = live.stats()
        out["generation"] = self.index_generation
        return out

    def compact_live(self):
        """Merge the delta prefix into a new on-disk index generation
        and swap the serve handles.

        The directories and the new searcher (its tables copied to the
        device) are built outside the gate, while queries keep flowing
        against base + delta; only the swap takes the write gate, which
        drains the readers in flight, drops the plans, the padded SPLADE
        postings and the old searcher (their device tensors go with
        them), and bumps the generation. Global pids are stable across
        the swap: delta doc ``j`` becomes base doc ``base_n + j``. One
        compaction at a time. → None when the delta is empty, else
        {"compacted", "colbert_dir", "splade_dir", "seconds": each
        step's wall}."""
        live = self._require_live()
        with self._compact_lock:
            n_take = live.snapshot_delta()
            if n_take == 0:
                return None
            marks = [time.perf_counter()]
            idx = self.searcher.index
            col_dir, spl_dir = write_compacted(idx, self.splade, live, n_take,
                                               self.index_generation + 1,
                                               marks)
            new_searcher = PLAIDSearcher(
                ColBERTIndex(col_dir, mode=idx.store.mode),
                self.searcher.params, device=self.device)
            new_splade = SpladeIndex.load(spl_dir)
            marks.append(time.perf_counter())
            with live.gate.write():
                marks.append(time.perf_counter())
                self.splade = new_splade
                self.searcher = new_searcher
                with self._lock:
                    self._plans.clear()
                    self._splade_device = None
                live.rebase(n_take)
                self.bump_index_generation()
            marks.append(time.perf_counter())
        return compaction_reply(n_take, col_dir, spl_dir, marks)

    def _plaid_salt(self) -> str:
        sp = self.searcher.params
        return f"np{sp.nprobe}|cc{sp.candidate_cap}|nd{sp.ndocs}"

    def cache_salts(self, method: str):
        """(exact_salt, stage1_salt): the retriever-config components of
        the cache keys. Everything that changes an answer for identical
        query bytes appears here: backends, first_k, normalizer, PLAID
        knobs and the index generation. The strings are the JAX
        package's, except that the stage-1 backend token reads this
        package's names (``bhost``/``bdevice``, ``sbhost``/``sbdevice``;
        the JAX package's device stage 1 reads ``pallas``). The fused
        and split tails give the same bits, and keep separate salts as
        in the JAX package."""
        p = self.params
        gen = self.index_generation
        if method == "colbert":
            s1 = f"cand|{self._plaid_salt()}|g{gen}"
        else:
            s1 = f"sp|fk{p.first_k}|b{self.splade_backend}|g{gen}"
        exact = (f"fk{p.first_k}|n{p.normalizer}|sb{self.splade_backend}"
                 f"|rb{self.rerank_backend}|{self._plaid_salt()}|g{gen}")
        return exact, s1

    def _stage1_ctx_keys(self, cb: CandidateBatch):
        """Per-query stage-1 cache keys for a batch, or None when the
        stage-1 cache is off or the batch carries no contexts."""
        caches = self._caches
        if (caches is None or caches.stage1.capacity <= 0
                or cb.ctxs is None):
            return None
        keys = [None if c is None else c.stage1_key for c in cb.ctxs]
        if all(k is None for k in keys):
            return None
        return keys

    # ------------------------------------------------------------------
    def run_splade_batch(self, term_ids, term_weights,
                         k: Optional[int] = None,
                         backend: Optional[str] = None,
                         live: Optional[bool] = None):
        """Stage 1 for a whole micro-batch: one vectorised host CSR pass
        (``host``) or one SPLADE kernel launch and a device top-k
        (``device``); ``backend`` defaults to the retriever's. A dirty
        live index scores on the host whatever the backend
        (:meth:`_run_splade_live`). ``live`` says whether to score as
        the dirty live index (None: as the live state is now); a plan
        passes the routing of its batch, so that an upsert landing
        mid-batch cannot hand a frozen plan delta pids. → host (pids
        (B, k) int64 −1 padded, scores (B, k) f32)."""
        backend = check_splade_backend(backend or self.splade_backend)
        k = self.params.first_k if k is None else k
        if self._live_dirty() if live is None else live:
            return self._run_splade_live(self.live, term_ids, term_weights,
                                         k)
        if backend == "host":
            return self.splade.score_batch_host(term_ids, term_weights, k)
        return self.splade_device_cache().score_topk(term_ids,
                                                     term_weights, k)

    def _run_splade_live(self, live, term_ids, term_weights, k: int):
        """Stage 1 of a dirty live index, on the host whatever the
        backend: the base CSR with tombstoned base pids excluded before
        its top-k (a deleted doc may not displace a survivor), merged
        with the delta segment's own top-k. The merge of top-k lists of
        disjoint partitions under (score desc, pid asc) is the top-k of
        their union, so the result is what one index over base ∪ delta
        minus the tombstones scores. A shard's ``LiveView`` has no delta:
        its base rows are the answer."""
        base = self.splade.score_batch_host(term_ids, term_weights, k,
                                            exclude=live.base_exclude)
        delta_topk = getattr(live, "splade_delta_topk", None)
        if delta_topk is None:
            # a shard of a group holds a LiveView: its own tombstones and
            # no delta, whose rows merge at the group's coordinator
            return base
        # imported here: core.sharded subclasses this module's retriever
        from repro_torch.core.sharded import merge_topk
        d_pids, d_scores = delta_topk(term_ids, term_weights, k)
        return merge_topk(
            np.concatenate([base[0].astype(np.int64), d_pids], axis=1),
            np.concatenate([base[1], d_scores], axis=1), k, pad_score=0.0)

    def search(self, method: str, q_emb=None, term_ids=None,
               term_weights=None, alpha: Optional[float] = None,
               k: Optional[int] = None):
        """One query → (pids (k,), scores (k,)), -1 padded, descending.
        Runs as a batch of one through :meth:`search_batch`."""
        pids, scores = self.search_batch(
            method, q_embs=None if q_emb is None else [q_emb],
            term_ids=None if term_ids is None else [term_ids],
            term_weights=None if term_weights is None else [term_weights],
            alpha=alpha, k=k)
        return pids[0], scores[0]

    # ------------------------------------------------------------------
    # stage-graph compilation
    # ------------------------------------------------------------------
    def build_batch(self, method: str, q_embs=None, term_ids=None,
                    term_weights=None, alphas=None, k: Optional[int] = None,
                    n: Optional[int] = None, ctxs=None) -> CandidateBatch:
        """Package per-query inputs into the immutable carrier a
        :class:`StagePlan` consumes. ``ctxs`` (optional per-query
        :class:`~repro_torch.serving.context.RequestContext`) rides
        along so plan stages can consult per-request cache keys."""
        k = self.params.k if k is None else k
        if n is None:
            n = len(q_embs) if q_embs is not None else len(term_ids)
        pick = (lambda seq: None if seq is None else tuple(seq[:n]))
        return CandidateBatch(method=method, k=k, q_embs=pick(q_embs),
                              term_ids=pick(term_ids),
                              term_weights=pick(term_weights),
                              alphas=alphas, ctxs=pick(ctxs))

    def compile_plan(self, method: str, live: bool = False) -> StagePlan:
        """The method's typed stage graph, cached per (method, stage-1
        backend, rerank backend, live); ``live`` asks for the overlay
        plan of a dirty live index."""
        if method not in METHODS:
            raise ValueError(f"method {method!r} not in {METHODS}")
        key = (method, self.splade_backend, self.rerank_backend, live)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = self._plans[key] = self._build_plan(method, live)
            return plan

    def _build_plan(self, method: str, live: bool = False) -> StagePlan:
        """Host stages touch only numpy (mmap gathers, padding); every
        host↔device copy and every device sync lives in a device
        stage. With the pool resident on the device the gathers run
        there and are device stages.

        ``live``: the overlay plan of a dirty live index (mmap pool
        only). Stage 1 runs on the host (``run_splade_batch(live=True)``);
        the gathers read base rows and leave the delta's pids out; the
        exact stage scores the delta's candidates beside the base's;
        colbert's approximate stage drops tombstoned candidates and
        merges the delta's; the tail is the split one."""
        p = self.params
        searcher = self.searcher
        state = self.live if live else None
        dr = searcher.device_resident
        gather_kind = DEVICE if dr else HOST
        access = None if dr else searcher.index.store.stats
        backend = self.splade_backend
        s1_kind = HOST if backend == "host" or live else DEVICE

        def base_rows(pids):
            # the residual gathers read base rows: a delta pid is -1 to
            # them, and its rows come from the delta segment
            if state is None:
                return pids
            return np.where(np.asarray(pids) >= state.base_n, -1, pids)

        def splade_stage(cb):
            # both backends return host arrays. Stage-1 cache: a row's
            # bits do not depend on the batch it is scored in, so hits
            # and misses mix freely; only the missed rows are
            # dispatched, then put back in place
            keys = self._stage1_ctx_keys(cb)
            if keys is None:
                pids_b, s_scores = self.run_splade_batch(
                    list(cb.term_ids), list(cb.term_weights), p.first_k,
                    backend=backend, live=live)
                return cb.with_state(pids_b=pids_b, s_scores=s_scores)
            cache = self._caches.stage1
            rows = [None if k_ is None else cache.get(k_) for k_ in keys]
            miss = [i for i, r in enumerate(rows) if r is None]
            self.pipeline_stats.counter("cache_stage1_hits",
                                        len(rows) - len(miss))
            self.pipeline_stats.counter("cache_stage1_misses", len(miss))
            if miss:
                pids_m, scores_m = self.run_splade_batch(
                    [cb.term_ids[i] for i in miss],
                    [cb.term_weights[i] for i in miss], p.first_k,
                    backend=backend, live=live)
                gen = self.index_generation
                for j, i in enumerate(miss):
                    rows[i] = (pids_m[j], scores_m[j])
                    if keys[i] is not None:
                        cache.put(keys[i], freeze(pids_m[j], scores_m[j]),
                                  gen)
            return cb.with_state(pids_b=np.stack([r[0] for r in rows]),
                                 s_scores=np.stack([r[1] for r in rows]))

        if method == "splade":
            def fuse_splade(cb):
                s = cb.state
                return cb.evolve(pids=s["pids_b"][:, :cb.k],
                                 scores=s["s_scores"][:, :cb.k])

            stages = (Stage("splade_stage1", s1_kind, splade_stage),
                      Stage("fuse_splade", HOST, fuse_splade))
            return StagePlan(method=method, stages=stages,
                             access_stats=access)

        # rerank / hybrid: SPLADE candidates → residual gather → exact
        # MaxSim rescoring (+ α-fusion) → top-k
        def gather(cb):
            s = cb.state
            q, q_valid = pad_query_batch_host(cb.q_embs)
            codes, packed, valid = searcher.gather_tokens_batch(
                base_rows(s["pids_b"]))
            return cb.with_state(q=q, q_valid=q_valid, g_codes=codes,
                                 g_packed=packed, g_valid=valid)

        # colbert: centroid probe → IVF candidates → codes gather →
        # approximate scores → the ndocs survivors' residual gather; its
        # exact tail is the rerank tail on the survivors (``pids_b``)
        def probe(cb):
            # survivor-cache probe: when EVERY query's survivors are
            # cached, stages 1-3 are skipped and the state the tail
            # reads is rebuilt as the cold path makes it (the query
            # padding and copy of ``probe_batch``; the survivors on the
            # host and, for a resident pool, on the device)
            keys = self._stage1_ctx_keys(cb)
            if keys is not None:
                rows = [None if k_ is None else self._caches.stage1.get(k_)
                        for k_ in keys]
                if all(r is not None for r in rows):
                    self.pipeline_stats.counter("cache_stage1_hits",
                                                len(rows))
                    q, q_valid = searcher.to_device(
                        *pad_query_batch_host(cb.q_embs))
                    pids_b = np.stack([r[0] for r in rows])
                    final = searcher.to_device(pids_b)[0] if dr else None
                    return cb.with_state(q=q, q_valid=q_valid,
                                         pids_b=pids_b, final=final,
                                         stage1_cached=True)
                self.pipeline_stats.counter(
                    "cache_stage1_misses", sum(r is None for r in rows))
            st = searcher.probe_batch(cb.q_embs)
            # the host gather reads host candidates: copy them here (and
            # the probed centroids, which give the delta's candidates)
            cand = st["cand"] if dr else st["cand"].cpu().numpy()
            cids = st["cids"].cpu().numpy() if live else None
            return cb.with_state(q=st["q"], q_valid=st["q_valid"],
                                 scores_c=st["scores_c"], cand=st["cand"],
                                 cand_g=cand, cids_g=cids)

        def gather_codes(cb):
            s = cb.state
            if s.get("stage1_cached"):
                return cb
            codes, valid = searcher.gather_codes_batch(s["cand_g"])
            if state is None:
                return cb.with_state(c_codes=codes, c_valid=valid)
            # the delta's candidates: its docs holding a probed centroid
            return cb.with_state(
                c_codes=codes, c_valid=valid,
                d_cand=state.delta_candidate_matrix(s["cids_g"]))

        def live_survivors(s, codes, valid):
            from repro_torch.core.sharded import merge_topk
            # base candidates' approximate scores with the tombstoned ones
            # dropped (pid -1, -inf: what a padded slot is), merged with
            # the delta's by (score desc, pid asc) — approx_select_batch's
            # order
            approx = stage3_approx_score_batch(s["scores_c"], codes, valid,
                                               s["q_valid"])
            approx = approx.masked_fill(s["cand"] < 0, float("-inf"))
            cand = s["cand_g"]
            tomb = state.is_tombstoned(np.clip(cand, 0, None)) & (cand >= 0)
            d_approx = state.approx_scores(s["scores_c"], s["q_valid"],
                                           s["d_cand"])
            pids_b, _ = merge_topk(
                np.concatenate([np.where(tomb, -1, cand).astype(np.int64),
                                s["d_cand"]], axis=1),
                np.concatenate([np.where(tomb, -np.inf,
                                         approx.cpu().numpy()),
                                d_approx], axis=1),
                min(searcher.params.ndocs, searcher.params.candidate_cap))
            return pids_b

        def approx(cb):
            s = cb.state
            if s.get("stage1_cached"):
                return cb
            codes, valid = searcher.to_device(s["c_codes"], s["c_valid"])
            if state is None:
                final = searcher.approx_select_batch(
                    s["scores_c"], codes, valid, s["q_valid"], s["cand"])
                pids_b = final.cpu().numpy().astype(np.int64)
            else:
                final, pids_b = None, live_survivors(s, codes, valid)
            keys = self._stage1_ctx_keys(cb)
            if keys is not None:
                # each row with its count of real candidates after the
                # cap, as the JAX package's entries hold
                n_real = (s["cand"] >= 0).sum(dim=1).tolist()
                gen = self.index_generation
                for i, key in enumerate(keys):
                    if key is not None:
                        self._caches.stage1.put(
                            key, (freeze(pids_b[i])[0], int(n_real[i])),
                            gen)
            return cb.with_state(final=final, pids_b=pids_b)

        def gather_survivors(cb):
            s = cb.state
            codes, packed, valid = searcher.gather_tokens_batch(
                s["final"] if dr else base_rows(s["pids_b"]))
            return cb.with_state(g_codes=codes, g_packed=packed,
                                 g_valid=valid)

        def answer(cb, pids, scores):
            # as in the reference, colbert answers k columns, rerank and
            # hybrid min(k, first_k)
            if method == "colbert":
                pids, scores = pad_topk_host(pids, scores, cb.k)
            return cb.evolve(pids=pids, scores=scores)

        def device_inputs(cb):
            s = cb.state
            return searcher.to_device(s["q"], s["q_valid"], s["g_codes"],
                                      s["g_packed"], s["g_valid"],
                                      s["pids_b"] >= 0)

        def score(cb):
            q, q_valid, codes, packed, valid, mask = device_inputs(cb)
            c = searcher.exact_score_gathered(q, q_valid, codes, packed,
                                              valid, mask)
            pids = cb.state["pids_b"]
            if state is not None and (pids >= state.base_n).any():
                # the delta's candidates, scored by their own launch; each
                # candidate's score is its own, so the stitched matrix is
                # what one launch over base ∪ delta gives
                delta = pids >= state.base_n
                d = state.exact_scores(q, q_valid, np.where(delta, pids, -1))
                (on_delta,) = searcher.to_device(delta)
                c = torch.where(on_delta, d, c)
            if method == "hybrid":
                (s_scores,) = searcher.to_device(cb.state["s_scores"])
                c = hybrid_mod.hybrid_scores(
                    s_scores, c, mask,
                    alpha=torch.as_tensor(cb.alphas, device=c.device),
                    normalizer=p.normalizer)
            return cb.with_state(exact=HostCopy(c))

        def fuse_split(cb):
            s = cb.state
            (final,) = s["exact"].wait()        # this batch's event only
            return answer(cb, *topk_host(final, s["pids_b"], cb.k))

        def score_fused(cb):
            q, q_valid, codes, packed, valid, mask = device_inputs(cb)
            if method == "hybrid":
                (s_scores,) = searcher.to_device(cb.state["s_scores"])
                top = searcher.fused_hybrid_topk_gathered(
                    q, q_valid, codes, packed, valid, mask, s_scores,
                    torch.as_tensor(cb.alphas, device=q.device), cb.k,
                    p.normalizer)
            else:
                top = searcher.fused_topk_gathered(
                    q, q_valid, codes, packed, valid, mask, cb.k)
            return cb.with_state(top=HostCopy(*top))

        def fuse_fused(cb):
            s = cb.state
            top_s, top_i = s["top"].wait()      # this batch's event only
            pids, scores = searcher.finalize_topk_fused(top_s, top_i,
                                                        s["pids_b"])
            return answer(cb, pids, scores)

        # the launching stage opens the async window: it launches one
        # hand-written kernel and enqueues its result's copy to the host
        # behind an event; the sync stage closes the window by waiting
        # for that event
        if self.rerank_backend == "fused" and not live:
            tail = (Stage("fused_rerank", DEVICE, score_fused,
                          opens_async=True, device_dispatches=1),
                    Stage("fused_rerank:sync", DEVICE, fuse_fused,
                          closes_async=True, device_dispatches=0))
        else:
            score_name = ("device_score:exact" if method == "colbert"
                          else "device_score:maxsim")
            # a live index's delta candidates take a second launch
            tail = (Stage(score_name, DEVICE, score, opens_async=True,
                          device_dispatches=2 if live else 1),
                    Stage("fuse_topk", DEVICE, fuse_split,
                          closes_async=True, device_dispatches=0))
        if method == "colbert":
            head = (Stage("plaid_probe", DEVICE, probe),
                    Stage("host_gather:codes", gather_kind, gather_codes),
                    Stage("device_score:approx", DEVICE, approx),
                    Stage("host_gather:residuals", gather_kind,
                          gather_survivors))
        else:
            head = (Stage("splade_stage1", s1_kind, splade_stage),
                    Stage("host_gather:residuals", gather_kind, gather))
        return StagePlan(method=method, stages=head + tail,
                         access_stats=access)

    # ------------------------------------------------------------------
    def search_batch(self, method, q_embs=None, term_ids=None,
                     term_weights=None, alpha=None, k: Optional[int] = None,
                     ctxs=None):
        """Cross-query batched retrieval.

        ``method``: one method name for the whole batch, or a sequence of
        per-query names (mixed batches are grouped and each group runs
        batched). ``q_embs``/``term_ids``/``term_weights``: per-query
        sequences (ragged lengths fine). ``alpha``: scalar, per-query
        sequence (None entries take the default), or None. Returns
        (pids (B, k), scores (B, k)); ``colbert`` pads past min(k,
        ndocs) with (-1, -inf), and a ``rerank``, ``hybrid`` or
        ``splade`` group returns min(k, first_k) columns, padded the same
        way in a mixed batch. ``ctxs``: optional per-query
        :class:`~repro_torch.serving.context.RequestContext` sequence;
        with caches attached, the plans consult each context's
        ``stage1_key``.

        With a live index the whole batch holds the compaction gate's
        read side: batches run concurrently (and re-entrantly — a mixed
        batch recurses here) and only the swap of a compaction excludes
        them."""
        live = self.live
        if live is None:
            return self._search_batch(method, q_embs, term_ids,
                                      term_weights, alpha, k, ctxs)
        with live.gate.read():
            return self._search_batch(method, q_embs, term_ids,
                                      term_weights, alpha, k, ctxs)

    def _search_batch(self, method, q_embs, term_ids, term_weights, alpha,
                      k: Optional[int], ctxs):
        p = self.params
        k = p.k if k is None else k
        n = len(q_embs) if q_embs is not None else len(term_ids)
        if not isinstance(method, str):
            methods = list(method)
            if len(set(methods)) > 1:
                return self._search_batch_mixed(methods, q_embs, term_ids,
                                                term_weights, alpha, k, ctxs)
            method = methods[0]
        alphas = self._alpha_array(alpha, n)
        cb = self.build_batch(method, q_embs, term_ids, term_weights,
                              alphas, k, n, ctxs=ctxs)
        plan = self.compile_plan(method, live=self._live_dirty())
        cb = plan.run(cb, stats=self.pipeline_stats)
        return cb.pids, cb.scores

    def _alpha_array(self, alpha, n: int) -> np.ndarray:
        if alpha is None:
            return np.full(n, self.params.alpha, np.float32)
        if np.ndim(alpha) == 0:
            return np.full(n, float(alpha), np.float32)
        return np.asarray([self.params.alpha if a is None else float(a)
                           for a in alpha], np.float32)

    @staticmethod
    def scatter_group(out_pids, out_scores, idx, pids, scores):
        """Scatter one method group's results back into request order.
        Groups return at most k columns — they fill the prefix,
        leaving the (-1, -inf) tail as padding."""
        w = pids.shape[1]
        out_pids[idx, :w] = pids
        out_scores[idx, :w] = scores

    def _search_batch_mixed(self, methods, q_embs, term_ids, term_weights,
                            alpha, k: int, ctxs=None):
        """Group a mixed-method batch by method, run each group batched,
        and scatter results back into request order."""
        n = len(methods)
        alphas = self._alpha_array(alpha, n)
        out_pids = np.full((n, k), -1, np.int64)
        out_scores = np.full((n, k), -np.inf, np.float32)
        for m in dict.fromkeys(methods):
            idx = [i for i, mi in enumerate(methods) if mi == m]
            pick = (lambda seq: None if seq is None
                    else [seq[i] for i in idx])
            pids, scores = self.search_batch(
                m, q_embs=pick(q_embs), term_ids=pick(term_ids),
                term_weights=pick(term_weights), alpha=alphas[idx], k=k,
                ctxs=pick(ctxs))
            self.scatter_group(out_pids, out_scores, idx, pids, scores)
        return out_pids, out_scores
