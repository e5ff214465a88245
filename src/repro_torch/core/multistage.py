"""ColBERT-serve's multi-stage retrieval pipeline.

Three of the paper's four systems (``colbert``, full PLAID, is not
ported yet):

  * ``splade``   — SPLADEv2 w/ PISA-style impact index only
  * ``rerank``   — SPLADE top-``first_k`` → MMAP ColBERT exact rescoring
  * ``hybrid``   — rerank + α-interpolated z-normed score fusion

Stage 1 scores on the host CSR index; the residual gather runs on the
host from the memory-mapped pool; the stage-4 tail runs on the
searcher's device through the CUDA kernels.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core import hybrid as hybrid_mod
from repro_torch.core.plaid import PLAIDSearcher, pad_query_batch_host
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.serving.pipeline import (
    DEVICE,
    HOST,
    CandidateBatch,
    PipelineStats,
    Stage,
    StagePlan,
)

RERANK_BACKENDS = ("fused", "split")
METHODS = ("splade", "rerank", "hybrid")


@dataclasses.dataclass(frozen=True)
class MultiStageParams:
    first_k: int = 200            # SPLADE candidates (paper: top-200)
    k: int = 100                  # final depth
    alpha: float = 0.3            # paper's MS MARCO-tuned value
    normalizer: str = "znorm"
    rerank_backend: str = "fused"  # stage-4 tail: fused | split


class MultiStageRetriever:
    def __init__(self, splade_index: SpladeIndex, searcher: PLAIDSearcher,
                 params: MultiStageParams = MultiStageParams(),
                 device="cuda"):
        """``device`` is where stage 4 runs; the searcher must already
        hold its tables there."""
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
        self._lock = threading.Lock()
        self._plans: dict = {}
        self.pipeline_stats = PipelineStats()
        self.set_rerank_backend(params.rerank_backend)

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

    def reset_stage_stats(self):
        self.pipeline_stats.reset()

    # ------------------------------------------------------------------
    def run_splade_batch(self, term_ids, term_weights,
                         k: Optional[int] = None):
        """Stage 1 for a whole micro-batch: one vectorised host CSR pass.
        → (pids (B, k) int64 −1 padded, scores (B, k) f32)."""
        k = self.params.first_k if k is None else k
        return self.splade.score_batch_host(term_ids, term_weights, k)

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
                    n: Optional[int] = None) -> CandidateBatch:
        """Package per-query inputs into the immutable carrier a
        :class:`StagePlan` consumes."""
        k = self.params.k if k is None else k
        if n is None:
            n = len(q_embs) if q_embs is not None else len(term_ids)
        pick = (lambda seq: None if seq is None else tuple(seq[:n]))
        return CandidateBatch(method=method, k=k, q_embs=pick(q_embs),
                              term_ids=pick(term_ids),
                              term_weights=pick(term_weights),
                              alphas=alphas)

    def compile_plan(self, method: str) -> StagePlan:
        """The method's typed stage graph, cached per (method, rerank
        backend)."""
        if method not in METHODS:
            raise ValueError(f"method {method!r} not in {METHODS}")
        key = (method, self.rerank_backend)
        with self._lock:
            plan = self._plans.get(key)
            if plan is None:
                plan = self._plans[key] = self._build_plan(method)
            return plan

    def _build_plan(self, method: str) -> StagePlan:
        """Host stages touch only numpy (mmap gathers, padding); every
        host↔device copy and every device sync lives in a device
        stage."""
        p = self.params
        searcher = self.searcher
        access = searcher.index.store.stats

        def splade_stage(cb):
            pids_b, s_scores = self.run_splade_batch(
                list(cb.term_ids), list(cb.term_weights), p.first_k)
            return cb.with_state(pids_b=pids_b, s_scores=s_scores)

        if method == "splade":
            def fuse_splade(cb):
                s = cb.state
                return cb.evolve(pids=s["pids_b"][:, :cb.k],
                                 scores=s["s_scores"][:, :cb.k])

            stages = (Stage("splade_stage1", HOST, splade_stage),
                      Stage("fuse_splade", HOST, fuse_splade))
            return StagePlan(method=method, stages=stages,
                             access_stats=access)

        # rerank / hybrid: SPLADE candidates → residual gather → exact
        # MaxSim rescoring (+ α-fusion) → top-k
        def gather(cb):
            s = cb.state
            q, q_valid = pad_query_batch_host(cb.q_embs)
            codes, packed, valid = searcher.gather_tokens_batch(s["pids_b"])
            return cb.with_state(q=q, q_valid=q_valid, g_codes=codes,
                                 g_packed=packed, g_valid=valid)

        def device_inputs(cb):
            s = cb.state
            return searcher.to_device(s["q"], s["q_valid"], s["g_codes"],
                                      s["g_packed"], s["g_valid"],
                                      s["pids_b"] >= 0)

        def score(cb):
            q, q_valid, codes, packed, valid, mask = device_inputs(cb)
            c = searcher.score_gathered_lazy(q, q_valid, codes, packed,
                                             valid, mask)
            if method == "hybrid":
                (s_scores,) = searcher.to_device(cb.state["s_scores"])
                c = hybrid_mod.hybrid_scores(
                    s_scores, c, mask,
                    alpha=torch.as_tensor(cb.alphas, device=c.device),
                    normalizer=p.normalizer)
            return cb.with_state(final_dev=c)

        def fuse_split(cb):
            s = cb.state
            final = s["final_dev"].cpu().numpy()          # device sync
            order = np.argsort(-final, axis=1, kind="stable")[:, :cb.k]
            sorted_final = np.take_along_axis(final, order, axis=1)
            out_pids = np.where(
                sorted_final > -np.inf,
                np.take_along_axis(s["pids_b"], order, axis=1), -1)
            return cb.evolve(pids=out_pids, scores=sorted_final)

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
            return cb.with_state(top_s=top[0], top_i=top[1])

        def fuse_fused(cb):
            s = cb.state
            pids, scores = searcher.finalize_topk_fused(
                s["top_s"], s["top_i"], s["pids_b"])      # device sync
            return cb.evolve(pids=pids, scores=scores)

        # the launching stage opens the async window, the sync stage
        # closes it; each tail launches one hand-written kernel
        if self.rerank_backend == "fused":
            tail = (Stage("fused_rerank", DEVICE, score_fused,
                          opens_async=True, device_dispatches=1),
                    Stage("fused_rerank:sync", DEVICE, fuse_fused,
                          closes_async=True, device_dispatches=0))
        else:
            tail = (Stage("device_score:maxsim", DEVICE, score,
                          opens_async=True, device_dispatches=1),
                    Stage("fuse_topk", DEVICE, fuse_split,
                          closes_async=True, device_dispatches=0))
        stages = (Stage("splade_stage1", HOST, splade_stage),
                  Stage("host_gather:residuals", HOST, gather)) + tail
        return StagePlan(method=method, stages=stages, access_stats=access)

    # ------------------------------------------------------------------
    def search_batch(self, method, q_embs=None, term_ids=None,
                     term_weights=None, alpha=None, k: Optional[int] = None):
        """Cross-query batched retrieval.

        ``method``: one method name for the whole batch, or a sequence of
        per-query names (mixed batches are grouped and each group runs
        batched). ``q_embs``/``term_ids``/``term_weights``: per-query
        sequences (ragged lengths fine). ``alpha``: scalar, per-query
        sequence (None entries take the default), or None. Returns
        (pids (B, k), scores (B, k)); a group's columns past
        min(k, first_k) are (-1, -inf)."""
        p = self.params
        k = p.k if k is None else k
        n = len(q_embs) if q_embs is not None else len(term_ids)
        if not isinstance(method, str):
            methods = list(method)
            if len(set(methods)) > 1:
                return self._search_batch_mixed(methods, q_embs, term_ids,
                                                term_weights, alpha, k)
            method = methods[0]
        alphas = self._alpha_array(alpha, n)
        cb = self.build_batch(method, q_embs, term_ids, term_weights,
                              alphas, k, n)
        cb = self.compile_plan(method).run(cb, stats=self.pipeline_stats)
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
        Groups return min(k, first_k) columns — they fill the prefix,
        leaving the (-1, -inf) tail as padding."""
        w = pids.shape[1]
        out_pids[idx, :w] = pids
        out_scores[idx, :w] = scores

    def _search_batch_mixed(self, methods, q_embs, term_ids, term_weights,
                            alpha, k: int):
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
                term_weights=pick(term_weights), alpha=alphas[idx], k=k)
            self.scatter_group(out_pids, out_scores, idx, pids, scores)
        return out_pids, out_scores
