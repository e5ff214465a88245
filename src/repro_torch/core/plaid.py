"""Stage 4 of ColBERT-serve over the compressed ColBERTv2 index: exact
rescoring of given candidates.

The searcher gathers the candidates' residual codes from the
memory-mapped PagedStore on the host — one deduplicated gather per
micro-batch, the only stage that touches residual pages — and scores
them on ``device`` through the decompress+MaxSim kernels
(``kernels/csrc``). The centroid table and bucket weights move to the
device once, at construction.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core import hybrid as hybrid_mod
from repro_torch.index.builder import ColBERTIndex
from repro_torch.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores_batch)
from repro_torch.kernels.fused_rerank.ops import fused_rerank_topk_batch
from repro_torch.kernels.fused_rerank.ref import stable_topk


def pad_query_batch_host(q_embs):
    """Stack ragged queries on the host. q_embs: sequence of (Lq_i, d)
    arrays → ((B, Lq_pad, d) f32 zero-padded, (B, Lq_pad) bool
    validity); ``Lq_pad`` is the longest query's length."""
    arrs = [np.asarray(qe, np.float32) for qe in q_embs]
    d = arrs[0].shape[-1]
    lq_pad = max(a.shape[0] for a in arrs)
    q = np.zeros((len(arrs), lq_pad, d), np.float32)
    valid = np.zeros((len(arrs), lq_pad), bool)
    for i, a in enumerate(arrs):
        q[i, :a.shape[0]] = a
        valid[i, :a.shape[0]] = True
    return q, valid


def fused_hybrid_tail(q, packed, cids, valid, cand_mask, centroids,
                      bucket_weights, q_valid, s_scores, alphas, *,
                      nbits: int, k: int, normalizer: str):
    """Hybrid stage-4 tail on the device: decompress + MaxSim (kernel),
    α-interpolated normalised fusion with the stage-1 scores, and the
    per-query top-k by (score desc, index asc). The normaliser needs
    statistics over the full candidate list, so the hybrid tail scores
    all candidates before it selects. → (scores (B, k), idx (B, k))."""
    c = decompress_maxsim_scores_batch(
        q, packed, cids, valid, centroids, bucket_weights, nbits=nbits,
        q_valid=q_valid)
    c = c.masked_fill(~cand_mask, float("-inf"))
    final = hybrid_mod.hybrid_scores(s_scores, c, cand_mask, alpha=alphas,
                                     normalizer=normalizer)
    return stable_topk(final, k)


class PLAIDSearcher:
    """Host-tier searcher (the paper's mmap system): the pool stays in
    the PagedStore and the device sees only gathered candidates."""

    def __init__(self, index: ColBERTIndex, device="cuda"):
        self.index = index
        self.device = resolve_device(device)
        self.centroids = torch.as_tensor(
            np.asarray(index.centroids, np.float32), device=self.device)
        self.bucket_weights = torch.as_tensor(
            np.asarray(index.bucket_weights, np.float32), device=self.device)

    def to_device(self, *arrays):
        """Host arrays → tensors on the searcher's device."""
        return tuple(torch.as_tensor(np.asarray(a), device=self.device)
                     for a in arrays)

    # -- host gather -------------------------------------------------------
    def gather_tokens_batch(self, pids_b: np.ndarray):
        """Residual gather for (B, C) pids (−1 pad) → host (codes
        (B, C, Ld) i32, packed (B, C, Ld, pd) u8, valid (B, C, Ld)),
        through ONE PagedStore gather over the deduplicated pid set, so
        co-batched queries fault each index page at most once."""
        pids_b = np.asarray(pids_b)
        real = pids_b[pids_b >= 0]
        uniq = np.unique(real) if real.size else np.zeros(1, np.int64)
        codes_u, packed_u, valid_u = self.index.gather_doc_tokens(uniq)
        pos = np.searchsorted(uniq, np.clip(pids_b, 0, None))
        pos = np.minimum(pos, len(uniq) - 1)
        valid = valid_u[pos] & (pids_b >= 0)[..., None]
        return codes_u[pos], packed_u[pos], valid

    # -- device scoring ----------------------------------------------------
    def score_gathered_lazy(self, q, q_valid, codes, packed, valid,
                            cand_mask):
        """Exact scores of gathered candidates as a device tensor
        (B, C), -inf where ``cand_mask`` is False. Returns as soon as
        the kernel is launched; the first host read waits for it."""
        scores = decompress_maxsim_scores_batch(
            q, packed, codes, valid, self.centroids, self.bucket_weights,
            nbits=self.index.nbits, q_valid=q_valid)
        return scores.masked_fill(~cand_mask, float("-inf"))

    def fused_topk_gathered(self, q, q_valid, codes, packed, valid,
                            cand_mask, k: int):
        """Fused rerank tail: decompress + MaxSim + per-query top-k in ONE
        kernel launch (no (B, C) score tensor). → device (scores (B, kk),
        idx (B, kk) into the candidate axis), kk = min(k, C), equal bit
        for bit to :meth:`score_gathered_lazy` + a stable sort."""
        return fused_rerank_topk_batch(
            q, packed, codes, valid, cand_mask, self.centroids,
            self.bucket_weights, nbits=self.index.nbits,
            k=min(k, cand_mask.shape[1]), q_valid=q_valid)

    def fused_hybrid_topk_gathered(self, q, q_valid, codes, packed, valid,
                                   cand_mask, s_scores, alphas, k: int,
                                   normalizer: str):
        """Hybrid tail (see :func:`fused_hybrid_tail`). → device
        (scores (B, kk), idx (B, kk)), kk = min(k, C)."""
        return fused_hybrid_tail(
            q, packed, codes, valid, cand_mask, self.centroids,
            self.bucket_weights, q_valid, s_scores, alphas,
            nbits=self.index.nbits, k=min(k, cand_mask.shape[1]),
            normalizer=normalizer)

    @staticmethod
    def finalize_topk_fused(top_s, top_i, pids_b: np.ndarray):
        """Map a selected top-k back to pids on the host: (top_s (B, kk),
        top_i (B, kk)) device tensors → (pids (B, kk) int64 with -1 at
        -inf slots, scores (B, kk) f32). The host copy waits for the
        device."""
        s_np = top_s.cpu().numpy()
        i_np = top_i.cpu().numpy().astype(np.int64)
        pids = np.take_along_axis(np.asarray(pids_b),
                                  np.clip(i_np, 0, None), axis=1)
        return np.where(s_np > -np.inf, pids, -1), s_np
