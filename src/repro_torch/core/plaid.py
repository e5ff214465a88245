"""PLAID multi-stage search over the compressed ColBERTv2 index.

Stages (Santhanam et al., CIKM'22):
  1. centroid probe: S_c = Q · Cᵀ, top-``nprobe`` centroids per query
     token;
  2. candidate generation from the IVF;
  3. approximate scoring by centroid interaction (codes only, no
     residual access);
  4. residual decompression + exact MaxSim for the ``ndocs`` survivors.

Stages 1–3 run on ``device`` as PyTorch ops (they have no kernel of
their own); stage 4 runs the decompress+MaxSim kernels
(``kernels/csrc``), which also rescore the given candidates of the
``rerank`` and ``hybrid`` methods. In the paper's mmap system (the
default) the pool stays in the PagedStore and the host gathers codes for
stage 3 and residuals for stage 4, one deduplicated gather per
micro-batch; with ``device_resident=True`` (the in-memory ColBERTv2
baseline) the pool is held on the device and gathered there. The
centroid table and bucket weights move to the device once, at
construction; the padded IVF once, when stage 2 first needs it.
"""

from __future__ import annotations

import dataclasses
import functools
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.common import resolve_device, settle
from repro_torch.core import hybrid as hybrid_mod
from repro_torch.index.builder import ColBERTIndex
from repro_torch.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores_batch)
from repro_torch.kernels.fused_rerank.ops import fused_rerank_topk_batch
from repro_torch.kernels.fused_rerank.ref import stable_topk

# bytes of stage 3's (rows, Lq, C, Ld) f32 gather, per chunk of query
# rows: 2 rows (189 MB) at Lq=32, C=4,096, Ld=180
APPROX_CHUNK_BYTES = 256 << 20


@dataclasses.dataclass(frozen=True)
class PlaidParams:
    nprobe: int = 4
    candidate_cap: int = 4096    # max candidate pids after stage 2
    ndocs: int = 256             # survivors entering exact scoring
    k: int = 100                 # final results


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


def topk_host(scores: np.ndarray, pids_b: np.ndarray, k: int):
    """Host top-k of (B, C) scores by (score desc, candidate index asc)
    → (pids (B, min(k, C)) with -1 at -inf slots, scores (B, min(k,
    C)))."""
    order = np.argsort(-scores, axis=1, kind="stable")[:, :k]
    top = np.take_along_axis(scores, order, axis=1)
    pids = np.take_along_axis(np.asarray(pids_b), order, axis=1)
    return np.where(top > -np.inf, pids, -1), top


def pad_topk_host(pids: np.ndarray, scores: np.ndarray, k: int):
    """(B, kk) host top-k → (B, k), padded with (-1, -inf) past kk."""
    B, kk = pids.shape
    out_pids = np.full((B, k), -1, np.int64)
    out_scores = np.full((B, k), -np.inf, np.float32)
    out_pids[:, :kk] = pids
    out_scores[:, :kk] = scores
    return out_pids, out_scores


# --------------------------------------------------------------------------
# stages 1-3 (batched over queries)
# --------------------------------------------------------------------------

def check_ieee_fp32():
    """Raise unless float32 matmuls run in IEEE fp32. TF32 would move
    probe scores by ~1e-3 and change which centroids are probed.

    Where torch has ``torch.backends.cuda.matmul.fp32_precision`` that
    setting is read first (the legacy setters update it too, and reading
    the legacy flags after the new API was used raises): it must be
    ``"ieee"``, or ``"none"`` with the legacy flags off. Older torch has
    only the legacy flags."""
    matmul = torch.backends.cuda.matmul
    precision = getattr(matmul, "fp32_precision", None)
    if precision == "ieee":
        return
    if precision not in (None, "none"):
        raise RuntimeError(
            "the centroid probe needs IEEE fp32 matmuls, but TF32 is "
            "allowed (torch.backends.cuda.matmul.fp32_precision="
            f"{precision!r}); set it to 'ieee'")
    if (matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the centroid probe needs IEEE fp32 matmuls, but TF32 is "
            "allowed (torch.backends.cuda.matmul.allow_tf32="
            f"{torch.backends.cuda.matmul.allow_tf32}, "
            "float32_matmul_precision="
            f"{torch.get_float32_matmul_precision()!r}); set "
            "allow_tf32=False and precision 'highest'")


def topk_ordered(x: torch.Tensor, k: int):
    """``stable_topk``'s answer — the top-``k`` along the last axis by
    (value desc, index asc) — without sorting whole rows: ``torch.topk``
    finds the k-th value, every element above it is taken in that order,
    and the elements equal to it fill the remaining places lowest index
    first. → (values, int64 indices)."""
    n = x.shape[-1]
    vals, idx = torch.topk(x, k, dim=-1)
    # the k taken, by (value desc, index asc)
    idx, perm = torch.sort(idx, dim=-1)
    vals = vals.gather(-1, perm)
    vals, perm = torch.sort(vals, dim=-1, descending=True, stable=True)
    idx = idx.gather(-1, perm)
    kth = vals[..., -1:]
    # the lowest indices of every element equal to the k-th value (exact
    # as float keys while n <= 2^24)
    pos = torch.arange(n, device=x.device, dtype=torch.float32)
    tie_key = torch.where(x == kth, -pos, float("-inf"))
    ties = torch.topk(tie_key, k, dim=-1).indices
    n_above = (vals > kth).sum(-1, keepdim=True)
    place = torch.arange(k, device=x.device)
    from_ties = ties.gather(-1, (place - n_above).clamp_min(0))
    above = place < n_above
    return (torch.where(above, vals, kth), torch.where(above, idx, from_ties))


def stage1_centroid_probe_batch(q, q_valid, centroids, nprobe: int):
    """q (B, Lq, d), q_valid (B, Lq), centroids (K, d) → (scores_c
    (B, Lq, K) f32, cids (B, Lq, nprobe) int32)."""
    check_ieee_fp32()
    B, Lq, d = q.shape
    s = torch.matmul(q.reshape(B * Lq, d), centroids.T).view(B, Lq, -1)
    _, cids = topk_ordered(s, nprobe)
    # padded query tokens must not widen the candidate set: they take
    # the first (always real) token's probes, which add nothing new
    cids = torch.where(q_valid[..., None], cids, cids[:, :1, :])
    return s, cids.to(torch.int32)


def stage2_candidates_batch(ivf_padded, cids, cap: int):
    """ivf_padded (K, P) int32 (-1 fill); cids (B, Lq, nprobe) → (B, cap)
    int32: the smallest ``cap`` real pids of each row's union of
    postings, ascending, -1 fill at the back — what the reference's
    ``unique(size=cap + 1, fill_value=-1)`` keeps (not the best pids)."""
    B = cids.shape[0]
    cand = ivf_padded[cids.reshape(B, -1).long()].reshape(B, -1)
    top = torch.iinfo(torch.int32).max      # sorts after every real pid
    keys = torch.where(cand >= 0, cand, top)
    if keys.shape[1] < cap:
        keys = torch.nn.functional.pad(keys, (0, cap - keys.shape[1]),
                                       value=top)
    keys = torch.sort(keys, dim=-1).values
    repeat = torch.zeros_like(keys, dtype=torch.bool)
    repeat[:, 1:] = keys[:, 1:] == keys[:, :-1]
    keys = torch.sort(keys.masked_fill(repeat, top), dim=-1).values[:, :cap]
    return keys.masked_fill(keys == top, -1)


def stage3_approx_score_batch(scores_c, codes, valid, q_valid):
    """Centroid interaction: scores_c (B, Lq, K); codes/valid (B, C, Ld);
    q_valid (B, Lq) → (B, C) f32: per query token the best centroid
    score over the doc's valid tokens (0 for a doc with none), summed
    over the real query tokens in token order.

    The (Lq, C, Ld) gather per query is made ``APPROX_CHUNK_BYTES`` of
    query rows at a time."""
    B, Lq, _ = scores_c.shape
    C, Ld = codes.shape[1:]
    per_q = torch.empty((B, Lq, C), dtype=torch.float32,
                        device=scores_c.device)
    rows = max(1, APPROX_CHUNK_BYTES // max(1, Lq * C * Ld * 4))
    for lo in range(0, B, rows):
        hi = min(B, lo + rows)
        idx = codes[lo:hi].reshape(hi - lo, 1, C * Ld).long()
        s = torch.gather(scores_c[lo:hi], 2, idx.expand(-1, Lq, -1))
        s = s.view(hi - lo, Lq, C, Ld).masked_fill_(~valid[lo:hi, None],
                                                    -1e30)
        per_q[lo:hi] = s.amax(dim=-1)
    per_q = per_q.masked_fill_(per_q <= -1e29, 0.0)
    per_q *= q_valid[..., None].to(torch.float32)
    # a fixed order, whatever the batch: token by token
    out = per_q[:, 0].clone()
    for t in range(1, Lq):
        out += per_q[:, t]
    return out


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


# --------------------------------------------------------------------------
# orchestrator
# --------------------------------------------------------------------------

class PLAIDSearcher:
    """Full PLAID (:meth:`search_batch`) and stage-4 rescoring of given
    candidates (:meth:`rerank_batch`), in mmap mode (host gathers from
    the PagedStore) or with the pool resident on ``device``."""

    def __init__(self, index: ColBERTIndex,
                 params: PlaidParams = PlaidParams(),
                 device_resident: bool = False, device="cuda"):
        self.index = index
        self.params = params
        self.device = resolve_device(device)
        self.centroids = torch.as_tensor(
            np.asarray(index.centroids, np.float32), device=self.device)
        self.bucket_weights = torch.as_tensor(
            np.asarray(index.bucket_weights, np.float32), device=self.device)
        self.device_resident = device_resident
        self._build_lock = threading.Lock()
        if device_resident:
            store = index.store
            # copies: the mmap pool is read-only
            self.dev_codes = torch.as_tensor(np.array(store.codes),
                                             device=self.device)
            self.dev_residuals = torch.as_tensor(np.array(store.residuals),
                                                 device=self.device)
            self.dev_offsets = torch.as_tensor(index.doc_offsets,
                                               device=self.device)
            self.dev_doclens = torch.as_tensor(index.doclens,
                                               device=self.device)
        settle(self.device)

    @functools.cached_property
    def ivf_padded(self) -> torch.Tensor:
        """The IVF as (K, longest list) int32 rows with -1 fill, on the
        device; built when stage 2 first runs, so a retriever that serves
        only the SPLADE methods never holds it. Built once under a lock
        (two pipeline workers may ask at once) and complete before any
        stream reads it."""
        with self._build_lock:
            padded = vars(self).get("ivf_padded")
            if padded is None:
                padded = torch.as_tensor(self.index.ivf.as_padded(),
                                         device=self.device)
                settle(self.device)
                # stored before the lock is let go, so that a second
                # caller waiting on it finds the tensor
                vars(self)["ivf_padded"] = padded
            return padded

    def to_device(self, *arrays):
        """Host arrays (or tensors) → tensors on the searcher's device."""
        return tuple(torch.as_tensor(
            a if isinstance(a, torch.Tensor) else np.asarray(a),
            device=self.device) for a in arrays)

    # -- stages 1-3 --------------------------------------------------------
    def probe_batch(self, q_embs) -> dict:
        """Stages 1-2: stack ragged queries, probe the centroids and
        generate each query's candidates. → device tensors {q, q_valid,
        scores_c, cids, cand (B, cap)}."""
        p = self.params
        q, q_valid = self.to_device(*pad_query_batch_host(q_embs))
        scores_c, cids = stage1_centroid_probe_batch(
            q, q_valid, self.centroids, p.nprobe)
        cand = stage2_candidates_batch(self.ivf_padded, cids,
                                       p.candidate_cap)
        return {"q": q, "q_valid": q_valid, "scores_c": scores_c,
                "cids": cids, "cand": cand}

    def gather_codes_batch(self, cand):
        """Codes-only gather of (B, C) candidates (-1 pad) for stage 3 →
        (codes (B, C, Ld) int32, valid (B, C, Ld)): host arrays from the
        PagedStore, never faulting a residual page, for host ``cand``; on
        the device when the pool is resident."""
        if self.device_resident:
            codes, _, valid = self._gather_device_batch(cand,
                                                        codes_only=True)
            return codes, valid
        codes, _, valid = self._dedup_gather(cand, codes_only=True)
        return codes, valid

    def approx_select_batch(self, scores_c, codes, valid, q_valid, cand):
        """Stage 3 (device): centroid-interaction scores → the (B, ndocs)
        survivors entering exact scoring, by (score desc, candidate index
        asc), -1 where fewer candidates are real."""
        approx = stage3_approx_score_batch(scores_c, codes, valid, q_valid)
        approx = approx.masked_fill(cand < 0, float("-inf"))
        ndocs = min(self.params.ndocs, self.params.candidate_cap)
        _, keep = stable_topk(approx, ndocs)
        return torch.gather(cand, 1, keep)

    # -- gathers -----------------------------------------------------------
    def gather_tokens_batch(self, pids_b):
        """Residual gather for (B, C) pids (−1 pad) → (codes (B, C, Ld)
        i32, packed (B, C, Ld, pd) u8, valid (B, C, Ld)): host arrays
        through ONE PagedStore gather over the deduplicated pid set, so
        co-batched queries fault each index page at most once; on the
        device when the pool is resident."""
        if self.device_resident:
            return self._gather_device_batch(pids_b)
        return self._dedup_gather(pids_b, codes_only=False)

    def _dedup_gather(self, pids_b: np.ndarray, *, codes_only: bool):
        pids_b = np.asarray(pids_b)
        real = pids_b[pids_b >= 0]
        uniq = np.unique(real) if real.size else np.zeros(1, np.int64)
        if codes_only:
            codes_u, valid_u = self.index.gather_doc_codes(uniq)
            packed_u = None
        else:
            codes_u, packed_u, valid_u = self.index.gather_doc_tokens(uniq)
        pos = np.searchsorted(uniq, np.clip(pids_b, 0, None))
        pos = np.minimum(pos, len(uniq) - 1)
        valid = valid_u[pos] & (pids_b >= 0)[..., None]
        return (codes_u[pos], None if packed_u is None else packed_u[pos],
                valid)

    def _gather_device_batch(self, pids, *, codes_only: bool = False):
        """The resident pool's rows of (B, C) pids, gathered on the
        device; pids clamp at n_docs - 1 and token rows at n_tokens - 1,
        as the host gather's do."""
        idx = self.index
        (pids,) = self.to_device(pids)
        pids = pids.long()
        safe = pids.clamp(0, idx.n_docs - 1)
        pos = torch.arange(idx.doc_maxlen, device=self.device)
        tok = (self.dev_offsets[safe][..., None] + pos).clamp_max(
            idx.store.n_tokens - 1)
        codes = self.dev_codes[tok]
        packed = None if codes_only else self.dev_residuals[tok]
        valid = (pos < self.dev_doclens[safe][..., None]) \
            & (pids >= 0)[..., None]
        return codes, packed, valid

    # -- stage 4 -----------------------------------------------------------
    def exact_score_gathered(self, q, q_valid, codes, packed, valid,
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
        for bit to :meth:`exact_score_gathered` + a stable sort."""
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
    def finalize_topk_fused(top_s: np.ndarray, top_i: np.ndarray,
                            pids_b: np.ndarray):
        """Map a selected top-k back to pids on the host: (top_s (B, kk),
        top_i (B, kk)) host copies of the device top-k → (pids (B, kk)
        int64 with -1 at -inf slots, scores (B, kk) f32)."""
        pids = np.take_along_axis(
            np.asarray(pids_b), np.clip(top_i.astype(np.int64), 0, None),
            axis=1)
        return np.where(top_s > -np.inf, pids, -1), top_s

    @staticmethod
    def finalize_topk(exact, pids_b: np.ndarray, k: int):
        """Split tail's selection (the serving plan's too): device (B, C)
        exact scores → host (pids (B, k), scores (B, k)) by (score desc,
        candidate index asc), padded with (-1, -inf) past min(k, C). The
        host copy waits for the device."""
        return pad_topk_host(*topk_host(exact.cpu().numpy(), pids_b, k), k)

    # -- full PLAID --------------------------------------------------------
    def search_batch(self, q_embs, k: Optional[int] = None):
        """Stages 1-4 over a micro-batch. q_embs: sequence of (Lq_i, d)
        arrays (ragged lengths fine). → (pids (B, k) int64, scores (B, k)
        f32, [{"candidates": real candidates after the cap}] per query),
        padded with (-1, -inf) past min(k, ndocs)."""
        k = self.params.k if k is None else k
        st = self.probe_batch(q_embs)
        cand = st["cand"] if self.device_resident else st["cand"].cpu().numpy()
        codes, valid = self.to_device(*self.gather_codes_batch(cand))
        final = self.approx_select_batch(st["scores_c"], codes, valid,
                                         st["q_valid"], st["cand"])
        final_np = final.cpu().numpy()
        f_codes, f_packed, f_valid = self.to_device(*self.gather_tokens_batch(
            final if self.device_resident else final_np))
        exact = self.exact_score_gathered(st["q"], st["q_valid"], f_codes,
                                          f_packed, f_valid, final >= 0)
        pids, scores = self.finalize_topk(exact, final_np, k)
        n_real = (st["cand"] >= 0).sum(dim=1).tolist()
        return pids, scores, [{"candidates": int(n)} for n in n_real]

    def search(self, q_emb, k: Optional[int] = None):
        """One query (Lq, d) → (pids (k,), scores (k,), aux): a batch of
        one."""
        pids, scores, aux = self.search_batch([q_emb], k)
        return pids[0], scores[0], aux[0]

    # -- stage 4 on given candidates -----------------------------------
    def rerank_batch(self, q_embs, pids):
        """Exact MaxSim for per-query candidate lists. pids: (B, C) (−1
        pad) → host scores (B, C) aligned with pids, -inf at pads: one
        deduplicated gather and one scoring launch."""
        pids = np.asarray(pids)
        q, q_valid = self.to_device(*pad_query_batch_host(q_embs))
        codes, packed, valid = self.to_device(*self.gather_tokens_batch(
            pids))
        (mask,) = self.to_device(pids >= 0)
        return self.exact_score_gathered(q, q_valid, codes, packed, valid,
                                         mask).cpu().numpy()

    def rerank(self, q_emb, pids):
        """One query: pids (C,) → scores (C,): a batch of one."""
        return self.rerank_batch([q_emb], np.asarray(pids)[None])[0]
