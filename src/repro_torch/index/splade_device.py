"""Device-resident SPLADE stage 1: padded postings + batched scoring.

The host CSR index (`SpladeIndex`) is the mmap/PISA tier. For the
device tier the postings are materialised **once** into the fixed-shape
``as_padded`` layout — (V, max_df) int32 pids + uint8 impacts,
5·V·max_df bytes — and moved to ``device``. Scoring a micro-batch is
then one launch of the SPLADE kernel, which reads each query term's
posting row by term id, followed by a stable per-query top-k on the
device.

Exactness: terms with df > max_df keep only their top-``max_df``
impacts (the documented memory/exactness tradeoff). With
``max_df=None`` the true maximum df is used, and the scores then equal
the host scorer's bit for bit: the kernel adds each doc's entries in
the host's order, with the host's roundings.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.kernels.splade_score.ops import (splade_row_scores_batch,
                                                  topk_scores)


class SpladeDeviceCache:
    """Owns the padded-postings device tensors for one `SpladeIndex` and
    serves batched stage-1 queries against them."""

    def __init__(self, index: SpladeIndex, max_df: int | None = None,
                 device="cuda"):
        self.device = resolve_device(device)
        dfs = np.diff(index.term_offsets)
        true_max = int(dfs.max()) if len(dfs) else 1
        self.max_df = max(1, true_max if max_df is None
                          else min(int(max_df), true_max))
        self.truncated_terms = int((dfs > self.max_df).sum())
        pids, imps = index.as_padded(self.max_df)
        self.pids = torch.as_tensor(pids, device=self.device)
        self.imps = torch.as_tensor(imps, device=self.device)  # uint8
        self.quantum = float(index.quantum)
        self.n_docs = int(index.n_docs)

    def nbytes(self) -> int:
        return int(self.pids.numel() * 4 + self.imps.numel())

    # ------------------------------------------------------------------
    def pad_queries(self, term_ids, term_weights):
        """Stack ragged per-query term lists into (B, Qt) arrays (−1 / 0
        padding), Qt the longest query's term count."""
        B = len(term_ids)
        vocab = self.pids.shape[0]
        qt = max((len(np.atleast_1d(t)) for t in term_ids), default=1)
        tids = np.full((B, max(qt, 1)), -1, np.int32)
        w = np.zeros((B, max(qt, 1)), np.float32)
        for i in range(B):
            t = np.atleast_1d(np.asarray(term_ids[i], np.int32))
            tw = np.atleast_1d(np.asarray(term_weights[i], np.float32))
            if (t >= vocab).any():
                # fail as loudly as the host CSR path would — a clamped
                # device gather would return plausible wrong scores
                raise IndexError(f"term id {int(t.max())} out of range "
                                 f"for vocab {vocab} (query {i})")
            tids[i, :len(t)] = t
            w[i, :len(tw)] = tw
        return tids, w

    def scaled_weights(self, tids: np.ndarray, w: np.ndarray):
        """(term rows (B, Qt) int32, −1 where a slot does not count;
        weights · quantum (B, Qt) f32, 0 there) — rounded as the host
        scorer rounds them (``w · f32(quantum)`` in fp32)."""
        live = (tids >= 0) & (w > 0)
        rows = np.where(live, tids, -1).astype(np.int32)
        scaled = (np.where(live, w, np.float32(0))
                  * np.float32(self.quantum)).astype(np.float32)
        return rows, scaled

    def dispatch_topk(self, term_ids, term_weights, k: int):
        """Launch the batched stage 1 and return it *lazy*: (device
        pids, device scores, k_eff, B, k) with no host sync; the caller
        syncs through :meth:`finalize_topk`."""
        B = len(term_ids)
        tids, w = self.pad_queries(term_ids, term_weights)
        k_eff = min(k, self.n_docs)
        if not k_eff or not B:
            return None, None, 0, B, k
        rows, scaled = self.scaled_weights(tids, w)
        scores = splade_row_scores_batch(
            self.pids, self.imps, torch.as_tensor(rows, device=self.device),
            torch.as_tensor(scaled, device=self.device), n_docs=self.n_docs)
        pids, top = topk_scores(scores, k_eff)
        return pids, top, k_eff, B, k

    @staticmethod
    def finalize_topk(dispatched):
        """Sync a :meth:`dispatch_topk` result into the host
        (pids (B, k) int64, scores (B, k) f32), −1/0 padded like the
        host scorer."""
        pids, scores, k_eff, B, k = dispatched
        out_pids = np.full((B, k), -1, np.int64)
        out_scores = np.zeros((B, k), np.float32)
        if k_eff:
            out_pids[:, :k_eff] = pids.cpu().numpy()
            out_scores[:, :k_eff] = scores.cpu().numpy()
        return out_pids, out_scores

    def score_topk(self, term_ids, term_weights, k: int):
        """Batched stage 1 over the device postings. term_ids /
        term_weights: sequences of (Qt_i,) arrays (ragged fine) →
        (pids (B, k) int64, scores (B, k) f32), −1/0 padded like the
        host scorer. One kernel launch per call."""
        return self.finalize_topk(
            self.dispatch_topk(term_ids, term_weights, k))
