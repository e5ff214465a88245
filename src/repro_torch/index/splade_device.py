"""Device-resident SPLADE stage 1: padded postings + batched scoring.

The host CSR index (`SpladeIndex`) is the mmap/PISA tier. For the
device tier the postings are materialised **once** into the fixed-shape
``as_padded`` layout — (V, max_df) int32 pids + uint8 impacts,
5·V·max_df bytes — and moved to ``device``. The kernel binary-searches
each row for a doc block's pids, so it reads a copy of each row sorted
stably by pid (−1 pads last). Untruncated rows of a built index come
out of the CSR index sorted already, and the copy is then the layout
itself; truncated rows keep their top impacts in no pid order (as may
the rows of an index made some other way), and the copy then costs
another 5·V·max_df bytes. Scoring a micro-batch is one
launch of the SPLADE kernel's top-k entry point: each block of docs
reads each query term's row by term id, keeps its best k, and the last
block of each query merges them into the query's top-k.

Exactness: terms with df > max_df keep only their top-``max_df``
impacts (the documented memory/exactness tradeoff). With
``max_df=None`` the true maximum df is used, and the scores then equal
the host scorer's bit for bit: the kernel adds each doc's entries in
the host's order, with the host's roundings; the stable pid sort of the
rows keeps that order for each doc.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import resolve_device, settle
from repro_torch.index.splade_index import SpladeIndex
from repro_torch.kernels.splade_score.ops import (sort_rows,
                                                  splade_row_topk_packed)


class SpladeDeviceCache:
    """Owns the padded-postings device tensors for one `SpladeIndex` and
    serves batched stage-1 queries against them. ``pids``/``imps`` are
    the ``as_padded`` layout; ``row_pids``/``row_imps`` its pid-sorted
    copy, which the kernel reads."""

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
        # the kernel's search is wrong on a row out of pid order
        key = pids.view(np.uint32)
        if (key[:, 1:] < key[:, :-1]).any():
            self.row_pids, self.row_imps = sort_rows(self.pids, self.imps)
        else:
            self.row_pids, self.row_imps = self.pids, self.imps
        self.quantum = float(index.quantum)
        self.n_docs = int(index.n_docs)
        # the rows' sort runs on the building thread's stream; pipeline
        # executors read them from theirs
        settle(self.device)

    def nbytes(self) -> int:
        """Bytes of the padded layout (``as_padded``)."""
        return int(self.pids.numel() * 4 + self.imps.numel())

    # ------------------------------------------------------------------
    def pad_queries(self, term_ids, term_weights):
        """Stack ragged per-query term lists into (B, Qt) arrays (−1 / 0
        padding), Qt the longest query's term count."""
        B = len(term_ids)
        vocab = self.pids.shape[0]
        ids, ws = _as_rows(term_ids), _as_rows(term_weights)
        lens = np.fromiter(map(len, ids), np.intp, B)
        w_lens = np.fromiter(map(len, ws), np.intp, B)
        qt = max(int(lens.max()) if B else 0, 1)
        if B and w_lens.max() > qt:
            raise ValueError(f"query {int(np.argmax(w_lens > qt))} has more "
                             f"weights than the longest query has terms "
                             f"({qt})")
        flat = (np.concatenate(ids) if B else np.zeros(0)).astype(np.int32)
        if flat.size and flat.max() >= vocab:
            # fail as loudly as the host CSR path would — a clamped
            # device gather would return plausible wrong scores
            i = int(np.searchsorted(np.cumsum(lens), np.argmax(flat >= vocab),
                                    side="right"))
            raise IndexError(f"term id {int(ids[i].max())} out of range "
                             f"for vocab {vocab} (query {i})")
        # a boolean mask assigns in row-major order: where a
        # concatenation of ragged rows lands
        cols = np.arange(qt)
        tids = np.full((B, qt), -1, np.int32)
        tids[cols < lens[:, None]] = flat
        w = np.zeros((B, qt), np.float32)
        if B:
            w[cols < w_lens[:, None]] = np.concatenate(ws)
        return tids, w

    def scaled_weights(self, tids: np.ndarray, w: np.ndarray):
        """(term rows (B, Qt) int32, −1 where a slot does not count;
        weights · quantum (B, Qt) f32, 0 there) — rounded as the host
        scorer rounds them (``w · f32(quantum)`` in fp32)."""
        dead = (tids < 0) | ~(w > 0)
        rows = tids.astype(np.int32)
        rows[dead] = -1
        scaled = np.multiply(w, np.float32(self.quantum), dtype=np.float32)
        scaled[dead] = 0
        return rows, scaled

    def upload(self, rows: np.ndarray, scaled: np.ndarray):
        """(rows, scaled weights) → the same on the device, in one
        host-to-device copy that does not wait (the weights travel as
        their int32 bits, through pinned memory on a CUDA device)."""
        host = torch.empty((2,) + rows.shape, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")
        both = host.numpy()
        both[0] = rows
        both[1] = scaled.view(np.int32)
        dev = host.to(self.device, non_blocking=True)
        return dev[0], dev[1].view(torch.float32)

    def dispatch_topk(self, term_ids, term_weights, k: int):
        """Launch the batched stage 1 and return it *lazy*: (the device
        top-k as one (2, B, k_eff) int32 tensor — pids, then score bits
        —, k_eff, B, k) with no host sync; the caller syncs through
        :meth:`finalize_topk`."""
        B = len(term_ids)
        tids, w = self.pad_queries(term_ids, term_weights)
        k_eff = min(k, self.n_docs)
        if not k_eff or not B:
            return None, 0, B, k
        rows, scaled = self.upload(*self.scaled_weights(tids, w))
        packed = splade_row_topk_packed(self.row_pids, self.row_imps, rows,
                                        scaled, n_docs=self.n_docs, k=k_eff)
        return packed, k_eff, B, k

    @staticmethod
    def finalize_topk(dispatched):
        """Sync a :meth:`dispatch_topk` result into the host
        (pids (B, k) int64, scores (B, k) f32), −1/0 padded like the
        host scorer; one device-to-host copy."""
        packed, k_eff, B, k = dispatched
        out_pids = np.full((B, k), -1, np.int64)
        out_scores = np.zeros((B, k), np.float32)
        if k_eff:
            both = packed.cpu().numpy()
            out_pids[:, :k_eff] = both[0]
            out_scores[:, :k_eff] = both[1].view(np.float32)
        return out_pids, out_scores

    def score_topk(self, term_ids, term_weights, k: int):
        """Batched stage 1 over the device postings. term_ids /
        term_weights: sequences of (Qt_i,) arrays (ragged fine) →
        (pids (B, k) int64, scores (B, k) f32), −1/0 padded like the
        host scorer. One kernel launch per call."""
        return self.finalize_topk(
            self.dispatch_topk(term_ids, term_weights, k))


def _as_rows(seq):
    """Each item of ``seq`` as a 1-D array (scalars and lists too); 1-D
    arrays pass as they are."""
    return [t if getattr(t, "ndim", 0) == 1 else np.ravel(t) for t in seq]
