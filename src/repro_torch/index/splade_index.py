"""Impact-ordered inverted index for SPLADE — the PISA adaptation.

Postings are stored CSR by term with uint8-quantised impacts and scored
term-at-a-time on the host with vectorised numpy (the first stage of
the serving path). The file set is the JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np


def _topk_rows(scores: np.ndarray, k: int):
    """Row-wise descending top-k. scores: (B, n) → (pids (B, k) int64,
    scores (B, k) f32); rows are padded with (−1, 0) when k > n.

    Ties are broken by ascending pid — the order every selection in
    this package uses, and the property that makes disjoint top-k lists
    merge into exactly the single-index ranking (quantised uint8 impacts
    tie often, so an unstable partition here would make candidate sets
    irreproducible). Selection stays O(n) per row: partition for the k-th
    value, keep everything above it, and fill the boundary from the
    pid-ascending scan of its ties — only the k survivors are sorted.
    """
    B, n = scores.shape
    k_eff = min(k, n)
    out_pids = np.full((B, k), -1, np.int64)
    out_scores = np.zeros((B, k), np.float32)
    if k_eff:
        if k_eff < n:
            kth = np.partition(scores, n - k_eff, axis=1)[:, n - k_eff,
                                                          None]
            above = scores > kth
            n_above = above.sum(axis=1, keepdims=True)
            ties = scores == kth
            keep = ties & (np.cumsum(ties, axis=1) <= k_eff - n_above)
            sel_mask = above | keep
        else:
            sel_mask = np.ones((B, n), bool)
        # nonzero scans row-major → exactly k_eff pids per row, ascending
        sel = np.nonzero(sel_mask)[1].reshape(B, k_eff)
        vals = np.take_along_axis(scores, sel, axis=1)
        order = np.argsort(-vals, axis=1, kind="stable")
        out_pids[:, :k_eff] = np.take_along_axis(sel, order, axis=1)
        out_scores[:, :k_eff] = np.take_along_axis(vals, order, axis=1)
    return out_pids, out_scores


@dataclasses.dataclass
class SpladeIndex:
    term_offsets: np.ndarray   # (V+1,) int64
    pids: np.ndarray           # (nnz,) int32  (pid-ascending within term)
    impacts: np.ndarray        # (nnz,) uint8
    quantum: float             # impact = quantum * uint8
    n_docs: int
    vocab: int

    # ------------------------------------------------------------------
    def df(self, term: int) -> int:
        return int(self.term_offsets[term + 1] - self.term_offsets[term])

    def score_host(self, term_ids: np.ndarray, term_weights: np.ndarray,
                   k: int = 200):
        """Term-at-a-time exact scoring on the host (the PISA stand-in).

        term_ids: (Qt,) int32; term_weights: (Qt,) float32 (0 padding ok).
        Returns (pids (k,), scores (k,)) sorted desc; -1 padded."""
        scores = np.zeros(self.n_docs, np.float32)
        for t, w in zip(term_ids, term_weights):
            if w <= 0 or t < 0:
                continue
            s, e = self.term_offsets[t], self.term_offsets[t + 1]
            if e > s:
                # np.add.at, not fancy-index +=: a pid repeated within a
                # term's postings must accumulate both impacts
                np.add.at(scores, self.pids[s:e],
                          np.float32(w * self.quantum)
                          * self.impacts[s:e].astype(np.float32))
        pids, top_scores = _topk_rows(scores[None], k)
        return pids[0], top_scores[0]

    def score_batch_host(self, term_ids, term_weights, k: int = 200,
                         exclude=None):
        """Vectorised multi-query host scoring (the no-device/mmap tier).

        term_ids/term_weights: sequences of (Qt_i,) arrays (ragged fine).
        One pass over the union of the batch's query terms: postings of
        each distinct term are gathered from the (possibly mmap'd) CSR
        arrays exactly once, then scattered into a (B, n_docs) score
        matrix with a single ``np.add.at`` — no per-query Python loop.
        Peak memory is ``4·B·n_docs`` bytes (vs one (n_docs,) vector per
        query sequentially) — size ``max_batch`` accordingly on very
        large host-tier corpora.

        ``exclude``: optional array of pids masked out *before* the
        top-k (live-index tombstones). Exclusion must happen pre-top-k
        so a tombstoned doc cannot displace a survivor from the k list
        — that is what keeps the filtered ranking identical to an index
        that never contained the doc. Legit scores are ≥ 0 (weights and
        impacts are non-negative), so excluded docs are marked with a
        negative sentinel and scrubbed to (-1, 0.0) pads afterwards.
        Returns (pids (B, k), scores (B, k)) sorted desc; -1 padded."""
        B = len(term_ids)
        scores = np.zeros((B, self.n_docs), np.float32)
        # flatten valid (query, term, weight) triples, query-major so the
        # scatter accumulates in the same order as per-query score_host
        qidx, terms, weights = [], [], []
        for i in range(B):
            t = np.asarray(term_ids[i]).astype(np.int64, copy=False)
            w = np.asarray(term_weights[i]).astype(np.float32, copy=False)
            keep = (w > 0) & (t >= 0)
            qidx.append(np.full(int(keep.sum()), i, np.int64))
            terms.append(t[keep])
            weights.append(w[keep])
        qidx = np.concatenate(qidx) if qidx else np.zeros(0, np.int64)
        terms = np.concatenate(terms) if terms else np.zeros(0, np.int64)
        weights = (np.concatenate(weights) if weights
                   else np.zeros(0, np.float32))
        if len(terms):
            # gather the union of posting lists once (one mmap touch per
            # distinct term even when co-batched queries share terms)
            uniq, inv = np.unique(terms, return_inverse=True)
            u_starts = self.term_offsets[uniq]
            u_lens = (self.term_offsets[uniq + 1] - u_starts).astype(np.int64)
            total = int(u_lens.sum())
            u_local = np.arange(total) - np.repeat(
                np.cumsum(u_lens) - u_lens, u_lens)
            u_flat = np.repeat(u_starts, u_lens) + u_local
            u_pids = np.asarray(self.pids[u_flat]).astype(np.int64,
                                                          copy=False)
            u_imps = self.impacts[u_flat].astype(np.float32)
            # expand per (query, term) entry into the gathered buffer
            u_offs = np.cumsum(u_lens) - u_lens        # term start in buffer
            e_lens = u_lens[inv]
            e_total = int(e_lens.sum())
            e_local = np.arange(e_total) - np.repeat(
                np.cumsum(e_lens) - e_lens, e_lens)
            e_src = np.repeat(u_offs[inv], e_lens) + e_local
            scale = (weights * np.float32(self.quantum)).astype(np.float32)
            vals = np.repeat(scale, e_lens) * u_imps[e_src]
            flat_target = np.repeat(qidx, e_lens) * self.n_docs \
                + u_pids[e_src]
            np.add.at(scores.reshape(-1), flat_target, vals)
        exclude = None if exclude is None else np.asarray(exclude, np.int64)
        if exclude is not None and exclude.size:
            scores[:, exclude] = -1.0
        pids, top = _topk_rows(scores, k)
        if exclude is not None and exclude.size:
            bad = top < 0
            pids[bad] = -1
            top[bad] = 0.0
        return pids, top

    # ------------------------------------------------------------------
    def as_padded(self, max_df: int):
        """Fixed-shape postings for the device stage 1: (V, max_df) pids
        (−1 fill) + impacts, each term's postings in CSR order. Terms
        with df > max_df keep their top-impact postings (a documented
        approximation: the device scores are then a lower bound)."""
        V = self.vocab
        pids = np.full((V, max_df), -1, np.int32)
        imps = np.zeros((V, max_df), np.uint8)
        for t in range(V):
            s, e = self.term_offsets[t], self.term_offsets[t + 1]
            if e <= s:
                continue
            p, i = self.pids[s:e], self.impacts[s:e]
            if e - s > max_df:
                keep = np.argpartition(i, -(max_df))[-max_df:]
                p, i = p[keep], i[keep]
            pids[t, :len(p)] = p
            imps[t, :len(p)] = i
        return pids, imps

    # ------------------------------------------------------------------
    def save(self, path):
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        np.save(path / "term_offsets.npy", self.term_offsets)
        self.pids.tofile(path / "postings_pids.bin")
        self.impacts.tofile(path / "postings_imps.bin")
        (path / "meta.json").write_text(json.dumps({
            "quantum": self.quantum, "n_docs": self.n_docs,
            "vocab": self.vocab, "nnz": int(len(self.pids))}))

    @classmethod
    def load(cls, path, mmap: bool = False):
        path = pathlib.Path(path)
        meta = json.loads((path / "meta.json").read_text())
        if mmap:
            pids = np.memmap(path / "postings_pids.bin", np.int32, "r")
            imps = np.memmap(path / "postings_imps.bin", np.uint8, "r")
        else:
            pids = np.fromfile(path / "postings_pids.bin", np.int32)
            imps = np.fromfile(path / "postings_imps.bin", np.uint8)
        return cls(term_offsets=np.load(path / "term_offsets.npy"),
                   pids=pids, impacts=imps, quantum=meta["quantum"],
                   n_docs=meta["n_docs"], vocab=meta["vocab"])


def build_splade_index(doc_term_ids: np.ndarray, doc_term_weights: np.ndarray,
                       vocab: int, n_docs: int,
                       quantum: float | None = None) -> SpladeIndex:
    """doc_term_ids/weights: (n_docs, T) top-T sparse representations
    (0-weight entries ignored). ``quantum`` pins an externally-chosen
    quantisation step (live-index delta segments and rebuild-parity
    oracles must quantise with the *base* index's quantum so impacts
    stay bitwise comparable); default derives it from this corpus."""
    rows, cols = np.nonzero(doc_term_weights > 0)
    terms = doc_term_ids[rows, cols].astype(np.int64)
    weights = doc_term_weights[rows, cols].astype(np.float32)
    pids = rows.astype(np.int32)

    if quantum is None:
        quantum = float(weights.max()) / 255.0 if len(weights) else 1.0
    imps = np.clip(np.round(weights / max(quantum, 1e-9)), 1, 255).astype(np.uint8)

    order = np.lexsort((pids, terms))
    terms, pids, imps = terms[order], pids[order], imps[order]
    counts = np.bincount(terms, minlength=vocab)
    offsets = np.zeros(vocab + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return SpladeIndex(term_offsets=offsets, pids=pids, impacts=imps,
                       quantum=quantum, n_docs=n_docs, vocab=vocab)
