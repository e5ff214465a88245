"""Merging top-k lists over a partition of the corpus.

Only :func:`merge_topk` so far: the live index merges the base index's
top-k with its delta segment's through it. The sharded retrievers that
merge per-shard lists with it come later.
"""

from __future__ import annotations

import numpy as np


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
