"""Inverted file: centroid id → postings of passage ids (CSR)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IVF:
    pids: np.ndarray         # (total_postings,) int32, concatenated per centroid
    offsets: np.ndarray      # (K+1,) int64
    n_centroids: int


def build_ivf(token_cids: np.ndarray, token_pids: np.ndarray,
              n_centroids: int) -> IVF:
    """token_cids/token_pids: (n_tokens,) — centroid and passage of each
    token. A passage appears once per distinct centroid among its tokens,
    pid-ascending within a centroid's list."""
    cids = np.asarray(token_cids, np.int64)
    pids = np.asarray(token_pids, np.int64)
    # one int64 key per (cid, pid) pair: its sorted unique set is the
    # (cid, pid)-lexicographic order, without a 2-D row unique
    stride = int(pids.max()) + 1 if pids.size else 1
    keys = np.unique(cids * stride + pids)
    cids, pids = keys // stride, keys % stride
    counts = np.bincount(cids, minlength=n_centroids)
    offsets = np.zeros(n_centroids + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return IVF(pids=pids.astype(np.int32), offsets=offsets,
               n_centroids=n_centroids)
