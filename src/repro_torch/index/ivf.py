"""Inverted file: centroid id → postings of passage ids (CSR)."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class IVF:
    pids: np.ndarray         # (total_postings,) int32, concatenated per centroid
    offsets: np.ndarray      # (K+1,) int64
    n_centroids: int

    def max_list_len(self) -> int:
        return int(np.max(np.diff(self.offsets))) if len(self.pids) else 0

    def as_padded(self, pad_to: int | None = None) -> np.ndarray:
        """Dense (K, pad) int32 with -1 fill, each list cut at ``pad``
        (default the longest list) — the device-resident form."""
        pad = pad_to or self.max_list_len()
        lens = np.minimum(np.diff(self.offsets), pad)
        rows = np.repeat(np.arange(self.n_centroids), lens)
        # a posting's slot in its row: its place in the flat kept list
        # minus the row's first place there
        first = np.cumsum(lens) - lens
        cols = np.arange(len(rows)) - np.repeat(first, lens)
        out = np.full((self.n_centroids, pad), -1, np.int32)
        out[rows, cols] = self.pids[self.offsets[rows] + cols]
        return out


def build_ivf(token_cids: np.ndarray, token_pids: np.ndarray,
              n_centroids: int) -> IVF:
    """token_cids/token_pids: (n_tokens,) — centroid and passage of each
    token. A passage appears once per distinct centroid among its tokens,
    pid-ascending within a centroid's list."""
    cids = np.asarray(token_cids, np.int64)
    pids = np.asarray(token_pids, np.int64)
    # one int64 key per (cid, pid) pair: its sorted unique set is the
    # (cid, pid)-lexicographic order, without a 2-D row unique. A sort
    # and a mask, not np.unique: from numpy 2.3 on it finds uniques with
    # a hash table, over an order of magnitude slower than the sort on
    # millions of mostly distinct keys
    stride = int(pids.max()) + 1 if pids.size else 1
    keys = np.sort(cids * stride + pids)
    first = np.ones(keys.size, bool)
    first[1:] = keys[1:] != keys[:-1]
    keys = keys[first]
    cids, pids = keys // stride, keys % stride
    counts = np.bincount(cids, minlength=n_centroids)
    offsets = np.zeros(n_centroids + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return IVF(pids=pids.astype(np.int32), offsets=offsets,
               n_centroids=n_centroids)
