"""Plain PyTorch SPLADE impact scoring over padded postings: the
reference the CUDA kernel is held to (and what a CPU tensor runs).

Its summation order is part of the contract: each doc's entries are
added in (term slot ascending, posting slot ascending) order, starting
from +0.0 — the order of the host CSR scorer
(``SpladeIndex.score_batch_host``, one query-major ``np.add.at``). A
1-D ``index_add_`` on the CPU adds its entries one after another in
index order, so on the CPU this version equals the host scorer bit for
bit; on a CUDA tensor ``index_add_`` uses atomics and the order is
lost, which is why the serving path runs the kernel there.
"""

from __future__ import annotations

import torch


def splade_row_scores_batch_ref(row_pids, row_imps, rows, weights,
                                n_docs: int):
    """row_pids: (R, max_df) int (−1 pad); row_imps: (R, max_df) uint8
    or float; rows: (B, Qt) int, the posting row of each term slot (−1:
    empty slot); weights: (B, Qt) f32 → scores (B, n_docs) f32.

    scores[b, p] = Σ weights[b, t] · imp over the entries of row
    rows[b, t] whose pid is p; a slot counts only where its row is ≥ 0
    and its weight > 0, an entry only where 0 ≤ pid < n_docs. A pid
    repeated inside one row accumulates every entry."""
    B, Qt = rows.shape
    dev = row_pids.device
    live = (rows >= 0) & (weights > 0)                       # (B, Qt)
    safe = torch.where(live, rows, torch.zeros_like(rows)).long()
    pids = row_pids[safe].long()                             # (B, Qt, max_df)
    vals = weights.float()[..., None] * row_imps[safe].float()
    keep = live[..., None] & (pids >= 0) & (pids < n_docs)
    target = torch.arange(B, device=dev).view(B, 1, 1) * n_docs + pids
    out = torch.zeros(B * n_docs, dtype=torch.float32, device=dev)
    # boolean indexing keeps row-major (b, t, j) order
    out.index_add_(0, target[keep], vals[keep])
    return out.view(B, n_docs)


def splade_block_scores_batch_ref(post_pids, post_imps, term_weights,
                                  n_docs: int):
    """post_pids: (B, Qt, max_df) int (−1 pad); post_imps: (B, Qt,
    max_df); term_weights: (B, Qt) f32 → (B, n_docs) f32."""
    B, Qt, max_df = post_pids.shape
    rows = torch.arange(B * Qt, device=post_pids.device).view(B, Qt)
    return splade_row_scores_batch_ref(post_pids.reshape(B * Qt, max_df),
                                       post_imps.reshape(B * Qt, max_df),
                                       rows, term_weights, n_docs)


def splade_block_scores_ref(post_pids, post_imps, term_weights,
                            n_docs: int):
    """One query: (Qt, max_df) postings, (Qt,) weights → (n_docs,)."""
    return splade_block_scores_batch_ref(post_pids[None], post_imps[None],
                                         term_weights[None], n_docs)[0]
