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
import torch.nn.functional as F

from repro_torch.kernels.fused_rerank.ref import stable_topk


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


def block_topk_ref(scores, k: int, block_d: int):
    """The top-k launch's per-block candidates from (B, n_docs) scores:
    for each block of ``block_d`` docs, its kb = min(k, docs in block)
    docs of rank < kb by (score desc, pid asc), in pid order, then
    (−inf, −1) up to min(k, block_d) → (scores, int32 pids), each
    (B, n_blocks · min(k, block_d)), blocks in pid order."""
    B, n_docs = scores.shape
    n_blocks = -(-n_docs // block_d)
    kb_max = min(k, block_d)
    padded = F.pad(scores, (0, n_blocks * block_d - n_docs),
                   value=float("-inf")).view(B, n_blocks, block_d)
    _, idx = stable_topk(padded, kb_max)
    idx, _ = idx.sort(dim=-1)                       # pid order
    pids = idx + torch.arange(n_blocks, device=scores.device).view(
        1, n_blocks, 1) * block_d
    vals = padded.gather(-1, idx)
    pad = pids >= n_docs                            # the ragged last block
    return (vals.masked_fill(pad, float("-inf")).view(B, -1),
            pids.masked_fill(pad, -1).to(torch.int32).view(B, -1))


def merge_block_topk_ref(cand_scores, cand_pids, k: int):
    """Per-block candidates (blocks in pid order, each in pid order) →
    the top-``k`` by (score desc, pid asc), as ``lax.top_k`` orders
    them, by one stable descending sort → (pids (B, k) int32, scores
    (B, k) f32): the plain version of the top-k launch's merge."""
    vals, order = stable_topk(cand_scores, k)
    return cand_pids.gather(-1, order), vals
