"""IR quality metrics: MRR@k, Recall@k, Success@k, nDCG@k (the port's
own copy of the reference's, with the same arithmetic)."""

from __future__ import annotations

import numpy as np


def mrr_at_k(ranked_pids: np.ndarray, relevant: list[set], k: int = 10) -> float:
    """ranked_pids: (Q, depth); relevant: per-query set of relevant pids."""
    total = 0.0
    for q in range(len(relevant)):
        for rank, pid in enumerate(ranked_pids[q][:k]):
            if int(pid) in relevant[q]:
                total += 1.0 / (rank + 1)
                break
    return total / max(len(relevant), 1)


def recall_at_k(ranked_pids: np.ndarray, relevant: list[set], k: int) -> float:
    total = 0.0
    for q in range(len(relevant)):
        if not relevant[q]:
            continue
        hits = sum(1 for pid in ranked_pids[q][:k] if int(pid) in relevant[q])
        total += hits / len(relevant[q])
    return total / max(len(relevant), 1)


def success_at_k(ranked_pids: np.ndarray, relevant: list[set], k: int = 5) -> float:
    total = 0.0
    for q in range(len(relevant)):
        if any(int(pid) in relevant[q] for pid in ranked_pids[q][:k]):
            total += 1.0
    return total / max(len(relevant), 1)


def ndcg_at_k(ranked_pids: np.ndarray, relevant: list, k: int = 10) -> float:
    """Graded-relevance nDCG@k.

    ``relevant`` is per-query either a set (binary gains) or a dict
    ``pid -> gain``. Queries with no relevant docs contribute 0. DCG
    uses the standard ``gain / log2(rank + 2)`` discount; the ideal DCG
    takes the top-k gains sorted descending."""
    total = 0.0
    for q in range(len(relevant)):
        rel = relevant[q]
        if not rel:
            continue
        gains = (rel if isinstance(rel, dict)
                 else {pid: 1.0 for pid in rel})
        dcg = 0.0
        for rank, pid in enumerate(ranked_pids[q][:k]):
            g = gains.get(int(pid), 0.0)
            if g:
                dcg += g / np.log2(rank + 2)
        ideal = sorted(gains.values(), reverse=True)[:k]
        idcg = sum(g / np.log2(r + 2) for r, g in enumerate(ideal))
        if idcg > 0:
            total += dcg / idcg
    return total / max(len(relevant), 1)
