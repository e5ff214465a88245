"""Plain PyTorch MaxSim (late interaction)."""

from __future__ import annotations

import torch


def maxsim_scores_ref(q, docs, doc_valid, q_valid=None):
    """q: (..., Lq, d); docs: (..., C, Ld, d); doc_valid: (..., C, Ld)
    bool; q_valid: optional (..., Lq) bool → scores (..., C) float32.

    score_c = Σ_{q tokens} max_{valid doc tokens} <q, d>. A doc with no
    valid token scores 0; a padded query token contributes 0."""
    s = torch.einsum("...qd,...cld->...cql", q.float(), docs.float())
    s = s.masked_fill(~doc_valid.bool().unsqueeze(-2), float("-inf"))
    per_q = s.amax(dim=-1)                                 # (..., C, Lq)
    per_q = torch.where(torch.isfinite(per_q), per_q,
                        torch.zeros((), dtype=per_q.dtype,
                                    device=per_q.device))
    if q_valid is not None:
        per_q = per_q * q_valid.unsqueeze(-2).to(per_q.dtype)
    return per_q.sum(dim=-1)
