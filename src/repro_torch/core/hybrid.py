"""Hybrid scoring: S = α·N(S_SPLADE) + (1−α)·N(S_ColBERT).

The paper compares three normalisers N and selects per-query z-norm.
All operate per query over the candidate list; padding entries (score
mask False) are excluded from the statistics.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def _masked_stats(x, mask):
    m = mask.to(torch.float32)
    n = m.sum(dim=-1, keepdim=True).clamp_min(1.0)
    mean = (x * m).sum(dim=-1, keepdim=True) / n
    var = ((x - mean).square() * m).sum(dim=-1, keepdim=True) / n
    return mean, var.sqrt()


def znorm(x, mask):
    """Per-query z-normalisation (the paper's pick)."""
    mean, std = _masked_stats(x, mask)
    return (x - mean) / std.clamp_min(_EPS)


def minmax_norm(x, mask):
    lo = x.masked_fill(~mask, float("inf")).amin(dim=-1, keepdim=True)
    hi = x.masked_fill(~mask, float("-inf")).amax(dim=-1, keepdim=True)
    return (x - lo) / (hi - lo).clamp_min(_EPS)


def linear_scale(x, mask):
    """Map to [0, 1] by dividing by the per-query max magnitude."""
    hi = x.abs().masked_fill(~mask, 0.0).amax(dim=-1, keepdim=True)
    return x / hi.clamp_min(_EPS)


NORMALIZERS = {"znorm": znorm, "minmax": minmax_norm, "linear": linear_scale}


def hybrid_scores(splade_scores, colbert_scores, mask, *, alpha,
                  normalizer: str = "znorm"):
    """Both score tensors: (..., C) aligned on the same candidate list.
    α = 0 → pure Rerank (ColBERT order); α = 1 → pure SPLADE.

    ``alpha`` is a scalar, or — for batched (B, C) inputs — a (B,)
    tensor or array of per-query interpolation weights. Padded slots
    come back as -inf."""
    norm = NORMALIZERS[normalizer]
    mask = mask.bool()
    # padded slots may carry -inf (rerank scores of -1 pids); zero them
    # before the stats so 0·(-inf) = NaN cannot poison the masked
    # mean/std — they are re-masked to -inf on the way out
    splade_scores = splade_scores.masked_fill(~mask, 0.0)
    colbert_scores = colbert_scores.masked_fill(~mask, 0.0)
    ns = norm(splade_scores, mask)
    nc = norm(colbert_scores, mask)
    alpha = torch.as_tensor(alpha, dtype=torch.float32,
                            device=colbert_scores.device)
    if alpha.dim():
        alpha = alpha.unsqueeze(-1)          # broadcast over the C axis
    out = alpha * ns + (1.0 - alpha) * nc
    return out.masked_fill(~mask, float("-inf"))
