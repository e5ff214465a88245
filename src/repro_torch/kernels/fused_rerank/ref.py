"""Plain PyTorch fused rerank tail: decompress → MaxSim → stable top-k.

The contract the CUDA kernel honours bit for bit against the split
path (its own scores, ``-inf`` at masked candidates, then a stable
descending sort):

    masked = where(cand_mask, maxsim(decompress(packed)), -inf)
    top-k by (score desc, candidate index asc)

When ``k`` exceeds the candidate count the tail is padded with
``(-inf, -1)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.decompress_maxsim.ref import decompress_maxsim_ref


def stable_topk(x: torch.Tensor, k: int):
    """Top-``k`` along the last axis by (value desc, index asc) — the
    order ``torch.topk`` does not promise on ties. → (values, int64
    indices)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_topk(vals, idx, k: int):
    kk = vals.shape[-1]
    idx = idx.to(torch.int32)
    if kk == k:
        return vals, idx
    return (F.pad(vals, (0, k - kk), value=float("-inf")),
            F.pad(idx, (0, k - kk), value=-1))


def empty_topk(lead: tuple, k: int, device):
    return (torch.full(lead + (k,), float("-inf"), dtype=torch.float32,
                       device=device),
            torch.full(lead + (k,), -1, dtype=torch.int32, device=device))


def fused_rerank_ref(q, packed, cids, doc_valid, cand_mask, centroids,
                     bucket_weights, nbits: int, k: int, q_valid=None):
    """q (..., Lq, d); packed (..., C, Ld, pd) u8; cids/doc_valid
    (..., C, Ld); cand_mask (..., C) bool (False = padded candidate) →
    (scores (..., k) f32 desc, idx (..., k) i32 into the candidate
    axis). With or without a leading batch axis."""
    C = cids.shape[-2]
    kk = min(k, C)
    if kk == 0:
        return empty_topk(tuple(cids.shape[:-2]), k, q.device)
    scores = decompress_maxsim_ref(q, packed, cids, doc_valid, centroids,
                                   bucket_weights, nbits, q_valid)
    masked = scores.masked_fill(~cand_mask.bool(), float("-inf"))
    vals, idx = stable_topk(masked, kk)
    return _pad_topk(vals, idx, k)
