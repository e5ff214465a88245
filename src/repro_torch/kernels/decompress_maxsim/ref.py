"""Plain PyTorch decompress-then-MaxSim: the reference the CUDA kernel
is held to (and what a CPU tensor runs)."""

from __future__ import annotations

from repro_torch.index.residual import decode_embeddings
from repro_torch.kernels.maxsim.ref import maxsim_scores_ref


def decompress_maxsim_ref(q, packed, cids, doc_valid, centroids,
                          bucket_weights, nbits: int, q_valid=None):
    """q: (..., Lq, d); packed: (..., C, Ld, d·nbits/8) uint8; cids:
    (..., C, Ld) int; doc_valid: (..., C, Ld) bool; centroids: (K, d);
    bucket_weights: (2^nbits,) → scores (..., C) f32. Works with or
    without a leading batch axis."""
    emb = decode_embeddings(packed, cids, centroids, bucket_weights, nbits)
    emb = emb * doc_valid.unsqueeze(-1).to(emb.dtype)
    return maxsim_scores_ref(q, emb, doc_valid, q_valid)
