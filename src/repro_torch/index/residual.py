"""ColBERTv2 residual codec: centroid id + n-bit quantised residual.

A token embedding e is stored as ``cid`` and one ``nbits`` bucket code
per dimension, packed little-endian into uint8 (8/nbits codes per
byte). Encoding: r = e − centroids[cid], code = the bucket of each r_d
against global quantile cutoffs (:func:`fit_codec`, on the host in
numpy, as the JAX package fits it). Decoding: e ≈ centroids[cid] +
bucket_weights[code].
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class ResidualCodec:
    centroids: torch.Tensor       # (K, dim) float32, unit norm
    bucket_cutoffs: torch.Tensor  # (2^nbits − 1,) float32
    bucket_weights: torch.Tensor  # (2^nbits,) float32
    nbits: int

    @property
    def dim(self) -> int:
        return int(self.centroids.shape[1])

    @property
    def codes_per_byte(self) -> int:
        return 8 // self.nbits

    def packed_dim(self) -> int:
        return self.dim // self.codes_per_byte


def fit_codec(centroids, sample_embs, sample_cids,
              nbits: int) -> ResidualCodec:
    """Fit bucket cutoffs (the residuals' 1/2^nbits quantiles) and
    weights (each bucket's mean residual) from a sample and its centroid
    ids. Host numpy, the reference's arithmetic: ``np.quantile`` is not
    ``torch.quantile``, which also caps its input at 2^24 elements."""
    centroids = np.asarray(centroids, np.float32)
    res = np.asarray(sample_embs) - centroids[np.asarray(sample_cids)]
    n_buckets = 2 ** nbits
    qs = np.linspace(0, 1, n_buckets + 1)[1:-1]
    cutoffs = np.quantile(res, qs)
    bucket_ids = np.searchsorted(cutoffs, res.reshape(-1))
    sums = np.bincount(bucket_ids, weights=res.reshape(-1),
                       minlength=n_buckets)
    cnts = np.maximum(np.bincount(bucket_ids, minlength=n_buckets), 1)
    weights = (sums / cnts).astype(np.float32)
    return ResidualCodec(
        centroids=torch.tensor(centroids),
        bucket_cutoffs=torch.from_numpy(cutoffs.astype(np.float32)),
        bucket_weights=torch.from_numpy(weights), nbits=nbits)


def encode_residuals(embs: torch.Tensor, cids: torch.Tensor,
                     centroids: torch.Tensor, cutoffs: torch.Tensor,
                     nbits: int) -> torch.Tensor:
    """embs: (N, dim) → packed codes (N, dim·nbits/8) uint8, on the
    tensors' device. A code is the number of cutoffs below the residual
    (``searchsorted`` from the left, as ``jnp.searchsorted``); code j of
    a byte sits at bits j·nbits. The packing runs in int32: uint8 shifts
    would overflow."""
    res = embs - centroids[cids.long()]
    codes = torch.searchsorted(cutoffs, res).to(torch.int32)
    cpb = 8 // nbits
    n, dim = codes.shape
    shifts = torch.arange(cpb, dtype=torch.int32, device=codes.device) * nbits
    packed = (codes.reshape(n, dim // cpb, cpb) << shifts).sum(
        dim=-1, dtype=torch.int32)
    return packed.to(torch.uint8)


def unpack_codes(packed: torch.Tensor, nbits: int) -> torch.Tensor:
    """packed: (..., dim/cpb) uint8 → codes (..., dim) uint8; code j of a
    byte is ``(byte >> j·nbits) & (2^nbits − 1)``."""
    cpb = 8 // nbits
    shifts = torch.arange(cpb, dtype=torch.uint8,
                          device=packed.device) * nbits
    codes = (packed.unsqueeze(-1) >> shifts) & ((1 << nbits) - 1)
    return codes.reshape(*packed.shape[:-1], packed.shape[-1] * cpb)


def decode_embeddings(packed, cids, centroids, bucket_weights,
                      nbits: int) -> torch.Tensor:
    """→ (..., dim) float32 approximate embeddings."""
    codes = unpack_codes(packed, nbits)
    return centroids[cids.long()] + bucket_weights[codes.long()]


def compression_ratio(dim: int, nbits: int) -> float:
    """fp32 embedding bytes vs (packed codes + 4-byte centroid id)."""
    return 4 * dim / (dim * nbits / 8 + 4)
