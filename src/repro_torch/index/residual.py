"""ColBERTv2 residual codec, decode side: centroid id + n-bit quantised
residual.

A token embedding e is stored as ``cid`` and one ``nbits`` bucket code
per dimension, packed little-endian into uint8 (8/nbits codes per
byte). Decoding: e ≈ centroids[cid] + bucket_weights[code].
"""

from __future__ import annotations

import dataclasses

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
