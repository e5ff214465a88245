"""Public wrapper for the fused decompress+MaxSim kernel
(``csrc/decompress_maxsim.cu``).

For CUDA tensors the wrapper launches the kernel, and raises if it
cannot; for CPU tensors it runs the plain PyTorch version (``ref.py``).
``decompress_maxsim_scores_batch.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._inputs import on_cpu, tile_inputs
from repro_torch.kernels.decompress_maxsim.ref import decompress_maxsim_ref


def decompress_maxsim_scores_batch(q, packed, cids, doc_valid, centroids,
                                   bucket_weights, *, nbits: int,
                                   q_valid=None):
    """Batched fused scoring over compressed candidates.

    q: (B, Lq, d) f32; packed: (B, C, Ld, d·nbits/8) uint8; cids:
    (B, C, Ld) int32; doc_valid: (B, C, Ld) bool; q_valid: optional
    (B, Lq) bool (False on padded query tokens) → (B, C) f32 scores.
    """
    if q_valid is None:
        q_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    if on_cpu(q, packed, cids, doc_valid, q_valid, centroids,
              bucket_weights):
        return decompress_maxsim_ref(q, packed, cids, doc_valid, centroids,
                                     bucket_weights, nbits, q_valid)
    args = tile_inputs(q, packed, cids, doc_valid, q_valid, centroids,
                       bucket_weights, nbits)
    B, Lq, d = q.shape
    C, Ld = packed.shape[1:3]
    out = torch.empty((B, C), dtype=torch.float32, device=q.device)
    if B * C == 0:
        return out
    lib = _build.load()
    smem = lib.decompress_maxsim_smem_bytes(Lq, d)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"decompress_maxsim needs {smem} B of shared "
                         f"memory at Lq={Lq}, d={d}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.decompress_maxsim_launch(
            *(t.data_ptr() for t in args), out.data_ptr(), B, C, Ld, Lq, d,
            nbits, stream)
    _build.check(lib, err, "decompress_maxsim")
    _build.count_launch(decompress_maxsim_scores_batch)
    return out


decompress_maxsim_scores_batch.launches = 0


def decompress_maxsim_scores(q, packed, cids, doc_valid, centroids,
                             bucket_weights, *, nbits: int, q_valid=None):
    """One query: q (Lq, d); packed (C, Ld, pd); cids/doc_valid (C, Ld)
    → (C,) f32 — a B=1 launch of the batched kernel."""
    qv = None if q_valid is None else q_valid[None]
    return decompress_maxsim_scores_batch(
        q[None], packed[None], cids[None], doc_valid[None], centroids,
        bucket_weights, nbits=nbits, q_valid=qv)[0]
