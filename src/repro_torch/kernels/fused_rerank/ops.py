"""Public wrapper for the fused decompress+MaxSim+top-k kernel
(``csrc/fused_rerank.cu``).

For CUDA tensors the wrapper launches the kernel, and raises if it
cannot; for CPU tensors it runs the plain PyTorch version (``ref.py``).
``fused_rerank_topk_batch.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._inputs import as_u8, on_cpu, tile_inputs
from repro_torch.kernels.fused_rerank.ref import (_pad_topk, empty_topk,
                                                  fused_rerank_ref)


def fused_rerank_topk_batch(q, packed, cids, doc_valid, cand_mask,
                            centroids, bucket_weights, *, nbits: int,
                            k: int, q_valid=None):
    """Cross-query fused rerank tail — one launch for the micro-batch.

    q: (B, Lq, d) f32; packed: (B, C, Ld, d·nbits/8) uint8;
    cids/doc_valid: (B, C, Ld); cand_mask: (B, C) bool; q_valid:
    optional (B, Lq) bool → (scores (B, k) f32 desc, idx (B, k) int32
    into the candidate axis), ties toward the lower index, padded with
    ``(-inf, -1)`` past min(k, C).
    """
    B, C = packed.shape[:2]
    kk = min(k, C)
    if q_valid is None:
        q_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    cpu = on_cpu(q, packed, cids, doc_valid, cand_mask, q_valid, centroids,
                 bucket_weights)
    if kk == 0:
        return empty_topk((B,), k, q.device)
    if cpu:
        return fused_rerank_ref(q, packed, cids, doc_valid, cand_mask,
                                centroids, bucket_weights, nbits, k,
                                q_valid)
    args = tile_inputs(q, packed, cids, doc_valid, q_valid, centroids,
                       bucket_weights, nbits)
    if tuple(cand_mask.shape) != (B, C):
        raise ValueError("cand_mask must be (B, C)")
    cmask = as_u8(cand_mask)
    Lq, d = q.shape[1:]
    Ld = packed.shape[2]
    vals = torch.empty((B, kk), dtype=torch.float32, device=q.device)
    idx = torch.empty((B, kk), dtype=torch.int32, device=q.device)
    if B == 0:
        return _pad_topk(vals, idx, k)
    lib = _build.load()
    smem = lib.fused_rerank_smem_bytes(Lq, d, C)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"fused_rerank needs {smem} B of shared memory "
                         f"at Lq={Lq}, d={d}, C={C}")
    qa, pa, ca, va, qva, cent, bw = args
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.fused_rerank_launch(
            qa.data_ptr(), pa.data_ptr(), ca.data_ptr(), va.data_ptr(),
            cmask.data_ptr(), qva.data_ptr(), cent.data_ptr(),
            bw.data_ptr(), vals.data_ptr(), idx.data_ptr(), B, C, Ld, Lq,
            d, nbits, kk, stream)
    _build.check(lib, err, "fused_rerank")
    _build.count_launch(fused_rerank_topk_batch)
    return _pad_topk(vals, idx, k)


fused_rerank_topk_batch.launches = 0


def fused_rerank_topk(q, packed, cids, doc_valid, cand_mask, centroids,
                      bucket_weights, *, nbits: int, k: int, q_valid=None):
    """One query: q (Lq, d); packed (C, Ld, pd); cids/doc_valid (C, Ld);
    cand_mask (C,) → (scores (k,), idx (k,)) — a B=1 launch of the
    batched kernel."""
    qv = None if q_valid is None else q_valid[None]
    vals, idx = fused_rerank_topk_batch(
        q[None], packed[None], cids[None], doc_valid[None], cand_mask[None],
        centroids, bucket_weights, nbits=nbits, k=k, q_valid=qv)
    return vals[0], idx[0]
