"""Public wrapper for the MaxSim kernel over fp32 embeddings
(``csrc/maxsim.cu``).

For CUDA tensors the wrapper launches the kernel, and raises if it
cannot; for CPU tensors it runs the plain PyTorch version (``ref.py``).
Inputs of another float type are cast to fp32 first.
``maxsim_scores_batch.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._inputs import aligned, as_u8, on_cpu
from repro_torch.kernels.maxsim.ref import maxsim_scores_ref


def maxsim_scores_batch(q, docs, doc_valid, q_valid=None):
    """Cross-query batched late-interaction scores.

    q: (B, Lq, d); docs: (B, C, Ld, d); doc_valid: (B, C, Ld) bool;
    q_valid: optional (B, Lq) bool (False on padded query tokens) →
    (B, C) f32. score = Σ over valid query tokens of the max over valid
    doc tokens of <q, doc>; a doc with no valid token scores 0.
    """
    q, docs = q.float(), docs.float()
    if q_valid is None:
        q_valid = torch.ones(q.shape[:2], dtype=torch.bool, device=q.device)
    if on_cpu(q, docs, doc_valid, q_valid):
        return maxsim_scores_ref(q, docs, doc_valid, q_valid)
    B, Lq, d = q.shape
    if docs.dim() != 4 or docs.shape[0] != B or docs.shape[3] != d:
        raise ValueError(f"docs shape {tuple(docs.shape)} does not match "
                         f"q {tuple(q.shape)}")
    C, Ld = docs.shape[1:3]
    if tuple(doc_valid.shape) != (B, C, Ld):
        raise ValueError("doc_valid must be (B, C, Ld)")
    if tuple(q_valid.shape) != (B, Lq):
        raise ValueError("q_valid must be (B, Lq)")
    if d % 32 or d > 1024:
        raise ValueError(f"kernel needs d a multiple of 32, at most 1024; "
                         f"got {d}")
    if Lq > 128:
        raise ValueError(f"kernel takes at most 128 query tokens, got {Lq}")
    if B * C * Ld >= 2 ** 31:
        raise ValueError(f"kernel takes fewer than 2^31 doc tokens, got "
                         f"{B * C * Ld}")
    q, docs = aligned(q), aligned(docs)
    valid, qv = as_u8(doc_valid), as_u8(q_valid)
    out = torch.empty((B, C), dtype=torch.float32, device=q.device)
    if B * C == 0:
        return out
    lib = _build.load()
    smem = lib.maxsim_smem_bytes(Lq, d, B, C)
    if smem > _build.MAX_SMEM_BYTES:
        raise ValueError(f"maxsim needs {smem} B of shared memory at "
                         f"Lq={Lq}, d={d}")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.maxsim_launch(q.data_ptr(), docs.data_ptr(),
                                valid.data_ptr(), qv.data_ptr(),
                                out.data_ptr(), B, C, Ld, Lq, d, stream)
    _build.check(lib, err, "maxsim")
    _build.count_launch(maxsim_scores_batch)
    return out


maxsim_scores_batch.launches = 0


def maxsim_scores(q, docs, doc_valid, q_valid=None):
    """One query: q (Lq, d); docs (C, Ld, d); doc_valid (C, Ld) → (C,)
    f32 — a B=1 launch of the batched kernel."""
    qv = None if q_valid is None else q_valid[None]
    return maxsim_scores_batch(q[None], docs[None], doc_valid[None], qv)[0]
