"""Public wrappers for the SPLADE stage-1 kernel
(``csrc/splade_score.cu``): scores over padded postings, and the scores
followed by a per-query top-k.

For CUDA tensors a wrapper launches the kernel, and raises if it
cannot; for CPU tensors it runs the plain PyTorch version (``ref.py``).
``splade_row_scores_batch.launches`` counts kernel launches; every
other entry point here goes through it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._inputs import on_cpu
from repro_torch.kernels.fused_rerank.ref import stable_topk
from repro_torch.kernels.splade_score.ref import splade_row_scores_batch_ref


def splade_row_scores_batch(row_pids, row_imps, rows, weights, *,
                            n_docs: int):
    """Stage-1 scores read straight from padded posting rows.

    row_pids: (R, max_df) int32 (−1 pad); row_imps: (R, max_df) uint8 or
    f32; rows: (B, Qt) int32, the row of each term slot (−1: empty);
    weights: (B, Qt) f32, already scaled by the index's quantum →
    (B, n_docs) f32, each doc's entries added in (term slot, posting
    slot) order (see ``ref.py``). Every row id must be < R: the kernel
    does not check it (``SpladeDeviceCache`` rejects out-of-vocabulary
    ids on the host)."""
    if on_cpu(row_pids, row_imps, rows, weights):
        return splade_row_scores_batch_ref(row_pids, row_imps, rows,
                                           weights, n_docs)
    if row_pids.dtype != torch.int32 or rows.dtype != torch.int32:
        raise TypeError("row_pids and rows must be int32")
    if weights.dtype != torch.float32:
        raise TypeError(f"weights must be float32, got {weights.dtype}")
    if row_imps.dtype not in (torch.uint8, torch.float32):
        raise TypeError(f"row_imps must be uint8 or float32, got "
                        f"{row_imps.dtype}")
    if row_pids.dim() != 2 or row_imps.shape != row_pids.shape:
        raise ValueError("row_pids and row_imps must be one (R, max_df) "
                         "shape")
    if rows.dim() != 2 or weights.shape != rows.shape:
        raise ValueError("rows and weights must be one (B, Qt) shape")
    B, Qt = rows.shape
    max_df = row_pids.shape[1]
    if Qt * max_df >= 2 ** 31 or n_docs >= 2 ** 31:
        raise ValueError(f"Qt·max_df = {Qt * max_df} or n_docs = {n_docs} "
                         "exceeds the kernel's int32 range")
    out = torch.empty((B, n_docs), dtype=torch.float32,
                      device=row_pids.device)
    if B * n_docs == 0:
        return out
    args = [t.contiguous() for t in (row_pids, row_imps, rows, weights)]
    lib = _build.load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.splade_score_launch(
            args[0].data_ptr(), args[1].data_ptr(),
            int(row_imps.dtype == torch.uint8), args[2].data_ptr(),
            args[3].data_ptr(), out.data_ptr(), B, Qt, max_df, n_docs,
            stream)
    _build.check(lib, err, "splade_score")
    _build.count_launch(splade_row_scores_batch)
    return out


splade_row_scores_batch.launches = 0


def splade_block_scores_batch(post_pids, post_imps, term_weights, *,
                              n_docs: int):
    """Cross-query batched impact scores over gathered postings.

    post_pids: (B, Qt, max_df) int32 (−1 pad); post_imps: (B, Qt,
    max_df) f32 (de-quantised) or uint8; term_weights: (B, Qt) f32 (0
    disables a term) → (B, n_docs) f32. One launch for the batch."""
    B, Qt, max_df = post_pids.shape
    rows = torch.arange(B * Qt, dtype=torch.int32,
                        device=post_pids.device).view(B, Qt)
    return splade_row_scores_batch(post_pids.reshape(B * Qt, max_df),
                                   post_imps.reshape(B * Qt, max_df), rows,
                                   term_weights, n_docs=n_docs)


def splade_block_scores(post_pids, post_imps, term_weights, *,
                        n_docs: int):
    """One query: (Qt, max_df) postings, (Qt,) weights → (n_docs,) f32
    — a B=1 launch of the batched kernel."""
    return splade_block_scores_batch(post_pids[None], post_imps[None],
                                     term_weights[None], n_docs=n_docs)[0]


def topk_scores(scores, k: int):
    """Per-row top-``k`` of (B, n) scores by (score desc, index asc), as
    ``lax.top_k`` orders them → (int32 indices (B, k), scores (B, k)).
    ``k`` must be ≤ n."""
    vals, idx = stable_topk(scores, k)
    return idx.to(torch.int32), vals


def splade_block_topk_batch(post_pids, post_imps, term_weights, *,
                            n_docs: int, k: int):
    """Stage-1 scores and a per-query top-k by (score desc, pid asc) →
    (pids (B, k) int32, scores (B, k) f32). ``k`` must be ≤ n_docs (the
    caller clamps and pads)."""
    return topk_scores(splade_block_scores_batch(
        post_pids, post_imps, term_weights, n_docs=n_docs), k)
