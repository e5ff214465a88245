"""Public wrappers for the SPLADE stage-1 kernel
(``csrc/splade_score.cu``) and its two entry points: scores over
pid-sorted posting rows, and a per-query top-k (per-block candidates,
merged on the card in the same launch).

For CUDA tensors a wrapper launches the kernel, and raises if it
cannot; for CPU tensors it runs the plain PyTorch version (``ref.py``).
``splade_row_scores_batch.launches`` and ``splade_row_topk_batch.launches``
count the launches of the two entry points; every other function here
goes through one of them.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._inputs import on_cpu
from repro_torch.kernels.fused_rerank.ref import stable_topk
from repro_torch.kernels.splade_score.ref import (block_topk_ref,
                                                  splade_row_scores_batch_ref)

# docs per block of each launch, as the kernel fixes them
# (kScoreBlockD, kTopkBlockD in csrc/splade_score.cu)
SCORE_BLOCK_DOCS = 2048
TOPK_BLOCK_DOCS = 8192
_MAX_GRID_Y = 65535


def sort_rows(pids, imps):
    """Posting rows stably sorted by pid read as unsigned, so −1 pads go
    to the end and each pid's entries keep their order: the layout the
    kernel searches. → (pids, imps), new tensors."""
    order = torch.sort(pids.long() & 0xFFFFFFFF, dim=-1, stable=True)[1]
    return pids.gather(-1, order), imps.gather(-1, order)


def _check(row_pids, row_imps, rows, weights, n_docs: int):
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
    if row_pids.numel() >= 2 ** 31 or n_docs >= 2 ** 31 - TOPK_BLOCK_DOCS:
        raise ValueError(f"postings of {row_pids.numel()} entries or "
                         f"n_docs = {n_docs} exceed the kernel's int32 "
                         "range")
    if rows.shape[0] > _MAX_GRID_Y:
        raise ValueError(f"at most {_MAX_GRID_Y} queries per launch, got "
                         f"{rows.shape[0]}")
    return [t.contiguous() for t in (row_pids, row_imps, rows, weights)]


def splade_row_scores_batch(row_pids, row_imps, rows, weights, *,
                            n_docs: int):
    """Stage-1 scores read straight from posting rows.

    row_pids: (R, max_df) int32, each row sorted by :func:`sort_rows`
    (−1 pads last); row_imps: (R, max_df) uint8 or f32 in the same
    order; rows: (B, Qt) int32, the row of each term slot (−1: empty);
    weights: (B, Qt) f32, already scaled by the index's quantum →
    (B, n_docs) f32, each doc's entries added in (term slot, posting
    slot) order (see ``ref.py``). Every row id must be < R: the kernel
    does not check it (``SpladeDeviceCache`` rejects out-of-vocabulary
    ids on the host). The plain version takes rows in any order."""
    if on_cpu(row_pids, row_imps, rows, weights):
        return splade_row_scores_batch_ref(row_pids, row_imps, rows,
                                           weights, n_docs)
    args = _check(row_pids, row_imps, rows, weights, n_docs)
    B, Qt = rows.shape
    out = torch.empty((B, n_docs), dtype=torch.float32,
                      device=row_pids.device)
    if B * n_docs == 0:
        return out
    lib = _build.load()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = lib.splade_score_launch(
            args[0].data_ptr(), args[1].data_ptr(),
            int(row_imps.dtype == torch.uint8), args[2].data_ptr(),
            args[3].data_ptr(), out.data_ptr(), B, Qt, row_pids.shape[1],
            n_docs, stream)
    _build.check(lib, err, "splade_score")
    _build.count_launch(splade_row_scores_batch)
    return out


splade_row_scores_batch.launches = 0


def _topk_launch(row_pids, row_imps, rows, weights, n_docs: int, k: int):
    """One launch of the top-k entry point → (packed top-k (2, B, k)
    int32: pids, then score bits; candidates (scores, pids), each
    (B, n_blocks · min(k, TOPK_BLOCK_DOCS)))."""
    if not 1 <= k <= n_docs:
        raise ValueError(f"k must be in [1, n_docs = {n_docs}], got {k}")
    args = _check(row_pids, row_imps, rows, weights, n_docs)
    B, Qt = rows.shape
    n_cand = -(-n_docs // TOPK_BLOCK_DOCS) * min(k, TOPK_BLOCK_DOCS)
    dev = row_pids.device
    # one buffer: candidate scores and pids, the merge's scratch, the
    # packed top-k; and the per-row counters of finished blocks
    buf = torch.empty(B * (2 * n_cand + 6 * k), dtype=torch.int32,
                      device=dev)
    cand = buf[:2 * B * n_cand].view(2, B, n_cand)
    packed = buf[B * (2 * n_cand + 4 * k):].view(2, B, k)
    if B == 0:
        return packed, (cand[0].view(torch.float32), cand[1])
    counters = torch.zeros(B, dtype=torch.int32, device=dev)
    at = [buf.data_ptr() + 4 * B * n for n in (0, n_cand, 2 * n_cand,
                                               2 * n_cand + 4 * k,
                                               2 * n_cand + 5 * k)]
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.splade_topk_launch(
            args[0].data_ptr(), args[1].data_ptr(),
            int(row_imps.dtype == torch.uint8), args[2].data_ptr(),
            args[3].data_ptr(), *at[:3], counters.data_ptr(), *at[3:], B, Qt,
            row_pids.shape[1], n_docs, k, stream)
    _build.check(lib, err, "splade_topk")
    _build.count_launch(splade_row_topk_batch)
    return packed, (cand[0].view(torch.float32), cand[1])


def splade_row_topk_batch(row_pids, row_imps, rows, weights, *, n_docs: int,
                          k: int):
    """Stage-1 top-``k`` per query from posting rows (the inputs of
    :func:`splade_row_scores_batch`) → (pids (B, k) int32, scores (B, k)
    f32) by (score desc, pid asc), as ``lax.top_k`` orders them; 1 ≤ k
    ≤ n_docs (the caller clamps and pads).

    On the card this is one launch: each block of ``TOPK_BLOCK_DOCS``
    docs keeps its min(k, docs in block) best docs by (score desc, pid
    asc), in pid order, and the last block of each row to finish merges
    the row's candidates (a radix select of the k-th score, then a stable radix
    sort of the k winners). The plain version sorts the whole score
    rows stably."""
    if on_cpu(row_pids, row_imps, rows, weights):
        vals, idx = stable_topk(splade_row_scores_batch_ref(
            row_pids, row_imps, rows, weights, n_docs), k)
        return idx.to(torch.int32), vals
    packed, _ = _topk_launch(row_pids, row_imps, rows, weights, n_docs, k)
    return packed[0], packed[1].view(torch.float32)


splade_row_topk_batch.launches = 0


def splade_row_topk_packed(row_pids, row_imps, rows, weights, *,
                           n_docs: int, k: int):
    """:func:`splade_row_topk_batch` as one (2, B, k) int32 tensor —
    the pids, then the scores' bits — so that one copy brings it to the
    host."""
    if on_cpu(row_pids, row_imps, rows, weights):
        pids, vals = splade_row_topk_batch(row_pids, row_imps, rows,
                                           weights, n_docs=n_docs, k=k)
        return torch.stack([pids, vals.view(torch.int32)])
    return _topk_launch(row_pids, row_imps, rows, weights, n_docs, k)[0]


def splade_row_block_candidates(row_pids, row_imps, rows, weights, *,
                                n_docs: int, k: int):
    """The per-block candidates the top-k launch merges → (scores f32,
    pids int32), each (B, n_blocks · min(k, TOPK_BLOCK_DOCS)): blocks
    in pid order, each block's min(k, docs in block) best docs by (score
    desc, pid asc) in pid order, then (−inf, −1). The plain version is
    ``ref.block_topk_ref`` over the plain scores."""
    if on_cpu(row_pids, row_imps, rows, weights):
        return block_topk_ref(splade_row_scores_batch_ref(
            row_pids, row_imps, rows, weights, n_docs), k, TOPK_BLOCK_DOCS)
    return _topk_launch(row_pids, row_imps, rows, weights, n_docs, k)[1]


def _gathered_rows(post_pids, post_imps):
    """(B, Qt, max_df) gathered postings → kernel rows (B·Qt, max_df),
    sorted for a CUDA launch, and the (B, Qt) row of each term slot."""
    B, Qt, max_df = post_pids.shape
    pids = post_pids.reshape(B * Qt, max_df)
    imps = post_imps.reshape(B * Qt, max_df)
    if not on_cpu(pids, imps):
        pids, imps = sort_rows(pids, imps)
    rows = torch.arange(B * Qt, dtype=torch.int32,
                        device=post_pids.device).view(B, Qt)
    return pids, imps, rows


def splade_block_scores_batch(post_pids, post_imps, term_weights, *,
                              n_docs: int):
    """Cross-query batched impact scores over gathered postings in any
    order.

    post_pids: (B, Qt, max_df) int32 (−1 pad); post_imps: (B, Qt,
    max_df) f32 (de-quantised) or uint8; term_weights: (B, Qt) f32 (0
    disables a term) → (B, n_docs) f32. On the card the rows are sorted
    stably by pid first, then scored in one launch."""
    pids, imps, rows = _gathered_rows(post_pids, post_imps)
    return splade_row_scores_batch(pids, imps, rows, term_weights,
                                   n_docs=n_docs)


def splade_block_scores(post_pids, post_imps, term_weights, *,
                        n_docs: int):
    """One query: (Qt, max_df) postings, (Qt,) weights → (n_docs,) f32
    — a B=1 launch of the batched kernel."""
    return splade_block_scores_batch(post_pids[None], post_imps[None],
                                     term_weights[None], n_docs=n_docs)[0]


def splade_block_topk_batch(post_pids, post_imps, term_weights, *,
                            n_docs: int, k: int):
    """Stage-1 scores and a per-query top-k by (score desc, pid asc) over
    gathered postings → (pids (B, k) int32, scores (B, k) f32). ``k``
    must be ≤ n_docs (the caller clamps and pads)."""
    pids, imps, rows = _gathered_rows(post_pids, post_imps)
    return splade_row_topk_batch(pids, imps, rows, term_weights,
                                 n_docs=n_docs, k=k)
