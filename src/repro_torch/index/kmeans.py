"""Batched k-means (Lloyd) for ColBERTv2 centroid training, on the
points' device.

Centroids live on the unit sphere (ColBERT embeddings are L2-normalised)
so assignment uses the max-inner-product == min-L2 equivalence. The
assignment is an IEEE fp32 matmul in row chunks (cuBLAS on the card, as
the JAX package leaves its einsum to XLA); there is no kernel of the
JAX package on this path.

The update's per-cluster sums are deterministic on the card: a stable
sort by centroid id and a segmented sum, not ``index_add_``, whose
float atomics on CUDA would let two builds write different centroids.
"""

from __future__ import annotations

import numpy as np
import torch


# rows per matmul: fewer cost a build more launches, more cost every
# live upsert, which pads its document's few rows to one whole chunk
CHUNK = 512


def assign(points: torch.Tensor, centroids: torch.Tensor,
           chunk: int = CHUNK):
    """points: (N, d); centroids: (K, d) → (ids (N,) int32, sims (N,)
    fp32): each point's most similar centroid, the first of equals as
    ``jnp.argmax`` takes it. ``chunk`` rows at a time bound the
    (chunk, K) similarity block. Refuses to run with TF32 allowed.

    Every matmul has exactly ``chunk`` rows: a last, partial chunk is
    padded with zero rows. A BLAS picks its kernel, and with it the
    order in which a dot product is summed, by the matrix shape (on the
    CPU and on the card alike, a few rows take another route than a
    full block), so without the padding a near-tie row could get
    another id when a live upsert assigns its document's few rows alone
    than when a rebuild assigns it inside a chunk. With it, a row's
    sims do not depend on the rows that came with it."""
    # imported here: core.plaid imports the index builder, which imports
    # this module
    from repro_torch.core.plaid import check_ieee_fp32
    check_ieee_fp32()
    n = points.shape[0]
    ids = torch.empty(n, dtype=torch.int32, device=points.device)
    sims = torch.empty(n, dtype=torch.float32, device=points.device)
    ct = centroids.T
    for lo in range(0, n, chunk):
        x = points[lo:lo + chunk]
        m = x.shape[0]
        if m < chunk:
            x = torch.cat([x, x.new_zeros(chunk - m, x.shape[1])])
        best, arg = (x @ ct)[:m].max(dim=1)   # the first maximal index
        sims[lo:lo + m] = best
        ids[lo:lo + m] = arg
    return ids, sims


def update(points: torch.Tensor, centroids: torch.Tensor,
           ids: torch.Tensor):
    """One Lloyd update: each centroid moves to the mean of its points,
    renormalised (norm floored at 1e-9); an empty cluster stays where it
    was. → (new centroids (K, d), counts (K,) fp32).

    The sums are a segmented sum over the points stably sorted by id:
    each cluster's points are added in their order, with no atomics, so
    the result does not change from run to run on the card (the JAX
    package's ``segment_sum`` adds in an order of its own)."""
    K = centroids.shape[0]
    ids = ids.long()
    counts = torch.bincount(ids, minlength=K)
    order = torch.argsort(ids, stable=True)
    sums = torch.segment_reduce(points[order], "sum", lengths=counts,
                                axis=0)
    counts = counts.to(torch.float32)
    new = sums / torch.clamp(counts[:, None], min=1.0)
    new = torch.where(counts[:, None] > 0, new, centroids)
    norm = torch.linalg.norm(new, dim=-1, keepdim=True)
    return new / torch.clamp(norm, min=1e-9), counts


def lloyd(points: torch.Tensor, centroids: torch.Tensor,
          n_iters: int) -> torch.Tensor:
    """``n_iters`` rounds of assign + update from the given centroids."""
    for _ in range(n_iters):
        ids, _ = assign(points, centroids)
        centroids, _ = update(points, centroids, ids)
    return centroids


def train_kmeans(points: torch.Tensor, n_centroids: int,
                 n_iters: int = 10, seed: int = 0) -> torch.Tensor:
    """points: (N, d) float32 (unit-norm). → (K, d) unit centroids.

    The initial rows come from a CPU ``torch.Generator`` seeded with
    ``seed`` (distinct rows when N >= K, drawn with replacement
    otherwise), so every device starts from the same rows."""
    n = points.shape[0]
    gen = torch.Generator().manual_seed(seed)
    if n >= n_centroids:
        idx = torch.randperm(n, generator=gen)[:n_centroids]
    else:
        idx = torch.randint(n, (n_centroids,), generator=gen)
    centroids = points[idx.to(points.device)]
    centroids = centroids / torch.clamp(
        torch.linalg.norm(centroids, dim=-1, keepdim=True), min=1e-9)
    return lloyd(points, centroids, n_iters)


def pick_n_centroids(n_tokens: int) -> int:
    """ColBERTv2 heuristic: ~16·sqrt(120·N) rounded to a power of two."""
    target = 16 * np.sqrt(n_tokens)
    return int(2 ** int(np.clip(np.round(np.log2(max(target, 2))), 2, 18)))
