"""Index sharding: split one SPLADE + ColBERT index into contiguous
document-range shards for scatter-gather serving.

A shard group partitions the corpus into ``n_shards`` contiguous pid
ranges. Every shard owns a complete, self-contained slice of all three
index structures:

* **SPLADE postings** — the CSR postings of the shard's pid range,
  remapped to shard-local ids. The *global* ``quantum`` is kept, so a
  document's impact scores are bit-identical to the unsharded index's
  (quantising per shard would shift every score).
* **PLAID centroids/IVF** — the centroid table, the bucket codec and
  the rest of the geometry are **replicated**; only the IVF postings are
  filtered and remapped. The same geometry gives every document the
  unsharded approximate and exact scores, so a global top-k merge
  reproduces the single-index ranking.
* **mmap PagedStore segment** — the token range of codes.bin /
  residuals.bin of the shard's documents, as a file pair of its own, so
  that each shard's gathers fault their own pages.

``split_index_tree`` writes the shards of a serve-layout index
(``<base>/colbert`` + ``<base>/splade``) under ``<base>/shards/<i>/``
(or another group directory), with a ``meta.json`` holding the
boundaries. The files are the JAX package's, byte for byte.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np

from repro_torch.core.store import PagedStore
from repro_torch.index.ivf import IVF
from repro_torch.index.splade_index import SpladeIndex


def shard_boundaries(n_docs: int, n_shards: int) -> np.ndarray:
    """(n_shards+1,) int64 contiguous pid boundaries, balanced to within
    one document. Shard i owns pids [b[i], b[i+1])."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > n_docs:
        raise ValueError(f"n_shards={n_shards} exceeds n_docs={n_docs}")
    return np.linspace(0, n_docs, n_shards + 1).round().astype(np.int64)


def split_splade_index(sidx: SpladeIndex, boundaries: np.ndarray
                       ) -> list[SpladeIndex]:
    """Slice the CSR postings per shard (pids remapped to shard-local).

    The source ``quantum`` is carried over as it is: a shard's scores
    must equal the global index's for the same document, or the merged
    top-k would not reproduce the single-index ranking."""
    # term id of every posting, recovered from the CSR offsets
    dfs = np.diff(sidx.term_offsets)
    terms = np.repeat(np.arange(sidx.vocab, dtype=np.int64), dfs)
    pids = np.asarray(sidx.pids)
    out = []
    for lo, hi in zip(boundaries[:-1], boundaries[1:]):
        keep = (pids >= lo) & (pids < hi)
        counts = np.bincount(terms[keep], minlength=sidx.vocab)
        offsets = np.zeros(sidx.vocab + 1, np.int64)
        np.cumsum(counts, out=offsets[1:])
        out.append(SpladeIndex(
            term_offsets=offsets,
            pids=(pids[keep] - lo).astype(np.int32),
            impacts=np.asarray(sidx.impacts)[keep],
            quantum=sidx.quantum,          # the global scale, see above
            n_docs=int(hi - lo), vocab=sidx.vocab))
    return out


def split_colbert_index(src_dir, out_dirs, boundaries: np.ndarray):
    """Write one ColBERT index directory per shard from a single index.

    ``src_dir``: an index written by ``build_colbert_index`` or
    ``write_index``; ``out_dirs``: one target directory per shard. The
    token pool is sliced by document range through a memmap (the source
    residuals are never read whole), the geometry files are replicated,
    and the IVF is filtered and remapped per shard."""
    src = pathlib.Path(src_dir)
    meta = json.loads((src / "meta.json").read_text())
    n_tokens, packed_dim = meta["n_tokens"], meta["packed_dim"]
    doc_offsets = np.load(src / "doc_offsets.npy")
    doclens = np.load(src / "doclens.npy")
    residuals = np.memmap(src / "residuals.bin", np.uint8, "r",
                          shape=(n_tokens, packed_dim))
    codes = np.memmap(src / "codes.bin", np.int32, "r", shape=(n_tokens,))
    ivf_pids = np.fromfile(src / "ivf_pids.bin", np.int32)
    ivf_offsets = np.load(src / "ivf_offsets.npy")
    n_centroids = meta["n_centroids"]
    ivf_cids = np.repeat(np.arange(n_centroids, dtype=np.int64),
                         np.diff(ivf_offsets))

    if len(out_dirs) != len(boundaries) - 1:
        raise ValueError("one output dir per shard required")
    for (lo, hi), out_dir in zip(zip(boundaries[:-1], boundaries[1:]),
                                 out_dirs):
        out = pathlib.Path(out_dir)
        t_lo, t_hi = int(doc_offsets[lo]), int(doc_offsets[hi])
        PagedStore.write(out, np.asarray(codes[t_lo:t_hi]),
                         np.asarray(residuals[t_lo:t_hi]),
                         dim=meta["dim"], nbits=meta["nbits"])
        # the geometry is replicated: the same centroids and buckets give
        # each of the shard's documents its unsharded scores bit for bit
        for f in ("centroids.npy", "bucket_cutoffs.npy",
                  "bucket_weights.npy"):
            np.save(out / f, np.load(src / f))
        np.save(out / "doclens.npy", doclens[lo:hi])
        np.save(out / "doc_offsets.npy", doc_offsets[lo:hi + 1] - t_lo)
        keep = (ivf_pids >= lo) & (ivf_pids < hi)
        iv = _csr_from_pairs(ivf_cids[keep], ivf_pids[keep] - lo,
                             n_centroids)
        iv.pids.tofile(out / "ivf_pids.bin")
        np.save(out / "ivf_offsets.npy", iv.offsets)
        shard_meta = json.loads((out / "meta.json").read_text())
        shard_meta.update({"n_docs": int(hi - lo),
                           "doc_maxlen": meta["doc_maxlen"],
                           "n_centroids": n_centroids})
        (out / "meta.json").write_text(json.dumps(shard_meta))
    return list(out_dirs)


def _csr_from_pairs(cids, pids, n_centroids: int) -> IVF:
    """CSR IVF from (cid, pid) pairs already in centroid order. The
    source IVF is centroid-major, so a filtered slice stays sorted."""
    counts = np.bincount(cids, minlength=n_centroids)
    offsets = np.zeros(n_centroids + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    return IVF(pids=pids.astype(np.int32), offsets=offsets,
               n_centroids=n_centroids)


def split_index_tree(base_dir, n_shards: int, group_dir=None):
    """Write the shard group of a serve-layout index
    (``<base>/{colbert,splade}``) under ``<base>/shards/`` (or
    ``group_dir``). Idempotent per shard count: an existing group with
    the same ``n_shards`` is reused. Returns the group directory."""
    base = pathlib.Path(base_dir)
    group = pathlib.Path(group_dir) if group_dir else base / "shards"
    meta_path = group / "meta.json"
    if meta_path.exists():
        meta = json.loads(meta_path.read_text())
        if meta["n_shards"] == n_shards:
            return group
    col_meta = json.loads((base / "colbert" / "meta.json").read_text())
    bounds = shard_boundaries(col_meta["n_docs"], n_shards)
    split_colbert_index(base / "colbert",
                        [group / str(i) / "colbert"
                         for i in range(n_shards)], bounds)
    sidx = SpladeIndex.load(base / "splade")
    for i, shard in enumerate(split_splade_index(sidx, bounds)):
        shard.save(group / str(i) / "splade")
    meta_path.write_text(json.dumps(
        {"n_shards": n_shards, "boundaries": bounds.tolist()}))
    return group


def load_group(group_dir):
    """A shard group's layout, read back from its ``meta.json``: →
    ``(shard_dirs, boundaries)``, what ``build_sharded_retriever`` takes
    to load a group that :func:`split_index_tree` wrote."""
    group = pathlib.Path(group_dir)
    meta = json.loads((group / "meta.json").read_text())
    dirs = [group / str(i) for i in range(meta["n_shards"])]
    return dirs, np.asarray(meta["boundaries"], np.int64)
