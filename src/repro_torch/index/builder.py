"""On-disk ColBERTv2 index: the writer of its file set and the loader.

The directory holds the PagedStore pool (``residuals.bin``, ``codes.bin``,
``meta.json``) plus centroids, bucket tables, doc lengths and offsets,
and the IVF — the same files, byte for byte, that the JAX package's
``build_colbert_index`` writes, so either package reads the other's
index.
"""

from __future__ import annotations

import json
import pathlib

import numpy as np
import torch

from repro_torch.core.store import PagedStore
from repro_torch.index import ivf as ivf_mod
from repro_torch.index.residual import ResidualCodec


def write_index(out_dir, cids: np.ndarray, packed: np.ndarray,
                centroids: np.ndarray, bucket_cutoffs: np.ndarray,
                bucket_weights: np.ndarray, doclens: np.ndarray,
                n_centroids: int, doc_maxlen: int | None = None):
    """Persist an encoded corpus. cids: (n_tokens,) centroid id per
    token; packed: (n_tokens, dim·nbits/8) uint8 codes; doclens:
    (n_docs,) with ``sum(doclens) == n_tokens``, tokens stored doc-major.
    ``dim`` comes from ``centroids`` and ``nbits`` from the bucket
    table. ``doc_maxlen`` is the gather width (the encoder's padded doc
    length; default the longest doc). Returns the directory."""
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    centroids = np.asarray(centroids, np.float32)
    doclens = np.asarray(doclens)
    dim = int(centroids.shape[1])
    nbits = int(np.log2(len(bucket_weights)))
    n_docs = len(doclens)
    doc_maxlen = int(doclens.max()) if doc_maxlen is None else doc_maxlen
    if doc_maxlen < int(doclens.max()):
        raise ValueError(f"doc_maxlen={doc_maxlen} is shorter than the "
                         f"longest doc ({int(doclens.max())})")
    if int(doclens.sum()) != len(cids) or len(cids) != len(packed):
        raise ValueError("cids, packed and doclens disagree on the token "
                         "count")
    if packed.shape[1] * 8 != dim * nbits:
        raise ValueError(f"packed width {packed.shape[1]} does not match "
                         f"dim={dim} at nbits={nbits}")

    PagedStore.write(out, cids, packed, dim=dim, nbits=nbits)
    np.save(out / "centroids.npy", centroids)
    np.save(out / "bucket_cutoffs.npy",
            np.asarray(bucket_cutoffs, np.float32))
    np.save(out / "bucket_weights.npy",
            np.asarray(bucket_weights, np.float32))
    np.save(out / "doclens.npy", doclens.astype(np.int32))
    offsets = np.zeros(n_docs + 1, np.int64)
    np.cumsum(doclens, out=offsets[1:])
    np.save(out / "doc_offsets.npy", offsets)

    token_pids = np.repeat(np.arange(n_docs), doclens)
    iv = ivf_mod.build_ivf(cids, token_pids, n_centroids)
    iv.pids.tofile(out / "ivf_pids.bin")
    np.save(out / "ivf_offsets.npy", iv.offsets)

    meta = json.loads((out / "meta.json").read_text())
    meta.update({"n_docs": int(n_docs), "doc_maxlen": int(doc_maxlen),
                 "n_centroids": int(n_centroids)})
    (out / "meta.json").write_text(json.dumps(meta))
    return out


class ColBERTIndex:
    """Loaded index handle. ``mode`` picks the paper's mmap tier or the
    full-RAM baseline for the code/residual pool; centroids, buckets,
    doclens and the IVF stay in RAM in both modes, as in the paper."""

    def __init__(self, path, mode: str = "mmap"):
        self.path = pathlib.Path(path)
        meta = json.loads((self.path / "meta.json").read_text())
        self.meta = meta
        self.n_docs = meta["n_docs"]
        self.doc_maxlen = meta["doc_maxlen"]
        self.dim = meta["dim"]
        self.nbits = meta["nbits"]
        self.n_centroids = meta["n_centroids"]

        self.centroids = np.load(self.path / "centroids.npy")
        self.bucket_cutoffs = np.load(self.path / "bucket_cutoffs.npy")
        self.bucket_weights = np.load(self.path / "bucket_weights.npy")
        self.doclens = np.load(self.path / "doclens.npy")
        self.doc_offsets = np.load(self.path / "doc_offsets.npy")
        ivf_pids = np.fromfile(self.path / "ivf_pids.bin", np.int32)
        ivf_offsets = np.load(self.path / "ivf_offsets.npy")
        self.ivf = ivf_mod.IVF(ivf_pids, ivf_offsets, self.n_centroids)
        self.store = PagedStore(self.path, mode=mode)

    def codec(self) -> ResidualCodec:
        return ResidualCodec(
            centroids=torch.from_numpy(self.centroids),
            bucket_cutoffs=torch.from_numpy(self.bucket_cutoffs),
            bucket_weights=torch.from_numpy(self.bucket_weights),
            nbits=self.nbits)

    def gather_doc_tokens(self, pids: np.ndarray):
        """→ (cids (C, Ld), packed (C, Ld, pd), valid (C, Ld)) for pids
        (host path; goes through the PagedStore and is page-accounted)."""
        pids = np.asarray(pids)
        safe = np.clip(pids, 0, self.n_docs - 1)
        starts = self.doc_offsets[safe]
        cds, res = self.store.gather_ranges(starts, self.doc_maxlen)
        return cds, res, self._doc_valid(pids, safe)

    def gather_doc_codes(self, pids: np.ndarray):
        """→ (cids (C, Ld), valid (C, Ld)): centroid ids only. Touches
        zero residual pages."""
        pids = np.asarray(pids)
        safe = np.clip(pids, 0, self.n_docs - 1)
        starts = self.doc_offsets[safe]
        cds = self.store.gather_codes_ranges(starts, self.doc_maxlen)
        return cds, self._doc_valid(pids, safe)

    def _doc_valid(self, pids, safe):
        valid = (np.arange(self.doc_maxlen)[None, :]
                 < self.doclens[safe][:, None])
        valid &= (pids >= 0)[:, None]
        return valid
