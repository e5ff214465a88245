"""On-disk ColBERTv2 index: the build, the writer of its file set and
the loader.

embeddings (n_docs, doc_maxlen, dim) + lengths
    → k-means centroids → residual codec → packed codes/residuals
    → IVF → on-disk index directory (PagedStore format + metadata).

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

from repro_torch.common import resolve_device
from repro_torch.core.store import PagedStore
from repro_torch.index import ivf as ivf_mod
from repro_torch.index import kmeans, residual
from repro_torch.index.residual import ResidualCodec

# bucket-table length → nbits; the codec packs 2 or 4 bits a code
NBITS_OF_BUCKETS = {4: 2, 16: 4}


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
    if len(bucket_weights) not in NBITS_OF_BUCKETS:
        raise ValueError(f"{len(bucket_weights)} bucket weights: the codec "
                         "has 4 (nbits=2) or 16 (nbits=4)")
    nbits = NBITS_OF_BUCKETS[len(bucket_weights)]
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


def build_colbert_index(out_dir, doc_embs: np.ndarray, doc_lens: np.ndarray,
                        *, nbits: int = 4, n_centroids: int | None = None,
                        kmeans_iters: int = 8, sample_cap: int = 65536,
                        seed: int = 0, centroids: np.ndarray | None = None,
                        bucket_cutoffs: np.ndarray | None = None,
                        bucket_weights: np.ndarray | None = None,
                        device="cuda"):
    """doc_embs: (n_docs, doc_maxlen, dim) unit-norm; doc_lens: (n_docs,).

    The k-means, the assignment of every token and the residual encode
    run on ``device``; the sample draw (``np.random.default_rng(seed)``,
    the JAX build's sample) and the codec fit run on the host. Training
    starts from rows drawn by a CPU generator seeded with ``seed``
    (:func:`kmeans.train_kmeans`), so the CPU and the card start alike.

    Passing ``centroids`` + ``bucket_cutoffs`` + ``bucket_weights`` pins
    the geometry: training and the fit are skipped and the corpus is
    encoded against the given codec. Given a JAX build's three arrays,
    the files written are that build's, byte for byte (up to assignment
    ties between the devices' fp32 sums). Returns the directory."""
    dev = resolve_device(device)
    pinned = (centroids, bucket_cutoffs, bucket_weights)
    if any(a is not None for a in pinned) and any(a is None for a in pinned):
        raise ValueError("pinned geometry needs centroids, "
                         "bucket_cutoffs and bucket_weights together")
    n_docs, doc_maxlen, _ = doc_embs.shape

    # flatten valid tokens
    valid = np.arange(doc_maxlen)[None, :] < doc_lens[:, None]
    flat = np.ascontiguousarray(doc_embs[valid], np.float32)
    n_tokens = flat.shape[0]
    flat_d = torch.from_numpy(flat).to(dev)

    if centroids is not None:
        codec = ResidualCodec(
            centroids=torch.tensor(centroids, dtype=torch.float32),
            bucket_cutoffs=torch.tensor(bucket_cutoffs, dtype=torch.float32),
            bucket_weights=torch.tensor(bucket_weights, dtype=torch.float32),
            nbits=nbits)
        n_centroids = codec.centroids.shape[0]
        cent_d = codec.centroids.to(dev)
        cids_d, _ = kmeans.assign(flat_d, cent_d)
    else:
        if n_centroids is None:
            n_centroids = max(16, min(kmeans.pick_n_centroids(n_tokens),
                                      n_tokens // 4))
        rng = np.random.default_rng(seed)
        sample = flat[rng.choice(n_tokens, min(sample_cap, n_tokens),
                                 replace=False)]
        sample_d = torch.from_numpy(sample).to(dev)
        cent_d = kmeans.train_kmeans(sample_d, n_centroids, kmeans_iters,
                                     seed)
        cids_d, _ = kmeans.assign(flat_d, cent_d)
        sample_cids, _ = kmeans.assign(sample_d, cent_d)
        codec = residual.fit_codec(cent_d.cpu().numpy(), sample,
                                   sample_cids.cpu().numpy(), nbits)
    packed = residual.encode_residuals(
        flat_d, cids_d, cent_d, codec.bucket_cutoffs.to(dev), nbits)
    return write_index(out_dir, cids_d.cpu().numpy(), packed.cpu().numpy(),
                       codec.centroids.numpy(), codec.bucket_cutoffs.numpy(),
                       codec.bucket_weights.numpy(), doc_lens, n_centroids,
                       doc_maxlen=doc_maxlen)


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
