"""Live (mutable) index: append-mode delta segment + tombstones + compaction.

The frozen serve layout (PagedStore codes/residuals, IVF, SPLADE CSR)
never changes shape under traffic; mutability is layered beside it:

* **Upserts** residual-encode the new document against the *existing*
  centroids and codec on the retriever's device (``kmeans.assign`` +
  ``encode_residuals``; ``assign`` runs every matmul on
  ``kmeans.CHUNK`` rows, so a row's code does not depend on the rows
  assigned with it and delta codes are what a from-scratch rebuild
  assigns the same embeddings) and append
  it to a delta segment in host RAM: per-doc centroid ids, packed
  residuals, SPLADE postings. Delta docs get append-only global pids
  ``base_n + j`` — stable across compactions, because a compaction
  promotes exactly the first ``n`` delta docs into the base in order.
* **Deletes** record the global pid in a tombstone set. Tombstoned
  docs stay physically present (base *and* compacted layouts) and are
  filtered before every top-k (``merge_topk``, the SPLADE top-k), which
  keeps pids stable and deletes O(1).
* **Compaction** merges the delta prefix into a *new* index directory
  (``<index>.g<gen>``) off-line, then swaps the serve handles under a
  writer gate and bumps the index generation so the exact and stage-1
  caches invalidate.

Correctness bar: an interleaved upsert/delete/query trace returns the
top-k of a from-scratch rebuild of the surviving corpus (the serve
index's geometry pinned) bit for bit at every quiet point, under the
monotone pid map (surviving global pids, ascending) ↔ (0..n-1).
"""

from __future__ import annotations

import pathlib
import threading
import traceback
from contextlib import contextmanager

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.core.plaid import stage3_approx_score_batch
from repro_torch.index import kmeans, residual
from repro_torch.index.builder import build_colbert_index, write_index
from repro_torch.index.splade_index import SpladeIndex, build_splade_index
from repro_torch.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores_batch)


class RWGate:
    """Readers/writer gate with writer preference and re-entrant reads.

    A *first-entry* reader blocks while a writer holds **or waits for**
    the gate, so the compaction swap cannot starve under a saturating
    read load (new queries queue behind the waiting writer; in-flight
    ones drain). A thread already inside ``read()`` re-enters without
    touching the queue — a mixed-method batch recurses into
    ``search_batch`` — so writer preference never deadlocks a reader
    against itself (the depth is tracked per thread).
    """

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._local = threading.local()

    @contextmanager
    def read(self):
        depth = getattr(self._local, "depth", 0)
        if depth:                      # nested read: already admitted
            self._local.depth = depth + 1
            try:
                yield
            finally:
                self._local.depth -= 1
            return
        with self._cond:
            while self._writer or self._writers_waiting:
                self._cond.wait()
            self._readers += 1
            self._local.depth = 1
        try:
            yield
        finally:
            with self._cond:
                self._readers -= 1
                self._local.depth = 0
                if not self._readers:
                    self._cond.notify_all()

    @contextmanager
    def write(self):
        with self._cond:
            self._writers_waiting += 1
            try:
                while self._writer or self._readers:
                    self._cond.wait()
                self._writer = True
            finally:
                self._writers_waiting -= 1
        try:
            yield
        finally:
            with self._cond:
                self._writer = False
                self._cond.notify_all()


class LiveView:
    """Shard-local view of the live state: the tombstones owned by one
    shard (local pids) plus counters — what a shard worker needs to
    filter its own SPLADE stage. Delta docs never reach shard workers;
    they are scored at the coordinator."""

    gate = None

    def __init__(self, tombstones=None, generation: int = 0, counters=None):
        self.tombstones = np.sort(np.asarray(
            [] if tombstones is None else tombstones, np.int64).ravel())
        self.generation = int(generation)
        self.counters = dict(counters or {})

    def update(self, tombstones, generation=None, counters=None):
        """Replace the view wholesale (idempotent full-state sync)."""
        self.tombstones = np.sort(np.asarray(
            [] if tombstones is None else tombstones, np.int64).ravel())
        if generation is not None:
            self.generation = int(generation)
        if counters is not None:
            self.counters = dict(counters)

    @property
    def dirty(self) -> bool:
        return self.tombstones.size > 0

    @property
    def base_exclude(self) -> np.ndarray:
        return self.tombstones

    def stats(self) -> dict:
        out = {"tombstones": int(self.tombstones.size),
               "delta_docs": 0, "generation": self.generation}
        out.update(self.counters)
        return out


class LiveIndexState:
    """Owner-side mutable state: the delta segment, the tombstone set,
    the compaction gate, and the delta scoring primitives the serve
    paths compose, each equal bit for bit to its frozen counterpart.
    The geometry lives on ``device`` (the retriever's): upserts are
    encoded there and delta candidates scored there, through the same
    functions and kernel as the base index's."""

    def __init__(self, index, splade, device="cuda"):
        self.device = resolve_device(device)
        self.base_n = int(index.n_docs)
        self.doc_maxlen = int(index.doc_maxlen)
        self.dim = int(index.dim)
        self.nbits = int(index.nbits)
        self.packed_dim = int(index.store.packed_dim)
        self.n_centroids = int(index.n_centroids)
        self.quantum = float(splade.quantum)
        self.vocab = int(splade.vocab)
        self._centroids, self._cutoffs, self._bweights = (
            torch.as_tensor(np.asarray(a, np.float32), device=self.device)
            for a in (index.centroids, index.bucket_cutoffs,
                      index.bucket_weights))

        # append-only delta segment (per-doc arrays, list index = local pid)
        self._cids: list[np.ndarray] = []
        self._packed: list[np.ndarray] = []
        self._doclens: list[int] = []
        self._term_ids: list[np.ndarray] = []
        self._term_weights: list[np.ndarray] = []

        self._tomb: set[int] = set()
        self._tomb_arr = np.zeros(0, np.int64)
        self._tomb_dirty = False

        self.gate = RWGate()
        self._lock = threading.Lock()
        self.counters = {"upserts": 0, "deletes": 0, "compactions": 0,
                         "docs_compacted": 0}

        # lazy caches keyed on (base_n, n_delta)
        self._splade_cache = (None, None)
        self._ivf_cache = (None, None)

    # -- mutation ----------------------------------------------------------
    def encode_doc(self, doc_emb, doc_len=None):
        """Residual-encode one document against the frozen geometry on
        the device. Returns host (cids (L,) int32, packed (L, pd) uint8,
        L)."""
        emb = np.asarray(doc_emb, np.float32)
        if emb.ndim != 2 or emb.shape[1] != self.dim:
            raise ValueError(f"doc_emb must be (L, {self.dim}), got {emb.shape}")
        L = int(emb.shape[0] if doc_len is None else doc_len)
        if not (0 < L <= self.doc_maxlen):
            raise ValueError(f"doc_len {L} outside (0, {self.doc_maxlen}]")
        x = torch.as_tensor(np.ascontiguousarray(emb[:L]), device=self.device)
        cids, _ = kmeans.assign(x, self._centroids)
        packed = residual.encode_residuals(x, cids, self._centroids,
                                           self._cutoffs, self.nbits)
        return cids.cpu().numpy(), packed.cpu().numpy(), L

    def upsert(self, doc_emb, term_ids, term_weights, doc_len=None) -> int:
        """Append one document to the delta segment → its global pid."""
        cids, packed, L = self.encode_doc(doc_emb, doc_len)
        t = np.asarray(term_ids, np.int32).ravel()
        w = np.asarray(term_weights, np.float32).ravel()
        with self._lock:
            j = len(self._doclens)
            self._cids.append(cids)
            self._packed.append(packed)
            self._doclens.append(L)
            self._term_ids.append(t)
            self._term_weights.append(w)
            self.counters["upserts"] += 1
            return self.base_n + j

    def delete(self, gpid: int) -> bool:
        """Tombstone a global pid. False if unknown or already deleted."""
        gpid = int(gpid)
        with self._lock:
            if gpid < 0 or gpid >= self.base_n + len(self._doclens):
                return False
            if gpid in self._tomb:
                return False
            self._tomb.add(gpid)
            self._tomb_dirty = True
            self.counters["deletes"] += 1
            return True

    # -- introspection -----------------------------------------------------
    @property
    def n_delta(self) -> int:
        return len(self._doclens)

    @property
    def dirty(self) -> bool:
        return bool(self._doclens) or bool(self._tomb)

    def tombstone_array(self) -> np.ndarray:
        """Sorted int64 snapshot of all tombstoned global pids."""
        with self._lock:
            if self._tomb_dirty:
                self._tomb_arr = np.array(sorted(self._tomb), np.int64)
                self._tomb_dirty = False
            return self._tomb_arr

    @property
    def base_exclude(self) -> np.ndarray:
        """Tombstoned *base* pids (for SPLADE score exclusion)."""
        t = self.tombstone_array()
        return t[t < self.base_n]

    def local_tombstones(self, lo: int, hi: int) -> np.ndarray:
        """Tombstoned pids within [lo, hi), shifted to shard-local."""
        t = self.tombstone_array()
        return t[(t >= lo) & (t < hi)] - lo

    def is_tombstoned(self, gpids) -> np.ndarray:
        """Vectorised tombstone membership for a global pid array."""
        return np.isin(np.asarray(gpids), self.tombstone_array())

    def stats(self) -> dict:
        with self._lock:
            out = dict(self.counters)
            out["delta_docs"] = len(self._doclens)
            out["delta_tokens"] = int(sum(self._doclens))
            out["tombstones"] = len(self._tomb)
        return out

    # -- SPLADE delta ------------------------------------------------------
    def _delta_splade(self, n: int) -> SpladeIndex:
        key, idx = self._splade_cache
        if key == (self.base_n, n):
            return idx
        T = max(int(t.size) for t in self._term_ids[:n]) if n else 1
        ids = np.full((n, max(T, 1)), -1, np.int32)
        ws = np.zeros((n, max(T, 1)), np.float32)
        for j in range(n):
            t = self._term_ids[j]
            ids[j, :t.size] = t
            ws[j, :t.size] = self._term_weights[j]
        # the base quantum is pinned so delta impacts are bit for bit
        # what a full rebuild (same quantum) produces for these docs
        idx = build_splade_index(ids, ws, self.vocab, n, quantum=self.quantum)
        self._splade_cache = ((self.base_n, n), idx)
        return idx

    def splade_delta_topk(self, term_ids, term_weights, k: int):
        """Delta-only SPLADE top-k on the host → ((B, k) global pids,
        (B, k) scores), padded (-1, 0.0); tombstoned delta docs excluded
        before the top-k."""
        n = self.n_delta
        B = len(term_ids)
        if n == 0:
            return (np.full((B, k), -1, np.int64),
                    np.zeros((B, k), np.float32))
        t = self.tombstone_array()
        excl = t[t >= self.base_n] - self.base_n
        excl = excl[excl < n]
        pids_l, scores = self._delta_splade(n).score_batch_host(
            term_ids, term_weights, k, exclude=excl)
        pids = np.where(pids_l >= 0, pids_l.astype(np.int64) + self.base_n,
                        np.int64(-1))
        return pids, scores

    # -- PLAID delta -------------------------------------------------------
    def _delta_ivf(self, n: int) -> dict:
        key, d = self._ivf_cache
        if key == (self.base_n, n):
            return d
        d = {}
        for j in range(n):
            for c in np.unique(self._cids[j]).tolist():
                d.setdefault(int(c), []).append(j)
        d = {c: np.asarray(js, np.int64) for c, js in d.items()}
        self._ivf_cache = ((self.base_n, n), d)
        return d

    def delta_candidates(self, cids_np) -> list:
        """cids_np (B, Lq, nprobe) probed centroid ids → per-query sorted
        unique *global* delta candidate pids (tombstoned excluded)."""
        n = self.n_delta
        cids_np = np.asarray(cids_np)
        B = cids_np.shape[0]
        if n == 0:
            return [np.zeros(0, np.int64) for _ in range(B)]
        iv = self._delta_ivf(n)
        t = self.tombstone_array()
        excl = t[t >= self.base_n] - self.base_n
        out = []
        for b in range(B):
            locs = [iv[c] for c in np.unique(cids_np[b]).tolist() if c in iv]
            if not locs:
                out.append(np.zeros(0, np.int64))
                continue
            uniq = np.unique(np.concatenate(locs))
            if excl.size:
                uniq = uniq[~np.isin(uniq, excl)]
            out.append(uniq + self.base_n)
        return out

    def delta_candidate_matrix(self, cids_np) -> np.ndarray:
        """:meth:`delta_candidates` as one (B, W) int64 matrix, -1 padded
        (W the longest list's length, at least 1)."""
        lists = self.delta_candidates(cids_np)
        out = np.full((len(lists), max(1, max(map(len, lists), default=0))),
                      -1, np.int64)
        for b, arr in enumerate(lists):
            out[b, :len(arr)] = arr
        return out

    def _gather_delta(self, pids_mat, with_packed: bool):
        """(B, C) global delta pids (-1 pad) → host (codes (B, C, Ld),
        packed (B, C, Ld, pd) | None, valid (B, C, Ld)) — the delta
        twin of ``PLAIDSearcher._dedup_gather``."""
        pids_mat = np.asarray(pids_mat)
        mask = pids_mat >= 0
        local = np.where(mask, pids_mat - self.base_n, 0).astype(np.int64)
        uniq = np.unique(local[mask]) if mask.any() else np.zeros(1, np.int64)
        Ld = self.doc_maxlen
        U = len(uniq)
        codes_u = np.zeros((U, Ld), np.int32)
        valid_u = np.zeros((U, Ld), bool)
        packed_u = (np.zeros((U, Ld, self.packed_dim), np.uint8)
                    if with_packed else None)
        for i, j in enumerate(uniq.tolist()):
            if 0 <= j < len(self._doclens):
                L = self._doclens[j]
                codes_u[i, :L] = self._cids[j]
                valid_u[i, :L] = True
                if with_packed:
                    packed_u[i, :L] = self._packed[j]
        pos = np.minimum(np.searchsorted(uniq, local), U - 1)
        codes = codes_u[pos]
        valid = valid_u[pos] & mask[..., None]
        packed = packed_u[pos] if with_packed else None
        return codes, packed, valid

    def _to_device(self, *arrays):
        return tuple(torch.as_tensor(a, device=self.device) for a in arrays)

    def approx_scores(self, scores_c, q_valid, pids_mat) -> np.ndarray:
        """Stage-3 centroid-interaction scores for delta candidates on
        the device (``scores_c`` (B, Lq, K), ``q_valid`` (B, Lq) device
        tensors; ``pids_mat`` (B, W) host), -inf at -1 slots → host (B,
        W) f32: the frozen stage's scores for the same docs (the same
        ``stage3_approx_score_batch``, each candidate's score its own)."""
        pids_mat = np.asarray(pids_mat)
        codes, _, valid = self._gather_delta(pids_mat, with_packed=False)
        approx = stage3_approx_score_batch(
            scores_c, *self._to_device(codes, valid), q_valid)
        return np.where(pids_mat >= 0, approx.cpu().numpy(),
                        -np.inf).astype(np.float32)

    def exact_scores(self, q, q_valid, pids_mat) -> torch.Tensor:
        """Exact decompress+MaxSim for delta candidates (``q`` (B, Lq,
        d), ``q_valid`` device tensors; ``pids_mat`` (B, C) host) → a
        device (B, C) f32 tensor, -inf at -1 slots. The kernel and the
        argument shapes are ``PLAIDSearcher.exact_score_gathered``'s, so
        each candidate's score is the frozen path's bit for bit."""
        pids_mat = np.asarray(pids_mat)
        codes, packed, valid, mask = self._to_device(
            *self._gather_delta(pids_mat, with_packed=True), pids_mat >= 0)
        scores = decompress_maxsim_scores_batch(
            q, packed, codes, valid, self._centroids, self._bweights,
            nbits=self.nbits, q_valid=q_valid)
        return scores.masked_fill(~mask, float("-inf"))

    # -- compaction --------------------------------------------------------
    def snapshot_delta(self) -> int:
        """Number of delta docs safe to compact (append-only prefix)."""
        with self._lock:
            return len(self._doclens)

    def rebase(self, n_take: int):
        """Drop the compacted prefix and advance base_n. Global pids are
        unchanged (delta doc j becomes base doc base_n + j)."""
        with self._lock:
            del self._cids[:n_take]
            del self._packed[:n_take]
            del self._doclens[:n_take]
            del self._term_ids[:n_take]
            del self._term_weights[:n_take]
            self.base_n += n_take
            self.counters["compactions"] += 1
            self.counters["docs_compacted"] += n_take
            self._splade_cache = (None, None)
            self._ivf_cache = (None, None)


# --------------------------------------------------------------------------
# compaction: delta prefix → new on-disk index directories
# --------------------------------------------------------------------------

def compact_colbert_dir(index, live: LiveIndexState, n_take: int, out_dir):
    """Write a new ColBERT index dir = base + first ``n_take`` delta
    docs through ``write_index`` (the PagedStore pool, the geometry
    copied verbatim, doc lengths and offsets, the IVF rebuilt over the
    full layout). The delta rows were encoded with the same geometry, so
    the files are what the from-scratch builder writes for the
    concatenated corpus. ``tombstones.npy`` rides along for operators
    and cold restarts; serving keeps the set in RAM (pids are stable,
    so it survives the swap as is)."""
    codes = np.concatenate([np.asarray(index.store.codes)]
                           + live._cids[:n_take])
    res = np.concatenate([np.asarray(index.store.residuals)]
                         + live._packed[:n_take])
    doclens = np.concatenate([np.asarray(index.doclens, np.int32),
                              np.asarray(live._doclens[:n_take], np.int32)])
    out = write_index(out_dir, codes, res, index.centroids,
                      index.bucket_cutoffs, index.bucket_weights, doclens,
                      index.n_centroids, doc_maxlen=index.doc_maxlen)
    np.save(out / "tombstones.npy", live.tombstone_array())
    return out


def compact_splade_dir(splade, live: LiveIndexState, n_take: int, out_dir):
    """Write a new SPLADE CSR dir = base postings + first ``n_take``
    delta docs' postings, re-sorted into the builder's (term, pid)
    order and quantised with the *base* quantum — bit for bit the CSR a
    from-scratch build (pinned quantum) produces for the same corpus."""
    base_terms = np.repeat(np.arange(splade.vocab, dtype=np.int64),
                           np.diff(splade.term_offsets))
    ts = [base_terms]
    ps = [np.asarray(splade.pids, np.int64)]
    ims = [np.asarray(splade.impacts, np.uint8)]
    for j in range(n_take):
        t = live._term_ids[j]
        w = live._term_weights[j]
        keep = w > 0  # the same filter build_splade_index applies
        t, w = t[keep].astype(np.int64), w[keep]
        imp = np.clip(np.round(w / max(live.quantum, 1e-9)), 1, 255)
        ts.append(t)
        # delta doc j lands after the base docs of this CSR
        ps.append(np.full(t.shape, splade.n_docs + j, np.int64))
        ims.append(imp.astype(np.uint8))
    terms = np.concatenate(ts)
    pids = np.concatenate(ps)
    imps = np.concatenate(ims)
    order = np.lexsort((pids, terms))
    terms, pids, imps = terms[order], pids[order], imps[order]
    counts = np.bincount(terms, minlength=splade.vocab)
    offsets = np.zeros(splade.vocab + 1, np.int64)
    np.cumsum(counts, out=offsets[1:])
    SpladeIndex(term_offsets=offsets, pids=pids.astype(np.int32),
                impacts=imps, quantum=float(splade.quantum),
                n_docs=int(splade.n_docs + n_take),
                vocab=int(splade.vocab)).save(out_dir)
    return pathlib.Path(out_dir)


# --------------------------------------------------------------------------
# rebuild oracle helpers (tests and chip_smoke.py)
# --------------------------------------------------------------------------

def map_global_to_ref(pids, survivors: np.ndarray):
    """Map global pids → reference (from-scratch rebuild) pids under
    the monotone bijection sorted(survivors) ↔ 0..n-1. -1 passes
    through. The map is monotone, so the (score desc, pid asc) tie
    order every merge uses is preserved, and mapped top-k lists compare
    exactly."""
    pids = np.asarray(pids)
    out = np.full(pids.shape, -1, np.int64)
    m = pids >= 0
    out[m] = np.searchsorted(survivors, pids[m])
    return out


def build_reference_indexes(colbert_dir, splade_dir, doc_embs, doc_lens,
                            term_ids, term_weights, vocab, *,
                            centroids, bucket_cutoffs, bucket_weights,
                            nbits: int, quantum: float, device="cuda"):
    """From-scratch rebuild of a (surviving) corpus with the serve
    index's frozen geometry pinned, encoded on ``device`` — the parity
    oracle."""
    build_colbert_index(colbert_dir, np.asarray(doc_embs, np.float32),
                        np.asarray(doc_lens), nbits=nbits,
                        centroids=centroids, bucket_cutoffs=bucket_cutoffs,
                        bucket_weights=bucket_weights, device=device)
    build_splade_index(np.asarray(term_ids), np.asarray(term_weights),
                       vocab, len(np.asarray(doc_lens)),
                       quantum=quantum).save(splade_dir)
    return colbert_dir, splade_dir


class AutoCompactor(threading.Thread):
    """Background thread: compact when the delta segment crosses a
    threshold. Single-flight by construction (the only caller of
    ``compact_live`` on its retriever). A failed compaction is printed
    with its traceback and counted in ``failures``; the thread keeps
    polling."""

    def __init__(self, retriever, every: int, interval_s: float = 0.25):
        super().__init__(daemon=True, name="live-compactor")
        self.retriever = retriever
        self.every = int(every)
        self.interval_s = interval_s
        self.failures = 0
        self._halt = threading.Event()

    def run(self):
        while not self._halt.wait(self.interval_s):
            live = getattr(self.retriever, "live", None)
            if live is not None and live.n_delta >= self.every:
                try:
                    self.retriever.compact_live()
                except Exception:  # a boundary that must keep running
                    self.failures += 1
                    traceback.print_exc()

    def stop(self, timeout: float = 30.0) -> bool:
        """Stop polling and join for at most ``timeout`` seconds (a
        compaction in progress runs to its end first). → True when the
        thread has ended."""
        self._halt.set()
        self.join(timeout=timeout)
        return not self.is_alive()

