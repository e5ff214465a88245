"""PagedStore: the paper's memory-mapped index pool.

The compressed index tensors (packed residual codes + centroid ids) live
in files and are opened fully in RAM (``mode="ram"``, the ColBERTv2
baseline) or memory-mapped (``mode="mmap"``, the paper's system). Every
gather records which 4 KiB pages of the residual file it touches, so
tests can check the multi-stage pipeline's access-minimisation claim.
The on-disk format is the JAX package's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
import threading
from typing import Optional

import numpy as np

PAGE_BYTES = 4096


def rss_bytes() -> int:
    """Resident set size of this process (Linux)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024
    return -1


@dataclasses.dataclass
class AccessStats:
    """Mmap access accounting. All mutation goes through :meth:`account`
    under a lock; readers that need a coherent view take
    :meth:`snapshot`."""

    gathers: int = 0
    tokens_read: int = 0
    pages_touched: int = 0            # residual pages, cumulative
    unique_pages: Optional[set] = None  # residual pages, deduplicated
    residual_gathers: int = 0         # gathers that faulted residual rows
    residual_tokens_read: int = 0     # rows read from the residual file

    def __post_init__(self):
        self._lock = threading.Lock()

    def reset(self):
        with self._lock:
            self.gathers = 0
            self.tokens_read = 0
            self.pages_touched = 0
            self.unique_pages = set()
            self.residual_gathers = 0
            self.residual_tokens_read = 0

    def account(self, token_ids: np.ndarray, packed_dim: int,
                residuals: bool = True):
        """Record one gather of ``token_ids`` rows (atomically)."""
        n = int(token_ids.size)
        if residuals:
            byte_lo = token_ids.astype(np.int64) * packed_dim
            pages = np.unique(byte_lo // PAGE_BYTES)
        with self._lock:
            self.gathers += 1
            self.tokens_read += n
            if not residuals:
                return
            self.residual_gathers += 1
            self.residual_tokens_read += n
            self.pages_touched += len(pages)
            if self.unique_pages is not None:
                self.unique_pages.update(pages.tolist())

    def snapshot(self) -> dict:
        with self._lock:
            return {"gathers": self.gathers,
                    "tokens_read": self.tokens_read,
                    "pages_touched": self.pages_touched,
                    "unique_pages": len(self.unique_pages or ()),
                    "residual_gathers": self.residual_gathers,
                    "residual_tokens_read": self.residual_tokens_read}


class PagedStore:
    """Column store of per-token index payloads with ram/mmap modes."""

    def __init__(self, path, mode: str = "mmap"):
        self.path = pathlib.Path(path)
        self.mode = mode
        meta = json.loads((self.path / "meta.json").read_text())
        self.n_tokens = meta["n_tokens"]
        self.packed_dim = meta["packed_dim"]
        self.nbits = meta["nbits"]
        self.dim = meta["dim"]

        if mode == "mmap":
            self.residuals = np.memmap(self.path / "residuals.bin", np.uint8,
                                       "r", shape=(self.n_tokens,
                                                   self.packed_dim))
            self.codes = np.memmap(self.path / "codes.bin", np.int32, "r",
                                   shape=(self.n_tokens,))
        elif mode == "ram":
            self.residuals = np.fromfile(self.path / "residuals.bin",
                                         np.uint8).reshape(self.n_tokens,
                                                           self.packed_dim)
            self.codes = np.fromfile(self.path / "codes.bin", np.int32)
        else:
            raise ValueError(mode)
        if self.codes.size != self.n_tokens:
            raise ValueError(f"{self.path}: codes.bin holds "
                             f"{self.codes.size} ids, meta says "
                             f"{self.n_tokens}")
        self.stats = AccessStats()
        self.stats.reset()

    # -- access ---------------------------------------------------------
    def gather_ranges(self, starts: np.ndarray, length: int):
        """Uniform-stride gather: rows [s, s+length) per start (clamped)."""
        flat = self._range_ids(starts, length)
        res = self.residuals[flat].reshape(len(starts), length,
                                           self.packed_dim)
        cds = self.codes[flat].reshape(len(starts), length)
        self.stats.account(flat, self.packed_dim)
        return cds, res

    def gather_codes_ranges(self, starts: np.ndarray, length: int):
        """Codes-only uniform-stride gather: reads centroid ids and never
        touches a residual page."""
        flat = self._range_ids(starts, length)
        cds = self.codes[flat].reshape(len(starts), length)
        self.stats.account(flat, self.packed_dim, residuals=False)
        return cds

    def _range_ids(self, starts: np.ndarray, length: int):
        idx = starts[:, None] + np.arange(length)[None, :]
        idx = np.minimum(idx, self.n_tokens - 1)
        return idx.reshape(-1)

    # -- info -------------------------------------------------------------
    def total_bytes(self) -> int:
        return self.n_tokens * (self.packed_dim + 4)

    def resident_fraction_estimate(self) -> float:
        """Fraction of the pool's pages ever touched (mmap working set)."""
        total_pages = max(1, self.total_bytes() // PAGE_BYTES)
        return len(self.stats.unique_pages or ()) / total_pages

    # -- construction ------------------------------------------------------
    @staticmethod
    def write(path, codes: np.ndarray, residuals: np.ndarray, *, dim: int,
              nbits: int):
        path = pathlib.Path(path)
        path.mkdir(parents=True, exist_ok=True)
        n_tokens, packed_dim = residuals.shape
        residuals.astype(np.uint8).tofile(path / "residuals.bin")
        codes.astype(np.int32).tofile(path / "codes.bin")
        (path / "meta.json").write_text(json.dumps({
            "n_tokens": int(n_tokens), "packed_dim": int(packed_dim),
            "dim": dim, "nbits": nbits}))
