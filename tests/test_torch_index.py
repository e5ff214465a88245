"""The port's index reader and writer against the JAX package's, on an
index the JAX builder wrote: gathers are byte-equal with equal page
counts, ``write_index`` reproduces the JAX builder's file set byte for
byte, and SPLADE stage-1 scoring is equal."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.common import utils as j_utils
from repro.index import residual as j_residual
from repro.index.builder import ColBERTIndex as JIndex
from repro.index.splade_index import (SpladeIndex as JSplade,
                                      build_splade_index as j_build_splade)
from repro_torch import common
from repro_torch.core.store import PagedStore, rss_bytes
from repro_torch.index import residual
from repro_torch.index.builder import ColBERTIndex, write_index
from repro_torch.index.splade_index import SpladeIndex, build_splade_index

INDEX_FILES = ("residuals.bin", "codes.bin", "centroids.npy",
               "bucket_cutoffs.npy", "bucket_weights.npy", "doclens.npy",
               "doc_offsets.npy", "ivf_pids.bin", "ivf_offsets.npy")


@pytest.mark.parametrize("mode", ["mmap", "ram"])
def test_gathers_byte_equal_with_equal_pages(built_index, mode):
    ji, ti = JIndex(built_index, mode=mode), ColBERTIndex(built_index,
                                                          mode=mode)
    rng = np.random.default_rng(0)
    for _ in range(3):
        pids = rng.integers(-1, ji.n_docs, 37)
        for a, b in zip(ji.gather_doc_tokens(pids),
                        ti.gather_doc_tokens(pids)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        for a, b in zip(ji.gather_doc_codes(pids),
                        ti.gather_doc_codes(pids)):
            np.testing.assert_array_equal(a, b)
    assert ji.store.stats.snapshot() == ti.store.stats.snapshot()
    assert ji.store.resident_fraction_estimate() == \
        ti.store.resident_fraction_estimate()
    np.testing.assert_array_equal(ji.ivf.pids, ti.ivf.pids)
    np.testing.assert_array_equal(ji.ivf.offsets, ti.ivf.offsets)


def test_write_index_reproduces_jax_files(built_index, tmp_path):
    ji = JIndex(built_index, mode="ram")
    out = write_index(tmp_path / "idx", np.asarray(ji.store.codes),
                      np.asarray(ji.store.residuals), ji.centroids,
                      ji.bucket_cutoffs, ji.bucket_weights, ji.doclens,
                      ji.n_centroids, doc_maxlen=ji.doc_maxlen)
    for name in INDEX_FILES:
        assert (out / name).read_bytes() == \
            (built_index / name).read_bytes(), name
    assert json.loads((out / "meta.json").read_text()) == \
        json.loads((built_index / "meta.json").read_text())
    ti = ColBERTIndex(out)
    assert ti.store.total_bytes() == ji.store.total_bytes()


def test_write_index_rejects_inconsistent_arrays(tmp_path):
    cids = np.zeros(5, np.int32)
    packed = np.zeros((5, 16), np.uint8)
    cent = np.zeros((4, 32), np.float32)
    bw, cut = np.zeros(16, np.float32), np.zeros(15, np.float32)
    with pytest.raises(ValueError, match="token count"):
        write_index(tmp_path, cids, packed, cent, cut, bw,
                    np.array([2, 2]), 4)
    with pytest.raises(ValueError, match="shorter"):
        write_index(tmp_path, cids, packed, cent, cut, bw,
                    np.array([2, 3]), 4, doc_maxlen=2)
    PagedStore.write(tmp_path / "store", cids, packed, dim=32, nbits=4)
    with pytest.raises(ValueError):
        PagedStore(tmp_path / "store", mode="disk")


@pytest.mark.parametrize("nbits", [2, 4])
def test_residual_decode_matches_jax(nbits):
    rng = np.random.default_rng(nbits)
    d, K = 32, 16
    packed = rng.integers(0, 256, (7, 3, d * nbits // 8), dtype=np.uint8)
    cids = rng.integers(0, K, (7, 3), dtype=np.int32)
    cent = rng.normal(size=(K, d)).astype(np.float32)
    bw = rng.normal(size=2 ** nbits).astype(np.float32)
    np.testing.assert_array_equal(
        residual.unpack_codes(torch.from_numpy(packed), nbits).numpy(),
        np.asarray(j_residual.unpack_codes(jnp.asarray(packed), nbits)))
    np.testing.assert_array_equal(
        residual.decode_embeddings(torch.from_numpy(packed),
                                   torch.from_numpy(cids),
                                   torch.from_numpy(cent),
                                   torch.from_numpy(bw), nbits).numpy(),
        np.asarray(j_residual.decode_embeddings(
            jnp.asarray(packed), jnp.asarray(cids), jnp.asarray(cent),
            jnp.asarray(bw), nbits)))
    assert residual.compression_ratio(128, nbits) == \
        j_residual.compression_ratio(128, nbits)


def test_codec_from_loaded_index(built_index):
    codec = ColBERTIndex(built_index).codec()
    jc = JIndex(built_index).codec()
    assert codec.packed_dim() == jc.packed_dim()
    np.testing.assert_array_equal(codec.centroids.numpy(),
                                  np.asarray(jc.centroids))


@pytest.fixture(scope="module")
def splade_pair(small_corpus, tmp_path_factory):
    c = small_corpus
    args = (c["doc_term_ids"], c["doc_term_weights"], c["cfg"].vocab,
            c["cfg"].n_docs)
    path = tmp_path_factory.mktemp("splade")
    j_build_splade(*args).save(path)
    return args, path


def test_splade_build_and_files_match_jax(splade_pair, tmp_path):
    args, path = splade_pair
    build_splade_index(*args).save(tmp_path)
    for name in ("term_offsets.npy", "postings_pids.bin",
                 "postings_imps.bin", "meta.json"):
        assert (tmp_path / name).read_bytes() == (path / name).read_bytes()


@pytest.mark.parametrize("mmap", [False, True])
def test_splade_scoring_matches_jax(splade_pair, small_corpus, mmap):
    _, path = splade_pair
    js, ts = JSplade.load(path, mmap=mmap), SpladeIndex.load(path, mmap=mmap)
    tids, tw = small_corpus["q_term_ids"][:9], small_corpus["q_term_weights"][:9]
    for k in (1, 20, 50, ts.n_docs + 3):
        for a, b in zip(js.score_batch_host(tids, tw, k),
                        ts.score_batch_host(tids, tw, k)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(js.score_host(tids[0], tw[0], 20),
                    ts.score_host(tids[0], tw[0], 20)):
        np.testing.assert_array_equal(a, b)
    excl = np.array([0, 5, 17])
    for a, b in zip(js.score_batch_host(tids, tw, 20, exclude=excl),
                    ts.score_batch_host(tids, tw, 20, exclude=excl)):
        np.testing.assert_array_equal(a, b)


def test_common_helpers_match_jax():
    for n in (1, 2, 3, 7, 8, 9, 200, 4097):
        assert common.next_pow2(n) == j_utils.next_pow2(n)
        for m in (1, 4, 8, 16):
            assert common.round_up(n, m) == j_utils.round_up(n, m)
            assert common.cdiv(n, m) == j_utils.cdiv(n, m)
    assert rss_bytes() > 0
