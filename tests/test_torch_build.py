"""The port's index build against the JAX package's, on the CPU.

Each case feeds the same numpy inputs to the JAX function and its port:
the synthetic corpus bit for bit; the IR metrics exactly; ``assign``
ids equal with sims ``allclose(atol=1e-6)`` (both fp32 dot products,
summed in the two libraries' own orders); ``update`` and 4 Lloyd
iterations from JAX's initial rows ``allclose(atol=1e-6)`` with equal
assignments at every step (the per-cluster sums run in another order:
the port's in position order, the JAX ``segment_sum`` in its own);
``fit_codec``, ``encode_residuals`` and a build with pinned geometry bit
for bit. A free build starts from other rows (a torch generator, not
``jax.random``), so it is held on its structure, its reproducibility
and its retrieval quality against the JAX free build of the same
corpus."""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synth as j_synth
from repro.eval import metrics as j_metrics
from repro.index import kmeans as j_kmeans
from repro.index import residual as j_residual
from repro.index.builder import build_colbert_index as j_build
from repro_torch.core.multistage import MultiStageParams, MultiStageRetriever
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.data import synth
from repro_torch.eval import metrics
from repro_torch.index import kmeans, residual
from repro_torch.index.builder import (ColBERTIndex, build_colbert_index,
                                       write_index)
from repro_torch.index.splade_index import build_splade_index

ROOT = pathlib.Path(__file__).resolve().parents[1]
INDEX_FILES = ("residuals.bin", "codes.bin", "centroids.npy",
               "bucket_cutoffs.npy", "bucket_weights.npy", "doclens.npy",
               "doc_offsets.npy", "ivf_pids.bin", "ivf_offsets.npy")
METHODS = ("colbert", "splade", "rerank", "hybrid")
ATOL = 1e-6

CORPUS_CFGS = [
    dict(n_docs=120, n_queries=20, vocab=512, dim=16, n_topics=8,
         doc_maxlen=12, doc_minlen=4, query_maxlen=4, seed=3),
    dict(n_docs=400, n_queries=60, vocab=1024, dim=32, n_topics=24,
         doc_maxlen=20, query_maxlen=6, seed=1),
    dict(n_docs=200, n_queries=30, vocab=800, dim=24, n_topics=12,
         doc_maxlen=16, query_maxlen=5, sem_noise=1.7, lex_gap=0.45,
         lex_drop=0.3, confuser=0.5, seed=23),
]


def flat_tokens(corpus) -> np.ndarray:
    lens, embs = corpus["doc_lens"], corpus["doc_embs"]
    return embs[np.arange(embs.shape[1])[None] < lens[:, None]]


def same_files(a: pathlib.Path, b: pathlib.Path) -> None:
    for name in INDEX_FILES:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name
    assert json.loads((a / "meta.json").read_text()) == \
        json.loads((b / "meta.json").read_text())


def jax_initial_rows(points: np.ndarray, k: int, seed: int = 0):
    """JAX ``train_kmeans``'s starting centroids."""
    idx = jax.random.choice(jax.random.PRNGKey(seed), len(points), (k,),
                            replace=len(points) < k)
    rows = points[np.asarray(idx)]
    return rows / np.maximum(np.linalg.norm(rows, axis=-1, keepdims=True),
                             1e-9)


# ---------------------------------------------------------------------------
# corpus and metrics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", CORPUS_CFGS, ids=["tiny", "small", "ood"])
def test_make_corpus_is_the_reference_bit_for_bit(kw):
    want = j_synth.make_corpus(j_synth.SynthCfg(**kw))
    got = synth.make_corpus(synth.SynthCfg(**kw))
    assert set(got) == set(want)
    for name, arr in want.items():
        if name == "qrels":
            assert got[name] == arr
        elif name == "cfg":
            assert got[name].__dict__ == arr.__dict__
        else:
            assert got[name].dtype == arr.dtype, name
            np.testing.assert_array_equal(got[name], arr, err_msg=name)
            assert got[name].tobytes() == arr.tobytes(), name


def test_make_token_corpus_is_the_reference():
    want = j_synth.make_token_corpus(np.random.default_rng(5), 50, 300, 24)
    got = synth.make_token_corpus(np.random.default_rng(5), 50, 300, 24)
    for a, b in zip(want, got, strict=True):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_metrics_equal_the_reference():
    rng = np.random.default_rng(7)
    ranked = rng.integers(0, 60, (40, 30))
    relevant = [set(rng.choice(60, rng.integers(1, 4), replace=False)
                    .tolist()) for _ in range(40)]
    relevant[3] = set()                 # a query with no relevant doc
    relevant[5] = {int(ranked[5, 0])}   # a hit at rank 1
    graded = [{int(p): float(rng.integers(1, 4)) for p in r}
              for r in relevant]
    for k in (1, 5, 10, 50):
        for fn in ("mrr_at_k", "recall_at_k", "success_at_k", "ndcg_at_k"):
            want = getattr(j_metrics, fn)(ranked, relevant, k)
            got = getattr(metrics, fn)(ranked, relevant, k)
            assert type(got) is type(want) and got == want, (fn, k)
        assert metrics.ndcg_at_k(ranked, graded, k) == \
            j_metrics.ndcg_at_k(ranked, graded, k)
    assert metrics.mrr_at_k(ranked[:0], [], 10) == \
        j_metrics.mrr_at_k(ranked[:0], [], 10) == 0.0


# ---------------------------------------------------------------------------
# k-means
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("chunk", [8192, 1000])
@pytest.mark.parametrize("k", [128, 300])
def test_assign_matches_jax(small_corpus, k, chunk):
    pts = flat_tokens(small_corpus)
    rng = np.random.default_rng(k)
    cent = rng.normal(size=(k, pts.shape[1])).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=-1, keepdims=True)
    want_ids, want_sims = j_kmeans.assign(jnp.asarray(pts), jnp.asarray(cent))
    ids, sims = kmeans.assign(torch.from_numpy(pts), torch.from_numpy(cent),
                              chunk=chunk)
    assert ids.dtype == torch.int32 and sims.dtype == torch.float32
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(sims.numpy(), np.asarray(want_sims),
                               rtol=0, atol=ATOL)


def test_assign_takes_the_first_of_equal_centroids():
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(50, 8)).astype(np.float32)
    cent = rng.normal(size=(6, 8)).astype(np.float32)
    cent = np.concatenate([cent, cent])     # every centroid twice
    ids, _ = kmeans.assign(torch.from_numpy(pts), torch.from_numpy(cent))
    want, _ = j_kmeans.assign(jnp.asarray(pts), jnp.asarray(cent))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want))
    assert ids.max() < 6


def test_update_matches_jax_and_keeps_empty_clusters(small_corpus):
    pts = flat_tokens(small_corpus)
    k = 256
    cent = jax_initial_rows(pts, k).astype(np.float32)
    ids = np.asarray(j_kmeans.assign(jnp.asarray(pts), jnp.asarray(cent))[0])
    # empty some clusters: move their points to cluster 0
    emptied = np.unique(ids)[::7]
    ids = np.where(np.isin(ids, emptied[1:]), emptied[0], ids).astype(
        np.int32)
    want, want_counts = j_kmeans._update(jnp.asarray(pts),
                                         jnp.asarray(cent.copy()),
                                         jnp.asarray(ids))
    got, counts = kmeans.update(torch.from_numpy(pts),
                                torch.from_numpy(cent), torch.from_numpy(ids))
    np.testing.assert_array_equal(counts.numpy(), np.asarray(want_counts))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    empty = counts.numpy() == 0
    assert empty.sum() >= len(emptied) - 1
    np.testing.assert_allclose(got.numpy()[empty], cent[empty], rtol=0,
                               atol=ATOL)


def test_lloyd_from_jax_rows_matches_jax(small_corpus):
    pts = flat_tokens(small_corpus)
    init = jax_initial_rows(pts, 128, seed=4).astype(np.float32)
    jc, tc = jnp.asarray(init), torch.from_numpy(init)
    tpts = torch.from_numpy(pts)
    for step in range(4):
        j_ids, _ = j_kmeans.assign(jnp.asarray(pts), jc)
        t_ids, _ = kmeans.assign(tpts, tc)
        np.testing.assert_array_equal(t_ids.numpy(), np.asarray(j_ids),
                                      err_msg=f"step {step}")
        jc, _ = j_kmeans._update(jnp.asarray(pts), jc, j_ids)
        tc, _ = kmeans.update(tpts, tc, t_ids)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0,
                                   atol=ATOL, err_msg=f"step {step}")
    looped = kmeans.lloyd(tpts, torch.from_numpy(init), 4)
    assert torch.equal(looped, tc)


@pytest.mark.parametrize("n,k", [(500, 64), (40, 64)])
def test_train_kmeans_draws_its_rows_from_a_cpu_generator(n, k):
    rng = np.random.default_rng(n)
    pts = rng.normal(size=(n, 8)).astype(np.float32)
    pts /= np.linalg.norm(pts, axis=-1, keepdims=True)
    start = kmeans.train_kmeans(torch.from_numpy(pts), k, n_iters=0, seed=9)
    again = kmeans.train_kmeans(torch.from_numpy(pts), k, n_iters=0, seed=9)
    assert torch.equal(start, again) and start.shape == (k, 8)
    # each starting centroid is a point: distinct points when N >= K,
    # drawn with replacement otherwise
    dist = np.linalg.norm(start.numpy()[:, None] - pts[None], axis=-1)
    assert dist.min(axis=1).max() < 1e-6
    assert (len(set(dist.argmin(axis=1).tolist())) == k) == (n >= k)
    trained = kmeans.train_kmeans(torch.from_numpy(pts), k, n_iters=3,
                                  seed=9)
    assert torch.equal(trained, kmeans.lloyd(torch.from_numpy(pts), start, 3))


def test_pick_n_centroids_is_the_reference():
    for n in (0, 1, 17, 6390, 43_706, 960_000, 10**9):
        assert kmeans.pick_n_centroids(n) == j_kmeans.pick_n_centroids(n)


# ---------------------------------------------------------------------------
# the codec
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def geometry(built_index):
    """The JAX-built index's centroids, and its tokens' ids against them."""
    cent = np.load(built_index / "centroids.npy")
    return cent, np.fromfile(built_index / "codes.bin", np.int32)


@pytest.mark.parametrize("nbits", [2, 4])
def test_fit_codec_is_the_reference_bit_for_bit(small_corpus, geometry,
                                                nbits):
    cent, cids = geometry
    pts = flat_tokens(small_corpus)
    sample = np.random.default_rng(0).choice(len(pts), 3000, replace=False)
    want = j_residual.fit_codec(cent, pts[sample], cids[sample], nbits)
    got = residual.fit_codec(cent, pts[sample], cids[sample], nbits)
    assert got.nbits == nbits and got.packed_dim() == want.packed_dim()
    for name in ("centroids", "bucket_cutoffs", "bucket_weights"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        assert g.dtype == w.dtype == np.float32 and g.tobytes() == \
            w.tobytes(), name


@pytest.mark.parametrize("nbits", [2, 4])
def test_encode_residuals_is_the_reference_bit_for_bit(small_corpus,
                                                       geometry, nbits):
    cent, cids = geometry
    pts = flat_tokens(small_corpus)
    codec = j_residual.fit_codec(cent, pts, cids, nbits)
    cut = np.array(codec.bucket_cutoffs)
    want = np.asarray(j_residual.encode_residuals(
        jnp.asarray(pts), jnp.asarray(cids), jnp.asarray(cent),
        jnp.asarray(cut), nbits))
    got = residual.encode_residuals(torch.from_numpy(pts),
                                    torch.from_numpy(cids),
                                    torch.from_numpy(cent),
                                    torch.from_numpy(cut), nbits)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()
    # the round trip through the port's decoder
    dec = residual.decode_embeddings(got, torch.from_numpy(cids),
                                     torch.from_numpy(cent),
                                     torch.from_numpy(np.array(
                                         codec.bucket_weights)), nbits)
    want_dec = j_residual.decode_embeddings(
        jnp.asarray(want), jnp.asarray(cids), jnp.asarray(cent),
        codec.bucket_weights, nbits)
    assert dec.numpy().tobytes() == np.asarray(want_dec).tobytes()


# ---------------------------------------------------------------------------
# the build
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("nbits", [2, 4])
def test_pinned_build_writes_the_jax_files(small_corpus, built_index,
                                           tmp_path, nbits):
    """Pinned to the JAX-built index's centroids and codec, the port
    writes that index byte for byte (nbits=4); at nbits=2 it writes what
    the JAX build writes with the same pinned geometry."""
    cent = np.load(built_index / "centroids.npy")
    if nbits == 4:
        ref = built_index
        cut = np.load(built_index / "bucket_cutoffs.npy")
        bw = np.load(built_index / "bucket_weights.npy")
    else:
        cids = np.fromfile(built_index / "codes.bin", np.int32)
        codec = j_residual.fit_codec(cent, flat_tokens(small_corpus), cids, 2)
        cut, bw = (np.asarray(codec.bucket_cutoffs),
                   np.asarray(codec.bucket_weights))
        ref = tmp_path / "jax"
        j_build(ref, small_corpus["doc_embs"], small_corpus["doc_lens"],
                nbits=2, centroids=cent, bucket_cutoffs=cut,
                bucket_weights=bw)
    out = build_colbert_index(
        tmp_path / "port", small_corpus["doc_embs"], small_corpus["doc_lens"],
        nbits=nbits, centroids=cent, bucket_cutoffs=cut, bucket_weights=bw,
        device="cpu")
    same_files(out, ref)


@pytest.fixture(scope="module")
def free_builds(small_corpus, tmp_path_factory):
    """(JAX free build, port free build, port free build again), with the
    builders' defaults (heuristic K, 8 iterations) from seed 0."""
    root = tmp_path_factory.mktemp("free")
    embs, lens = small_corpus["doc_embs"], small_corpus["doc_lens"]
    j_build(root / "jax", embs, lens, nbits=4, seed=0)
    for name in ("port", "again"):
        build_colbert_index(root / name, embs, lens, nbits=4, seed=0,
                            device="cpu")
    return root / "jax", root / "port", root / "again"


def test_free_build_structure(small_corpus, free_builds):
    jax_dir, port_dir, _ = free_builds
    assert sorted(p.name for p in port_dir.iterdir()) == \
        sorted(p.name for p in jax_dir.iterdir())
    lens = small_corpus["doc_lens"]
    n_tokens = int(lens.sum())
    k = max(16, min(kmeans.pick_n_centroids(n_tokens), n_tokens // 4))
    meta = json.loads((port_dir / "meta.json").read_text())
    assert meta == {"n_tokens": n_tokens, "packed_dim": 16, "dim": 32,
                    "nbits": 4, "n_docs": len(lens),
                    "doc_maxlen": small_corpus["doc_embs"].shape[1],
                    "n_centroids": k}
    index = ColBERTIndex(port_dir)
    assert index.centroids.shape == (k, 32)
    np.testing.assert_allclose(np.linalg.norm(index.centroids, axis=-1), 1,
                               atol=1e-5)
    assert np.all(np.diff(index.bucket_cutoffs) >= 0)
    cids = np.fromfile(port_dir / "codes.bin", np.int32)
    assert len(cids) == n_tokens and cids.min() >= 0 and cids.max() < k
    # the IVF lists each (centroid, doc) pair of codes.bin once, pid
    # ascending within a list
    pids = np.repeat(np.arange(len(lens)), lens)
    pairs = set(zip(cids.tolist(), pids.tolist()))
    offs = index.ivf.offsets
    assert offs[0] == 0 and offs[-1] == len(pairs) == len(index.ivf.pids)
    got = set()
    for c in range(k):
        lst = index.ivf.pids[offs[c]:offs[c + 1]]
        assert np.all(np.diff(lst) > 0)
        got |= {(c, int(p)) for p in lst}
    assert got == pairs
    # every token is coded against its nearest centroid
    ids, _ = kmeans.assign(torch.from_numpy(flat_tokens(small_corpus)),
                           torch.from_numpy(index.centroids))
    np.testing.assert_array_equal(ids.numpy(), cids)


def quality(path, corpus) -> dict:
    """MRR@10 of the four methods through the port's retriever on the
    CPU, at the benchmarks' parameters."""
    cfg = corpus["cfg"]
    sidx = build_splade_index(corpus["doc_term_ids"],
                              corpus["doc_term_weights"], cfg.vocab,
                              cfg.n_docs)
    searcher = PLAIDSearcher(ColBERTIndex(path), PlaidParams(
        nprobe=4, candidate_cap=1024, ndocs=256, k=100), device="cpu")
    retr = MultiStageRetriever(sidx, searcher, MultiStageParams(
        first_k=200, k=100, alpha=0.3), device="cpu")
    out = {}
    for m in METHODS:
        pids, _ = retr.search_batch(
            m, q_embs=list(corpus["q_embs"]),
            term_ids=list(corpus["q_term_ids"]),
            term_weights=list(corpus["q_term_weights"]))
        out[m] = metrics.mrr_at_k(pids, corpus["qrels"], 10)
    return out


def test_free_build_quality_holds_to_the_jax_build(small_corpus,
                                                   free_builds):
    jax_dir, port_dir, _ = free_builds
    want, got = quality(jax_dir, small_corpus), quality(port_dir,
                                                        small_corpus)
    assert abs(got["colbert"] - want["colbert"]) <= 0.05, (got, want)
    # the paper-shape relationships of the quality benchmark
    assert got["hybrid"] >= got["rerank"] - 0.01, got
    assert got["hybrid"] > got["splade"], got
    assert got["colbert"] > got["splade"], got


def test_free_build_is_reproducible(free_builds):
    _, port_dir, again = free_builds
    same_files(port_dir, again)


@pytest.mark.parametrize("given", ["centroids", "centroids+cutoffs",
                                   "cutoffs+weights"])
def test_partial_pinning_raises(small_corpus, built_index, tmp_path, given):
    arrays = {"centroids": np.load(built_index / "centroids.npy"),
              "bucket_cutoffs": np.load(built_index / "bucket_cutoffs.npy"),
              "bucket_weights": np.load(built_index / "bucket_weights.npy")}
    names = {"centroids": ["centroids"],
             "centroids+cutoffs": ["centroids", "bucket_cutoffs"],
             "cutoffs+weights": ["bucket_cutoffs", "bucket_weights"]}[given]
    kw = {n: arrays[n] for n in names}
    with pytest.raises(ValueError, match="pinned geometry"):
        build_colbert_index(tmp_path, small_corpus["doc_embs"],
                            small_corpus["doc_lens"], device="cpu", **kw)
    if "centroids" in names:    # the reference refuses these too
        with pytest.raises(ValueError, match="pinned geometry"):
            j_build(tmp_path, small_corpus["doc_embs"],
                    small_corpus["doc_lens"], **kw)


def test_build_on_cuda_raises_without_a_gpu(small_corpus, tmp_path,
                                            monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_colbert_index(tmp_path, small_corpus["doc_embs"],
                            small_corpus["doc_lens"])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("n_weights", [2, 3, 8, 32])
def test_write_index_refuses_a_bucket_table_of_another_length(tmp_path,
                                                              n_weights):
    cids = np.zeros(4, np.int32)
    packed = np.zeros((4, 8), np.uint8)
    cent = np.zeros((2, 16), np.float32)
    with pytest.raises(ValueError, match="bucket weights"):
        write_index(tmp_path, cids, packed, cent,
                    np.zeros(n_weights - 1, np.float32),
                    np.zeros(n_weights, np.float32), np.array([4]), 2)


@pytest.mark.parametrize("nbits", [2, 4])
def test_write_index_reads_nbits_from_the_bucket_table(tmp_path, nbits):
    cids = np.zeros(4, np.int32)
    packed = np.zeros((4, 16 * nbits // 8), np.uint8)
    out = write_index(tmp_path, cids, packed, np.zeros((2, 16), np.float32),
                      np.zeros(2 ** nbits - 1, np.float32),
                      np.zeros(2 ** nbits, np.float32), np.array([4]), 2)
    assert json.loads((out / "meta.json").read_text())["nbits"] == nbits


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

def test_quickstart_driver_on_the_cpu():
    """``examples/quickstart_torch.py --device cpu`` at the JAX
    quickstart's own size; one thread, as the suite runs files side by
    side."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    res = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu"], capture_output=True, text=True, timeout=120,
        env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    rows = {ln.split()[0]: [float(x) for x in ln.split()[1:]]
            for ln in res.stdout.splitlines()
            if ln.split() and ln.split()[0] in METHODS}
    assert set(rows) == set(METHODS)
    for vals in rows.values():
        assert len(vals) == 4 and all(0 <= v <= 1 for v in vals)
    assert rows["hybrid"][0] > rows["splade"][0]
    assert "mmap pool access:" in res.stdout and "done." in res.stdout
