"""The port's CUDA kernels and serving path on the card.

Every test here needs an NVIDIA GPU and nvcc; without one it skips. The
file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held to their plain PyTorch versions (scores
``allclose(rtol=1e-5, atol=1e-5)``: the kernel sums each dot product in
a fixed sequential order, the plain version through cuBLAS, and the
plain SPLADE version on the card through atomics; ids equal up to tie
groups), and bit for bit wherever the port promises it: the fused tail
to the split tail, the SPLADE kernel to the ordered plain version on the
CPU and to the host scorer, MaxSim on decoded embeddings to
decompress+MaxSim.
"""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch.common import HostCopy
from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import (PLAIDSearcher, PlaidParams,
                                    stage2_candidates_batch,
                                    stage3_approx_score_batch)
from repro_torch.data.synth import SynthCfg, make_corpus
from repro_torch.index import kmeans
from repro_torch.index.builder import (ColBERTIndex, build_colbert_index,
                                       write_index)
from repro_torch.index.residual import encode_residuals, fit_codec
from repro_torch.index.residual import decode_embeddings
from repro_torch.index.splade_device import SpladeDeviceCache
from repro_torch.index.splade_index import SpladeIndex, build_splade_index
from repro_torch.kernels import _build
from repro_torch.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores_batch)
from repro_torch.kernels.fused_rerank.ops import fused_rerank_topk_batch
from repro_torch.kernels.fused_rerank.ref import stable_topk
from repro_torch.kernels.maxsim.ops import maxsim_scores, maxsim_scores_batch
from repro_torch.kernels.maxsim.ref import maxsim_scores_ref
from repro_torch.kernels.splade_score.ops import (
    TOPK_BLOCK_DOCS, sort_rows, splade_block_scores,
    splade_block_scores_batch, splade_block_topk_batch,
    splade_row_block_candidates, splade_row_scores_batch,
    splade_row_topk_batch)
from repro_torch.kernels.splade_score.ref import (block_topk_ref,
                                                  splade_block_scores_batch_ref,
                                                  splade_row_scores_batch_ref)
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.pipeline import (DEVICE, HOST, CandidateBatch,
                                          PipelineExecutor, Stage, StagePlan)
from repro_torch.testing import (REF_MARGIN, assert_colbert_match,
                                 assert_topk_match)

TOL = dict(rtol=1e-5, atol=1e-5)
TIMEOUT = 30.0          # seconds: the bound on every wait of the pipeline
SLEEP_CYCLES = 1_000_000_000   # torch.cuda._sleep: ~0.5 s of device time

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _case(seed, B, C, Ld, nbits, K, d, Lq):
    rng = np.random.default_rng(seed)
    arrs = (rng.normal(size=(B, Lq, d)).astype(np.float32),
            rng.integers(0, 256, (B, C, Ld, d * nbits // 8), dtype=np.uint8),
            rng.integers(0, K, (B, C, Ld), dtype=np.int32),
            rng.random((B, C, Ld)) < 0.8,
            rng.random((B, C)) < 0.85,
            rng.normal(size=(K, d)).astype(np.float32),
            np.linspace(-0.3, 0.3, 2 ** nbits, dtype=np.float32),
            rng.random((B, Lq)) < 0.9)
    return tuple(torch.from_numpy(a) for a in arrs)


@pytest.mark.parametrize("nbits,B,C,Ld,k,K,d,Lq", [
    (4, 3, 40, 12, 10, 500, 128, 32),
    (2, 2, 17, 5, 30, 64, 64, 8),        # k > C
    (4, 1, 1, 1, 1, 8, 32, 4),
    # the serve width (C=200, Ld=180, Lq=32, d=128) at B=1 and B=2
    (4, 1, 200, 180, 100, 4096, 128, 32),
    (2, 1, 200, 180, 100, 4096, 128, 32),
    (4, 2, 200, 180, 256, 4096, 128, 32),
    (2, 2, 200, 180, 100, 4096, 128, 32),
    # C not a multiple of the candidate group, Ld of the token chunk
    (4, 2, 201, 70, 50, 300, 64, 16),
    (4, 3, 17, 130, 5, 300, 128, 32),
    (2, 2, 1, 1, 3, 64, 64, 8),          # C = 1, Ld = 1
    (4, 2, 33, 1, 40, 64, 32, 32),       # Ld = 1, d = 32
    # one query token, and the most the kernel takes
    (4, 2, 24, 20, 8, 128, 128, 1),
    (2, 2, 24, 20, 8, 128, 128, 128),
    # a width whose tile only fits with one warp and windows of 4 tokens
    (4, 2, 9, 7, 5, 64, 1024, 48),
])
def test_kernels_match_plain(cuda, nbits, B, C, Ld, k, K, d, Lq):
    case = list(_case(nbits + C, B, C, Ld, nbits, K, d, Lq))
    if C > 2:
        case[3][:, C // 2] = False        # a candidate with no valid token
    if B > 1:
        case[4][B - 1] = False            # a row with every candidate masked
    q, packed, cids, valid, cmask, cent, bw, qv = case
    dev = tuple(t.to(cuda) for t in case)
    launches = (decompress_maxsim_scores_batch.launches,
                fused_rerank_topk_batch.launches)
    got = decompress_maxsim_scores_batch(*dev[:4], *dev[5:7], nbits=nbits,
                                         q_valid=dev[7])
    want = decompress_maxsim_scores_batch(q, packed, cids, valid, cent, bw,
                                          nbits=nbits, q_valid=qv)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **TOL)
    vals, idx = fused_rerank_topk_batch(*dev[:7], nbits=nbits, k=k,
                                        q_valid=dev[7])
    wv, wi = fused_rerank_topk_batch(q, packed, cids, valid, cmask, cent, bw,
                                     nbits=nbits, k=k + REF_MARGIN,
                                     q_valid=qv)
    assert_topk_match(wv.numpy(), wi.numpy(), vals.cpu().numpy(),
                      idx.cpu().numpy())
    assert (decompress_maxsim_scores_batch.launches,
            fused_rerank_topk_batch.launches) == (launches[0] + 1,
                                                  launches[1] + 1)
    # fused == split, bit for bit
    kk = min(k, C)
    sv, si = stable_topk(got.masked_fill(~dev[4], float("-inf")), kk)
    np.testing.assert_array_equal(idx[:, :kk].cpu().numpy(), si.cpu().numpy())
    np.testing.assert_array_equal(vals[:, :kk].cpu().numpy().view(np.uint32),
                                  sv.cpu().numpy().view(np.uint32))
    # a B=1 launch equals its batch row, bit for bit
    for b in {0, B - 1}:
        one = decompress_maxsim_scores_batch(
            *(t[b:b + 1] for t in dev[:4]), *dev[5:7], nbits=nbits,
            q_valid=dev[7][b:b + 1])
        np.testing.assert_array_equal(one.cpu().numpy().view(np.uint32),
                                      got[b:b + 1].cpu().numpy()
                                      .view(np.uint32))
        v1, i1 = fused_rerank_topk_batch(
            *(t[b:b + 1] for t in dev[:5]), *dev[5:7], nbits=nbits, k=k,
            q_valid=dev[7][b:b + 1])
        np.testing.assert_array_equal(i1.cpu().numpy(), idx[b:b + 1].cpu()
                                      .numpy())
        np.testing.assert_array_equal(v1.cpu().numpy().view(np.uint32),
                                      vals[b:b + 1].cpu().numpy()
                                      .view(np.uint32))


def test_tile_takes_every_shape_the_per_warp_tile_took(cuda):
    """The register-tiled body never refuses a shape that the earlier
    one-warp-per-candidate tile took: (Lq·(d+4) + 8·d + 16) floats of
    shared memory, at most 232,448 bytes."""
    lib = _build.load()
    for nbits in (2, 4):
        for d in range(32, 1025, 32):
            for Lq in range(1, 129):
                if (Lq * (d + 4) + 8 * d + 16) * 4 > _build.MAX_SMEM_BYTES:
                    continue
                assert lib.decompress_maxsim_smem_bytes(Lq, d, nbits) \
                    <= _build.MAX_SMEM_BYTES, (Lq, d, nbits)
                assert lib.fused_rerank_smem_bytes(Lq, d, nbits, 200) \
                    <= _build.MAX_SMEM_BYTES, (Lq, d, nbits)


def test_wrappers_reject_mixed_devices(cuda):
    q, packed, cids, valid, cmask, cent, bw, qv = _case(1, 1, 4, 2, 4, 8,
                                                        32, 4)
    with pytest.raises(ValueError, match="span devices"):
        decompress_maxsim_scores_batch(q.to(cuda), packed, cids, valid, cent,
                                       bw, nbits=4, q_valid=qv)
    with pytest.raises(TypeError, match="int32"):
        decompress_maxsim_scores_batch(
            *(t.to(cuda) for t in (q, packed, cids.long(), valid, cent, bw)),
            nbits=4, q_valid=qv.to(cuda))


@pytest.fixture
def index_dir(tmp_path):
    rng = np.random.default_rng(0)
    n_docs, d, nbits, K, vocab = 300, 64, 4, 256, 500
    doclens = rng.integers(4, 25, n_docs)
    n_tok = int(doclens.sum())
    write_index(tmp_path / "colbert", rng.integers(0, K, n_tok, dtype=np.int32),
                rng.integers(0, 256, (n_tok, d * nbits // 8), dtype=np.uint8),
                rng.normal(size=(K, d)).astype(np.float32),
                np.sort(rng.normal(size=15)),
                np.sort(rng.normal(scale=0.1, size=16)), doclens, K,
                doc_maxlen=24)
    build_splade_index(rng.integers(0, vocab, (n_docs, 20)),
                       rng.uniform(0.1, 2, (n_docs, 20)), vocab,
                       n_docs).save(tmp_path / "splade")
    return tmp_path


def _retriever(path, device):
    return MultiStageRetriever(
        SpladeIndex.load(path / "splade"),
        PLAIDSearcher(ColBERTIndex(path / "colbert"), device=device),
        MultiStageParams(first_k=60, k=30), device=device)


def test_serving_path_matches_cpu(cuda, index_dir):
    rng = np.random.default_rng(1)
    n = 12
    kw = dict(q_embs=[rng.normal(size=(int(rng.integers(4, 33)), 64))
                      .astype(np.float32) for _ in range(n)],
              term_ids=[rng.integers(0, 500, 8) for _ in range(n)],
              term_weights=[rng.uniform(0.1, 2, 8).astype(np.float32)
                            for _ in range(n)],
              alpha=list(np.linspace(0, 1, n)), k=30)
    gpu, cpu = _retriever(index_dir, cuda), _retriever(index_dir, "cpu")
    for method in METHODS:
        want = cpu.search_batch(method, **dict(kw, k=kw["k"] + REF_MARGIN))
        gpu.set_rerank_backend("fused")
        fused = gpu.search_batch(method, **kw)
        gpu.set_rerank_backend("split")
        split = gpu.search_batch(method, **kw)
        if method == "colbert":
            # a tie at the probe's or the approximate stage's boundary
            # may change the candidates: held to the tie rule
            for b, q in enumerate(kw["q_embs"]):
                assert_colbert_match(
                    cpu.searcher, gpu.searcher, q,
                    (want[1][b], want[0][b]), (fused[1][b], fused[0][b]),
                    what=f"colbert row {b}")
        else:
            assert_topk_match(want[1], want[0], fused[1], fused[0],
                              what=method)
        np.testing.assert_array_equal(fused[0], split[0])
        np.testing.assert_array_equal(fused[1].view(np.uint32),
                                      split[1].view(np.uint32))


@pytest.mark.parametrize("B,Qt,max_df,n_docs,imp", [
    (3, 8, 64, 500, "f32"),
    (5, 16, 16, 700, "u8"),
    (2, 4, 300, 9000, "f32"),       # n_docs past one doc block, ragged
    (1, 1, 1, 1, "u8"),
])
def test_splade_kernel_matches_plain(cuda, B, Qt, max_df, n_docs, imp):
    """Kernel against the plain version on the card (atomics: a
    tolerance) and on the CPU (the same order: bit for bit), with -1
    pads, repeated pids in a row and disabled term slots."""
    rng = np.random.default_rng(B * 100 + Qt)
    pids = rng.integers(-1, min(n_docs, 40) if B == 5 else n_docs,
                        (B, Qt, max_df)).astype(np.int32)
    imps = (rng.integers(1, 256, (B, Qt, max_df)).astype(np.uint8)
            if imp == "u8" else rng.random((B, Qt, max_df), np.float32))
    w = rng.random((B, Qt), np.float32)
    w[0, 0] = 0.0
    cpu = tuple(map(torch.from_numpy, (pids, imps, w)))
    dev = tuple(t.to(cuda) for t in cpu)
    before = splade_row_scores_batch.launches
    got = splade_block_scores_batch(*dev, n_docs=n_docs)
    assert splade_row_scores_batch.launches == before + 1
    on_card = splade_block_scores_batch_ref(*dev, n_docs)
    torch.cuda.synchronize()
    np.testing.assert_allclose(got.cpu().numpy(), on_card.cpu().numpy(),
                               **TOL)
    want = splade_block_scores_batch(*cpu, n_docs=n_docs)
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint32),
                                  want.numpy().view(np.uint32))
    one = splade_block_scores(*(t[B - 1] for t in dev), n_docs=n_docs)
    assert torch.equal(one, got[B - 1])


def _bits(t):
    return t.cpu().numpy().view(np.uint32)


@pytest.mark.parametrize("entry", ["row_scores", "gathered_batch",
                                   "gathered_one"])
def test_splade_scores_on_unsorted_rows(cuda, entry):
    """The scores entry points on unsorted gathered rows (repeated pids,
    pads in the middle, pids past n_docs, a ragged last doc block): the
    row entry on the rows sorted by ``sort_rows``, and the gathered
    entries, which sort them stably themselves; each equals the plain
    version on the unsorted rows bit for bit, in one launch."""
    rng = np.random.default_rng(7)
    B, Qt, max_df, n_docs = 3, 6, 700, 9000
    pids = rng.integers(-1, n_docs + 50, (B, Qt, max_df)).astype(np.int32)
    pids[:, :, ::7] = pids[:, :, 1::7][:, :, :pids[:, :, ::7].shape[2]]
    assert (np.diff(pids, axis=-1) < 0).any()
    imps = rng.integers(1, 256, (B, Qt, max_df)).astype(np.uint8)
    w = rng.random((B, Qt), np.float32)
    w[1] = 0.0                                     # an all-zero query
    cpu = tuple(map(torch.from_numpy, (pids, imps, w)))
    dev = tuple(t.to(cuda) for t in cpu)
    want = splade_block_scores_batch_ref(*cpu, n_docs)
    before = splade_row_scores_batch.launches
    if entry == "row_scores":
        sp, si = sort_rows(dev[0].view(B * Qt, max_df),
                           dev[1].view(B * Qt, max_df))
        rows = torch.arange(B * Qt, dtype=torch.int32,
                            device=cuda).view(B, Qt)
        got = splade_row_scores_batch(sp, si, rows, dev[2], n_docs=n_docs)
    elif entry == "gathered_batch":
        got = splade_block_scores_batch(*dev, n_docs=n_docs)
    else:
        got = splade_block_scores(*(t[B - 1] for t in dev),
                                  n_docs=n_docs)[None]
        want = want[B - 1:]
    assert splade_row_scores_batch.launches == before + 1
    np.testing.assert_array_equal(_bits(got), want.numpy().view(np.uint32))
    if entry != "gathered_one":
        assert (got[1] == 0).all()


@pytest.mark.parametrize("n_docs", [3 * TOPK_BLOCK_DOCS - 777,
                                    2 * TOPK_BLOCK_DOCS])
def test_splade_topk_matches_plain(cuda, n_docs):
    """The top-k launch against its plain version bit for bit — its
    per-block candidates and its merged top-k — for k around the block
    size, with a ragged last block (or none), quantised impacts that tie
    often, most docs at zero and an all-zero query."""
    rng = np.random.default_rng(n_docs)
    R, max_df, B, Qt = 64, 600, 4, 8
    pids = np.sort(rng.integers(0, n_docs, (R, max_df)), axis=1)
    pids[:, max_df - 50:] = -1                     # pads last
    imps = rng.integers(1, 4, (R, max_df)).astype(np.uint8)
    rows = rng.integers(-1, R, (B, Qt)).astype(np.int32)
    w = rng.choice(np.float32([0.0, 0.5, 1.0]), (B, Qt))
    w[2] = 0.0                                     # an all-zero query
    cpu = (torch.from_numpy(pids.astype(np.int32)), torch.from_numpy(imps),
           torch.from_numpy(rows), torch.from_numpy(w))
    dev = tuple(t.to(cuda) for t in cpu)
    ordered = splade_row_scores_batch_ref(*cpu, n_docs)
    for k in (1, 200, TOPK_BLOCK_DOCS - 1, TOPK_BLOCK_DOCS,
              TOPK_BLOCK_DOCS + 1, n_docs):
        before = splade_row_topk_batch.launches
        cs, cp = splade_row_block_candidates(*dev, n_docs=n_docs, k=k)
        assert splade_row_topk_batch.launches == before + 1
        ws, wp = block_topk_ref(ordered, k, TOPK_BLOCK_DOCS)
        np.testing.assert_array_equal(cp.cpu().numpy(), wp.numpy())
        np.testing.assert_array_equal(_bits(cs), _bits(ws))
        tp, ts = splade_row_topk_batch(*dev, n_docs=n_docs, k=k)
        assert splade_row_topk_batch.launches == before + 2
        hp, hs = splade_row_topk_batch(*cpu, n_docs=n_docs, k=k)
        np.testing.assert_array_equal(tp.cpu().numpy(), hp.numpy())
        np.testing.assert_array_equal(_bits(ts), _bits(hs))
        np.testing.assert_array_equal(tp[2].cpu().numpy(), np.arange(k))
    gp, gs = splade_block_topk_batch(dev[0][dev[2].long().clamp(min=0)],
                                     dev[1][dev[2].long().clamp(min=0)],
                                     dev[3] * (dev[2] >= 0), n_docs=n_docs,
                                     k=300)
    hp, hs = splade_row_topk_batch(*cpu, n_docs=n_docs, k=300)
    np.testing.assert_array_equal(gp.cpu().numpy(), hp.numpy())
    np.testing.assert_array_equal(_bits(gs), _bits(hs))


def test_splade_device_cache_equals_host_bitwise(cuda, index_dir):
    idx = SpladeIndex.load(index_dir / "splade")
    rng = np.random.default_rng(2)
    tids = [rng.integers(0, 500, int(rng.integers(1, 12))) for _ in range(9)]
    tw = [rng.uniform(0.1, 2, len(t)).astype(np.float32) for t in tids]
    tw[3][:] = 0.0                                   # an all-zero query
    cache = SpladeDeviceCache(idx, device=cuda)
    assert cache.pids.is_cuda and cache.truncated_terms == 0
    for k in (1, 60, idx.n_docs + 7):
        dp, ds = cache.score_topk(tids, tw, k)
        hp, hs = idx.score_batch_host(tids, tw, k)
        np.testing.assert_array_equal(dp, hp)
        np.testing.assert_array_equal(ds.view(np.uint32), hs.view(np.uint32))
    with pytest.raises(IndexError, match="out of range"):
        cache.score_topk([np.array([idx.vocab])], [np.ones(1, np.float32)],
                         5)


def test_maxsim_kernel_matches_plain_and_decompress(cuda):
    rng = np.random.default_rng(5)
    B, C, Ld, Lq, d, K, nbits = 3, 40, 12, 32, 128, 500, 4
    q = torch.from_numpy(rng.normal(size=(B, Lq, d)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(0, 256, (B, C, Ld, d * nbits // 8),
                                           dtype=np.uint8))
    cids = torch.from_numpy(rng.integers(0, K, (B, C, Ld), dtype=np.int32))
    valid = torch.from_numpy(rng.random((B, C, Ld)) < 0.8)
    valid[1, 7] = False                              # an all-invalid doc
    qv = torch.from_numpy(rng.random((B, Lq)) < 0.9)
    cent = torch.from_numpy(rng.normal(size=(K, d)).astype(np.float32))
    bw = torch.linspace(-0.3, 0.3, 2 ** nbits)
    q, packed, cids, valid, qv, cent, bw = (
        t.to(cuda) for t in (q, packed, cids, valid, qv, cent, bw))
    emb = decode_embeddings(packed, cids, cent, bw, nbits)
    before = maxsim_scores_batch.launches
    got = maxsim_scores_batch(q, emb, valid, qv)
    assert maxsim_scores_batch.launches == before + 1
    want = maxsim_scores_ref(q, emb, valid, qv)
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), **TOL)
    assert got[1, 7].item() == 0.0
    dms = decompress_maxsim_scores_batch(q, packed, cids, valid, cent, bw,
                                         nbits=nbits, q_valid=qv)
    assert torch.equal(got.view(torch.int32), dms.view(torch.int32))
    one = maxsim_scores(q[2], emb[2], valid[2], qv[2])
    assert torch.equal(one, got[2])
    half = maxsim_scores_batch(q.bfloat16(), emb.bfloat16(), valid, qv)
    assert half.dtype == torch.float32


def test_device_stage1_serving_matches_cpu(cuda, index_dir):
    rng = np.random.default_rng(3)
    n = 10
    kw = dict(q_embs=[rng.normal(size=(int(rng.integers(4, 33)), 64))
                      .astype(np.float32) for _ in range(n)],
              term_ids=[rng.integers(0, 500, 8) for _ in range(n)],
              term_weights=[rng.uniform(0.1, 2, 8).astype(np.float32)
                            for _ in range(n)],
              alpha=list(np.linspace(0, 1, n)), k=30)
    gpu = _retriever(index_dir, cuda)
    ServeEngine(gpu, splade_backend="device")
    cpu = _retriever(index_dir, "cpu")
    dp, ds = gpu.run_splade_batch(kw["term_ids"], kw["term_weights"])
    hp, hs = gpu.run_splade_batch(kw["term_ids"], kw["term_weights"],
                                  backend="host")
    np.testing.assert_array_equal(dp, hp)
    np.testing.assert_array_equal(ds.view(np.uint32), hs.view(np.uint32))
    for method in ("splade", "rerank", "hybrid"):
        before = splade_row_topk_batch.launches
        got = gpu.search_batch(method, **kw)
        assert splade_row_topk_batch.launches == before + 1
        want = cpu.search_batch(method, **dict(kw, k=kw["k"] + REF_MARGIN))
        assert_topk_match(want[1], want[0], got[1], got[0], what=method)


def test_splade_device_cache_sorts_unsorted_rows(cuda, index_dir):
    """An untruncated index whose postings are out of pid order (each
    term's reversed): the cache sorts its rows for the kernel's search,
    and the device stage 1 still equals the host scorer bit for bit."""
    idx = SpladeIndex.load(index_dir / "splade")
    off = idx.term_offsets
    order = np.concatenate([np.arange(off[t + 1] - 1, off[t] - 1, -1)
                            for t in range(idx.vocab)]).astype(np.int64)
    rev = dataclasses.replace(idx, pids=np.asarray(idx.pids)[order],
                              impacts=np.asarray(idx.impacts)[order])
    cache = SpladeDeviceCache(rev, device=cuda)
    assert cache.truncated_terms == 0 and cache.row_pids is not cache.pids
    rng = np.random.default_rng(3)
    tids = [rng.integers(0, 500, int(rng.integers(1, 12))) for _ in range(9)]
    tw = [rng.uniform(0.1, 2, len(t)).astype(np.float32) for t in tids]
    for k in (60, rev.n_docs + 7):
        dp, ds = cache.score_topk(tids, tw, k)
        hp, hs = rev.score_batch_host(tids, tw, k)
        np.testing.assert_array_equal(dp, hp)
        np.testing.assert_array_equal(ds.view(np.uint32), hs.view(np.uint32))


def test_colbert_on_card_matches_cpu(cuda, index_dir):
    """``colbert`` on the card, mmap and resident pools, fused and split
    tails, at a cap that binds: every answer equals the CPU engine's
    under the tie rule; within the card fused == split and resident ==
    mmap bit for bit; the resident path launches fused_rerank and no
    SPLADE kernel; the codes gather touches no residual page."""
    rng = np.random.default_rng(5)
    qs = [rng.normal(size=(int(rng.integers(4, 33)), 64)).astype(np.float32)
          for _ in range(12)]
    params = PlaidParams(nprobe=4, candidate_cap=96, ndocs=40, k=30)

    def retriever(device, resident=False):
        return MultiStageRetriever(
            SpladeIndex.load(index_dir / "splade"),
            PLAIDSearcher(ColBERTIndex(index_dir / "colbert"), params,
                          device_resident=resident, device=device),
            MultiStageParams(first_k=60, k=30), device=device)

    cpu = retriever("cpu")
    want = cpu.search_batch("colbert", q_embs=qs, k=30 + REF_MARGIN)
    answers = {}
    for pool in ("mmap", "resident"):
        gpu = retriever(cuda, resident=pool == "resident")
        for tail in ("fused", "split"):
            gpu.set_rerank_backend(tail)
            gpu.searcher.index.store.stats.reset()
            gpu.reset_stage_stats()
            before = (fused_rerank_topk_batch.launches,
                      decompress_maxsim_scores_batch.launches,
                      splade_row_topk_batch.launches)
            answers[pool, tail] = got = gpu.search_batch("colbert",
                                                         q_embs=qs, k=30)
            after = (fused_rerank_topk_batch.launches,
                     decompress_maxsim_scores_batch.launches,
                     splade_row_topk_batch.launches)
            assert tuple(a - b for a, b in zip(after, before)) == (
                (1, 0, 0) if tail == "fused" else (0, 1, 0))
            stages = gpu.pipeline_stats.snapshot()["stages"]
            assert stages["host_gather:codes"]["pages_touched"] == 0
            for b, q in enumerate(qs):
                assert_colbert_match(cpu.searcher, gpu.searcher, q,
                                     (want[1][b], want[0][b]),
                                     (got[1][b], got[0][b]),
                                     what=f"{pool} {tail} row {b}")
    for key in answers:
        np.testing.assert_array_equal(answers[key][0],
                                      answers["mmap", "fused"][0])
        np.testing.assert_array_equal(
            answers[key][1].view(np.uint32),
            answers["mmap", "fused"][1].view(np.uint32))


def test_colbert_probe_stages_match_cpu(cuda, index_dir):
    """The probe scores allclose to the CPU's, and a query's probe on the
    card is its batch row's bit for bit; stage 2 from equal probed
    centroids equals the CPU's exactly; the approximate scores from
    equal candidates are allclose."""
    rng = np.random.default_rng(6)
    qs = [rng.normal(size=(int(rng.integers(4, 33)), 64)).astype(np.float32)
          for _ in range(9)]
    params = PlaidParams(nprobe=4, candidate_cap=96, ndocs=40, k=30)
    index = ColBERTIndex(index_dir / "colbert")
    gpu = PLAIDSearcher(index, params, device=cuda)
    cpu = PLAIDSearcher(index, params, device="cpu")
    g, c = gpu.probe_batch(qs), cpu.probe_batch(qs)
    np.testing.assert_allclose(g["scores_c"].cpu().numpy(),
                               c["scores_c"].numpy(), **TOL)
    one = gpu.probe_batch(qs[4:5])
    lq = len(qs[4])
    assert torch.equal(one["scores_c"][0, :lq], g["scores_c"][4, :lq])
    cand = stage2_candidates_batch(gpu.ivf_padded, c["cids"].to(cuda),
                                   params.candidate_cap)
    np.testing.assert_array_equal(cand.cpu().numpy(), c["cand"].numpy())
    codes, valid = cpu.gather_codes_batch(c["cand"].numpy())
    approx = [stage3_approx_score_batch(st["scores_c"],
                                        *s.to_device(codes, valid),
                                        st["q_valid"]).cpu().numpy()
              for s, st in ((gpu, g), (cpu, c))]
    np.testing.assert_allclose(*approx, **TOL)


def test_cache_hits_equal_cold_on_card(cuda, index_dir):
    """On the card, in one mixed batch: stage-1 hits (rows a splade batch
    scored, read by hybrid and rerank; with misses beside them in one
    group), colbert survivor hits at another k, and exact hits equal an
    engine without caches bit for bit; the batch run again is all exact
    hits and launches no kernel."""
    rng = np.random.default_rng(7)
    qs = [rng.normal(size=(int(rng.integers(4, 33)), 64)).astype(np.float32)
          for _ in range(12)]
    tids = [rng.integers(0, 500, 8) for _ in range(12)]
    tw = [rng.uniform(0.1, 2, 8).astype(np.float32) for _ in range(12)]
    retr = MultiStageRetriever(
        SpladeIndex.load(index_dir / "splade"),
        PLAIDSearcher(ColBERTIndex(index_dir / "colbert"),
                      PlaidParams(nprobe=4, candidate_cap=96, ndocs=40,
                                  k=30), device=cuda),
        MultiStageParams(first_k=60, k=30), device=cuda)
    plain = ServeEngine(retr, splade_backend="device")
    cached = ServeEngine(retr, caches=CacheHierarchy(64, 64))

    def reqs(spec):
        return [Request(qid=n, method=m, q_emb=qs[i], term_ids=tids[i],
                        term_weights=tw[i], k=k, alpha=a)
                for n, (m, i, k, a) in enumerate(spec)]

    cold = [("splade", i, 10, None) for i in range(4)] + [
        ("colbert", i, 10, None) for i in range(4, 8)]
    mixed = ([("hybrid", i, 20, 0.2 * i) for i in (0, 1, 8, 9)]
             + [("rerank", i, 30, None) for i in (2, 3, 10)]
             + [("colbert", i, 25, None) for i in range(4, 8)]
             + [("splade", i, 10, None) for i in (0, 1)])
    cached.process_batch(reqs(cold))
    retr.reset_stage_stats()
    got = cached.process_batch(reqs(mixed))
    counters = retr.pipeline_stats.snapshot()["counters"]
    assert [r.cache_hit for r in got] == [False] * 11 + [True] * 2
    assert counters["cache_stage1_hits"] == 2 + 2 + 4
    assert counters["cache_stage1_misses"] == 2 + 1
    want = plain.process_batch(reqs(mixed))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w.pids, g.pids)
        np.testing.assert_array_equal(w.scores.view(np.uint32),
                                      g.scores.view(np.uint32))
    before = (fused_rerank_topk_batch.launches,
              decompress_maxsim_scores_batch.launches,
              splade_row_topk_batch.launches)
    again = cached.process_batch(reqs(mixed))
    assert before == (fused_rerank_topk_batch.launches,
                      decompress_maxsim_scores_batch.launches,
                      splade_row_topk_batch.launches)
    assert all(r.cache_hit for r in again)
    for g, a in zip(got, again):
        np.testing.assert_array_equal(g.pids, a.pids)
        np.testing.assert_array_equal(g.scores.view(np.uint32),
                                      a.scores.view(np.uint32))


# -- the pipelined executor on the card -------------------------------------

def _cb(i=0):
    return CandidateBatch(method="x", k=1, term_ids=(np.asarray([i]),))


def _id(cb):
    return int(cb.term_ids[0][0])


@pytest.mark.parametrize("workers", ["single", "kind"])
def test_executor_runs_its_stages_on_its_own_stream(cuda, workers):
    """Every stage an executor runs, on either worker, sees the
    executor's stream as the current stream, not the default one."""
    seen = []

    def record(cb):
        seen.append((torch.cuda.current_stream(cuda),
                     threading.current_thread().name))
        return cb

    plan = StagePlan("x", (
        Stage("host_gather", HOST, record),
        Stage("device_score", DEVICE, lambda cb: record(cb).evolve(
            pids=np.zeros((1, 1), np.int64)))))
    px = PipelineExecutor(plan, depth=2, workers=workers, device=cuda)
    try:
        for f in [px.submit(_cb(i)) for i in range(3)]:
            f.result(timeout=TIMEOUT)
    finally:
        px.stop()
    assert px.stream is not None
    assert px.stream != torch.cuda.default_stream(cuda)
    assert len(seen) == 6 and all(st == px.stream for st, _ in seen)
    names = {name for _, name in seen}
    assert names == ({"pipe-x"} if workers == "single"
                     else {"pipe-x-host", "pipe-x-device"})


@pytest.mark.parametrize("workers", ["single", "kind"])
def test_closing_stage_waits_for_its_own_event_only(cuda, workers):
    """Batch 1's launch stage queues ~0.5 s of device work before its
    copy; batch 0's closing stage, run after it, returns while batch 1's
    event is still pending (a ``.cpu()`` there would wait for the whole
    stream), with batch 0's own values."""
    go = threading.Event()
    copies, pending = {}, {}

    def launch(cb):
        i = _id(cb)
        if i == 0:
            go.wait(TIMEOUT)
        x = torch.full((4,), float(i + 1), device=cuda)
        if i == 1:
            torch.cuda._sleep(SLEEP_CYCLES)
        copies[i] = HostCopy(x * 2)
        return cb.with_state(top=copies[i])

    def close(cb):
        (v,) = cb.state["top"].wait()
        i = _id(cb)
        if i + 1 in copies:
            pending[i] = not copies[i + 1].event.query()
        return cb.evolve(pids=np.zeros((1, 1), np.int64),
                         scores=v[None])

    plan = StagePlan("x", (
        Stage("fused_rerank", DEVICE, launch, opens_async=True),
        Stage("fused_rerank:sync", DEVICE, close, closes_async=True)))
    px = PipelineExecutor(plan, depth=2, workers=workers, device=cuda)
    try:
        futs = [px.submit(_cb(0)), px.submit(_cb(1))]
        go.set()
        out = [f.result(timeout=TIMEOUT) for f in futs]
    finally:
        go.set()
        px.stop()
    assert pending[0] is True
    np.testing.assert_array_equal(out[0].scores[0], np.full(4, 2.0))
    np.testing.assert_array_equal(out[1].scores[0], np.full(4, 4.0))


def test_executor_stream_waits_for_state_built_before_it(cuda):
    """Device state written on the default stream behind ~0.5 s of work,
    then copied by the executor's first stage on its own stream: the
    executor's stream waits for it at creation, so the copy reads the
    written values. Everything is allocated before the sleep, so that no
    allocation in the stage synchronises the device."""
    torch.cuda.Stream(device=cuda)        # the stream pool, made early
    x = torch.zeros(1 << 20, device=cuda)
    y = torch.empty_like(x)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    x.fill_(7.0)

    def copy(cb):
        y.copy_(x)
        return cb.evolve(pids=np.zeros((1, 1), np.int64))

    px = PipelineExecutor(StagePlan("x", (Stage("copy", DEVICE, copy),)),
                          device=cuda)
    try:
        px.submit(_cb()).result(timeout=TIMEOUT)
    finally:
        px.stop()
    torch.cuda.synchronize()
    assert bool((y == 7.0).all())


@pytest.mark.parametrize("workers", ["single", "kind"])
@pytest.mark.parametrize("resident", [False, True])
def test_pipelined_equals_synchronous_on_card(cuda, index_dir, resident,
                                              workers):
    """All four methods with the device stage 1, mmap and resident
    pools: ``process_batch_async`` at depth 2 equals ``process_batch``
    on the same micro-batches bit for bit, each launching its path's
    kernels on the executor's streams."""
    rng = np.random.default_rng(8)
    n = 24
    retr = MultiStageRetriever(
        SpladeIndex.load(index_dir / "splade"),
        PLAIDSearcher(ColBERTIndex(index_dir / "colbert"),
                      PlaidParams(nprobe=4, candidate_cap=96, ndocs=40,
                                  k=30), device_resident=resident,
                      device=cuda),
        MultiStageParams(first_k=60, k=30), device=cuda)
    sync = ServeEngine(retr, splade_backend="device")
    piped = ServeEngine(retr, pipeline_depth=2, pipeline_workers=workers)
    reqs = [Request(qid=i, method=METHODS[i % 4],
                    q_emb=rng.normal(size=(int(rng.integers(4, 33)), 64))
                    .astype(np.float32),
                    term_ids=rng.integers(0, 500, 8),
                    term_weights=rng.uniform(0.1, 2, 8).astype(np.float32),
                    k=(10, 30)[i % 2], alpha=None if i % 3 else 0.25)
            for i in range(n)]
    batches = [reqs[i:i + 8] for i in range(0, n, 8)]
    want = [r for b in batches for r in sync.process_batch(b)]
    before = (fused_rerank_topk_batch.launches,
              decompress_maxsim_scores_batch.launches,
              splade_row_topk_batch.launches)
    try:
        futs = [piped.process_batch_async(b) for b in batches]
        got = [r for f in futs for r in f.result(timeout=TIMEOUT)]
        streams = {m: px.stream for m, px in piped._pipelines.items()}
    finally:
        piped.close()
    after = (fused_rerank_topk_batch.launches,
             decompress_maxsim_scores_batch.launches,
             splade_row_topk_batch.launches)
    # per batch: fused_rerank for rerank and colbert, decompress_maxsim
    # for hybrid, the SPLADE top-k for the three SPLADE methods
    assert tuple(a - b for a, b in zip(after, before)) == (6, 3, 9)
    assert len({s.cuda_stream for s in streams.values()}) == 4
    assert all(s != torch.cuda.default_stream(cuda)
               for s in streams.values())
    for w, g in zip(want, got):
        assert w.qid == g.qid
        np.testing.assert_array_equal(w.pids, g.pids)
        np.testing.assert_array_equal(w.scores.view(np.uint32),
                                      g.scores.view(np.uint32))


INDEX_FILES = ("residuals.bin", "codes.bin", "centroids.npy",
               "bucket_cutoffs.npy", "bucket_weights.npy", "doclens.npy",
               "doc_offsets.npy", "ivf_pids.bin", "ivf_offsets.npy",
               "meta.json")


def _ties_only(pts, cent, a, b) -> int:
    """Ids that differ between two assignments are ties (the point's two
    best sims within 1e-6); → how many differ."""
    diff = np.nonzero(a != b)[0]
    if len(diff):
        top2 = torch.topk(torch.from_numpy(pts[diff])
                          @ torch.from_numpy(cent).T, 2).values
        assert bool((top2[:, 0] - top2[:, 1] <= 1e-6).all()), diff
    return len(diff)


def test_build_on_card_matches_cpu(cuda, tmp_path):
    """assign, update and encode_residuals on the card against the CPU,
    a pinned build on the card byte for byte the CPU's (up to assignment
    ties), and two free card builds from one seed byte for byte."""
    corpus = make_corpus(SynthCfg(n_docs=300, n_queries=4, dim=64,
                                  doc_maxlen=40, seed=5))
    embs, lens = corpus["doc_embs"], corpus["doc_lens"]
    pts = embs[np.arange(embs.shape[1])[None] < lens[:, None]]
    rng = np.random.default_rng(6)
    cent = rng.normal(size=(512, 64)).astype(np.float32)
    cent /= np.linalg.norm(cent, axis=-1, keepdims=True)
    tp, tc = torch.from_numpy(pts), torch.from_numpy(cent)
    ids_c, sims_c = kmeans.assign(tp, tc)
    ids_g, sims_g = kmeans.assign(tp.to(cuda), tc.to(cuda), chunk=1000)
    _ties_only(pts, cent, ids_c.numpy(), ids_g.cpu().numpy())
    np.testing.assert_allclose(sims_g.cpu().numpy(), sims_c.numpy(), rtol=0,
                               atol=1e-6)

    new_c, counts_c = kmeans.update(tp, tc, ids_c)
    new_g, counts_g = kmeans.update(tp.to(cuda), tc.to(cuda), ids_c.to(cuda))
    again, _ = kmeans.update(tp.to(cuda), tc.to(cuda), ids_c.to(cuda))
    assert torch.equal(new_g, again)
    assert torch.equal(counts_g.cpu(), counts_c)
    np.testing.assert_allclose(new_g.cpu().numpy(), new_c.numpy(), rtol=0,
                               atol=1e-6)

    for nbits in (2, 4):
        codec = fit_codec(cent, pts, ids_c.numpy(), nbits)
        want = encode_residuals(tp, ids_c, tc, codec.bucket_cutoffs, nbits)
        got = encode_residuals(tp.to(cuda), ids_c.to(cuda), tc.to(cuda),
                               codec.bucket_cutoffs.to(cuda), nbits)
        assert torch.equal(got.cpu(), want)

    free = [build_colbert_index(tmp_path / name, embs, lens, nbits=4,
                                kmeans_iters=4, seed=3, device=cuda)
            for name in ("free", "again")]
    for name in INDEX_FILES:
        assert (free[0] / name).read_bytes() == \
            (free[1] / name).read_bytes(), name
    pin = {n: np.load(free[0] / f"{n}.npy")
           for n in ("centroids", "bucket_cutoffs", "bucket_weights")}
    card, host = (build_colbert_index(tmp_path / f"pinned_{dev}", embs,
                                      lens, nbits=4, device=dev, **pin)
                  for dev in (cuda, "cpu"))
    ties = _ties_only(pts, pin["centroids"],
                      np.fromfile(host / "codes.bin", np.int32),
                      np.fromfile(card / "codes.bin", np.int32))
    for name in INDEX_FILES:
        if ties and name in ("codes.bin", "residuals.bin", "ivf_pids.bin",
                             "ivf_offsets.npy"):
            continue    # the tie's tokens, and the IVF lists they enter
        assert (card / name).read_bytes() == (host / name).read_bytes(), name
