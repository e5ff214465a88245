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
import os
import pathlib
import re
import shutil
import signal
import socket
import subprocess
import sys
import threading
import time

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
from repro_torch.index import kmeans, live
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
from repro_torch.launch.serve import build_or_load
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.pipeline import (DEVICE, HOST, CandidateBatch,
                                          PipelineExecutor, Stage, StagePlan)
from repro_torch.serving.server import (RetrievalServer, tcp_query,
                                        wire_request)
from repro_torch.testing import (REF_MARGIN, assert_colbert_match,
                                 assert_same_up_to_exact_ties,
                                 assert_topk_match, assign_placements,
                                 near_tie_rows)

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


def test_maxsim_takes_every_shape_the_per_warp_kernel_took(cuda):
    """The staged MaxSim body never refuses a shape that the earlier
    one-warp-per-candidate kernel took: (Lq·(d+4) + 8·d + 16) floats of
    shared memory, at most 232,448 bytes, at B·C from one to a batch."""
    lib = _build.load()
    for d in range(32, 1025, 32):
        for Lq in range(1, 129):
            if (Lq * (d + 4) + 8 * d + 16) * 4 > _build.MAX_SMEM_BYTES:
                continue
            for B, C in ((1, 1), (1, 200), (32, 200)):
                assert lib.maxsim_smem_bytes(Lq, d, B, C) \
                    <= _build.MAX_SMEM_BYTES, (Lq, d, B, C)


def test_concurrent_launches_at_several_sizes(cuda):
    """Host threads launching decompress_maxsim back to back at batch
    sizes whose tiles take different shared memory (B·C = 2,000, 2,200,
    4,400 give groups of 1, 2 and 4 candidates a block) all launch, and
    each answer is the single-threaded launch's bit for bit. A
    shared-memory attribute set to each launch's own size lets one
    thread lower it under another's launch (CUDA error 701)."""
    cases = [_case(40 + i, B, 200, 24, 4, 4096, 128, 32)
             for i, B in enumerate((10, 11, 22))]
    cases = [tuple(t.to(cuda) for t in c) for c in cases]

    def launch(c):
        q, packed, cids, valid, _, cent, bw, qv = c
        return decompress_maxsim_scores_batch(q, packed, cids, valid, cent,
                                              bw, nbits=4, q_valid=qv)

    want = [launch(c).cpu() for c in cases]
    errors, start = [], threading.Barrier(6)

    def worker(i):
        try:
            start.wait(timeout=TIMEOUT)
            # no sync between launches: every thread's attribute set and
            # launch interleave with the others'
            got = [(j, launch(cases[j])) for n in range(300)
                   for j in [(i + n) % len(cases)]]
            for j, out in got:
                assert torch.equal(out.cpu().view(torch.int32),
                                   want[j].view(torch.int32))
        except Exception as e:   # surfaced below
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[0]


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


@pytest.mark.parametrize("B,C,Ld,Lq,d,prefix", [
    (3, 40, 12, 32, 128, False),
    (4, 1, 180, 5, 128, False),
    (4, 7, 180, 33, 128, False),
    (4, 200, 180, 32, 128, True),
    (4, 200, 180, 128, 128, False),
    (2, 7, 70, 32, 64, False),
    (2, 7, 70, 128, 256, True),
    (2, 2, 17000, 8, 32, False),
    (2, 7, 40, 112, 480, False),
    (2, 7, 40, 120, 448, True),
])
def test_maxsim_kernel_matches_plain_and_decompress(cuda, B, C, Ld, Lq, d,
                                                    prefix):
    """The MaxSim kernel at its edges (one candidate, C not a multiple of
    anything, Lq past a pass of 32 and at 128, d 64 to 256, masks that
    are not a prefix, a row with every doc invalid, docs with more
    chunks of 64 positions than a block's table holds, the shapes with
    the least shared memory to spare): against its plain
    version, bit for bit against decompress+MaxSim on the decoded
    embeddings and against a second launch, and a B=1 launch against its
    batch row."""
    rng = np.random.default_rng(5 + C + Lq + d)
    K, nbits = 500, 4
    q = torch.from_numpy(rng.normal(size=(B, Lq, d)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(0, 256, (B, C, Ld, d * nbits // 8),
                                           dtype=np.uint8))
    cids = torch.from_numpy(rng.integers(0, K, (B, C, Ld), dtype=np.int32))
    if prefix:
        valid = torch.from_numpy(np.arange(Ld) < rng.integers(
            0, Ld + 1, (B, C))[..., None])
        qv = torch.from_numpy(np.arange(Lq) < rng.integers(
            1, Lq + 1, B)[:, None])
    else:
        valid = torch.from_numpy(rng.random((B, C, Ld)) < 0.7)
        qv = torch.from_numpy(rng.random((B, Lq)) < 0.8)
    valid[0, 0] = False                              # an all-invalid doc
    valid[B - 1] = False                             # a row of them
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
    assert got[0, 0].item() == 0.0 and torch.all(got[B - 1] == 0)
    dms = decompress_maxsim_scores_batch(q, packed, cids, valid, cent, bw,
                                         nbits=nbits, q_valid=qv)
    assert torch.equal(got.view(torch.int32), dms.view(torch.int32))
    again = maxsim_scores_batch(q, emb, valid, qv)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    for b in range(B):
        one = maxsim_scores(q[b], emb[b], valid[b], qv[b])
        assert torch.equal(one.view(torch.int32), got[b].view(torch.int32))
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


def _launch_counts():
    return (fused_rerank_topk_batch.launches,
            decompress_maxsim_scores_batch.launches,
            splade_row_topk_batch.launches)


def test_tcp_front_on_card(cuda, index_dir):
    """A mixed batch of the four methods over the TCP front, queued
    before the server starts (so it is one micro-batch): every reply
    equals the engine's in-process answer on the same batch bit for bit,
    the batch launches its path's kernels, and an exact-cache hit over
    TCP (answered on the connection's handler thread) launches none."""
    rng = np.random.default_rng(9)
    retr = MultiStageRetriever(
        SpladeIndex.load(index_dir / "splade"),
        PLAIDSearcher(ColBERTIndex(index_dir / "colbert"),
                      PlaidParams(nprobe=4, candidate_cap=96, ndocs=40,
                                  k=30), device=cuda),
        MultiStageParams(first_k=60, k=30), device=cuda)
    engine = ServeEngine(retr, splade_backend="device",
                         caches=CacheHierarchy(64, 64))
    plain = ServeEngine(retr)
    msgs = [{"qid": i, "method": METHODS[i % 4], "k": (10, 20)[i % 2],
             "q_emb": rng.normal(size=(int(rng.integers(4, 33)), 64))
             .astype(np.float32).tolist(),
             "term_ids": rng.integers(0, 500, 8).tolist(),
             "term_weights": rng.uniform(0.1, 2, 8).astype(np.float32)
             .tolist()} for i in range(8)]
    reqs = [wire_request(m) for m in msgs]
    server = RetrievalServer(engine, max_batch=8, batch_timeout_ms=50.0)
    submitted = threading.Condition()
    count = [0]
    submit = server.submit

    def counted(req):
        fut = submit(req)
        with submitted:
            count[0] += 1
            submitted.notify_all()
        return fut

    server.submit = counted
    tcp = server.serve_tcp("127.0.0.1", 0)
    serving = threading.Thread(target=tcp.serve_forever, name="tcp-serve",
                               daemon=True)
    serving.start()
    replies, clients = {}, []
    try:
        for i, m in enumerate(msgs):      # queued in order, one by one
            t = threading.Thread(
                target=lambda m=m: replies.__setitem__(
                    m["qid"], tcp_query("127.0.0.1", server.tcp_port, m)),
                daemon=True)
            clients.append(t)
            t.start()
            with submitted:
                assert submitted.wait_for(lambda: count[0] == i + 1,
                                          TIMEOUT)
        before = _launch_counts()
        server.start()
        for t in clients:
            t.join(timeout=TIMEOUT)
        after = _launch_counts()
        hit = tcp_query("127.0.0.1", server.tcp_port, msgs[2])
        assert _launch_counts() == after
    finally:
        server.shutdown_gracefully()
        serving.join(timeout=TIMEOUT)
    assert not serving.is_alive()
    assert not any(t.is_alive() for t in clients)
    # one batch: fused_rerank for rerank and colbert, decompress_maxsim
    # for hybrid, the SPLADE top-k for the three SPLADE methods
    assert tuple(a - b for a, b in zip(after, before)) == (2, 1, 3)
    want = plain.process_batch(reqs)
    for w in want:
        got = replies[w.qid]
        assert "error" not in got and "cache_hit" not in got, got
        assert got["pids"] == w.pids.tolist()
        np.testing.assert_array_equal(
            np.asarray(got["scores"], np.float32).view(np.uint32),
            w.scores.view(np.uint32))
    assert hit["cache_hit"] is True
    assert (hit["pids"], hit["scores"]) == (replies[2]["pids"],
                                            replies[2]["scores"])


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


def test_upsert_assignment_equals_chunked_at_near_ties(cuda):
    """A live upsert assigns a document's L <= 180 rows alone; a rebuild
    assigns the same rows inside ``kmeans.CHUNK``-row chunks. Rows that
    are exact ties in real arithmetic between two of K=131,072 centroids
    (d=128) get the same id and the same sim bits alone, for every L in
    1..180, as inside a full chunk and a partial last chunk at several
    offsets."""
    g = torch.Generator().manual_seed(11)
    cent = torch.randn(131072, 128, generator=g)
    cent = (cent / torch.linalg.norm(cent, dim=-1, keepdim=True)).to(cuda)
    rows = near_tie_rows(cent, 180, seed=12)
    got = assign_placements(rows, cent, chunk=kmeans.CHUNK, seed=13)
    print("near-tie placements:", got)
    assert got["placements"] == 180 + 2 + 5
    assert (got["ids_differ"], got["sims_differ"]) == (0, 0), got


def test_live_trace_on_card(cuda, tmp_path):
    """The live index on the card: the canonical trace (upsert held-out
    docs, tombstone base docs and a delta doc), served dirty and after a
    compaction. On the card every answer equals a pinned card rebuild of
    the surviving corpus bit for bit, the delta codes equal the rebuild's
    rows, a dirty batch launches decompress_maxsim and nothing else; and
    every answer matches the same trace's run with ``device="cpu"``."""
    corpus = make_corpus(SynthCfg(n_docs=240, n_queries=16, vocab=512,
                                  dim=32, n_topics=12, doc_maxlen=20,
                                  query_maxlen=6, seed=3))
    hold, deleted_base = 8, (5, 17, 100, 201)
    n = corpus["cfg"].n_docs - hold
    build_colbert_index(tmp_path / "base" / "colbert", corpus["doc_embs"][:n],
                        corpus["doc_lens"][:n], nbits=4, n_centroids=64,
                        kmeans_iters=4, device="cpu")
    build_splade_index(corpus["doc_term_ids"][:n],
                       corpus["doc_term_weights"][:n], corpus["cfg"].vocab,
                       n).save(tmp_path / "base" / "splade")
    params = dict(plaid=PlaidParams(nprobe=4, candidate_cap=4096, ndocs=128,
                                    k=10),
                  ms=MultiStageParams(first_k=64, k=10,
                                      splade_backend="device"))
    q = dict(q_embs=list(corpus["q_embs"]),
             term_ids=list(corpus["q_term_ids"]),
             term_weights=list(corpus["q_term_weights"]))

    def retriever(path, device):
        return MultiStageRetriever(
            SpladeIndex.load(path / "splade"),
            PLAIDSearcher(ColBERTIndex(path / "colbert"), params["plaid"],
                          device=device), params["ms"], device=device)

    def answers(retr, k):
        return {m: retr.search_batch(m, **q, k=k) for m in METHODS}

    deleted = set(deleted_base) | {n + 2}
    survivors = np.array([g for g in range(corpus["cfg"].n_docs)
                          if g not in deleted], np.int64)
    idx = ColBERTIndex(tmp_path / "base" / "colbert")
    runs = {}
    for device in (cuda, "cpu"):
        path = tmp_path / str(device)
        shutil.copytree(tmp_path / "base", path)
        retr = retriever(path, device)
        retr.enable_live()
        for j in range(n, corpus["cfg"].n_docs):
            retr.live_upsert(corpus["doc_embs"][j], corpus["doc_term_ids"][j],
                             corpus["doc_term_weights"][j],
                             corpus["doc_lens"][j])
        for g in sorted(deleted):
            assert retr.live_delete(g)
        k = 10 if device == cuda else 10 + REF_MARGIN
        before = _launch_counts()
        dirty = answers(retr, k)
        after = _launch_counts()
        if device == cuda:
            assert after[0] == before[0] and after[2] == before[2]
            assert after[1] > before[1]       # decompress_maxsim only
        delta_cids = [c.copy() for c in retr.live._cids]
        assert retr.compact_live()["compacted"] == hold
        runs[str(device)] = (dirty, answers(retr, k), delta_cids)

    rebuild = tmp_path / "rebuild"
    live.build_reference_indexes(
        rebuild / "colbert", rebuild / "splade",
        corpus["doc_embs"][survivors], corpus["doc_lens"][survivors],
        corpus["doc_term_ids"][survivors],
        corpus["doc_term_weights"][survivors], corpus["cfg"].vocab,
        centroids=idx.centroids, bucket_cutoffs=idx.bucket_cutoffs,
        bucket_weights=idx.bucket_weights, nbits=idx.nbits,
        quantum=SpladeIndex.load(tmp_path / "base" / "splade").quantum,
        device=cuda)
    want = answers(retriever(rebuild, cuda), 10)
    ref = ColBERTIndex(rebuild / "colbert")
    codes = np.asarray(ref.store.codes)
    for j, cids in enumerate(runs[str(cuda)][2]):
        r = int(np.searchsorted(survivors, n + j))
        if n + j in deleted:
            continue
        lo, hi = ref.doc_offsets[r], ref.doc_offsets[r + 1]
        np.testing.assert_array_equal(cids, codes[lo:hi], err_msg=f"doc {j}")
    for state in (0, 1):
        for m in METHODS:
            got = runs[str(cuda)][state][m]
            np.testing.assert_array_equal(
                live.map_global_to_ref(got[0], survivors), want[m][0],
                err_msg=f"{m} state {state}")
            np.testing.assert_array_equal(got[1].view(np.uint32),
                                          want[m][1].view(np.uint32))
            cpu = runs["cpu"][state][m]
            assert_topk_match(cpu[1], cpu[0], got[1], got[0],
                              what=f"{m} state {state}")


def test_sharded_live_trace_on_card(cuda, tmp_path):
    """A live group of 2 shards on the card, fed the canonical trace
    (upsert held-out docs, tombstone base docs in both shards and a
    delta doc), equals the card's unsharded live retriever fed the same
    trace bit for bit, dirty and after a compaction, for the four
    methods. A dirty group's batches launch decompress_maxsim (a shard
    each, and the delta's at the coordinator) and no other kernel."""
    from repro_torch.core.sharded import build_sharded_retriever
    from repro_torch.index.sharding import load_group, split_index_tree
    corpus = make_corpus(SynthCfg(n_docs=240, n_queries=16, vocab=512,
                                  dim=32, n_topics=12, doc_maxlen=20,
                                  query_maxlen=6, seed=3))
    hold, deleted = 8, (5, 17, 100, 201, 234)
    n = corpus["cfg"].n_docs - hold
    base = tmp_path / "base"
    build_colbert_index(base / "colbert", corpus["doc_embs"][:n],
                        corpus["doc_lens"][:n], nbits=4, n_centroids=64,
                        kmeans_iters=4, device="cpu")
    build_splade_index(corpus["doc_term_ids"][:n],
                       corpus["doc_term_weights"][:n], corpus["cfg"].vocab,
                       n).save(base / "splade")
    plaid = PlaidParams(nprobe=4, candidate_cap=4096, ndocs=128, k=10)
    ms = MultiStageParams(first_k=64, k=10, splade_backend="device")
    q = dict(q_embs=list(corpus["q_embs"]),
             term_ids=list(corpus["q_term_ids"]),
             term_weights=list(corpus["q_term_weights"]))
    shutil.copytree(base, tmp_path / "one")
    one = MultiStageRetriever(
        SpladeIndex.load(tmp_path / "one" / "splade"),
        PLAIDSearcher(ColBERTIndex(tmp_path / "one" / "colbert"), plaid,
                      device=cuda), ms, device=cuda)
    dirs, bounds = load_group(split_index_tree(base, 2,
                                               group_dir=tmp_path / "two"))
    two = build_sharded_retriever(dirs, bounds, plaid_params=plaid,
                                  multistage_params=ms, device=cuda)
    answers = {}
    for name, retr in (("one", one), ("two", two)):
        retr.enable_live()
        for j in range(n, corpus["cfg"].n_docs):
            assert retr.live_upsert(
                corpus["doc_embs"][j], corpus["doc_term_ids"][j],
                corpus["doc_term_weights"][j], corpus["doc_lens"][j]) == j
        for g in deleted:
            assert retr.live_delete(g)
        for state in ("dirty", "compacted"):
            if state == "compacted":
                assert retr.compact_live()["compacted"] == hold
            for m in METHODS:
                before = _launch_counts()
                answers[name, state, m] = retr.search_batch(m, **q, k=10)
                after = _launch_counts()
                if name == "two":
                    assert after[0] == before[0] and after[2] == before[2]
                    dms = after[1] - before[1]
                    assert dms == 0 if m == "splade" else dms in (2, 3), m
    assert [sh.live.tombstones.tolist() for sh in two.shards] == \
        [[5, 17, 100], [201 - 116, 234 - 116]]
    for state in ("dirty", "compacted"):
        for m in METHODS:
            want, got = answers["one", state, m], answers["two", state, m]
            np.testing.assert_array_equal(got[0], want[0],
                                          err_msg=f"{m} {state}")
            np.testing.assert_array_equal(got[1].view(np.uint32),
                                          want[1].view(np.uint32))


def test_launcher_on_card(cuda, index_dir):
    """``python -m repro_torch.launch.serve --index-dir <dir> --port 0``
    on the card: three replies over TCP equal an in-process twin (the
    launcher's ``build_or_load`` at its defaults, each request served
    alone as at ``--max-batch 1``) bit for bit; after SIGTERM the
    launcher exits 0 and the port refuses connections."""
    rng = np.random.default_rng(11)
    msgs = [{"qid": i, "method": m, "k": 10,
             "q_emb": rng.normal(size=(16, 64)).astype(np.float32).tolist(),
             "term_ids": rng.integers(0, 500, 8).tolist(),
             "term_weights": rng.uniform(0.1, 2, 8).astype(np.float32)
             .tolist()} for i, m in enumerate(("hybrid", "colbert",
                                               "splade"))]
    root = pathlib.Path(__file__).resolve().parents[1]
    out_path, err_path = index_dir / "launcher.out", index_dir / "launcher.err"
    with open(out_path, "w") as out, open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--index-dir",
             str(index_dir), "--port", "0"], cwd=root, stdout=out,
            stderr=err, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    try:
        for _ in range(int(4 * TIMEOUT / 0.05)):
            m = re.search(r"^RETRIEVAL_PORT=(\d+)$", out_path.read_text(),
                          re.M)
            if m or proc.poll() is not None:
                break
            time.sleep(0.05)
        assert m, err_path.read_text()[-3000:]
        port = int(m.group(1))
        replies = [tcp_query("127.0.0.1", port, msg) for msg in msgs]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0, err_path.read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
    _, _, retr = build_or_load(str(index_dir), "mmap", device=cuda)
    engine = ServeEngine(retr)
    for msg, got in zip(msgs, replies):
        want = engine.process(wire_request(msg))
        assert "error" not in got, got
        assert got["pids"] == want.pids.tolist()
        np.testing.assert_array_equal(
            np.asarray(got["scores"], np.float32).view(np.uint32),
            want.scores.view(np.uint32))


def test_shard_groups_equal_one_shard_on_card(cuda, index_dir):
    """Groups of 2 and 4 shards on the card equal the one-shard group
    (the unsharded path) bit for bit: splade, rerank and hybrid with the
    host and the device stage 1, against both tails of the one shard;
    colbert at a candidate cap that cannot bind (4,096 over 300 docs).
    Per rerank or hybrid batch each shard launches decompress_maxsim once
    and fused_rerank never, and with the device stage 1 each shard
    launches the SPLADE top-k entry once."""
    from repro_torch.core.sharded import (ShardedRetriever,
                                          build_sharded_retriever)
    from repro_torch.index.sharding import load_group, split_index_tree
    rng = np.random.default_rng(21)
    B, d = 12, 64
    q = dict(q_embs=[rng.normal(size=(int(n), d)).astype(np.float32)
                     for n in rng.integers(3, 17, B)],
             term_ids=[rng.integers(0, 500, 8) for _ in range(B)],
             term_weights=[rng.uniform(0.1, 2, 8).astype(np.float32)
                           for _ in range(B)])
    plaid = PlaidParams(nprobe=8, candidate_cap=4096, ndocs=64, k=30)

    def group(n_shards, backend):
        dirs, bounds = load_group(split_index_tree(
            index_dir, n_shards, group_dir=index_dir / f"shards{n_shards}"))
        return build_sharded_retriever(
            dirs, bounds, plaid_params=plaid, device=cuda,
            multistage_params=MultiStageParams(first_k=60, k=30,
                                               splade_backend=backend))

    for backend in ("host", "device"):
        one = group(1, backend)
        assert isinstance(one, ShardedRetriever) and one.n_shards == 1
        want = {}
        for tail in ("fused", "split"):
            one.set_rerank_backend(tail)
            want[tail] = {m: one.search_batch(m, **q, k=30) for m in METHODS}
        for n_shards in (2, 4):
            retr = group(n_shards, backend)
            for m in METHODS:
                before = _launch_counts()
                got = retr.search_batch(m, **q, k=30)
                after = _launch_counts()
                for tail in ("fused", "split"):
                    if m == "colbert":
                        assert_same_up_to_exact_ties(want[tail][m], got,
                                                     what=m)
                        continue
                    np.testing.assert_array_equal(got[0], want[tail][m][0])
                    np.testing.assert_array_equal(
                        got[1].view(np.uint32),
                        want[tail][m][1].view(np.uint32))
                assert after[0] == before[0]              # no fused_rerank
                dms = {"splade": 0, "colbert": n_shards}.get(m, n_shards)
                assert after[1] - before[1] == dms
                stage1 = n_shards if backend == "device" and m != "colbert" \
                    else 0
                assert after[2] - before[2] == stage1


def test_shard_group_pipelined_on_card(cuda, index_dir):
    """A group of 2 shards behind the engine at depth 2 with single and
    kind workers (the executor's stream; pooled host gathers) gives the
    synchronous engine's answers bit for bit, mixed batches included."""
    from repro_torch.core.sharded import build_sharded_retriever
    from repro_torch.index.sharding import load_group, split_index_tree
    rng = np.random.default_rng(22)
    dirs, bounds = load_group(split_index_tree(index_dir, 2))
    retr = build_sharded_retriever(
        dirs, bounds, device=cuda,
        plaid_params=PlaidParams(nprobe=8, candidate_cap=4096, ndocs=64,
                                 k=30),
        multistage_params=MultiStageParams(first_k=60, k=30,
                                           splade_backend="device"))
    reqs = [Request(qid=i, method=METHODS[i % 4],
                    q_emb=rng.normal(size=(12, 64)).astype(np.float32),
                    term_ids=rng.integers(0, 500, 8),
                    term_weights=rng.uniform(0.1, 2, 8).astype(np.float32),
                    k=(5, 30)[i % 2], alpha=None if i % 3 else 0.7)
            for i in range(24)]
    chunks = [reqs[i:i + 8] for i in range(0, 24, 8)]
    want = [r for c in chunks for r in ServeEngine(retr).process_batch(c)]
    for workers in ("single", "kind"):
        eng = ServeEngine(retr, pipeline_depth=2, pipeline_workers=workers)
        try:
            futs = [eng.process_batch_async(c) for c in chunks]
            got = [r for f in futs for r in f.result(timeout=TIMEOUT)]
        finally:
            eng.close()
        for a, b in zip(want, got):
            np.testing.assert_array_equal(a.pids, b.pids)
            np.testing.assert_array_equal(a.scores.view(np.uint32),
                                          b.scores.view(np.uint32))


def test_shard_worker_on_card_equals_in_process_shard(cuda, index_dir):
    """A shard worker process on the card (the client's default
    ``device="cuda"``) answers ``splade`` with the device stage 1,
    ``score_tokens``, ``colbert_candidates`` and ``colbert_exact`` with
    the bits of the in-process 2-shard group's shard 1 on the same
    inputs: its stage 1 (every shard's top-k launched before any is
    copied back) and the lifted stage functions. The kernel library is
    built in this process before the spawn; the worker loads it."""
    from repro_torch.core import sharded
    from repro_torch.core.plaid import (pad_query_batch_host,
                                        stage1_centroid_probe_batch)
    from repro_torch.index.sharding import load_group, split_index_tree
    from repro_torch.serving.transport import ShardWorkerClient
    rng = np.random.default_rng(23)
    B, d, first_k = 12, 64, 60
    plaid = dict(nprobe=8, candidate_cap=4096, ndocs=64, k=30)
    ms = dict(first_k=first_k, k=30, splade_backend="device")
    dirs, bounds = load_group(split_index_tree(index_dir, 2))
    group = sharded.build_sharded_retriever(
        dirs, bounds, plaid_params=PlaidParams(**plaid),
        multistage_params=MultiStageParams(**ms), device=cuda)
    shard = group.shards[1]
    term_ids = [rng.integers(0, 500, 8) for _ in range(B)]
    term_weights = [rng.uniform(0.1, 2, 8).astype(np.float32)
                    for _ in range(B)]
    q, q_valid = pad_query_batch_host(
        [rng.normal(size=(int(n), d)).astype(np.float32)
         for n in rng.integers(3, 17, B)])
    n_local = int(bounds[2] - bounds[1])
    sel = np.where(rng.random((B, 24)) < 0.8,
                   rng.integers(0, n_local, (B, 24)), -1)
    qt, qvt = shard.searcher.to_device(q, q_valid)
    scores_c, cids = stage1_centroid_probe_batch(
        qt, qvt, shard.searcher.centroids, plaid["nprobe"])
    pids, s1 = group._shard_stage1(term_ids, term_weights, first_k,
                                   "device")[1]
    want = {
        "splade": {"pids": np.where(pids >= 0, pids - bounds[1], -1),
                   "scores": s1},
        "score_tokens": {"scores": HostCopy(sharded.shard_exact_scores(
            shard, q, q_valid, sharded.shard_gather(shard, sel))).wait()[0]},
    }
    want["colbert_exact"] = want["score_tokens"]
    a = sharded.shard_approx(
        shard, scores_c, qvt, sharded.shard_gather_codes(
            shard, sharded.shard_candidates(shard, cids)))
    want["colbert_candidates"] = {
        "cand": a["cand_np"], "approx": a["approx_np"],
        "n_real": (a["cand_np"] >= 0).sum(axis=1)}
    payloads = {
        "splade": {"term_ids": term_ids, "term_weights": term_weights,
                   "k": first_k, "backend": "device"},
        "score_tokens": {"q": q, "q_valid": q_valid, "sel": sel},
        "colbert_exact": {"q": q, "q_valid": q_valid, "sel": sel},
        "colbert_candidates": {"scores_c": scores_c.cpu().numpy(),
                               "cids": cids.cpu().numpy(),
                               "q_valid": q_valid}}
    _build.load()
    cli = ShardWorkerClient(1, dirs[1], plaid_params=plaid, ms_params=ms,
                            transport="socket", spawn_timeout_s=120,
                            call_timeout_s=60)
    try:
        cli.spawn()
        assert cli.call("warm", {"backend": "device"}) == {
            "warmed": "device"}
        # the worker's own view: a context of its own, bytes on the card
        h = cli.call("health", {})
        assert h["device"].startswith("cuda") and h["cuda_initialized"]
        assert h["device_allocated_bytes"] > 0
        for op, payload in payloads.items():
            got = cli.call(op, payload)
            assert list(got) == list(want[op]), op
            for key, w in want[op].items():
                g = got[key]
                assert (g.dtype, g.shape) == (w.dtype, w.shape), (op, key)
                assert g.tobytes() == w.tobytes(), (op, key)
    finally:
        assert cli.terminate() == 0
