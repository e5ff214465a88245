#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. build   — print the card (``nvidia-smi``) and build the four CUDA
             kernels from ``src/repro_torch/kernels/csrc`` with nvcc;
2. kernels — hold decompress_maxsim and fused_rerank, and their B=1
             launches, against their plain PyTorch versions on the card
             at full width (B=32, Lq=32, C=200, Ld=180, d=128, K=131072;
             nbits 4 and 2; ragged valid and cmask, k < C and k > C,
             empty C); fused must equal split bit for bit, and a B=1
             launch its batch row. Then MaxSim over fp32
             embeddings at the same width (ragged validity, an
             all-invalid doc) against its plain version, and bit for bit
             against decompress_maxsim on the decoded embeddings;
3. index   — write a synthetic index at full width (d=128, nbits=4,
             doc_maxlen=180, K=131072, SPLADE vocab 30522) with
             ``write_index`` and ``SpladeIndex.save``, 100,000 docs; then
             hold the SPLADE kernel's two entry points (scores, per-block
             top-k) on the cache's pid-sorted rows against their plain
             versions on the index's ``as_padded`` layout (32 queries of
             12 terms; k = 200 and around the top-k block size), with
             ``max_df=64`` truncation (the layout unsorted, the copy
             sorted), the cache's top-200 and whole ranking against the
             host scorer bit for bit, and the edge cases (unsorted rows
             with repeated pids, all-zero weights, k > n_docs, a ragged
             last doc block, an out-of-vocabulary id);
3b. build  — the ColBERTv2 index build on the card (no kernel of its
             own: k-means, the assignment and the encode are PyTorch ops
             on the card; the sample and the codec fit on the host).
             (a) a synthetic corpus at the serve config's widths (10,000
             docs, d=128, doc_maxlen=180, ~0.96 M tokens) built with
             ``build_colbert_index`` at nbits 4 and 2 (heuristic K =
             16,384, 8 Lloyd iterations on a 65,536-token sample), each
             step timed with CUDA events beside its bound; (b) the
             nbits=4 build again from the same seed, timed as well:
             every file byte for byte; (c) 300 of its docs built on the
             card and on the CPU pinned to (a)'s centroids and codec:
             every file byte for byte, unless a token's id differs at
             a tie (top-2 sims within 1e-6; counted, and then only those
             tokens differ);
             (d) the benchmarks' in-domain profile (4,000 docs) built
             freely on the card and on the CPU from one seed, the four
             methods served on the card: hybrid ≥ rerank − 0.01, hybrid
             > splade, colbert > splade, and the card build's colbert
             MRR@10 within 0.01 of the CPU build's; (e) 64 mixed
             colbert/hybrid/rerank requests of the corpus's own queries
             on (a)'s index through ``RetrievalServer`` at max_batch=32,
             fused tail: every answer held to the CPU engine, the run's
             launches the tail's two kernels and no other. Its figures
             go on a ``build`` line;
4. serve   — serve mixed splade/rerank/hybrid requests through
             ``RetrievalServer`` on ``cuda``: 64 at max_batch=32, once
             with the host stage 1 and once with
             ``splade_backend="device"`` (in turns, twice each); 24 at
             the server's default max_batch=1 and 32 with the split
             rerank tail, both with the device stage 1. Every answer is
             held to an engine built with ``device="cpu"`` over the same
             directory, each run's launch counts must show the kernels of
             its path and no other, and the device stage 1 must equal the
             host's bit for bit on the requests' terms. Then PLAID
             ``colbert`` at the serve_plaid shape (nprobe=4,
             candidate_cap=4096, ndocs=256; 32-token unit random
             queries, k ∈ {10, 100}): 64 requests at max_batch=32 on the
             mmap pool with the fused tail, 32 with the split tail, 32
             with the pool resident on the card, 16 at max_batch=1. Each
             run must launch its tail's kernel and no SPLADE kernel, the
             mmap runs' codes gather must touch no residual page, every
             answer is held to the CPU engine (through a tie at the
             probe's or the approximate stage's boundary where they
             differ), the split and resident runs equal the mmap fused
             run bit for bit, and stages 1-3 of one batch are held to the
             CPU's;
4c. front door — caches (``CacheHierarchy(exact_entries=256,
             stage1_entries=256)``), admission and the adaptive batch cap
             on the phase-3 index, device stage 1, fused tail. A: a cold
             mixed batch of 32 (8 of each method, k ∈ {10, 100}, a
             quarter with their own α) and the same batch again: 32 exact
             hits equal to the cold answers bit for bit, no launch, no
             stage run. B: hybrid and rerank on the terms the batch's
             splade requests scored, at another α or k: all stage-1
             hits, no SPLADE launch, one launch of each tail kernel. C:
             the batch's colbert requests at the other k, mmap and
             resident pools: all survivor hits, no probe or approximate
             stage, no codes read, one fused_rerank launch. D: a batch
             of 32 with 16 exact hits. B-D equal an engine without caches
             bit for bit. E: ``bump_index_generation()`` purges every
             entry; the batch then misses everything and gives the same
             bits. F: ``RetrievalServer`` admission at an SLO between the
             predicted cheap and full costs (from the warm stage EWMAs)
             degrades hybrid/rerank to the splade plan (its bits, not
             stored). G: a request with ``deadline_ms=0.001`` is shed
             before it is queued. H: an SLO below a request's service
             time halves ``batch_cap`` to 1, a slack one grows it back.
             Then a trace: 256 requests drawn with Zipf s=1.1 from 64
             distinct ones (16 queries × the four methods), served in
             waves of 32, caches off and on in turns, twice each; every
             repeat equals its first answer bit for bit. Every distinct
             answer of the phase is held to the CPU engine;
4d. pipelined — the stage executor (``ServeEngine(pipeline_depth=2)``,
             one CUDA stream per executor, an event per async window)
             through ``RetrievalServer`` at max_batch=32 on the phase-3
             index, device stage 1, fused tail: 64 mixed SPLADE-method
             requests, 64 mmap ``colbert`` requests and 32 resident
             ones, each at depth 1 and at depth 2 with ``single`` and
             ``kind`` workers in turns (1, single, kind, kind, single,
             1). Every answer equals the first depth-1 run's bit for
             bit, whose answers are held to the CPU engine; each run's
             launch counts show its path's kernels and no other; the
             codes gather touches 0 residual pages; no pipeline thread
             outlives its run. QPS, p50, p99, ``overlap_fraction``, the
             stage walls and queue waits per run go on a ``pipelined``
             line;
5. time    — time each kernel with CUDA events at the serve shapes, and
             each at B=1, in an eager loop (the rerank tail's two
             kernels, the SPLADE kernel's two entry points and
             ``index_add_`` also by CUDA-graph replay, as ``graph_ms``
             and ``library_graph_ms``); and one
             device stage-1 dispatch in its parts (host padding, the
             copy in, the top-k launch, the copy out, the whole
             dispatch, and the full sort the launch replaced). One
             colbert batch in its device parts (the probe's matmul and
             top-nprobe selection, stage 2, stage 3, and the tail's two
             kernels at C = ndocs on its survivors, where they are also
             held to their plain versions; fused_rerank also at B=1),
             eager and by replay, each against its bound.

The ``{"kernels": [...]}`` line lists each kernel once per main path
(``path``): the SPLADE methods served with the device stage 1, each
colbert run with its tail's kernel, and the front door's cold mixed
batch (``front_door``) with the three kernels of its path, phase 4d's
first single-worker runs (``pipelined_splade``, ``pipelined_colbert``,
``pipelined_colbert_resident``), and phase 3b's serve on the card-built
index (``built_index``); ``launches`` is that path's own run's
count, and the times are at that path's candidate width (``C``).

Arithmetic is IEEE fp32: TF32 is switched off for matmuls and cuDNN.
The last line of standard output is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published peaks (NVIDIA data sheets): fp32 on the CUDA cores, HBM rate
PEAKS = {"sxm": (67e12, 3.35e12), "pcie": (51e12, 2.0e12)}


@dataclasses.dataclass(frozen=True)
class Shapes:
    B: int = 32            # micro-batch (max_batch)
    Lq: int = 32           # query tokens
    C: int = 200           # first_k candidates
    Ld: int = 180          # doc_maxlen
    d: int = 128           # embedding width
    K: int = 131072        # centroids
    n_docs: int = 100_000  # cut from MS MARCO's 8.84 M
    vocab: int = 30522     # SPLADE (BERT) vocabulary
    # SPLADE traffic after the repo's synthetic corpus generator
    # (src/repro/data/synth.py, SynthCfg defaults); no public source
    # fixes these, so stage-1 cost under this traffic is not MS MARCO's
    doc_terms: int = 24        # nonzero terms per SPLADE doc vector
    query_terms: int = 12      # nonzero terms per SPLADE query vector
    terms_per_topic: int = 96  # a topic's vocabulary, drawn Zipf(1/rank)
    n_requests: int = 64
    # PLAID colbert at the serve_plaid shape
    # (src/repro/configs/colbert_serve.py:73-75)
    nprobe: int = 4
    candidate_cap: int = 4096
    ndocs: int = 256


FULL = Shapes()


def log(msg: str) -> None:
    print(f"[chip_smoke {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

def unit(x):
    return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(np.float32)


def kernel_inputs(rng, s: Shapes, nbits: int, C: int | None = None):
    """Numpy inputs of the tile kernels at the serve shapes: ragged doc
    lengths (some docs empty), ragged query lengths, ~10% of the
    candidates masked and a masked tail on some rows."""
    C = s.C if C is None else C
    B, Lq, Ld, d = s.B, s.Lq, s.Ld, s.d
    q = unit(rng.normal(size=(B, Lq, d)))
    packed = rng.integers(0, 256, (B, C, Ld, d * nbits // 8), dtype=np.uint8)
    cids = rng.integers(0, s.K, (B, C, Ld), dtype=np.int32)
    lens = rng.integers(0, Ld + 1, (B, C))
    valid = np.arange(Ld)[None, None, :] < lens[..., None]
    cmask = rng.random((B, C)) < 0.9
    for b in range(0, B, 4):          # short candidate lists
        cmask[b, C - C // 4:] = False
    qlen = rng.integers(Lq // 2, Lq + 1, B)
    q_valid = np.arange(Lq)[None, :] < qlen[:, None]
    centroids = unit(rng.normal(size=(s.K, d)))
    bw = np.sort(rng.normal(scale=0.05, size=2 ** nbits)).astype(np.float32)
    return dict(q=q, packed=packed, cids=cids, valid=valid, cmask=cmask,
                q_valid=q_valid, centroids=centroids, bw=bw)


def to_dev(arrs: dict, device) -> dict:
    import torch
    return {k: torch.as_tensor(v, device=device) for k, v in arrs.items()}


def sub_rng(seed: int, phase: str):
    """A generator of its own for a phase added after the first slice,
    so the earlier phases keep drawing the same inputs from ``--seed``."""
    return np.random.default_rng([seed, sum(map(ord, phase))])


def maxsim_inputs(rng, s: Shapes, device):
    """The tile kernels' inputs at the serve shapes (nbits=4) plus their
    decoded fp32 embeddings (B, C, Ld, d), and one all-invalid doc."""
    from repro_torch.index.residual import decode_embeddings
    x = to_dev(kernel_inputs(rng, s, 4), device)
    x["valid"][1, 5] = False
    x["emb"] = decode_embeddings(x["packed"], x["cids"], x["centroids"],
                                 x["bw"], 4)
    return x


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(rng, s: Shapes, device) -> dict:
    """Returns the largest |kernel - plain| score difference per kernel."""
    import torch
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores, decompress_maxsim_scores_batch)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk, fused_rerank_topk_batch)
    from repro_torch.kernels.fused_rerank.ref import (fused_rerank_ref,
                                                      stable_topk)
    from repro_torch.testing import ATOL, REF_MARGIN, RTOL, assert_topk_match

    err = {"decompress_maxsim": 0.0, "fused_rerank": 0.0}
    for nbits in (4, 2):
        x = to_dev(kernel_inputs(rng, s, nbits), device)
        tile = (x["q"], x["packed"], x["cids"], x["valid"])
        tables = (x["centroids"], x["bw"])
        got = decompress_maxsim_scores_batch(*tile, *tables, nbits=nbits,
                                             q_valid=x["q_valid"])
        want = decompress_maxsim_ref(*tile, *tables, nbits, x["q_valid"])
        torch.cuda.synchronize()
        e = (got - want).abs().max().item()
        err["decompress_maxsim"] = max(err["decompress_maxsim"], e)
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"decompress_maxsim nbits={nbits}")
        log(f"decompress_maxsim nbits={nbits}: max |err| {e:.3g}")

        for k in (100, s.C + 56):                      # k < C and k > C
            vals, idx = fused_rerank_topk_batch(
                *tile, x["cmask"], *tables, nbits=nbits, k=k,
                q_valid=x["q_valid"])
            wv, wi = fused_rerank_ref(*tile, x["cmask"], *tables, nbits,
                                      k + REF_MARGIN, x["q_valid"])
            assert_topk_match(wv.cpu().numpy(), wi.cpu().numpy(),
                              vals.cpu().numpy(), idx.cpu().numpy(),
                              what=f"fused_rerank nbits={nbits} k={k}")
            fin = torch.isfinite(wv[:, :k])
            e = (vals[fin] - wv[:, :k][fin]).abs().max().item()
            err["fused_rerank"] = max(err["fused_rerank"], e)
            # fused == split, bit for bit: the split tail is the scoring
            # kernel, -inf at masked candidates, a stable sort
            kk = min(k, s.C)
            sv, si = stable_topk(
                got.masked_fill(~x["cmask"], float("-inf")), kk)
            assert torch.equal(idx[:, :kk].long(), si), "fused != split ids"
            assert torch.equal(vals[:, :kk].view(torch.int32),
                               sv.view(torch.int32)), "fused != split bits"
            if k > s.C:
                assert torch.all(idx[:, s.C:] == -1)
                assert torch.all(vals[:, s.C:] == float("-inf"))
            log(f"fused_rerank nbits={nbits} k={k}: max |err| {e:.3g}, "
                "fused == split")

        # B=1 launches (the single-query entry points) at full width:
        # against their plain versions, and bit for bit against their
        # batch row
        for b in (0, 3):
            row = tuple(t[b] for t in tile)
            one = decompress_maxsim_scores(*row, *tables, nbits=nbits,
                                           q_valid=x["q_valid"][b])
            want1 = decompress_maxsim_ref(*row, *tables, nbits,
                                          x["q_valid"][b])
            np.testing.assert_allclose(
                one.cpu().numpy(), want1.cpu().numpy(), rtol=RTOL,
                atol=ATOL, err_msg=f"B=1 decompress_maxsim nbits={nbits}")
            assert torch.equal(one.view(torch.int32),
                               got[b].view(torch.int32)), \
                "B=1 decompress_maxsim != batch row"
            kk = min(100, s.C)
            v1, i1 = fused_rerank_topk(*row, x["cmask"][b], *tables,
                                       nbits=nbits, k=kk,
                                       q_valid=x["q_valid"][b])
            wv, wi = fused_rerank_ref(*row, x["cmask"][b], *tables, nbits,
                                      kk + REF_MARGIN, x["q_valid"][b])
            assert_topk_match(wv.cpu().numpy(), wi.cpu().numpy(),
                              v1.cpu().numpy(), i1.cpu().numpy(),
                              what=f"B=1 fused_rerank nbits={nbits}")
            sv, si = stable_topk(got[b].masked_fill(~x["cmask"][b],
                                                    float("-inf")), kk)
            assert torch.equal(i1.long(), si) and torch.equal(
                v1.view(torch.int32), sv.view(torch.int32)), \
                "B=1 fused_rerank != split row"
        log(f"B=1 launches nbits={nbits}: match plain, == batch row")

    # empty candidate set
    x = to_dev(kernel_inputs(rng, s, 4, C=0), device)
    tile = (x["q"], x["packed"], x["cids"], x["valid"])
    vals, idx = fused_rerank_topk_batch(*tile, x["cmask"], x["centroids"],
                                        x["bw"], nbits=4, k=10,
                                        q_valid=x["q_valid"])
    assert vals.shape == (s.B, 10) and torch.all(idx == -1)
    assert torch.all(vals == float("-inf"))
    sc = decompress_maxsim_scores_batch(*tile, x["centroids"], x["bw"],
                                        nbits=4, q_valid=x["q_valid"])
    assert sc.shape == (s.B, 0)
    torch.cuda.synchronize()
    return err


def check_maxsim(rng, s: Shapes, device) -> float:
    """MaxSim over fp32 embeddings at full width: against its plain
    version (tolerance: the plain version sums through cuBLAS), and bit
    for bit against decompress_maxsim on the embeddings it decodes.
    Returns the largest |kernel - plain|."""
    import torch
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.maxsim.ops import (maxsim_scores,
                                                maxsim_scores_batch)
    from repro_torch.kernels.maxsim.ref import maxsim_scores_ref
    from repro_torch.testing import ATOL, RTOL

    x = maxsim_inputs(rng, s, device)
    got = maxsim_scores_batch(x["q"], x["emb"], x["valid"], x["q_valid"])
    want = maxsim_scores_ref(x["q"], x["emb"], x["valid"], x["q_valid"])
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL, err_msg="maxsim")
    assert got[1, 5].item() == 0.0, "an all-invalid doc must score 0"
    split = dms(x["q"], x["packed"], x["cids"], x["valid"], x["centroids"],
                x["bw"], nbits=4, q_valid=x["q_valid"])
    assert torch.equal(got.view(torch.int32), split.view(torch.int32)), \
        "maxsim on decoded embeddings != decompress_maxsim"
    one = maxsim_scores(x["q"][3], x["emb"][3], x["valid"][3],
                        x["q_valid"][3])
    assert torch.equal(one, got[3]), "B=1 maxsim != batch row"
    log(f"maxsim: max |err| {err:.3g}, == decompress_maxsim bit for bit")
    return err


# ---------------------------------------------------------------------------
# phase 3: a synthetic index at full width
# ---------------------------------------------------------------------------

def splade_topics(rng, s: Shapes) -> np.ndarray:
    """(vocab // terms_per_topic, terms_per_topic) topic vocabularies,
    each of distinct term ids, as the repo's synthetic generator draws
    them."""
    return np.stack([rng.choice(s.vocab, s.terms_per_topic, replace=False)
                     for _ in range(s.vocab // s.terms_per_topic)])


def topic_terms(rng, topics: np.ndarray, n: int, n_terms: int):
    """n sparse vectors, each of n_terms distinct terms of one random
    topic drawn without replacement with weight 1/rank (Gumbel top-k)
    → (term ids (n, n_terms) i32, weights (n, n_terms) f32)."""
    m = topics.shape[1]
    keys = rng.gumbel(size=(n, m)) - np.log(np.arange(1, m + 1))
    slots = np.argpartition(-keys, n_terms - 1, axis=1)[:, :n_terms]
    topic = rng.integers(0, len(topics), n)
    ids = topics[topic[:, None], slots].astype(np.int32)
    return ids, (1.0 + rng.exponential(0.5, (n, n_terms))).astype(np.float32)


def write_synthetic_index(rng, s: Shapes, out: pathlib.Path, nbits: int = 4):
    from repro_torch.index.builder import write_index
    from repro_torch.index.splade_index import build_splade_index

    # MS MARCO passages average 67 tokens (configs/colbert_serve.py)
    doclens = np.clip(rng.normal(67, 30, s.n_docs).round(), 8, s.Ld)
    doclens = doclens.astype(np.int64)
    doclens[rng.integers(0, s.n_docs, s.n_docs // 50)] = s.Ld
    n_tokens = int(doclens.sum())
    cids = rng.integers(0, s.K, n_tokens, dtype=np.int32)
    packed = rng.integers(0, 256, (n_tokens, s.d * nbits // 8),
                          dtype=np.uint8)
    centroids = unit(rng.normal(size=(s.K, s.d)))
    cutoffs = np.sort(rng.normal(scale=0.05, size=2 ** nbits - 1))
    weights = np.sort(rng.normal(scale=0.05, size=2 ** nbits))
    write_index(out / "colbert", cids, packed, centroids, cutoffs, weights,
                doclens, s.K, doc_maxlen=s.Ld)
    topics = splade_topics(rng, s)
    term_ids, term_w = topic_terms(rng, topics, s.n_docs, s.doc_terms)
    build_splade_index(term_ids, term_w, s.vocab, s.n_docs).save(
        out / "splade")
    return n_tokens, topics


def kernel_rows(cache, tids, tw):
    """The SPLADE kernel's (term rows, scaled weights) for a batch of
    queries, on the cache's device — what ``score_topk`` launches on."""
    return cache.upload(*cache.scaled_weights(
        *cache.pad_queries(list(tids), list(tw))))


def check_splade(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
                 device) -> dict:
    """The SPLADE kernel's two entry points on the index's own postings,
    read from the cache's pid-sorted rows: the scores against the plain
    version on the card (atomics there: a tolerance) and, bit for bit,
    on the CPU over the unsorted ``as_padded`` layout; the per-block
    top-k candidates and the merged top-k bit for bit against theirs;
    the cache's top-k against the host scorer bit for bit. Returns the
    largest |kernel - plain| of each entry point."""
    import torch
    from repro_torch.index.splade_device import SpladeDeviceCache
    from repro_torch.index.splade_index import SpladeIndex
    from repro_torch.kernels.splade_score.ops import (
        SCORE_BLOCK_DOCS, TOPK_BLOCK_DOCS, splade_block_scores,
        splade_block_scores_batch, splade_block_topk_batch,
        splade_row_block_candidates, splade_row_scores_batch,
        splade_row_topk_batch)
    from repro_torch.kernels.splade_score.ref import (
        block_topk_ref, splade_row_scores_batch_ref)
    from repro_torch.testing import ATOL, RTOL

    index = SpladeIndex.load(path / "splade", mmap=True)
    cache = SpladeDeviceCache(index, device=device)
    log(f"splade cache: max_df {cache.max_df}, truncated_terms "
        f"{cache.truncated_terms}, nbytes {cache.nbytes()}, n_docs "
        f"{cache.n_docs}, in blocks of {SCORE_BLOCK_DOCS} (scores; the "
        f"last of {cache.n_docs % SCORE_BLOCK_DOCS}) and {TOPK_BLOCK_DOCS} "
        f"(top-k; the last of {cache.n_docs % TOPK_BLOCK_DOCS})")
    assert cache.truncated_terms == 0 and cache.row_pids is cache.pids
    assert cache.n_docs % SCORE_BLOCK_DOCS and cache.n_docs % TOPK_BLOCK_DOCS
    tids, tw = (list(a) for a in topic_terms(rng, topics, s.B,
                                              s.query_terms))
    tw[5] = np.zeros_like(tw[5])                     # an all-zero query
    rows, w = kernel_rows(cache, tids, tw)
    err = {"splade_score": 0.0, "splade_topk": 0.0}

    def against_plain(c, what):
        """Both entry points on the sorted copy against the plain version
        on the as_padded layout, which is unsorted where rows are
        truncated."""
        got = splade_row_scores_batch(c.row_pids, c.row_imps, rows, w,
                                      n_docs=c.n_docs)
        on_card = splade_row_scores_batch_ref(c.pids, c.imps, rows, w,
                                              c.n_docs)
        torch.cuda.synchronize()
        e = (got - on_card).abs().max().item()
        err["splade_score"] = max(err["splade_score"], e)
        np.testing.assert_allclose(got.cpu().numpy(), on_card.cpu().numpy(),
                                   rtol=RTOL, atol=ATOL, err_msg=what)
        cpu = (c.pids.cpu(), c.imps.cpu(), rows.cpu(), w.cpu())
        ordered = splade_row_scores_batch_ref(*cpu, c.n_docs)
        assert torch.equal(got.cpu().view(torch.int32),
                           ordered.view(torch.int32)), \
            f"{what}: kernel != ordered plain version"
        for k in (s.C, TOPK_BLOCK_DOCS - 1, TOPK_BLOCK_DOCS,
                  TOPK_BLOCK_DOCS + 1):
            cs, cp = splade_row_block_candidates(c.row_pids, c.row_imps,
                                                 rows, w, n_docs=c.n_docs,
                                                 k=k)
            ws, wp = block_topk_ref(ordered, k, TOPK_BLOCK_DOCS)
            fin = torch.isfinite(ws)
            err["splade_topk"] = max(err["splade_topk"], (
                cs.cpu()[fin] - ws[fin]).abs().max().item())
            assert torch.equal(cp.cpu(), wp) and torch.equal(
                cs.cpu().view(torch.int32), ws.view(torch.int32)), \
                f"{what}: top-{k} candidates != plain"
            tp, ts = splade_row_topk_batch(c.row_pids, c.row_imps, rows, w,
                                           n_docs=c.n_docs, k=k)
            hp, hs = splade_row_topk_batch(*cpu, n_docs=c.n_docs, k=k)
            assert torch.equal(tp.cpu(), hp) and torch.equal(
                ts.cpu().view(torch.int32), hs.view(torch.int32)), \
                f"{what}: top-{k} != plain"
        return got

    got = against_plain(cache, "splade serve batch")
    assert torch.all(got[5] == 0), "an all-zero query must score 0"
    one = splade_row_scores_batch(cache.row_pids, cache.row_imps, rows[2:3],
                                  w[2:3], n_docs=cache.n_docs)
    assert torch.equal(one[0], got[2]), "B=1 splade != batch row"
    for k in (FULL.C, cache.n_docs + 5):             # k > n_docs pads
        dp, ds = cache.score_topk(tids, tw, k)
        hp, hs = index.score_batch_host(tids, tw, k)
        assert np.array_equal(dp, hp), f"splade top-{k} pids != host"
        assert np.array_equal(ds.view(np.uint32), hs.view(np.uint32)), \
            f"splade top-{k} scores != host bits"
    log(f"splade: max |err| {err}; both entry points == their ordered "
        f"plain versions; top-{FULL.C} and the whole ranking equal the "
        "host scorer bit for bit")

    trunc = SpladeDeviceCache(index, max_df=64, device=device)
    assert trunc.truncated_terms > 0 and trunc.row_pids is not trunc.pids
    against_plain(trunc, "splade max_df=64")
    log(f"splade max_df=64: {trunc.truncated_terms} truncated terms; the "
        "kernel on the sorted copy == the ordered plain version on the "
        "unsorted layout")

    # unsorted gathered rows: repeated pids inside a row, -1 pads, f32
    # impacts, a B=1 launch
    pids = torch.as_tensor(rng.integers(-1, 40, (5, 16, 16), dtype=np.int32))
    imps = torch.as_tensor(rng.random((5, 16, 16), np.float32))
    pw = torch.as_tensor(rng.random((5, 16), np.float32))
    dev = (pids.to(device), imps.to(device), pw.to(device))
    got = splade_block_scores_batch(*dev, n_docs=700)
    want = splade_block_scores_batch(pids, imps, pw, n_docs=700)
    assert torch.equal(got.cpu().view(torch.int32), want.view(torch.int32))
    one = splade_block_scores(*(t[1] for t in dev), n_docs=700)
    assert torch.equal(one, got[1])
    for k in (1, 50, 700):
        tp, ts = splade_block_topk_batch(*dev, n_docs=700, k=k)
        hp, hs = splade_block_topk_batch(pids, imps, pw, n_docs=700, k=k)
        assert torch.equal(tp.cpu(), hp) and torch.equal(ts.cpu(), hs)
    try:
        cache.score_topk([np.array([s.vocab + 3])], [np.ones(1, np.float32)],
                         5)
    except IndexError:
        pass
    else:
        raise AssertionError("an out-of-vocabulary id must raise")
    log("splade edge cases: unsorted rows with repeated pids, all-zero "
        "weights, k around the block size, k > n_docs, ragged last block, "
        "truncation, out-of-vocabulary id")
    return err


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def plaid_params(s: Shapes):
    from repro_torch.core.plaid import PlaidParams
    return PlaidParams(nprobe=s.nprobe, candidate_cap=s.candidate_cap,
                       ndocs=s.ndocs, k=100)


def make_searcher(path: pathlib.Path, device, resident: bool = False):
    """The index's searcher on ``device``: the mmap pool, or with
    ``resident`` the pool held on the device."""
    from repro_torch.core.plaid import PLAIDSearcher
    from repro_torch.index.builder import ColBERTIndex
    return PLAIDSearcher(ColBERTIndex(path / "colbert", mode="mmap"),
                         plaid_params(FULL), device_resident=resident,
                         device=device)


def make_retriever(path: pathlib.Path, device, resident: bool = False):
    from repro_torch.core.multistage import (MultiStageParams,
                                             MultiStageRetriever)
    from repro_torch.index.splade_index import SpladeIndex
    return MultiStageRetriever(
        SpladeIndex.load(path / "splade", mmap=True),
        make_searcher(path, device, resident),
        MultiStageParams(first_k=FULL.C, k=100), device=device)


def counted_kernels() -> dict:
    """Every kernel wrapper with a launch count, by name."""
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.kernels.maxsim.ops import maxsim_scores_batch
    from repro_torch.kernels.splade_score.ops import (splade_row_scores_batch,
                                                      splade_row_topk_batch)
    return {"decompress_maxsim": dms, "fused_rerank": frk,
            "splade_score": splade_row_scores_batch,
            "splade_topk": splade_row_topk_batch,
            "maxsim": maxsim_scores_batch}


def check_launches(label: str, launches: dict, path_kernels) -> None:
    """Each kernel of the run's path launched, and no other."""
    for name in path_kernels:
        if launches[name] == 0:
            raise RuntimeError(f"kernel {name} was never launched in the "
                               f"{label} run")
    for name in set(launches) - set(path_kernels):
        if launches[name]:
            raise RuntimeError(f"the {label} run launched {name}, which is "
                               "not on its path")


def make_requests(rng, s: Shapes, topics: np.ndarray, n: int,
                  qid0: int = 0):
    from repro_torch.serving.engine import Request
    methods = ("rerank", "hybrid", "splade")
    term_ids, term_w = topic_terms(rng, topics, n, s.query_terms)
    reqs = []
    for i in range(n):
        m = methods[i % 3]
        alpha = None if i % 4 else float(rng.uniform(0.1, 0.9))
        reqs.append(Request(
            qid=qid0 + i, method=m, q_emb=unit(rng.normal(size=(s.Lq, s.d))),
            term_ids=term_ids[i], term_weights=term_w[i],
            k=(10, 100)[(i // 3) % 2], alpha=alpha))
    return reqs


def serve_run(engine, warm, reqs, max_batch: int, counted: dict):
    """Serve ``reqs`` through a ``RetrievalServer`` over ``engine`` after
    a warm-up batch, with every counter of ``counted`` (name → wrapper)
    set to 0 just before the requests and read just after."""
    from repro_torch.serving.server import RetrievalServer

    if engine.pipelined:     # the executors start in the warm-up
        engine.process_batch_async(warm).result(timeout=600)
    else:
        engine.process_batch(warm)
    server = RetrievalServer(engine, max_batch=max_batch,
                             batch_timeout_ms=5.0)
    server.start()
    try:
        engine.retriever.reset_stage_stats()
        for fn in counted.values():
            fn.launches = 0
        t0 = time.perf_counter()
        futs = [server.submit(r) for r in reqs]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {n: fn.launches for n, fn in counted.items()}
        health = server.health()
    finally:
        server.stop()
    if health["failed"] or health["served"] != len(reqs) + len(warm):
        raise RuntimeError(f"server health: {health}")
    lat = np.array([r.latency for r in results]) * 1e3
    stages = {n: r["wall_s"] for n, r in health["stages"].items()}
    return results, {
        "requests": len(results), "max_batch": max_batch,
        "batches": health["batches"],
        "qps": len(results) / wall,
        "p50_ms": float(np.percentile(lat, 50)),
        "p99_ms": float(np.percentile(lat, 99)),
        "splade_stage1_s": stages.get("splade_stage1"),
        "stage_wall_s": stages,
        "stage_queue_wait_s": {n: r["queue_wait_s"]
                               for n, r in health["stages"].items()},
        "overlap_fraction": health["overlap_fraction"],
        "stage_pages": {n: r["pages_touched"]
                        for n, r in health["stages"].items()},
        "launches": launches,
        "launches_per_batch": {n: c / health["batches"]
                               for n, c in launches.items()}}


def serve_runs(s: Shapes):
    """Phase 4's runs: (label, stage-1 backend, rerank tail, max_batch,
    number of requests). The host/device pairs at max_batch=B run in
    turns so that the two backends are compared inside one call; then
    the server's default max_batch=1 and the split tail, each on fewer
    requests."""
    full = (s.B, s.n_requests)
    return (("host", "host", "fused", *full),
            ("device", "device", "fused", *full),
            ("device", "device", "fused", *full),
            ("host", "host", "fused", *full),
            ("device_b1", "device", "fused", 1, min(24, s.n_requests)),
            ("device_split", "device", "split", s.B,
             min(32, s.n_requests)))


def serve(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
          device) -> dict:
    """Serve the runs of :func:`serve_runs` (each a prefix of the same 64
    requests); every run's answers are held to one CPU reference, and
    each run's launch counts must show the kernels of its path. →
    {label: [run line, ...]}."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import REF_MARGIN, assert_topk_match

    counted = counted_kernels()
    # the kernels each (stage-1 backend, rerank tail) must launch; the
    # device stage 1 runs the SPLADE kernel's top-k entry point
    stage1 = {"host": (), "device": ("splade_topk",)}
    tail = {"fused": ("decompress_maxsim", "fused_rerank"),
            "split": ("decompress_maxsim",)}
    retriever = make_retriever(path, device)
    warm = make_requests(rng, s, topics, 6, qid0=10_000)
    reqs = make_requests(rng, s, topics, s.n_requests)
    runs = []
    try:
        for label, backend, rerank, max_batch, n in serve_runs(s):
            retriever.set_rerank_backend(rerank)
            engine = ServeEngine(retriever, splade_backend=backend)
            results, line = serve_run(engine, warm, reqs[:n], max_batch,
                                      counted)
            line.update(splade_backend=backend, rerank_backend=rerank)
            runs.append((label, results, line))
            launches = line["launches"]
            log(f"served {len(results)} requests ({label}: {backend} stage "
                f"1, {rerank} tail, max_batch {max_batch}) in "
                f"{line['requests'] / line['qps']:.3f} s, {line['batches']} "
                f"batches; launches {launches}")
            check_launches(label, launches, stage1[backend] + tail[rerank])
    finally:
        retriever.set_rerank_backend("fused")

    # the reference answers REF_MARGIN places deeper, so that ties at
    # each answer's last place are visible
    ref_engine = ServeEngine(make_retriever(path, "cpu"))
    deeper = [dataclasses.replace(r, k=r.k + REF_MARGIN) for r in reqs]
    want = []
    for lo in range(0, len(deeper), s.B):
        want += ref_engine.process_batch(deeper[lo:lo + s.B])
    for label, results, _ in runs:
        for res, ref, req in zip(results, want, reqs):
            assert res.qid == ref.qid == req.qid
            assert_topk_match(ref.scores, ref.pids, res.scores, res.pids,
                              what=f"{label}: qid {req.qid} {req.method} "
                                   f"k={req.k}")
    log(f"every answer of all {len(runs)} runs matches the CPU engine")

    tids = [r.term_ids for r in reqs]
    tw = [r.term_weights for r in reqs]
    dp, ds = retriever.run_splade_batch(tids, tw, backend="device")
    hp, hs = retriever.run_splade_batch(tids, tw, backend="host")
    assert np.array_equal(dp, hp) and np.array_equal(
        ds.view(np.uint32), hs.view(np.uint32)), \
        "device stage 1 != host stage 1 on the served requests"
    log(f"device stage 1 == host stage 1 bit for bit on the {len(reqs)} "
        "requests")
    return {lb: [line for lb2, _, line in runs if lb2 == lb]
            for lb in dict.fromkeys(r[0] for r in serve_runs(s))}


# ---------------------------------------------------------------------------
# phase 4: serve colbert (PLAID)
# ---------------------------------------------------------------------------

def colbert_requests(rng, s: Shapes, n: int, qid0: int = 0):
    """n colbert requests: unit random queries of ``s.Lq`` tokens,
    k ∈ {10, 100}."""
    from repro_torch.serving.engine import Request
    return [Request(qid=qid0 + i, method="colbert",
                    q_emb=unit(rng.normal(size=(s.Lq, s.d))),
                    k=(10, 100)[i % 2]) for i in range(n)]


def colbert_runs(s: Shapes):
    """The colbert runs of phase 4: (label, pool resident on the card,
    rerank tail, max_batch, number of requests), each a prefix of the
    same requests."""
    n = s.n_requests
    return (("colbert", False, "fused", s.B, n),
            ("colbert_split", False, "split", s.B, min(32, n)),
            ("colbert_resident", True, "fused", s.B, min(32, n)),
            ("colbert_b1", False, "fused", 1, min(16, n)))


def candidate_counts(searcher, q_embs, B: int) -> dict:
    """Real candidates per query: the union of its probed lists, and
    what stage 2 keeps of it under the cap."""
    import torch
    before, after = [], []
    for lo in range(0, len(q_embs), B):
        st = searcher.probe_batch(q_embs[lo:lo + B])
        n = st["cids"].shape[0]
        union = searcher.ivf_padded[st["cids"].reshape(n, -1).long()]
        before += [int(torch.unique(r[r >= 0]).numel())
                   for r in union.reshape(n, -1)]
        after += (st["cand"] >= 0).sum(dim=1).tolist()
    cap = searcher.params.candidate_cap

    def summary(x):
        return {"min": int(np.min(x)), "median": float(np.median(x)),
                "max": int(np.max(x))}

    return {"before_cap": summary(before), "after_cap": summary(after),
            "queries_capped": int(sum(b > cap for b in before)),
            "queries": len(before), "ivf_longest_list": int(
                searcher.ivf_padded.shape[1])}


def check_colbert_stages(cpu, dev, q_embs, device) -> dict:
    """Stages 1-3 of one batch on the card against the CPU: probe scores
    allclose (and a B=1 probe equal to its batch row bit for bit); the
    stage-2 candidates from the CPU's probed centroids equal exactly;
    the approximate scores of the CPU's candidates allclose. Returns the
    largest differences."""
    import torch
    from repro_torch.core.plaid import (stage2_candidates_batch,
                                        stage3_approx_score_batch)
    from repro_torch.testing import ATOL, RTOL

    g, c = dev.probe_batch(q_embs), cpu.probe_batch(q_embs)
    want = c["scores_c"].to(device)
    diff = (g["scores_c"] - want).abs()
    probe_err = diff.max().item()
    if not bool((diff <= ATOL + RTOL * want.abs()).all()):
        raise AssertionError(f"probe scores differ by up to {probe_err}")
    del want, diff
    nprobe = dev.params.nprobe
    moved = sum(set(a) != set(b) for a, b in zip(
        g["cids"].cpu().numpy().reshape(-1, nprobe),
        c["cids"].numpy().reshape(-1, nprobe)))
    one = dev.probe_batch(q_embs[3:4])
    if not torch.equal(one["scores_c"][0], g["scores_c"][3]):
        raise AssertionError("a B=1 probe != its batch row")
    cand = stage2_candidates_batch(dev.ivf_padded, c["cids"].to(device),
                                   dev.params.candidate_cap)
    if not torch.equal(cand.cpu(), c["cand"]):
        raise AssertionError("stage-2 candidates from equal probes differ")
    codes, valid = cpu.gather_codes_batch(c["cand"].numpy())
    got = stage3_approx_score_batch(g["scores_c"], *dev.to_device(
        codes, valid), g["q_valid"]).cpu().numpy()
    ref = stage3_approx_score_batch(c["scores_c"], *cpu.to_device(
        codes, valid), c["q_valid"]).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL,
                               err_msg="approximate scores")
    out = {"probe_max_abs_err": probe_err, "probe_tokens_moved": moved,
           "probe_tokens": len(q_embs) * len(q_embs[0]),
           "approx_max_abs_err": float(np.abs(got - ref).max())}
    log(f"colbert stages 1-3 vs CPU on {len(q_embs)} queries: {out}; "
        "B=1 probe == batch row, stage 2 equal")
    return out


def serve_colbert(rng, s: Shapes, path: pathlib.Path, device):
    """Serve the runs of :func:`colbert_runs` through ``RetrievalServer``
    on the card. Each run must launch its tail's kernel and no other;
    the mmap runs' codes gather must touch no residual page. Every
    answer is held to a ``device="cpu"`` engine, under the tie rule
    (``repro_torch.testing.assert_colbert_match``); the resident and the
    split runs equal the mmap fused run bit for bit. → ({label: run
    line}, stage check, candidate counts)."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import REF_MARGIN, assert_colbert_match

    counted = counted_kernels()
    tail = {"fused": ("fused_rerank",), "split": ("decompress_maxsim",)}
    pools = {False: make_retriever(path, device),
             True: make_retriever(path, device, resident=True)}
    warm = colbert_requests(rng, s, 4, qid0=20_000)
    reqs = colbert_requests(rng, s, s.n_requests)
    runs = []
    for label, resident, rerank, max_batch, n in colbert_runs(s):
        retriever = pools[resident]
        retriever.set_rerank_backend(rerank)
        try:
            results, line = serve_run(ServeEngine(retriever), warm,
                                      reqs[:n], max_batch, counted)
        finally:
            retriever.set_rerank_backend("fused")
        line.update(method="colbert", rerank_backend=rerank,
                    pool="resident" if resident else "mmap")
        check_launches(label, line["launches"], tail[rerank])
        pages = line["stage_pages"]
        if not resident and (pages["host_gather:codes"] != 0
                             or pages["host_gather:residuals"] == 0):
            raise RuntimeError(f"{label}: residual pages touched by the "
                               f"codes / residual gathers: {pages}")
        log(f"served {n} colbert requests ({label}: {line['pool']} pool, "
            f"{rerank} tail, max_batch {max_batch}) at {line['qps']:.1f} "
            f"QPS, p50 {line['p50_ms']:.1f} ms, p99 {line['p99_ms']:.1f} "
            f"ms; stage walls {line['stage_wall_s']}; residual pages "
            f"{pages}; launches {line['launches']}")
        runs.append((label, results, line, retriever.searcher))

    cpu = make_retriever(path, "cpu")
    ref_engine = ServeEngine(cpu)
    deeper = [dataclasses.replace(r, k=r.k + REF_MARGIN) for r in reqs]
    want = []
    for lo in range(0, len(deeper), s.B):
        want += ref_engine.process_batch(deeper[lo:lo + s.B])
    for label, results, line, searcher in runs:
        routes = {}
        for res, ref, req in zip(results, want, reqs):
            assert res.qid == ref.qid == req.qid
            route = assert_colbert_match(
                cpu.searcher, searcher, req.q_emb, (ref.scores, ref.pids),
                (res.scores, res.pids),
                what=f"{label}: qid {req.qid} k={req.k}")
            if route:
                routes[route] = routes.get(route, 0) + 1
        line["tie_routes"] = routes
        log(f"{label}: all {len(results)} answers match the CPU engine; "
            f"through a tie at a stage boundary: {routes or 'none'}")
    by_label = {label: results for label, results, _, _ in runs}
    for label in ("colbert_split", "colbert_resident"):
        for a, b in zip(by_label[label], by_label["colbert"]):
            if not (np.array_equal(a.pids, b.pids) and np.array_equal(
                    a.scores.view(np.uint32), b.scores.view(np.uint32))):
                raise AssertionError(f"{label} qid {a.qid} != the mmap "
                                     "fused run")
    log("colbert: the split and the resident runs equal the mmap fused "
        "run bit for bit")
    stages = check_colbert_stages(cpu.searcher, pools[False].searcher,
                                  [r.q_emb for r in reqs[:s.B]], device)
    counts = candidate_counts(pools[False].searcher,
                              [r.q_emb for r in reqs], s.B)
    log(f"colbert candidates per query: {counts}")
    return {label: line for label, _, line, _ in runs}, stages, counts


# ---------------------------------------------------------------------------
# phase 4c: the front door (caches, admission, the adaptive batch cap)
# ---------------------------------------------------------------------------

DOOR_METHODS = ("splade", "rerank", "hybrid", "colbert")
DOOR_KERNELS = ("splade_topk", "fused_rerank", "decompress_maxsim")


def door_requests(rng, s: Shapes, topics: np.ndarray, n: int,
                  methods=DOOR_METHODS, qid0: int = 0):
    """n requests of distinct random queries (a unit query of ``s.Lq``
    tokens and ``s.query_terms`` topic terms each), the methods in turn,
    k ∈ {10, 100}, a quarter with their own α."""
    from repro_torch.serving.engine import Request
    term_ids, term_w = topic_terms(rng, topics, n, s.query_terms)
    reqs = []
    for i in range(n):
        alpha = None if i % 4 else float(rng.uniform(0.1, 0.9))
        reqs.append(Request(
            qid=qid0 + i, method=methods[i % len(methods)],
            q_emb=unit(rng.normal(size=(s.Lq, s.d))), term_ids=term_ids[i],
            term_weights=term_w[i], k=(10, 100)[(i // len(methods)) % 2],
            alpha=alpha))
    return reqs


def fresh(reqs, **kw):
    """Copies of requests without their lifecycle record (``ctx``), so
    that an engine resolves each anew; ``kw`` replaces fields."""
    return [dataclasses.replace(r, ctx=None, **kw) for r in reqs]


def same_bits(want, got, what: str) -> None:
    """Each result of ``got`` equals its result in ``want`` bit for bit."""
    for a, b in zip(want, got, strict=True):
        if not (np.array_equal(a.pids, b.pids) and np.array_equal(
                np.asarray(a.scores).view(np.uint32),
                np.asarray(b.scores).view(np.uint32))):
            raise AssertionError(f"{what}: qid {b.qid} differs from its "
                                 "cold answer")


def reset_counts(retriever, counted: dict) -> None:
    """Set the stage records and every launch count to 0."""
    retriever.reset_stage_stats()
    for fn in counted.values():
        fn.launches = 0


def read_counts(counted: dict) -> dict:
    return {n: fn.launches for n, fn in counted.items()}


def expect_launches(what: str, launches: dict, want: dict) -> None:
    """The run launched exactly ``want`` (name → count; others 0)."""
    got = {n: c for n, c in launches.items() if c}
    if got != {n: c for n, c in want.items() if c}:
        raise RuntimeError(f"{what}: launches {launches}, expected {want}")


class ProbeCalls:
    """Counts a searcher's probe (stages 1-2) and approximate-stage calls
    while in use: a survivor hit makes neither."""

    def __init__(self, searcher):
        self.searcher, self.calls = searcher, 0

    def _counted(self, fn):
        def call(*a, **kw):
            self.calls += 1
            return fn(*a, **kw)
        return call

    def __enter__(self):
        s = self.searcher
        s.probe_batch = self._counted(s.probe_batch)
        s.approx_select_batch = self._counted(s.approx_select_batch)
        return self

    def __exit__(self, *exc):
        del self.searcher.probe_batch, self.searcher.approx_select_batch


def hold_to_cpu(cpu, searchers: dict, held: list, s: Shapes) -> dict:
    """Hold each (request, card result, pool) of ``held`` to the CPU
    engine's answer ``REF_MARGIN`` places deeper; ``colbert`` through the
    tie rule against that pool's searcher. → {tie route: count}."""
    from repro_torch.testing import (REF_MARGIN, assert_colbert_match,
                                     assert_topk_match)
    deeper = [dataclasses.replace(r, ctx=None, k=r.k + REF_MARGIN)
              for r, _, _ in held]
    want = []
    for lo in range(0, len(deeper), s.B):
        want += cpu.process_batch(deeper[lo:lo + s.B])
    routes = {}
    for (req, res, pool), ref in zip(held, want, strict=True):
        what = f"front door: qid {req.qid} {req.method} k={req.k}"
        if req.method != "colbert":
            assert_topk_match(ref.scores, ref.pids, res.scores, res.pids,
                              what=what)
            continue
        route = assert_colbert_match(
            cpu.retriever.searcher, searchers[pool], req.q_emb,
            (ref.scores, ref.pids), (res.scores, res.pids), what=what)
        if route:
            routes[route] = routes.get(route, 0) + 1
    return routes


def door_exact(cached, counted, batch) -> tuple:
    """A: a cold mixed batch, then the same batch again: every answer an
    exact hit equal to the cold one bit for bit, with no launch and no
    stage run."""
    retriever = cached.retriever
    reset_counts(retriever, counted)
    t0 = time.perf_counter()
    cold = cached.process_batch(fresh(batch))
    cold_s = time.perf_counter() - t0
    launches = read_counts(counted)
    check_launches("front door cold batch", launches, DOOR_KERNELS)
    if any(r.cache_hit for r in cold):
        raise AssertionError("A: a hit in the cold batch")
    reset_counts(retriever, counted)
    t0 = time.perf_counter()
    warm = cached.process_batch(fresh(batch))
    hit_s = time.perf_counter() - t0
    stages = retriever.pipeline_stats.snapshot()["stages"]
    if not all(r.cache_hit for r in warm):
        raise AssertionError("A: the repeated batch missed the exact cache")
    same_bits(cold, warm, "A: exact hit")
    expect_launches("A: exact hits", read_counts(counted), {})
    if stages:
        raise AssertionError(f"A: exact hits ran stages {list(stages)}")
    if any(r.pids.flags.writeable or r.scores.flags.writeable for r in warm):
        raise AssertionError("A: a hit's arrays are writeable")
    return cold, {"requests": len(batch), "cold_s": cold_s, "hit_s": hit_s,
                  "hits": len(warm), "launches_cold": launches,
                  "launches_hit": 0}


def door_stage1(cached, plain, counted, batch, rng) -> tuple:
    """B: hybrid and rerank requests on the terms the cold batch's splade
    requests scored, at another α or k: every row a stage-1 hit, no
    SPLADE launch, one launch of each tail; equal to the engine without
    caches bit for bit."""
    retriever = cached.retriever
    sp = [r for r in batch if r.method == "splade"]
    reqs = ([dataclasses.replace(r, ctx=None, qid=r.qid + 1000,
                                 method="hybrid",
                                 alpha=float(rng.uniform(0.1, 0.9)))
             for r in sp]
            + [dataclasses.replace(r, ctx=None, qid=r.qid + 2000,
                                   method="rerank", k=110 - r.k)
               for r in sp])
    reset_counts(retriever, counted)
    got = cached.process_batch(fresh(reqs))
    launches = read_counts(counted)
    counters = retriever.pipeline_stats.snapshot()["counters"]
    if any(r.cache_hit for r in got):
        raise AssertionError("B: an exact hit")
    if counters != {"cache_stage1_hits": len(reqs),
                    "cache_stage1_misses": 0, "cache_exact_stores":
                    len(reqs)}:
        raise AssertionError(f"B: counters {counters}")
    expect_launches("B: stage-1 hits", launches,
                    {"fused_rerank": 1, "decompress_maxsim": 1})
    same_bits(plain.process_batch(fresh(reqs)), got, "B: stage-1 hit")
    return reqs, got, {"requests": len(reqs), "counters": counters,
                       "launches": launches}


def door_survivors(cached, plain, counted, batch) -> tuple:
    """C: the cold batch's colbert requests at the other k: every row a
    survivor hit (no probe or approximate stage, no codes read), one
    fused_rerank launch; equal to the engine without caches bit for
    bit."""
    retriever = cached.retriever
    reqs = [dataclasses.replace(r, ctx=None, k=110 - r.k)
            for r in batch if r.method == "colbert"]
    reset_counts(retriever, counted)
    with ProbeCalls(retriever.searcher) as calls:
        got = cached.process_batch(fresh(reqs))
    snap = retriever.pipeline_stats.snapshot()
    codes = snap["stages"]["host_gather:codes"]
    launches = read_counts(counted)
    if calls.calls or snap["counters"].get("cache_stage1_hits") != len(reqs):
        raise AssertionError(f"C: probe calls {calls.calls}, counters "
                             f"{snap['counters']}")
    if codes["pages_touched"] or codes["tokens_read"]:
        raise AssertionError(f"C: the codes gather read {codes}")
    expect_launches("C: survivor hits", launches, {"fused_rerank": 1})
    same_bits(plain.process_batch(fresh(reqs)), got, "C: survivor hit")
    return reqs, got, {"requests": len(reqs), "probe_calls": calls.calls,
                       "counters": snap["counters"],
                       "codes_gather": {n: codes[n] for n in (
                           "pages_touched", "tokens_read")},
                       "launches": launches}


def front_door(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
               device) -> tuple:
    """Phase 4c: checks A-H and the Zipf trace (see the module docstring)
    on the phase-3 index, with the device stage 1 and the fused tail. →
    (the phase's figures, the cold batch's launches)."""
    from repro_torch.serving.context import CacheHierarchy
    from repro_torch.serving.engine import ServeEngine

    counted = counted_kernels()
    retr = make_retriever(path, device)
    plain = ServeEngine(retr, splade_backend="device")
    caches = CacheHierarchy(exact_entries=256, stage1_entries=256)
    cached = ServeEngine(retr, caches=caches)
    out = {}
    plain.process_batch(door_requests(rng, s, topics, 8, qid0=30_000))

    batch = door_requests(rng, s, topics, s.B, qid0=31_000)
    cold, out["A"] = door_exact(cached, counted, batch)
    held = [(r, res, "mmap") for r, res in zip(batch, cold)]
    log(f"front door A: {s.B} exact hits equal their cold answers bit for "
        f"bit, no launch, no stage; cold {out['A']['cold_s']:.3f} s, hits "
        f"{out['A']['hit_s'] * 1e3:.3f} ms")

    reqs, got, out["B"] = door_stage1(cached, plain, counted, batch, rng)
    held += [(r, res, "mmap") for r, res in zip(reqs, got)]
    log(f"front door B: {len(reqs)} stage-1 hits equal the engine without "
        f"caches bit for bit; launches {out['B']['launches']}")

    reqs, got, out["C"] = door_survivors(cached, plain, counted, batch)
    held += [(r, res, "mmap") for r, res in zip(reqs, got)]
    resident = make_retriever(path, device, resident=True)
    r_cached = ServeEngine(resident, caches=CacheHierarchy(256, 256))
    r_cached.process_batch(fresh([r for r in batch
                                  if r.method == "colbert"]))
    _, r_got, out["C_resident"] = door_survivors(
        r_cached, ServeEngine(resident), counted, batch)
    same_bits(got, r_got, "C: resident survivor hit vs mmap")
    log(f"front door C: {len(reqs)} colbert survivor hits at the other k, "
        "mmap and resident, no probe, no codes read, one fused_rerank "
        "launch each; equal to the engine without caches and resident == "
        "mmap bit for bit")

    new = door_requests(rng, s, topics, s.B // 2, qid0=32_000)
    mixed = [x for pair in zip(batch[:s.B // 2], new) for x in pair]
    reset_counts(retr, counted)
    got = cached.process_batch(fresh(mixed))
    if [r.cache_hit for r in got] != [True, False] * (s.B // 2):
        raise AssertionError("D: hits are not the cached half")
    same_bits(plain.process_batch(fresh(mixed)), got, "D: partial hits")
    held += [(r, res, "mmap") for r, res in zip(mixed[1::2], got[1::2])]
    out["D"] = {"requests": len(mixed), "hits": s.B // 2,
                "launches": read_counts(counted)}
    log(f"front door D: a batch of {len(mixed)} with {s.B // 2} exact hits "
        "equals the engine without caches bit for bit")

    sizes = (len(caches.exact), len(caches.stage1))
    before = (caches.exact.invalidations, caches.stage1.invalidations)
    gen = retr.bump_index_generation()
    purged = (caches.exact.invalidations - before[0],
              caches.stage1.invalidations - before[1])
    if purged != sizes or len(caches.exact) or len(caches.stage1):
        raise AssertionError(f"E: purged {purged} of {sizes}")
    reset_counts(retr, counted)
    again = cached.process_batch(fresh(batch))
    counters = retr.pipeline_stats.snapshot()["counters"]
    if any(r.cache_hit for r in again) or counters.get("cache_stage1_hits"):
        raise AssertionError(f"E: a hit after the bump: {counters}")
    same_bits(cold, again, "E: after the generation bump")
    out["E"] = {"generation": gen, "purged": purged,
                "launches": read_counts(counted)}
    log(f"front door E: generation {gen} purged {purged} entries (exact, "
        "stage 1); the batch misses everything and gives the same bits")

    as_splade, f_res, out["F"], out["G"] = door_admission(
        cached, plain, rng, s, topics)
    held += [(r, res, "mmap") for r, res in zip(as_splade, f_res)]
    log(f"front door F: at an SLO of {out['F']['slo_ms']:.3f} ms (stage 1 "
        f"{out['F']['stage1_ms']:.3f} ms, tail {out['F']['tail_ms']:.3f} "
        f"ms) {len(f_res)} hybrid/rerank requests came back degraded "
        "(slo_tail), equal to the splade plan bit for bit and not stored; "
        "G: the request past its deadline was shed before it was queued")

    out["H"] = door_batch_cap(plain, rng, s, topics)
    log(f"front door H: batch_cap {out['H']}")

    out["trace"], t_held = door_trace(retr, plain, counted, rng, s, topics)
    held += t_held
    searchers = {"mmap": retr.searcher, "resident": resident.searcher}
    cpu = ServeEngine(make_retriever(path, "cpu"))
    out["tie_routes"] = hold_to_cpu(cpu, searchers, held, s)
    log(f"front door: {len(held)} distinct answers match the CPU engine; "
        f"through a tie at a stage boundary: {out['tie_routes'] or 'none'}")
    return out, out["A"]["launches_cold"]


def door_admission(cached, plain, rng, s: Shapes, topics) -> tuple:
    """F: through ``RetrievalServer`` admission at an SLO between the
    predicted cheap and full costs (from the stage EWMAs of a warm batch)
    degrades hybrid/rerank requests, one at a time (the queue empty at
    each decision), to the splade plan: its bits, flagged ``slo_tail``,
    never stored. G: a request with ``deadline_ms=0.001`` is shed before
    it is queued. → (the requests as splade requests, their results, F's
    figures, G's figures)."""
    from repro_torch.serving.admission import (AdmissionController,
                                               RequestShed)
    from repro_torch.serving.server import RetrievalServer
    retr, caches = cached.retriever, cached.caches
    retr.reset_stage_stats()
    plain.process_batch(door_requests(rng, s, topics, s.B,
                                      ("hybrid", "rerank", "splade"),
                                      qid0=33_000))
    stage1_ms, tail_ms, _ = AdmissionController.stage_costs(
        retr.pipeline_stats.snapshot()["stages"])
    # the splade plan's own dispatches move the stage-1 EWMA, by less
    # than half the tail when the tail is over twice stage 1
    if not tail_ms > 2 * stage1_ms:
        raise RuntimeError(f"F: tail {tail_ms} ms is not over twice stage "
                           f"1's {stage1_ms} ms")
    slo = stage1_ms + tail_ms / 2
    f_reqs = door_requests(rng, s, topics, 8, ("hybrid", "rerank"),
                           qid0=34_000)
    g_req = door_requests(rng, s, topics, 1, ("hybrid",), qid0=35_000)[0]
    g_req.deadline_ms = 0.001
    n_exact = len(caches.exact)
    srv = RetrievalServer(cached, max_batch=s.B, batch_timeout_ms=5.0,
                          admission=AdmissionController(slo))
    srv.start()
    try:
        f_res = [srv.submit(r).result(timeout=600) for r in f_reqs]
        depth = srv.queue.qsize()
        try:
            srv.submit(g_req).result(timeout=60)
        except RequestShed as e:
            shed = e.reason
        else:
            raise AssertionError("G: the request past its deadline was "
                                 "served")
        health = srv.health()
    finally:
        srv.stop()
    if any((r.degraded, r.degrade_reason) != (True, "slo_tail")
           for r in f_res):
        raise AssertionError("F: " + str([(r.degraded, r.degrade_reason)
                                          for r in f_res]))
    if len(caches.exact) != n_exact or any(
            caches.exact.get(r.ctx.cache_key, count_miss=False) is not None
            for r in f_reqs):
        raise AssertionError("F: a degraded answer was stored")
    as_splade = fresh(f_reqs, method="splade")
    same_bits(plain.process_batch(as_splade), f_res, "F: degraded answer")
    if (shed, health["sheds"], health["queue_depth"]) != ("deadline", 1,
                                                         depth):
        raise AssertionError(f"G: shed {shed}, health {health}")
    return as_splade, f_res, {
        "slo_ms": slo, "stage1_ms": stage1_ms, "tail_ms": tail_ms,
        "degraded": len(f_res), "admission": health["admission"]}, {
        "shed_reason": shed, "sheds": health["sheds"],
        "queue_depth": health["queue_depth"]}


def door_batch_cap(engine, rng, s: Shapes, topics) -> dict:
    """H: an SLO below one request's service time halves the batch cap to
    1; a slack one grows it back to ``max_batch`` after
    ``grow_patience`` batches that fill the cap. Requests are queued
    before the workers start, so that every batch fills."""
    from repro_torch.serving.server import RetrievalServer
    reqs = door_requests(rng, s, topics, 6 * s.B, ("splade",), qid0=36_000)
    one_ms = min(engine.process(r).service_time for r in reqs[:3]) * 1e3
    srv = RetrievalServer(engine, max_batch=s.B, batch_timeout_ms=5.0,
                          latency_slo_ms=one_ms / 4)
    out = {"slo_tight_ms": one_ms / 4}
    for label, part, slo in (("tight", reqs[:2 * s.B], one_ms / 4),
                             ("slack", reqs[2 * s.B:], 1e6)):
        srv.latency_slo_ms = slo
        futs = [srv.submit(r) for r in part]
        b0 = srv.batches
        srv.start()
        try:
            for f in futs:
                f.result(timeout=600)
        finally:
            srv.stop()
        out[label] = {"requests": len(part), "batches": srv.batches - b0,
                      "batch_cap": srv.batch_cap,
                      "ewma_latency_ms": srv.ewma_latency_ms}
    if out["tight"]["batch_cap"] != 1 or out["slack"]["batch_cap"] != s.B:
        raise AssertionError(f"H: {out}")
    return out


def door_trace(retr, plain, counted, rng, s: Shapes, topics,
               n_queries: int = 16, n: int = 256, zipf_s: float = 1.1):
    """The trace: ``n`` requests drawn with Zipf(``zipf_s``) over
    ``4 * n_queries`` distinct requests (each query asked by the four
    methods), served at max_batch=B in waves of B (a wave is submitted
    when the last one is answered), caches off and on in turns, twice
    each. Every repeat equals the distinct request's first answer of
    the first run bit for bit. → (figures, that run's distinct answers
    for the CPU check)."""
    from repro_torch.serving.context import CacheHierarchy
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.server import RetrievalServer

    distinct = []
    for q in door_requests(rng, s, topics, n_queries, ("splade",),
                           qid0=40_000):
        for m in DOOR_METHODS:
            alpha = (float(rng.uniform(0.1, 0.9)) if rng.random() < 0.25
                     else None)
            distinct.append(dataclasses.replace(
                q, method=m, qid=len(distinct), k=int(rng.choice([10, 100])),
                alpha=alpha))
    weight = np.arange(1, len(distinct) + 1, dtype=np.float64) ** -zipf_s
    weight = weight[rng.permutation(len(distinct))]
    order = rng.choice(len(distinct), size=n, p=weight / weight.sum())

    runs, first = [], {}
    for label in ("off", "on", "on", "off"):
        caches = CacheHierarchy(256, 256) if label == "on" else None
        retr.attach_caches(None)
        engine = plain if caches is None else ServeEngine(retr,
                                                          caches=caches)
        reset_counts(retr, counted)
        srv = RetrievalServer(engine, max_batch=s.B, batch_timeout_ms=5.0)
        srv.start()
        results, at_submit = [], []
        t0 = time.perf_counter()
        try:
            for lo in range(0, n, s.B):
                futs = []
                for j in order[lo:lo + s.B]:
                    futs.append(srv.submit(dataclasses.replace(
                        distinct[j], ctx=None)))
                    at_submit.append(futs[-1].done())
                results += [f.result(timeout=600) for f in futs]
            wall = time.perf_counter() - t0
            health = srv.health()
        finally:
            srv.stop()
        for j, res in zip(order, results):
            if j not in first:
                first[j] = res
            else:
                same_bits([first[j]], [res], f"trace ({label}): a repeat")
        lat = np.array([r.latency for r in results]) * 1e3
        sub = lat[np.array(at_submit)]
        c = health["counters"]
        s1 = c.get("cache_stage1_hits", 0) + c.get("cache_stage1_misses", 0)
        runs.append({
            "caches": label, "requests": n, "qps": n / wall,
            "p50_ms": float(np.percentile(lat, 50)),
            "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)),
            "exact_hits": int(sum(r.cache_hit for r in results)),
            "exact_hit_share": sum(r.cache_hit for r in results) / n,
            "submit_hits": int(len(sub)),
            "submit_hit_p50_ms": (float(np.percentile(sub, 50))
                                  if len(sub) else None),
            "stage1_lookups": s1,
            "stage1_hit_share": (c.get("cache_stage1_hits", 0) / s1
                                 if s1 else None),
            "batches": health["batches"], "counters": c,
            "stage_wall_s": {m: r["wall_s"]
                             for m, r in health["stages"].items()},
            "launches": read_counts(counted)})
        log(f"front door trace, caches {label}: {runs[-1]}")
    retr.attach_caches(None)
    held = [(distinct[j], first[j], "mmap") for j in sorted(first)]
    return {"distinct": len(distinct), "drawn": len(first),
            "zipf_s": zipf_s, "wave": s.B, "runs": runs}, held


# ---------------------------------------------------------------------------
# phase 4d: the pipelined executor
# ---------------------------------------------------------------------------

def pipelined_workloads(s: Shapes):
    """Phase 4d's workloads: (name, pool resident on the card, number of
    requests, the kernels of its path)."""
    return (("splade", False, s.n_requests,
             ("splade_topk", "decompress_maxsim", "fused_rerank")),
            ("colbert", False, s.n_requests, ("fused_rerank",)),
            ("colbert_resident", True, min(32, s.n_requests),
             ("fused_rerank",)))


# depth 1, then the executor with each worker mode, in turns
PIPELINED_TURNS = ((1, None), (2, "single"), (2, "kind"), (2, "kind"),
                   (2, "single"), (1, None))


def pipelined(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
              device) -> dict:
    """Phase 4d: serve each workload of :func:`pipelined_workloads`
    through ``RetrievalServer`` at depth 1 and with the engine at
    ``pipeline_depth=2``, single and kind workers, in the turns of
    ``PIPELINED_TURNS`` (device stage 1, fused tail). Every answer
    equals the first depth-1 run's bit for bit, whose answers are held
    to the CPU engine; each run's launch counts show its path's kernels
    and no other; the mmap codes gather touches no residual page; no
    pipeline thread outlives its run. → {workload: [run line, ...]}."""
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.testing import REF_MARGIN, assert_colbert_match, \
        assert_topk_match

    counted = counted_kernels()
    splade_reqs = make_requests(rng, s, topics, s.n_requests)
    colbert_reqs = colbert_requests(rng, s, s.n_requests)
    warm = {"splade": make_requests(rng, s, topics, 6, qid0=50_000),
            "colbert": colbert_requests(rng, s, 4, qid0=50_100)}
    pools = {False: make_retriever(path, device),
             True: make_retriever(path, device, resident=True)}
    out, first = {}, {}
    for name, resident, n, kernels in pipelined_workloads(s):
        retriever = pools[resident]
        reqs = (splade_reqs if name == "splade" else colbert_reqs)[:n]
        lines = out[name] = []
        for depth, workers in PIPELINED_TURNS:
            engine = ServeEngine(retriever, splade_backend="device",
                                 pipeline_depth=depth,
                                 pipeline_workers=workers or "single")
            results, line = serve_run(
                engine, warm["splade" if name == "splade" else "colbert"],
                fresh(reqs), s.B, counted)
            label = f"pipelined {name} depth {depth}" + (
                f" {workers}" if workers else "")
            left = [t for t in threading.enumerate()
                    if t.name.startswith(("pipe-", "pipeline-retry"))]
            for t in left:
                t.join(timeout=30)
            if any(t.is_alive() for t in left):
                raise RuntimeError(f"{label}: pipeline threads left "
                                   f"running: {[t.name for t in left]}")
            check_launches(label, line["launches"], kernels)
            pages = line["stage_pages"]
            if not resident and name == "colbert" and (
                    pages["host_gather:codes"] != 0
                    or pages["host_gather:residuals"] == 0):
                raise RuntimeError(f"{label}: residual pages touched by "
                                   f"the codes / residual gathers: {pages}")
            if name not in first:
                first[name] = results
            else:
                same_bits(first[name], results, label)
            line.update(workload=name, depth=depth, workers=workers,
                        pool="resident" if resident else "mmap")
            lines.append(line)
            log(f"{label}: {line['qps']:.1f} QPS, p50 "
                f"{line['p50_ms']:.1f} ms, p99 {line['p99_ms']:.1f} ms, "
                f"overlap {line['overlap_fraction']:.3f}, {line['batches']} "
                f"batches; stage walls {line['stage_wall_s']}; launches "
                f"{line['launches']}; equal to depth 1 bit for bit")

    cpu = make_retriever(path, "cpu")
    ref_engine = ServeEngine(cpu)
    for name, resident, n, _ in pipelined_workloads(s):
        if name == "colbert_resident":
            continue          # the prefix of the colbert draws, held below
        deeper = [dataclasses.replace(r, k=r.k + REF_MARGIN)
                  for r in (splade_reqs if name == "splade"
                            else colbert_reqs)[:n]]
        want = []
        for lo in range(0, len(deeper), s.B):
            want += ref_engine.process_batch(deeper[lo:lo + s.B])
        for res, ref, req in zip(first[name], want, deeper):
            what = f"pipelined {name}: qid {req.qid} {req.method}"
            if req.method == "colbert":
                assert_colbert_match(cpu.searcher, pools[False].searcher,
                                     req.q_emb, (ref.scores, ref.pids),
                                     (res.scores, res.pids), what=what)
            else:
                assert_topk_match(ref.scores, ref.pids, res.scores,
                                  res.pids, what=what)
    same_bits(first["colbert"][:len(first["colbert_resident"])],
              first["colbert_resident"], "pipelined: resident vs mmap")
    log("pipelined: every depth-1 answer matches the CPU engine, the "
        "resident colbert answers equal the mmap ones bit for bit")
    return out


# ---------------------------------------------------------------------------
# phase 3b: the index build on the card
# ---------------------------------------------------------------------------

# the serve config's widths (src/repro/configs/colbert_serve.py:26-34:
# d=128, doc_maxlen=180, query_maxlen=32) and BERT's vocabulary; 10,000
# docs of the synthetic generator (mean length 96) are ~0.96 M tokens
BUILD_CORPUS = dict(n_docs=10_000, n_queries=256, dim=128, doc_maxlen=180,
                    query_maxlen=32, vocab=30522)
# the benchmarks' in-domain profile (benchmarks/common.py:26), built as
# they build it (benchmarks/common.py:43-46: nbits=4, 6 iterations) and
# served at their parameters
QUALITY_CORPUS = dict(n_docs=4000, n_queries=300, n_topics=96, seed=11)
QUALITY_ITERS = 6
PINNED_DOCS = 300
BUILD_REQUESTS = 64
INDEX_FILES = ("residuals.bin", "codes.bin", "meta.json", "centroids.npy",
               "bucket_cutoffs.npy", "bucket_weights.npy", "doclens.npy",
               "doc_offsets.npy", "ivf_pids.bin", "ivf_offsets.npy")
# the files that follow from the tokens' centroid ids
CID_FILES = ("codes.bin", "residuals.bin", "ivf_pids.bin", "ivf_offsets.npy")


class BuildSteps:
    """While in use, marks a free build's steps with CUDA events at the
    call and the return of ``kmeans.train_kmeans``, ``assign`` and
    ``update``, ``residual.fit_codec`` and ``encode_residuals`` and
    ``builder.write_index``, each after a synchronise, so that the host's
    steps and the card's read alike as wall time on the card's clock."""

    WRAPPED = (("kmeans", "train_kmeans"), ("kmeans", "assign"),
               ("kmeans", "update"), ("residual", "fit_codec"),
               ("residual", "encode_residuals"), ("builder", "write_index"))

    def __init__(self):
        self.marks = []

    def mark(self, label: str) -> None:
        import torch
        torch.cuda.synchronize()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((label, ev))

    def _wrapped(self, name: str, fn):
        def call(*a, **kw):
            self.mark(name + ">")
            out = fn(*a, **kw)
            self.mark(name + "<")
            return out
        return call

    def __enter__(self):
        from repro_torch.index import builder, kmeans, residual
        mods = {"kmeans": kmeans, "residual": residual, "builder": builder}
        self.saved = [(mods[m], n, getattr(mods[m], n))
                      for m, n in self.WRAPPED]
        for mod, name, fn in self.saved:
            setattr(mod, name, self._wrapped(name, fn))
        self.mark("build>")
        return self

    def __exit__(self, *exc):
        self.mark("build<")
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)

    def steps(self) -> dict:
        """→ ms of each step: the flatten, the sample and their copies to
        the card; the initial draw; each Lloyd iteration (assign +
        update on the sample); assigning every token; assigning the
        sample for the fit; the fit; the encode; the copy of the codes
        to the host; the write; the whole build."""
        labels = [lb for lb, _ in self.marks]
        ev = [e for _, e in self.marks]

        def ms(a: int, b: int) -> float:
            return ev[a].elapsed_time(ev[b])

        t0, t1 = labels.index("train_kmeans>"), labels.index("train_kmeans<")
        lloyd, j = [], labels.index("assign>", t0)
        out = {"sample_ms": ms(0, t0), "init_ms": ms(t0, j)}
        while j < t1:
            end = labels.index("update<", j)
            lloyd.append(ms(j, end))
            j = end + 1
        out["lloyd_ms"] = lloyd
        a = labels.index("assign>", t1)
        b = labels.index("assign>", a + 1)
        f = labels.index("fit_codec>")
        e = labels.index("encode_residuals>")
        w = labels.index("write_index>")
        out.update(assign_all_ms=ms(a, a + 1), assign_sample_ms=ms(b, b + 1),
                   fit_ms=ms(f, f + 1), encode_ms=ms(e, e + 1),
                   copy_out_ms=ms(e + 1, w), write_ms=ms(w, w + 1),
                   total_ms=ms(0, len(ev) - 1))
        return out


def build_bounds(n_tokens: int, n_sample: int, K: int, d: int, nbits: int,
                 peaks) -> dict:
    """The least time of the build's device steps: the larger of their
    fp32 operations over the fp32 peak and the bytes they must move
    (each input read once, each output written once) over HBM. →
    {step: (ms, "operations" | "bytes")}."""
    flops, hbm = peaks

    def least(ops: float, nbytes: float):
        t_ops, t_bytes = ops / flops, nbytes / hbm
        return (max(t_ops, t_bytes) * 1e3,
                "operations" if t_ops >= t_bytes else "bytes")

    return {
        # (N, d) · (d, K) and the row max; in: points, centroids; out:
        # ids and sims
        "assign_all": least(2 * n_tokens * K * d,
                            4 * (n_tokens * d + K * d + 2 * n_tokens)),
        # assign on the sample, then the sums; in: sample, centroids;
        # out: centroids
        "lloyd_iteration": least(2 * n_sample * K * d + n_sample * d,
                                 4 * (n_sample * d + 2 * K * d)),
        # in: tokens, their ids, centroids, cutoffs; out: packed codes
        "encode": least(n_tokens * d * (1 + nbits),
                        4 * (n_tokens * d + n_tokens + K * d
                             + 2 ** nbits - 1)
                        + n_tokens * d * nbits // 8)}


def same_index_files(a: pathlib.Path, b: pathlib.Path, what: str,
                     skip=()) -> None:
    for name in INDEX_FILES:
        if name not in skip and (a / name).read_bytes() != \
                (b / name).read_bytes():
            raise AssertionError(f"{what}: {name} differs")


def tie_ids(tokens: np.ndarray, centroids: np.ndarray, a: np.ndarray,
            b: np.ndarray) -> np.ndarray:
    """The tokens whose ids differ between two assignments; each must be
    a tie, its two best sims (fp32, on the CPU) within 1e-6."""
    import torch
    diff = np.nonzero(a != b)[0]
    if len(diff):
        top2 = torch.topk(torch.from_numpy(tokens[diff])
                          @ torch.from_numpy(centroids).T, 2).values
        gap = (top2[:, 0] - top2[:, 1]).numpy()
        if (gap > 1e-6).any():
            raise AssertionError(f"{int((gap > 1e-6).sum())} ids differ "
                                 "between the card and the CPU without a "
                                 f"tie (largest gap {gap.max()})")
    return diff


def check_pinned(corpus, geometry: pathlib.Path, root: pathlib.Path,
                 device) -> dict:
    """(c): the first ``PINNED_DOCS`` docs built on the card and on the
    CPU, pinned to ``geometry``'s centroids and codec: every file byte
    for byte, except where a token's id differs at a tie (then the ids
    differ only there, and the residual rows only at those tokens)."""
    from repro_torch.index.builder import build_colbert_index
    embs = corpus["doc_embs"][:PINNED_DOCS]
    lens = corpus["doc_lens"][:PINNED_DOCS]
    pin = {n: np.load(geometry / f"{n}.npy")
           for n in ("centroids", "bucket_cutoffs", "bucket_weights")}
    card, host = (build_colbert_index(root / f"pinned_{dev}", embs, lens,
                                      nbits=4, device=dev, **pin)
                  for dev in (device, "cpu"))
    codes = [np.fromfile(p / "codes.bin", np.int32) for p in (card, host)]
    tokens = embs[np.arange(embs.shape[1])[None] < lens[:, None]]
    ties = tie_ids(tokens, pin["centroids"], *codes)
    same_index_files(card, host, "pinned build, card vs CPU",
                     skip=CID_FILES if len(ties) else ())
    if len(ties):
        res = [np.fromfile(p / "residuals.bin", np.uint8).reshape(
            len(codes[0]), -1) for p in (card, host)]
        moved = np.nonzero((res[0] != res[1]).any(axis=1))[0]
        if not np.isin(moved, ties).all():
            raise AssertionError("pinned build: residual rows differ at "
                                 "tokens whose ids agree")
    out = {"docs": PINNED_DOCS, "tokens": len(codes[0]),
           "tie_ids": len(ties), "files_byte_equal": not len(ties)}
    log(f"build (c): pinned card build == CPU build on {PINNED_DOCS} docs "
        f"({len(codes[0])} tokens): {out}")
    return out


def quality(corpus, path: pathlib.Path, methods, device) -> dict:
    """Each method's MRR@10, nDCG@10, R@5, R@50 and S@5 over the
    corpus's queries, served on ``device`` through ``ServeEngine`` at
    the benchmarks' parameters (benchmarks/common.py:51-56)."""
    from repro_torch.core.multistage import (MultiStageParams,
                                             MultiStageRetriever)
    from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
    from repro_torch.eval import metrics
    from repro_torch.index.builder import ColBERTIndex
    from repro_torch.index.splade_index import build_splade_index
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = corpus["cfg"]
    retr = MultiStageRetriever(
        build_splade_index(corpus["doc_term_ids"],
                           corpus["doc_term_weights"], cfg.vocab,
                           cfg.n_docs),
        PLAIDSearcher(ColBERTIndex(path), PlaidParams(
            nprobe=4, candidate_cap=1024, ndocs=256, k=100), device=device),
        MultiStageParams(first_k=200, k=100, alpha=0.3), device=device)
    engine, qrels, out = ServeEngine(retr), corpus["qrels"], {}
    for m in methods:
        reqs = [Request(qid=i, method=m, q_emb=corpus["q_embs"][i],
                        term_ids=corpus["q_term_ids"][i],
                        term_weights=corpus["q_term_weights"][i], k=100)
                for i in range(cfg.n_queries)]
        ranked = np.stack([r.pids for lo in range(0, len(reqs), FULL.B)
                           for r in engine.process_batch(
                               reqs[lo:lo + FULL.B])])
        out[m] = {"MRR@10": metrics.mrr_at_k(ranked, qrels, 10),
                  "nDCG@10": metrics.ndcg_at_k(ranked, qrels, 10),
                  "R@5": metrics.recall_at_k(ranked, qrels, 5),
                  "R@50": metrics.recall_at_k(ranked, qrels, 50),
                  "S@5": metrics.success_at_k(ranked, qrels, 5)}
    return out


def check_quality(root: pathlib.Path, device) -> dict:
    """(d): the in-domain profile built freely on the card and on the
    CPU from one seed; the four methods of the card build served on the
    card, and colbert of the CPU build. The quality benchmark's
    relationships hold (benchmarks/bench_quality.py:67-69), and the
    card build's colbert MRR@10 is within 0.01 of the CPU build's."""
    from repro_torch.data.synth import SynthCfg, make_corpus
    from repro_torch.index.builder import build_colbert_index
    corpus = make_corpus(SynthCfg(**QUALITY_CORPUS))
    dirs = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        dirs[str(dev)] = build_colbert_index(
            root / f"quality_{dev}", corpus["doc_embs"], corpus["doc_lens"],
            nbits=4, kmeans_iters=QUALITY_ITERS, seed=0, device=dev)
        log(f"build (d): in-domain profile built on {dev} in "
            f"{time.perf_counter() - t0:.2f} s")
    card, host = dirs[str(device)], dirs["cpu"]
    codes = [np.fromfile(p / "codes.bin", np.int32) for p in (card, host)]
    agree = float(np.mean(codes[0] == codes[1]))
    q = quality(corpus, card, ("colbert", "splade", "rerank", "hybrid"),
                device)
    q_cpu = quality(corpus, host, ("colbert",), device)
    mrr = {m: r["MRR@10"] for m, r in q.items()}
    log(f"build (d): card build {q}; CPU build colbert {q_cpu['colbert']}; "
        f"cid agreement {agree:.6f}")
    if not (mrr["hybrid"] >= mrr["rerank"] - 0.01
            and mrr["hybrid"] > mrr["splade"]
            and mrr["colbert"] > mrr["splade"]):
        raise AssertionError(f"quality relationships broken: {mrr}")
    gap = abs(mrr["colbert"] - q_cpu["colbert"]["MRR@10"])
    if gap > 0.01:
        raise AssertionError(f"colbert MRR@10 of the card build is {gap} "
                             "from the CPU build's")
    return {"card_build": q, "cpu_build": q_cpu, "cid_agreement": agree,
            "colbert_mrr_gap": gap,
            "tokens": len(codes[0]),
            "n_centroids": int(np.load(card / "centroids.npy").shape[0])}


def built_requests(corpus, n: int, first: int = 0, qid0: int = 0):
    """n requests of the corpus's own queries from ``first``: colbert,
    hybrid and rerank in turn, k ∈ {10, 100}, a quarter with their own
    α."""
    from repro_torch.serving.engine import Request
    methods = ("colbert", "hybrid", "rerank")
    return [Request(qid=qid0 + i, method=methods[i % 3],
                    q_emb=corpus["q_embs"][first + i],
                    term_ids=corpus["q_term_ids"][first + i],
                    term_weights=corpus["q_term_weights"][first + i],
                    k=(10, 100)[(i // 3) % 2],
                    alpha=None if i % 4 else 0.1 + 0.8 * (i % 7) / 6)
            for i in range(n)]


def serve_built(corpus, root: pathlib.Path, s: Shapes, device) -> dict:
    """(e): ``BUILD_REQUESTS`` mixed requests on the card-built index
    through ``RetrievalServer`` at max_batch=B with the fused tail, held
    to the CPU engine on the same directory; the run launches the
    tail's two kernels and no other."""
    from repro_torch.serving.engine import ServeEngine
    counted = counted_kernels()
    retr = make_retriever(root, device)
    reqs = built_requests(corpus, BUILD_REQUESTS)
    warm = built_requests(corpus, 6, first=BUILD_REQUESTS, qid0=40_000)
    results, line = serve_run(ServeEngine(retr), warm, reqs, s.B, counted)
    check_launches("built_index", line["launches"],
                   ("fused_rerank", "decompress_maxsim"))
    routes = hold_to_cpu(ServeEngine(make_retriever(root, "cpu")),
                         {"mmap": retr.searcher},
                         [(r, res, "mmap") for r, res in zip(reqs, results)],
                         s)
    line["tie_routes"] = routes
    log(f"build (e): served {len(reqs)} requests on the card-built index "
        f"at {line['qps']:.1f} QPS; every answer matches the CPU engine "
        f"(tie routes: {routes or 'none'}); launches {line['launches']}")
    return line


def build_phase(seed: int, s: Shapes, root: pathlib.Path, device,
                peaks) -> dict:
    """Phase 3b (see the module docstring): (a) the free build at full
    width, nbits 4 and 2, each step timed; (b) the nbits=4 build again,
    byte for byte; (c) pinned card == CPU; (d) quality, card and CPU
    builds; (e) serving the card-built index. → the phase's figures."""
    from repro_torch.data.synth import SynthCfg, make_corpus
    from repro_torch.index.builder import build_colbert_index
    from repro_torch.index.splade_index import build_splade_index

    t0 = time.perf_counter()
    cfg = SynthCfg(**BUILD_CORPUS, seed=seed)
    corpus = make_corpus(cfg)
    embs, lens = corpus["doc_embs"], corpus["doc_lens"]
    n_tokens = int(lens.sum())
    build_splade_index(corpus["doc_term_ids"], corpus["doc_term_weights"],
                       cfg.vocab, cfg.n_docs).save(root / "splade")
    out = {"corpus": dict(BUILD_CORPUS, seed=seed, tokens=n_tokens),
           "corpus_s": time.perf_counter() - t0, "builds": {}}
    log(f"build (a): corpus of {cfg.n_docs} docs, {n_tokens} tokens in "
        f"{out['corpus_s']:.1f} s")

    # the first build pays the card's first calls (cuBLAS, the sort);
    # the repeat of (b) is timed too
    for nbits, name, label in ((4, "colbert", "nbits4"),
                               (2, "nbits2", "nbits2"),
                               (4, "again", "nbits4_again")):
        with BuildSteps() as steps:
            build_colbert_index(root / name, embs, lens, nbits=nbits,
                                seed=seed, device=device)
        meta = json.loads((root / name / "meta.json").read_text())
        K = meta["n_centroids"]
        n_sample = min(65536, n_tokens)
        bounds = build_bounds(n_tokens, n_sample, K, cfg.dim, nbits, peaks)
        out["builds"][label] = {
            "nbits": nbits, "n_centroids": K, "sample": n_sample,
            "steps": steps.steps(),
            "bounds": {k: {"ms": v[0], "bound_by": v[1]}
                       for k, v in bounds.items()}}
        log(f"build (a): {label}, K={K}: {out['builds'][label]}")

    same_index_files(root / "colbert", root / "again",
                     "two card builds from one seed")
    out["reproducible"] = True
    log("build (b): a second card build from the same seed writes the "
        "same bytes in every file")

    out["pinned"] = check_pinned(corpus, root / "colbert", root, device)
    out["quality"] = check_quality(root, device)
    out["serve"] = serve_built(corpus, root, s, device)
    return out


# ---------------------------------------------------------------------------
# phase 5: timing
# ---------------------------------------------------------------------------

def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_time_ms(fn, iters: int = 20, reps: int = 5) -> float:
    """CUDA-event ms per call of ``fn`` with the host's enqueue taken out:
    ``iters`` calls captured in one CUDA graph, replayed ``reps`` times.
    An eager loop of a kernel that is shorter than its wrapper's Python
    times the host, not the card."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def bound(x: dict, s: Shapes, peaks, fused: bool) -> tuple[float, str]:
    """The least time the card could take: bytes the function must move
    (each input read once, each output written once; packed codes and
    ids only of the valid tokens of the candidates it scores, centroid
    rows only those those tokens use) over the memory rate, against the
    FLOPs (2·d per real query token per scored doc token) over the fp32
    peak."""
    import torch
    flops_peak, bw_peak = peaks
    scored = x["valid"] & x["cmask"][..., None] if fused else x["valid"]
    n_tok = scored.sum(dim=(1, 2)).double()                  # (B,)
    q_real = x["q_valid"].sum(dim=1).double()
    n_cent = torch.unique(x["cids"][scored]).numel()
    pd = x["packed"].shape[-1]
    B, C = x["cmask"].shape
    n_bytes = (n_tok.sum().item() * (pd + 4) + x["valid"].numel()
               + x["q"].numel() * 4 + x["q_valid"].numel()
               + n_cent * s.d * 4 + x["bw"].numel() * 4)
    n_bytes += B * C + B * 100 * 8 if fused else B * C * 4
    flops = (n_tok * q_real).sum().item() * 2 * s.d
    t_bytes, t_ops = n_bytes / bw_peak, flops / flops_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def rows_of(x: dict, b: int) -> dict:
    """Batch row ``b`` of the tile inputs as a batch of one (the tables
    stay whole)."""
    return {k: v if k in ("centroids", "bw") else v[b:b + 1]
            for k, v in x.items()}


def splade_bound(cache, rows, w, peaks, k: int | None = None
                 ) -> tuple[float, str]:
    """Bytes: the real postings of the queried rows (4-byte pid and
    1-byte impact each, padding not counted), the (rows, weights) slots
    and the function's output: the (B, n_docs) f32 scores, or with ``k``
    the (B, k) pids and scores, 8 bytes a place (the launch's per-block
    candidates are its own intermediate); operations: one multiply and
    one add per real posting, at the fp32 peak."""
    flops_peak, bw_peak = peaks
    live = (rows >= 0) & (w > 0)
    r = rows[live].long()
    entries = (cache.pids[r] >= 0).sum().item()
    B = rows.shape[0]
    written = B * (cache.n_docs * 4 if k is None else k * 8)
    n_bytes = entries * 5 + rows.numel() * 8 + written
    t_bytes, t_ops = n_bytes / bw_peak, 2 * entries / flops_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def maxsim_bound(x: dict, s: Shapes, peaks) -> tuple[float, str]:
    """Bytes: the fp32 rows of the valid doc tokens, the valid flags,
    the query and its flags, the (B, C) output; operations: 2·d FLOPs
    per (real query token, valid doc token) pair, at the fp32 peak."""
    flops_peak, bw_peak = peaks
    n_tok = x["valid"].sum(dim=(1, 2)).double()
    q_real = x["q_valid"].sum(dim=1).double()
    B, C = x["valid"].shape[:2]
    n_bytes = (n_tok.sum().item() * s.d * 4 + x["valid"].numel()
               + x["q"].numel() * 4 + x["q_valid"].numel() + B * C * 4)
    flops = (n_tok * q_real).sum().item() * 2 * s.d
    t_bytes, t_ops = n_bytes / bw_peak, flops / flops_peak
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def wall_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Host-clock ms of ``fn`` followed by a device synchronize, the mean
    over ``iters`` calls after ``warmup``."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def stage1_breakdown(cache, tids, tw, k: int) -> dict:
    """One device stage-1 dispatch of ``cache.score_topk`` in its parts:
    padding and scaling on the host, the host-to-device copy (host
    clock, synchronized), the top-k launch, which selects and merges on
    the card (CUDA events: eager, and by graph replay for its device
    time), the device-to-host copy, and the whole dispatch (host clock,
    synchronized). ``select_full_ms`` times what the selection was
    before the top-k launch: one stable sort of the (B, n_docs) scores
    of the scores launch."""
    from repro_torch.kernels.fused_rerank.ref import stable_topk
    from repro_torch.kernels.splade_score.ops import (splade_row_scores_batch,
                                                      splade_row_topk_packed)

    def host():
        return cache.scaled_weights(*cache.pad_queries(tids, tw))

    rows_np, w_np = host()
    rows, w = cache.upload(rows_np, w_np)
    k_eff = min(k, cache.n_docs)
    args = (cache.row_pids, cache.row_imps, rows, w)

    def kernel():
        return splade_row_topk_packed(*args, n_docs=cache.n_docs, k=k_eff)

    packed = kernel()
    scores = splade_row_scores_batch(*args, n_docs=cache.n_docs)
    return {"B": len(tids), "k": k,
            "host_ms": wall_ms(host),
            "h2d_ms": wall_ms(lambda: cache.upload(rows_np, w_np)),
            "kernel_ms": cuda_time_ms(kernel, 20),
            "kernel_graph_ms": graph_time_ms(kernel),
            "d2h_ms": wall_ms(lambda: cache.finalize_topk(
                (packed, k_eff, len(tids), k))),
            "dispatch_ms": wall_ms(lambda: cache.score_topk(tids, tw, k)),
            "select_full_ms": cuda_time_ms(
                lambda: stable_topk(scores, k_eff), 20)}


def tile_fns(x: dict, fused: bool) -> dict:
    """The rerank tail's kernel on tile inputs ``x`` (nbits=4, k=100)
    and its plain version, as timing closures."""
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.kernels.fused_rerank.ref import fused_rerank_ref

    t = (x["q"], x["packed"], x["cids"], x["valid"])
    tables = (x["centroids"], x["bw"])
    if fused:
        return {
            "ms": lambda: frk(*t, x["cmask"], *tables, nbits=4, k=100,
                              q_valid=x["q_valid"]),
            "plain": lambda: fused_rerank_ref(*t, x["cmask"], *tables, 4,
                                              100, x["q_valid"])}
    return {"ms": lambda: dms(*t, *tables, nbits=4, q_valid=x["q_valid"]),
            "plain": lambda: decompress_maxsim_ref(*t, *tables, 4,
                                                   x["q_valid"])}


def tail_errors(x: dict) -> dict:
    """The rerank tail's two kernels against their plain versions on tile
    inputs ``x`` (nbits=4, k=100): scores allclose, the fused top-k's ids
    equal up to tie groups. → the largest |kernel - plain| per kernel."""
    import torch
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.kernels.fused_rerank.ref import fused_rerank_ref
    from repro_torch.testing import ATOL, REF_MARGIN, RTOL, assert_topk_match

    t = (x["q"], x["packed"], x["cids"], x["valid"])
    tables = (x["centroids"], x["bw"])
    got = dms(*t, *tables, nbits=4, q_valid=x["q_valid"])
    want = decompress_maxsim_ref(*t, *tables, 4, x["q_valid"])
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=RTOL, atol=ATOL,
                               err_msg="decompress_maxsim")
    vals, idx = frk(*t, x["cmask"], *tables, nbits=4, k=100,
                    q_valid=x["q_valid"])
    wv, wi = fused_rerank_ref(*t, x["cmask"], *tables, 4, 100 + REF_MARGIN,
                              x["q_valid"])
    assert_topk_match(wv.cpu().numpy(), wi.cpu().numpy(), vals.cpu().numpy(),
                      idx.cpu().numpy(), what="fused_rerank")
    fin = torch.isfinite(wv[:, :100])
    return {"decompress_maxsim": (got - want).abs().max().item(),
            "fused_rerank": (vals[fin] - wv[:, :100][fin]).abs().max().item()}


def measure(fns, bound_fn, library=None, graph=False) -> dict:
    """Time ``fns["ms"]`` (and ``fns["plain"]``, where given, and
    ``library``) in turns — plain, kernel, library, library, kernel,
    plain — so that drift on the card does not favour one of them; each
    number is the mean of its two turns, both turns are kept. ``ms`` and
    ``library_ms`` are eager loops, every kernel's yardstick; with
    ``graph`` the kernel and the library call are also timed by
    CUDA-graph replay (graph_ms, library_graph_ms: their device time
    without the host's enqueue)."""
    order = ([("plain_ms", fns["plain"], cuda_time_ms, 10)]
             if "plain" in fns else [])
    timed = [("ms", fns["ms"])]
    if library is not None:
        timed.append(("library_ms", library))
    for name, fn in timed:
        order.append((name, fn, cuda_time_ms, 20))
        if graph:
            order.append((name.replace("ms", "graph_ms"), fn,
                          graph_time_ms, 20))
    turns = {name: [] for name, _, _, _ in order}
    for name, fn, timer, iters in order + order[::-1]:
        turns[name].append(timer(fn, iters))
    out = {name: sum(t) / len(t) for name, t in turns.items()}
    out.setdefault("library_ms", None)
    return dict(out, turns=turns, bound=bound_fn())


def time_kernels(rng, s: Shapes, device, peaks, path: pathlib.Path,
                 topics: np.ndarray, seed: int) -> dict:
    """CUDA-event times of each kernel, its plain version and (where one
    PyTorch call computes the same function) that call, at the serve
    shapes (batch) and for one query of them (b1)."""
    import torch
    from repro_torch.index.splade_device import SpladeDeviceCache
    from repro_torch.index.splade_index import SpladeIndex
    from repro_torch.kernels.maxsim.ops import maxsim_scores_batch
    from repro_torch.kernels.maxsim.ref import maxsim_scores_ref
    from repro_torch.kernels.fused_rerank.ref import stable_topk
    from repro_torch.kernels.splade_score.ops import (splade_row_scores_batch,
                                                      splade_row_topk_batch)
    from repro_torch.kernels.splade_score.ref import (
        splade_row_scores_batch_ref)

    out = {}
    x = to_dev(kernel_inputs(rng, s, 4), device)
    x1 = rows_of(x, 3)
    out["decompress_maxsim"] = {
        "batch": measure(tile_fns(x, False), lambda: bound(x, s, peaks, False),
                         graph=True),
        "b1": measure(tile_fns(x1, False), lambda: bound(x1, s, peaks, False),
                      graph=True)}
    out["fused_rerank"] = {
        "batch": measure(tile_fns(x, True), lambda: bound(x, s, peaks, True),
                         graph=True),
        "b1": measure(tile_fns(x1, True), lambda: bound(x1, s, peaks, True),
                      graph=True)}
    del x, x1

    m = maxsim_inputs(sub_rng(seed, "maxsim timing"), s, device)
    m1 = rows_of(m, 3)

    def maxsim_fns(m):
        args = (m["q"], m["emb"], m["valid"], m["q_valid"])
        return {"ms": lambda: maxsim_scores_batch(*args),
                "plain": lambda: maxsim_scores_ref(*args)}

    out["maxsim"] = {
        "batch": measure(maxsim_fns(m), lambda: maxsim_bound(m, s, peaks)),
        "b1": measure(maxsim_fns(m1), lambda: maxsim_bound(m1, s, peaks))}
    del m, m1

    cache = SpladeDeviceCache(SpladeIndex.load(path / "splade", mmap=True),
                              device=device)
    srng = sub_rng(seed, "splade timing")
    rows, w = kernel_rows(cache, *topic_terms(srng, topics, s.B,
                                              s.query_terms))

    def splade_fns(rows, w):
        args = (cache.row_pids, cache.row_imps, rows, w)
        # the single PyTorch call that computes the same function: one
        # index_add_ of the masked entries into the flattened scores
        B = rows.shape[0]
        live = (rows >= 0) & (w > 0)
        safe = torch.where(live, rows, 0).long()
        pids = cache.pids[safe].long()
        keep = live[..., None] & (pids >= 0)
        target = (torch.arange(B, device=device).view(B, 1, 1)
                  * cache.n_docs + pids)[keep]
        vals = (w[..., None] * cache.imps[safe].float())[keep]
        scores = torch.zeros(B * cache.n_docs, device=device)
        return ({"ms": lambda: splade_row_scores_batch(
                    *args, n_docs=cache.n_docs),
                 "plain": lambda: splade_row_scores_batch_ref(
                    *args, cache.n_docs)},
                lambda: scores.index_add_(0, target, vals))

    stids, stw = (list(a) for a in topic_terms(
        sub_rng(seed, "splade breakdown"), topics, s.B, s.query_terms))
    out["stage1"] = {"batch": stage1_breakdown(cache, stids, stw, s.C),
                     "b1": stage1_breakdown(cache, stids[:1], stw[:1], s.C)}
    log(f"stage-1 breakdown: {out['stage1']}")
    fns, lib = splade_fns(rows, w)
    fns1, lib1 = splade_fns(rows[2:3], w[2:3])
    out["splade_score"] = {
        "batch": measure(fns, lambda: splade_bound(cache, rows, w, peaks),
                         library=lib, graph=True),
        "b1": measure(fns1, lambda: splade_bound(cache, rows[2:3], w[2:3],
                                                 peaks), library=lib1,
                      graph=True)}

    def topk_fns(rows, w):
        # the top-k launch (per-block candidates and their merge); its
        # plain version: the scores and one stable sort of them; no
        # single PyTorch call does either
        args = (cache.row_pids, cache.row_imps, rows, w)
        kw = dict(n_docs=cache.n_docs, k=s.C)
        return {"ms": lambda: splade_row_topk_batch(*args, **kw),
                "plain": lambda: stable_topk(splade_row_scores_batch_ref(
                    *args, cache.n_docs), s.C)}

    out["splade_topk"] = {
        at: measure(topk_fns(r, ww), lambda r=r, ww=ww: splade_bound(
            cache, r, ww, peaks, s.C), graph=True)
        for at, (r, ww) in (("batch", (rows, w)),
                            ("b1", (rows[2:3], w[2:3])))}
    return out


def time_colbert(rng, s: Shapes, device, peaks, path: pathlib.Path) -> dict:
    """One colbert batch at the serve_plaid shape in its device parts —
    the probe's matmul, its top-nprobe selection, stage 2, stage 3 — and
    the exact tail's two kernels on the batch's real survivors (C =
    ndocs; fused_rerank also for one of its queries, B=1), each eager and
    by CUDA-graph replay, against its bound; the tail's kernels also
    held to their plain versions on those survivors (``max_abs_err``)."""
    import torch
    from repro_torch.core.plaid import (stage2_candidates_batch,
                                        stage3_approx_score_batch,
                                        topk_ordered)
    searcher = make_searcher(path, device)
    p = searcher.params
    st = searcher.probe_batch([unit(rng.normal(size=(s.Lq, s.d)))
                               for _ in range(s.B)])
    q2, cent = st["q"].reshape(-1, s.d), searcher.centroids
    B, Lq, K, d = s.B, s.Lq, s.K, s.d
    flops_peak, bw_peak = peaks

    def bound_of(n_bytes, ops):
        t_bytes, t_ops = n_bytes / bw_peak, ops / flops_peak
        return (max(t_bytes, t_ops) * 1e3,
                "bytes" if t_bytes >= t_ops else "operations")

    out = {"B": B, "Lq": Lq, "K": K, "d": d, "nprobe": p.nprobe,
           "candidate_cap": p.candidate_cap, "ndocs": p.ndocs}
    # bytes: the centroid table, the queries and the (B, Lq, K) scores
    # written once; operations: 2·d per (query token, centroid)
    out["probe_matmul"] = measure(
        {"ms": lambda: torch.matmul(q2, cent.T)},
        lambda: bound_of((K * d + B * Lq * d + B * Lq * K) * 4,
                         2 * B * Lq * K * d), graph=True)
    # the scores read once, (value, index) pairs written; a compare each
    out["probe_select"] = measure(
        {"ms": lambda: topk_ordered(st["scores_c"], p.nprobe)},
        lambda: bound_of(B * Lq * K * 4 + B * Lq * p.nprobe * 12,
                         B * Lq * K), graph=True)
    P = searcher.ivf_padded.shape[1]
    # the probed ids, their padded lists, the (B, cap) candidates
    out["stage2"] = measure(
        {"ms": lambda: stage2_candidates_batch(searcher.ivf_padded,
                                               st["cids"], p.candidate_cap)},
        lambda: bound_of(B * Lq * p.nprobe * (4 + P * 4)
                         + B * p.candidate_cap * 4, 0), graph=True)
    codes, valid = searcher.to_device(*searcher.gather_codes_batch(
        st["cand"].cpu().numpy()))
    # the scores, the codes and flags read once, (B, C) written; a max
    # per (query token, candidate token)
    out["stage3"] = measure(
        {"ms": lambda: stage3_approx_score_batch(st["scores_c"], codes,
                                                 valid, st["q_valid"])},
        lambda: bound_of(B * Lq * K * 4 + codes.numel() * 5 + B * Lq
                         + B * p.candidate_cap * 4, codes.numel() * Lq),
        graph=True)
    final = searcher.approx_select_batch(st["scores_c"], codes, valid,
                                         st["q_valid"], st["cand"])
    del codes, valid
    f_codes, f_packed, f_valid = searcher.to_device(
        *searcher.gather_tokens_batch(final.cpu().numpy()))
    x = dict(q=st["q"], packed=f_packed, cids=f_codes, valid=f_valid,
             cmask=final >= 0, q_valid=st["q_valid"], centroids=cent,
             bw=searcher.bucket_weights)
    x1 = rows_of(x, 3)
    err, err1 = tail_errors(x), tail_errors(x1)
    out["fused_rerank"] = dict(measure(tile_fns(x, True),
                                       lambda: bound(x, s, peaks, True),
                                       graph=True),
                               max_abs_err=err["fused_rerank"])
    out["decompress_maxsim"] = dict(measure(tile_fns(x, False),
                                            lambda: bound(x, s, peaks, False),
                                            graph=True),
                                    max_abs_err=err["decompress_maxsim"])
    out["fused_rerank_b1"] = dict(measure(tile_fns(x1, True),
                                          lambda: bound(x1, s, peaks, True),
                                          graph=True),
                                  max_abs_err=err1["fused_rerank"])
    log(f"colbert timing: {out}")
    return out


# ---------------------------------------------------------------------------

# each kernel's source and the TPU kernel it replaces
SOURCES = {
    "decompress_maxsim": (
        "src/repro_torch/kernels/csrc/decompress_maxsim.cu",
        "src/repro/kernels/decompress_maxsim/decompress_maxsim.py:132"),
    "fused_rerank": (
        "src/repro_torch/kernels/csrc/fused_rerank.cu",
        "src/repro/kernels/fused_rerank/fused_rerank.py:144"),
    "splade_score": (
        "src/repro_torch/kernels/csrc/splade_score.cu",
        "src/repro/kernels/splade_score/splade_score.py:97"),
    "splade_topk": (
        "src/repro_torch/kernels/csrc/splade_score.cu",
        "src/repro/kernels/splade_score/splade_score.py:97"),
    "maxsim": (
        "src/repro_torch/kernels/csrc/maxsim.cu",
        "src/repro/kernels/maxsim/maxsim.py:83"),
}


def kernel_entries(served: dict, colbert: dict, door: dict, times: dict,
                   ctimes: dict, err: dict, s: Shapes, piped: dict,
                   built: dict) -> list:
    """The ``{"kernels": [...]}`` line's entries: one per main path and
    kernel, with that path's launches from its own run (counts set to 0
    just before it, read just after) and the kernel timed at that path's
    shape: the SPLADE methods served with the device stage 1 (C =
    first_k; every kernel, those off this path at 0 launches), and each
    colbert run's tail kernel on real survivors (C = ndocs); the front
    door's cold mixed batch with the kernels of its path, timed at the
    serve shape; phase 4d's first single-worker run of each workload
    with the kernels of its path; phase 3b's serve on the card-built
    index (``built``: its launches) with the tail's two kernels, timed
    at the serve shape."""
    paths = [("serve_device", served["device"][0]["launches"], kname,
              times[kname]["batch"], err[kname], s.C) for kname in SOURCES]
    paths += [("front_door", door, kname, times[kname]["batch"], err[kname],
               s.C) for kname in DOOR_KERNELS]
    paths += [(label, colbert[label]["launches"], kname, ctimes[t_key],
               ctimes[t_key]["max_abs_err"], s.ndocs)
              for label, kname, t_key in (
                  ("colbert", "fused_rerank", "fused_rerank"),
                  ("colbert_split", "decompress_maxsim", "decompress_maxsim"),
                  ("colbert_resident", "fused_rerank", "fused_rerank"),
                  ("colbert_b1", "fused_rerank", "fused_rerank_b1"))]
    single = {name: next(ln for ln in lines if ln["workers"] == "single")
              for name, lines in piped.items()}
    paths += [("pipelined_splade", single["splade"]["launches"], kname,
               times[kname]["batch"], err[kname], s.C)
              for kname in DOOR_KERNELS]
    paths += [(f"pipelined_{name}", single[name]["launches"], "fused_rerank",
               ctimes["fused_rerank"], ctimes["fused_rerank"]["max_abs_err"],
               s.ndocs) for name in ("colbert", "colbert_resident")]
    paths += [("built_index", built, kname, times[kname]["batch"],
               err[kname], s.C) for kname in ("fused_rerank",
                                              "decompress_maxsim")]
    out = []
    for path_name, launches, kname, t, max_err, C in paths:
        src, replaces = SOURCES[kname]
        bound_ms, bound_by = t["bound"]
        out.append({
            "name": kname, "path": path_name, "C": C, "route": "cuda",
            "source": src, "replaces": replaces,
            "launches": launches[kname], "max_abs_err": max_err,
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": t["library_ms"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible; this script runs only "
              "on a GPU", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("TF32 off for matmul and cuDNN: IEEE fp32 throughout")
    device = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    card = card_line()
    print(card, flush=True)
    peaks = PEAKS["pcie" if "PCIe" in card else "sxm"]
    rng = np.random.default_rng(args.seed)
    s = FULL

    t_all = t0 = time.perf_counter()
    _build.load()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s "
        f"({_build.library_path().name})")
    ptxas = _build.library_path().with_suffix(".log").read_text()
    for line in ptxas.splitlines():
        if "entry function" in line or "registers" in line \
                or "spill" in line:
            log("  ptxas: " + line.strip())

    t0 = time.perf_counter()
    err = check_kernels(rng, s, device)
    err["maxsim"] = check_maxsim(sub_rng(args.seed, "maxsim"), s, device)
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = pathlib.Path(tmp)
        t0 = time.perf_counter()
        n_tokens, topics = write_synthetic_index(rng, s, path)
        log(f"phase 3 index: {s.n_docs} docs, {n_tokens} tokens, "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        err.update(check_splade(sub_rng(args.seed, "splade"), s, path,
                                topics, device))
        log(f"phase 3 splade kernel vs plain: "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        built = build_phase(args.seed, s, path / "build", device, peaks)
        log(f"phase 3b build: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        served = serve(rng, s, path, topics, device)
        log(f"phase 4 serve: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        colbert, colbert_stages, colbert_counts = serve_colbert(
            sub_rng(args.seed, "colbert"), s, path, device)
        log(f"phase 4 colbert: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        door, door_launches = front_door(sub_rng(args.seed, "front door"),
                                         s, path, topics, device)
        log(f"phase 4c front door: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        piped = pipelined(sub_rng(args.seed, "pipelined"), s, path, topics,
                          device)
        log(f"phase 4d pipelined: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        times = time_kernels(rng, s, device, peaks, path, topics, args.seed)
        ctimes = time_colbert(sub_rng(args.seed, "colbert timing"), s,
                              device, peaks, path)
        log(f"phase 5 timing: {time.perf_counter() - t0:.1f} s")

    name, limit = (p.strip() for p in card.split(",", 1))
    per_batch = {b: lines[0]["launches_per_batch"]
                 for b, lines in served.items()}
    per_batch.update({b: line["launches_per_batch"]
                      for b, line in colbert.items()})
    for kname in SOURCES:
        for at in ("batch", "b1"):
            t = times[kname][at]
            bound_ms, bound_by = t["bound"]
            print(json.dumps({
                "kernel": kname, "at": at, "kernel_ms": t["ms"],
                "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": t["library_ms"],
                "turns_ms": t["turns"],
                **{n: t[n] for n in ("graph_ms", "library_graph_ms")
                   if n in t},
                "launches_per_batch": {b: n[kname]
                                       for b, n in per_batch.items()},
                "shapes": dataclasses.asdict(s) if at == "batch"
                else dict(dataclasses.asdict(s), B=1),
                "card": name, "power_limit": limit}), flush=True)
    kernels = kernel_entries(served, colbert, door_launches, times, ctimes,
                             err, s, piped, built["serve"]["launches"])
    print(json.dumps({"phase": "build", **built, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "stage1_breakdown", **times["stage1"],
                      "card": name, "power_limit": limit}), flush=True)
    for backend, lines in served.items():
        print(json.dumps({"phase": "serve", "splade_backend": backend,
                          "runs": lines, "card": name,
                          "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "serve_colbert", "runs": colbert,
                      "stages_vs_cpu": colbert_stages,
                      "candidates": colbert_counts, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "colbert_timing", **ctimes, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "front_door", **door, "card": name,
                      "power_limit": limit}), flush=True)
    print(json.dumps({"phase": "pipelined", "runs": piped, "card": name,
                      "power_limit": limit}), flush=True)
    log(f"chip_smoke wall, build included: "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
