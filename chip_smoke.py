#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Phases, in order; any failure raises and the script exits non-zero:

1. build   — print the card (``nvidia-smi``) and build the CUDA kernels
             from ``src/repro_torch/kernels/csrc`` with nvcc;
2. kernels — hold both kernels, and their B=1 launches, against their
             plain PyTorch versions on the card at full width (B=32,
             Lq=32, C=200, Ld=180, d=128, K=131072; nbits 4 and 2;
             ragged valid and cmask, k > C, empty C); fused must equal
             split bit for bit;
3. index   — write a synthetic index at full width (d=128, nbits=4,
             doc_maxlen=180, K=131072, SPLADE vocab 30522) with
             ``write_index`` and ``SpladeIndex.save``, 100,000 docs;
4. serve   — serve 64 mixed splade/rerank/hybrid requests through
             ``RetrievalServer`` on ``cuda`` with max_batch=32, hold every
             answer against an engine built with ``device="cpu"`` over the
             same directory, and check that both kernels were launched;
5. time    — time each kernel with CUDA events at the serve shapes.

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

        # B=1 launches (the single-query entry points) equal their batch
        # row bit for bit
        one = decompress_maxsim_scores(*(t[3] for t in tile), *tables,
                                       nbits=nbits, q_valid=x["q_valid"][3])
        assert torch.equal(one, got[3]), "B=1 decompress_maxsim != batch row"
        kk = min(100, s.C)
        v1, i1 = fused_rerank_topk(*(t[3] for t in tile), x["cmask"][3],
                                   *tables, nbits=nbits, k=kk,
                                   q_valid=x["q_valid"][3])
        sv, si = stable_topk(got[3].masked_fill(~x["cmask"][3],
                                                float("-inf")), kk)
        assert torch.equal(i1.long(), si) and torch.equal(v1, sv), \
            "B=1 fused_rerank != split row"

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


# ---------------------------------------------------------------------------
# phase 4: serve
# ---------------------------------------------------------------------------

def make_retriever(path: pathlib.Path, device):
    from repro_torch.core.multistage import (MultiStageParams,
                                             MultiStageRetriever)
    from repro_torch.core.plaid import PLAIDSearcher
    from repro_torch.index.builder import ColBERTIndex
    from repro_torch.index.splade_index import SpladeIndex
    return MultiStageRetriever(
        SpladeIndex.load(path / "splade", mmap=True),
        PLAIDSearcher(ColBERTIndex(path / "colbert", mode="mmap"),
                      device=device),
        MultiStageParams(first_k=FULL.C, k=100), device=device)


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


def serve(rng, s: Shapes, path: pathlib.Path, topics: np.ndarray,
          device) -> dict:
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.serving.engine import ServeEngine
    from repro_torch.serving.server import RetrievalServer
    from repro_torch.testing import REF_MARGIN, assert_topk_match

    engine = ServeEngine(make_retriever(path, device))
    engine.process_batch(make_requests(rng, s, topics, 6, qid0=10_000))
    reqs = make_requests(rng, s, topics, s.n_requests)
    server = RetrievalServer(engine, max_batch=s.B, batch_timeout_ms=5.0)
    server.start()
    try:
        engine.retriever.reset_stage_stats()
        dms.launches = frk.launches = 0
        t0 = time.perf_counter()
        futs = [server.submit(r) for r in reqs]
        results = [f.result(timeout=600) for f in futs]
        wall = time.perf_counter() - t0
        launches = {"decompress_maxsim": dms.launches,
                    "fused_rerank": frk.launches}
        health = server.health()
    finally:
        server.stop()
    log(f"served {len(results)} requests in {wall:.3f} s, "
        f"{health['batches']} batches; launches {launches}")
    if health["failed"] or health["served"] != len(reqs) + 6:
        raise RuntimeError(f"server health: {health}")
    for name, n in launches.items():
        if n == 0:
            raise RuntimeError(f"kernel {name} was never launched while "
                               "serving")

    # the reference answers REF_MARGIN places deeper, so that ties at
    # each answer's last place are visible
    ref_engine = ServeEngine(make_retriever(path, "cpu"))
    deeper = [dataclasses.replace(r, k=r.k + REF_MARGIN) for r in reqs]
    want = []
    for lo in range(0, len(deeper), s.B):
        want += ref_engine.process_batch(deeper[lo:lo + s.B])
    for res, ref, req in zip(results, want, reqs):
        assert res.qid == ref.qid == req.qid
        assert_topk_match(ref.scores, ref.pids, res.scores, res.pids,
                          what=f"qid {req.qid} {req.method} k={req.k}")
    log("every served answer matches the CPU engine")

    lat = np.array([r.latency for r in results]) * 1e3
    per_batch = {n: c / health["batches"] for n, c in launches.items()}
    return {"launches": launches, "launches_per_batch": per_batch,
            "serve": {"phase": "serve", "requests": len(results),
                      "batches": health["batches"],
                      "qps": len(results) / wall,
                      "p50_ms": float(np.percentile(lat, 50)),
                      "p99_ms": float(np.percentile(lat, 99)),
                      "stage_wall_s": {n: r["wall_s"] for n, r in
                                       health["stages"].items()}}}


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


def time_kernels(rng, s: Shapes, device, peaks) -> dict:
    import torch
    from repro_torch.kernels.decompress_maxsim.ops import (
        decompress_maxsim_scores_batch as dms)
    from repro_torch.kernels.decompress_maxsim.ref import (
        decompress_maxsim_ref)
    from repro_torch.kernels.fused_rerank.ops import (
        fused_rerank_topk_batch as frk)
    from repro_torch.kernels.fused_rerank.ref import fused_rerank_ref

    x = to_dev(kernel_inputs(rng, s, 4), device)
    tile = (x["q"], x["packed"], x["cids"], x["valid"])
    tables = (x["centroids"], x["bw"])
    qv, cm = x["q_valid"], x["cmask"]
    out = {
        "decompress_maxsim": {
            "ms": cuda_time_ms(lambda: dms(*tile, *tables, nbits=4,
                                           q_valid=qv), 20),
            "plain_ms": cuda_time_ms(lambda: decompress_maxsim_ref(
                *tile, *tables, 4, qv), 5, warmup=1),
            "bound": bound(x, s, peaks, fused=False)},
        "fused_rerank": {
            "ms": cuda_time_ms(lambda: frk(*tile, cm, *tables, nbits=4,
                                           k=100, q_valid=qv), 20),
            "plain_ms": cuda_time_ms(lambda: fused_rerank_ref(
                *tile, cm, *tables, 4, 100, qv), 5, warmup=1),
            "bound": bound(x, s, peaks, fused=True)},
    }
    return out


# ---------------------------------------------------------------------------

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

    t0 = time.perf_counter()
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
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        path = pathlib.Path(tmp)
        t0 = time.perf_counter()
        n_tokens, topics = write_synthetic_index(rng, s, path)
        log(f"phase 3 index: {s.n_docs} docs, {n_tokens} tokens, "
            f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        served = serve(rng, s, path, topics, device)
        log(f"phase 4 serve: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    times = time_kernels(rng, s, device, peaks)
    log(f"phase 5 timing: {time.perf_counter() - t0:.1f} s")

    name, limit = (p.strip() for p in card.split(",", 1))
    sources = {
        "decompress_maxsim": (
            "src/repro_torch/kernels/csrc/decompress_maxsim.cu",
            "src/repro/kernels/decompress_maxsim/decompress_maxsim.py:132"),
        "fused_rerank": (
            "src/repro_torch/kernels/csrc/fused_rerank.cu",
            "src/repro/kernels/fused_rerank/fused_rerank.py:144"),
    }
    kernels = []
    for kname, (src, replaces) in sources.items():
        t = times[kname]
        bound_ms, bound_by = t["bound"]
        kernels.append({
            "name": kname, "route": "cuda", "source": src,
            "replaces": replaces, "launches": served["launches"][kname],
            "max_abs_err": err[kname], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None})
        print(json.dumps({
            "kernel": kname, "kernel_ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "launches_per_batch": served["launches_per_batch"][kname],
            "shapes": dataclasses.asdict(s), "card": name,
            "power_limit": limit}), flush=True)
    print(json.dumps(dict(served["serve"], card=name, power_limit=limit)),
          flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
