"""Serving launcher: bring up the concurrent ColBERT-serve stack on one
device.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--method hybrid] [--threads 1] [--port 8080] [--qps 2.0] \
        [--device cuda]

Builds (or loads with --index-dir) a ColBERT + SPLADE index, starts the
worker pool and the TCP front, and either serves forever (--port) or
runs a bounded Poisson load and prints the latency report.

The flags, their defaults and the report lines are the JAX package's
``launch/serve.py``'s on its single-index path, with three differences:
``--splade-backend`` takes ``host`` or ``device`` (the SPLADE kernel
over padded postings, the reference's ``pallas``; its ``jax`` backend
has no counterpart), ``--device`` picks the card (default ``cuda``,
which raises without a GPU) or ``cpu``, and the shard and replica flags
(``--shards`` … ``--hedge-floor-ms``) are not taken. The ``fused`` tail
never falls back: a kernel that does not build or launch raises.
"""

from __future__ import annotations

import argparse
import pathlib
import tempfile

import numpy as np

from repro_torch.common import resolve_device
from repro_torch.core.multistage import (SPLADE_BACKENDS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.data.synth import SynthCfg, make_corpus
from repro_torch.index.builder import ColBERTIndex, build_colbert_index
from repro_torch.index.live import AutoCompactor
from repro_torch.index.splade_index import SpladeIndex, build_splade_index
from repro_torch.serving.admission import AdmissionController
from repro_torch.serving.context import CacheHierarchy
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loadgen import (
    load_trace,
    run_open_loop,
    run_poisson_load,
    zipf_trace,
)
from repro_torch.serving.server import RetrievalServer


def build_or_load(index_dir: str | None, mode: str,
                  splade_backend: str = "host",
                  splade_max_df: int | None = None,
                  rerank_backend: str = "fused", device="cuda"):
    """Build (or load) the serving index and its retriever on
    ``device``. An ``index_dir`` holding ``colbert/`` is loaded;
    otherwise the built-in synthetic corpus is built into it (into a new
    temporary directory when ``index_dir`` is None), the ColBERT index
    on ``device``. → (the corpus, or None when loaded; the ColBERT
    index; the retriever)."""
    dev = resolve_device(device)
    if index_dir and (pathlib.Path(index_dir) / "colbert").exists():
        base = pathlib.Path(index_dir)
        corpus = None
    else:
        cfg = SynthCfg(n_docs=3000, n_queries=300, seed=0)
        corpus = make_corpus(cfg)
        base = pathlib.Path(index_dir or tempfile.mkdtemp(prefix="serve_"))
        build_colbert_index(base / "colbert", corpus["doc_embs"],
                            corpus["doc_lens"], nbits=4,
                            n_centroids=256, kmeans_iters=4, device=dev)
        build_splade_index(corpus["doc_term_ids"],
                           corpus["doc_term_weights"], cfg.vocab,
                           cfg.n_docs).save(base / "splade")
    plaid_params = PlaidParams(nprobe=4, candidate_cap=1024, ndocs=256)
    ms_params = MultiStageParams(first_k=200, alpha=0.3,
                                 splade_backend=splade_backend,
                                 splade_max_df=splade_max_df,
                                 rerank_backend=rerank_backend)
    index = ColBERTIndex(base / "colbert", mode=mode)
    sidx = SpladeIndex.load(base / "splade", mmap=(mode == "mmap"))
    retr = MultiStageRetriever(
        sidx, PLAIDSearcher(index, plaid_params, device=dev), ms_params,
        device=dev)
    return corpus, index, retr


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--index-dir", default=None)
    ap.add_argument("--mode", default="mmap", choices=["mmap", "ram"])
    ap.add_argument("--method", default="hybrid")
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--splade-backend", default="host",
                    choices=list(SPLADE_BACKENDS),
                    help="stage-1 scorer: host CSR pass, or the SPLADE "
                         "kernel over padded postings on the device")
    ap.add_argument("--splade-max-df", type=int, default=None,
                    help="padded-postings df cap for the device stage 1 "
                         "(memory vs exactness; default: exact)")
    ap.add_argument("--rerank-backend", default="fused",
                    choices=["fused", "split"],
                    help="stage-4 tail: fused = decompress + MaxSim + "
                         "top-k in one kernel launch, split = "
                         "decompress + MaxSim on the device, top-k on "
                         "the host. Results are bitwise-identical")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--max-batch", type=int, default=1)
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0)
    ap.add_argument("--latency-slo-ms", type=float, default=None,
                    help="enable adaptive micro-batch sizing against "
                         "this service-time SLO")
    ap.add_argument("--pipeline", action="store_true",
                    help="stage-graph pipelining at the default depth "
                         "(2, double-buffered)")
    ap.add_argument("--pipeline-depth", type=int, default=None,
                    help="batches in flight: 1 = synchronous, "
                         ">=2 overlaps micro-batch N+1's mmap gather "
                         "with batch N's device work")
    ap.add_argument("--pipeline-workers", default="single",
                    choices=["single", "kind"],
                    help="executor scheduling: single-worker software "
                         "pipelining, or a host and a device worker "
                         "thread per executor")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="strictly open-loop Poisson arrivals at this "
                         "QPS (instead of the default generator)")
    ap.add_argument("--cache-exact", type=int, default=0,
                    help="exact result cache entries (0 = off): a hit "
                         "returns the bitwise cold answer straight "
                         "from the front door")
    ap.add_argument("--cache-stage1", type=int, default=0,
                    help="stage-1/candidate cache entries (0 = off): "
                         "cached SPLADE rows / PLAID survivors skip the "
                         "stage-1 work on repeat queries")
    ap.add_argument("--admission-slo-ms", type=float, default=None,
                    help="SLO-aware admission: when per-stage EWMAs "
                         "predict a request blows this budget, degrade "
                         "it to the splade-only plan or shed it")
    ap.add_argument("--shed-factor", type=float, default=3.0,
                    help="shed when even the degraded plan is "
                         "predicted past factor×SLO")
    ap.add_argument("--skew", type=float, default=0.0,
                    help="Zipf skew of the bounded load's query "
                         "sampling (0 = round-robin; >0 draws queries "
                         "with popularity ∝ 1/rank^skew)")
    ap.add_argument("--replay", default=None,
                    help="replay a query-index trace file (one index "
                         "per line) instead of sampling")
    ap.add_argument("--live", action="store_true",
                    help="enable the mutable index: upsert/delete/"
                         "compact ops on the TCP front (new docs land "
                         "in an in-RAM delta segment, deletes are "
                         "tombstones filtered at the merges; needs "
                         "--mode mmap)")
    ap.add_argument("--live-compact-every", type=int, default=None,
                    help="background compaction threshold: merge the "
                         "delta segment into a new index generation "
                         "whenever it reaches this many docs (implies "
                         "--live)")
    ap.add_argument("--port", type=int, default=None,
                    help="serve forever on this TCP port (0 binds an "
                         "ephemeral port and prints the real one); "
                         "omit to run the bounded load test instead")
    ap.add_argument("--qps", type=float, default=2.0)
    ap.add_argument("--n", type=int, default=60)
    return ap


def bounded_trace(args, n_unique: int) -> np.ndarray:
    """The bounded load's query indices: the ``--replay`` file (wrapped
    into the corpus's queries, cut or repeated to ``--n``), a Zipf draw
    (``--skew``), or round-robin."""
    if args.replay is not None:
        trace = load_trace(args.replay) % n_unique
        return (trace[:args.n] if len(trace) >= args.n
                else np.resize(trace, args.n))
    if args.skew > 0:
        return zipf_trace(args.n, n_unique, skew=args.skew, seed=0)
    return np.arange(args.n) % n_unique


def report(res, caches, admission, server, index) -> None:
    """The bounded load's report lines, the JAX launcher's. The pipeline
    line is printed where the engine runs the pipeline (a live index
    stays synchronous at any depth, where the JAX launcher fails on the
    missing queues)."""
    s = res.summary()
    print(f"offered {s['offered_qps']:.2f} QPS → achieved "
          f"{s['achieved_qps']:.2f}; p50 {s['p50'] * 1e3:.1f} ms, "
          f"p95 {s['p95'] * 1e3:.1f} ms, p99 {s['p99'] * 1e3:.1f} ms")
    print(f"trace: {s['unique_queries']} unique / "
          f"{s['repeat_queries']} repeats; outcomes: "
          f"{s['cache_hits']} cache hits, {s['degraded']} degraded, "
          f"{s['shed']} shed, {s['failed']} failed")
    if caches is not None:
        cs = caches.stats()
        print(f"caches: exact {cs['exact']['hits']}h/"
              f"{cs['exact']['misses']}m "
              f"(size {cs['exact']['size']}/"
              f"{cs['exact']['capacity']}), stage1 "
              f"{cs['stage1']['hits']}h/{cs['stage1']['misses']}m "
              f"(size {cs['stage1']['size']}/"
              f"{cs['stage1']['capacity']})")
    if admission is not None:
        ast = admission.stats()
        print(f"admission: {ast['full_admits']} full, "
              f"{ast['degraded_admits']} degraded, "
              f"{ast['sheds']} shed "
              f"(SLO {ast['latency_slo_ms']:.0f} ms)")
    if server.engine.pipelined:
        h = server.health()
        print(f"pipeline overlap: "
              f"{100 * h.get('overlap_fraction', 0.0):.1f}% "
              f"(stage queues: {h['pipeline']['queues']})")
    # in-process serving: the gathers hit this process's store
    print(f"mmap working set: "
          f"{100 * index.store.resident_fraction_estimate():.1f}% of pool")


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)    # no GPU: raise before any work

    depth = (args.pipeline_depth if args.pipeline_depth is not None
             else (2 if args.pipeline else 1))
    corpus, index, retr = build_or_load(
        args.index_dir, args.mode, args.splade_backend,
        args.splade_max_df, rerank_backend=args.rerank_backend,
        device=device)
    compactor = None
    if args.live or args.live_compact_every is not None:
        retr.enable_live()
        if args.live_compact_every is not None:
            compactor = AutoCompactor(retr, args.live_compact_every)
            compactor.start()
    caches = None
    if args.cache_exact > 0 or args.cache_stage1 > 0:
        caches = CacheHierarchy(exact_entries=args.cache_exact,
                                stage1_entries=args.cache_stage1)
    admission = None
    if args.admission_slo_ms is not None:
        admission = AdmissionController(args.admission_slo_ms,
                                        shed_factor=args.shed_factor)
    engine = ServeEngine(retr, pipeline_depth=depth,
                         pipeline_workers=args.pipeline_workers,
                         caches=caches)
    server = RetrievalServer(
        engine, n_threads=args.threads, max_batch=args.max_batch,
        batch_timeout_ms=args.batch_timeout_ms,
        latency_slo_ms=args.latency_slo_ms, admission=admission)
    server.start()
    print(f"serving ({args.mode} index, {args.threads} thread(s), "
          f"stage1={args.splade_backend}, rerank={retr.rerank_backend}, "
          f"pipeline_depth={depth}, shards=1 [thread workers]); "
          f"pool={index.store.total_bytes() / 1e6:.1f} MB", flush=True)

    try:
        if args.port is not None:
            tcp = server.serve_tcp("0.0.0.0", args.port)
            server.install_sigterm_handler()   # graceful drain on TERM
            print(f"TCP front on :{server.tcp_port} (newline-delimited "
                  f"JSON; SIGTERM or Ctrl-C to stop)", flush=True)
            try:
                tcp.serve_forever()
            except KeyboardInterrupt:
                pass
            finally:
                server.shutdown_gracefully()
            return

        if corpus is None:
            raise SystemExit("the bounded load test needs the built-in "
                             "corpus: give --port, or an --index-dir "
                             "without colbert/")
        trace = bounded_trace(args, len(corpus["q_embs"]))
        reqs = [Request(qid=i, method=args.method,
                        q_emb=corpus["q_embs"][q],
                        term_ids=corpus["q_term_ids"][q],
                        term_weights=corpus["q_term_weights"][q],
                        k=20, trace_id=int(q))
                for i, q in enumerate(trace)]
        if args.arrival_rate is not None:
            res = run_open_loop(server, reqs,
                                arrival_rate=args.arrival_rate, seed=0)
        else:
            res = run_poisson_load(server, reqs, qps=args.qps, seed=0,
                                   burst=args.max_batch)
        report(res, caches, admission, server, index)
        server.drain()
        server.stop()
    finally:
        if compactor is not None:
            compactor.stop()
        engine.close()


if __name__ == "__main__":
    main()
