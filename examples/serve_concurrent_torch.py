"""End-to-end serving driver on the PyTorch/CUDA port (the paper's
deployment scenario):

    PYTHONPATH=src python examples/serve_concurrent_torch.py [--tcp] \
        [--device cpu]

Brings up the concurrent retrieval server over a memory-mapped index,
drives it with Poisson traffic at several offered loads (batched
concurrent clients), and reports client-observed p50/p95/p99 — the
paper's Fig 1/2 methodology. --tcp also exercises the newline-JSON TCP
front with a real socket client. It runs on the card by default;
``--device cpu`` runs the plain PyTorch path.
"""

import argparse
import pathlib
import sys
import tempfile
import threading
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np

from repro_torch.common import resolve_device
from repro_torch.core.multistage import (SPLADE_BACKENDS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.data.synth import SynthCfg, make_corpus
from repro_torch.index.builder import ColBERTIndex, build_colbert_index
from repro_torch.index.splade_index import build_splade_index
from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.loadgen import run_open_loop, run_poisson_load
from repro_torch.serving.server import (RetrievalServer, TCPRetrievalServer,
                                        tcp_query)


def build_stack(splade_backend="host", splade_max_df=None,
                rerank_backend="fused", device="cuda"):
    dev = resolve_device(device)
    cfg = SynthCfg(n_docs=2500, n_queries=200, seed=3)
    corpus = make_corpus(cfg)
    d = tempfile.mkdtemp(prefix="serve_")
    build_colbert_index(d, corpus["doc_embs"], corpus["doc_lens"],
                        nbits=4, n_centroids=256, kmeans_iters=4, device=dev)
    index = ColBERTIndex(d, mode="mmap")
    sidx = build_splade_index(corpus["doc_term_ids"],
                              corpus["doc_term_weights"], cfg.vocab,
                              cfg.n_docs)
    searcher = PLAIDSearcher(index, PlaidParams(nprobe=4,
                                                candidate_cap=1024,
                                                ndocs=256), device=dev)
    retr = MultiStageRetriever(
        sidx, searcher,
        MultiStageParams(first_k=200, alpha=0.3,
                         splade_backend=splade_backend,
                         splade_max_df=splade_max_df,
                         rerank_backend=rerank_backend), device=dev)
    return corpus, retr


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tcp", action="store_true")
    ap.add_argument("--method", default="hybrid")
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--threads", type=int, default=1)
    ap.add_argument("--max-batch", type=int, default=1,
                    help="micro-batch size (1 = request-at-a-time)")
    ap.add_argument("--batch-timeout-ms", type=float, default=2.0,
                    help="max wait to coalesce a micro-batch")
    ap.add_argument("--latency-slo-ms", type=float, default=None,
                    help="adaptive micro-batching: shrink/grow the "
                         "effective batch cap to keep batch service "
                         "time (EWMA) under this SLO")
    ap.add_argument("--splade-backend", default="host",
                    choices=list(SPLADE_BACKENDS),
                    help="stage-1 scorer backend")
    ap.add_argument("--splade-max-df", type=int, default=None,
                    help="padded-postings df cap for the device stage 1 "
                         "(memory vs exactness; default: exact)")
    ap.add_argument("--rerank-backend", default="fused",
                    choices=["fused", "split"],
                    help="stage-4 tail: fused single-launch "
                         "decompress+MaxSim+top-k vs the split tail "
                         "(bitwise-identical results)")
    ap.add_argument("--pipeline-depth", type=int, default=1,
                    help="stage-graph pipelining: 1 = synchronous, "
                         ">=2 overlaps mmap gathers with device "
                         "scoring across micro-batches")
    ap.add_argument("--arrival-rate", type=float, default=None,
                    help="drive with strictly open-loop Poisson "
                         "arrivals at this QPS instead of the "
                         "capacity-relative sweep")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    print("building index + retriever ...")
    corpus, retr = build_stack(splade_backend=args.splade_backend,
                               splade_max_df=args.splade_max_df,
                               rerank_backend=args.rerank_backend,
                               device=args.device)
    server = RetrievalServer(
        ServeEngine(retr, pipeline_depth=args.pipeline_depth),
        n_threads=args.threads, max_batch=args.max_batch,
        batch_timeout_ms=args.batch_timeout_ms,
        latency_slo_ms=args.latency_slo_ms)
    server.start()

    def reqs(n):
        return [Request(qid=i, method=args.method,
                        q_emb=corpus["q_embs"][i % 200],
                        term_ids=corpus["q_term_ids"][i % 200],
                        term_weights=corpus["q_term_weights"][i % 200],
                        k=20) for i in range(n)]

    # warm up + measure capacity
    for r in reqs(8):
        server.submit(r).result(timeout=120)
    if args.max_batch > 1:
        # warm the coalesced batch shapes, then measure capacity as burst
        # throughput — a lone probe request would pay the full
        # batch_timeout_ms coalescing window and understate capacity
        for f in [server.submit(r) for r in reqs(2 * args.max_batch)]:
            f.result(timeout=120)
        n_cap = 4 * args.max_batch
        t0 = time.perf_counter()
        for f in [server.submit(r) for r in reqs(n_cap)]:
            f.result(timeout=120)
        cap = n_cap / (time.perf_counter() - t0)
        svc = 1.0 / cap
    else:
        svc = np.mean([server.submit(r).result(timeout=120).service_time
                       for r in reqs(8)])
        cap = 1.0 / svc
    print(f"service time {svc * 1e3:.1f} ms → capacity ≈ {cap:.1f} QPS "
          f"({args.threads} thread(s), max_batch={args.max_batch})\n")
    print(f"{'offered':>10s} {'p50':>9s} {'p95':>9s} {'p99':>9s} "
          f"{'achieved':>9s}")
    if args.arrival_rate is not None:
        # strictly open-loop at exactly the requested rate (no sweep):
        # what you ask for is what gets offered
        rates = [args.arrival_rate]
    else:
        rates = [cap * frac for frac in (0.3, 0.6, 0.9, 1.5)]
    for rate in rates:
        if args.arrival_rate is not None:
            res = run_open_loop(server, reqs(args.n), arrival_rate=rate,
                                seed=0)
        else:
            res = run_poisson_load(server, reqs(args.n), qps=rate,
                                   seed=0, burst=args.max_batch)
        s = res.summary()
        print(f"{s['offered_qps']:8.1f}/s {s['p50'] * 1e3:7.1f}ms "
              f"{s['p95'] * 1e3:7.1f}ms {s['p99'] * 1e3:7.1f}ms "
              f"{s['achieved_qps']:7.1f}/s")
    print("\nhealth:", server.health())

    if args.tcp:
        tcp = TCPRetrievalServer(("127.0.0.1", 0), server)
        port = tcp.server_address[1]
        serving = threading.Thread(target=tcp.serve_forever,
                                   name="tcp-serve", daemon=True)
        serving.start()
        print(f"\nTCP front on :{port}; sending one JSON query ...")
        out = tcp_query("127.0.0.1", port, {
            "qid": 0, "method": args.method,
            "q_emb": corpus["q_embs"][0].tolist(),
            "term_ids": corpus["q_term_ids"][0].tolist(),
            "term_weights": corpus["q_term_weights"][0].tolist(), "k": 5})
        print("response:", {k: out[k] for k in ("qid", "pids", "latency")})
        tcp.stop_accepting()
        serving.join(timeout=60)

    server.drain()
    server.stop()
    print("drained + stopped cleanly.")


if __name__ == "__main__":
    main()
