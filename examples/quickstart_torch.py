"""Quickstart on the PyTorch/CUDA port: build a ColBERT-serve stack end
to end on synthetic data.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

Steps: synthetic corpus → ColBERT index (k-means, 4-bit residuals and
the encode on the device, IVF, memory-mapped) → SPLADE impact index →
the four systems from the paper (ColBERTv2 / SPLADEv2 / Rerank / Hybrid)
through the port's ``MultiStageRetriever`` → quality + access stats.
It runs on the card by default; ``--device cpu`` runs the plain PyTorch
path.
"""

import argparse
import pathlib
import sys
import tempfile

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np

from repro_torch.common import resolve_device
from repro_torch.core.multistage import MultiStageParams, MultiStageRetriever
from repro_torch.core.plaid import PLAIDSearcher, PlaidParams
from repro_torch.data.synth import SynthCfg, make_corpus
from repro_torch.eval import metrics
from repro_torch.index.builder import ColBERTIndex, build_colbert_index
from repro_torch.index.splade_index import build_splade_index

BATCH = 32      # queries per search_batch call


def run(cfg: SynthCfg, device) -> dict:
    """Build the stack for ``cfg`` on ``device`` in a temporary directory
    and report each method's quality and the pool's page accounting.
    → {method: {"MRR@10", "R@5", "R@50", "S@5"}}."""
    dev = resolve_device(device)
    print("1) synthesising corpus (complementary lexical+semantic views)")
    corpus = make_corpus(cfg)

    with tempfile.TemporaryDirectory(prefix="quickstart_torch_") as d:
        print(f"2) building the compressed ColBERT index on {dev} "
              "(mmap'd pool)")
        build_colbert_index(d, corpus["doc_embs"], corpus["doc_lens"],
                            nbits=4, n_centroids=256, kmeans_iters=6,
                            device=dev)
        index = ColBERTIndex(d, mode="mmap")
        print(f"   pool: {index.store.total_bytes() / 1e6:.1f} MB on disk, "
              f"{index.n_centroids} centroids, {index.store.n_tokens} "
              "tokens")

        print("3) building the SPLADE impact index (PISA adaptation)")
        sidx = build_splade_index(corpus["doc_term_ids"],
                                  corpus["doc_term_weights"], cfg.vocab,
                                  cfg.n_docs)
        searcher = PLAIDSearcher(index, PlaidParams(nprobe=4,
                                                    candidate_cap=1024,
                                                    ndocs=256, k=100),
                                 device=dev)
        retr = MultiStageRetriever(sidx, searcher,
                                   MultiStageParams(first_k=200, alpha=0.3),
                                   device=dev)

        print("4) running the paper's four systems\n")
        print(f"{'method':8s}  MRR@10   R@5    R@50   S@5")
        index.store.stats.reset()
        q = corpus["qrels"]
        out = {}
        for method in ("colbert", "splade", "rerank", "hybrid"):
            ranked = []
            for lo in range(0, cfg.n_queries, BATCH):
                hi = min(lo + BATCH, cfg.n_queries)
                pids, _ = retr.search_batch(
                    method, q_embs=list(corpus["q_embs"][lo:hi]),
                    term_ids=list(corpus["q_term_ids"][lo:hi]),
                    term_weights=list(corpus["q_term_weights"][lo:hi]))
                ranked.append(pids)
            r = np.concatenate(ranked)
            out[method] = {"MRR@10": metrics.mrr_at_k(r, q, 10),
                           "R@5": metrics.recall_at_k(r, q, 5),
                           "R@50": metrics.recall_at_k(r, q, 50),
                           "S@5": metrics.success_at_k(r, q, 5)}
            m = out[method]
            print(f"{method:8s}  {m['MRR@10']:.4f}  {m['R@5']:.4f} "
                  f"{m['R@50']:.4f} {m['S@5']:.4f}")

        st = index.store.stats
        print(f"\nmmap pool access: {st.tokens_read} token rows, "
              f"{len(st.unique_pages or ())} unique 4KiB pages "
              f"({100 * index.store.resident_fraction_estimate():.0f}% of "
              "pool)")
    print("done.")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    run(SynthCfg(n_docs=2000, n_queries=150, seed=0), args.device)


if __name__ == "__main__":
    main()
