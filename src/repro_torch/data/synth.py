"""Synthetic retrieval corpora with planted relevance.

The paper's quality claims are *relationships* between systems
(Hybrid ≥ Rerank ≥ SPLADE; ColBERTv2 strong; α-sweep rises then falls).
To validate them without trained checkpoints we generate corpora from a
latent topic model in which the two retrievers see *complementary*
noisy views of relevance:

* **Semantic view (ColBERT)** — token embeddings cluster around a doc
  topic vector; query embeddings are noisy copies of the relevant doc's
  topic. MaxSim recovers relevance up to embedding noise.
* **Lexical view (SPLADE)** — docs draw terms from topic-specific
  Zipfian vocabularies; queries copy doc terms but with a synonym gap
  (some terms swapped within the topic's synonym groups) plus mild
  expansion. Impact scoring recovers relevance up to the lexical gap.

Because the noise sources are independent, interpolating the two scores
(the paper's Hybrid) beats either alone — the mechanism the paper
credits for Hybrid's wins, reproduced in a controlled setting.

Numpy only, and the port's own copy of the reference generator: the
same ``default_rng`` draws in the same order, so a config gives the
same arrays, bit for bit, in both packages.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SynthCfg:
    n_docs: int = 2000
    n_queries: int = 200
    vocab: int = 4096
    dim: int = 64
    n_topics: int = 64
    doc_maxlen: int = 32
    doc_minlen: int = 12
    query_maxlen: int = 8
    sparse_terms: int = 24        # nnz terms per doc sparse vector
    query_terms: int = 12         # nnz terms per query sparse vector
    doc_sig: float = 0.9          # doc-identity strength over its topic
    sem_noise: float = 1.5        # embedding-space query noise
    confuser: float = 0.45        # noise directed at a same-topic hard negative
    tok_noise: float = 0.45       # doc token scatter around doc identity
    lex_gap: float = 0.35         # synonym-substitution probability
    lex_drop: float = 0.20        # query terms replaced by random topic terms
    terms_per_topic: int = 96
    seed: int = 0


def _unit(x, axis=-1):
    n = np.linalg.norm(x, axis=axis, keepdims=True)
    return x / np.maximum(n, 1e-9)


def make_corpus(cfg: SynthCfg):
    rng = np.random.default_rng(cfg.seed)

    topics = _unit(rng.normal(size=(cfg.n_topics, cfg.dim)))
    # topic → term vocabulary (overlapping blocks + synonym pairing)
    topic_terms = np.stack([
        rng.choice(cfg.vocab, cfg.terms_per_topic, replace=False)
        for _ in range(cfg.n_topics)])
    # synonym of term t within a topic = the paired term one slot over
    syn_of = np.roll(topic_terms, 1, axis=1)

    # ---------------- documents ----------------
    doc_topic = rng.integers(0, cfg.n_topics, cfg.n_docs)
    doc_lens = rng.integers(cfg.doc_minlen, cfg.doc_maxlen + 1, cfg.n_docs)

    # each doc has a *doc-specific* identity vector near its topic — this
    # is what late interaction can resolve that lexical matching cannot.
    # Noise is added as unit directions so the mixing coefficients are
    # cosine-meaningful regardless of dim.
    doc_vec = _unit(topics[doc_topic] + cfg.doc_sig * _unit(
        rng.normal(size=(cfg.n_docs, cfg.dim))))
    tok = _unit(rng.normal(size=(cfg.n_docs, cfg.doc_maxlen, cfg.dim)))
    doc_embs = _unit(doc_vec[:, None, :] + cfg.tok_noise * tok)
    mask = np.arange(cfg.doc_maxlen)[None] < doc_lens[:, None]
    doc_embs = (doc_embs * mask[..., None]).astype(np.float32)

    # sparse vectors: Zipfian draw from the doc's topic terms
    ranks = np.arange(1, cfg.terms_per_topic + 1)
    zipf = (1.0 / ranks) / np.sum(1.0 / ranks)
    doc_term_ids = np.zeros((cfg.n_docs, cfg.sparse_terms), np.int32)
    doc_term_w = np.zeros((cfg.n_docs, cfg.sparse_terms), np.float32)
    for d in range(cfg.n_docs):
        slots = rng.choice(cfg.terms_per_topic, cfg.sparse_terms,
                           replace=False, p=zipf)
        doc_term_ids[d] = topic_terms[doc_topic[d], slots]
        doc_term_w[d] = 1.0 + rng.exponential(0.5, cfg.sparse_terms)

    # ---------------- queries ----------------
    q_rel = rng.integers(0, cfg.n_docs, cfg.n_queries)   # relevant doc/query
    # hard negatives: part of the query noise points at another doc of the
    # same topic, so semantic errors are *confusions*, not random misses
    topic_docs = {t: np.nonzero(doc_topic == t)[0] for t in range(cfg.n_topics)}
    conf = np.array([rng.choice(topic_docs[doc_topic[d]]) for d in q_rel])
    noise_dir = _unit((1 - cfg.confuser) * _unit(rng.normal(
        size=(cfg.n_queries, cfg.query_maxlen, cfg.dim)))
        + cfg.confuser * doc_vec[conf][:, None, :])
    q_embs = _unit(doc_vec[q_rel][:, None, :]            # doc-specific signal
                   + cfg.sem_noise * noise_dir).astype(np.float32)

    q_term_ids = np.zeros((cfg.n_queries, cfg.query_terms), np.int32)
    q_term_w = np.zeros((cfg.n_queries, cfg.query_terms), np.float32)
    for qi in range(cfg.n_queries):
        d = q_rel[qi]
        t = doc_topic[d]
        pick = rng.choice(cfg.sparse_terms, cfg.query_terms, replace=False)
        terms = doc_term_ids[d, pick].copy()
        w = doc_term_w[d, pick] * (0.5 + rng.random(cfg.query_terms))
        # lexical gap: swap to an in-topic synonym the doc may not contain
        swap = rng.random(cfg.query_terms) < cfg.lex_gap
        for j in np.nonzero(swap)[0]:
            slot = np.nonzero(topic_terms[t] == terms[j])[0]
            if len(slot):
                terms[j] = syn_of[t, slot[0]]
        # topical drift: some query terms are topic-typical, not doc-specific
        drop = rng.random(cfg.query_terms) < cfg.lex_drop
        for j in np.nonzero(drop)[0]:
            terms[j] = topic_terms[t, rng.integers(cfg.terms_per_topic)]
        q_term_ids[qi], q_term_w[qi] = terms, w

    qrels = [{int(p)} for p in q_rel]
    return {
        "doc_embs": doc_embs.astype(np.float32),
        "doc_lens": doc_lens.astype(np.int32),
        "doc_term_ids": doc_term_ids,
        "doc_term_weights": doc_term_w,
        "q_embs": q_embs,
        "q_term_ids": q_term_ids,
        "q_term_weights": q_term_w,
        "qrels": qrels,
        "cfg": cfg,
    }


def make_token_corpus(rng: np.random.Generator, n_docs: int, vocab: int,
                      doc_maxlen: int, doc_minlen: int = 8):
    """Plain integer token docs (for exercising the real encoders)."""
    lens = rng.integers(doc_minlen, doc_maxlen + 1, n_docs)
    toks = rng.integers(4, vocab, (n_docs, doc_maxlen)).astype(np.int32)
    toks *= (np.arange(doc_maxlen)[None] < lens[:, None])
    return toks, lens.astype(np.int32)
