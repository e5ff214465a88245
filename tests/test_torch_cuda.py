"""The port's CUDA kernels and serving path on the card.

Every test here needs an NVIDIA GPU and nvcc; without one it skips. The
file imports neither jax nor the JAX package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The kernels are held to their plain PyTorch versions (scores
``allclose(rtol=1e-5, atol=1e-5)``: the kernel sums each dot product in
a fixed sequential order, the plain version through cuBLAS; ids equal up
to tie groups), and the fused tail to the split tail bit for bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.multistage import (METHODS, MultiStageParams,
                                         MultiStageRetriever)
from repro_torch.core.plaid import PLAIDSearcher
from repro_torch.index.builder import ColBERTIndex, write_index
from repro_torch.index.splade_index import SpladeIndex, build_splade_index
from repro_torch.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores_batch)
from repro_torch.kernels.fused_rerank.ops import fused_rerank_topk_batch
from repro_torch.kernels.fused_rerank.ref import stable_topk
from repro_torch.testing import REF_MARGIN, assert_topk_match

TOL = dict(rtol=1e-5, atol=1e-5)

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
])
def test_kernels_match_plain(cuda, nbits, B, C, Ld, k, K, d, Lq):
    case = _case(nbits + C, B, C, Ld, nbits, K, d, Lq)
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
    kk = min(k, C)
    sv, si = stable_topk(got.masked_fill(~dev[4], float("-inf")), kk)
    np.testing.assert_array_equal(idx[:, :kk].cpu().numpy(), si.cpu().numpy())
    np.testing.assert_array_equal(vals[:, :kk].cpu().numpy().view(np.uint32),
                                  sv.cpu().numpy().view(np.uint32))
    assert (decompress_maxsim_scores_batch.launches,
            fused_rerank_topk_batch.launches) == (launches[0] + 1,
                                                  launches[1] + 1)


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
        assert_topk_match(want[1], want[0], fused[1], fused[0], what=method)
        np.testing.assert_array_equal(fused[0], split[0])
        np.testing.assert_array_equal(fused[1].view(np.uint32),
                                      split[1].view(np.uint32))
