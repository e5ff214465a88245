"""The port's kernel wrappers against the JAX package's kernels.

On the CPU a wrapper runs its plain PyTorch version; these tests hold
that version to the JAX reference (``impl="ref"``) and to the Pallas
kernel body run in interpret mode, on the same numpy inputs. The
CUDA kernels are held to the plain versions on the card by
``tests/test_torch_cuda.py``.

Tolerance: scores ``allclose(rtol=1e-5, atol=1e-5)`` — the two packages
sum the d-term dot products and the query-token sums in different
orders; candidate ids must match except inside tie groups, judged on a
reference ``REF_MARGIN`` places deeper than the answer (see
``repro_torch.testing``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores as j_dms,
    decompress_maxsim_scores_batch as j_dms_batch,
)
from repro.kernels.fused_rerank.ops import (
    fused_rerank_topk as j_fr,
    fused_rerank_topk_batch as j_fr_batch,
)
from repro_torch.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores,
    decompress_maxsim_scores_batch,
)
from repro_torch.kernels.fused_rerank.ops import (
    fused_rerank_topk,
    fused_rerank_topk_batch,
)
from repro_torch.kernels.fused_rerank.ref import stable_topk
from repro_torch.testing import REF_MARGIN, assert_topk_match

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, B, C, Ld, nbits, K=32, d=64, Lq=8, mask_p=0.85):
    """Random compressed candidate set with a leading batch axis, drawn
    with numpy: (q, packed, cids, valid, cmask, centroids, bw, q_valid)."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Lq, d)).astype(np.float32),
            rng.integers(0, 256, (B, C, Ld, d * nbits // 8), dtype=np.uint8),
            rng.integers(0, K, (B, C, Ld), dtype=np.int32),
            rng.random((B, C, Ld)) < 0.8,
            rng.random((B, C)) < mask_p,
            rng.normal(size=(K, d)).astype(np.float32),
            np.linspace(-0.3, 0.3, 2 ** nbits, dtype=np.float32),
            rng.random((B, Lq)) < 0.9)


def _torch(case):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in case)


def _jax(case):
    return tuple(jnp.asarray(a) for a in case)


@pytest.mark.parametrize("nbits,B,C,Ld", [(4, 3, 32, 12), (2, 2, 24, 5),
                                          (4, 1, 9, 1)])
def test_decompress_maxsim_batch_matches_jax(nbits, B, C, Ld):
    case = _case(nbits * 31 + C, B, C, Ld, nbits)
    q, packed, cids, valid, _, cent, bw, qv = _torch(case)
    got = decompress_maxsim_scores_batch(q, packed, cids, valid, cent, bw,
                                         nbits=nbits, q_valid=qv).numpy()
    jq, jp, jc, jv, _, jcent, jbw, jqv = _jax(case)
    for impl in ("ref", "interpret"):
        want = np.asarray(j_dms_batch(jq, jp, jc, jv, jcent, jbw,
                                      nbits=nbits, q_valid=jqv, impl=impl,
                                      block_c=8))
        np.testing.assert_allclose(got, want, err_msg=impl, **TOL)


@pytest.mark.parametrize("nbits", [2, 4])
def test_decompress_maxsim_single_matches_jax(nbits):
    case = _case(7 + nbits, 1, 16, 6, nbits)
    q, packed, cids, valid, _, cent, bw, qv = _torch(case)
    got = decompress_maxsim_scores(q[0], packed[0], cids[0], valid[0], cent,
                                   bw, nbits=nbits, q_valid=qv[0]).numpy()
    jq, jp, jc, jv, _, jcent, jbw, jqv = _jax(case)
    for impl in ("ref", "interpret"):
        want = np.asarray(j_dms(jq[0], jp[0], jc[0], jv[0], jcent, jbw,
                                nbits=nbits, q_valid=jqv[0], impl=impl,
                                block_c=8))
        np.testing.assert_allclose(got, want, err_msg=impl, **TOL)


@pytest.mark.parametrize("nbits,B,C,Ld,k", [
    (4, 3, 32, 10, 12),
    (2, 1, 24, 4, 24),      # k == C
    (4, 4, 20, 8, 64),      # k > C: (-inf, -1) tail
    (2, 2, 8, 5, 1),        # k == 1
])
def test_fused_rerank_batch_matches_jax(nbits, B, C, Ld, k):
    case = _case(nbits * 7 + B + C, B, C, Ld, nbits)
    q, packed, cids, valid, cmask, cent, bw, qv = _torch(case)
    vals, idx = fused_rerank_topk_batch(q, packed, cids, valid, cmask, cent,
                                        bw, nbits=nbits, k=k, q_valid=qv)
    assert vals.shape == (B, k) and idx.dtype == torch.int32
    jq, jp, jc, jv, jm, jcent, jbw, jqv = _jax(case)
    for impl in ("ref", "interpret"):
        wv, wi = j_fr_batch(jq, jp, jc, jv, jm, jcent, jbw, nbits=nbits,
                            k=k + REF_MARGIN, q_valid=jqv, impl=impl,
                            block_c=8)
        assert_topk_match(np.asarray(wv), np.asarray(wi), vals.numpy(),
                          idx.numpy(), what=impl)


@pytest.mark.parametrize("nbits,C,k", [(4, 33, 10), (2, 16, 40)])
def test_fused_rerank_single_matches_jax(nbits, C, k):
    case = _case(nbits + C, 1, C, 6, nbits)
    q, packed, cids, valid, cmask, cent, bw, qv = _torch(case)
    vals, idx = fused_rerank_topk(q[0], packed[0], cids[0], valid[0],
                                  cmask[0], cent, bw, nbits=nbits, k=k,
                                  q_valid=qv[0])
    jq, jp, jc, jv, jm, jcent, jbw, jqv = _jax(case)
    for impl in ("ref", "interpret"):
        wv, wi = j_fr(jq[0], jp[0], jc[0], jv[0], jm[0], jcent, jbw,
                      nbits=nbits, k=k + REF_MARGIN, q_valid=jqv[0],
                      impl=impl, block_c=8)
        assert_topk_match(np.asarray(wv), np.asarray(wi), vals.numpy(),
                          idx.numpy(), what=impl)


def test_fused_rerank_ties_break_toward_lower_index():
    """Identical candidates score identically; selection orders them by
    ascending candidate index, as the JAX reference does."""
    nbits, C, k = 4, 16, 8
    case = list(_case(5, 1, C, 6, nbits, mask_p=1.0))
    for i in (1, 2, 3):             # every candidate a copy of the first
        case[i] = np.ascontiguousarray(
            np.broadcast_to(case[i][:, :1], case[i].shape))
    q, packed, cids, valid, cmask, cent, bw, qv = _torch(case)
    _, idx = fused_rerank_topk_batch(q, packed, cids, valid, cmask, cent,
                                     bw, nbits=nbits, k=k, q_valid=qv)
    np.testing.assert_array_equal(idx.numpy()[0], np.arange(k))
    jq, jp, jc, jv, jm, jcent, jbw, jqv = _jax(case)
    _, wi = j_fr_batch(jq, jp, jc, jv, jm, jcent, jbw, nbits=nbits, k=k,
                       q_valid=jqv, impl="ref")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(wi))


def test_fused_rerank_all_masked_and_empty():
    nbits, k = 2, 6
    q, packed, cids, valid, cmask, cent, bw, qv = _torch(
        _case(11, 2, 16, 4, nbits))
    vals, idx = fused_rerank_topk_batch(q, packed, cids, valid,
                                        torch.zeros_like(cmask), cent, bw,
                                        nbits=nbits, k=k, q_valid=qv)
    assert torch.all(vals == float("-inf"))
    np.testing.assert_array_equal(idx.numpy(), np.tile(np.arange(k), (2, 1)))
    vals, idx = fused_rerank_topk_batch(q, packed[:, :0], cids[:, :0],
                                        valid[:, :0], cmask[:, :0], cent, bw,
                                        nbits=nbits, k=k, q_valid=qv)
    assert vals.shape == (2, k) and torch.all(vals == float("-inf"))
    assert torch.all(idx == -1)
    scores = decompress_maxsim_scores_batch(
        q, packed[:, :0], cids[:, :0], valid[:, :0], cent, bw, nbits=nbits,
        q_valid=qv)
    assert scores.shape == (2, 0)


def test_fused_equals_split_bitwise():
    """Within the port the fused tail is the split tail: scores, -inf at
    masked candidates, stable descending selection — bit for bit."""
    nbits, k = 4, 12
    q, packed, cids, valid, cmask, cent, bw, qv = _torch(
        _case(17, 4, 32, 8, nbits))
    scores = decompress_maxsim_scores_batch(q, packed, cids, valid, cent,
                                            bw, nbits=nbits, q_valid=qv)
    want_v, want_i = stable_topk(scores.masked_fill(~cmask, float("-inf")),
                                 k)
    vals, idx = fused_rerank_topk_batch(q, packed, cids, valid, cmask, cent,
                                        bw, nbits=nbits, k=k, q_valid=qv)
    np.testing.assert_array_equal(idx.numpy(), want_i.numpy())
    np.testing.assert_array_equal(vals.numpy().view(np.uint32),
                                  want_v.numpy().view(np.uint32))


def test_wrappers_refuse_other_devices():
    """Only a CPU tensor takes the plain version; any other device goes to
    the kernel path or raises."""
    q, packed, cids, valid, cmask, cent, bw, qv = _torch(
        _case(3, 1, 8, 4, 4))
    with pytest.raises(ValueError, match="unsupported device"):
        decompress_maxsim_scores_batch(q.to("meta"), packed.to("meta"),
                                       cids.to("meta"), valid.to("meta"),
                                       cent.to("meta"), bw.to("meta"),
                                       nbits=4, q_valid=qv.to("meta"))
    with pytest.raises(ValueError, match="span devices"):
        fused_rerank_topk_batch(q.to("meta"), packed, cids, valid, cmask,
                                cent, bw, nbits=4, k=4, q_valid=qv)


@pytest.mark.parametrize("got_ids,ok", [
    ([7], True),            # the reference's first place
    ([9], True),            # ties with it inside tolerance
    ([4], False),           # a lower place: caught at k=1
    ([7, 9], True),
    ([7, 4], False),        # wrong id in the last place
    ([7, 7], False),        # repeated id
])
def test_parity_bar_checks_the_last_place(got_ids, ok):
    """The bar checks every answer id, the last included, against a
    reference that is deeper than the answer."""
    ref_s = np.float32([3.0, 3.0 - 1e-6, 2.0, 1.0])
    ref_i = np.int64([7, 9, 4, 1])
    got_s = ref_s[:len(got_ids)]
    if ok:
        assert_topk_match(ref_s, ref_i, got_s, np.int64(got_ids))
    else:
        with pytest.raises(AssertionError):
            assert_topk_match(ref_s, ref_i, got_s, np.int64(got_ids))
