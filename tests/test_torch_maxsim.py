"""The port's MaxSim wrapper over fp32 embeddings against the JAX
package's ``maxsim_scores[_batch]``.

On the CPU the wrapper runs its plain PyTorch version; these tests hold
it to the JAX reference (``impl="ref"``) and to the Pallas kernel body
in interpret mode, on the same numpy inputs, with the JAX kernel tests'
tolerance (``rtol=atol=1e-4``; the two sum the dot products in other
orders). The CUDA kernel is held to the plain version, and to the
decompress+MaxSim kernel bit for bit, on the card by
``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.maxsim.ops import (maxsim_scores as j_maxsim,
                                      maxsim_scores_batch as j_maxsim_batch)
from repro_torch.index.residual import decode_embeddings
from repro_torch.kernels.decompress_maxsim.ops import (
    decompress_maxsim_scores_batch)
from repro_torch.kernels.maxsim.ops import maxsim_scores, maxsim_scores_batch

TOL = dict(rtol=1e-4, atol=1e-4)


def _case(seed, lead, C, Ld, Lq, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=lead + (Lq, d)).astype(np.float32),
            rng.normal(size=lead + (C, Ld, d)).astype(np.float32),
            rng.random(lead + (C, Ld)) < 0.8,
            rng.random(lead + (Lq,)) < 0.9)


@pytest.mark.parametrize("C,Ld,Lq,d,block_c", [
    (16, 24, 32, 128, 16),
    (20, 8, 8, 64, 8),
    (1, 180, 32, 128, 16),
    (64, 17, 5, 32, 32),
])
def test_maxsim_matches_jax(C, Ld, Lq, d, block_c):
    q, docs, valid, qv = _case(C * 101 + Ld, (), C, Ld, Lq, d)
    got = maxsim_scores(*map(torch.from_numpy, (q, docs, valid, qv)))
    assert got.shape == (C,) and got.dtype == torch.float32
    for impl in ("ref", "interpret"):
        want = j_maxsim(*map(jnp.asarray, (q, docs, valid, qv)), impl=impl,
                        block_c=block_c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=impl, **TOL)


@pytest.mark.parametrize("B,C,Ld,Lq,d,block_c", [
    (3, 16, 24, 32, 128, 16),
    (2, 20, 8, 8, 64, 8),
    (4, 9, 17, 5, 32, 4),
])
def test_maxsim_batch_matches_jax(B, C, Ld, Lq, d, block_c):
    q, docs, valid, qv = _case(B * 7 + C, (B,), C, Ld, Lq, d)
    valid[0, 2] = False                      # an all-invalid doc
    got = maxsim_scores_batch(*map(torch.from_numpy, (q, docs, valid, qv)))
    assert got.shape == (B, C)
    assert got[0, 2].item() == 0.0
    for impl in ("ref", "interpret"):
        want = j_maxsim_batch(*map(jnp.asarray, (q, docs, valid, qv)),
                              impl=impl, block_c=block_c)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=impl, **TOL)
    # without q_valid every query token counts
    got = maxsim_scores_batch(torch.from_numpy(q), torch.from_numpy(docs),
                              torch.from_numpy(valid))
    want = j_maxsim_batch(jnp.asarray(q), jnp.asarray(docs),
                          jnp.asarray(valid), impl="ref")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _masked_case(seed, B, C, Ld, Lq, d, prefix):
    """Inputs whose doc and query masks are prefixes (ragged lengths) or
    not (each position drawn on its own), with an all-invalid first doc
    when there is more than one."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Lq, d)).astype(np.float32)
    docs = rng.normal(size=(B, C, Ld, d)).astype(np.float32)
    if prefix:
        valid = np.arange(Ld) < rng.integers(0, Ld + 1, (B, C))[..., None]
        qv = np.arange(Lq) < rng.integers(1, Lq + 1, B)[:, None]
    else:
        valid = rng.random((B, C, Ld)) < 0.6
        qv = rng.random((B, Lq)) < 0.7
    if C > 1:
        valid[0, 0] = False
    return q, docs, valid, qv


@pytest.mark.parametrize("B,C,Ld,Lq,d,prefix", [
    (2, 5, 20, 33, 64, True),
    (2, 5, 20, 33, 64, False),
    (2, 3, 12, 128, 32, True),
    (2, 3, 12, 128, 32, False),
    (2, 4, 9, 16, 256, True),
    (2, 4, 9, 16, 256, False),
    (1, 1, 70, 24, 64, False),
])
def test_maxsim_edges_match_jax(B, C, Ld, Lq, d, prefix):
    """The plain version at the CUDA kernel's edges (a second pass of 32
    query tokens, 128 of them, d=256, masks that are or are not a prefix,
    a lone candidate with more than one chunk of positions) against the
    JAX reference and the Pallas body in interpret mode."""
    q, docs, valid, qv = _masked_case(B * 31 + C + Lq + d, B, C, Ld, Lq, d,
                                      prefix)
    got = maxsim_scores_batch(*map(torch.from_numpy, (q, docs, valid, qv)))
    assert got.shape == (B, C)
    if C > 1:
        assert got[0, 0].item() == 0.0
    for impl in ("ref", "interpret"):
        want = j_maxsim_batch(*map(jnp.asarray, (q, docs, valid, qv)),
                              impl=impl, block_c=4)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=impl, **TOL)
    if B == 1:   # the single-query entry point, a B=1 launch on the card
        one = maxsim_scores(*map(torch.from_numpy,
                                 (q[0], docs[0], valid[0], qv[0])))
        np.testing.assert_array_equal(one.numpy(), got[0].numpy())
        for impl in ("ref", "interpret"):
            want = j_maxsim(*map(jnp.asarray, (q[0], docs[0], valid[0],
                                               qv[0])), impl=impl, block_c=4)
            np.testing.assert_allclose(one.numpy(), np.asarray(want),
                                       err_msg=impl, **TOL)


def test_maxsim_bf16_inputs_are_cast_to_fp32():
    """A bf16 input is scored in fp32, as the JAX wrapper casts it:
    equal to the fp32 scores of the bf16-rounded values."""
    q, docs, valid, _ = _case(7, (), 16, 12, 8, 64)
    qb = torch.from_numpy(q).bfloat16()
    db = torch.from_numpy(docs).bfloat16()
    v = torch.from_numpy(valid)
    got = maxsim_scores(qb, db, v)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(),
                                  maxsim_scores(qb.float(), db.float(),
                                                v).numpy())
    want = j_maxsim(jnp.asarray(q, jnp.bfloat16), jnp.asarray(docs,
                                                             jnp.bfloat16),
                    jnp.asarray(valid), impl="interpret")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_maxsim_all_invalid_doc_scores_zero():
    q = torch.ones(4, 16)
    docs = torch.ones(3, 5, 16)
    valid = torch.tensor([[True] * 5, [False] * 5, [True] * 5])
    s = maxsim_scores(q, docs, valid)
    assert s[1].item() == 0.0 and s[0].item() == 64.0
    js = j_maxsim(jnp.ones((4, 16)), jnp.ones((3, 5, 16)),
                  jnp.asarray(valid.numpy()), impl="interpret")
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_maxsim_on_decoded_equals_decompress_maxsim():
    """MaxSim over decoded embeddings is decompress+MaxSim: the decode is
    one fp32 add per dimension in both."""
    rng = np.random.default_rng(4)
    B, C, Ld, Lq, d, K, nbits = 2, 12, 9, 8, 64, 40, 4
    q = torch.from_numpy(rng.normal(size=(B, Lq, d)).astype(np.float32))
    packed = torch.from_numpy(rng.integers(0, 256, (B, C, Ld, d * nbits // 8),
                                           dtype=np.uint8))
    cids = torch.from_numpy(rng.integers(0, K, (B, C, Ld), dtype=np.int32))
    valid = torch.from_numpy(rng.random((B, C, Ld)) < 0.7)
    qv = torch.from_numpy(rng.random((B, Lq)) < 0.9)
    cent = torch.from_numpy(rng.normal(size=(K, d)).astype(np.float32))
    bw = torch.linspace(-0.3, 0.3, 2 ** nbits)
    emb = decode_embeddings(packed, cids, cent, bw, nbits)
    a = maxsim_scores_batch(q, emb, valid, qv)
    b = decompress_maxsim_scores_batch(q, packed, cids, valid, cent, bw,
                                       nbits=nbits, q_valid=qv)
    np.testing.assert_array_equal(a.numpy().view(np.uint32),
                                  b.numpy().view(np.uint32))


def test_maxsim_refuses_other_devices():
    q, docs, valid, qv = map(torch.from_numpy, _case(1, (1,), 4, 3, 4, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        maxsim_scores_batch(q.to("meta"), docs.to("meta"), valid.to("meta"),
                            qv.to("meta"))
    with pytest.raises(ValueError, match="span devices"):
        maxsim_scores_batch(q.to("meta"), docs, valid, qv)
