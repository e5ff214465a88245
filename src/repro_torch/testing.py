"""The parity bar for ranked answers, shared by the tests and
``chip_smoke.py``.

Two implementations that sum in different orders give scores a few ulp
apart, and candidates whose scores lie that close may swap places. The
bar: scores ``allclose(rtol, atol)``; ids equal position by position,
except inside a tie group — a run of reference scores each within
tolerance of the previous one — where they are equal as a set.

A top-k list cuts its last tie group wherever k falls, so the reference
is asked for ``REF_MARGIN`` more places than the answer (or for every
candidate): its extra places show which candidates tie with the
answer's last ones, and every answer id is then checked, the last
included.

A ``colbert`` answer may differ by more than a swap inside a tie group:
a tie at the centroid probe's or the approximate stage's boundary
changes the candidates themselves. ``colbert_tie_reference`` shows such
a tie and recomputes the reference past it.

Inside the port a shard group's answer equals the single index's bit
for bit; for ``colbert`` the ids only up to exact-score ties
(``assert_same_up_to_exact_ties``).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.plaid import (stage2_candidates_batch,
                                    stage3_approx_score_batch)
from repro_torch.kernels.fused_rerank.ref import stable_topk

RTOL = 1e-5
ATOL = 1e-5
REF_MARGIN = 8      # extra reference places beyond the answer's k


def _close(a: float, b: float, rtol: float, atol: float) -> bool:
    if a == b:                       # also equal infinities
        return True
    return bool(abs(a - b) <= atol + rtol * abs(b))


def assert_topk_match(ref_scores, ref_ids, got_scores, got_ids, *,
                      rtol: float = RTOL, atol: float = ATOL,
                      what: str = "") -> None:
    """Raise AssertionError unless (got_scores, got_ids) meets the bar
    against the reference. Inputs: (k,) or (B, k) arrays; the reference
    may have more columns than the answer (k_ref ≥ k) and is compared on
    its first k. An id of -1 is padding and must sit at the same place
    in both.

    In each reference tie group [lo, hi) the answer's ids at places
    lo … min(hi, k) - 1 must be ids of that group, and no real id may
    repeat: where the group ends inside the answer that is set equality,
    and where it runs past k the answer may hold any of its members. A
    group that reaches the reference's last column may go on past it,
    so give a reference wide enough that the answer's last group ends
    inside it."""
    rs = np.atleast_2d(np.asarray(ref_scores, np.float64))
    ri = np.atleast_2d(np.asarray(ref_ids, np.int64))
    gs = np.atleast_2d(np.asarray(got_scores, np.float64))
    gi = np.atleast_2d(np.asarray(got_ids, np.int64))
    k = gs.shape[1]
    if (gs.shape != gi.shape or rs.shape != ri.shape
            or rs.shape[0] != gs.shape[0] or rs.shape[1] < k):
        raise AssertionError(f"{what}: shapes differ: ref {rs.shape}/"
                             f"{ri.shape}, got {gs.shape}/{gi.shape}")
    for b in range(rs.shape[0]):
        where = f"{what} row {b}"
        np.testing.assert_allclose(gs[b], rs[b, :k], rtol=rtol, atol=atol,
                                   err_msg=where)
        np.testing.assert_array_equal(gi[b] < 0, ri[b, :k] < 0,
                                      err_msg=f"{where}: padding")
        n = rs.shape[1]
        lo = 0
        while lo < k:
            hi = lo + 1
            while hi < n and _close(rs[b, hi], rs[b, hi - 1], rtol, atol):
                hi += 1
            r_set = set(ri[b, lo:hi].tolist())
            g = gi[b, lo:min(hi, k)].tolist()
            if not set(g) <= r_set:
                raise AssertionError(
                    f"{where}: ids {g} at [{lo}:{min(hi, k)}] are not "
                    f"in the reference's tie group {ri[b, lo:hi].tolist()}")
            lo = hi
        real = gi[b][gi[b] >= 0]
        if len(np.unique(real)) != len(real):
            raise AssertionError(f"{where}: repeated ids {gi[b]}")


def colbert_tie_reference(ref, dev, q_emb, k: int):
    """The reference for a ``colbert`` answer of the ``dev`` searcher
    that differs from the ``ref`` searcher's (same index and params; ref
    on the CPU, dev on the card).

    The two sum the centroid probe and the approximate scores in
    different orders, so a centroid at a token's ``nprobe`` boundary, or
    a candidate at the ``ndocs`` boundary, may fall on either side when
    its score ties with the next one. This shows on ``dev`` that the
    boundary where the two stages differ is such a tie (the two scores
    within tolerance), reruns ``ref``'s later stages from ``dev``'s
    probed centroids or survivors, and returns that answer: (pids
    (k + REF_MARGIN,), scores, route), route naming the boundaries that
    tied ("probe", "approx" or both). Raises AssertionError where the
    stages differ without a tie, or do not differ at all."""
    p = ref.params
    rs, ds = ref.probe_batch([q_emb]), dev.probe_batch([q_emb])
    r_cids, d_cids = rs["cids"][0].numpy(), ds["cids"][0].cpu().numpy()
    routes = []
    cand = rs["cand"]
    moved = [t for t in range(len(r_cids))
             if set(r_cids[t]) != set(d_cids[t])]
    if moved:
        top = torch.topk(ds["scores_c"][0], p.nprobe + 1).values.cpu()
        for t in moved:
            a, b = float(top[t, p.nprobe - 1]), float(top[t, p.nprobe])
            if not _close(b, a, RTOL, ATOL):
                raise AssertionError(
                    f"token {t}: probed centroids differ without a tie "
                    f"at the nprobe boundary ({a!r} vs {b!r})")
        routes.append("probe")
        cand = stage2_candidates_batch(ref.ivf_padded,
                                       torch.as_tensor(d_cids)[None],
                                       p.candidate_cap)
    else:
        np.testing.assert_array_equal(ds["cand"].cpu().numpy(),
                                      cand.numpy(),
                                      err_msg="stage-2 candidates")

    def survivors(s, scores_c, q_valid):
        (c,) = s.to_device(cand)
        codes, valid = s.to_device(*s.gather_codes_batch(
            c if s.device_resident else cand.numpy()))
        approx = stage3_approx_score_batch(scores_c, codes, valid, q_valid)
        return (s.approx_select_batch(scores_c, codes, valid, q_valid, c),
                approx.masked_fill(c < 0, float("-inf")))

    final, _ = survivors(ref, rs["scores_c"], rs["q_valid"])
    d_final, d_approx = survivors(dev, ds["scores_c"], ds["q_valid"])
    d_final = d_final.cpu()
    if set(final[0].tolist()) != set(d_final[0].tolist()):
        ndocs = final.shape[1]
        top = stable_topk(d_approx, ndocs + 1)[0][0].cpu()
        a, b = float(top[ndocs - 1]), float(top[-1])
        if len(top) == ndocs or not _close(b, a, RTOL, ATOL):
            raise AssertionError(
                f"survivors differ without a tie at the ndocs boundary "
                f"({a!r} vs {b!r})")
        routes.append("approx")
        final = d_final
    if not routes:
        raise AssertionError("the answer differs, but the probe and the "
                             "survivors equal the reference's")
    scores = ref.rerank_batch([q_emb], final.numpy())[0]
    order = np.argsort(-scores, kind="stable")[:k + REF_MARGIN]
    pids = np.where(scores[order] > -np.inf, final[0].numpy()[order], -1)
    return pids, scores[order], "+".join(routes)


def assert_same_up_to_exact_ties(want, got, *, what: str = "") -> None:
    """Hold (pids, scores) ``got`` to ``want``, both (k,) or (B, k):
    scores equal bit for bit; ids equal place by place, except inside a
    run of bitwise-equal scores, where they are equal as a set. This is
    the bar between a colbert shard group and the single index: the
    group's final merge breaks an exact-score tie by pid, the single
    index's by approximate rank."""
    wp, gp = np.atleast_2d(want[0]), np.atleast_2d(got[0])
    ws = np.atleast_2d(np.asarray(want[1], np.float32)).view(np.uint32)
    gs = np.atleast_2d(np.asarray(got[1], np.float32)).view(np.uint32)
    np.testing.assert_array_equal(gs, ws, err_msg=f"{what}: score bits")
    np.testing.assert_array_equal(gp.shape, wp.shape, err_msg=what)
    for b in range(ws.shape[0]):
        lo = 0
        while lo < ws.shape[1]:
            hi = lo + 1
            while hi < ws.shape[1] and ws[b, hi] == ws[b, lo]:
                hi += 1
            if sorted(gp[b, lo:hi].tolist()) != sorted(wp[b, lo:hi].tolist()):
                raise AssertionError(
                    f"{what} row {b}: ids {gp[b, lo:hi].tolist()} at "
                    f"[{lo}:{hi}] are not {wp[b, lo:hi].tolist()}")
            lo = hi


def assert_colbert_match(ref, dev, q_emb, want, got, *, what: str = ""
                         ) -> str:
    """Hold one ``colbert`` answer of the ``dev`` searcher, got = (scores,
    pids), to the ``ref`` searcher's, want = (scores, pids) asked for
    ``REF_MARGIN`` places deeper; where they differ, to
    :func:`colbert_tie_reference`. Returns the tie's route, or "" when
    the answers met the bar directly."""
    try:
        assert_topk_match(*want, *got, what=what)
        return ""
    except AssertionError:
        k = np.shape(got[1])[-1]
        pids, scores, route = colbert_tie_reference(ref, dev, q_emb, k)
        assert_topk_match(scores, pids, *got, what=f"{what} ({route} tie)")
        return route


def near_tie_rows(centroids: torch.Tensor, n: int, seed: int = 0
                  ) -> torch.Tensor:
    """n unit rows, each the normalised sum of two distinct centroids:
    its sims to the two are equal in exact arithmetic, so which one an
    fp32 matmul ranks first rests on the matmul's rounding."""
    K = centroids.shape[0]
    g = torch.Generator().manual_seed(seed)
    a = torch.randperm(K, generator=g)[:n]
    b = (a + torch.randint(1, K, (n,), generator=g)) % K
    rows = centroids[a.to(centroids.device)] + centroids[b.to(
        centroids.device)]
    return rows / torch.linalg.norm(rows, dim=-1, keepdim=True)


def assign_placements(rows: torch.Tensor, centroids: torch.Tensor,
                      chunk: int, seed: int = 0) -> dict:
    """``kmeans.assign`` on ``rows`` as a live upsert runs it — the first
    L rows alone, for every L up to ``len(rows)`` — and as a build runs
    it: inside a full ``chunk``-row chunk at three offsets, and inside a
    partial last chunk (three lengths, at its start and its end), among
    unit filler rows. → counts of the rows whose id, and whose best sim's
    bits, differ from the first full-chunk placement's, and how many
    rows were compared."""
    from repro_torch.index.kmeans import assign
    n, d = rows.shape
    if not 0 < n < chunk:
        raise ValueError(f"{n} rows do not fit the placements of a "
                         f"{chunk}-row chunk")
    g = torch.Generator().manual_seed(seed)
    filler = torch.randn(2 * chunk, d, generator=g).to(rows.device)
    filler /= torch.linalg.norm(filler, dim=-1, keepdim=True)

    def placed(total: int, at: int):
        pts = filler[:total].clone()
        pts[at:at + n] = rows
        ids, sims = assign(pts, centroids, chunk=chunk)
        return ids[at:at + n], sims[at:at + n]

    want_ids, want_sims = placed(chunk, 0)
    runs = [placed(chunk, at) for at in ((chunk - n) // 2, chunk - n)]
    for tail in sorted({n, (n + chunk) // 2, chunk - 1}):
        runs += [placed(chunk + tail, chunk + at)
                 for at in sorted({0, tail - n})]
    runs += [assign(rows[:L], centroids, chunk=chunk)
             for L in range(1, n + 1)]
    out = {"placements": len(runs), "rows_compared": 0, "ids_differ": 0,
           "sims_differ": 0}
    for ids, sims in runs:
        m = len(ids)
        out["rows_compared"] += m
        out["ids_differ"] += int((ids != want_ids[:m]).sum())
        out["sims_differ"] += int((sims.view(torch.int32)
                                   != want_sims[:m].view(torch.int32)).sum())
    return out
