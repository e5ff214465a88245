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
"""

from __future__ import annotations

import numpy as np

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
