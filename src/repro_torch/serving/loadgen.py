"""Load generators + latency aggregation (the paper's Fig 1/2
methodology: QPS sampled from a Poisson process, p50/p95/p99 latency
observed by concurrent clients).

Three arrival disciplines:

* :func:`run_poisson_load` — Poisson arrivals on an absolute schedule,
  optionally bursty (``burst`` co-arriving requests per arrival) and
  time-compressed (``time_scale``) for smoke tests.
* :func:`run_open_loop` — strictly open-loop Poisson arrivals on an
  absolute schedule (``--arrival-rate``): submissions never wait on
  completions, so a saturated server cannot throttle its own offered
  load and queueing shows up in the latency tail — the discipline that
  makes pipeline wins visible at p95/p99, not just in QPS.
* :func:`run_closed_loop` — ``concurrency`` synchronous clients, each
  issuing its next request only after the previous completes
  (throughput self-limits to concurrency/latency).

The generators are host code: they submit to a
:class:`~repro_torch.serving.server.RetrievalServer` and read its
futures, and need no device of their own. Names, signatures, defaults
and draws are the JAX package's ``serving/loadgen.py``; its chaos
choreography (``ChaosSchedule``, ``kill_shard_replica``) belongs to the
process shard workers and is not part of this module.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.serving.admission import RequestShed
from repro_torch.serving.engine import Request
from repro_torch.serving.server import RetrievalServer


@dataclasses.dataclass
class LoadResult:
    latencies: np.ndarray
    service_times: np.ndarray
    wall_time: float
    offered_qps: float
    failed: int = 0          # requests that raised (tolerate_failures)
    # sample of the exceptions behind ``failed`` (first 8) — an
    # availability assert that trips should say what actually broke
    errors: list = dataclasses.field(default_factory=list)
    # outcome split: a shed is a measured overload response, never a
    # failure; degraded and cache-hit answers completed and are in the
    # latency arrays but are counted separately so a run's quality mix
    # is visible next to its tail latency
    shed: int = 0
    degraded: int = 0
    cache_hits: int = 0
    # query-identity mix of the submitted trace (``trace_id``, falling
    # back to qid): how much repeat traffic the cache could have seen
    unique_queries: int = 0
    repeat_queries: int = 0

    def percentile(self, p: float) -> float:
        return float(np.percentile(self.latencies, p)) if len(self.latencies) else float("nan")

    @property
    def p50(self):
        return self.percentile(50)

    @property
    def p95(self):
        return self.percentile(95)

    @property
    def p99(self):
        return self.percentile(99)

    @property
    def achieved_qps(self) -> float:
        return len(self.latencies) / max(self.wall_time, 1e-9)

    def summary(self) -> dict:
        return {"offered_qps": self.offered_qps,
                "achieved_qps": self.achieved_qps,
                "p50": self.p50, "p95": self.p95, "p99": self.p99,
                "mean_service": float(np.mean(self.service_times))
                if len(self.service_times) else float("nan"),
                "n": int(len(self.latencies)),
                "failed": int(self.failed),
                "shed": int(self.shed),
                "degraded": int(self.degraded),
                "cache_hits": int(self.cache_hits),
                "unique_queries": int(self.unique_queries),
                "repeat_queries": int(self.repeat_queries)}


def _trace_counts(requests: list[Request]) -> tuple[int, int]:
    """(unique, repeat) over the submitted trace's query identities."""
    ids = [r.trace_id if r.trace_id is not None else r.qid
           for r in requests]
    unique = len(set(ids))
    return unique, len(ids) - unique


def zipf_trace(n_requests: int, n_unique: int, skew: float = 1.1,
               seed: int = 0) -> np.ndarray:
    """Query indices for a Zipf-skewed trace: request ``i`` asks query
    ``trace[i]`` in ``[0, n_unique)``, with popularity ∝ 1/rank^skew.
    ``skew <= 0`` degenerates to uniform sampling. Ranks are mapped to
    query indices through a seeded permutation so "popular" is not
    correlated with low query ids."""
    rng = np.random.default_rng(seed)
    if skew <= 0:
        return rng.integers(0, n_unique, size=n_requests)
    ranks = np.arange(1, n_unique + 1, dtype=np.float64)
    w = 1.0 / np.power(ranks, skew)
    w /= w.sum()
    picks = rng.choice(n_unique, size=n_requests, p=w)
    perm = rng.permutation(n_unique)
    return perm[picks]


def load_trace(path) -> np.ndarray:
    """Replay trace: one query index per line (blank lines and ``#``
    comments skipped)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                out.append(int(line))
    if not out:
        raise ValueError(f"replay trace {path} has no query indices")
    return np.asarray(out, dtype=np.int64)


def run_poisson_load(server: RetrievalServer, requests: list[Request],
                     qps: float, seed: int = 0,
                     time_scale: float = 1.0,
                     burst: int = 1,
                     on_result: Optional[Callable] = None,
                     tolerate_failures: bool = False) -> LoadResult:
    """Submit ``requests`` with Poisson(qps) inter-arrival gaps.

    Latency statistics are reported raw (client-observed). ``time_scale``
    > 1 compresses the arrival process for smoke tests where only
    mechanics matter — it distorts queueing, so benchmarks use 1.0 and
    instead choose QPS relative to the measured service rate.

    ``burst`` > 1 submits requests in groups of that size per arrival
    (total rate still ``qps``) — the arrival pattern that lets the
    server's micro-batcher coalesce co-arriving queries.

    Arrivals follow an **absolute** schedule (cumulative gaps against
    ``t0``), like :func:`run_open_loop`: a relative ``sleep(gap)`` per
    iteration accumulates scheduler lag and submit overhead, so the
    offered rate silently sags under load — the coordinated-omission
    trap. On the absolute schedule a late submitter skips its sleep and
    catches up, keeping offered ≈ requested QPS.
    """
    rng = np.random.default_rng(seed)
    burst = max(1, burst)
    n_arrivals = -(-len(requests) // burst)
    arrivals = np.cumsum(rng.exponential(burst / qps, n_arrivals)
                         / time_scale)
    return _run_scheduled(server, requests, arrivals, burst=burst,
                          offered_qps=qps, on_result=on_result,
                          tolerate_failures=tolerate_failures)


def run_open_loop(server: RetrievalServer, requests: list[Request],
                  arrival_rate: float, seed: int = 0,
                  timeout: float = 300.0) -> LoadResult:
    """Strictly open-loop Poisson arrivals at ``arrival_rate`` QPS.

    Arrival times are drawn up-front (cumulative exponential gaps) and
    each request is submitted at its absolute scheduled instant — the
    submitter sleeps to the schedule and never waits on a result, so a
    slow server cannot slow the offered load down. Under overload the
    queue grows and p95/p99 latency explodes, which is exactly the
    signal the pipelined server is meant to push out to higher rates.
    """
    rng = np.random.default_rng(seed)
    arrivals = np.cumsum(rng.exponential(1.0 / arrival_rate,
                                         len(requests)))
    return _run_scheduled(server, requests, arrivals, burst=1,
                          offered_qps=arrival_rate, timeout=timeout)


def _run_scheduled(server: RetrievalServer, requests: list[Request],
                   arrivals: np.ndarray, *, burst: int,
                   offered_qps: float, timeout: float = 300.0,
                   on_result: Optional[Callable] = None,
                   tolerate_failures: bool = False) -> LoadResult:
    """Shared submit-on-absolute-schedule loop: ``burst`` requests enter
    at each arrival instant (a late submitter skips its sleep and
    catches up), then every future is drained into a
    :class:`LoadResult`. Both Poisson generators are this loop with
    different schedules — fixes to the discipline land once.

    ``tolerate_failures`` counts failed requests into
    ``LoadResult.failed`` instead of aborting the run on the first
    exception — the discipline for availability experiments, where the
    question is how many requests a fault cost, not whether one
    happened."""
    futures = []
    t0 = time.perf_counter()
    for i, t_sched in zip(range(0, len(requests), burst), arrivals):
        delay = t0 + t_sched - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        for req in requests[i:i + burst]:
            futures.append(server.submit(req))
    lat, svc = [], []
    failed = shed = degraded = cache_hits = 0
    errors: list = []
    for fut in futures:
        try:
            res = fut.result(timeout=timeout)
        except RequestShed:
            # admission control rejecting under overload is a measured
            # outcome of the experiment, not a failure to tolerate
            shed += 1
            continue
        except Exception as e:
            if not tolerate_failures:
                raise
            failed += 1
            if len(errors) < 8:      # a diagnosable sample, not a flood
                errors.append(e)
            continue
        lat.append(res.latency)
        svc.append(res.service_time)
        if getattr(res, "degraded", False):
            degraded += 1
        if getattr(res, "cache_hit", False):
            cache_hits += 1
        if on_result is not None:
            on_result(res)
    wall = time.perf_counter() - t0
    unique, repeat = _trace_counts(requests)
    return LoadResult(latencies=np.asarray(lat),
                      service_times=np.asarray(svc),
                      wall_time=wall, offered_qps=offered_qps,
                      failed=failed, errors=errors, shed=shed,
                      degraded=degraded, cache_hits=cache_hits,
                      unique_queries=unique, repeat_queries=repeat)


def run_closed_loop(server: RetrievalServer, requests: list[Request],
                    concurrency: int = 1,
                    timeout: float = 300.0) -> LoadResult:
    """Closed-loop clients: ``concurrency`` threads, each submitting its
    next request only after the previous one completes. Offered load is
    whatever the server sustains — useful as the service-rate probe the
    open-loop sweep is calibrated against."""
    concurrency = max(1, concurrency)
    lock = threading.Lock()
    next_i = [0]
    lat = [None] * len(requests)
    svc = [None] * len(requests)
    errors: list[BaseException] = []
    counts = {"shed": 0, "degraded": 0, "cache_hits": 0}

    def client():
        while True:
            with lock:
                i = next_i[0]
                if i >= len(requests):
                    return
                next_i[0] += 1
            try:
                res = server.submit(requests[i]).result(timeout=timeout)
            except RequestShed:
                with lock:
                    counts["shed"] += 1
                continue
            except Exception as e:
                # record and keep the loop alive: one failed request must
                # not silently kill the client thread and strand the rest
                with lock:
                    errors.append(e)
                continue
            lat[i] = res.latency
            svc[i] = res.service_time
            if getattr(res, "degraded", False):
                with lock:
                    counts["degraded"] += 1
            if getattr(res, "cache_hit", False):
                with lock:
                    counts["cache_hits"] += 1

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True)
               for _ in range(concurrency)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    ok_lat = [x for x in lat if x is not None]
    ok_svc = [x for x in svc if x is not None]
    if errors and not ok_lat:
        raise errors[0]
    unique, repeat = _trace_counts(requests)
    return LoadResult(latencies=np.asarray(ok_lat, np.float64),
                      service_times=np.asarray(ok_svc, np.float64),
                      wall_time=wall,
                      offered_qps=len(requests) / max(wall, 1e-9),
                      failed=len(errors), errors=errors[:8],
                      shed=counts["shed"], degraded=counts["degraded"],
                      cache_hits=counts["cache_hits"],
                      unique_queries=unique, repeat_queries=repeat)
