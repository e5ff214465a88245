"""SLO-aware admission control for the serving front door.

The controller turns overload into a measured quality trade instead of
a latency collapse.  It predicts what one more request would cost from
the live per-stage EWMAs in ``PipelineStats`` plus the current queue
depth, and walks the degradation ladder:

    full  →  degraded (splade-only plan)  →  shed

A request is degraded when the full plan's predicted latency blows the
SLO but the cheap stage-1-only path still fits; it is shed only when
even the cheap path is predicted to exceed ``shed_factor`` times the
SLO (or its own deadline). A degraded answer comes back with
``Result.degraded`` set and a reason code.

The cost model buckets the plans' stage names by prefix; the port's
plans use the JAX package's stage names, so the prefixes are the same.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, Mapping, Optional

from repro_torch.serving.context import ADMIT_DEGRADED, ADMIT_FULL, ADMIT_SHED


class RequestShed(RuntimeError):
    """Raised to the caller when admission rejects a request outright."""

    def __init__(self, reason: str, predicted_ms: float = 0.0):
        super().__init__(f"request shed by admission control: {reason} "
                         f"(predicted {predicted_ms:.1f}ms)")
        self.reason = reason
        self.predicted_ms = predicted_ms


@dataclass(frozen=True)
class AdmissionDecision:
    admission: str            # ADMIT_FULL | ADMIT_DEGRADED | ADMIT_SHED
    reason: str
    predicted_full_ms: float
    predicted_cheap_ms: float


# Stage-name prefixes that belong to the post-stage-1 tail (gathers,
# rerank scoring, merges).  Everything else — the splade stage-1
# dispatch and its cheap fuse — is the degraded path's cost.
_TAIL_PREFIXES = (
    "host_gather",
    "device_score",
    "fused_rerank",
    "fuse_topk",
    "shard_rpc",
    "plaid_probe",
    "merge_topk:approx",
    "candidates",
    "gather_codes",
)
_STAGE1_PREFIXES = ("splade_stage1", "fuse_splade", "merge_topk")


def _bucket(stage_name: str) -> Optional[str]:
    for p in _TAIL_PREFIXES:
        if stage_name.startswith(p):
            return "tail"
    for p in _STAGE1_PREFIXES:
        if stage_name.startswith(p):
            return "stage1"
    return None


class AdmissionController:
    """Predict-then-decide admission against ``latency_slo_ms``.

    The prediction is deliberately simple and cheap: per-stage EWMA
    milliseconds (one batch's wall per stage) summed into a stage-1
    cost and a rerank-tail cost, plus an estimate of queue wait as
    ``ceil(queue_depth / batch_cap)`` batches of full service ahead of
    us.  Stage EWMAs are global across methods, so on mixed-method
    traffic the prediction is an upper bound — acceptable for a shed
    decision that only needs to be directionally right under overload.
    """

    def __init__(
        self,
        latency_slo_ms: float,
        shed_factor: float = 3.0,
        min_samples: int = 1,
    ):
        if latency_slo_ms <= 0:
            raise ValueError("latency_slo_ms must be positive")
        self.latency_slo_ms = float(latency_slo_ms)
        self.shed_factor = float(shed_factor)
        self.min_samples = int(min_samples)
        self._lock = threading.Lock()
        self.full_admits = 0
        self.degraded_admits = 0
        self.sheds = 0
        self.last: Optional[AdmissionDecision] = None

    # -- cost model ----------------------------------------------------

    @staticmethod
    def stage_costs(stage_snapshot: Mapping[str, Mapping[str, float]]):
        """(stage1_ms, tail_ms, n_samples) from a PipelineStats stage map."""
        stage1 = 0.0
        tail = 0.0
        samples = 0
        for name, rec in stage_snapshot.items():
            bucket = _bucket(name)
            if bucket is None:
                continue
            ewma = float(rec.get("ewma_ms", 0.0))
            samples = max(samples, int(rec.get("dispatches", 0)))
            if bucket == "tail":
                tail += ewma
            else:
                stage1 += ewma
        return stage1, tail, samples

    def decide(
        self,
        method: str,
        degradable: bool,
        stage_snapshot: Mapping[str, Mapping[str, float]],
        queue_depth: int = 0,
        batch_cap: int = 1,
        deadline_ms: Optional[float] = None,
    ) -> AdmissionDecision:
        stage1_ms, tail_ms, samples = self.stage_costs(stage_snapshot)
        full_ms = stage1_ms + tail_ms
        if method == "splade":
            # splade requests already run the cheap plan
            full_ms = stage1_ms
        batches_ahead = 0
        if batch_cap > 0:
            batches_ahead = (int(queue_depth) + batch_cap - 1) // batch_cap
        wait_ms = batches_ahead * full_ms
        predicted_full = wait_ms + full_ms
        predicted_cheap = batches_ahead * stage1_ms + stage1_ms

        budget = self.latency_slo_ms
        if deadline_ms is not None:
            budget = min(budget, float(deadline_ms))

        if samples < self.min_samples:
            # cold start: no signal yet, admit everything at full quality
            d = AdmissionDecision(ADMIT_FULL, "cold_start", predicted_full, predicted_cheap)
        elif predicted_full <= budget:
            d = AdmissionDecision(ADMIT_FULL, "", predicted_full, predicted_cheap)
        elif degradable and predicted_cheap <= budget:
            d = AdmissionDecision(
                ADMIT_DEGRADED, "slo_tail", predicted_full, predicted_cheap
            )
        elif degradable and predicted_cheap <= budget * self.shed_factor:
            # over budget either way, but the cheap path is close enough
            # that serving a degraded answer beats rejecting outright
            d = AdmissionDecision(
                ADMIT_DEGRADED, "slo_overload", predicted_full, predicted_cheap
            )
        elif not degradable and predicted_full <= budget * self.shed_factor:
            d = AdmissionDecision(ADMIT_FULL, "slo_best_effort", predicted_full, predicted_cheap)
        else:
            reason = "deadline" if (
                deadline_ms is not None and budget < self.latency_slo_ms
            ) else "overload"
            d = AdmissionDecision(ADMIT_SHED, reason, predicted_full, predicted_cheap)

        with self._lock:
            self.last = d
            if d.admission == ADMIT_FULL:
                self.full_admits += 1
            elif d.admission == ADMIT_DEGRADED:
                self.degraded_admits += 1
            else:
                self.sheds += 1
        return d

    def stats(self) -> Dict[str, object]:
        with self._lock:
            last = self.last
            return {
                "latency_slo_ms": self.latency_slo_ms,
                "shed_factor": self.shed_factor,
                "full_admits": self.full_admits,
                "degraded_admits": self.degraded_admits,
                "sheds": self.sheds,
                "last_predicted_full_ms": last.predicted_full_ms if last else 0.0,
                "last_predicted_cheap_ms": last.predicted_cheap_ms if last else 0.0,
            }
