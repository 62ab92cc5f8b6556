"""SLO metrics: TTFT/TPOT percentiles, goodput, sustainable QPS (paper §5.1).

Goodput = rate of SLO-compliant requests (both TTFT and TPOT within their
thresholds) — the paper's primary quality-of-service metric, with the 90%
compliance target defining the sustainable-QPS frontier.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence

import numpy as np

__all__ = ["SLO", "RejectReason", "RequestRecord", "summarize", "goodput",
           "slo_frontier", "per_tenant_ttft", "PAPER_SLOS"]


class RejectReason(enum.Enum):
    """Typed admission/overload rejection causes (engine ``submit`` + the
    shedding path). A rejected request is *not* an engine bug: it carries
    its reason on the :class:`RequestRecord` so the chaos-drill invariant
    "every submitted request completes **or** is rejected with a typed
    reason" is checkable, and ``EngineStats.rejected`` tallies by reason
    for the ``serve`` summary line."""

    TOO_LONG = "too_long"        # prompt_len exceeds the engine's max_seq
    NEVER_FITS = "never_fits"    # worst-case KV reservation exceeds the
    #                              admissible pool (would wait forever)
    SHED = "shed"                # overload: load-shedding dropped it under
    #                              KV-pool pressure (watermark breach)


@dataclasses.dataclass(frozen=True)
class SLO:
    ttft: float                    # seconds
    tpot: float                    # seconds/token


#: Paper Table 2b thresholds.
PAPER_SLOS: Dict[tuple, SLO] = {
    ("sharegpt", "deepseek-v3-671b"): SLO(0.250, 0.125),
    ("sharegpt", "qwen3-moe-235b-a22b"): SLO(0.250, 0.100),
    ("sonnet", "deepseek-v3-671b"): SLO(0.350, 0.125),
    ("sonnet", "qwen3-moe-235b-a22b"): SLO(0.350, 0.100),
}


@dataclasses.dataclass
class RequestRecord:
    req_id: int
    arrival: float
    prompt_len: int
    output_len: int
    first_token_at: float = float("nan")
    finished_at: float = float("nan")
    tenant: str = ""               # workload tenant tag ("" = untagged)
    reject_reason: Optional[RejectReason] = None   # None = never rejected
    preemptions: int = 0           # decode evictions under KV pressure
    requeues: int = 0              # total trips back to the waiting queue
    #                                (rank-failure drains + preemptions) —
    #                                the bounded-retry/backoff ledger

    @property
    def rejected(self) -> bool:
        return self.reject_reason is not None

    @property
    def ttft(self) -> float:
        return self.first_token_at - self.arrival

    @property
    def tpot(self) -> float:
        # output_len == 1 means the prefill's argmax IS the full response:
        # zero decode steps, so the per-output-token latency is 0 by
        # definition (a division by output_len - 1 would be 0/0 here)
        if self.output_len <= 1:
            return 0.0
        return (self.finished_at - self.first_token_at) / (self.output_len - 1)

    def meets(self, slo: SLO) -> bool:
        return (np.isfinite(self.ttft) and self.ttft <= slo.ttft
                and self.tpot <= slo.tpot)


def _pct(xs: np.ndarray, p: float) -> float:
    return float(np.percentile(xs, p)) if xs.size else float("nan")


def summarize(records: Sequence[RequestRecord]) -> Dict[str, float]:
    ttft = np.array([r.ttft for r in records if np.isfinite(r.ttft)])
    tpot = np.array([r.tpot for r in records if np.isfinite(r.tpot)])
    return {
        "n": len(records),
        "n_rejected": sum(1 for r in records if r.rejected),
        "ttft_p50": _pct(ttft, 50), "ttft_p90": _pct(ttft, 90),
        "ttft_p99": _pct(ttft, 99),
        "tpot_p50": _pct(tpot, 50), "tpot_p90": _pct(tpot, 90),
        "tpot_p99": _pct(tpot, 99),
    }


def per_tenant_ttft(records: Sequence[RequestRecord],
                    percentile: float = 90.0) -> Dict[str, float]:
    """Per-tenant TTFT percentile — the multi-tenant fairness view.

    Groups records by their ``tenant`` tag and reports the requested TTFT
    percentile per group (unfinished requests, NaN TTFT, are excluded the
    same way :func:`summarize` excludes them). The aggregation is a pure
    function of each tenant's TTFT *multiset*, so it is invariant to
    record order — pinned by a property test."""
    by_tenant: Dict[str, List[float]] = {}
    for r in records:
        if np.isfinite(r.ttft):
            by_tenant.setdefault(r.tenant, []).append(r.ttft)
    return {t: _pct(np.array(xs), percentile)
            for t, xs in by_tenant.items()}


def goodput(records: Sequence[RequestRecord], slo: SLO) -> float:
    """Fraction of requests meeting both SLO thresholds."""
    if not records:
        return 0.0
    return float(np.mean([r.meets(slo) for r in records]))


def slo_frontier(qps_to_goodput: Dict[float, float],
                 target: float = 0.90) -> float:
    """Max sustainable QPS holding ≥ target goodput (linear interpolation).

    "Sustainable" means the piecewise-linear goodput curve stays ≥ target
    at every rate up to the frontier, so the frontier is the *first*
    downward crossing: if goodput dips below target anywhere in the sweep,
    higher sampled rates do not extend the frontier even when a later
    (non-monotone / noisy) sample pops back above target — previously such
    a dip between non-adjacent above-target samples was sailed past and
    the recovery point reported instead. Curves that never drop below the
    target yield the largest sampled QPS; curves already below it at the
    lowest sampled QPS yield 0.
    """
    pts = sorted(qps_to_goodput.items())
    if not pts or pts[0][1] < target:
        return 0.0
    for (q0, g0), (q, g) in zip(pts, pts[1:]):
        if g < target:
            # first downward crossing: g0 ≥ target > g (g0 > g follows)
            return q0 + (q - q0) * (g0 - target) / (g0 - g)
    return pts[-1][0]
