"""Synthetic serving workloads (paper §5.1 Table 2b).

Two benchmark families, statistically matched to the paper's datasets:

* ``sharegpt`` — variable lengths: input ~ lognormal(mean 219.2), output ~
  lognormal(mean 200.8). Variable-length inputs create routing variance
  (paper §5.2: "hot experts can exhibit sudden load spikes").
* ``sonnet``   — fixed 1024-token input / 128-token output: stable routing
  that closely matches time-averaged placement statistics.

Requests arrive via a Poisson process at a target QPS (the vLLM client
replay the paper uses). Each workload also carries a *routing profile* — a
per-layer expert-popularity matrix sampled from a Dirichlet whose
concentration controls skew, calibrated to the paper's Fig 4 observation
(busiest EP rank >24% of tokens, lightest <10%, under 8-way contiguous
placement of 256 experts). Step-level expert loads are multinomial draws
from that profile, so "activation patterns are relatively stable for a
given benchmark" (§4.2.2) holds by construction while per-step noise
remains.

Beyond the flat Poisson client, *traces* model millions-of-users-shaped
traffic: an :class:`ArrivalSpec` picks the arrival process (poisson /
bursty MMPP / diurnal thinning) and a :class:`TraceSpec` mixes
multi-tenant request populations (chat vs long-context, each with its own
length distribution and TTFT SLO) over it — see :data:`TRACES` and
:func:`sample_trace`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["Request", "WorkloadSpec", "WORKLOADS", "sample_requests",
           "routing_profile", "step_loads", "topic_loadings",
           "ArrivalSpec", "TenantSpec", "TraceSpec", "TRACES",
           "sample_arrivals", "sample_trace"]


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    arrival: float                 # seconds
    prompt_len: int
    output_len: int
    tenant: str = ""               # trace tenant (multi-tenant mixes)
    ttft_slo: Optional[float] = None   # per-request deadline override


@dataclasses.dataclass(frozen=True)
class WorkloadSpec:
    name: str
    mean_in: float
    mean_out: float
    fixed: bool                    # fixed lengths (sonnet) vs lognormal
    cv_in: float = 1.2             # coefficient of variation (variable only)
    cv_out: float = 1.1
    routing_alpha: float = 0.25    # Dirichlet concentration (lower = skewed)
    routing_seed: int = 17         # identity of the workload's hot experts
    burst_sigma: float = 0.3       # per-step i.i.d. lognormal spikes
    n_topics: int = 8              # correlated routing factors per step
    topic_sigma: float = 0.5       # topic-factor strength
    # Per-step routing deviation has two parts. ``burst_sigma`` is i.i.d.
    # per-expert noise; ``topic_sigma`` drives a low-rank *correlated*
    # component: a batch of similar prompts routes similarly, so groups of
    # experts spike together across layers. Correlated spikes are what make
    # a token-balanced static placement fragile — the paper's §5.2
    # mechanism: "hot experts can exhibit sudden load spikes that deviate
    # from the profiled average … EPLB may assign these spike-prone experts
    # to slow GPUs."


WORKLOADS: Dict[str, WorkloadSpec] = {
    # variable lengths → more routing variance (paper §5.2)
    "sharegpt": WorkloadSpec("sharegpt", mean_in=219.2, mean_out=200.8,
                             fixed=False, routing_alpha=0.2, routing_seed=17,
                             burst_sigma=0.4, topic_sigma=0.8),
    # fixed lengths → stable routing matching time-averaged statistics
    "sonnet": WorkloadSpec("sonnet", mean_in=1024, mean_out=128,
                           fixed=True, routing_alpha=0.3, routing_seed=91,
                           burst_sigma=0.1, topic_sigma=0.15),
    # long-context family: document-scale prompts, short answers — the
    # head-of-line-blocking stressor for chunked prefill (one of these
    # behind a chat burst is exactly where P90 TTFT separates schedulers)
    "longcontext": WorkloadSpec("longcontext", mean_in=4096, mean_out=96,
                                fixed=False, cv_in=0.6, cv_out=0.8,
                                routing_alpha=0.22, routing_seed=53,
                                burst_sigma=0.3, topic_sigma=0.5),
}


# ---------------------------------------------------------------------------
# arrival processes + multi-tenant traces
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalSpec:
    """Arrival-process family at a target *mean* rate (set per sample).

    * ``poisson`` — exponential gaps (the flat baseline).
    * ``bursty``  — 2-state MMPP: a burst state at ``burst_factor ×`` the
      mean rate occupying ``burst_fraction`` of the time, a quiet state
      sized so the long-run rate stays at the target. Burst/quiet sojourns
      are exponential with mean ``sojourn`` seconds.
    * ``diurnal`` — inhomogeneous Poisson via thinning: rate(t) =
      qps · (1 + amplitude · sin(2πt / period)).
    """

    process: str = "poisson"         # poisson | bursty | diurnal
    burst_factor: float = 4.0        # burst-state rate multiplier
    burst_fraction: float = 0.2      # long-run fraction of time in burst
    sojourn: float = 2.0             # mean burst/quiet dwell (seconds)
    amplitude: float = 0.8           # diurnal swing (< 1)
    period: float = 60.0             # diurnal cycle (seconds)

    def __post_init__(self):
        if self.process not in ("poisson", "bursty", "diurnal"):
            raise ValueError(f"unknown arrival process {self.process!r}")
        if not 0.0 < self.burst_fraction < 1.0:
            raise ValueError("burst_fraction must be in (0, 1)")
        if self.burst_factor * self.burst_fraction >= 1.0 \
                and self.process == "bursty":
            raise ValueError("burst_factor × burst_fraction must be < 1 "
                             "(quiet-state rate would go negative)")
        if not 0.0 <= self.amplitude < 1.0:
            raise ValueError("amplitude must be in [0, 1)")


def sample_arrivals(spec: ArrivalSpec, n: int, qps: float,
                    rng: np.random.Generator) -> np.ndarray:
    """(n,) sorted arrival times with long-run mean rate ``qps``."""
    qps = max(qps, 1e-9)
    if spec.process == "poisson":
        return np.cumsum(rng.exponential(1.0 / qps, size=n))
    if spec.process == "diurnal":
        # thinning against the peak rate
        peak = qps * (1.0 + spec.amplitude)
        out, t = [], 0.0
        while len(out) < n:
            t += rng.exponential(1.0 / peak)
            rate = qps * (1.0 + spec.amplitude
                          * math.sin(2.0 * math.pi * t / spec.period))
            if rng.uniform() * peak <= rate:
                out.append(t)
        return np.asarray(out)
    # bursty MMPP: quiet-state rate balances the long-run mean
    hi = qps * spec.burst_factor
    lo = qps * (1.0 - spec.burst_factor * spec.burst_fraction) \
        / (1.0 - spec.burst_fraction)
    # dwell times hit the target duty cycle
    dwell = {True: spec.sojourn, False: spec.sojourn
             * (1.0 - spec.burst_fraction) / spec.burst_fraction}
    out, t = [], 0.0
    burst = rng.uniform() < spec.burst_fraction
    next_switch = t + rng.exponential(dwell[burst])
    while len(out) < n:
        rate = hi if burst else lo
        gap = rng.exponential(1.0 / max(rate, 1e-9))
        if t + gap >= next_switch:
            t = next_switch
            burst = not burst
            next_switch = t + rng.exponential(dwell[burst])
            continue
        t += gap
        out.append(t)
    return np.asarray(out)


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One request population inside a trace."""

    name: str
    workload: str                    # WORKLOADS key (length distribution)
    weight: float                    # mixing probability
    ttft_slo: Optional[float] = None # tenant deadline (None = serving default)


@dataclasses.dataclass(frozen=True)
class TraceSpec:
    """Arrival process × multi-tenant mix = one serving trace."""

    name: str
    arrival: ArrivalSpec
    tenants: Tuple[TenantSpec, ...]

    def __post_init__(self):
        if not self.tenants:
            raise ValueError("trace needs at least one tenant")
        for t in self.tenants:
            if t.workload not in WORKLOADS:
                raise ValueError(f"tenant {t.name!r}: unknown workload "
                                 f"{t.workload!r}")

    @property
    def primary(self) -> WorkloadSpec:
        """Highest-weight tenant's workload (drives the routing profile)."""
        return WORKLOADS[max(self.tenants, key=lambda t: t.weight).workload]


TRACES: Dict[str, TraceSpec] = {
    # the legacy flat client as a trace (sanity baseline)
    "flat": TraceSpec("flat", ArrivalSpec("poisson"),
                      (TenantSpec("chat", "sharegpt", 1.0),)),
    # chat bursts with long-context stragglers mixed in: the paper's P90
    # TTFT stressor — a 4096-token prefill head-of-line-blocks a burst of
    # chats unless prefill is chunked and deadline-scheduled
    "bursty": TraceSpec(
        "bursty", ArrivalSpec("bursty", burst_factor=4.0,
                              burst_fraction=0.2, sojourn=2.0),
        (TenantSpec("chat", "sharegpt", 0.85, ttft_slo=0.25),
         TenantSpec("longctx", "longcontext", 0.15, ttft_slo=0.60))),
    # slow sinusoidal load swing, three tenants (batch jobs have no TTFT
    # urgency; interactive chat does)
    "diurnal": TraceSpec(
        "diurnal", ArrivalSpec("diurnal", amplitude=0.8, period=60.0),
        (TenantSpec("chat", "sharegpt", 0.6, ttft_slo=0.25),
         TenantSpec("batch", "sonnet", 0.25, ttft_slo=2.0),
         TenantSpec("longctx", "longcontext", 0.15, ttft_slo=0.60))),
}


def sample_trace(trace: TraceSpec, n: int, qps: float,
                 seed: int = 0) -> List[Request]:
    """Sample ``n`` requests from a trace at long-run rate ``qps``."""
    rng = np.random.default_rng(seed)
    arrivals = sample_arrivals(trace.arrival, n, qps, rng)
    weights = np.array([t.weight for t in trace.tenants], dtype=np.float64)
    weights = weights / weights.sum()
    choice = rng.choice(len(trace.tenants), size=n, p=weights)
    reqs: List[Request] = []
    for i in range(n):
        ten = trace.tenants[int(choice[i])]
        spec = WORKLOADS[ten.workload]
        if spec.fixed:
            p_in, p_out = int(spec.mean_in), int(spec.mean_out)
        else:
            p_in = max(1, int(_lognormal(rng, spec.mean_in, spec.cv_in, 1)[0]))
            p_out = max(1, int(_lognormal(rng, spec.mean_out, spec.cv_out,
                                          1)[0]))
        reqs.append(Request(i, float(arrivals[i]), p_in, p_out,
                            tenant=ten.name, ttft_slo=ten.ttft_slo))
    return reqs


def topic_loadings(spec: WorkloadSpec, n_layers: int,
                   n_experts: int) -> np.ndarray:
    """(L, E, n_topics) expert↔topic affinity, fixed per workload."""
    rng = np.random.default_rng(spec.routing_seed + 1)
    a = rng.normal(0.0, 1.0, size=(n_layers, n_experts, spec.n_topics))
    return a / np.sqrt(spec.n_topics)


def _lognormal(rng, mean: float, cv: float, size: int) -> np.ndarray:
    sigma2 = math.log(1.0 + cv * cv)
    mu = math.log(mean) - 0.5 * sigma2
    return rng.lognormal(mu, math.sqrt(sigma2), size=size)


def sample_requests(spec: WorkloadSpec, n: int, qps: float,
                    seed: int = 0) -> List[Request]:
    """Poisson arrivals at ``qps``; lengths per the workload family."""
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / max(qps, 1e-9), size=n)
    arrivals = np.cumsum(gaps)
    if spec.fixed:
        p_in = np.full(n, int(spec.mean_in))
        p_out = np.full(n, int(spec.mean_out))
    else:
        p_in = np.maximum(1, _lognormal(rng, spec.mean_in, spec.cv_in,
                                        n)).astype(int)
        p_out = np.maximum(1, _lognormal(rng, spec.mean_out, spec.cv_out,
                                         n)).astype(int)
    return [Request(i, float(arrivals[i]), int(p_in[i]), int(p_out[i]))
            for i in range(n)]


def routing_profile(spec: WorkloadSpec, n_layers: int,
                    n_experts: int) -> np.ndarray:
    """(L, E) expert-popularity matrix (rows sum to 1), workload-stable."""
    rng = np.random.default_rng(spec.routing_seed)
    return rng.dirichlet(np.full(n_experts, spec.routing_alpha),
                         size=n_layers)


def step_loads(profile: np.ndarray, tokens: int, top_k: int,
               rng: np.random.Generator,
               phase_scale: Optional[np.ndarray] = None) -> np.ndarray:
    """Multinomial per-layer expert token loads for one forward pass.

    Each of ``tokens`` tokens selects ``top_k`` experts per layer; the
    returned (L, E) counts therefore sum to tokens·top_k per row.
    ``phase_scale`` optionally perturbs popularity (drift experiments).
    """
    L, E = profile.shape
    prof = profile if phase_scale is None else profile * phase_scale
    prof = prof / prof.sum(axis=1, keepdims=True)
    out = np.empty((L, E), dtype=np.float64)
    n = tokens * top_k
    for l in range(L):
        out[l] = rng.multinomial(n, prof[l])
    return out
