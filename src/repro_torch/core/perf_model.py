"""Device-specific performance models (paper §4.2.1).

Each EP rank g gets a model ``f_g(n)`` mapping token load ``n`` to expected
fused-MoE kernel latency. The paper profiles each GPU once with the fused MoE
kernel across a token-count sweep (Phase 1); under *performance drift*
(thermal throttling, power-cap changes, device replacement — §4.2.4) the
fitted model goes stale, so this module also provides the online side: a
:class:`TelemetryBuffer` of observed per-rank ``(n, latency)`` samples from
serving itself, and :func:`refit_from_samples` which rebuilds f_g from the
recent window with the same fitting machinery — no offline sweep required.

We model the physically-motivated two-regime shape observed on both GPUs and
TPUs:

  latency(n) = max(t_mem(n), t_compute(n)) + t_base

* ``t_base``    — kernel launch / dispatch overhead (device-independent-ish).
* ``t_mem``     — weight + activation traffic; for small n the expert weights
                  dominate and latency is ~flat in n (memory-bound floor).
* ``t_compute`` — MXU/SIMD time, linear in n, with a device-specific speed
                  factor; near the power envelope the effective slope grows
                  (DVFS throttling), which we capture with a piecewise-linear
                  fit rather than a single slope.

The public surface is small:

  * :class:`PerfModel` — immutable fitted model; ``__call__(n) -> seconds``;
    ``speed(n_ref)`` = 1/f_g(n_ref) (the paper's s_g).
  * :func:`fit_perf_model` — least-squares piecewise-linear fit from
    (token_count, latency) samples, as produced by the profiling harness.
  * :class:`DeviceProfile` — the profiling sweep record for one device.
  * :class:`TelemetryBuffer` — per-rank rolling window of serving-observed
    ``(n, latency)`` samples (the perf-drift detector's raw signal).
  * :func:`refit_from_samples` — rebuild one rank's f_g from such a window.

Everything here is plain numpy — this is control-plane code that runs on the
host next to the serving engine, exactly as in the paper.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "PerfModel",
    "DeviceProfile",
    "TelemetryBuffer",
    "fit_perf_model",
    "profile_device",
    "refit_from_samples",
]


@dataclasses.dataclass(frozen=True)
class PerfModel:
    """Piecewise-linear token-load → latency model for one device.

    ``knots``  — increasing token counts (K,), first is 0.
    ``lat``    — latency (seconds) at each knot (K,).
    Between knots latency is linear; beyond the last knot it extrapolates
    with the final segment's slope. This representation subsumes the paper's
    "assume f_g monotone" requirement and captures the memory-bound floor +
    power-throttled steep region without committing to a parametric form.
    """

    knots: np.ndarray
    lat: np.ndarray
    device_id: int = 0

    def __post_init__(self):
        k = np.asarray(self.knots, dtype=np.float64)
        l = np.asarray(self.lat, dtype=np.float64)
        if k.ndim != 1 or k.shape != l.shape or k.size < 2:
            raise ValueError("knots/lat must be matching 1-D arrays, >=2 points")
        if not np.all(np.diff(k) > 0):
            raise ValueError("knots must be strictly increasing")
        if np.any(l <= 0):
            raise ValueError("latencies must be positive")
        object.__setattr__(self, "knots", k)
        object.__setattr__(self, "lat", l)

    def __call__(self, n) -> np.ndarray:
        """Predicted latency (seconds) at token load ``n`` (scalar or array)."""
        n = np.asarray(n, dtype=np.float64)
        k, l = self.knots, self.lat
        # linear extrapolation beyond last knot using the final slope
        out = np.interp(n, k, l)
        last_slope = (l[-1] - l[-2]) / (k[-1] - k[-2])
        over = n > k[-1]
        out = np.where(over, l[-1] + (n - k[-1]) * last_slope, out)
        return out if out.ndim else float(out)

    def speed(self, n_ref: float) -> float:
        """Paper's s_g = 1 / f_g(n_ref)."""
        return 1.0 / float(self(n_ref))

    def throughput(self, n: float) -> float:
        """Tokens per second at load n (marginal, from local slope)."""
        eps = max(1.0, 0.01 * n)
        return 2 * eps / (float(self(n + eps)) - float(self(n - eps)) + 1e-30)

    def scaled(self, factor: float) -> "PerfModel":
        """A copy with all latencies scaled (e.g. to model degradation)."""
        return PerfModel(self.knots.copy(), self.lat * factor, self.device_id)


@dataclasses.dataclass(frozen=True)
class DeviceProfile:
    """Raw profiling sweep for one device: latency at each token count."""

    device_id: int
    token_counts: np.ndarray  # (S,)
    latencies: np.ndarray     # (S,) seconds

    def __post_init__(self):
        object.__setattr__(self, "token_counts",
                           np.asarray(self.token_counts, dtype=np.float64))
        object.__setattr__(self, "latencies",
                           np.asarray(self.latencies, dtype=np.float64))


def fit_perf_model(profile: DeviceProfile, n_knots: int = 8) -> PerfModel:
    """Fit a monotone piecewise-linear model to a profiling sweep.

    Knots are placed at quantiles of the sampled token counts; latency at
    each knot comes from an isotonic-regularized *local regression* over the
    knot's nearest-knot bin — a line fit through the bin's samples evaluated
    at the knot itself — guaranteeing the fitted f_g is monotone
    non-decreasing (physical requirement — more tokens never finish faster).
    A bin mean (the pre-fix estimator) answered "average latency near this
    knot", not "latency *at* this knot": around the stress knee, where
    curvature is largest, samples on the steep side pulled the mean
    systematically off the knee value (~10% error at the documented profile
    densities). Evaluating the local line at the knot removes that bias
    while degenerating gracefully — single-sample or zero-spread bins fall
    back to the mean. A 0-knot is always anchored at the memory-bound floor
    (the smallest-load bin's latency — at decode-scale loads the expert
    weights dominate and latency is flat in n), honouring the
    :class:`PerfModel` contract that the first knot is 0 even when the
    sweep starts at, say, 64 tokens.
    """
    tc, lt = profile.token_counts, profile.latencies
    order = np.argsort(tc)
    tc, lt = tc[order], lt[order]
    if tc.size < 2:
        raise ValueError("need at least 2 profile samples")
    n_knots = int(min(n_knots, tc.size))
    qs = np.linspace(0.0, 1.0, n_knots)
    knots = np.quantile(tc, qs)
    # de-duplicate knots (quantiles of few samples can repeat)
    knots = np.unique(knots)
    if knots.size < 2:
        knots = np.array([tc.min(), tc.max() + 1.0])
    # local latency per knot: nearest-knot binning, then a per-knot local
    # regression (line through the bin evaluated AT the knot) instead of
    # the bin mean, which sat ~10% off the stress knee (bins straddling
    # the knee average the steep side into the knot value)
    idx = np.abs(tc[:, None] - knots[None, :]).argmin(axis=1)
    lat = np.full(knots.size, np.nan)
    for i in range(knots.size):
        x, y = tc[idx == i], lt[idx == i]
        if x.size == 0:
            continue
        if x.size == 1 or np.ptp(x) == 0.0:
            lat[i] = y.mean()
            continue
        slope, icpt = np.polyfit(x, y, 1)
        lat[i] = icpt + slope * knots[i]
    # fill empty bins by interpolation
    bad = np.isnan(lat)
    if bad.any():
        lat[bad] = np.interp(knots[bad], knots[~bad], lat[~bad])
    # isotonic pass (pool adjacent violators, simple O(K^2) is fine for K<=16)
    lat = _pava(lat)
    # strictly positive floor
    lat = np.maximum(lat, 1e-9)
    if knots[0] > 0.0:
        # anchor the promised 0-knot at the memory-bound floor: loads below
        # the smallest profiled count see the flat floor explicitly instead
        # of relying on interp's silent clamp
        knots = np.concatenate([[0.0], knots])
        lat = np.concatenate([[lat[0]], lat])
    return PerfModel(knots, lat, device_id=profile.device_id)


def _pava(y: np.ndarray) -> np.ndarray:
    """Pool-adjacent-violators: smallest monotone non-decreasing fit."""
    y = y.astype(np.float64).copy()
    n = y.size
    w = np.ones(n)
    # classic stack-based PAVA
    vals = [y[0]]
    wts = [w[0]]
    for i in range(1, n):
        vals.append(y[i])
        wts.append(w[i])
        while len(vals) > 1 and vals[-2] > vals[-1]:
            v = (vals[-2] * wts[-2] + vals[-1] * wts[-1]) / (wts[-2] + wts[-1])
            wt = wts[-2] + wts[-1]
            vals = vals[:-2] + [v]
            wts = wts[:-2] + [wt]
    out = []
    for v, wt in zip(vals, wts):
        out.extend([v] * int(round(wt)))
    return np.asarray(out[:n])


def profile_device(
    latency_fn,
    device_id: int,
    token_counts: Sequence[int] = (64, 128, 256, 512, 1024, 2048, 4096, 8192),
    repeats: int = 3,
) -> DeviceProfile:
    """Run the profiling sweep: call ``latency_fn(device_id, n)`` (seconds).

    In production ``latency_fn`` times the fused MoE kernel on the real
    device (after a warm-up to steady-state thermals, per the paper); in this
    repo the serving simulator and tests inject synthetic device behaviour.
    The median over ``repeats`` is recorded per token count.
    """
    tc, lat = [], []
    for n in token_counts:
        samples = [float(latency_fn(device_id, int(n))) for _ in range(repeats)]
        tc.append(float(n))
        lat.append(float(np.median(samples)))
    return DeviceProfile(device_id=device_id,
                         token_counts=np.asarray(tc),
                         latencies=np.asarray(lat))


# ---------------------------------------------------------------------------
# online telemetry (perf-drift recalibration, §4.2.4)
# ---------------------------------------------------------------------------

class TelemetryBuffer:
    """Per-rank rolling window of serving-observed ``(n, latency)`` samples.

    Serving produces these for free: the engine's virtual clock (or a real
    deployment's kernel timers) yields per-rank token load and measured MoE
    latency every step. The buffer keeps the last ``window`` samples per
    rank — enough load diversity (prefill chunks + decode batches) to refit
    a piecewise-linear f_g without any offline sweep.
    """

    def __init__(self, n_ranks: int, window: int = 128):
        if n_ranks < 1 or window < 1:
            raise ValueError("n_ranks and window must be >= 1")
        self.n_ranks = int(n_ranks)
        self.window = int(window)
        self._buf: List[Deque[Tuple[float, float]]] = [
            collections.deque(maxlen=window) for _ in range(self.n_ranks)]

    def add(self, rank_loads: np.ndarray, rank_latencies: np.ndarray) -> None:
        """Record one step's observations.

        ``rank_loads`` / ``rank_latencies``: matching (G,) or (L, G) arrays
        — the per-layer rows the virtual clock computes are each a genuine
        (n, f_g(n)) sample, so they all go in.
        """
        loads = np.atleast_2d(np.asarray(rank_loads, dtype=np.float64))
        lats = np.atleast_2d(np.asarray(rank_latencies, dtype=np.float64))
        if loads.shape != lats.shape or loads.shape[1] != self.n_ranks:
            raise ValueError(f"loads {loads.shape} / latencies {lats.shape} "
                             f"must match and have {self.n_ranks} columns")
        for g in range(self.n_ranks):
            self._buf[g].extend(zip(loads[:, g], lats[:, g]))

    def count(self, rank: int) -> int:
        return len(self._buf[rank])

    def samples(self, rank: int) -> Tuple[np.ndarray, np.ndarray]:
        """(n, latency) arrays of the rank's current window (oldest first)."""
        if not self._buf[rank]:
            return np.empty(0), np.empty(0)
        arr = np.asarray(self._buf[rank], dtype=np.float64)
        return arr[:, 0], arr[:, 1]

    def relative_residuals(self, models: Sequence[PerfModel],
                           min_samples: int = 1) -> np.ndarray:
        """(G,) windowed mean relative residual |observed − f_g(n)| / f_g(n).

        Ranks with fewer than ``min_samples`` observations report NaN (the
        detector treats that as "no signal yet").
        """
        if len(models) != self.n_ranks:
            raise ValueError("one model per rank required")
        out = np.full(self.n_ranks, np.nan)
        for g, model in enumerate(models):
            if self.count(g) < max(min_samples, 1):
                continue
            n, lat = self.samples(g)
            pred = np.maximum(np.asarray(model(n), dtype=np.float64), 1e-12)
            out[g] = float(np.mean(np.abs(lat - pred) / pred))
        return out

    def clear(self, rank: Optional[int] = None) -> None:
        for g in ([rank] if rank is not None else range(self.n_ranks)):
            self._buf[g].clear()


def refit_from_samples(token_loads: np.ndarray, latencies: np.ndarray,
                       device_id: int = 0, n_knots: int = 8,
                       prior: Optional[PerfModel] = None,
                       min_span: float = 4.0) -> PerfModel:
    """Rebuild one rank's f_g from a telemetry window (online refresh).

    Reuses :func:`fit_perf_model` — quantile knots over the *observed* load
    range, isotonic latencies, 0-knot anchored at the memory-bound floor —
    so the refreshed model has exactly the same shape guarantees as the
    Phase 1 fit, just sourced from recent serving telemetry instead of an
    offline sweep.

    Serving windows rarely look like an offline sweep, so a ``prior`` model
    (the one being replaced) disciplines the refit where the window is
    uninformative:

    * narrow window (max/min < ``min_span``, e.g. a saturated server seeing
      the same full prefill chunk every step): the window identifies at
      most a scale and a trend, so the unseen region is extrapolated from
      the prior. Two physically distinct drifts are modelled separately —
      **throttle** (DVFS-style power capping divides the whole kernel, so
      the observed/predicted ratio is flat in load → rescale the prior's
      entire curve by the median ratio) vs **deviation** (a stress-gated
      shift, e.g. a replaced device with a weaker variability bin, inflates
      only the load-dependent region → preserve the prior's zero-load
      floor and rescale only the excess above it, so low-load predictions
      are not dragged up by a drift that never touched them). The split is
      decided by the ratio's trend across the window's load median.
    * diverse window: the shape is refit from the samples, and the prior's
      knots *above* the observed range ride along, rescaled to match at
      the seam — linear extrapolation from a low-load window would
      otherwise wildly mispredict stressed loads the rank sees later.
    """
    tc = np.asarray(token_loads, dtype=np.float64)
    lt = np.asarray(latencies, dtype=np.float64)
    if tc.size < 2:
        raise ValueError("need at least 2 telemetry samples to refit")
    span = (float(tc.max()) + 1.0) / (float(tc.min()) + 1.0)
    if prior is not None and span < min_span:
        pred = np.maximum(np.asarray(prior(tc), dtype=np.float64), 1e-12)
        ratio = lt / pred
        factor = float(np.median(ratio))
        # throttle vs deviation: split the window at its median load and
        # compare the ratio's halves. A flat trend (or a single-point
        # window, where hi is empty) is the throttle signature.
        n_med = float(np.median(tc))
        lo, hi = ratio[tc <= n_med], ratio[tc > n_med]
        trend = (float(np.median(hi)) - float(np.median(lo))
                 if lo.size and hi.size else 0.0)
        floor = float(prior.lat[0])
        excess = np.maximum(pred - floor, 1e-12)
        deviation = (trend > 0.25 * max(abs(factor - 1.0), 0.02)
                     and float(np.median(pred - floor))
                     > 0.25 * float(np.median(pred)))
        if not deviation:
            return PerfModel(prior.knots.copy(),
                             np.maximum(prior.lat * factor, 1e-9), device_id)
        # deviation: latency = floor + k * (prior - floor); monotone and
        # floor-preserving by construction
        k = max(float(np.median((lt - floor) / excess)), 0.0)
        return PerfModel(prior.knots.copy(),
                         np.maximum(floor + k * (prior.lat - floor), 1e-9),
                         device_id)
    fitted = fit_perf_model(DeviceProfile(device_id, tc, lt),
                            n_knots=n_knots)
    if prior is None:
        return fitted
    n_hi = float(tc.max())
    tail = prior.knots > n_hi * 1.25
    if not tail.any():
        return fitted
    ratio = float(fitted(n_hi)) / max(float(prior(n_hi)), 1e-12)
    knots = np.concatenate([fitted.knots, prior.knots[tail]])
    lat = np.concatenate([fitted.lat,
                          np.maximum(prior.lat[tail] * ratio, 1e-9)])
    # the seam is continuous by construction (both sides equal ~fitted(n_hi)
    # at n_hi); accumulate guards monotonicity against bin noise
    return PerfModel(knots, np.maximum.accumulate(lat), device_id)
