"""Hardware variability models (paper §2, §3 Challenge 2, §5.5).

The paper measures per-GPU throughput asymmetry on real AMD nodes: up to 7%
fused-MoE kernel-time spread on MI325X, milder on MI300X, and a synthetic
"skewed" regime with one device degraded 13% via a modified V-F curve. The
defining property (Fig 5) is *stress dependence*: variability is latent at low
utilization (decode) and activates when the workload pushes devices to their
power envelope (prefill).

This module provides the cluster-level stand-in used by the discrete-event
simulator and the benchmarks: a :class:`ClusterVariability` that yields one
ground-truth latency function per device, with presets matching the paper's
measured regimes plus a conservative TPU projection.

Ground-truth per-device latency (seconds) for token load n:

    lat_g(n) = t_base + max(w_bytes/BW, 2*n*d*f*3 / (PEAK * speed_g(n)))

where ``speed_g(n)`` interpolates between 1.0 (unstressed) and the device's
intrinsic speed factor as utilization approaches the power envelope:

    speed_g(n) = 1 - (1 - base_speed_g) * stress(n)
    stress(n)  = clip(n / n_tdp, 0, 1) ** stress_gamma

so at low load all devices look identical (paper Fig 5 decode) and at high
load the full process-variation spread is exposed (prefill). ViBE never sees
this ground truth — it only observes profiled (n, latency) samples, exactly
like the real system.

**Time-varying hardware (§4.2.4 "performance estimates" refresh):** the
cluster additionally carries a schedule of :class:`VariabilityEvent`\\ s, so
the ground truth itself can drift: a thermal throttle ramping one device
down, a fleet-wide power-cap step, transient neighbor interference, or a
device replacement that changes a rank's intrinsic speed bin. ``latency``
(and the simulator's vectorized twin) take the virtual-clock time ``t``;
with no events the cluster is static and behaves exactly as before. Named
scenario presets (:data:`SCENARIOS`, :func:`make_scenario`) back the
hardware-drift benchmarks and the ``serve --variability-scenario`` flag.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np

from .perf_model import DeviceProfile, PerfModel, fit_perf_model, profile_device

__all__ = [
    "VariabilityRegime",
    "VariabilityEvent",
    "ClusterVariability",
    "REGIMES",
    "SCENARIOS",
    "make_cluster",
    "make_scenario",
]


@dataclasses.dataclass(frozen=True)
class VariabilityRegime:
    """Distribution of per-device intrinsic speed factors."""

    name: str
    # intrinsic speed factors are sampled as 1 - |N(0, sigma)| truncated,
    # optionally with explicit per-device overrides (e.g. skewed GPU 0).
    sigma: float
    max_slowdown: float              # truncation: slowest device speed
    overrides: Optional[Dict[int, float]] = None
    stress_gamma: float = 2.0        # how sharply variability activates
    throttle: float = 0.30          # fleet-wide frequency drop at full stress
    # Paper Fig 5: "sustained power saturation reduces GPU frequency by 38%
    # on average for MoE layers" — that base throttle hits every device; the
    # device-specific sigma spread rides on top of it. Effective speed:
    #   speed_g(n) = 1 − (throttle + (1 − base_speed_g)) · stress(n)

    def sample_speeds(self, n_devices: int, seed: int = 0) -> np.ndarray:
        rng = np.random.default_rng(seed)
        draw = np.abs(rng.normal(0.0, self.sigma, size=n_devices))
        speeds = np.clip(1.0 - draw, self.max_slowdown, 1.0)
        if self.overrides:
            for dev, s in self.overrides.items():
                if dev < n_devices:
                    speeds[dev] = s
        return speeds


@dataclasses.dataclass(frozen=True)
class VariabilityEvent:
    """One scheduled change to the cluster's ground-truth behaviour.

    ``kind``:

    * ``"ramp"``      — gradual slowdown: the device's effective speed is
      multiplied by a factor going linearly 1 → (1 − magnitude) over
      [t_start, t_start + duration], then holding (thermal throttle).
    * ``"step"``      — instantaneous permanent slowdown by ``magnitude``
      from ``t_start`` on (power-cap change).
    * ``"transient"`` — slowdown by ``magnitude`` only during
      [t_start, t_start + duration) (neighbor interference, shared-fabric
      contention), full recovery afterwards.
    * ``"replace"``   — the device's *intrinsic* speed bin (its entry in
      ``ClusterVariability.speeds``) becomes ``magnitude`` from ``t_start``
      on: a swapped part from a different process-variation bin. Unlike the
      multiplicative kinds this only shows under stress, exactly like the
      static spread.

    ``device`` is an EP rank index, or None for the whole fleet (only
    meaningful for the multiplicative kinds).
    """

    kind: str                        # "ramp" | "step" | "transient" | "replace"
    t_start: float
    magnitude: float                 # fractional slowdown; "replace": new speed
    device: Optional[int] = None     # None = every device
    duration: float = 0.0            # ramp length / transient length

    def __post_init__(self):
        if self.kind not in ("ramp", "step", "transient", "replace"):
            raise ValueError(f"unknown VariabilityEvent kind {self.kind!r}")
        if self.kind == "replace":
            if self.device is None:
                raise ValueError("replace events need a specific device")
            if not 0.0 < self.magnitude <= 1.0:
                raise ValueError("replace magnitude is the new intrinsic "
                                 f"speed in (0, 1], got {self.magnitude}")
        elif not 0.0 <= self.magnitude < 1.0:
            raise ValueError(f"{self.kind} magnitude must be a fractional "
                             f"slowdown in [0, 1), got {self.magnitude}")

    def multiplier(self, t: float) -> float:
        """Effective-speed multiplier this event contributes at time ``t``
        (1.0 = inactive; "replace" events always return 1.0 here)."""
        if self.kind == "replace" or t < self.t_start:
            return 1.0
        if self.kind == "step":
            return 1.0 - self.magnitude
        if self.kind == "transient":
            return (1.0 - self.magnitude
                    if t < self.t_start + self.duration else 1.0)
        # ramp
        if self.duration <= 0.0 or t >= self.t_start + self.duration:
            return 1.0 - self.magnitude
        frac = (t - self.t_start) / self.duration
        return 1.0 - self.magnitude * frac


#: Named hardware-drift scenarios for benchmarks / ``serve``. Each maps to a
#: builder ``f(n_devices, t0, duration) -> List[VariabilityEvent]``; default
#: magnitudes are calibrated to be clearly detectable (≫ jitter_sigma) while
#: staying within the paper's measured throttling range.
SCENARIOS: Dict[str, Callable[..., List[VariabilityEvent]]] = {}


def _scenario(name):
    def reg(fn):
        SCENARIOS[name] = fn
        return fn
    return reg


@_scenario("thermal-ramp")
def _thermal_ramp(n_devices, t0, duration, magnitude=0.30):
    # one device gradually throttles (clogged heatsink / thermal paste aging)
    return [VariabilityEvent("ramp", t0, magnitude, device=0,
                             duration=duration)]


@_scenario("power-cap")
def _power_cap(n_devices, t0, duration, magnitude=0.15):
    # facility lowers the fleet power cap: every device steps down at once
    return [VariabilityEvent("step", t0, magnitude, device=None)]


@_scenario("interference")
def _interference(n_devices, t0, duration, magnitude=0.35):
    # a co-located tenant hammers shared fabric next to the last rank,
    # then goes away
    return [VariabilityEvent("transient", t0, magnitude,
                             device=n_devices - 1, duration=duration)]


@_scenario("device-replace")
def _device_replace(n_devices, t0, duration, magnitude=0.86):
    # rank 0's board is swapped for a part from a slower V-F bin
    return [VariabilityEvent("replace", t0, magnitude, device=0)]


def make_scenario(name: str, n_devices: int, t0: float = 1.0,
                  duration: float = 4.0, **kw) -> List[VariabilityEvent]:
    """Build the event schedule for a named hardware-drift scenario."""
    try:
        builder = SCENARIOS[name]
    except KeyError:
        raise ValueError(f"unknown variability scenario {name!r}; known: "
                         f"{', '.join(sorted(SCENARIOS))}") from None
    return builder(n_devices, t0, duration, **kw)


#: Paper-measured regimes (§3, §5.5) + TPU projection (DESIGN.md §3).
REGIMES: Dict[str, VariabilityRegime] = {
    # MI325X node: up to ~7% kernel-time variation under balanced load
    # (§1, §3). Calibrated so an 8-device draw yields ≈7% spread in *kernel
    # time* at full stress: max|N(0, .035)| over 8 ≈ .046 deviation,
    # ratio (1−.30)/(1−.30−.046) ≈ 1.07. See benchmarks/bench_fig13.
    "mi325x": VariabilityRegime("mi325x", sigma=0.035, max_slowdown=0.94,
                                throttle=0.30),
    # MI300X node: lower variability (§5.5 Fig 13a)
    "mi300x": VariabilityRegime("mi300x", sigma=0.012, max_slowdown=0.97,
                                throttle=0.25),
    # Skewed: GPU 0 degraded 13% via modified V-F curve (§5.5 Fig 13b)
    "skewed": VariabilityRegime("skewed", sigma=0.028, max_slowdown=0.93,
                                overrides={0: 0.87}, throttle=0.30),
    # Conservative TPU v5e projection: narrower binning spread, mild thermal
    "tpu-v5e": VariabilityRegime("tpu-v5e", sigma=0.012, max_slowdown=0.965,
                                 throttle=0.05),
    # Homogeneous control (EPLB's implicit assumption): throttling still
    # happens, identically on every device
    "uniform": VariabilityRegime("uniform", sigma=0.0, max_slowdown=1.0,
                                 throttle=0.30),
}

#: Per-platform hardware magnitudes (effective, not peak-datasheet):
#: peak FLOP/s at serving dtype, HBM bandwidth, scale-up link bandwidth,
#: and the per-rank token load where the power envelope binds (paper §3:
#: 1024-in × bs16 ⇒ ~2k tokens/rank holds MI325X at TDP 82.8% of the time).
#: ici_bw is the per-device *aggregate* scale-up bandwidth (all links used
#: concurrently by an all-to-all): MI3xx full-mesh xGMI ≈ 7×64 GB/s,
#: v5e 2-D torus ≈ 4 usable × 45 GB/s. peak_flops is *effective sustained*
#: FP8 throughput for the fused MoE GEMMs (datasheet peak × ~0.4 MoE-shape
#: MXU efficiency), so simulated step times land at the paper's absolute
#: scale (sonnet saturation ~2–3.5 QPS/GPU on 8×MI325X).
HW_PRESETS: Dict[str, Dict[str, float]] = {
    "mi325x": dict(peak_flops=0.55e15, hbm_bw=6.0e12, ici_bw=448e9,
                   n_tdp=2048.0),
    "mi300x": dict(peak_flops=0.45e15, hbm_bw=5.3e12, ici_bw=448e9,
                   n_tdp=2048.0),
    "skewed": dict(peak_flops=0.55e15, hbm_bw=6.0e12, ici_bw=448e9,
                   n_tdp=2048.0),
    "tpu-v5e": dict(peak_flops=100e12, hbm_bw=819e9, ici_bw=180e9,
                    n_tdp=4096.0),
    "uniform": dict(peak_flops=0.55e15, hbm_bw=6.0e12, ici_bw=448e9,
                    n_tdp=2048.0),
}


@dataclasses.dataclass
class ClusterVariability:
    """Ground-truth latency oracle for a cluster of ``n_devices`` EP ranks.

    Parameters mirror an MoE expert shard: d_model, d_ff, n local experts —
    these set the compute/memory magnitudes so simulated latencies have
    realistic scale and a realistic memory-bound floor.
    """

    n_devices: int
    speeds: np.ndarray               # (G,) intrinsic speed factors in (0,1]
    events: List[VariabilityEvent] = dataclasses.field(default_factory=list)
    # time-varying drift schedule; empty = static cluster (historical
    # behaviour; every ``t`` parameter below is then irrelevant)
    d_model: int = 7168
    d_ff: int = 2048
    experts_per_rank: int = 32
    peak_flops: float = 197e12       # effective FLOP/s per chip
    hbm_bw: float = 819e9            # bytes/s
    ici_bw: float = 50e9             # scale-up link bytes/s (a2a path)
    t_base: float = 8e-6             # dispatch overhead
    n_tdp: float = 4096.0            # token load where power envelope binds
    stress_gamma: float = 2.0
    throttle: float = 0.30           # fleet-wide frequency drop at full stress
    jitter_sigma: float = 0.01       # per-invocation measurement noise
    _rng: np.random.Generator = dataclasses.field(
        default_factory=lambda: np.random.default_rng(1234))

    @property
    def weight_bytes(self) -> float:
        # SwiGLU expert: 3 matrices d_model×d_ff, bf16
        return self.experts_per_rank * 3 * self.d_model * self.d_ff * 2.0

    def stress(self, n: float) -> float:
        return float(np.clip(n / self.n_tdp, 0.0, 1.0) ** self.stress_gamma)

    # -- time-varying ground truth ------------------------------------------

    def base_speeds_at(self, t: float = 0.0) -> np.ndarray:
        """(G,) intrinsic speed bins at time ``t`` ("replace" events)."""
        sp = np.asarray(self.speeds, dtype=np.float64)
        if not self.events:
            return sp
        sp = sp.copy()
        # by t_start, not list order: the most recent replacement wins
        for ev in sorted(self.events, key=lambda e: e.t_start):
            if ev.kind == "replace" and t >= ev.t_start:
                sp[ev.device] = ev.magnitude
        return sp

    def multipliers_at(self, t: float = 0.0) -> np.ndarray:
        """(G,) product of active events' effective-speed multipliers."""
        m = np.ones(self.n_devices, dtype=np.float64)
        for ev in self.events:
            f = ev.multiplier(t)
            if f == 1.0:
                continue
            if ev.device is None:
                m *= f
            else:
                m[ev.device] *= f
        return m

    def effective_speed(self, device_id: int, n: float,
                        t: float = 0.0) -> float:
        """1 at rest; (1 − throttle − device deviation) at full stress,
        further scaled by whatever drift events are active at time ``t``."""
        base = float(self.base_speeds_at(t)[device_id])
        mult = float(self.multipliers_at(t)[device_id])
        speed = (1.0 - (self.throttle + (1.0 - base)) * self.stress(n)) * mult
        return max(speed, 0.1)

    def latency(self, device_id: int, n: float, t: float = 0.0,
                jitter: bool = False) -> float:
        """Ground-truth fused-MoE latency for n tokens on one rank at
        virtual-clock time ``t``.

        DVFS throttling divides the *whole* kernel by the effective speed —
        a frequency drop slows the fabric and scheduling as well as the MXU,
        matching the paper's observation of whole-kernel-time spread (§3).
        """
        n = float(max(n, 0.0))
        flops = 2.0 * n * self.d_model * self.d_ff * 3.0  # 3 GEMMs (SwiGLU)
        t_mem = self.weight_bytes / self.hbm_bw
        t_cmp = flops / self.peak_flops
        lat = (self.t_base
               + max(t_mem, t_cmp) / self.effective_speed(device_id, n, t))
        if jitter and self.jitter_sigma > 0:
            lat *= float(1.0 + self._rng.normal(0.0, self.jitter_sigma))
        return max(lat, 1e-9)

    # -- profiling interface (what ViBE is allowed to see) ------------------

    def profile_all(self, token_counts=(64, 128, 256, 512, 1024, 2048, 4096,
                                         8192, 16384),
                    repeats: int = 3, t: float = 0.0) -> List[DeviceProfile]:
        fn = lambda g, n: self.latency(g, n, t=t, jitter=True)
        return [profile_device(fn, g, token_counts, repeats)
                for g in range(self.n_devices)]

    def fit_models(self, t: float = 0.0, **kw) -> List[PerfModel]:
        """Profile-and-fit at virtual-clock time ``t`` (Phase 1; an oracle
        re-profile of a drifted cluster passes the post-drift time)."""
        return [fit_perf_model(p, **kw)
                for p in self.profile_all(t=t, **kw_pop(kw))]


def kw_pop(kw):
    # profile_all kwargs pass-through helper (fit_perf_model takes n_knots)
    out = {}
    for k in ("token_counts", "repeats"):
        if k in kw:
            out[k] = kw.pop(k)
    return out


def make_cluster(
    n_devices: int,
    regime: str = "mi325x",
    seed: int = 0,
    **overrides,
) -> ClusterVariability:
    """Build a ground-truth cluster for a named variability regime.

    The regime name also selects the platform's hardware magnitudes
    (HW_PRESETS); any explicit keyword overrides them.
    """
    r = REGIMES[regime]
    speeds = r.sample_speeds(n_devices, seed=seed)
    kw = dict(HW_PRESETS.get(regime, {}))
    kw.update(overrides)
    return ClusterVariability(
        n_devices=n_devices,
        speeds=speeds,
        stress_gamma=r.stress_gamma,
        throttle=r.throttle,
        **kw,
    )
