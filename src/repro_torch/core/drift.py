"""Drift detection (paper §4.2.4 "Drift-triggered recalibration", Alg 1 Phase 3).

ViBE monitors three signals rather than recalibrating on a fixed cadence:

1. **Routing drift** — cosine distance between the current windowed mean
   per-layer expert-load vector w and the reference snapshot ŵ recorded at
   the last rearrangement:

       d_l = 1 − (w·ŵ)/(‖w‖‖ŵ‖)

   checked every H forward passes (default 10) over a 100-sample window;
   trigger when max_l d_l > δ_cos (default 0.05).

2. **Stress drift** — unlike EPLB, ViBE also tracks absolute token
   *magnitude*, because hardware variability is stress-dependent: the same
   routing ratios at 4× the batch tokens push devices into steeper regions
   of f_g(n). We trigger when the windowed mean batch token count deviates
   from the reference by more than ``delta_mag`` (relative). Stress takes
   precedence over routing when both fire in the same check — a moved
   operating point mandates the full re-solve path, which the incremental
   routing path would skip.

3. **Performance drift** (:class:`PerfDriftDetector`) — the paper refreshes
   "routing *and performance* estimates": the fitted f_g models themselves
   go stale when hardware behaviour changes (thermal throttling, power-cap
   steps, device replacement). The detector watches the windowed relative
   residual |observed − f_g(n)| / f_g(n) per rank over a
   :class:`~repro_torch.core.perf_model.TelemetryBuffer` of serving-observed
   samples and fires when any rank exceeds δ_perf; the affected ranks'
   models are then refit from the same window.

After a rearrangement a cooldown of H forward passes suppresses spurious
re-triggers from the transient load burst caused by the rearrangement itself
(paper Appendix A.1).
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Optional, Sequence, Tuple

import numpy as np

from .perf_model import PerfModel, TelemetryBuffer, refit_from_samples

__all__ = ["DriftConfig", "DriftDetector", "DriftEvent",
           "PerfDriftConfig", "PerfDriftDetector", "PerfDriftEvent"]


@dataclasses.dataclass(frozen=True)
class DriftConfig:
    delta_cos: float = 0.05      # cosine-distance threshold (paper default)
    delta_mag: float = 0.5       # relative token-magnitude threshold
    window: int = 100            # samples in the rolling mean (paper: 100)
    interval: int = 10           # H — check every H forward passes
    cooldown: int = 10           # forward passes suppressed after a trigger


@dataclasses.dataclass(frozen=True)
class DriftEvent:
    step: int
    kind: str                    # "routing" | "stress"
    max_cos_distance: float
    layer: int                   # argmax routing-drift layer; -1 when the
    #                              routing signal did not trip (pure stress)
    magnitude_ratio: float
    routing_drift: bool = False  # routing signal also above threshold (a
    #                              stress event can carry both)


def cosine_distance(a: np.ndarray, b: np.ndarray) -> float:
    na, nb = float(np.linalg.norm(a)), float(np.linalg.norm(b))
    if na == 0.0 or nb == 0.0:
        return 0.0 if na == nb else 1.0
    return float(1.0 - np.dot(a, b) / (na * nb))


class DriftDetector:
    """Stateful monitor fed one observation per forward pass.

    ``observe(w_step, tokens)`` with w_step the (L, E) per-layer expert load
    of this step and ``tokens`` the batch token count. Returns a DriftEvent
    when recalibration should fire, else None.
    """

    def __init__(self, n_layers: int, n_experts: int,
                 config: DriftConfig = DriftConfig()):
        self.cfg = config
        self.L, self.E = n_layers, n_experts
        self._win: Deque[np.ndarray] = collections.deque(maxlen=config.window)
        self._tok_win: Deque[float] = collections.deque(maxlen=config.window)
        self._ref: Optional[np.ndarray] = None       # (L, E) snapshot ŵ
        self._ref_tokens: Optional[float] = None
        self._step = 0
        self._cooldown_until = -1
        self.events = []

    # -- reference management -------------------------------------------

    def snapshot(self) -> None:
        """Record current window mean as the reference ŵ (after rearrange)."""
        if self._win:
            self._ref = self.window_mean()
            self._ref_tokens = float(np.mean(self._tok_win))
        self._cooldown_until = self._step + self.cfg.cooldown

    def window_mean(self) -> np.ndarray:
        return np.mean(np.stack(self._win), axis=0)

    @property
    def reference(self) -> Optional[np.ndarray]:
        return self._ref

    # -- main entry point -------------------------------------------------

    def observe(self, w_step: np.ndarray, tokens: float) -> Optional[DriftEvent]:
        w_step = np.asarray(w_step, dtype=np.float64)
        if w_step.shape != (self.L, self.E):
            raise ValueError(f"expected ({self.L},{self.E}), got {w_step.shape}")
        self._win.append(w_step)
        self._tok_win.append(float(tokens))
        self._step += 1

        if self._ref is None:
            # bootstrap: snapshot once the window has filled
            if len(self._win) >= self.cfg.window:
                self.snapshot()
            return None
        if self._step <= self._cooldown_until:
            return None
        if self._step % self.cfg.interval != 0:
            return None
        if len(self._win) < self.cfg.window:
            return None

        mean = self.window_mean()
        # routing drift: max per-layer cosine distance
        dists = np.array([cosine_distance(mean[l], self._ref[l])
                          for l in range(self.L)])
        l_max = int(np.argmax(dists))
        d_max = float(dists[l_max])
        mag_ratio = (float(np.mean(self._tok_win)) /
                     max(self._ref_tokens, 1e-9))

        routing = d_max > self.cfg.delta_cos
        stress = abs(mag_ratio - 1.0) > self.cfg.delta_mag
        event = None
        if stress:
            # stress takes precedence: a moved operating point mandates the
            # full re-solve path even when routing drifted simultaneously
            # (the event still carries the routing signal)
            event = DriftEvent(self._step, "stress", d_max,
                               l_max if routing else -1, mag_ratio,
                               routing_drift=routing)
        elif routing:
            event = DriftEvent(self._step, "routing", d_max, l_max, mag_ratio,
                               routing_drift=True)
        if event is not None:
            self.events.append(event)
        return event


# ---------------------------------------------------------------------------
# performance drift (the f_g refresh half of §4.2.4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PerfDriftConfig:
    delta_perf: float = 0.15     # windowed relative-residual threshold
    # fit_perf_model's per-knot local regression removed the ~10%
    # systematic bin-mean bias at the stress knee, so thresholds below
    # 0.10 are meaningful now (they used to fire on fit error alone);
    # 0.15 remains the default as margin for serving-telemetry jitter
    window: int = 128            # telemetry samples kept per rank
    interval: int = 10           # check every H observe() calls
    cooldown: int = 20           # observations suppressed after a trigger
    min_samples: int = 8         # residual needs this many samples per rank
    n_knots: int = 8             # refit resolution (fit_perf_model)


@dataclasses.dataclass(frozen=True)
class PerfDriftEvent:
    step: int
    ranks: Tuple[int, ...]       # ranks whose residual exceeded delta_perf
    max_residual: float
    rank_residuals: np.ndarray   # (G,) windowed relative residuals (NaN→0)
    kind: str = "perf"


class PerfDriftDetector:
    """Watches observed per-rank latencies against the fitted f_g models.

    Fed one observation per engine/simulator step via
    ``observe(rank_loads, rank_latencies)`` ((G,) or (L, G) arrays — the
    per-layer rows the virtual clock computes are each a genuine (n, f_g(n))
    sample). Fires a :class:`PerfDriftEvent` when any rank's windowed mean
    relative residual |observed − f_g(n)| / f_g(n) exceeds ``delta_perf``.

    ``models`` is held by reference: :meth:`refit` replaces the stale
    entries *in place*, so a controller sharing its ``perf_models`` list
    sees the refreshed curves without any copying protocol.
    """

    def __init__(self, n_ranks: int, models: Sequence[PerfModel],
                 config: PerfDriftConfig = PerfDriftConfig()):
        if len(models) != n_ranks:
            raise ValueError("one perf model per rank required")
        self.cfg = config
        self.G = int(n_ranks)
        self.models = models if isinstance(models, list) else list(models)
        self.buffer = TelemetryBuffer(n_ranks, window=config.window)
        self._step = 0
        self._cooldown_until = -1
        self.events = []

    def snapshot(self) -> None:
        """Start the post-recalibration cooldown (mirror of
        :meth:`DriftDetector.snapshot`)."""
        self._cooldown_until = self._step + self.cfg.cooldown

    def residuals(self) -> np.ndarray:
        """(G,) current windowed relative residuals (NaN → 0 for ranks
        without enough samples)."""
        res = self.buffer.relative_residuals(self.models,
                                             self.cfg.min_samples)
        return np.nan_to_num(res, nan=0.0)

    def observe(self, rank_loads: np.ndarray,
                rank_latencies: np.ndarray) -> Optional[PerfDriftEvent]:
        self.buffer.add(rank_loads, rank_latencies)
        self._step += 1
        if self._step <= self._cooldown_until:
            return None
        if self._step % self.cfg.interval != 0:
            return None
        res = self.residuals()
        hot = np.nonzero(res > self.cfg.delta_perf)[0]
        if hot.size == 0:
            return None
        event = PerfDriftEvent(self._step, tuple(int(g) for g in hot),
                               float(res.max()), res)
        self.events.append(event)
        return event

    def refit(self, ranks: Optional[Sequence[int]] = None) -> Tuple[int, ...]:
        """Rebuild the named ranks' models from their telemetry windows.

        Replaces entries of ``self.models`` in place; returns the ranks
        actually refit (those with ≥ 2 window samples). ``None`` = every
        rank currently above threshold.
        """
        if ranks is None:
            ranks = tuple(int(g) for g in
                          np.nonzero(self.residuals()
                                     > self.cfg.delta_perf)[0])
        done = []
        for g in ranks:
            n, lat = self.buffer.samples(g)
            if n.size < 2:
                continue
            # prior= keeps the profiled curve shape (rescaled) when the
            # window lacks load diversity — a saturated server sees only
            # one operating point per step
            self.models[g] = refit_from_samples(n, lat, device_id=g,
                                                n_knots=self.cfg.n_knots,
                                                prior=self.models[g])
            done.append(int(g))
        return tuple(done)
