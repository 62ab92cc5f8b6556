"""Dispatch-time token rescheduling between recalibrations (work stealing).

Placement reacts on drift-detector timescales; between recalibrations a
bursty batch or a stale profile leaves realized per-rank load diverging
from the plan — the regime HarMoEny (PAPERS.md) attacks by rebalancing at
*dispatch* time rather than placement time. This module closes that gap on
the variability-aware stack: each step the :class:`TokenRescheduler`
compares per-rank *predicted latency* — ``f_g`` on the realized loads, so
a fast rank legitimately carries more tokens — against the fleet mean, and
when the hottest rank exceeds it by a configurable headroom, shifts a
bounded fraction of traffic share away from that rank's replicated-expert
copies toward their sibling copies on faster ranks.

The mechanism is a pure reweighting of the placement's per-copy traffic
shares (``ReplicatedPlacement.share`` → ``copy_cdf``): no weights move, so
model semantics are untouched (replicas hold identical parameters), and
per-expert share sums stay exactly 1, so token conservation is structural.
The share table is a plain data input to the jitted dispatch (copy-axis
width pinned via ``r_max``), so steal updates never recompile.

Degenerate cases fall out of the math rather than special-casing:

* **r_max == 1** — a singleton expert's only copy has no sibling to
  receive share, so its removal is cancelled; nothing ever changes.
* **balanced load** — the headroom trigger never fires; shares stay at
  the solver's plan.

Everything here is deterministic host-side numpy given the tally stream —
no RNG — so steal-on runs are bit-reproducible under a fixed seed.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence

import numpy as np

from .perf_model import PerfModel
from .placement import ReplicatedPlacement

__all__ = ["StealConfig", "TokenRescheduler"]


@dataclasses.dataclass(frozen=True)
class StealConfig:
    """Knobs for dispatch-time token rescheduling.

    ``headroom``  — steal only when the hottest rank's predicted latency
        exceeds the fleet mean by this relative margin. 0 chases every
        imbalance (thrash-prone); large values only fire on genuine
        stragglers.
    ``max_shift`` — fraction of a hot copy's current share moved per step;
        bounds each step's reweighting so a single noisy tally cannot
        swing the split (the next step's trigger re-evaluates from the
        shifted state, so repeated steps converge geometrically).
    ``interval``  — evaluate the trigger every this many observed steps
        (tallies are still folded into the load estimate in between).
    ``smoothing`` — EMA coefficient on realized per-expert loads: the
        weight of the newest step. 1.0 reacts to the raw last step; lower
        values trade reaction time for stability on decode-sized batches.
    """

    headroom: float = 0.1
    max_shift: float = 0.25
    interval: int = 1
    smoothing: float = 0.5

    def __post_init__(self):
        if self.headroom < 0:
            raise ValueError(f"headroom must be >= 0, got {self.headroom}")
        if not 0.0 < self.max_shift <= 1.0:
            raise ValueError("max_shift must be in (0, 1], "
                             f"got {self.max_shift}")
        if self.interval < 1:
            raise ValueError(f"interval must be >= 1, got {self.interval}")
        if not 0.0 < self.smoothing <= 1.0:
            raise ValueError("smoothing must be in (0, 1], "
                             f"got {self.smoothing}")


class TokenRescheduler:
    """Per-step bounded reweighting of a replicated placement's copy shares.

    Owns the *responsive* share table: :attr:`placement` starts as the
    solver's plan (set via :meth:`reset` at every recalibration) and drifts
    from it as :meth:`observe` reacts to realized load. Consumers price and
    dispatch against :attr:`placement`; the base plan is untouched, so a
    recalibration always restarts from the solver's intent.

    ``perf_models`` is held **by reference** (the controller's live list) —
    online perf-drift refits flow into the steal trigger without a copy
    protocol, mirroring :class:`~repro_torch.core.drift.PerfDriftDetector`.
    """

    def __init__(self, config: StealConfig,
                 perf_models: Sequence[PerfModel]):
        self.cfg = config
        self.perf_models: List[PerfModel] = \
            perf_models if isinstance(perf_models, list) else \
            list(perf_models)
        #: monotone change counter: consumers compare against their own
        #: snapshot to learn "the responsive shares moved, refresh tables"
        #: without the rescheduler knowing who consumes them
        self.version = 0
        self.steals = 0              # steps on which any share moved
        self.share_moved = 0.0       # Σ |share delta| across all steals
        self._pl: Optional[ReplicatedPlacement] = None
        self._share: Optional[np.ndarray] = None
        self._w: Optional[np.ndarray] = None
        self._ticks = 0
        #: (G,) EMA of measured/predicted latency per rank, from
        #: observe_latency telemetry; None until the first measurement
        self._lat_bias: Optional[np.ndarray] = None

    # ------------------------------------------------------------------
    @property
    def placement(self) -> ReplicatedPlacement:
        """The responsive placement (base slot table, current shares)."""
        if self._pl is None:
            raise RuntimeError("TokenRescheduler.reset() not called")
        return self._pl

    def reset(self, placement: ReplicatedPlacement) -> None:
        """Adopt a new base placement (called at every recalibration).

        Responsive shares restart at the solver's plan and the load EMA
        restarts cold — post-recalibration tallies reflect the *new*
        layout, and the old estimate would mis-trigger against it.
        """
        if len(self.perf_models) != placement.n_ranks:
            raise ValueError(f"{len(self.perf_models)} perf models != "
                             f"{placement.n_ranks} ranks")
        self._pl = placement
        self._share = placement.share.copy()
        self._w = None
        self._ticks = 0
        # drop the measured-latency bias too: a recalibration usually means
        # the perf models were just refit from the same telemetry, and
        # keeping the bias would double-count the drift it already absorbed
        self._lat_bias = None
        self.version += 1

    # ------------------------------------------------------------------
    def observe(self, expert_loads: np.ndarray) -> bool:
        """Feed one step's realized per-expert loads; returns True when the
        responsive shares changed (consumers should refresh dispatch/CDF
        tables — :attr:`version` bumps in lockstep)."""
        if self._pl is None:
            raise RuntimeError("TokenRescheduler.reset() not called")
        w = np.atleast_2d(np.asarray(expert_loads, dtype=np.float64))
        if w.shape != (self._pl.n_layers, self._pl.n_experts):
            raise ValueError(
                f"expert_loads shape {w.shape} != "
                f"{(self._pl.n_layers, self._pl.n_experts)}")
        a = self.cfg.smoothing
        self._w = w if self._w is None else a * w + (1.0 - a) * self._w
        self._ticks += 1
        if self._ticks % self.cfg.interval:
            return False
        new_share = self._steal(self._w)
        if new_share is None:
            return False
        self._share = new_share
        self._pl = ReplicatedPlacement(self._pl.slot_expert, new_share,
                                       self._pl.n_ranks, self._pl.n_experts)
        self.version += 1
        self.steals += 1
        return True

    # ------------------------------------------------------------------
    def observe_latency(self, rank_loads: np.ndarray,
                        rank_latencies: np.ndarray) -> None:
        """Blend measured per-rank latencies into the steal trigger.

        ``rank_loads`` / ``rank_latencies`` are (G,) or (L, G) — the same
        telemetry the virtual clocks feed ``ViBEController.observe_latency``
        for perf-drift refits. The measured/predicted ratio is EMA-tracked
        per rank and multiplies :meth:`predicted_latency`, so the trigger
        (and recipient speed weights) see hardware drift *between* perf
        refits — e.g. a thermal ramp that f_g, fitted minutes ago, knows
        nothing about. :meth:`reset` clears the bias: the refit the
        recalibration just ran absorbed the same drift.
        """
        if self._pl is None:
            return
        load = np.atleast_2d(np.asarray(rank_loads, dtype=np.float64))
        lat = np.atleast_2d(np.asarray(rank_latencies, dtype=np.float64))
        if load.shape != lat.shape or load.shape[-1] != self._pl.n_ranks:
            raise ValueError(f"latency telemetry shapes {load.shape} / "
                             f"{lat.shape} do not match G={self._pl.n_ranks}")
        pred = np.empty_like(load)
        for g, m in enumerate(self.perf_models):
            pred[:, g] = m(load[:, g])
        ratio = (lat / np.maximum(pred, 1e-12)).mean(axis=0)     # (G,)
        a = self.cfg.smoothing
        self._lat_bias = ratio if self._lat_bias is None \
            else a * ratio + (1.0 - a) * self._lat_bias

    def predicted_latency(self, w: np.ndarray) -> np.ndarray:
        """(L, G) per-rank predicted latency f_g(load) under the current
        responsive shares — the steal trigger's signal. Scaled by the
        measured/predicted bias when latency telemetry has been observed."""
        load = self._pl_with(self._share).rank_loads(w)
        lat = np.empty_like(load)
        for g, m in enumerate(self.perf_models):
            lat[:, g] = m(load[:, g])
        if self._lat_bias is not None:
            lat = lat * self._lat_bias[None, :]
        return lat

    def _pl_with(self, share: np.ndarray) -> ReplicatedPlacement:
        pl = self._pl
        return ReplicatedPlacement(pl.slot_expert, share,
                                   pl.n_ranks, pl.n_experts)

    def _steal(self, w: np.ndarray) -> Optional[np.ndarray]:
        """One bounded reweighting pass; None when nothing moves.

        Vectorized across layers: per layer, the single hottest rank (by
        predicted latency) sheds ``max_shift`` of each of its resident
        copies' shares to the same experts' copies on other ranks,
        recipients weighted by the *speed* (1/latency) of the rank they
        sit on. Experts with no off-hot-rank copy keep their share — the
        removal is cancelled, never dropped.
        """
        pl = self._pl
        cfg = self.cfg
        share = self._share
        se = pl.slot_expert
        L, S = se.shape
        E, G = pl.n_experts, pl.n_ranks
        rows = np.arange(L)
        lat = self.predicted_latency(w)                          # (L, G)
        hot = np.argmax(lat, axis=1)                             # (L,)
        trigger = lat[rows, hot] > (1.0 + cfg.headroom) * lat.mean(axis=1)
        if not trigger.any():
            return None
        rank_of = np.arange(S) // pl.slots_per_rank              # (S,)
        real = se < E                                            # (L, S)
        on_hot = rank_of[None, :] == hot[:, None]                # (L, S)
        # recipients: an expert's copies off the hot rank, weighted by the
        # speed of the rank they occupy (faster rank absorbs more)
        slot_speed = 1.0 / lat[:, rank_of]                       # (L, S)
        recv_w = np.where(real & ~on_hot & trigger[:, None],
                          slot_speed, 0.0)
        se_c = np.minimum(se, E)
        denom = np.zeros((L, E + 1))
        np.add.at(denom, (rows[:, None], se_c), recv_w)
        denom[:, E] = 1.0                                        # phantoms
        has_recv = np.take_along_axis(denom, se_c, axis=1) > 0.0
        delta = np.where(trigger[:, None] & on_hot & real & has_recv,
                         share * cfg.max_shift, 0.0)
        if not delta.any():
            return None                                # e.g. r_max == 1
        removed = np.zeros((L, E + 1))
        np.add.at(removed, (rows[:, None], se_c), delta)
        gain = recv_w / np.maximum(np.take_along_axis(denom, se_c, axis=1),
                                   1e-300) \
            * np.take_along_axis(removed, se_c, axis=1)
        new_share = share - delta + gain
        self.share_moved += float(delta.sum())
        return new_share

    # ------------------------------------------------------------------
    def expected_rank_loads(self, w: np.ndarray) -> np.ndarray:
        """(L, G) fractional per-rank loads under the responsive shares —
        convenience for tests and pricing parity checks."""
        return self._pl_with(self._share).rank_loads(
            np.atleast_2d(np.asarray(w, dtype=np.float64)))

    @property
    def share_table_bytes(self) -> int:
        """Bytes of the float32 CDF/share broadcast a steal update ships to
        the fleet — what the virtual clocks charge per update."""
        if self._pl is None:
            return 0
        return int(self._pl.share.size * 4)
