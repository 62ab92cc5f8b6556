"""ViBE end-to-end controller (paper Algorithm 1, Appendix A.1).

Ties the four components together across the three phases:

  Phase 1 (offline):  profile each EP rank → f_g(n); run representative
                      workload → activation matrix W.
  Phase 2 (initial):  registry policy solve over the SolveContext.
  Phase 3 (online):   every H forward passes check drift; on trigger refresh
                      W from recent routing, recalibrate (capability-gated:
                      policies advertising ``supports_incremental`` refine
                      with minimal-movement swaps, others re-solve in full),
                      snapshot the reference, cool down.

Phase 3 watches **both** halves of the paper's recalibration story: routing
drift over the activation matrix (``observe``) and *performance* drift over
the fitted f_g models (``observe_latency`` — per-rank (load, latency)
telemetry fed back from the serving virtual clock or real kernel timers).
A perf-drift event refits the affected ranks' models from the telemetry
window (:func:`~repro_torch.core.perf_model.refit_from_samples`), rebuilds the
SolveContext with the refreshed models, and recalibrates; on the
incremental path ``reweight_shares_by_speed`` then consumes the refreshed
speeds, so traffic shares chase the hardware's *current* behaviour.

The controller is engine-agnostic: the serving engine feeds it per-step
routing tallies + observed batch token counts and asks for the current
placement; when a recalibration fires, the controller returns a
:class:`PlacementUpdate` whose swap list doubles as the weight-migration
plan (bytes accounted for the paper's transfer-volume comparison).

The placement policy is resolved from the registry
(:mod:`repro_torch.core.policy`) by name — the controller never compares policy
names itself; every branch reads :class:`PolicyCapabilities` flags, so a
newly registered policy works here unchanged. Placements are always the
unified :class:`ReplicatedPlacement` representation (singleton policies
yield the r_max = 1 degenerate).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

from .activation import ActivationProfiler
from .drift import (DriftConfig, DriftDetector, DriftEvent, PerfDriftConfig,
                    PerfDriftDetector, PerfDriftEvent)
from .incremental import IncrementalResult
from .perf_model import PerfModel
from .placement import ReplicatedPlacement
from .policy import PlacementPolicy, SolveContext, get_policy
from .steal import StealConfig, TokenRescheduler
from .topology import ClusterTopology

__all__ = ["ViBEConfig", "PlacementUpdate", "FailEvent", "ViBEController"]


@dataclasses.dataclass(frozen=True)
class ViBEConfig:
    policy: str = "vibe"              # any name in repro_torch.core.policy registry
    adaptive: bool = True             # Phase 3 on/off (paper: static vs adaptive)
    drift: DriftConfig = dataclasses.field(default_factory=DriftConfig)
    perf_drift: Optional[PerfDriftConfig] = None
    # None disables performance-drift monitoring (routing-only Phase 3, the
    # pre-drift-refresh behaviour). Set a PerfDriftConfig to watch observed
    # per-rank latencies against the fitted f_g models and refit + recalibrate
    # when the relative residual exceeds delta_perf on any rank.
    epsilon: float = 0.03             # incremental solver tolerance
    expert_bytes: int = 0             # per-expert weight bytes (migration cost)
    full_resolve_on_stress: bool = True
    # stress drift changes f_g's operating point → re-solve from scratch is
    # allowed there (the paper's magnitude-aware recalibration); routing-only
    # drift uses the minimal-movement incremental solver.
    slot_budget: Union[None, int, Sequence[int], np.ndarray] = None
    # physical slot budget per rank for replication-capable policies: a
    # scalar (uniform) or a (G,) array (non-uniform, device memory
    # headroom). None = the policy's default. Only valid when the policy's
    # capabilities report accepts_slot_budget.
    slots_per_rank: Union[None, int, Sequence[int], np.ndarray] = None
    # deprecated alias of slot_budget (the published pre-registry kwarg);
    # the two are merged in __post_init__ and read identically afterwards.
    reweight_shares: bool = False
    # replicated policies only: after an incremental (swap-based)
    # recalibration, re-proportion each expert's copy shares to the speeds
    # of the ranks its copies landed on (placement.reweight_shares_by_speed)
    # so the weighted dispatch keeps steering traffic toward fast copies.
    steal: Optional[StealConfig] = None
    # dispatch-time token rescheduling (core/steal.py): between
    # recalibrations, shift bounded traffic shares away from the rank whose
    # predicted latency exceeds the fleet mean by the configured headroom,
    # toward sibling replica copies on faster ranks. Operates even with
    # adaptive=False (it is orthogonal to recalibration — exactly the
    # stale-profile regime it exists for). Requires a replication-capable
    # policy: without copies there is nowhere to shift share.
    topology: Optional[ClusterTopology] = None
    # fleet topology (core/topology.py): node structure + ICI/DCN link
    # asymmetry, threaded into every SolveContext so topology-aware
    # policies (vibe_h) bin experts by node. None = flat cluster — every
    # pre-existing policy behaves identically either way.

    # -- validated against the registered policy's capabilities -----------
    def __post_init__(self):
        if self.slots_per_rank is not None:
            if self.slot_budget is not None and not np.array_equal(
                    np.asarray(self.slot_budget),
                    np.asarray(self.slots_per_rank)):
                raise ValueError("pass slot_budget or its deprecated alias "
                                 "slots_per_rank, not conflicting both")
            object.__setattr__(self, "slot_budget", self.slots_per_rank)
        else:
            object.__setattr__(self, "slots_per_rank", self.slot_budget)
        caps = get_policy(self.policy).capabilities   # raises on unknown name
        if self.perf_drift is not None and not caps.needs_perf_models:
            # such a policy never reads f_g — refitting the models could
            # never change its placement, so the monitor would be inert
            raise ValueError(
                f"perf_drift set, but policy {self.policy!r} has "
                "capabilities.needs_perf_models=False — refreshed perf "
                "models would never influence its placement")
        if self.slot_budget is not None and not caps.accepts_slot_budget:
            raise ValueError(
                f"slot_budget set, but policy {self.policy!r} has "
                "capabilities.accepts_slot_budget=False — the budget would "
                "be silently ignored")
        if self.reweight_shares and not (caps.supports_replication
                                         and caps.supports_incremental):
            # the reweight only executes on the incremental refine path, so
            # accepting it for a policy that never refines (or has no copy
            # shares at all) would be silently inert
            raise ValueError(
                f"reweight_shares=True, but policy {self.policy!r} lacks "
                "supports_replication+supports_incremental — the flag "
                "would never take effect")
        if self.steal is not None and not caps.supports_replication:
            # stealing reweights *copy* shares; a singleton placement has
            # one copy per expert, so every steal would cancel — inert
            raise ValueError(
                f"steal set, but policy {self.policy!r} has "
                "capabilities.supports_replication=False — a singleton "
                "placement has no replica copies to shift share between")


@dataclasses.dataclass(frozen=True)
class FailEvent:
    """A rank (or several) left the fleet — device failure, scheduled
    replace, or elastic shrink. Triggers a topology-masked full re-solve
    through :meth:`ViBEController.mask_ranks`."""

    ranks: Tuple[int, ...]
    kind: str = "fail"


@dataclasses.dataclass(frozen=True)
class PlacementUpdate:
    step: int
    event: Union[DriftEvent, PerfDriftEvent, FailEvent]
    placement: ReplicatedPlacement
    moved_experts: int
    migration_bytes: int
    swaps_per_layer: Optional[np.ndarray] = None
    full_resolve: bool = False
    refit_ranks: Tuple[int, ...] = ()   # ranks whose f_g was refreshed
    #                                     ("perf" events only)

    @property
    def kind(self) -> str:
        """Which signal triggered this update:
        "routing" | "stress" | "perf" | "fail"."""
        return self.event.kind


class ViBEController:
    def __init__(
        self,
        n_layers: int,
        n_experts: int,
        n_ranks: int,
        perf_models: Sequence[PerfModel],
        config: ViBEConfig = ViBEConfig(),
        initial_w: Optional[np.ndarray] = None,
    ):
        if len(perf_models) != n_ranks:
            raise ValueError("one perf model per EP rank required")
        if config.topology is not None \
                and config.topology.n_ranks != n_ranks:
            raise ValueError(f"topology has {config.topology.n_ranks} ranks "
                             f"but the controller manages {n_ranks}")
        self.cfg = config
        self.policy: PlacementPolicy = get_policy(config.policy)
        self.L, self.E, self.G = n_layers, n_experts, n_ranks
        self.dead_ranks: Tuple[int, ...] = ()
        self.perf_models = list(perf_models)
        self.profiler = ActivationProfiler(n_layers, n_experts,
                                           window=config.drift.window)
        self.detector = DriftDetector(n_layers, n_experts, config.drift)
        # perf-drift detector shares self.perf_models BY REFERENCE: its
        # refit() replaces entries in place, so _context() always reads the
        # freshest f_g without a copy protocol
        self.perf_detector = (
            PerfDriftDetector(n_ranks, self.perf_models, config.perf_drift)
            if config.perf_drift is not None else None)
        w0 = (np.atleast_2d(initial_w) if initial_w is not None
              else np.full((n_layers, n_experts), 1.0 / n_experts))
        self.placement: ReplicatedPlacement = self._solve(w0)
        # dispatch-time work stealing: shares self.perf_models BY REFERENCE
        # (like perf_detector) so online refits retune the steal trigger
        self.rescheduler = (TokenRescheduler(config.steal, self.perf_models)
                            if config.steal is not None else None)
        if self.rescheduler is not None:
            self.rescheduler.reset(self.placement)
        self._step = 0
        self.updates: List[PlacementUpdate] = []

    # ------------------------------------------------------------------
    def _context(self, w: np.ndarray) -> SolveContext:
        """SolveContext carrying this controller's knobs and profiles."""
        caps = self.policy.capabilities
        return SolveContext(
            w=w, n_ranks=self.G,
            perf_models=self.perf_models if caps.needs_perf_models else None,
            slot_budget=self.cfg.slot_budget,
            epsilon=self.cfg.epsilon,
            reweight_shares=self.cfg.reweight_shares,
            topology=self.cfg.topology,
            dead_ranks=self.dead_ranks or None)

    def _solve(self, w: np.ndarray) -> ReplicatedPlacement:
        """Full placement solve with this controller's policy and knobs."""
        return self.policy.solve(self._context(w))

    # ------------------------------------------------------------------
    @property
    def step(self) -> int:
        return self._step

    @property
    def dispatch_placement(self) -> ReplicatedPlacement:
        """What dispatch should route against *right now*: the responsive
        (steal-adjusted) placement when stealing is on, else the plan.
        Same slot table either way — only traffic shares differ."""
        if self.rescheduler is not None:
            return self.rescheduler.placement
        return self.placement

    def observe(self, step_counts: np.ndarray,
                tokens: Optional[float] = None) -> Optional[PlacementUpdate]:
        """Feed one forward pass; returns an update when recalibration fires.

        ``step_counts``: (L, E) routing tallies for this pass.
        ``tokens``: batch token count (defaults to layer-0 tally sum).
        """
        self._step += 1
        step_counts = np.asarray(step_counts, dtype=np.float64)
        self.profiler.update(step_counts)
        if self.rescheduler is not None:
            # BEFORE the adaptive gate: stealing is dispatch-time and
            # orthogonal to recalibration — it must run for static
            # controllers too (the stale-profile regime it exists for)
            self.rescheduler.observe(step_counts)
        if tokens is None:
            tokens = float(step_counts[0].sum())
        if not self.cfg.adaptive \
                or not self.policy.capabilities.workload_aware:
            # static layouts can't react to routing — still track (so
            # static-vs-adaptive comparisons share stats)
            self.detector.observe(step_counts, tokens)
            return None
        event = self.detector.observe(step_counts, tokens)
        if event is None:
            return None
        return self._recalibrate(event)

    def observe_latency(self, rank_loads: np.ndarray,
                        rank_latencies: np.ndarray
                        ) -> Optional[PlacementUpdate]:
        """Feed one step's per-rank (token load, observed MoE latency).

        Arrays are (G,) or (L, G) — the engine/simulator virtual clocks
        produce the per-layer form. When the windowed relative residual
        against the fitted f_g exceeds δ_perf on any rank, the affected
        models are refit from the telemetry window and a recalibration runs
        with the refreshed estimates (the paper's performance-refresh half
        of §4.2.4). Returns the resulting update, or None.

        Telemetry is tracked even for static controllers so static-vs-
        adaptive comparisons share drift statistics, mirroring ``observe``.
        """
        if self.rescheduler is not None:
            # BEFORE the perf-drift gate: measured latencies retune the
            # dispatch-time steal trigger even when perf-drift monitoring
            # (refits) is disabled — stealing reacts to hardware drift
            # *between* refits, which is exactly its job
            self.rescheduler.observe_latency(rank_loads, rank_latencies)
        if self.perf_detector is None:
            return None
        event = self.perf_detector.observe(rank_loads, rank_latencies)
        if event is None or not self.cfg.adaptive:
            return None
        refit = self.perf_detector.refit(event.ranks)
        if not refit:
            return None                    # not enough samples to refresh
        return self._recalibrate(event, refit_ranks=refit)

    # ------------------------------------------------------------------
    def mask_ranks(self, dead: Sequence[int]) -> PlacementUpdate:
        """Mark ranks dead and re-solve over the survivors (elastic fail
        path — ``serving/elastic.py`` routes rank-loss events here).

        ``dead`` is the *complete* dead set (replaces any previous mask;
        pass ``()`` to restore a recovered fleet). The re-solve is always
        full: dead ranks come back as all-phantom zero-share windows
        (``SolveContext.dead_ranks``), so dispatch stops sending them
        tokens while the slot-table geometry stays put.
        """
        dead_set = tuple(sorted(set(int(g) for g in dead)))
        for g in dead_set:
            if not 0 <= g < self.G:
                raise ValueError(f"rank {g} outside [0, {self.G})")
        if len(dead_set) >= self.G:
            raise ValueError("cannot mask every rank — no survivors")
        return self._set_dead(dead_set, FailEvent(dead_set, kind="fail"))

    def unmask_ranks(self, ranks: Sequence[int]) -> PlacementUpdate:
        """Bring recovered ranks back into the fleet (elastic *grow*, the
        inverse of :meth:`mask_ranks` — ``serving/elastic.recover_rank``
        routes rank-recovery events here).

        ``ranks`` are the ranks to unmask; each must currently be dead.
        The re-solve is full over the enlarged survivor set, so traffic
        shares flow back onto the recovered ranks and the weight
        rehydration shows up as ``moved_experts``/``migration_bytes`` on
        the returned update (event kind ``"recover"``). A fail→recover
        round trip with no interleaved observations restores the healthy
        placement bit-identically (pinned by property test).
        """
        up_set = tuple(sorted(set(int(g) for g in ranks)))
        if not up_set:
            raise ValueError("no ranks to unmask")
        dead = set(self.dead_ranks)
        for g in up_set:
            if not 0 <= g < self.G:
                raise ValueError(f"rank {g} outside [0, {self.G})")
            if g not in dead:
                raise ValueError(f"rank {g} is not dead — nothing to unmask")
        new_dead = tuple(sorted(dead - set(up_set)))
        return self._set_dead(new_dead, FailEvent(up_set, kind="recover"))

    def _set_dead(self, dead_set: Tuple[int, ...],
                  event: FailEvent) -> PlacementUpdate:
        """Shared rank-lifecycle transition: install the new dead set,
        full re-solve over the survivors, account the migration, reset the
        rescheduler and cool down both drift monitors."""
        self.dead_ranks = dead_set
        w = self.profiler.window_matrix()
        old = self.placement
        new = self._solve(w)
        moved = new.moved_experts(old)
        upd = PlacementUpdate(
            step=self._step, event=event, placement=new,
            moved_experts=moved,
            migration_bytes=moved * self.cfg.expert_bytes,
            full_resolve=True)
        self.placement = new
        if self.rescheduler is not None:
            self.rescheduler.reset(new)
        self.detector.snapshot()
        if self.perf_detector is not None:
            self.perf_detector.snapshot()
        self.updates.append(upd)
        return upd

    # ------------------------------------------------------------------
    def _recalibrate(self, event: Union[DriftEvent, PerfDriftEvent],
                     refit_ranks: Tuple[int, ...] = ()) -> PlacementUpdate:
        w = self.profiler.window_matrix()
        old = self.placement
        if event.kind in ("stress", "perf") \
                and self.cfg.full_resolve_on_stress:
            # stress: the operating point of every f_g moved; perf: the
            # f_g curves themselves moved → full re-solve with the fresh
            # estimates (still same machinery).
            incremental = False
        else:
            incremental = self.policy.capabilities.supports_incremental
        if self.dead_ranks:
            # swap-based refinement is blind to the mask — it would happily
            # move copies back onto a dead rank. Full re-solves go through
            # the masked path in policy.solve.
            incremental = False
        if incremental:
            res: IncrementalResult = self.policy.refine(old, self._context(w))
            new, moved = res.placement, res.moved_expert_count()
            upd = PlacementUpdate(
                step=self._step, event=event, placement=new,
                moved_experts=moved,
                migration_bytes=moved * self.cfg.expert_bytes,
                swaps_per_layer=res.per_layer_swaps,
                refit_ranks=refit_ranks)
        else:
            # full greedy re-solve (the paper's contrast for eplb-style
            # policies; also the stress/perf-event path for every policy).
            # ``moved_experts`` counts changed (layer, slot) residents, so
            # every migrated *copy* is charged expert_bytes.
            new = self._solve(w)
            moved = new.moved_experts(old)
            upd = PlacementUpdate(
                step=self._step, event=event, placement=new,
                moved_experts=moved,
                migration_bytes=moved * self.cfg.expert_bytes,
                full_resolve=True, refit_ranks=refit_ranks)
        self.placement = upd.placement
        if self.rescheduler is not None:
            # recalibration restarts the responsive shares from the fresh
            # plan — post-migration tallies reflect the new layout
            self.rescheduler.reset(upd.placement)
        # cool down BOTH monitors: the rearrangement perturbs routing and
        # latency telemetry alike (transient migration burst, Appendix A.1)
        self.detector.snapshot()
        if self.perf_detector is not None:
            self.perf_detector.snapshot()
        self.updates.append(upd)
        return upd
