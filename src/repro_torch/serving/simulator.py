"""Discrete-event multi-device EP serving simulator (DESIGN.md §4).

This CPU host has one device, so multi-GPU variability cannot be *measured*
here; it is *modeled*: per-device ground-truth latency functions come from
:mod:`repro_torch.core.variability` (calibrated to the paper's measured regimes),
per-layer expert loads come from the workload routing profiles (or from real
JAX router tallies via the engine), and placement comes from the real
solvers. The simulator then plays the paper's synchronized-EP execution
model:

    step = Σ_layers [ t_attn + t_a2a + max_g f_g(n_g) ]  (+ dense-TP layers)

with continuous batching, prefill/decode separation (the paper emulates
disaggregation, §5.1), drift-aware recalibration events and their migration
stalls (Fig 12). Every paper figure regenerates through this path — and a
real deployment would use the same class for what-if placement scoring, so
it is a first-class library feature, not scaffolding.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (ClusterVariability, Placement,
                        VariabilityEvent, ViBEController)
from repro_torch.core.placement import copy_enumeration, pad_phantom_column
from .config import SimConfig
from .kvcache import PagedKVCache
from .metrics import RequestRecord
from .scheduler import Action, RequestView, SchedulerContext, get_scheduler
from .workload import (Request, WorkloadSpec, routing_profile, step_loads,
                       topic_loadings)

__all__ = ["SimConfig", "EPSimulator", "rank_latency_matrix", "LayerStats",
           "realized_rank_loads", "capacity_bucket_rows"]


def capacity_bucket_rows(tokens: float, top_k: int, n_slots: int,
                         capacity_factor: float) -> int:
    """Token rows the fixed-bucket (capacity) kernel allocates per slot.

    Single source for every capacity *pricing* consumer (simulator, engine
    virtual clock, benches) so they cannot drift apart. The model layer's
    per-device capacity additionally rounds up to a multiple of 4 from its
    *local* token count (MXU alignment, ``moe_layer``); pricing stays at
    this abstract global level on purpose.
    """
    return max(int(np.ceil(tokens * top_k / n_slots * capacity_factor)), 1)


# ---------------------------------------------------------------------------
# vectorized ground-truth timing
# ---------------------------------------------------------------------------

def rank_latency_matrix(cluster: ClusterVariability, n_lg: np.ndarray,
                        rng: Optional[np.random.Generator] = None,
                        t: float = 0.0) -> np.ndarray:
    """(L, G) per-rank token loads → (L, G) ground-truth MoE kernel seconds.

    Vectorized version of ``ClusterVariability.latency`` (same formula),
    evaluated at virtual-clock time ``t`` so scheduled drift events
    (thermal ramps, power caps, replacements) show up in simulated and
    engine-clocked latencies alike. The per-rank loads already reflect
    replica-aware splitting when they come from
    ``ReplicatedPlacement.rank_loads`` (each expert's tokens are divided
    over its copies by the solver's traffic shares), so latency projection
    is placement-representation-agnostic.
    """
    n = np.maximum(np.asarray(n_lg, dtype=np.float64), 0.0)
    stress = np.clip(n / cluster.n_tdp, 0.0, 1.0) ** cluster.stress_gamma
    base = cluster.base_speeds_at(t) if cluster.events else cluster.speeds
    speed = 1.0 - (cluster.throttle + (1.0 - base[None, :])) * stress
    if cluster.events:
        speed = speed * cluster.multipliers_at(t)[None, :]
    speed = np.maximum(speed, 0.1)
    flops = 2.0 * n * cluster.d_model * cluster.d_ff * 3.0
    t_mem = cluster.weight_bytes / cluster.hbm_bw
    lat = cluster.t_base + np.maximum(t_mem,
                                      flops / cluster.peak_flops) / speed
    if rng is not None and cluster.jitter_sigma > 0:
        lat = lat * (1.0 + rng.normal(0.0, cluster.jitter_sigma,
                                      size=lat.shape))
    return np.maximum(lat, 1e-9)


def realized_rank_loads(placement, loads: np.ndarray) -> np.ndarray:
    """(L, E) expert loads → (L, G) per-rank loads as *dispatch* realizes them.

    ``Placement.rank_loads`` scores the solver's intended split — for a
    ``ReplicatedPlacement`` that means fractional tokens per copy. The real
    model layer sends whole tokens: each assignment picks one copy by
    inverse-CDF over the share table (models/moe.py ``_select_slots``).
    This scores that token-granular dispatch: each expert's integer load is
    apportioned over its copies by largest-remainder rounding of the shares
    — the allocation the hash-based selection converges to, exact to ±1
    token per copy. Singleton placements pass through unchanged (one copy
    holds all of an expert's tokens either way), so the function is
    placement-representation-agnostic like ``rank_latency_matrix``.

    Fully vectorized (this runs per simulated step, and the engine's
    virtual clock calls it per engine step): copies are grouped with the
    canonical ``copy_enumeration``, and the largest-remainder top-up is a
    second in-run ranking by descending fractional part.
    """
    loads = np.atleast_2d(np.asarray(loads, dtype=np.float64))
    share = getattr(placement, "share", None)
    if share is None:
        return placement.rank_loads(loads)
    se = placement.slot_expert
    L, S = se.shape
    E = placement.n_experts
    rows = np.arange(L)[:, None]
    # phantom slots (ids == E, budget padding) get a sentinel column with
    # zero load, zero share, and a unit denominator so they contribute
    # nothing without tripping 0/0
    loads_pad = pad_phantom_column(loads)
    order, e_sorted, _ = copy_enumeration(se)
    sh = np.take_along_axis(share, order, axis=1)
    denom = np.zeros((L, E + 1))
    np.add.at(denom, (rows, e_sorted), sh)
    denom[:, E] = 1.0
    exact = sh / denom[rows, e_sorted] * loads_pad[rows, e_sorted]
    base = np.floor(exact)
    base_sum = np.zeros((L, E + 1))
    np.add.at(base_sum, (rows, e_sorted), base)
    rem = np.maximum(np.round(loads_pad - base_sum), 0.0)  # leftovers (L, E+1)
    rem[:, E] = 0.0
    # rank copies within each expert's run by descending fractional part
    # (stable → slot order breaks ties, matching the copy axis); the first
    # rem[l, e] of them absorb one leftover token each
    frac = exact - base
    key = e_sorted.astype(np.float64) * 2.0 + (1.0 - frac)
    ford = np.argsort(key, axis=1, kind="stable")
    e_f = np.take_along_axis(e_sorted, ford, axis=1)
    pos = np.arange(S)[None, :]
    new_run = np.concatenate(
        [np.ones((L, 1), bool), e_f[:, 1:] != e_f[:, :-1]], axis=1)
    run_start = np.maximum.accumulate(np.where(new_run, pos, 0), axis=1)
    bump = ((pos - run_start) < rem[rows, e_f]).astype(np.float64)
    slot_tok = np.zeros((L, S))
    slot_tok[rows, np.take_along_axis(order, ford, axis=1)] = \
        np.take_along_axis(base, ford, axis=1) + bump
    return slot_tok.reshape(L, placement.n_ranks,
                            placement.slots_per_rank).sum(axis=2)


@dataclasses.dataclass
class LayerStats:
    """Per-step MoE layer accounting (feeds Figs 1, 6, 10)."""
    rank_time: np.ndarray            # (L, G)
    rank_load: np.ndarray            # (L, G)

    @property
    def layer_time(self) -> np.ndarray:
        return self.rank_time.max(axis=1)

    @property
    def latency_gap(self) -> np.ndarray:
        return self.rank_time.max(axis=1) - self.rank_time.min(axis=1)

    @property
    def barrier_idle(self) -> float:
        return float((self.rank_time.max(axis=1, keepdims=True)
                      - self.rank_time).sum())


# ---------------------------------------------------------------------------
# simulator
# ---------------------------------------------------------------------------

# SimConfig moved to serving/config.py (frozen, part of the unified
# ServingConfig hierarchy); re-exported here for back-compat. The
# ``moe_impl`` semantics are unchanged: "ragged" (default, matches the
# model layer's dropless default and the historical simulator behaviour)
# prices the realized routed tokens; "capacity" prices the fixed-bucket
# kernel honestly — every rank runs slots_per_rank × capacity rows
# (zero-padding included) regardless of skew, and per-slot overflow is
# tallied into ``dropped_assignments`` instead of adding compute.


class EPSimulator:
    """Serving simulator for one model on one variability cluster."""

    def __init__(self, model: ArchConfig, cluster: ClusterVariability,
                 workload: WorkloadSpec, sim: SimConfig = SimConfig(),
                 controller: Optional[ViBEController] = None,
                 placement: Optional[Placement] = None,
                 profile: Optional[np.ndarray] = None):
        if not model.is_moe:
            raise ValueError("EPSimulator requires an MoE model config")
        if sim.moe_impl not in ("ragged", "capacity"):
            raise ValueError("moe_impl must be 'ragged' or 'capacity', "
                             f"got {sim.moe_impl!r}")
        self.model = model
        self.cluster = cluster
        self.workload = workload
        self.cfg = sim
        self.L = model._n_moe_layers()
        self.E = model.n_experts
        self.G = sim.ep_degree
        self.controller = controller
        self._static_placement = placement
        self.profile = (profile if profile is not None
                        else routing_profile(workload, self.L, self.E))
        self._topics = (topic_loadings(workload, self.L, self.E)
                        if workload.topic_sigma > 0 else None)
        self.rng = np.random.default_rng(sim.seed)
        # virtual-clock time of the step being simulated: run() keeps it
        # current; drift events (ClusterVariability.events) key off it
        self.now = 0.0
        # accounting
        self.layer_stats: List[LayerStats] = []
        self.rank_busy = np.zeros(self.G)
        self.total_layer_time = 0.0
        self.total_barrier_idle = 0.0
        self.dropped_assignments = 0.0   # capacity-bucket overflow (moe_impl)
        self.steps = 0
        self.migration_stalls: List[Tuple[float, float, int]] = []
        # hierarchical a2a accounting (cfg.topology set + multi-node):
        # cumulative dispatch+combine bytes by link class
        self.ici_bytes = 0.0
        self.dcn_bytes = 0.0
        if sim.topology is not None and sim.topology.n_ranks != self.G:
            raise ValueError(f"topology has {sim.topology.n_ranks} ranks "
                             f"but ep_degree is {self.G}")
        self.expert_bytes = (3 * model.d_model * model.moe_d_ff * 2
                             if model.moe_d_ff else 0)
        # dispatch-time work stealing (controller.rescheduler): track the
        # responsive-share version so each share-only update is charged
        # its table broadcast exactly once
        self.steal_updates = 0
        rs = getattr(controller, "rescheduler", None)
        self._steal_version = rs.version if rs is not None else 0
        # fault injection (inject_faults): pending specs by at_step, the
        # applied/skipped audit log, and any open dcn_degrade window
        # (virtual-time expiry, healthy cfg to restore)
        self._fault_queue: List = []
        self.fault_log: List[Tuple] = []
        self._dcn_restore: Optional[Tuple[float, SimConfig]] = None

    # -- placement ---------------------------------------------------------

    @property
    def placement(self) -> Placement:
        """What this step's dispatch routes (and is priced) against: the
        controller's responsive placement when work stealing is on (same
        slot table, steal-adjusted shares), its plan otherwise."""
        if self.controller is not None:
            return getattr(self.controller, "dispatch_placement",
                           self.controller.placement)
        if self._static_placement is None:
            raise ValueError("need controller or static placement")
        return self._static_placement

    # -- per-step timing ---------------------------------------------------

    def _draw_loads(self, tokens: int,
                    phase_scale: Optional[np.ndarray] = None) -> np.ndarray:
        prof = self.profile if phase_scale is None else \
            self.profile * phase_scale
        log_spike = 0.0
        if self._topics is not None:
            # correlated spikes: topic factors shared by the whole batch
            z = self.rng.normal(0.0, self.workload.topic_sigma,
                                size=self.workload.n_topics)
            log_spike = self._topics @ z                       # (L, E)
        if self.workload.burst_sigma > 0:
            log_spike = log_spike + self.rng.normal(
                0.0, self.workload.burst_sigma, size=prof.shape)
        if np.ndim(log_spike):
            prof = prof * np.exp(log_spike)
        prof = prof / prof.sum(axis=1, keepdims=True)
        n = tokens * self.model.top_k
        if self.cfg.poisson_loads:
            return self.rng.poisson(prof * n).astype(np.float64)
        return step_loads(prof, tokens, self.model.top_k, self.rng)

    def _attn_time(self, tokens: int, ctx: float) -> float:
        """Per-layer attention + dense-projection time (TP over G ranks)."""
        m = self.model
        proj = 4 * m.d_model * m.n_heads * m.hd        # qkvo, weighted 2x MACs
        score = 4 * ctx * m.n_heads * m.hd
        flops = self.cfg.attn_flops_scale * 2.0 * tokens * (proj + score)
        return flops / (self.G * self.cluster.peak_flops) + self.cluster.t_base

    def _a2a_time(self, tokens: int) -> float:
        """Dispatch + combine all-to-all per MoE layer (aggregate links)."""
        bw = self.cfg.ici_bw or self.cluster.ici_bw
        bytes_per_rank = (tokens * self.model.top_k * self.model.d_model
                          * self.cfg.act_bytes
                          * (self.G - 1) / (self.G * self.G))
        return 2.0 * bytes_per_rank / bw + self.cluster.t_base

    def _hier_a2a(self, pl, loads: np.ndarray) -> float:
        """Topology-priced all-to-all across all L MoE layers.

        Splits each rank's incoming tokens into intra-node (ICI) and
        cross-node (DCN) components via
        :meth:`ClusterTopology.node_split_loads` — the node-preferring
        dispatch model — and prices each class at its own link bandwidth.
        Per layer the exchange completes when the slowest rank does;
        dispatch + combine doubles the traffic. Also accumulates the
        cumulative byte split (``ici_bytes`` / ``dcn_bytes``) — the
        fig15_hier gate's metric.
        """
        topo = self.cfg.topology
        bpt = self.model.d_model * self.cfg.act_bytes   # bytes/routed token
        local_in, cross_in = topo.node_split_loads(
            pl, np.atleast_2d(np.asarray(loads, dtype=np.float64)))
        D = topo.rank_node_sizes.astype(np.float64)[None, :]     # (1, G)
        # incoming local tokens: (D-1)/D of them crossed an ICI link (the
        # rest originated on the receiving rank itself); cross-node tokens
        # all rode the DCN
        ici_b = local_in * (D - 1.0) / D * bpt                   # (L, G)
        dcn_b = cross_in * bpt
        per_rank = ici_b / topo.ici_bw + dcn_b / topo.dcn_bw
        self.ici_bytes += 2.0 * float(ici_b.sum())
        self.dcn_bytes += 2.0 * float(dcn_b.sum())
        hop = self.cluster.t_base + topo.dcn_latency
        return float((2.0 * per_rank.max(axis=1) + hop).sum())

    def _capacity_rank_loads(self, pl, loads: np.ndarray,
                             tokens: int) -> np.ndarray:
        """Fixed-bucket (moe_impl="capacity") compute pricing.

        The capacity kernel runs ``slots_per_rank × capacity`` rows on every
        rank — zero padding included — so per-rank compute is flat in the
        realized skew; what skew *does* change is the overflow, tallied into
        ``dropped_assignments`` (the artifact the ragged path removes)."""
        loads = np.atleast_2d(loads)
        n_slots = int(getattr(pl, "n_slots", self.E))
        cap = capacity_bucket_rows(tokens, self.model.top_k, n_slots,
                                   self.cfg.capacity_factor)
        share = getattr(pl, "share", None)
        if share is None:
            slot_load = loads                  # singleton: slot == expert
        else:
            slot_load = np.take_along_axis(
                pad_phantom_column(loads), pl.slot_expert, axis=1) * share
        self.dropped_assignments += float(
            np.maximum(slot_load - cap, 0.0).sum())
        if hasattr(pl, "rank_slot_budget"):
            # non-uniform budgets: each rank runs its own bucket count
            # (phantom slots allocate nothing)
            return pl.rank_slot_budget().astype(np.float64) * cap
        s_loc = max(n_slots // self.G, 1)
        return np.full((loads.shape[0], self.G), float(s_loc * cap))

    def step_time(self, tokens: int, ctx: float,
                  loads: Optional[np.ndarray] = None) -> float:
        """One synchronized forward pass over all layers."""
        if loads is None:
            loads = self._draw_loads(tokens)
        pl = self.placement
        # replica-aware dispatch: ReplicatedPlacement splits each expert's
        # tokens over its copies (speed-proportional shares); singleton
        # placements map expert→rank one-to-one. Same call either way.
        # ``realized_loads`` swaps the fractional split for the
        # token-granular one the model-layer dispatch actually produces.
        # ``moe_impl="capacity"`` instead prices the fixed-bucket kernel's
        # padded compute (+ overflow drop accounting).
        if self.cfg.moe_impl == "capacity":
            rank_load = self._capacity_rank_loads(pl, loads, tokens)
        else:
            rank_load = (realized_rank_loads(pl, loads)
                         if self.cfg.realized_loads
                         else pl.rank_loads(loads))              # (L, G)
        rank_time = rank_latency_matrix(self.cluster, rank_load, self.rng,
                                        t=self.now)
        layer_t = rank_time.max(axis=1)
        moe_t = float(layer_t.sum())
        self.rank_busy += rank_time.sum(axis=0)
        self.total_layer_time += moe_t
        self.total_barrier_idle += float(
            (layer_t[:, None] - rank_time).sum())
        if self.cfg.record_layer_stats:
            self.layer_stats.append(LayerStats(rank_time, rank_load))
        self.steps += 1

        topo = self.cfg.topology
        if topo is not None and not topo.is_flat:
            t = moe_t + self._hier_a2a(pl, loads)
        else:
            t = moe_t + self.L * self._a2a_time(tokens)
        t += self.model.n_layers * self._attn_time(tokens, ctx)
        t += self.cfg.step_overhead

        t += self.observe_step(loads, tokens, latencies=(rank_load, rank_time))
        return t

    def observe_step(self, tallies, tokens: float, latencies=None) -> float:
        """Feed one step's telemetry; returns migration-stall seconds.

        The unified observation surface (same shape as
        ``Engine.observe_step``). Performance-drift feed first (§4.2.4
        f_g refresh): the jittered per-rank ``latencies`` —
        ``(rank_load, rank_time)`` — ARE the serving telemetry a real
        deployment would measure. Then the routing feed (``tallies``,
        per-expert loads). Each can fire its own recalibration; both
        charge a migration stall (returned, so external callers can add
        it to their clock the way ``step_time`` does internally).
        """
        if self.controller is None:
            return 0.0
        stall = 0.0
        recalibrated = False
        if latencies is not None:
            rank_load, rank_time = latencies
            upd = self.controller.observe_latency(rank_load, rank_time)
            recalibrated |= upd is not None
            stall += self._account_update(upd, tokens)
        upd = self.controller.observe(tallies, tokens=float(tokens))
        recalibrated |= upd is not None
        stall += self._account_update(upd, tokens)
        rs = getattr(self.controller, "rescheduler", None)
        if rs is not None and rs.version != self._steal_version:
            if not recalibrated:
                # share-only steal update: the fleet syncs just the new
                # CDF table — no weights move (a recalibration's migration
                # stall already covers its own table rebuild)
                topo = self.cfg.topology
                if topo is not None:
                    stall += topo.broadcast_cost(rs.share_table_bytes)
                else:
                    bw = self.cfg.ici_bw or self.cluster.ici_bw
                    stall += rs.share_table_bytes / bw
                self.steal_updates += 1
            self._steal_version = rs.version
        return stall

    def _account_update(self, upd, tokens: int) -> float:
        """Migration stall (coordination + weight transfer) for one
        recalibration, or 0.0 when none fired."""
        if upd is None:
            return 0.0
        moved_bytes = upd.moved_experts * self.expert_bytes
        topo = self.cfg.topology
        if topo is not None:
            # G concurrent links; flat degenerate = bytes / (G * ici_bw),
            # exactly the legacy divide below
            xfer = topo.migration_cost(moved_bytes, parallel_links=self.G)
        else:
            bw = self.cfg.ici_bw or self.cluster.ici_bw
            xfer = moved_bytes / (self.G * bw)
        stall = self.cfg.migration_overhead + xfer
        self.migration_stalls.append((stall, float(tokens),
                                      upd.moved_experts))
        return stall

    # -- fault injection ----------------------------------------------------

    def inject_faults(self, schedule) -> None:
        """Arm a :class:`~repro_torch.serving.faults.FaultSchedule`: the next
        ``run`` applies each spec once ``self.steps`` reaches its
        ``at_step``. Rank faults route through the controller's
        mask/unmask re-solve (migration stall charged like a
        recalibration); ``transient_stall`` composes with the live
        variability scenario; ``dcn_degrade`` shrinks ``cfg.topology``'s
        cross-node bandwidth for its duration. Infeasible specs are
        logged in ``fault_log``, never raised."""
        self._fault_queue = list(schedule.faults)
        self.fault_log = []
        self._dcn_restore = None

    def _poll_faults(self, t: float) -> float:
        """Apply due faults at step granularity; returns stall seconds."""
        if self._dcn_restore is not None and t >= self._dcn_restore[0]:
            self.cfg = self._dcn_restore[1]
            self._dcn_restore = None
        stall = 0.0
        while self._fault_queue and self._fault_queue[0].at_step <= self.steps:
            stall += self._apply_fault(self._fault_queue.pop(0), t)
        return stall

    def _flush_faults(self, t: float) -> None:
        """Drain the fault queue when traffic ends before the schedule
        does (same contract as the engine drill's flush): every fault is
        still exercised — a late ``rank_recover`` must restore the fleet
        even if the last request finished first — and any open DCN
        window is closed."""
        while self._fault_queue:
            self._apply_fault(self._fault_queue.pop(0), t)
        if self._dcn_restore is not None:
            self.cfg = self._dcn_restore[1]
            self._dcn_restore = None

    def _apply_fault(self, spec, t: float) -> float:
        ctl = self.controller
        if spec.kind in ("rank_fail", "rank_recover"):
            if ctl is None:
                self.fault_log.append((spec, "skipped: no controller"))
                return 0.0
            try:
                if spec.kind == "rank_fail":
                    if spec.rank in ctl.dead_ranks:
                        self.fault_log.append(
                            (spec, f"skipped: rank {spec.rank} already dead"))
                        return 0.0
                    if len(ctl.dead_ranks) + 1 >= ctl.G:
                        self.fault_log.append(
                            (spec, "skipped: would kill the last survivor"))
                        return 0.0
                    upd = ctl.mask_ranks(
                        tuple(set(ctl.dead_ranks) | {spec.rank}))
                else:
                    if spec.rank not in ctl.dead_ranks:
                        self.fault_log.append(
                            (spec, f"skipped: rank {spec.rank} is not dead"))
                        return 0.0
                    upd = ctl.unmask_ranks((spec.rank,))
            except ValueError as e:
                # e.g. a singleton policy that cannot tile the survivors
                self.fault_log.append((spec, f"skipped: {e}"))
                return 0.0
            self.fault_log.append((spec, "applied"))
            return self._account_update(upd, 0)
        if spec.kind == "transient_stall":
            self.cluster.events.append(VariabilityEvent(
                "transient", t_start=t, magnitude=spec.magnitude,
                device=spec.rank if spec.rank >= 0 else None,
                duration=spec.duration))
            self.fault_log.append((spec, "applied"))
            return 0.0
        # dcn_degrade
        topo = self.cfg.topology
        if topo is None:
            self.fault_log.append(
                (spec, "skipped: no fleet topology (flat pricing)"))
            return 0.0
        healthy = self.cfg if self._dcn_restore is None \
            else self._dcn_restore[1]
        self.cfg = dataclasses.replace(self.cfg, topology=dataclasses.replace(
            topo, dcn_bw=topo.dcn_bw * (1.0 - spec.magnitude)))
        self._dcn_restore = (t + spec.duration, healthy)
        self.fault_log.append((spec, "applied"))
        return 0.0

    # -- event loop (continuous batching, prefill-priority) ----------------

    def run(self, requests: Sequence[Request], phase: str = "mixed",
            drift_profile: Optional[np.ndarray] = None,
            drift_at: Optional[float] = None) -> List[RequestRecord]:
        """Serve a request trace. ``phase``: "mixed" | "prefill" | "decode".

        * prefill: paper's prefill isolation (long input, 1 output token).
        * decode:  warm prefix cache — prompt cost skipped (paper §5.1).
        * drift_profile/drift_at: swap the routing profile at a given time
          (the SG→SN / SN→SG transitions of §5.4).

        With ``cfg.scheduler`` set the loop is scheduler-driven
        (:meth:`_run_scheduled`): chunked prefill, SLO-aware ordering and
        optional paged-KV admission. ``cfg.scheduler=None`` keeps this
        legacy prefill-priority whole-prompt loop byte-for-byte.
        """
        if self.cfg.scheduler is not None:
            return self._run_scheduled(requests, phase, drift_profile,
                                       drift_at)
        recs = {r.req_id: RequestRecord(r.req_id, r.arrival, r.prompt_len,
                                        r.output_len, tenant=r.tenant)
                for r in requests}
        arrivals = collections.deque(sorted(requests, key=lambda r: r.arrival))
        waiting: collections.deque = collections.deque()
        running: List[List] = []      # [req, tokens_left, ctx]
        t = 0.0
        switched = False

        while arrivals or waiting or running:
            self.now = t                      # drift events key off this
            t += self._poll_faults(t)         # injected faults (chaos)
            self.now = t
            if drift_at is not None and not switched and t >= drift_at:
                self.profile = drift_profile
                switched = True
            # admit arrivals
            while arrivals and arrivals[0].arrival <= t:
                waiting.append(arrivals.popleft())
            if not waiting and not running:
                if arrivals:
                    t = arrivals[0].arrival
                    continue
                break

            if waiting:
                # prefill step: chunk of whole prompts under the token budget
                batch, toks = [], 0
                while waiting and (not batch or
                                   toks + waiting[0].prompt_len
                                   <= self.cfg.max_prefill_tokens):
                    r = waiting.popleft()
                    batch.append(r)
                    toks += r.prompt_len
                ctx = np.mean([r.prompt_len for r in batch]) / 2
                dt = (self.step_time(toks, ctx) if phase != "decode"
                      else self.cluster.t_base)
                t += dt
                for r in batch:
                    recs[r.req_id].first_token_at = t
                    if r.output_len <= 1 or phase == "prefill":
                        recs[r.req_id].finished_at = t
                    else:
                        running.append([r, r.output_len - 1, r.prompt_len])
                continue

            # decode step: one token for up to max_batch running seqs
            batch = running[:self.cfg.max_batch]
            toks = len(batch)
            ctx = float(np.mean([b[2] for b in batch]))
            dt = self.step_time(toks, ctx)
            t += dt
            done = []
            for b in batch:
                b[1] -= 1
                b[2] += 1
                if b[1] <= 0:
                    recs[b[0].req_id].finished_at = t
                    done.append(b)
            for b in done:
                running.remove(b)
        self._flush_faults(t)
        return list(recs.values())

    # -- event loop (scheduler-driven: chunked prefill, SLO ordering) -------

    def _run_scheduled(self, requests: Sequence[Request], phase: str,
                       drift_profile: Optional[np.ndarray],
                       drift_at: Optional[float]) -> List[RequestRecord]:
        """Scheduler-driven serving loop (``cfg.scheduler`` set).

        Per step a registered scheduler picks a prefill batch (all its
        chunks run in one synchronized step under the
        ``max_prefill_tokens`` budget, each priced at its own context
        depth) or a decode step. ``cfg.kv`` adds paged-KV admission:
        requests wait until the block pool can commit their full
        reservation. ``cfg.kv=None`` keeps admission unbounded (legacy).
        """
        sched_cfg = self.cfg.scheduler
        scheduler = get_scheduler(sched_cfg.name)
        kv = PagedKVCache(self.cfg.kv) if self.cfg.kv is not None else None
        recs = {r.req_id: RequestRecord(r.req_id, r.arrival, r.prompt_len,
                                        r.output_len, tenant=r.tenant)
                for r in requests}
        by_id = {r.req_id: r for r in requests}
        arrivals = collections.deque(sorted(requests,
                                            key=lambda r: r.arrival))
        waiting: collections.deque = collections.deque()
        prefilling: Dict[int, int] = {}   # req_id -> prompt tokens done
        running: List[List] = []          # [req, tokens_left, ctx]
        t = 0.0
        streak = 0
        switched = False

        while arrivals or waiting or prefilling or running:
            self.now = t
            t += self._poll_faults(t)         # injected faults (chaos)
            self.now = t
            if drift_at is not None and not switched and t >= drift_at:
                self.profile = drift_profile
                switched = True
            while arrivals and arrivals[0].arrival <= t:
                waiting.append(arrivals.popleft())
            if not waiting and not prefilling and not running:
                t = arrivals[0].arrival
                continue

            wviews = []
            for r in waiting:
                if kv is not None and not kv.can_admit(r.prompt_len
                                                       + r.output_len):
                    continue
                wviews.append(RequestView(r.req_id, r.arrival, r.prompt_len,
                                          r.output_len, 0, r.ttft_slo))
            pviews = [RequestView(by_id[i].req_id, by_id[i].arrival,
                                  by_id[i].prompt_len, by_id[i].output_len,
                                  done, by_id[i].ttft_slo)
                      for i, done in prefilling.items()]
            action = scheduler.schedule(SchedulerContext(
                now=t, config=sched_cfg, waiting=wviews, prefilling=pviews,
                n_running=len(running), prefill_streak=streak,
                can_start=len(wviews),
                chunk_budget=self.cfg.max_prefill_tokens))

            if action.kind == "prefill":
                # admission pass: earlier admissions in the same batch
                # shrink the pool, so re-check each new request against
                # the live allocator state (the view was a snapshot)
                chunks = []
                for c in action.chunks:
                    r = by_id[c.req_id]
                    if c.req_id not in prefilling:
                        if kv is not None and not kv.can_admit(
                                r.prompt_len + r.output_len):
                            continue
                        waiting.remove(r)
                        if kv is not None:
                            kv.allocate(r.req_id,
                                        r.prompt_len + r.output_len)
                        prefilling[c.req_id] = 0
                    chunks.append(c)
                if chunks:
                    # one synchronized step runs the whole chunk batch;
                    # each chunk priced at its own attention depth
                    toks = sum(c.n_tokens for c in chunks)
                    depths = [prefilling[c.req_id] + c.n_tokens / 2
                              for c in chunks]
                    ctx = float(np.mean(depths))
                    dt = (self.step_time(toks, ctx) if phase != "decode"
                          else self.cluster.t_base)
                    t += dt
                    for c in chunks:
                        r = by_id[c.req_id]
                        if kv is not None:
                            kv.advance(r.req_id, c.n_tokens)
                        prefilling[c.req_id] += c.n_tokens
                        if prefilling[c.req_id] >= r.prompt_len:
                            del prefilling[c.req_id]
                            recs[r.req_id].first_token_at = t
                            if r.output_len <= 1 or phase == "prefill":
                                recs[r.req_id].finished_at = t
                                if kv is not None:
                                    kv.free_seq(r.req_id)
                            else:
                                running.append([r, r.output_len - 1,
                                                r.prompt_len])
                    streak += 1
                    continue
                # every candidate lost admission since the snapshot —
                # behave as if the scheduler had answered decode/idle
                action = Action("decode") if running else Action("idle")

            if action.kind == "decode":
                batch = running[:self.cfg.max_batch]
                toks = len(batch)
                ctx = float(np.mean([b[2] for b in batch]))
                dt = self.step_time(toks, ctx)
                t += dt
                done = []
                for b in batch:
                    b[1] -= 1
                    b[2] += 1
                    if kv is not None:
                        kv.extend(b[0].req_id)
                    if b[1] <= 0:
                        recs[b[0].req_id].finished_at = t
                        done.append(b)
                        if kv is not None:
                            kv.free_seq(b[0].req_id)
                for b in done:
                    running.remove(b)
                streak = 0
                continue

            # idle: nothing runnable now — jump to the next arrival, or
            # give up if KV admission can never be satisfied (requests
            # too large for the pool with nothing in flight to free)
            if arrivals:
                t = arrivals[0].arrival
                continue
            break
        self._flush_faults(t)
        return list(recs.values())

    # -- summary helpers ----------------------------------------------------

    def utilization_spread(self) -> np.ndarray:
        """Per-rank busy-time share (Fig 10b frequency-uniformity proxy)."""
        total = self.rank_busy.sum()
        return self.rank_busy / total if total else self.rank_busy
