"""Pluggable placement-policy registry: the baseline family as plugins.

The paper's evaluation matrix (and the related-work baselines — GEM's
variability-aware expert-to-GPU mapping, HarMoEny's redundant-sharding load
balancing) is a *family* of placement strategies. This module makes that
family open-ended: a placement policy is any object satisfying the
:class:`PlacementPolicy` protocol —

* ``name`` — the registry key (what ``--policy`` accepts end to end),
* ``capabilities`` — :class:`PolicyCapabilities` flags consumers branch on
  (instead of comparing policy name strings),
* ``solve(ctx) -> ReplicatedPlacement`` — full solve from a
  :class:`SolveContext` (activation matrix, perf models, per-rank slot
  budgets). Always returns the *unified* replicated representation;
  singleton strategies return the r_max = 1 degenerate.
* optional ``refine(placement, ctx) -> IncrementalResult`` — minimal-
  movement recalibration (Algorithm 2), advertised via
  ``capabilities.supports_incremental``.

Registering a policy (one file, no core edits) exposes it everywhere at
once: ``ViBEConfig``/``ViBEController`` recalibration, the serving engine,
``launch/serve.py --policy`` choices, ``training/elastic.py`` re-planning,
and every benchmark sweep that enumerates :func:`registered_policies`.

    from repro_torch.core.policy import (PolicyCapabilities, SolveContext,
                                   register_policy)

    @register_policy
    class RandomPolicy:
        name = "random"
        capabilities = PolicyCapabilities()
        def solve(self, ctx):
            rng = np.random.default_rng(0)
            assign = np.stack([rng.permutation(ctx.n_experts) % ctx.n_ranks
                               for _ in range(ctx.n_layers)])
            return ReplicatedPlacement.from_singleton(
                Placement(assign, ctx.n_ranks))
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Protocol, Sequence, Tuple, runtime_checkable

import numpy as np

from .incremental import IncrementalResult, incremental_update_replicated
from .perf_model import PerfModel
from .placement import (Placement, ReplicatedPlacement, contiguous_placement,
                        eplb_placement, gem_placement, harmoeny_placement,
                        inflate_placement, normalize_slot_budget,
                        vibe_placement, vibe_r_placement)
from .topology import ClusterTopology, vibe_h_placement

__all__ = [
    "PolicyCapabilities",
    "SolveContext",
    "PlacementPolicy",
    "UnknownPolicyError",
    "register_policy",
    "get_policy",
    "registered_policies",
]


@dataclasses.dataclass(frozen=True)
class PolicyCapabilities:
    """What a placement policy consumes and supports.

    Consumers branch on these flags — never on the policy name:

    * ``workload_aware``     — the solve reads the activation matrix; if
      False (static layouts like ``contiguous``) the controller skips
      drift-triggered recalibration entirely.
    * ``needs_perf_models``  — the solve requires per-rank f_g(n) latency
      models (:class:`SolveContext.perf_models` must be set).
    * ``supports_replication`` — the solve may place multiple copies of an
      expert (returns a genuinely replicated placement; the engine must
      budget physical slots beyond one-per-expert).
    * ``supports_incremental`` — the policy implements ``refine`` (swap-
      based minimal-movement recalibration); the controller uses it for
      routing-drift events instead of a full re-solve.
    * ``accepts_slot_budget`` — the solve honours
      :class:`SolveContext.slot_budget` (per-rank physical slot counts,
      possibly non-uniform). Setting a budget for a policy without this
      capability is a configuration error.
    """

    workload_aware: bool = True
    needs_perf_models: bool = False
    supports_replication: bool = False
    supports_incremental: bool = False
    accepts_slot_budget: bool = False


@dataclasses.dataclass(frozen=True)
class SolveContext:
    """Everything a placement solve may consume, in one validated bundle.

    ``w``            — (L, E) activation matrix (per-layer expert token
                       loads from the profiler window).
    ``n_ranks``      — EP group size G.
    ``perf_models``  — per-rank f_g(n) latency models (len == G), or None
                       for hardware-oblivious policies.
    ``slot_budget``  — per-rank physical slot counts: None (policy
                       default), a scalar (uniform budget), or a (G,) array
                       (non-uniform, e.g. device memory headroom). Arrays
                       are first-class: the replicated solvers pad ranks
                       below the maximum with phantom slots.
    ``n_ref_mode``   — operating point for speed estimates ("rank" |
                       "expert", see :func:`~repro_torch.core.placement.
                       vibe_placement`).
    ``epsilon``      — incremental-refinement convergence tolerance.
    ``reweight_shares`` — re-proportion copy shares to rank speeds after a
                       swap-based refinement (replicated policies only).
    ``topology``     — optional :class:`~repro_torch.core.topology.ClusterTopology`
                       (node structure + ICI/DCN link asymmetry). ``None``
                       and flat topologies are equivalent for every
                       built-in policy; only topology-aware solvers
                       (``vibe_h``) read the node structure.
    ``dead_ranks``   — ranks currently lost to the fleet (elastic fail
                       path). When set, the built-in policies solve over
                       the survivors only (with a masked topology) and
                       re-inflate the result so dead ranks hold
                       all-phantom zero-share slot windows — dispatch
                       sends them nothing while the global slot-table
                       geometry stays put.
    """

    w: np.ndarray
    n_ranks: int
    perf_models: Optional[Sequence[PerfModel]] = None
    slot_budget: Optional[np.ndarray] = None
    n_ref_mode: str = "rank"
    epsilon: float = 0.03
    reweight_shares: bool = False
    topology: Optional[ClusterTopology] = None
    dead_ranks: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        w = np.atleast_2d(np.asarray(self.w, dtype=np.float64))
        if w.ndim != 2 or w.size == 0:
            raise ValueError(f"activation matrix must be (L, E), got {w.shape}")
        object.__setattr__(self, "w", w)
        if self.n_ranks < 1:
            raise ValueError(f"n_ranks must be >= 1, got {self.n_ranks}")
        if self.perf_models is not None:
            pm = tuple(self.perf_models)
            if len(pm) != self.n_ranks:
                raise ValueError("need one perf model per rank "
                                 f"({len(pm)} != {self.n_ranks})")
            object.__setattr__(self, "perf_models", pm)
        if self.slot_budget is not None:
            # one validation path with the solvers: scalar → (G,),
            # shape/min checks, and feasibility (Σ ≥ E, max ≤ E) — so
            # infeasible budgets fail here at the boundary, before any
            # policy (including third-party ones) reads the context
            object.__setattr__(
                self, "slot_budget",
                normalize_slot_budget(self.slot_budget, self.n_experts,
                                      self.n_ranks))
        if self.topology is not None \
                and self.topology.n_ranks != self.n_ranks:
            raise ValueError(f"topology has {self.topology.n_ranks} ranks "
                             f"but n_ranks={self.n_ranks}")
        if self.dead_ranks is not None:
            dead = tuple(sorted(set(int(g) for g in self.dead_ranks)))
            if dead and (dead[0] < 0 or dead[-1] >= self.n_ranks):
                raise ValueError(f"dead_ranks {dead} outside "
                                 f"[0, {self.n_ranks})")
            if len(dead) >= self.n_ranks:
                raise ValueError("cannot mark every rank dead")
            object.__setattr__(self, "dead_ranks", dead or None)

    @property
    def n_layers(self) -> int:
        return self.w.shape[0]

    @property
    def n_experts(self) -> int:
        return self.w.shape[1]


@runtime_checkable
class PlacementPolicy(Protocol):
    """Protocol every registered placement policy satisfies."""

    name: str
    capabilities: PolicyCapabilities

    def solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        """Full placement solve → unified replicated representation."""
        ...


class UnknownPolicyError(ValueError):
    """Raised for a policy name absent from the registry."""


_REGISTRY: Dict[str, PlacementPolicy] = {}


def register_policy(policy, *, replace: bool = False):
    """Add a policy to the registry; usable as a class decorator.

    Accepts a :class:`PlacementPolicy` instance or a zero-arg class (which
    is instantiated). Duplicate names raise unless ``replace=True``.
    Returns the argument unchanged so decorated classes stay usable.
    """
    inst = policy() if isinstance(policy, type) else policy
    name = getattr(inst, "name", "")
    if not name or not isinstance(name, str):
        raise ValueError("placement policy needs a non-empty string .name")
    if not isinstance(inst, PlacementPolicy):
        raise TypeError(f"{name!r} does not satisfy the PlacementPolicy "
                        "protocol (name/capabilities/solve)")
    if inst.capabilities.supports_incremental \
            and not callable(getattr(inst, "refine", None)):
        raise TypeError(
            f"{name!r} advertises supports_incremental but implements no "
            "refine(placement, ctx) — the controller would crash on the "
            "first routing-drift recalibration")
    if name in _REGISTRY and not replace:
        raise ValueError(f"placement policy {name!r} already registered "
                         "(pass replace=True to override)")
    _REGISTRY[name] = inst
    return policy


def get_policy(name: str) -> PlacementPolicy:
    """Registry lookup; unknown names list what *is* registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownPolicyError(
            f"unknown placement policy {name!r}; registered policies: "
            f"{', '.join(registered_policies())}") from None


def registered_policies() -> Tuple[str, ...]:
    """Sorted names of all registered policies (drives CLI choices and
    benchmark sweeps)."""
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# built-in policies
# ---------------------------------------------------------------------------

class _BuiltinPolicy:
    """Shared context validation + capability-gated refine plumbing."""

    name: str = ""
    capabilities = PolicyCapabilities()

    def validate(self, ctx: SolveContext) -> None:
        caps = self.capabilities
        if caps.needs_perf_models and ctx.perf_models is None:
            raise ValueError(f"{self.name} placement requires perf_models")
        if ctx.slot_budget is not None and not caps.accepts_slot_budget:
            raise ValueError(
                f"policy {self.name!r} does not accept a slot budget "
                "(capabilities.accepts_slot_budget=False)")

    def solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        self.validate(ctx)
        if ctx.dead_ranks:
            return self._solve_masked(ctx)
        return self._solve(ctx)

    def _solve_masked(self, ctx: SolveContext) -> ReplicatedPlacement:
        """Solve over the surviving ranks only and re-inflate: dead ranks
        come back as all-phantom zero-share windows (dispatch sends them
        nothing), so the global slot-table geometry the engine pinned at
        init survives the failure whenever the per-rank budget does."""
        from .placement import default_slots_per_rank
        dead = set(ctx.dead_ranks)
        survivors = [g for g in range(ctx.n_ranks) if g not in dead]
        Gs, E = len(survivors), ctx.n_experts
        if not self.capabilities.supports_replication and E % Gs:
            raise ValueError(
                f"policy {self.name!r} places one expert per slot and "
                f"cannot spread E={E} experts over {Gs} surviving ranks "
                "(E % survivors != 0) — elastic fail-over needs a "
                "replication-capable policy (e.g. vibe_r / vibe_h)")
        if ctx.slot_budget is not None:
            budget = ctx.slot_budget[survivors]
        else:
            # per-rank memory budgets don't change because a peer died:
            # keep the default budget of the *original* group size, bumped
            # only if the survivors can no longer hold every expert
            b = max(default_slots_per_rank(E, ctx.n_ranks),
                    -(-E // Gs))
            budget = np.full(Gs, min(b, E), dtype=np.int64)
        sub = SolveContext(
            w=ctx.w, n_ranks=Gs,
            perf_models=(tuple(ctx.perf_models[g] for g in survivors)
                         if ctx.perf_models is not None else None),
            slot_budget=(budget if self.capabilities.accepts_slot_budget
                         else None),
            n_ref_mode=ctx.n_ref_mode, epsilon=ctx.epsilon,
            reweight_shares=ctx.reweight_shares,
            topology=(ctx.topology.mask(sorted(dead))
                      if ctx.topology is not None else None))
        return inflate_placement(self._solve(sub), survivors, ctx.n_ranks)

    def refine(self, placement: ReplicatedPlacement,
               ctx: SolveContext) -> IncrementalResult:
        """Swap-based minimal-movement recalibration (Algorithm 2 at slot
        granularity; the r_max = 1 degenerate reduces to expert swaps)."""
        if not self.capabilities.supports_incremental:
            raise NotImplementedError(
                f"policy {self.name!r} has no incremental refinement "
                "(capabilities.supports_incremental=False)")
        self.validate(ctx)
        if ctx.perf_models is None:
            raise ValueError(f"{self.name} refine requires perf_models "
                             "(swap scoring evaluates f_g latency curves)")
        return incremental_update_replicated(
            placement, ctx.w, ctx.perf_models, epsilon=ctx.epsilon,
            reweight_shares=ctx.reweight_shares)

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name!r}>"


@register_policy
class ContiguousPolicy(_BuiltinPolicy):
    """vLLM default: expert e on rank e // (E/G). No workload or hardware
    awareness — the static lower bound of the sweep."""

    name = "contiguous"
    capabilities = PolicyCapabilities(workload_aware=False)

    def _solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        return ReplicatedPlacement.from_singleton(
            contiguous_placement(ctx.n_layers, ctx.n_experts, ctx.n_ranks))


@register_policy
class EplbPolicy(_BuiltinPolicy):
    """EPLB baseline: greedy token-count balancing (assumes f_g(n) = n)."""

    name = "eplb"
    capabilities = PolicyCapabilities()

    def _solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        return ReplicatedPlacement.from_singleton(
            eplb_placement(ctx.w, ctx.n_ranks))


@register_policy
class GemPolicy(_BuiltinPolicy):
    """GEM-style variability-aware greedy: hottest experts to the rank with
    the lowest predicted completion time f_g(n_g + w_e); no replication."""

    name = "gem"
    capabilities = PolicyCapabilities(needs_perf_models=True)

    def _solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        return ReplicatedPlacement.from_singleton(
            gem_placement(ctx.w, ctx.perf_models))


@register_policy
class HarmoenyPolicy(_BuiltinPolicy):
    """HarMoEny-style baseline: redundant sharding for pure load balance —
    ViBE-R's replication machinery with uniform speeds and shares."""

    name = "harmoeny"
    capabilities = PolicyCapabilities(supports_replication=True,
                                      accepts_slot_budget=True)

    def _solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        return harmoeny_placement(ctx.w, ctx.n_ranks,
                                  slots_per_rank=ctx.slot_budget)


@register_policy
class VibePolicy(_BuiltinPolicy):
    """The paper's contribution: speed-proportional token targets from the
    profiled f_g curves, greedy descending-load fill (Alg 1 Phase 2)."""

    name = "vibe"
    capabilities = PolicyCapabilities(needs_perf_models=True,
                                      supports_incremental=True)

    def _solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        return ReplicatedPlacement.from_singleton(
            vibe_placement(ctx.w, ctx.perf_models, ctx.n_ref_mode))


@register_policy
class VibeRPolicy(_BuiltinPolicy):
    """ViBE-R: slot-budget hot-expert replication + speed-proportional copy
    shares (cluster-scale extension; accepts non-uniform budgets)."""

    name = "vibe_r"
    capabilities = PolicyCapabilities(needs_perf_models=True,
                                      supports_replication=True,
                                      supports_incremental=True,
                                      accepts_slot_budget=True)

    def _solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        return vibe_r_placement(ctx.w, ctx.perf_models,
                                slots_per_rank=ctx.slot_budget,
                                n_ref_mode=ctx.n_ref_mode)


@register_policy
class VibeHPolicy(_BuiltinPolicy):
    """ViBE-H: two-level node-aware solve — experts binned across nodes to
    minimize cross-node (DCN) token traffic, then the full ViBE-R
    replication solve within each node against that node's per-rank perf
    models (see :func:`repro_torch.core.topology.vibe_h_placement`). Without a
    (multi-node) ``SolveContext.topology`` it delegates to ``vibe_r``
    exactly. No incremental refine: swap-based refinement is blind to node
    boundaries, so routing drift triggers a full (cheap, vectorized)
    re-solve instead."""

    name = "vibe_h"
    capabilities = PolicyCapabilities(needs_perf_models=True,
                                      supports_replication=True,
                                      accepts_slot_budget=True)

    def _solve(self, ctx: SolveContext) -> ReplicatedPlacement:
        return vibe_h_placement(ctx.w, ctx.perf_models, ctx.topology,
                                slots_per_rank=ctx.slot_budget,
                                n_ref_mode=ctx.n_ref_mode)
