"""Expert placement solvers (paper §4.2.3, Table 2c, Alg 1 Phase 2 + ViBE-R).

Four policies, matching the paper's evaluation matrix plus the cluster-scale
replication extension:

* :func:`contiguous_placement` — vLLM baseline: logical experts partitioned
  contiguously, expert e → rank e // (E/G). No workload or hardware awareness.
* :func:`eplb_placement` — EPLB baseline: greedy token-count balancing.
  Identical machinery to ViBE but with the implicit assumption f_g(n) = n
  (paper: "EPLB implicitly assumes f_g(n)=n, so it cannot compensate for
  hardware throughput differences").
* :func:`vibe_placement` — the paper's contribution. Per layer:
    1. speed estimate  s_g = 1 / f_g(n_ref),  n_ref = N / E (mean per-expert
       token load),
    2. token target    τ_g = N · s_g / Σ_h s_h,
    3. experts assigned in descending load order to the rank farthest below
       its target (most remaining target capacity), subject to the uniform
       slot constraint (same #experts per rank — paper §5.1 keeps memory
       uniform; non-uniform allocation is future work there, optional here).
* :func:`vibe_r_placement` — **ViBE-R**: replication-aware co-optimization
  of workload skew and hardware variability at cluster scale (paper Fig 15
  regime; HarMoEny-style redundant sharding). Under a slot budget of
  ``slots_per_rank × G`` physical slots it (a) grants extra *copies* to the
  hottest experts (greedy largest-per-copy-load splitting), (b) spreads each
  expert's traffic over its copies speed-proportionally (fast devices absorb
  a larger share), and (c) runs the whole solve vectorized across layers —
  a 64-rank × 58-layer × 256-expert model solves in milliseconds.

Singleton placements are an integer array ``assign`` of shape (E,) with
``assign[e] = rank`` per layer ((L, E) for the model); replicated placements
are a *slot table* ``slot_expert`` of shape (L, S) (logical expert held in
each physical slot, entries repeat for replicas) plus per-copy traffic
shares. Both convert to the logical→physical permutation consumed by the
JAX MoE layer (models/moe.py ``build_slots_of``).

All solvers are pure numpy host code (control plane). The greedy fills are
vectorized across layers: a Python loop runs only over the E (or S) item
*positions*, with every layer advanced simultaneously via argmax/scatter
ops — the per-layer reference implementations are kept for the equivalence
tests.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Sequence, Union

import numpy as np

from .perf_model import PerfModel

__all__ = [
    "Placement",
    "ReplicatedPlacement",
    "copy_enumeration",
    "copy_share_cdf",
    "contiguous_placement",
    "eplb_placement",
    "vibe_placement",
    "vibe_r_placement",
    "gem_placement",
    "harmoeny_placement",
    "solve_model_placement",
    "reweight_shares_by_speed",
    "placement_to_permutation",
    "permutation_to_placement",
    "predicted_layer_latency",
    "predicted_rank_latencies",
    "layer_latency_span",
    "default_slots_per_rank",
    "normalize_slot_budget",
    "pad_phantom_column",
    "inflate_placement",
    "compact_placement",
]


@dataclasses.dataclass(frozen=True)
class Placement:
    """Expert→rank assignment for every MoE layer (one copy per expert).

    ``assign``: (L, E) int array, assign[l, e] = EP rank of logical expert e.
    ``perm``:   (L, E) int array, perm[l, p] = logical expert held in physical
                slot p (slots are rank-major: rank g owns slots
                [g*E_loc, (g+1)*E_loc)). This is what the JAX layer consumes.
    """

    assign: np.ndarray
    n_ranks: int

    def __post_init__(self):
        a = np.asarray(self.assign, dtype=np.int32)
        if a.ndim == 1:
            a = a[None, :]
        object.__setattr__(self, "assign", a)
        L, E = a.shape
        if E % self.n_ranks != 0:
            raise ValueError(f"E={E} not divisible by n_ranks={self.n_ranks}")
        counts = np.apply_along_axis(np.bincount, 1, a, minlength=self.n_ranks)
        if not np.all(counts == E // self.n_ranks):
            raise ValueError("placement violates uniform slots-per-rank")

    @property
    def n_layers(self) -> int:
        return self.assign.shape[0]

    @property
    def n_experts(self) -> int:
        return self.assign.shape[1]

    @property
    def n_slots(self) -> int:
        return self.assign.shape[1]

    @property
    def experts_per_rank(self) -> int:
        return self.n_experts // self.n_ranks

    @property
    def perm(self) -> np.ndarray:
        return placement_to_permutation(self.assign, self.n_ranks)

    def rank_loads(self, w: np.ndarray) -> np.ndarray:
        """Per-rank token loads (L, G) given per-expert loads w (L, E)."""
        w = np.atleast_2d(np.asarray(w, dtype=np.float64))
        L, E = self.assign.shape
        G = self.n_ranks
        flat = (np.arange(L)[:, None] * G + self.assign).ravel()
        return np.bincount(flat, weights=w.ravel(),
                           minlength=L * G).reshape(L, G)

    def moved_experts(self, other: "Placement") -> int:
        """Number of (layer, expert) pairs whose rank differs vs ``other``."""
        return int(np.sum(self.assign != other.assign))


@dataclasses.dataclass(frozen=True)
class ReplicatedPlacement:
    """(expert, copy)→slot placement with per-copy traffic shares (ViBE-R).

    This is the *unified* placement representation: singleton placements are
    the r_max = 1 degenerate (one copy per expert, all shares 1), so every
    consumer — controller, engine, simulator, benchmarks — handles one type
    (see :meth:`from_singleton` / :meth:`to_singleton` / :attr:`assign`).

    ``slot_expert``: (L, S) int array — logical expert whose weights occupy
        physical slot s. Slots are rank-major (rank g owns
        [g*S_loc, (g+1)*S_loc)); entries *repeat* when an expert is
        replicated. Every logical expert holds ≥ 1 slot per layer. Entries
        equal to ``n_experts`` are *phantom* slots (no resident expert,
        zero share) — how a non-uniform per-rank slot budget is expressed
        over the uniform rank-major physical layout: ranks with a smaller
        budget pad their tail slots with phantoms.
    ``share``: (L, S) float array — fraction of the expert's token traffic
        dispatched to this copy; sums to 1 over the copies of each
        (layer, expert); 0 on phantom slots. The model layer approximates
        fractional shares by hashing assignments across copies; the
        solver's shares are what the latency objective (and the simulator)
        score.
    """

    slot_expert: np.ndarray
    share: np.ndarray
    n_ranks: int
    n_experts: int

    def __post_init__(self):
        se = np.atleast_2d(np.asarray(self.slot_expert, dtype=np.int32))
        sh = np.atleast_2d(np.asarray(self.share, dtype=np.float64))
        if se.shape != sh.shape:
            raise ValueError(f"slot_expert {se.shape} != share {sh.shape}")
        L, S = se.shape
        if S % self.n_ranks != 0:
            raise ValueError(f"S={S} not divisible by n_ranks={self.n_ranks}")
        if se.min() < 0 or se.max() > self.n_experts:
            raise ValueError("slot_expert ids outside [0, n_experts] "
                             f"(= {self.n_experts} marks a phantom slot)")
        counts = _replica_counts(se, self.n_experts)
        if np.any(counts == 0):
            raise ValueError("some logical expert has no physical slot")
        if sh.min() < -1e-12:
            raise ValueError("negative copy share")
        if np.any(sh[se >= self.n_experts] > 1e-12):
            raise ValueError("phantom slots cannot carry traffic share")
        sums = np.zeros((L, self.n_experts + 1))
        np.add.at(sums, (np.arange(L)[:, None],
                         np.minimum(se, self.n_experts)), sh)
        if not np.allclose(sums[:, :self.n_experts], 1.0, atol=1e-6):
            raise ValueError("copy shares must sum to 1 per (layer, expert)")
        object.__setattr__(self, "slot_expert", se)
        object.__setattr__(self, "share", sh)

    @property
    def n_layers(self) -> int:
        return self.slot_expert.shape[0]

    @property
    def n_slots(self) -> int:
        return self.slot_expert.shape[1]

    @property
    def slots_per_rank(self) -> int:
        return self.n_slots // self.n_ranks

    @property
    def perm(self) -> np.ndarray:
        """Slot table consumed by models/moe.py (entries repeat = replicas)."""
        return self.slot_expert

    @classmethod
    def from_singleton(cls, placement: "Placement") -> "ReplicatedPlacement":
        """Lift a singleton :class:`Placement` into the unified replicated
        representation (one copy per expert, unit shares)."""
        perm = placement.perm
        return cls(perm, np.ones(perm.shape, dtype=np.float64),
                   placement.n_ranks, placement.n_experts)

    def to_singleton(self) -> "Placement":
        """The inverse of :meth:`from_singleton`; only defined for the
        degenerate r_max = 1 case with no phantom slots."""
        if self.n_slots != self.n_experts or int(self.n_copies().max()) > 1:
            raise ValueError("placement is genuinely replicated (or padded); "
                             "no singleton equivalent")
        return Placement(permutation_to_placement(self.slot_expert,
                                                  self.n_ranks), self.n_ranks)

    @property
    def assign(self) -> np.ndarray:
        """(L, E) expert→rank map of the singleton degenerate (raises for a
        genuinely replicated placement) — lets Placement consumers read the
        unified type without type-switching."""
        return self.to_singleton().assign

    def n_copies(self) -> np.ndarray:
        """(L, E) replica count per logical expert (phantoms excluded)."""
        return _replica_counts(self.slot_expert, self.n_experts)

    def rank_slot_budget(self) -> np.ndarray:
        """(L, G) count of *real* (non-phantom) slots per rank — the
        per-rank slot budget the solve actually used."""
        real = (self.slot_expert < self.n_experts)
        return real.reshape(self.n_layers, self.n_ranks,
                            self.slots_per_rank).sum(axis=2)

    def copy_shares(self, r_max: Optional[int] = None) -> np.ndarray:
        """(L, E, r_max) per-copy traffic shares, copies in slot order.

        The copy axis matches the enumeration ``build_slots_of`` uses for
        its ``slots_of`` table (ascending physical slot), so index r here
        is the share of the copy living in ``slots_of[l, e, r]``. Entries
        past an expert's replica count are zero. ``r_max`` pads the copy
        axis (must be ≥ the actual maximum replica count).
        """
        se = self.slot_expert
        L, S = se.shape
        counts = self.n_copies()
        rm = int(counts.max()) if r_max is None else int(r_max)
        if rm < int(counts.max()):
            raise ValueError(f"r_max={rm} < max replica count {counts.max()}")
        order, e_sorted, occ = copy_enumeration(se)
        sh_sorted = np.take_along_axis(self.share, order, axis=1)
        out = np.zeros((L, self.n_experts, rm))
        li, si = np.nonzero(e_sorted < self.n_experts)    # skip phantoms
        out[li, e_sorted[li, si], occ[li, si]] = sh_sorted[li, si]
        return out

    def copy_cdf(self, r_max: Optional[int] = None) -> np.ndarray:
        """(L, E, r_max) cumulative copy-share table for weighted dispatch.

        This is what the model layer consumes (via ``make_moe_tables``) for
        inverse-CDF replica selection: assignment with uniform u picks the
        first copy r with u < cdf[l, e, r]. Delegates to the canonical
        :func:`copy_share_cdf` builder — one implementation for the solver
        and the model seam.
        """
        return copy_share_cdf(self.slot_expert, self.n_experts,
                              share=self.share, r_max=r_max)

    def rank_loads(self, w: np.ndarray) -> np.ndarray:
        """Per-rank token loads (L, G): expert loads split over copies."""
        L, S = self.slot_expert.shape
        slot_load = np.take_along_axis(pad_phantom_column(w),
                                       self.slot_expert, axis=1) * self.share
        return slot_load.reshape(L, self.n_ranks, self.slots_per_rank).sum(2)

    def _window_padded(self, spr: int) -> np.ndarray:
        """slot_expert with each rank's window right-padded to ``spr``
        slots with phantoms — aligns tables of different widths."""
        L, _ = self.slot_expert.shape
        se = self.slot_expert.reshape(L, self.n_ranks, self.slots_per_rank)
        out = np.full((L, self.n_ranks, spr), self.n_experts,
                      dtype=se.dtype)
        out[:, :, :self.slots_per_rank] = se
        return out.reshape(L, -1)

    def moved_experts(self, other: "ReplicatedPlacement") -> int:
        """(layer, slot) pairs whose resident expert differs vs ``other`` —
        the weight-migration volume in expert-tensor units. Tables of
        different per-rank widths (an elastic re-solve can widen the
        survivor budget) are aligned window-by-window: a slot that only
        exists on one side counts as moved unless it is a phantom."""
        if (other.n_ranks == self.n_ranks
                and other.slots_per_rank != self.slots_per_rank):
            spr = max(self.slots_per_rank, other.slots_per_rank)
            return int(np.sum(self._window_padded(spr)
                              != other._window_padded(spr)))
        return int(np.sum(self.slot_expert != other.slot_expert))


AnyPlacement = Union[Placement, ReplicatedPlacement]


def pad_phantom_column(w: np.ndarray) -> np.ndarray:
    """(L, E) expert loads → (L, E+1) with a zero column at index E.

    THE gather guard for phantom slots: a slot table may contain the
    sentinel id ``n_experts`` (budget-padding phantom), so every
    ``take_along_axis(w, slot_expert)`` must read from a padded matrix
    where the sentinel column is 0 — one helper instead of each consumer
    re-deriving the incantation (rank_loads, incremental swap loads, the
    simulator's realized-dispatch split all go through here).
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    return np.concatenate([w, np.zeros((w.shape[0], 1))], axis=1)


def _replica_counts(slot_expert: np.ndarray, n_experts: int) -> np.ndarray:
    """(L, S) slot table → (L, E) copies per logical expert (ids ≥ E are
    phantom padding and are not counted)."""
    clipped = np.minimum(slot_expert, n_experts)
    return np.apply_along_axis(np.bincount, 1, clipped,
                               minlength=n_experts + 1)[:, :n_experts]


def copy_enumeration(slot_table: np.ndarray):
    """Canonical copy enumeration of a (L, S) slot table, vectorized.

    Groups each layer's slots by resident id — stable, so slot-ascending
    within an id — and indexes each slot's occurrence within its run:
    returns ``(order, id_sorted, occ)``, all (L, S), where ``order`` maps
    sorted position → physical slot, ``id_sorted`` is the resident id at
    that position, and ``occ`` says "this is the id's occ-th copy".

    This ordering is THE copy axis: ``build_slots_of`` (models/sharding)
    lays out ``slots_of[l, e, r]`` in it, and every share/CDF table must
    enumerate copies identically or solver-side shares and model-side
    dispatch silently disagree — which is why all of them call this one
    helper.
    """
    slot_table = np.atleast_2d(slot_table)
    L, S = slot_table.shape
    order = np.argsort(slot_table, axis=1, kind="stable")
    id_sorted = np.take_along_axis(slot_table, order, axis=1)
    pos = np.arange(S)[None, :]
    new_run = np.concatenate(
        [np.ones((L, 1), bool), id_sorted[:, 1:] != id_sorted[:, :-1]],
        axis=1)
    run_start = np.maximum.accumulate(np.where(new_run, pos, 0), axis=1)
    return order, id_sorted, pos - run_start


def copy_share_cdf(slot_table: np.ndarray, n_experts: int,
                   share: Optional[np.ndarray] = None,
                   r_max: Optional[int] = None) -> np.ndarray:
    """THE cumulative copy-share table: (L, S) slot table → (L, E, r_max).

    The single normalization behind ``ReplicatedPlacement.copy_cdf`` and
    ``models.sharding.build_copy_cdf`` — solver-side scoring and
    model-side dispatch must agree bit-for-bit on this table, so there is
    exactly one implementation. Entries ≥ ``n_experts`` are phantom
    padding and take no share; ``share=None`` means a uniform split over
    each expert's copies; trailing (padding) entries along the copy axis
    are 1.0 so inverse-CDF selection can never land outside an expert's
    real copies. Experts whose shares sum to zero (fully starved) fall
    back to a uniform split. Returns float32.
    """
    slot_table = np.atleast_2d(slot_table)
    L, S = slot_table.shape
    if share is not None:
        share = np.atleast_2d(np.asarray(share, dtype=np.float64))
        if share.shape != slot_table.shape:
            raise ValueError(
                f"share shape {share.shape} != table {slot_table.shape}")
    clipped = np.minimum(slot_table, n_experts)      # phantoms → sentinel E
    counts = np.apply_along_axis(np.bincount, 1, clipped,
                                 minlength=n_experts + 1)[:, :n_experts]
    rm = int(counts.max()) if r_max is None else int(r_max)
    if rm < int(counts.max()):
        raise ValueError(f"r_max={rm} < max replica count {counts.max()}")
    order, e_sorted, occ = copy_enumeration(clipped)
    sh_sorted = (np.ones((L, S))
                 if share is None else np.take_along_axis(share, order, 1))
    acc = np.zeros((L, n_experts, rm), dtype=np.float64)
    li, si = np.nonzero(e_sorted < n_experts)
    acc[li, e_sorted[li, si], occ[li, si]] = sh_sorted[li, si]
    totals = acc.sum(-1)
    dead = totals <= 0.0
    if dead.any():
        uniform = (np.arange(rm)[None, None, :] < counts[..., None]) * 1.0
        acc = np.where(dead[..., None], uniform, acc)
        totals = acc.sum(-1)
    cdf = np.cumsum(acc, axis=-1) / totals[..., None]
    return np.minimum(cdf, 1.0).astype(np.float32)


def placement_to_permutation(assign: np.ndarray, n_ranks: int) -> np.ndarray:
    """(L,E) assign → (L,E) perm with perm[l,p] = logical expert in slot p.

    Slots are rank-major; within a rank, logical experts are ordered by id
    (deterministic so repeated solves with equal assignment produce identical
    physical layouts — minimizes spurious weight movement). Implemented as a
    single stable argsort per layer: sorting expert ids by rank keeps the
    ascending-id order within each rank.
    """
    assign = np.atleast_2d(assign)
    return np.argsort(assign, axis=1, kind="stable").astype(np.int32)


def permutation_to_placement(perm: np.ndarray, n_ranks: int) -> np.ndarray:
    perm = np.atleast_2d(perm)
    L, E = perm.shape
    e_loc = E // n_ranks
    rank_of_slot = (np.arange(E, dtype=np.int32) // e_loc)[None, :]
    assign = np.empty((L, E), dtype=np.int32)
    np.put_along_axis(assign, perm, np.broadcast_to(rank_of_slot, (L, E)),
                      axis=1)
    return assign


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------

def contiguous_placement(n_layers: int, n_experts: int, n_ranks: int) -> Placement:
    """vLLM default: expert e on rank e // (E/G), identical at every layer."""
    e_loc = n_experts // n_ranks
    row = np.arange(n_experts, dtype=np.int32) // e_loc
    return Placement(np.tile(row, (n_layers, 1)), n_ranks)


def _greedy_target_assign(
    w_layer: np.ndarray,           # (E,) per-expert token load
    targets: np.ndarray,           # (G,) token targets τ_g
    n_ranks: int,
) -> np.ndarray:
    """Paper Alg 1 Phase 2 inner loop with the uniform-slot constraint.

    Experts in descending load order go to argmax_g (τ_g − n_g) among ranks
    with free slots. Per-layer reference implementation — production solves
    go through :func:`_greedy_target_assign_vec`; an equivalence test pins
    the two to identical output.
    """
    E = w_layer.size
    e_loc = E // n_ranks
    order = np.argsort(-w_layer, kind="stable")
    load = np.zeros(n_ranks)
    slots = np.full(n_ranks, e_loc, dtype=np.int64)
    assign = np.empty(E, dtype=np.int32)
    for e in order:
        gap = targets - load
        gap[slots == 0] = -np.inf
        g = int(np.argmax(gap))
        assign[e] = g
        load[g] += w_layer[e]
        slots[g] -= 1
    return assign


def _greedy_target_assign_vec(
    w: np.ndarray,                 # (L, E) per-expert token loads
    targets: np.ndarray,           # (L, G) token targets τ_{l,g}
) -> np.ndarray:
    """Vectorized greedy fill: all layers advance one item per iteration.

    The Python loop runs over the E item *positions* (descending-load order
    within each layer); each iteration is O(L·G) numpy work, so DeepSeek
    scale (L=58, E=256, G=64) completes in milliseconds instead of the
    seconds the per-layer double loop needs. Produces exactly the per-layer
    reference's output (same float ops in the same order, same argmax
    tie-breaking).
    """
    w = np.asarray(w, dtype=np.float64)
    L, E = w.shape
    G = targets.shape[1]
    e_loc = E // G
    order = np.argsort(-w, axis=1, kind="stable")                # (L, E)
    rows = np.arange(L)
    load = np.zeros((L, G))
    slots = np.full((L, G), e_loc, dtype=np.int64)
    assign = np.empty((L, E), dtype=np.int32)
    for i in range(E):
        item = order[:, i]                                       # (L,)
        gap = targets - load
        gap[slots == 0] = -np.inf
        g = np.argmax(gap, axis=1)                               # (L,)
        assign[rows, item] = g
        load[rows, g] += w[rows, item]
        slots[rows, g] -= 1
    return assign


def eplb_placement(
    w: np.ndarray,                 # (L, E) activation matrix
    n_ranks: int,
) -> Placement:
    """EPLB: equalize token counts. τ_g = N/G for all g (f_g(n)=n)."""
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    L, E = w.shape
    targets = np.repeat(w.sum(axis=1, keepdims=True) / n_ranks, n_ranks,
                        axis=1)
    return Placement(_greedy_target_assign_vec(w, targets), n_ranks)


def _speed_targets(
    w: np.ndarray,                 # (L, E)
    perf_models: Sequence[PerfModel],
    n_ref_mode: str,
) -> tuple:
    """Per-layer speeds s_{l,g} and token targets τ_{l,g} → ((L,G), (L,G))."""
    L, E = w.shape
    G = len(perf_models)
    N = w.sum(axis=1)                                            # (L,)
    n_ref = np.maximum(N / (G if n_ref_mode == "rank" else E), 1.0)
    s = np.empty((L, G))
    for g, m in enumerate(perf_models):
        s[:, g] = 1.0 / np.asarray(m(n_ref), dtype=np.float64)
    targets = N[:, None] * s / s.sum(axis=1, keepdims=True)
    return s, targets


def vibe_placement(
    w: np.ndarray,                 # (L, E) activation matrix
    perf_models: Sequence[PerfModel],
    n_ref_mode: str = "rank",
) -> Placement:
    """ViBE (paper Alg 1 Phase 2): speed-proportional targets, greedy fill.

    ``n_ref_mode`` picks the operating point for the speed estimate
    s_g = 1/f_g(n_ref):

    * ``"rank"`` (default) — n_ref = N/G, the mean per-*rank* token load.
      f_g maps whole-device kernel load to latency, so this evaluates each
      device at the load it will actually run — where power-limited
      variability is expressed (paper Fig 5).
    * ``"expert"`` — n_ref = N/E, Algorithm 1's literal text. At low
      per-expert loads f_g sits in the unstressed regime where all devices
      look identical, degenerating to EPLB (see DESIGN.md §3 fidelity note).
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    _, targets = _speed_targets(w, perf_models, n_ref_mode)
    return Placement(_greedy_target_assign_vec(w, targets),
                     len(perf_models))


# ---------------------------------------------------------------------------
# ViBE-R: replication-aware placement
# ---------------------------------------------------------------------------

def default_slots_per_rank(n_experts: int, n_ranks: int) -> int:
    """Default ViBE-R slot budget: the singleton footprint rounded up, plus
    one spare slot per rank when E divides G evenly (otherwise the phantom
    padding slots already provide replication headroom)."""
    base = -(-n_experts // n_ranks)                  # ceil(E/G)
    return base + (1 if base * n_ranks == n_experts else 0)


def normalize_slot_budget(
    slot_budget,                   # None | int | (G,) array-like
    n_experts: int,
    n_ranks: int,
) -> np.ndarray:
    """Per-rank physical slot budget → validated (G,) int array.

    ``None`` → :func:`default_slots_per_rank` on every rank; a scalar is a
    uniform budget; an array gives each rank its own budget (device memory
    headroom — paper §5.1's non-uniform allocation). Every rank needs ≥ 1
    slot, the fleet must hold all E experts, and no rank may hold more
    slots than E (it would be forced to colocate sibling copies).
    """
    if slot_budget is None:
        budget = np.full(n_ranks, default_slots_per_rank(n_experts, n_ranks),
                         dtype=np.int64)
    else:
        budget = np.asarray(slot_budget, dtype=np.int64)
        if budget.ndim == 0:
            budget = np.full(n_ranks, int(budget), dtype=np.int64)
    if budget.shape != (n_ranks,):
        raise ValueError(f"slot budget shape {budget.shape} != ({n_ranks},)")
    if budget.min() < 1:
        raise ValueError("every rank needs a slot budget of at least 1")
    S = int(budget.sum())
    if S < n_experts:
        raise ValueError(
            f"slot budget {S} (over {n_ranks} ranks) cannot hold "
            f"{n_experts} experts")
    if budget.max() > n_experts:
        raise ValueError(f"per-rank slot budget {int(budget.max())} > "
                         f"E={n_experts}: that rank would hold the full "
                         "expert set and colocate sibling copies")
    return budget


def _replication_degrees(
    w: np.ndarray,                 # (L, E)
    n_extra: int,                  # copies beyond one-per-expert
    max_copies: int,
) -> np.ndarray:
    """Greedy hot-expert splitting, vectorized across layers.

    Start from one copy each; repeatedly grant a copy to the expert with the
    largest *per-copy* load w_e / c_e (the straggler bound a replica buys
    down the most). ``n_extra`` iterations of O(L·E) work.
    """
    L, E = w.shape
    rows = np.arange(L)
    copies = np.ones((L, E), dtype=np.int64)
    q = w.astype(np.float64).copy()                  # per-copy load
    for _ in range(n_extra):
        q_masked = np.where(copies >= max_copies, -np.inf, q)
        e_star = np.argmax(q_masked, axis=1)
        copies[rows, e_star] += 1
        q[rows, e_star] = w[rows, e_star] / copies[rows, e_star]
    return copies


def _replicated_solve(
    w: np.ndarray,                 # (L, E) activation matrix
    speeds: np.ndarray,            # (L, G) per-rank speed estimates s_{l,g}
    targets: np.ndarray,           # (L, G) per-rank token targets τ_{l,g}
    n_ranks: int,
    budget: np.ndarray,            # (G,) per-rank physical slot budget
    perf_models: Optional[Sequence[PerfModel]] = None,
) -> ReplicatedPlacement:
    """Shared replication machinery behind ViBE-R and HarMoEny-style solves.

    Three phases, all vectorized across layers:

    1. **Replicate** — under the slot budget S = Σ_g budget_g, grant the
       S − E spare slots to the hottest experts (largest per-copy load
       first), capped at one copy per rank.
    2. **Place** — greedy target fill over the (expert, copy) items in
       descending per-copy load order, to the rank farthest below its token
       target τ_g with free budget; a copy avoids ranks already holding a
       copy of the same expert (a colocated replica absorbs no skew).
    3. **Share** — split each expert's traffic over its copies
       proportionally to the *speed* of the rank each copy landed on, so
       the share lands where f_g is fastest (uniform speeds → uniform
       shares).

    With ``perf_models`` given, a **reweighted refill** closes the loop
    between phases 2 and 3: the greedy fill assumed uniform per-copy loads,
    but the speed-proportional shares mean copies on fast ranks carry more
    — so the fill re-runs with per-copy loads under those shares, and each
    layer keeps whichever of the two placements has the lower predicted
    straggler latency max_g f_g(n_g). Never worse than the single-pass
    solve by construction (the incremental path's
    ``reweight_shares_by_speed`` folded into the full solve). Uniform
    speeds make the reweighted loads identical to the uniform ones, so
    hardware-oblivious solves (HarMoEny) pass None and skip the refill.

    The physical layout is rank-major with ``max(budget)`` slots per rank;
    ranks below the maximum pad their tail slots with phantoms (id E,
    share 0) so non-uniform budgets ride the uniform slot table every
    consumer already understands.
    """
    L, E = w.shape
    G = n_ranks
    s_max = int(budget.max())
    S = int(budget.sum())
    rows = np.arange(L)

    # Phase 1: replication degrees (S − E spare copies, ≤ G copies each)
    copies = _replication_degrees(w, S - E, max_copies=G)

    # Expand to per-copy items: ce (L, S) expert id, cl (L, S) per-copy load
    # (uniform split at placement time; phase 3 reweights by speed).
    cum = np.cumsum(copies, axis=1)                              # (L, E)
    ce = (np.arange(S)[None, :, None] >= cum[:, None, :]).sum(2) \
        .astype(np.int32)                                        # (L, S)
    we = np.take_along_axis(w, ce, axis=1)                       # (L, S)
    cl = we / np.take_along_axis(copies, ce, axis=1)

    # Phase 2: vectorized greedy fill over copies (descending per-copy load)
    def _fill(cl: np.ndarray) -> np.ndarray:
        order = np.argsort(-cl, axis=1, kind="stable")
        load = np.zeros((L, G))
        slots_free = np.tile(budget, (L, 1))
        on_rank = np.zeros((L, G, E), dtype=bool)
        copy_rank = np.empty((L, S), dtype=np.int32)
        for i in range(S):
            item = order[:, i]                                   # (L,)
            e_item = ce[rows, item]                              # (L,)
            gap = targets - load
            invalid = (slots_free == 0) | on_rank[rows, :, e_item]
            # rows where the dedup constraint is unsatisfiable fall back to
            # the slot constraint alone (only when copies ≥ free ranks)
            stuck = invalid.all(axis=1)
            if stuck.any():
                invalid[stuck] = (slots_free[stuck] == 0)
            gap[invalid] = -np.inf
            g = np.argmax(gap, axis=1)                           # (L,)
            copy_rank[rows, item] = g
            load[rows, g] += cl[rows, item]
            slots_free[rows, g] -= 1
            on_rank[rows, g, e_item] = True
        return copy_rank

    # Phase 3: speed-proportional copy shares
    def _shares(copy_rank: np.ndarray) -> np.ndarray:
        sp = speeds[rows[:, None], copy_rank]                    # (L, S)
        denom = np.zeros((L, E))
        np.add.at(denom, (rows[:, None], ce), sp)
        return sp / np.take_along_axis(denom, ce, axis=1)

    copy_rank = _fill(cl)
    share = _shares(copy_rank)

    if perf_models is not None:
        # reweighted refill: redo the greedy under the loads the shares
        # actually send, keep per layer only when the predicted straggler
        # latency strictly improves
        def _objective(cr: np.ndarray, sh: np.ndarray) -> np.ndarray:
            rank_load = np.zeros((L, G))
            np.add.at(rank_load, (rows[:, None], cr), we * sh)
            lat = np.empty_like(rank_load)
            for g, m in enumerate(perf_models):
                lat[:, g] = m(rank_load[:, g])
            return lat.max(axis=1)
        cr2 = _fill(we * share)
        sh2 = _shares(cr2)
        better = _objective(cr2, sh2) < _objective(copy_rank, share)
        if better.any():
            copy_rank = np.where(better[:, None], cr2, copy_rank)
            share = np.where(better[:, None], sh2, share)

    # Lay out rank-major slots, copies ordered by expert id within a rank
    key = copy_rank.astype(np.int64) * (E + 1) + ce
    lay = np.argsort(key, axis=1, kind="stable")
    if s_max * G == S:             # uniform budget: no phantom padding
        return ReplicatedPlacement(
            slot_expert=np.take_along_axis(ce, lay, axis=1),
            share=np.take_along_axis(share, lay, axis=1),
            n_ranks=G, n_experts=E)
    # Non-uniform budget: each rank g filled exactly budget_g copies (the
    # greedy consumes every slot), so the rank-sorted items form contiguous
    # runs of length budget_g — scatter each run to the head of its rank's
    # s_max-slot window, phantoms (id E, share 0) fill the tail.
    ce_l = np.take_along_axis(ce, lay, axis=1)
    sh_l = np.take_along_axis(share, lay, axis=1)
    rk_l = np.take_along_axis(copy_rank, lay, axis=1)
    offsets = np.concatenate([[0], np.cumsum(budget)[:-1]])      # (G,)
    dest = rk_l * s_max + (np.arange(S)[None, :] - offsets[rk_l])
    slot_expert = np.full((L, s_max * G), E, dtype=np.int32)
    share_phys = np.zeros((L, s_max * G))
    lr = np.repeat(rows, S)
    slot_expert[lr, dest.ravel()] = ce_l.ravel()
    share_phys[lr, dest.ravel()] = sh_l.ravel()
    return ReplicatedPlacement(slot_expert=slot_expert, share=share_phys,
                               n_ranks=G, n_experts=E)


def vibe_r_placement(
    w: np.ndarray,                 # (L, E) activation matrix
    perf_models: Sequence[PerfModel],
    slots_per_rank=None,           # None | int | (G,) per-rank budgets
    n_ref_mode: str = "rank",
) -> ReplicatedPlacement:
    """ViBE-R: co-optimize replication degree with per-device speed.

    :func:`_replicated_solve` under ViBE's speed-proportional token targets
    (τ_g ∝ s_g = 1/f_g(n_ref)), including its reweighted refill (the fill
    re-run under the speed-proportional shares' realized loads, kept per
    layer only when the predicted straggler latency improves).
    ``slots_per_rank`` may be a scalar (the paper's uniform memory
    footprint) or a (G,) array of per-rank budgets driven by device memory
    headroom — ranks below the maximum pad with phantom slots.
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    L, E = w.shape
    G = len(perf_models)
    budget = normalize_slot_budget(slots_per_rank, E, G)
    speeds, targets = _speed_targets(w, perf_models, n_ref_mode)
    return _replicated_solve(w, speeds, targets, G, budget,
                             perf_models=perf_models)


def harmoeny_placement(
    w: np.ndarray,                 # (L, E) activation matrix
    n_ranks: int,
    slots_per_rank=None,           # None | int | (G,) per-rank budgets
) -> ReplicatedPlacement:
    """HarMoEny-style baseline: redundant sharding for *pure load balance*.

    The replication machinery of ViBE-R with all hardware awareness
    removed: every rank is assumed equally fast (f_g(n) = n), so token
    targets are uniform (τ_g = N/G) and each expert's traffic splits
    uniformly over its copies. Isolates what redundant hot-expert sharding
    buys *without* variability awareness — the HarMoEny baseline family the
    paper's benchmark sweep compares against.
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    L, E = w.shape
    G = n_ranks
    budget = normalize_slot_budget(slots_per_rank, E, G)
    speeds = np.ones((L, G))
    targets = np.repeat(w.sum(axis=1, keepdims=True) / G, G, axis=1)
    return _replicated_solve(w, speeds, targets, G, budget)


def gem_placement(
    w: np.ndarray,                 # (L, E) activation matrix
    perf_models: Sequence[PerfModel],
) -> Placement:
    """GEM-style variability-aware greedy mapping (no replication).

    Experts in descending load order go to the rank whose *predicted
    completion time* f_g(n_g + w_e) is lowest among ranks with free slots —
    a direct greedy on the profiled latency curves (GEM's expert-to-GPU
    mapping), in contrast to ViBE's precomputed speed-proportional token
    targets. Vectorized across layers like the other solvers.
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    L, E = w.shape
    G = len(perf_models)
    if E % G != 0:
        raise ValueError(f"E={E} not divisible by n_ranks={G}")
    e_loc = E // G
    order = np.argsort(-w, axis=1, kind="stable")                # (L, E)
    rows = np.arange(L)
    load = np.zeros((L, G))
    slots = np.full((L, G), e_loc, dtype=np.int64)
    assign = np.empty((L, E), dtype=np.int32)
    for i in range(E):
        item = order[:, i]                                       # (L,)
        wl = w[rows, item]                                       # (L,)
        t = np.stack([np.asarray(perf_models[g](load[:, g] + wl),
                                 dtype=np.float64) for g in range(G)],
                     axis=1)                                     # (L, G)
        t[slots == 0] = np.inf
        g = np.argmin(t, axis=1)                                 # (L,)
        assign[rows, item] = g
        load[rows, g] += wl
        slots[rows, g] -= 1
    return Placement(assign, G)


def reweight_shares_by_speed(
    placement: ReplicatedPlacement,
    w: np.ndarray,                 # (L, E) activation matrix
    perf_models: Sequence[PerfModel],
    n_ref_mode: str = "rank",
) -> ReplicatedPlacement:
    """Re-proportion each expert's copy shares to its ranks' current speeds.

    Solver phase 3 applied to an *existing* slot table: after slot-granular
    swaps (incremental updates) move copies between ranks, the shares riding
    with them still reflect the ranks they came from. This recomputes
    share ∝ s_g = 1/f_g(n_ref) for the rank each copy now occupies, keeping
    per-expert sums at 1 and the slot table untouched — so the weighted
    dispatch keeps steering traffic toward the fast copies.
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    se = placement.slot_expert
    L, S = se.shape
    E = placement.n_experts
    if w.shape != (L, E):
        raise ValueError(f"w shape {w.shape} != {(L, E)}")
    speeds, _ = _speed_targets(w, perf_models, n_ref_mode)
    rank_of = np.arange(S) // placement.slots_per_rank
    sp = np.where(se < E, speeds[:, rank_of], 0.0)               # (L, S)
    rows = np.arange(L)
    se_c = np.minimum(se, E)
    denom = np.zeros((L, E + 1))
    np.add.at(denom, (rows[:, None], se_c), sp)
    denom[:, E] = 1.0                                            # phantoms
    share = sp / np.take_along_axis(denom, se_c, axis=1)
    return ReplicatedPlacement(se.copy(), share, placement.n_ranks, E)


def inflate_placement(sub: ReplicatedPlacement, survivors: Sequence[int],
                      n_ranks: int) -> ReplicatedPlacement:
    """Re-inflate a placement solved over a survivor subset back to the
    full ``n_ranks`` rank space.

    ``sub`` was solved with ``sub.n_ranks == len(survivors)``;
    ``survivors[j]`` is the global rank that sub-rank j maps to. Dead
    ranks get all-phantom slot windows with zero share, so dispatch sends
    them nothing and ``rank_loads`` reads 0 there — which is how a
    topology-masked re-solve (``SolveContext.dead_ranks``) keeps the
    global slot-table geometry the engine pinned at init.
    """
    surv = np.asarray(survivors, dtype=np.int64)
    if surv.size != sub.n_ranks:
        raise ValueError(f"{surv.size} survivors but sub-placement has "
                         f"{sub.n_ranks} ranks")
    if surv.size != np.unique(surv).size:
        raise ValueError("duplicate survivor ranks")
    if surv.size and (surv.min() < 0 or surv.max() >= n_ranks):
        raise ValueError(f"survivor ranks outside [0, {n_ranks})")
    L = sub.n_layers
    spr = sub.slots_per_rank
    E = sub.n_experts
    slot_expert = np.full((L, n_ranks * spr), E, dtype=np.int32)
    share = np.zeros((L, n_ranks * spr))
    for j, g in enumerate(surv):
        slot_expert[:, g * spr:(g + 1) * spr] = \
            sub.slot_expert[:, j * spr:(j + 1) * spr]
        share[:, g * spr:(g + 1) * spr] = sub.share[:, j * spr:(j + 1) * spr]
    return ReplicatedPlacement(slot_expert, share, n_ranks, E)


def compact_placement(full: ReplicatedPlacement, survivors: Sequence[int],
                      ) -> ReplicatedPlacement:
    """Inverse of :func:`inflate_placement`: slice the survivor rank
    windows out of a full-G masked placement.

    A topology-masked solve (``SolveContext.dead_ranks``) keeps the
    original G-rank geometry with all-phantom zero-share windows on the
    dead ranks — right for a serving engine whose compiled step functions
    pinned that geometry. A *training* relaunch instead rebuilds the mesh
    over the survivors, so it wants the survivor-only geometry back:
    ``compact_placement(masked_solve, survivors)``. Refuses to drop a
    rank window still carrying share (that would silently lose experts).
    """
    surv = np.asarray(survivors, dtype=np.int64)
    if surv.size < 1:
        raise ValueError("need at least one survivor")
    if surv.size != np.unique(surv).size:
        raise ValueError("duplicate survivor ranks")
    if surv.min() < 0 or surv.max() >= full.n_ranks:
        raise ValueError(f"survivor ranks outside [0, {full.n_ranks})")
    spr = full.slots_per_rank
    dropped = np.setdiff1d(np.arange(full.n_ranks), surv)
    if dropped.size:
        cols = (dropped[:, None] * spr + np.arange(spr)).ravel()
        if np.any(full.share[:, cols] != 0.0):
            raise ValueError(
                f"ranks {dropped.tolist()} still carry dispatch share — "
                "compacting them away would lose experts")
    keep = (surv[:, None] * spr + np.arange(spr)).ravel()
    return ReplicatedPlacement(full.slot_expert[:, keep].copy(),
                               full.share[:, keep].copy(),
                               int(surv.size), full.n_experts)


def solve_model_placement(
    policy: str,
    w: np.ndarray,
    n_ranks: int,
    perf_models: Optional[Sequence[PerfModel]] = None,
    slots_per_rank=None,
    topology=None,
) -> AnyPlacement:
    """DEPRECATED string-dispatch entry point (use the policy registry).

    Thin shim over ``repro_torch.core.policy``: resolves the name in the registry
    and solves through the :class:`~repro_torch.core.policy.PlacementPolicy`
    protocol. Return types match the historical if/elif chain bit for bit —
    singleton policies (``contiguous``/``eplb``/``vibe``/``gem``) yield a
    :class:`Placement`, replication-capable ones (``vibe_r``/``harmoeny``)
    a :class:`ReplicatedPlacement`. ``slots_per_rank`` is forwarded only to
    policies whose capabilities accept a slot budget (the old behaviour:
    silently ignored elsewhere). ``topology`` (a
    :class:`~repro_torch.core.topology.ClusterTopology`) is forwarded verbatim —
    ``None`` or a flat topology keeps every pre-existing policy
    bit-identical; only topology-aware policies (``vibe_h``) read it. New
    code should build a
    :class:`~repro_torch.core.policy.SolveContext` and call
    ``get_policy(name).solve(ctx)`` directly.
    """
    warnings.warn(
        "solve_model_placement is deprecated; use "
        "repro_torch.core.policy.get_policy(name).solve(SolveContext(...))",
        DeprecationWarning, stacklevel=2)
    from . import policy as _policy          # late: policy imports this module
    pol = _policy.get_policy(policy)
    caps = pol.capabilities
    if caps.needs_perf_models and perf_models is None:
        raise ValueError(f"{policy} placement requires perf_models")
    ctx = _policy.SolveContext(
        w=w, n_ranks=n_ranks,
        perf_models=perf_models if caps.needs_perf_models else None,
        slot_budget=slots_per_rank if caps.accepts_slot_budget else None,
        topology=topology)
    solved = pol.solve(ctx)
    return solved if caps.supports_replication else solved.to_singleton()


# ---------------------------------------------------------------------------
# Objective evaluation (paper §4.2.3 problem formulation)
# ---------------------------------------------------------------------------

def predicted_layer_latency(
    assign_layer: np.ndarray,      # (E,)
    w_layer: np.ndarray,           # (E,)
    perf_models: Sequence[PerfModel],
) -> np.ndarray:
    """Per-rank predicted latencies f_g(n_g) for one layer → (G,)."""
    G = len(perf_models)
    load = np.zeros(G)
    np.add.at(load, assign_layer, w_layer)
    return np.array([perf_models[g](load[g]) for g in range(G)])


def predicted_rank_latencies(
    placement: AnyPlacement,
    w: np.ndarray,                 # (L, E)
    perf_models: Sequence[PerfModel],
) -> np.ndarray:
    """Predicted f_g(n_{l,g}) → (L, G); replica-aware via ``rank_loads``."""
    load = placement.rank_loads(np.atleast_2d(w))
    lat = np.empty_like(load)
    for g, m in enumerate(perf_models):
        lat[:, g] = m(load[:, g])
    return lat


def layer_latency_span(
    placement: AnyPlacement,
    w: np.ndarray,
    perf_models: Sequence[PerfModel],
) -> np.ndarray:
    """Per-layer (T_max, T_mean, T_min) → (L, 3). T = max is layer latency."""
    lat = predicted_rank_latencies(placement, w, perf_models)
    return np.stack([lat.max(1), lat.mean(1), lat.min(1)], axis=1)
