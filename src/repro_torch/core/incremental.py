"""Incremental placement update (paper Algorithm 2, §4.2.4, Appendix A.2).

Rather than re-solving placement from scratch (which reassigns >200 of 256
slots per layer and incurs large weight-transfer cost), start from the
current placement and apply the minimum number of cross-rank expert swaps:

  repeat
    g+ ← rank with highest f_g(n_g)     (slowest)
    g- ← rank with lowest  f_g(n_g)     (fastest)
    evaluate all (e_i ∈ g+, e_j ∈ g-) swaps, score by marginal reduction in
    the pair's max latency; apply the best one
  until  max_g f_g(n_g) ≤ (1+ε) · mean_g f_g(n_g)   or no beneficial swap

The paper reports convergence in 5–30 swaps/layer. We additionally support
one-sided *moves* ... no — the paper keeps uniform slots per rank, so only
swaps preserve the memory constraint; we do the same.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import numpy as np

from .perf_model import PerfModel
from .placement import (Placement, ReplicatedPlacement, _speed_targets,
                        pad_phantom_column, reweight_shares_by_speed)

__all__ = ["Swap", "IncrementalResult", "incremental_update",
           "SlotSwap", "incremental_update_replicated"]


@dataclasses.dataclass(frozen=True)
class Swap:
    layer: int
    expert_a: int   # logical expert moving g_plus → g_minus
    expert_b: int   # logical expert moving g_minus → g_plus
    rank_a: int     # g_plus (was slowest)
    rank_b: int     # g_minus (was fastest)


@dataclasses.dataclass(frozen=True)
class SlotSwap:
    """One (expert, copy)-granular exchange between two physical slots."""
    layer: int
    slot_a: int     # slot on rank_a (was slowest)
    slot_b: int     # slot on rank_b (was fastest)
    rank_a: int
    rank_b: int


@dataclasses.dataclass(frozen=True)
class IncrementalResult:
    placement: "Placement | ReplicatedPlacement"
    swaps: List
    converged_layers: int
    per_layer_swaps: np.ndarray     # (L,)

    @property
    def total_swaps(self) -> int:
        return len(self.swaps)

    def moved_expert_count(self) -> int:
        """Experts whose rank changed = 2 per swap (both directions)."""
        return 2 * len(self.swaps)


def _rank_latencies(load: np.ndarray, perf_models: Sequence[PerfModel]) -> np.ndarray:
    return np.array([perf_models[g](load[g]) for g in range(len(perf_models))])


def incremental_update(
    placement: Placement,
    w: np.ndarray,                       # (L, E) fresh activation matrix
    perf_models: Sequence[PerfModel],
    epsilon: float = 0.03,
    max_swaps_per_layer: int = 64,
) -> IncrementalResult:
    """Paper Algorithm 2 over all layers.

    Returns a new Placement plus the swap log (the weight-migration plan:
    exactly the swapped experts' tensors move between ranks).
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    G = placement.n_ranks
    L, E = placement.assign.shape
    if w.shape != (L, E):
        raise ValueError(f"w shape {w.shape} != placement {placement.assign.shape}")

    assign = placement.assign.copy()
    swaps: List[Swap] = []
    per_layer = np.zeros(L, dtype=np.int64)
    converged = 0

    for l in range(L):
        # per-rank loads under current assignment
        load = np.zeros(G)
        np.add.at(load, assign[l], w[l])
        # expert lists per rank (mutable)
        members = [list(np.flatnonzero(assign[l] == g)) for g in range(G)]

        for _ in range(max_swaps_per_layer):
            lat = _rank_latencies(load, perf_models)
            target = (1.0 + epsilon) * lat.mean()
            if lat.max() <= target:
                break
            g_plus = int(np.argmax(lat))
            g_minus = int(np.argmin(lat))
            if g_plus == g_minus:
                break

            # evaluate all swaps between g_plus and g_minus, score by the
            # reduction in max(f_{g+}, f_{g-}) (marginal latency gain)
            cur_pair_max = max(lat[g_plus], lat[g_minus])
            best_gain, best = 0.0, None
            fp, fm = perf_models[g_plus], perf_models[g_minus]
            wl = w[l]
            lp, lm = load[g_plus], load[g_minus]
            for ei in members[g_plus]:
                for ej in members[g_minus]:
                    dn = wl[ei] - wl[ej]
                    if dn <= 0:
                        continue  # only moving load off the slow rank helps
                    new_max = max(float(fp(lp - dn)), float(fm(lm + dn)))
                    gain = cur_pair_max - new_max
                    if gain > best_gain + 1e-15:
                        best_gain, best = gain, (ei, ej, dn)
            if best is None:
                break  # no latency reduction available

            ei, ej, dn = best
            members[g_plus].remove(ei); members[g_plus].append(ej)
            members[g_minus].remove(ej); members[g_minus].append(ei)
            assign[l, ei] = g_minus
            assign[l, ej] = g_plus
            load[g_plus] -= dn
            load[g_minus] += dn
            swaps.append(Swap(l, int(ei), int(ej), g_plus, g_minus))
            per_layer[l] += 1

        lat = _rank_latencies(load, perf_models)
        if lat.max() <= (1.0 + epsilon) * lat.mean():
            converged += 1

    return IncrementalResult(
        placement=Placement(assign, G),
        swaps=swaps,
        converged_layers=converged,
        per_layer_swaps=per_layer,
    )


def _replicated_objective(placement: ReplicatedPlacement, w: np.ndarray,
                          perf_models: Sequence[PerfModel]) -> float:
    """Σ_l max_g f_g(n_{l,g}) under the placement's own traffic shares."""
    loads = placement.rank_loads(np.atleast_2d(w))               # (L, G)
    lat = np.stack([np.asarray(perf_models[g](loads[:, g]), dtype=np.float64)
                    for g in range(placement.n_ranks)], axis=1)
    return float(lat.max(axis=1).sum())


def _replicated_swap_run(
    placement: ReplicatedPlacement,
    w: np.ndarray,
    perf_models: Sequence[PerfModel],
    epsilon: float,
    max_swaps_per_layer: int,
    speeds: "np.ndarray | None" = None,
) -> IncrementalResult:
    """One slot-swap greedy pass. ``speeds=None`` scores swaps under the
    *carried* shares (legacy); ``speeds`` (L, G) scores them under the
    *post-reweight* shares each candidate map would get (folded mode): the
    two candidate experts' copy shares are re-proportioned to their
    hypothetical rank speeds before pricing the pair, and after a swap the
    affected experts' shares/loads are rebuilt so the loop's view always
    matches what :func:`reweight_shares_by_speed` will produce."""
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    G = placement.n_ranks
    L, S = placement.slot_expert.shape
    E = placement.n_experts
    s_loc = placement.slots_per_rank

    se = placement.slot_expert.copy()
    sh = placement.share.copy()
    # frozen per-slot traffic under the fresh activation matrix (phantom
    # slots — ids == E, zero share — carry no load and never move: they
    # encode a rank's missing memory budget, not migratable capacity)
    slot_load = np.take_along_axis(pad_phantom_column(w), se, axis=1) * sh
    swaps: List[SlotSwap] = []
    per_layer = np.zeros(L, dtype=np.int64)
    converged = 0

    for l in range(L):
        load = slot_load[l].reshape(G, s_loc).sum(axis=1)
        rank_of = np.arange(S) // s_loc
        spl = None if speeds is None else speeds[l]

        def folded_pair_loads(si, sj, ei, ej, g_plus, g_minus, lp, lm):
            """(new_lp, new_lm) with ei→g-, ej→g+ and both experts' copy
            shares re-proportioned to the speeds of their new ranks."""
            new_lp, new_lm = lp, lm
            for e, src, dst in ((ei, si, g_minus), (ej, sj, g_plus)):
                cs = np.flatnonzero(se[l] == e)
                r_new = rank_of[cs].copy()
                r_new[cs == src] = dst
                sp = spl[r_new]
                sh_new = sp / sp.sum()
                we = w[l, e]
                cur = slot_load[l, cs]
                new_lp += (we * sh_new[r_new == g_plus].sum()
                           - cur[rank_of[cs] == g_plus].sum())
                new_lm += (we * sh_new[r_new == g_minus].sum()
                           - cur[rank_of[cs] == g_minus].sum())
            return new_lp, new_lm

        for _ in range(max_swaps_per_layer):
            lat = _rank_latencies(load, perf_models)
            target = (1.0 + epsilon) * lat.mean()
            if lat.max() <= target:
                break
            g_plus = int(np.argmax(lat))
            g_minus = int(np.argmin(lat))
            if g_plus == g_minus:
                break

            cur_pair_max = max(lat[g_plus], lat[g_minus])
            best_gain, best = 0.0, None
            fp, fm = perf_models[g_plus], perf_models[g_minus]
            lp, lm = load[g_plus], load[g_minus]
            slots_p = np.flatnonzero(rank_of == g_plus)
            slots_m = np.flatnonzero(rank_of == g_minus)
            experts_p = set(int(e) for e in se[l, slots_p])
            experts_m = set(int(e) for e in se[l, slots_m])
            for si in slots_p:
                ei = int(se[l, si])
                if ei >= E:
                    continue                  # phantom slot: nothing to move
                for sj in slots_m:
                    ej = int(se[l, sj])
                    if ei == ej or ej >= E:
                        continue
                    # dedup: arriving copy must not meet a sibling copy
                    if ei in experts_m or ej in experts_p:
                        continue
                    if spl is None:
                        dn = slot_load[l, si] - slot_load[l, sj]
                        if dn <= 0:
                            continue  # only off-loading the slow rank helps
                        new_lp, new_lm = lp - dn, lm + dn
                    else:
                        new_lp, new_lm = folded_pair_loads(
                            si, sj, ei, ej, g_plus, g_minus, lp, lm)
                        dn = lp - new_lp
                    new_max = max(float(fp(new_lp)), float(fm(new_lm)))
                    gain = cur_pair_max - new_max
                    if gain > best_gain + 1e-15:
                        best_gain, best = gain, (int(si), int(sj), dn)
            if best is None:
                break  # no latency reduction available

            si, sj, dn = best
            if spl is None:
                for arr in (se, sh, slot_load):
                    arr[l, si], arr[l, sj] = arr[l, sj], arr[l, si]
                load[g_plus] -= dn
                load[g_minus] += dn
            else:
                ei, ej = int(se[l, si]), int(se[l, sj])
                se[l, si], se[l, sj] = se[l, sj], se[l, si]
                # rebuild the two swapped experts' reweighted shares/loads
                for e in (ei, ej):
                    cs = np.flatnonzero(se[l] == e)
                    sp = spl[rank_of[cs]]
                    sh[l, cs] = sp / sp.sum()
                    slot_load[l, cs] = w[l, e] * sh[l, cs]
                load = slot_load[l].reshape(G, s_loc).sum(axis=1)
            swaps.append(SlotSwap(l, si, sj, g_plus, g_minus))
            per_layer[l] += 1

        lat = _rank_latencies(load, perf_models)
        if lat.max() <= (1.0 + epsilon) * lat.mean():
            converged += 1

    return IncrementalResult(
        placement=ReplicatedPlacement(se, sh, G, E),
        swaps=swaps,
        converged_layers=converged,
        per_layer_swaps=per_layer,
    )


def incremental_update_replicated(
    placement: ReplicatedPlacement,
    w: np.ndarray,                       # (L, E) fresh activation matrix
    perf_models: Sequence[PerfModel],
    epsilon: float = 0.03,
    max_swaps_per_layer: int = 64,
    reweight_shares: bool = False,
) -> IncrementalResult:
    """Algorithm 2 at (expert, copy)-slot granularity (ViBE-R placements).

    The swap unit is a physical *slot*: exchanging the residents of one slot
    on the slowest rank with one on the fastest moves exactly two expert
    copies (and their traffic shares) — the share tables are updated in
    place alongside the slot table, so per-expert share sums and replica
    counts are invariant, which keeps every logical expert resident
    somewhere. Swaps that would colocate two copies of the same expert on
    one rank are skipped (a colocated replica absorbs no skew). The swap
    log doubles as the weight-migration plan, exactly as in the singleton
    solver.

    ``reweight_shares=True`` folds the share reweighting *into* the swap
    search: the loop starts from the reweighted shares, scores every
    candidate swap under the post-reweight shares its new copy→rank map
    would get (solver phase 3 inside the objective, not applied after the
    fact), and rebuilds the swapped experts' shares after each apply. A
    carried-share pass with post-hoc :func:`reweight_shares_by_speed` is
    still run as a safety net and the better-scoring result (by
    Σ_l max_g f_g) is returned — so folding can only match or improve on
    the historical post-hoc path. Off by default: the swap loop scores
    under the carried shares and no reweighting happens at all.
    """
    w = np.atleast_2d(np.asarray(w, dtype=np.float64))
    L, S = placement.slot_expert.shape
    E = placement.n_experts
    if w.shape != (L, E):
        raise ValueError(f"w shape {w.shape} != {(L, E)}")

    if not reweight_shares:
        return _replicated_swap_run(placement, w, perf_models, epsilon,
                                    max_swaps_per_layer)

    # folded: search under post-reweight shares (same speed estimate
    # reweight_shares_by_speed uses), starting from a reweighted table
    speeds, _ = _speed_targets(w, perf_models, "rank")
    folded = _replicated_swap_run(
        reweight_shares_by_speed(placement, w, perf_models), w, perf_models,
        epsilon, max_swaps_per_layer, speeds=speeds)
    folded = dataclasses.replace(
        folded, placement=reweight_shares_by_speed(folded.placement, w,
                                                   perf_models))
    legacy = _replicated_swap_run(placement, w, perf_models, epsilon,
                                  max_swaps_per_layer)
    posthoc = dataclasses.replace(
        legacy, placement=reweight_shares_by_speed(legacy.placement, w,
                                                   perf_models))
    if (_replicated_objective(folded.placement, w, perf_models)
            <= _replicated_objective(posthoc.placement, w, perf_models)):
        return folded
    return posthoc
