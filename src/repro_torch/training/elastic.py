"""Fault tolerance & elasticity: straggler detection and EP re-planning.

ViBE composes directly with elasticity (DESIGN.md §8): the placement
solvers are parametric in the rank set, so losing (or regaining) a device
is "re-solve placement over the survivors and migrate the minimal expert
set". Three pieces:

* :class:`StragglerDetector` — per-rank EWMA of step latencies; flags ranks
  persistently slower than the fleet median by a threshold. A flagged rank
  is first *absorbed* (ViBE shifts load off it — the paper's mechanism used
  as a mitigation), and only *excluded* if it degrades past a hard limit.
* :func:`replan_after_loss` — rebuild the EP placement on the surviving
  ranks (slot-count padding keeps E divisible), returning the migration
  plan (which surviving slots must fetch which experts).
* :func:`elastic_targets` — speed-weighted *data* split for non-MoE work
  (Fig 6's variability-informed token assignment applied to DP batches).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np

from repro_torch.core import (PerfModel, ReplicatedPlacement, SolveContext,
                        compact_placement, get_policy)

__all__ = ["StragglerDetector", "replan_after_loss", "elastic_targets"]


@dataclasses.dataclass
class StragglerDetector:
    n_ranks: int
    alpha: float = 0.1              # EWMA factor
    soft_ratio: float = 1.10        # flag: 10% above median
    hard_ratio: float = 1.50        # exclude: 50% above median
    min_steps: int = 20

    def __post_init__(self):
        self.ewma = np.zeros(self.n_ranks)
        self.steps = 0

    def observe(self, rank_times: np.ndarray) -> Dict[str, List[int]]:
        """Feed per-rank step times; returns {'soft': [...], 'hard': [...]}."""
        rank_times = np.asarray(rank_times, dtype=np.float64)
        if self.steps == 0:
            self.ewma[:] = rank_times
        else:
            self.ewma = (1 - self.alpha) * self.ewma + self.alpha * rank_times
        self.steps += 1
        if self.steps < self.min_steps:
            return {"soft": [], "hard": []}
        med = float(np.median(self.ewma))
        soft = [g for g in range(self.n_ranks)
                if self.ewma[g] > self.soft_ratio * med]
        hard = [g for g in range(self.n_ranks)
                if self.ewma[g] > self.hard_ratio * med]
        return {"soft": soft, "hard": hard}


def replan_after_loss(
    w: np.ndarray,                      # (L, E) activation matrix
    perf_models: Sequence[PerfModel],   # original G models
    lost_ranks: Sequence[int],
    policy: str = "vibe",
) -> Tuple[ReplicatedPlacement, np.ndarray]:
    """Re-solve placement over surviving ranks with any registered policy.

    Routes through the registry's *masked-solve* path
    (``SolveContext.dead_ranks``) — the same code the serving
    controller's ``mask_ranks`` / ``unmask_ranks`` elastic shrink/grow
    uses — so training relaunch and live serving cannot disagree about
    what a survivor solve means (survivor budgets, masked topology,
    replication-capability guards). The full-G masked result (dead ranks
    hold all-phantom zero-share windows) is then compacted to the
    survivor-only geometry with
    :func:`~repro_torch.core.placement.compact_placement`, because a training
    relaunch rebuilds the mesh over the survivors rather than pinning the
    old geometry. Returns (unified placement over G' survivors —
    singleton policies give the r_max = 1 degenerate — and rank_map (G',)
    giving each new rank index its original physical rank id; the
    launcher uses it to rebuild the mesh and the migration plan).
    """
    G = len(perf_models)
    dead = tuple(sorted(set(int(g) for g in lost_ranks)))
    survivors = [g for g in range(G) if g not in set(dead)]
    if not survivors:
        raise ValueError("no surviving ranks")
    pol = get_policy(policy)
    ctx = SolveContext(
        w=w, n_ranks=G,
        perf_models=(tuple(perf_models)
                     if pol.capabilities.needs_perf_models else None),
        dead_ranks=dead)
    full = pol.solve(ctx)
    return (compact_placement(full, survivors),
            np.asarray(survivors, dtype=np.int32))


def elastic_targets(perf_models: Sequence[PerfModel],
                    total_items: int, n_ref: float) -> np.ndarray:
    """Speed-proportional work split across ranks (Fig 6 for DP batches)."""
    s = np.array([m.speed(n_ref) for m in perf_models])
    raw = total_items * s / s.sum()
    out = np.floor(raw).astype(np.int64)
    # distribute the remainder to the fastest ranks
    rem = total_items - int(out.sum())
    order = np.argsort(-(raw - out))
    out[order[:rem]] += 1
    return out
