"""Single-device sharding rules and the placement lookup tables.

The port's :class:`ShardingRules` holds only what the single-device path
reads: the MoE implementation, the ragged row tile and the capacity factor
(the virtual clock's capacity pricing). The mesh fields of the reference's
rules wait for the multi-rank slice.

``build_slots_of`` and ``build_copy_cdf`` are the reference's numpy table
builders (``repro.models.sharding``), copied.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.placement import copy_share_cdf

__all__ = ["ShardingRules", "build_slots_of", "build_copy_cdf"]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """How the model maps onto one device.

    ``moe_impl`` — ``"ragged"``: sort-based dropless dispatch, the grouped
    FFN over occupied tiles only (the one implementation this slice
    ports). ``moe_block_m`` — the ragged row tile: a multiple of the CUDA
    kernel's 64-row block on the card, any size on the CPU.
    """

    moe_impl: str = "ragged"
    moe_block_m: int = 128
    capacity_factor: float = 1.25


def build_slots_of(perm: np.ndarray, n_experts: int, n_slots: int,
                   r_max: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """Logical-expert → physical-slot lookup tables from a slot permutation.

    ``perm``: (L, n_slots) int — logical expert held in each physical slot
    (entries ≥ n_experts are phantom padding; entries may repeat = replicas).
    ``r_max`` optionally pins the copy-axis width. Returns ``slots_of``
    (L, E, r_max) int32 (padded with the first copy) and ``n_copies``
    (L, E) int32.
    """
    perm = np.atleast_2d(perm)
    L = perm.shape[0]
    counts = np.zeros((L, n_experts), dtype=np.int32)
    for l in range(L):
        for p in range(n_slots):
            e = perm[l, p]
            if e < n_experts:
                counts[l, e] += 1
    if np.any(counts == 0):
        raise ValueError("some logical expert has no physical slot")
    if r_max is None:
        r_max = int(counts.max())
    elif r_max < int(counts.max()):
        raise ValueError(f"r_max={r_max} < max replica count {counts.max()}")
    slots_of = np.zeros((L, n_experts, r_max), dtype=np.int32)
    fill = np.zeros((L, n_experts), dtype=np.int32)
    for l in range(L):
        for p in range(n_slots):
            e = perm[l, p]
            if e < n_experts:
                slots_of[l, e, fill[l, e]] = p
                fill[l, e] += 1
        for e in range(n_experts):
            slots_of[l, e, counts[l, e]:] = slots_of[l, e, 0]
    return slots_of, counts


def build_copy_cdf(perm: np.ndarray, n_experts: int, n_slots: int,
                   share: Optional[np.ndarray] = None,
                   r_max: Optional[int] = None) -> np.ndarray:
    """Per-(layer, expert) cumulative copy-share table (L, E, r_max) f32
    for weighted dispatch; ``share`` None = uniform over each expert's
    copies. Copies are enumerated in slot order, as :func:`build_slots_of`
    lays them out."""
    perm = np.atleast_2d(perm)
    if perm.shape[1] != n_slots:
        raise ValueError(f"perm has {perm.shape[1]} slots != {n_slots}")
    return copy_share_cdf(perm, n_experts, share=share, r_max=r_max)
