"""Mixture-of-Experts layer: the single-device ragged (dropless) path.

The counterpart of ``repro.models.moe`` for one device. Routing is softmax
→ top-k → renormalise (the router kernel on the card); each assignment
picks a physical slot among its expert's replicas by inverse CDF over a
deterministic per-assignment uniform (``_select_slots``); assignments are
stable-sorted by slot into a flat buffer whose per-slot segments are
padded to the row tile (``_ragged_plan``); the grouped SwiGLU FFN kernel
runs the occupied tiles only; and a gather combines each token's ``top_k``
results in f32.

Placement is positional, as in the reference: the stacked expert weights
live in physical slot order, ``slots_of``/``n_copies``/``copy_cdf`` map
logical experts to slots at run time, and :func:`apply_placement` migrates
the weights when the placement changes.

Nothing on the per-layer path synchronises the host: every shape is a
static worst-case bound (``n_tiles = A // bm + n_slots``), and the
data-dependent parts are tensor values. The capacity path
(``moe_impl="capacity"``) and the multi-rank dispatches are later slices.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.ragged_moe_ffn import (ragged_n_tiles,
                                                ragged_tile_metadata)
from .common import dense_init
from .sharding import ShardingRules

__all__ = ["moe_init", "moe_layer", "route", "apply_placement",
           "placement_gather_indices"]


def moe_init(generator: torch.Generator, *, d: int, f: int, n_experts: int,
             n_slots: int, dtype=torch.bfloat16, device=None,
             lead: Tuple[int, ...] = ()):
    """Router (logical order, f32) + stacked expert weights (physical slot
    order), each with the leading dims ``lead`` (the block axis)."""
    slots = tuple(lead) + (n_slots,)
    return {
        "router": dense_init(generator, d, n_experts, torch.float32, device,
                             lead),
        "w1": dense_init(generator, d, f, dtype, device, slots),
        "w3": dense_init(generator, d, f, dtype, device, slots),
        "w2": dense_init(generator, f, d, dtype, device, slots),
    }


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------

def route(router_w: torch.Tensor, xf: torch.Tensor, top_k: int):
    """Softmax-then-top-k routing.

    Returns gate weights (t, K) f32 renormalised over the selected experts,
    indices (t, K) int32 (logical), and mean full-softmax probs (E,) f32
    for the load-balance aux loss. The f32 router product is a plain
    matmul; softmax, top-k and renormalisation are the router kernel on
    the card (its plain version on the CPU).
    """
    logits = xf.float() @ router_w
    weights, idx = ops.router_topk(logits, top_k)
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=0)
    return weights, idx, mean_prob


_U32 = 0xFFFFFFFF
#: Knuth multiplicative-hash constant (the reference's ``_HASH_MULT``).
_HASH_MULT = 2654435761
#: odd stride of the per-step salt (the reference's ``_SEED_MULT``).
_SEED_MULT = 2246822519


def _mul_u32(a: torch.Tensor, c: int) -> torch.Tensor:
    """``(a * c) mod 2^32`` for int64 ``a`` in [0, 2^32): the product is
    split at 16 bits so no partial product leaves int64's range."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _U32


def _assignment_uniforms(t: int, K: int, seed=None,
                         device=None) -> torch.Tensor:
    """Deterministic per-assignment uniforms u ∈ [0, 1) → (t, K) f32.

    The reference's uint32 wrap-around hash, bit for bit, computed in int64
    masked to 32 bits: top 24 bits of ``(i + seed·SEED_MULT)·HASH_MULT``.
    """
    i = torch.arange(t * K, dtype=torch.int64, device=device)
    if seed is not None:
        s = torch.as_tensor(seed, device=device).to(torch.int64) & _U32
        i = (i + _mul_u32(s, _SEED_MULT)) & _U32
    h = _mul_u32(i, _HASH_MULT)
    u = (h >> 8).to(torch.float32) * (2.0 ** -24)
    return u.reshape(t, K)


def _select_slots(idx: torch.Tensor, slots_of: torch.Tensor,
                  n_copies: torch.Tensor,
                  copy_cdf: Optional[torch.Tensor] = None,
                  route_seed=None) -> torch.Tensor:
    """Map logical ids (t, K) to physical slots across replicas: by inverse
    CDF over ``copy_cdf`` (E, r_max), or the uniform ``% n_copies`` hash
    without it (see the reference's ``_select_slots``)."""
    t, K = idx.shape
    r_max = slots_of.shape[-1]
    ii = idx.long()
    if r_max == 1:
        return slots_of[:, 0][ii]
    if copy_cdf is None:
        copy = (torch.arange(t * K, dtype=torch.int64, device=idx.device)
                .reshape(t, K)) % n_copies[ii]
    else:
        u = _assignment_uniforms(t, K, route_seed, device=idx.device)
        # smallest r with u < cdf[r]; the min() guards f32 round-up
        copy = (u[:, :, None] >= copy_cdf[ii]).sum(dim=-1)
        copy = torch.minimum(copy, (n_copies[ii] - 1).long())
    return slots_of[ii, copy.long()]


# ---------------------------------------------------------------------------
# ragged (dropless) dispatch
# ---------------------------------------------------------------------------

def _sort_by_slot(slot_flat: torch.Tensor, n_slots: int,
                  active: Optional[torch.Tensor] = None):
    """Stable sort of the (A,) assignment→slot map; inactive assignments
    get the sentinel key ``n_slots``. Returns ``(order, sorted_key, starts,
    pos_sorted)`` as the reference does (``order`` int64 for indexing)."""
    key = slot_flat.to(torch.int32)
    if active is not None:
        key = torch.where(active, key, torch.full_like(key, n_slots))
    sorted_key, order = torch.sort(key, stable=True)
    starts = torch.searchsorted(
        sorted_key, torch.arange(n_slots + 1, dtype=torch.int32,
                                 device=key.device)).to(torch.int32)
    pos_sorted = (torch.arange(key.shape[0], dtype=torch.int32,
                               device=key.device)
                  - starts[sorted_key.long()])
    return order, sorted_key, starts, pos_sorted


def _ragged_plan(slot_flat: torch.Tensor, n_slots: int, bm: int,
                 active: Optional[torch.Tensor] = None):
    """Sort-based dropless dispatch plan. Returns ``(order, rows,
    tile_group, n_rows)``: assignment index in slot-sorted order, buffer
    row per sorted assignment (``n_rows`` for inactive ones), owning slot
    per tile (sentinel ``n_slots``), and the static buffer row count."""
    A = slot_flat.shape[0]
    order, sorted_key, starts, pos_sorted = _sort_by_slot(
        slot_flat, n_slots, active)
    sizes = starts[1:] - starts[:-1]
    n_tiles = ragged_n_tiles(A, n_slots, bm)
    n_rows = n_tiles * bm
    row_off, tile_group = ragged_tile_metadata(sizes, bm, n_tiles)
    rows = torch.where(
        sorted_key < n_slots,
        row_off[torch.clamp(sorted_key, max=n_slots - 1).long()] + pos_sorted,
        torch.full_like(sorted_key, n_rows))
    return order, rows, tile_group, n_rows


def _ragged_local_ffn(xf, weights, slots, active, n_groups, bm, ffn,
                      w1, w3, w2):
    """Sorted-buffer grouped FFN + weighted combine; (t, D) f32 out.

    ``weights``/``slots`` are (t, K): assignment ``a`` belongs to token
    ``a // K``. Rows are scattered into an ``n_rows + 1`` buffer whose spare
    last row takes the inactive assignments and is cut off (the
    reference's ``mode="drop"``). The combine is a gather, not a
    scatter-add: the inverse of ``order`` gives each (t, k) its buffer row,
    and ``out[t] = Σ_k w[t, k]·y[row[t, k]]`` is summed in k order in f32,
    the same on every run (a CUDA ``index_add_`` is not).
    """
    t, D = xf.shape
    K = slots.shape[1]
    order, rows, tile_group, n_rows = _ragged_plan(
        slots.reshape(-1), n_groups, bm,
        None if active is None else active.reshape(-1))
    rows = rows.long()
    buf = xf.new_zeros((n_rows + 1, D))
    buf[rows] = xf[torch.div(order, K, rounding_mode="floor")]
    y_buf = ffn(w1, w3, w2, buf[:n_rows], tile_group)
    row_of = torch.empty_like(rows)
    row_of[order] = torch.clamp(rows, max=n_rows - 1)
    w = weights.float()
    if active is not None:
        w = w * active.to(w.dtype)
    contrib = y_buf[row_of.reshape(t, K)].float() * w[:, :, None]
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    return out


def _masked_tally(idx, n_experts, row_valid=None):
    oh = (idx[..., None] == torch.arange(n_experts, device=idx.device)
          ).to(torch.float32)
    if row_valid is not None:
        oh = oh * row_valid[:, None, None].to(torch.float32)
    return oh.sum(dim=(0, 1))


def _aux_loss(tally, mean_prob, n_experts):
    frac = tally / torch.clamp(tally.sum(), min=1.0)
    return n_experts * torch.dot(frac, mean_prob)


def _dense_dispatch_ragged(p, xf, route_seed, *, top_k, n_experts, slots_of,
                           n_copies, copy_cdf, bm, ffn: Callable,
                           row_valid=None):
    """Single-device ragged dispatch: each assignment computed exactly once
    (A = t·top_k rows). ``ffn`` is the grouped FFN — ``ops.ragged_moe_ffn``
    on the model path; a caller may pass the plain version to compare.
    Returns (y (t, D), tally (E+1,), aux)."""
    weights, idx, mean_prob = route(p["router"], xf, top_k)
    if row_valid is not None:
        weights = weights * row_valid[:, None].to(weights.dtype)
    slots = _select_slots(idx, slots_of, n_copies, copy_cdf, route_seed)
    out = _ragged_local_ffn(xf, weights, slots, None, p["w1"].shape[0], bm,
                            ffn, p["w1"], p["w3"], p["w2"])
    tally = _masked_tally(idx, n_experts, row_valid)
    aux = _aux_loss(tally, mean_prob, n_experts)
    tally = torch.cat([tally, tally.new_zeros((1,))])
    return out.to(xf.dtype), tally, aux


def moe_layer(p, x: torch.Tensor, *, top_k: int, n_experts: int,
              rules: Optional[ShardingRules] = None,
              slots_of: Optional[torch.Tensor] = None,
              n_copies: Optional[torch.Tensor] = None,
              copy_cdf: Optional[torch.Tensor] = None,
              route_seed=None,
              row_valid: Optional[torch.Tensor] = None):
    """Returns (y (B, S, D), tally (E+1,), aux_loss).

    ``rules=None`` means the single-device ``ShardingRules()``: the ragged
    path (the reference's ``rules=None`` is its dense oracle). ``tally[:E]``
    counts logical-expert assignments; ``tally[E]``, the capacity drops,
    is structurally 0 on this dropless path. One device runs one dispatch
    for every phase, so the reference's ``phase`` argument is not taken.
    """
    rules = ShardingRules() if rules is None else rules
    if rules.moe_impl != "ragged":
        raise NotImplementedError(
            f"moe_impl={rules.moe_impl!r}: only the ragged path is ported; "
            "the capacity path is the next slice")
    B, S, D = x.shape
    dev = x.device
    if slots_of is None:
        slots_of = torch.arange(n_experts, dtype=torch.int32,
                                device=dev)[:, None]
    if n_copies is None:
        n_copies = torch.ones((n_experts,), dtype=torch.int32, device=dev)
    if copy_cdf is None:
        r_pad = slots_of.shape[-1]
        copy_cdf = torch.clamp(
            torch.arange(1, r_pad + 1, dtype=torch.float32,
                         device=dev)[None, :]
            / torch.clamp(n_copies[:, None].float(), min=1.0), max=1.0)
    if route_seed is None:
        route_seed = 0
    route_seed = torch.as_tensor(route_seed, device=dev).to(torch.int32)
    out, tally, aux = _dense_dispatch_ragged(
        p, x.reshape(B * S, D), route_seed, top_k=top_k,
        n_experts=n_experts, slots_of=slots_of, n_copies=n_copies,
        copy_cdf=copy_cdf, bm=rules.moe_block_m, ffn=ops.ragged_moe_ffn,
        row_valid=row_valid)
    return out.reshape(B, S, D), tally, aux


# ---------------------------------------------------------------------------
# placement application (weight migration)
# ---------------------------------------------------------------------------

def _first_slot_of(perm: np.ndarray, n_ids: int) -> np.ndarray:
    """inv[l, e] = first (lowest) slot in ``perm[l]`` holding id e, -1 if
    absent (descending fancy assignment: the last write, slot 0, wins)."""
    L, NS = perm.shape
    inv = np.full((L, n_ids), -1, dtype=np.int32)
    desc = np.arange(NS - 1, -1, -1, dtype=np.int32)
    inv[np.arange(L)[:, None], perm[:, ::-1]] = desc[None, :]
    return inv


def placement_gather_indices(old_perm: np.ndarray,
                             new_perm: np.ndarray) -> np.ndarray:
    """gather_idx[l, p] = old slot whose weights must land in new slot p."""
    old_perm = np.atleast_2d(old_perm)
    new_perm = np.atleast_2d(new_perm)
    L, NS = old_perm.shape
    n_ids = int(max(old_perm.max(), new_perm.max())) + 1
    inv = _first_slot_of(old_perm, n_ids)
    src = inv[np.arange(L)[:, None], new_perm]
    return np.where(src >= 0, src,
                    np.arange(NS, dtype=np.int32)[None, :]).astype(np.int32)


def apply_placement(expert_params: dict, old_perm: np.ndarray,
                    new_perm: np.ndarray) -> Tuple[dict, int]:
    """Migrate stacked expert weights (L, n_slots, ...) from one slot
    permutation to another. Returns (new params, number of (layer, slot)
    tensors that moved)."""
    gi = placement_gather_indices(old_perm, new_perm)
    moved = int((gi != np.arange(gi.shape[1])[None, :]).sum())
    out = dict(expert_params)
    for k in ("w1", "w2", "w3"):
        if k in out:
            leaf = out[k]
            g = torch.as_tensor(gi, dtype=torch.int64, device=leaf.device)
            lidx = torch.arange(g.shape[0], device=leaf.device)[:, None]
            out[k] = leaf[lidx, g]
    return out, moved
