"""Mixture-of-Experts layer: the ragged (dropless) and capacity paths.

The counterpart of ``repro.models.moe`` for one device. Routing is softmax
→ top-k → renormalise; each assignment picks a physical slot among its
expert's replicas by inverse CDF over a deterministic per-assignment
uniform (``_select_slots``). On the path the whole routing stage — router
product, top-k, replica choice, tally, mean probabilities, aux loss — is
one call, :func:`repro_torch.kernels.ops.route_select` (one kernel launch
a layer on the card, its plain version on the CPU).

* **ragged** (``moe_impl="ragged"``): assignments are stable-sorted by slot
  into a flat buffer whose per-slot segments are padded to the row tile
  (``_ragged_plan``); the grouped SwiGLU FFN kernel runs the occupied tiles
  only; a gather combines each token's ``top_k`` results in f32.
* **capacity** (``moe_impl="capacity"``) on a one-rank expert-parallel
  group (``ShardingRules.ep_ranks=1``, the reference's one-device mesh):
  the reference's ``_a2a_body`` (prefill) and ``_replicated_body``
  (decode) with ``ep = 1``, where ``all_to_all`` and ``psum`` are the
  identity. Each slot gets a bucket of ``capacity`` rows in arrival order
  (``_bucket_positions``); overflowing assignments are dropped and counted
  in ``tally[E]``; the capacity FFN kernel runs every bucket.
* **dense oracle** (capacity without a group, the reference's
  ``rules=None``): every expert on every token with the plain FFN.

Placement is positional, as in the reference: the stacked expert weights
live in physical slot order, ``slots_of``/``n_copies``/``copy_cdf`` map
logical experts to slots at run time, and :func:`apply_placement` migrates
the weights when the placement changes.

Nothing on the per-layer path synchronises the host: every shape is a
static bound (``n_tiles = A // bm + n_slots``, ``capacity`` from the token
count), and the data-dependent parts are tensor values. Multi-rank
dispatch is a later slice (ROADMAP Queue 1, "Multi-rank dispatch").

Training runs the ragged path: the routing stage and the FFN are
differentiable through their kernels (``ops``), the buffer fill through
:class:`_FillBuffer`, whose backward is a gather, and the combine through
autograd (a gather whose backward scatters to distinct rows). The capacity
FFN has no backward kernel yet, so gradients through ``moe_impl=
"capacity"`` on the card raise.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref
from repro_torch.kernels.ragged_moe_ffn import (ragged_n_tiles,
                                                ragged_tile_metadata)
from .common import dense_init
from .sharding import ShardingRules

__all__ = ["moe_init", "moe_layer", "route", "expert_ffn_ref",
           "apply_placement", "placement_gather_indices"]


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
    """Softmax-then-top-k routing, the plain mirror of the reference's
    ``route`` (the model path routes through ``ops.route_select``).

    Returns gate weights (t, K) f32 renormalised over the selected experts,
    indices (t, K) int32 (logical), and mean full-softmax probs (E,) f32
    for the load-balance aux loss. The f32 router product is a plain
    matmul; softmax, top-k and renormalisation are ``ops.router_topk``.
    """
    logits = xf.float() @ router_w
    weights, idx = ops.router_topk(logits, top_k)
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=0)
    return weights, idx, mean_prob


def expert_ffn_ref(w1, w3, w2, toks):
    """Grouped SwiGLU FFN: toks (E_loc, C, D) → (E_loc, C, D), plain
    products in the input dtype (the reference's jnp oracle FFN)."""
    h = torch.bmm(toks, w1)
    h = F.silu(h) * torch.bmm(toks, w3)
    return torch.bmm(h, w2)


#: the plain replica choice, shared with the fused routing stage's plain
#: version (``kernels/ref.py``)
_assignment_uniforms = ref.assignment_uniforms
_select_slots = ref.select_slots


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


def _bucket_positions(slot_flat: torch.Tensor, n_slots: int,
                      active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Arrival position (int32) of each assignment within its slot's
    bucket; the stable sort keeps arrival order, which decides the drops.
    Positions of inactive assignments are meaningless (callers mask
    them)."""
    order, _, _, pos_sorted = _sort_by_slot(slot_flat, n_slots, active)
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted
    return pos


def _combine(y_rows: torch.Tensor, rows: torch.Tensor, w: torch.Tensor,
             t: int, K: int) -> torch.Tensor:
    """``out[t] = Σ_k w[t, k]·y_rows[rows[t, k]]`` in f32, summed in k
    order: a gather, not the reference's scatter-add, so it is the same on
    every run (a CUDA ``index_add_`` is not). ``rows``/``w`` are (t·K,)
    or (t, K), assignment ``a`` belonging to token ``a // K``.

    Its backward (autograd's) scatters ``dy_rows`` to the rows it read. On
    the ragged path they are distinct (each assignment owns its buffer
    row); on the capacity paths a dropped assignment shares a row, but
    with weight 0 it adds an exact 0. So the scatter sums nothing in an
    order that could change between runs."""
    contrib = (y_rows[rows.reshape(t, K)].float()
               * w.reshape(t, K).float()[:, :, None])
    out = contrib[:, 0]
    for k in range(1, K):
        out = out + contrib[:, k]
    return out


def _ragged_plan(slot_flat: torch.Tensor, n_slots: int, bm: int,
                 active: Optional[torch.Tensor] = None):
    """Sort-based dropless dispatch plan. Returns ``(order, rows,
    tile_group, n_rows, row_off, sizes)``: assignment index in slot-sorted
    order, buffer row per sorted assignment (``n_rows`` for inactive ones),
    owning slot per tile (sentinel ``n_slots``), the static buffer row
    count, and where each slot's segment starts and how many of its rows
    are real (from which the kernel works out each tile's real rows)."""
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
    return order, rows, tile_group, n_rows, row_off, sizes


class _FillBuffer(torch.autograd.Function):
    """The ragged buffer fill ``buf[rows] = xf[order // K]`` with a
    backward that is a gather: ``dxf[t] = Σ_k dbuf[row_of[t, k]]``, summed
    in k order in f32, where ``row_of`` (t, K) is each assignment's buffer
    row (``n_rows``, the cut spare row, for an inactive one). Autograd's
    own backward of the fill would scatter-add each token's K rows, which
    on the card sums in an order that varies between runs."""

    @staticmethod
    def forward(ctx, xf, rows, src, row_of, n_rows):
        buf = xf.new_zeros((n_rows + 1, xf.shape[1]))
        buf[rows] = xf[src]
        ctx.save_for_backward(row_of)
        ctx.n_rows = n_rows
        return buf[:n_rows]

    @staticmethod
    def backward(ctx, dbuf):
        (row_of,) = ctx.saved_tensors
        n_rows = ctx.n_rows
        live = row_of < n_rows
        rows = torch.clamp(row_of, max=n_rows - 1)
        dx = None
        for k in range(rows.shape[1]):
            g = dbuf[rows[:, k]].float() * live[:, k, None]
            dx = g if dx is None else dx + g
        return dx.to(dbuf.dtype), None, None, None, None


def _ragged_local_ffn(xf, weights, slots, active, n_groups, bm, ffn,
                      w1, w3, w2):
    """Sorted-buffer grouped FFN + weighted combine; (t, D) f32 out.

    ``weights``/``slots`` are (t, K): assignment ``a`` belongs to token
    ``a // K``. Rows are scattered into an ``n_rows + 1`` buffer whose spare
    last row takes the inactive assignments and is cut off (the
    reference's ``mode="drop"``). The inverse of ``order`` gives each
    (t, k) its buffer row for the gather combine (:func:`_combine`).
    """
    t, D = xf.shape
    K = slots.shape[1]
    order, rows, tile_group, n_rows, row_off, sizes = _ragged_plan(
        slots.reshape(-1), n_groups, bm,
        None if active is None else active.reshape(-1))
    rows = rows.long()
    src = torch.div(order, K, rounding_mode="floor")
    if torch.is_grad_enabled() and xf.requires_grad:
        row_full = torch.empty_like(rows)
        row_full[order] = rows
        buf = _FillBuffer.apply(xf, rows, src, row_full.reshape(t, K),
                                n_rows)
    else:
        buf = xf.new_zeros((n_rows + 1, D))
        buf[rows] = xf[src]
        buf = buf[:n_rows]
    # a token's K slots are distinct, so no tile holds more than t rows
    y_buf = ffn(w1, w3, w2, buf, tile_group, row_offsets=row_off,
                sizes=sizes, max_rows=t)
    row_of = torch.empty_like(rows)
    row_of[order] = torch.clamp(rows, max=n_rows - 1)
    w = weights.float()
    if active is not None:
        w = w * active.to(w.dtype)
    return _combine(y_buf, row_of, w, t, K)


def _dense_dispatch_ragged(p, xf, route_seed, *, top_k, n_experts, slots_of,
                           n_copies, copy_cdf, bm, ffn: Callable,
                           row_valid=None):
    """Single-device ragged dispatch: each assignment computed exactly once
    (A = t·top_k rows). ``ffn`` is the grouped FFN — ``ops.ragged_moe_ffn``
    on the model path; a caller may pass the plain version to compare.
    Returns (y (t, D), tally (E+1,), aux)."""
    weights, _, slots, tally, _, aux = ops.route_select(
        xf, p["router"], slots_of, n_copies, copy_cdf, route_seed, top_k,
        row_valid)
    out = _ragged_local_ffn(xf, weights, slots, None, p["w1"].shape[0], bm,
                            ffn, p["w1"], p["w3"], p["w2"])
    return out.to(xf.dtype), tally, aux


# ---------------------------------------------------------------------------
# dense oracle (capacity without an expert-parallel group)
# ---------------------------------------------------------------------------

def _dense_dispatch(p, xf, route_seed, *, top_k, n_experts, slots_of,
                    n_copies, copy_cdf, row_valid=None):
    """Every slot's FFN on every token (plain products), combined by a
    (t, n_slots) gate matrix; nothing can drop. Same return contract as
    :func:`_dense_dispatch_ragged`."""
    weights, _, slots, tally, _, aux = ops.route_select(
        xf, p["router"], slots_of, n_copies, copy_cdf, route_seed, top_k,
        row_valid)
    n_slots = p["w1"].shape[0]
    # a token's K experts are distinct, so are their slots: no index of a
    # row repeats and the scatter-add is exact
    comb = torch.zeros((xf.shape[0], n_slots), dtype=torch.float32,
                       device=xf.device).scatter_add_(1, slots.long(),
                                                      weights)
    y = expert_ffn_ref(p["w1"], p["w3"], p["w2"],
                       xf.expand((n_slots,) + tuple(xf.shape)))
    out = torch.einsum("te,etd->td", comb, y.float())
    return out.to(xf.dtype), tally, aux


# ---------------------------------------------------------------------------
# capacity buckets on a one-rank expert-parallel group
# ---------------------------------------------------------------------------

def _fill_buckets(rows_x: torch.Tensor, dest: torch.Tensor,
                  keep: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(n_rows, D) buckets holding each kept assignment's token row at
    ``dest``, zeros elsewhere. Kept destinations are unique, so this is an
    index assignment where the reference scatter-adds (``.at[dest].add``;
    a CUDA ``index_add_`` is not deterministic); a spare last row takes
    the dropped assignments and is cut off."""
    buf = rows_x.new_zeros((n_rows + 1, rows_x.shape[1]))
    buf[torch.where(keep, dest, torch.full_like(dest, n_rows))] = rows_x
    return buf[:n_rows]


def _capacity_route(router_w, xf, slots_of, n_copies, copy_cdf, route_seed,
                    top_k):
    """The routing stage of a capacity body: flat gate weights and slots
    (t·K,), the tally (E+1,) whose last entry the body fills with its
    drops, and the aux loss."""
    weights, _, slots, tally, _, aux = ops.route_select(
        xf, router_w, slots_of, n_copies, copy_cdf, route_seed, top_k)
    return weights.reshape(-1), slots.reshape(-1), tally, aux


def _a2a_body(xb, router_w, w1, w3, w2, slots_of, n_copies, copy_cdf,
              route_seed, *, top_k, n_experts, n_slots, capacity, ep,
              ffn: Callable):
    """One rank's block of the a2a capacity dispatch (train / prefill).

    The reference's ``_a2a_body`` with its ``(ep, e_loc, C, D)`` layout,
    at ``ep = 1`` (``ShardingRules`` refuses larger groups): the two
    ``all_to_all`` exchanges and the ``psum`` of the tally are the
    identity. ``tally[E]`` counts the assignments past their slot's
    bucket, ``sum(1 - keep)``.
    """
    Bl, Sl, D = xb.shape
    e_loc = n_slots // ep
    xf = xb.reshape(Bl * Sl, D)
    t = xf.shape[0]
    wgt_flat, slot_flat, tally, aux = _capacity_route(
        router_w, xf, slots_of, n_copies, copy_cdf, route_seed, top_k)
    pos = _bucket_positions(slot_flat, n_slots)
    keep = pos < capacity
    dest = (slot_flat.long() * capacity
            + torch.where(keep, pos, torch.zeros_like(pos)).long())
    send = _fill_buckets(xf.repeat_interleave(top_k, dim=0), dest, keep,
                         n_slots * capacity)
    # dispatch (ep, E_loc, C, D): chunk i goes to rank i (all_to_all over
    # one rank: the identity); recv[j] = tokens from rank j for my experts
    recv = send.reshape(ep, e_loc, capacity, D)
    toks = recv.movedim(0, 1).reshape(e_loc, ep * capacity, D).contiguous()
    y = ffn(w1, w3, w2, toks)                       # (E_loc, ep·C, D)
    back = y.reshape(e_loc, ep, capacity, D).movedim(1, 0)
    back = back.reshape(n_slots * capacity, D)      # my sends, processed
    out = _combine(back, dest, wgt_flat * keep, t, top_k)
    tally[n_experts] = (1.0 - keep.float()).sum()
    return out.to(xb.dtype).reshape(Bl, Sl, D), tally, aux


def _replicated_body(xb, router_w, w1, w3, w2, slots_of, n_copies, copy_cdf,
                     route_seed, *, top_k, n_experts, capacity,
                     ffn: Callable):
    """One rank's block of the replicated capacity dispatch (decode).

    The reference's ``_replicated_body`` on a one-rank fleet: every slot
    is local (``my_rank = 0``, ``e_loc = n_slots``) and the ``psum``
    combine is the identity. ``tally[E]`` counts ``mine & pos >= C``.
    """
    B, S, D = xb.shape
    e_loc = w1.shape[0]
    my_rank = 0
    xf = xb.reshape(B * S, D)
    t = xf.shape[0]
    wgt_flat, slot_flat, tally, aux = _capacity_route(
        router_w, xf, slots_of, n_copies, copy_cdf, route_seed, top_k)
    mine = torch.div(slot_flat, e_loc, rounding_mode="floor") == my_rank
    loc = slot_flat % e_loc
    pos = _bucket_positions(loc, e_loc, active=mine)
    keep = mine & (pos >= 0) & (pos < capacity)
    dest = (loc.long() * capacity
            + torch.where(keep, pos, torch.zeros_like(pos)).long())
    buckets = _fill_buckets(xf.repeat_interleave(top_k, dim=0), dest, keep,
                            e_loc * capacity)
    y = ffn(w1, w3, w2, buckets.reshape(e_loc, capacity, D))
    out = _combine(y.reshape(e_loc * capacity, D), dest, wgt_flat * keep, t,
                   top_k)
    tally[n_experts] = (mine & (pos >= capacity)).float().sum()
    return out.to(xb.dtype).reshape(B, S, D), tally, aux


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_layer(p, x: torch.Tensor, *, top_k: int, n_experts: int,
              rules: Optional[ShardingRules] = None,
              slots_of: Optional[torch.Tensor] = None,
              n_copies: Optional[torch.Tensor] = None,
              copy_cdf: Optional[torch.Tensor] = None,
              route_seed=None, phase: str = "train",
              row_valid: Optional[torch.Tensor] = None):
    """Returns (y (B, S, D), tally (E+1,), aux_loss).

    ``rules=None`` means ``ShardingRules()``: the single-device ragged path
    (the reference's ``rules=None`` is its dense oracle). The dispatch is
    chosen as the reference chooses it (``moe.py:676-700``), with
    ``rules.ep_ranks`` in place of its mesh:

    * no group (``ep_ranks=0``): ragged → the single-device ragged
      dispatch; capacity → the dense oracle;
    * a one-rank group: capacity → the a2a body (prefill, train, chunk) or
      the replicated body (decode), as ``rules.moe_dispatch`` selects;
      ragged → the single-device ragged dispatch, which computes what the
      reference's one-rank ragged bodies compute (summed in another
      order).

    ``tally[:E]`` counts logical-expert assignments (pre-capacity);
    ``tally[E]`` the capacity drops (0 on the ragged and dense paths).
    ``row_valid`` (B·S,) masks padded chunk rows out of the output and the
    tally; with a group it raises, as in the reference.
    """
    rules = ShardingRules() if rules is None else rules
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
    tables = dict(slots_of=slots_of, n_copies=n_copies, copy_cdf=copy_cdf)

    mode = "dense"
    if rules.ep_ranks:
        if rules.moe_dispatch != "auto":
            mode = rules.moe_dispatch
        elif phase == "decode":
            mode = "replicated"
        else:
            mode = "a2a"
        if mode != "dense" and row_valid is not None:
            raise NotImplementedError(
                "row_valid (chunked-prefill padding mask) is only supported "
                "without an expert-parallel group")

    xf = x.reshape(B * S, D)
    if rules.moe_impl == "capacity" and x.is_cuda and torch.is_grad_enabled() \
            and (x.requires_grad or any(t.requires_grad for t in p.values())):
        raise NotImplementedError(
            "gradients through moe_impl='capacity' on the card: the capacity "
            "FFN kernel (csrc/moe_ffn.cu) has no backward kernel yet "
            "(ROADMAP Queue 2, \"A backward for the capacity FFN\"); train "
            "with moe_impl='ragged'")
    if rules.moe_impl == "ragged":
        out, tally, aux = _dense_dispatch_ragged(
            p, xf, route_seed, top_k=top_k, n_experts=n_experts,
            bm=rules.moe_block_m, ffn=ops.ragged_moe_ffn,
            row_valid=row_valid, **tables)
        return out.reshape(B, S, D), tally, aux
    if mode == "dense":
        out, tally, aux = _dense_dispatch(
            p, xf, route_seed, top_k=top_k, n_experts=n_experts,
            row_valid=row_valid, **tables)
        return out.reshape(B, S, D), tally, aux

    n_slots = p["w1"].shape[0]
    cf = rules.capacity_factor
    args = (x, p["router"], p["w1"], p["w3"], p["w2"], slots_of, n_copies,
            copy_cdf, route_seed)
    if mode == "a2a":
        t_loc = B * S                                 # one rank holds all
        capacity = _round_up(max(math.ceil(t_loc * top_k / n_slots * cf), 1),
                             4)
        return _a2a_body(*args, top_k=top_k, n_experts=n_experts,
                         n_slots=n_slots, capacity=capacity,
                         ep=rules.ep_ranks, ffn=ops.fused_moe_ffn)
    t = B * S
    capacity = _round_up(
        max(math.ceil(t * top_k / n_slots * max(cf, 2.0)), 4), 4)
    return _replicated_body(*args, top_k=top_k, n_experts=n_experts,
                            capacity=capacity, ffn=ops.fused_moe_ffn)


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
