"""Mixture-of-Experts layer: the ragged (dropless) and capacity paths, on
one device or over an expert-parallel group of ranks.

The counterpart of ``repro.models.moe``. Routing is softmax → top-k →
renormalise; each assignment picks a physical slot among its expert's
replicas by inverse CDF over a deterministic per-assignment uniform
(``_select_slots``). On the path the whole routing stage — router
product, top-k, replica choice, tally, mean probabilities, aux loss — is
one call, :func:`repro_torch.kernels.ops.route_select` (one kernel launch
a layer on the card, its plain version on the CPU).

* **ragged** (``moe_impl="ragged"``): assignments are stable-sorted by slot
  into a flat buffer whose per-slot segments are padded to the row tile
  (``_ragged_plan``); the grouped SwiGLU FFN kernel runs the occupied tiles
  only; a gather combines each token's ``top_k`` results in f32.
* **capacity** (``moe_impl="capacity"``): each slot gets a bucket of
  ``capacity`` rows in arrival order (``_bucket_positions``); overflowing
  assignments are dropped and counted in ``tally[E]``; the capacity FFN
  kernel runs every bucket.
* **dense oracle** (capacity without a group, the reference's
  ``rules=None``): every expert on every token with the plain FFN. With
  ``moe_dispatch="dense"`` on a grid every rank runs it (or, ragged, the
  single-device ragged dispatch) on the whole batch and the whole expert
  weights, as GSPMD runs the reference's.

With a group (``ShardingRules.grouped``) the reference's four bodies run
as it chooses them (``moe_layer``): ``_a2a_body_ragged`` and ``_a2a_body``
(train, prefill: each rank routes its ``(B/dp, S/ep)`` block, the rows go
to the rank that holds their slot through ``all_to_all`` and come back
through the mirror exchange), ``_replicated_body_ragged`` and
``_replicated_body`` (decode: every rank routes every token, computes its
own slots and a ``psum`` combines), the tallies summed and ``mean_prob``
averaged over the group for a global aux loss. On a rank grid the
collectives are :mod:`.collectives` over ``torch.distributed``; on a
one-rank group (no grid) they are the identity, and the ragged bodies
reduce to the single-device ragged dispatch, which runs in their place.
The expert weights a rank holds are its slice
(:func:`repro_torch.launch.sharding.shard_params`): its slots, over
``fsdp`` a slice of their axis 1, under expert-TP a slice of F. In the
model the layer gets the rank's rows (``rows``): with the batch over
``dp`` and the sequence over ``tp`` (= ``ep``, as ``make_rules`` sets
them), they are the rank's a2a block as they are; other layouts are
converted to the block and back, and the replicated bodies gather the
whole batch, as GSPMD does around the reference's replicated
``shard_map``.

Placement is positional, as in the reference: the stacked expert weights
live in physical slot order, ``slots_of``/``n_copies``/``copy_cdf`` map
logical experts to slots at run time, :func:`apply_placement` migrates
the weights when the placement changes, and :func:`expand_experts` builds
the decode fleet's replicated slots from the a2a layout. Phantom padding
(``n_slots_a2a``): E padded to a multiple of the group; phantom slots get
no tokens.

Nothing on the per-layer path synchronises the host: every shape is a
static bound (``n_tiles = A // bm + n_slots``, ``capacity`` from the token
count, the a2a frames of ``t_loc·top_k`` rows a destination), and the
data-dependent parts are tensor values.

Training runs either path: the routing stage and both FFNs are
differentiable through their kernels (``ops``), the buffer fill through
:class:`_FillBuffer`, whose backward is a gather, the bucket fill
(``_fill_buckets``) and the combine through autograd (gathers whose
backward scatters to distinct rows), and the exchanges through
:mod:`.collectives`.
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
from . import collectives as C
from .common import dense_init
from .sharding import ShardingRules

__all__ = ["moe_init", "moe_layer", "route", "expert_ffn_ref",
           "default_perm_a2a", "default_perm_replicated", "n_slots_a2a",
           "apply_placement", "placement_gather_indices", "expand_experts"]


# ---------------------------------------------------------------------------
# slot layout helpers (the reference's, copied)
# ---------------------------------------------------------------------------

def n_slots_a2a(n_experts: int, ep_size: int) -> int:
    """Physical slot count for a2a dispatch: E padded to a multiple of EP."""
    return ((n_experts + ep_size - 1) // ep_size) * ep_size


def default_perm_a2a(n_layers: int, n_experts: int,
                     ep_size: int) -> np.ndarray:
    """Identity (contiguous) slot permutation; phantoms at the tail."""
    ns = n_slots_a2a(n_experts, ep_size)
    return np.tile(np.arange(ns, dtype=np.int32), (n_layers, 1))


def default_perm_replicated(n_layers: int, n_experts: int,
                            fleet: int) -> np.ndarray:
    """Round-robin replication: slot p holds logical expert p % E."""
    e_loc = max(1, -(-n_experts // max(fleet, 1)))
    ns = e_loc * max(fleet, 1)
    return np.tile(np.arange(ns, dtype=np.int32) % n_experts, (n_layers, 1))


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
    return _ksum(_contrib(y_rows, rows, w, t, K))


def _contrib(y_rows, rows, w, t: int, K: int) -> torch.Tensor:
    """Each assignment's weighted row ``w[t, k]·y_rows[rows[t, k]]``,
    (t, K, D) f32."""
    return (y_rows[rows.reshape(t, K)].float()
            * w.reshape(t, K).float()[:, :, None])


def _ksum(contrib: torch.Tensor) -> torch.Tensor:
    """(t, K, D) → (t, D), summed in k order."""
    out = contrib[:, 0]
    for k in range(1, contrib.shape[1]):
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


def _fill(xf, rows, src, row_of, n_rows):
    """``buf[rows] = xf[src]`` into ``n_rows`` zero rows (a row index of
    ``n_rows`` lands in a spare row that is cut off), through
    :class:`_FillBuffer` when ``xf`` takes a gradient."""
    if torch.is_grad_enabled() and xf.requires_grad:
        return _FillBuffer.apply(xf, rows, src, row_of, n_rows)
    buf = xf.new_zeros((n_rows + 1, xf.shape[1]))
    buf[rows] = xf[src]
    return buf[:n_rows]


def _ragged_local_ffn(xf, weights, slots, active, n_groups, bm, ffn,
                      w1, w3, w2):
    """Sorted-buffer grouped FFN; each assignment's weighted row (t, K, D)
    f32 out, for :func:`_ksum`.

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
    row_full = torch.empty_like(rows)
    row_full[order] = rows
    buf = _fill(xf, rows, torch.div(order, K, rounding_mode="floor"),
                row_full.reshape(t, K), n_rows)
    # a token's K slots are distinct, so no tile holds more than t rows
    y_buf = ffn(w1, w3, w2, buf, tile_group, row_offsets=row_off,
                sizes=sizes, max_rows=t)
    w = weights.float()
    if active is not None:
        w = w * active.to(w.dtype)
    return _contrib(y_buf, torch.clamp(row_full, max=n_rows - 1), w, t, K)


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
    out = _ksum(_ragged_local_ffn(xf, weights, slots, None, p["w1"].shape[0],
                                  bm, ffn, p["w1"], p["w3"], p["w2"]))
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
# expert-parallel bodies
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


def _expert_weights(w1, w3, w2, fsdp_group, rep_group, summed=True):
    """The rank's expert weights as its FFN reads them: replicated over
    ``rep_group`` (the batch axes the weights are not sharded over) and
    gathered over ``fsdp_group`` on axis 1 (ZeRO-3; the reference's
    ``all_gather(..., axis=1, tiled=True)``), the gradient coming back as
    ``summed`` says (``collectives.gather_shards``): the a2a bodies sum it
    over the FSDP axes of their block, whose ranks route other rows, and
    take the rank's slice over the FSDP axes outside it, whose ranks hold
    the same block and route it again."""
    return tuple(C.gather_shards(C.replicate(w, rep_group), fsdp_group,
                                 dim=1, summed=summed) for w in (w1, w3, w2))


def _psum(t: torch.Tensor, group) -> torch.Tensor:
    """Sum of a count (no gradient) over ``group``, as a new tensor."""
    return t if group is None else C.all_reduce_(t.clone(), group)


def _global_aux(tally, mean_prob, aux, n_experts, group):
    """The aux loss from the group's summed tally and averaged
    ``mean_prob`` (the reference's psum / pmean); on one rank the routing
    stage's own ``aux`` is that already."""
    if group is None:
        return aux
    return ref.aux_loss(tally[:n_experts], C.mean_over(mean_prob, group),
                        n_experts)


def _a2a_body_ragged(xb, router_w, w1, w3, w2, slots_of, n_copies, copy_cdf,
                     route_seed, *, top_k, n_experts, n_slots, bm, ep,
                     ep_group, stat_group, fsdp_group, rep_group,
                     ffn: Callable, fsdp_summed=True):
    """Dropless a2a dispatch (``src/repro/models/moe.py:386-464``): sorted
    per-destination frames + ragged FFN.

    The exchange cannot be ragged itself (``all_to_all`` with equal
    splits), so the send buffer holds one frame of ``A = t_loc·top_k``
    rows per destination rank — the worst case, so nothing can overflow.
    Assignments are slot-sorted (slots are rank-major, so one sort orders
    by destination rank and groups by slot), packed into their
    destination's frame, and their local-slot ids ride along in a parallel
    int frame (``e_loc`` marks padding). The receiver sorts the ``ep·A``
    rows by local slot into the ragged buffer, runs the grouped FFN over
    occupied tiles, and the results return through the mirror exchange;
    the combine gathers each token's rows in k order."""
    Bl, Sl, D = xb.shape
    e_loc = n_slots // ep
    w1, w3, w2 = _expert_weights(w1, w3, w2, fsdp_group, rep_group,
                                 fsdp_summed)
    xf = xb.reshape(Bl * Sl, D)
    t = xf.shape[0]
    A = t * top_k
    dev = xf.device
    weights, _, slots, tally, mean_prob, aux = ops.route_select(
        xf, C.replicate(router_w, stat_group), slots_of, n_copies, copy_cdf,
        route_seed, top_k)

    # slot-major order == (dest rank, local slot) order
    order, ss, starts, _ = _sort_by_slot(slots.reshape(-1), n_slots)
    rank_sorted = torch.div(ss, e_loc, rounding_mode="floor")
    rank_starts = starts[torch.arange(ep + 1, device=dev) * e_loc]
    pos_in_rank = (torch.arange(A, dtype=torch.int32, device=dev)
                   - rank_starts[rank_sorted.long()])
    send_row = (rank_sorted * A + pos_in_rank).long()
    frame_row = torch.empty_like(send_row)       # each assignment's row
    frame_row[order] = send_row
    send = _fill(xf, send_row, torch.div(order, top_k, rounding_mode="floor"),
                 frame_row.reshape(t, top_k), ep * A)
    loc_ids = torch.full((ep * A,), e_loc, dtype=torch.int32, device=dev)
    loc_ids[send_row] = ss % e_loc
    recv = C.all_to_all(send, ep_group)
    rloc = C.all_to_all(loc_ids, ep_group)

    # receiver: the ep·A frame rows into the slot-sorted ragged buffer
    active = rloc < e_loc
    order2, rows2, tile_group, n_rows, row_off, sizes = _ragged_plan(
        rloc, e_loc, bm, active=active)
    rows2 = rows2.long()
    buf = recv.new_zeros((n_rows + 1, D))
    buf[rows2] = recv[order2]
    # a slot gets at most t_loc rows from each of the ep senders
    y_buf = ffn(w1, w3, w2, buf[:n_rows], tile_group, row_offsets=row_off,
                sizes=sizes, max_rows=ep * t)
    row_of_recv = torch.empty_like(rows2)
    row_of_recv[order2] = torch.clamp(rows2, max=n_rows - 1)
    y_recv = y_buf[row_of_recv] * active[:, None].to(y_buf.dtype)
    back = C.all_to_all(y_recv, ep_group)

    out = _combine(back, frame_row, weights, t, top_k)
    tally = _psum(tally, stat_group)                  # dropless: tally[E] 0
    aux = _global_aux(tally, mean_prob, aux, n_experts, stat_group)
    return out.to(xb.dtype).reshape(Bl, Sl, D), tally, aux


def _replicated_body_ragged(xb, router_w, w1, w3, w2, slots_of, n_copies,
                            copy_cdf, route_seed, *, top_k, n_experts, bm,
                            my_rank, psum_group, ffn: Callable):
    """Dropless decode (``src/repro/models/moe.py:467-501``): every rank
    routes every token, runs the assignments whose slot it holds
    (``slot // e_loc == my_rank``) through the ragged buffer, and a
    ``psum`` of the ranks' (t, D) f32 partials combines."""
    B, S, D = xb.shape
    e_loc = w1.shape[0]
    xf = xb.reshape(B * S, D)
    weights, _, slots, tally, _, aux = ops.route_select(
        xf, router_w, slots_of, n_copies, copy_cdf, route_seed, top_k)
    mine = torch.div(slots, e_loc, rounding_mode="floor") == my_rank
    contrib = _ragged_local_ffn(C.replicate(xf, psum_group),
                                C.replicate(weights, psum_group),
                                slots % e_loc, mine, e_loc, bm, ffn, w1, w3,
                                w2)
    out = C.sum_partials(_ksum(contrib), psum_group)
    return out.to(xb.dtype).reshape(B, S, D), tally, aux


def _capacity_route(router_w, xf, slots_of, n_copies, copy_cdf, route_seed,
                    top_k):
    """The routing stage of a capacity body: gate weights (t, K) and flat
    slots (t·K,), the tally (E+1,) whose last entry the body fills with its
    drops, the mean probabilities and the aux loss."""
    weights, _, slots, tally, mean_prob, aux = ops.route_select(
        xf, router_w, slots_of, n_copies, copy_cdf, route_seed, top_k)
    if weights.requires_grad:
        # on the card (and on meta) the stage's outputs are views of one
        # buffer, and autograd refuses an in-place write into one of them:
        # the body writes its drop column into a copy of its own
        tally = tally.clone()
    return weights, slots.reshape(-1), tally, mean_prob, aux


def _a2a_body(xb, router_w, w1, w3, w2, slots_of, n_copies, copy_cdf,
              route_seed, *, top_k, n_experts, n_slots, capacity, ep,
              ffn: Callable, ep_group=None, stat_group=None, fsdp_group=None,
              rep_group=None, fsdp_summed=True):
    """One rank's block of the a2a capacity dispatch (train / prefill;
    ``src/repro/models/moe.py:508-563``), in its ``(ep, e_loc, C, D)``
    layout: bucket ``slot·C + pos`` holds an assignment kept by its
    slot's capacity; the buckets of rank ``r``'s slots go to rank ``r``.
    ``tally[E]`` counts the assignments past their slot's bucket,
    ``sum(1 - keep)``, summed over the group."""
    Bl, Sl, D = xb.shape
    e_loc = n_slots // ep
    w1, w3, w2 = _expert_weights(w1, w3, w2, fsdp_group, rep_group,
                                 fsdp_summed)
    xf = xb.reshape(Bl * Sl, D)
    t = xf.shape[0]
    weights, slot_flat, tally, mean_prob, aux = _capacity_route(
        C.replicate(router_w, stat_group), xf, slots_of, n_copies, copy_cdf,
        route_seed, top_k)
    pos = _bucket_positions(slot_flat, n_slots)
    keep = pos < capacity
    dest = (slot_flat.long() * capacity
            + torch.where(keep, pos, torch.zeros_like(pos)).long())
    send = _fill_buckets(xf.repeat_interleave(top_k, dim=0), dest, keep,
                         n_slots * capacity)
    # block j of recv: rank j's buckets for my slots
    recv = C.all_to_all(send, ep_group)
    toks = recv.reshape(ep, e_loc, capacity, D).movedim(0, 1)
    y = ffn(w1, w3, w2, toks.reshape(e_loc, ep * capacity, D).contiguous())
    back = y.reshape(e_loc, ep, capacity, D).movedim(1, 0)
    back = C.all_to_all(back.reshape(n_slots * capacity, D), ep_group)
    out = _combine(back, dest, weights.reshape(-1) * keep, t, top_k)
    tally[n_experts] = (1.0 - keep.float()).sum()
    tally = _psum(tally, stat_group)
    aux = _global_aux(tally, mean_prob, aux, n_experts, stat_group)
    return out.to(xb.dtype).reshape(Bl, Sl, D), tally, aux


def _replicated_body(xb, router_w, w1, w3, w2, slots_of, n_copies, copy_cdf,
                     route_seed, *, top_k, n_experts, capacity,
                     ffn: Callable, my_rank=0, psum_group=None,
                     drop_group=None):
    """Tokens replicated fleet-wide, each rank computes its slots only
    (decode; ``src/repro/models/moe.py:570-615``), combined by a ``psum``
    of the ranks' (t, D) f32 partials. With expert-TP the local w1/w3
    carry an F-slice and w2 the matching rows: ``y`` is a partial sum over
    F, folded in by the wider ``psum_group``. ``tally[E]`` counts
    ``mine & pos >= C``, summed over the slot ranks (``drop_group``) only:
    expert-TP ranks see the same drops."""
    B, S, D = xb.shape
    e_loc = w1.shape[0]
    xf = xb.reshape(B * S, D)
    t = xf.shape[0]
    weights, slot_flat, tally, _, aux = _capacity_route(
        router_w, xf, slots_of, n_copies, copy_cdf, route_seed, top_k)
    mine = torch.div(slot_flat, e_loc, rounding_mode="floor") == my_rank
    loc = slot_flat % e_loc
    pos = _bucket_positions(loc, e_loc, active=mine)
    keep = mine & (pos >= 0) & (pos < capacity)
    dest = (loc.long() * capacity
            + torch.where(keep, pos, torch.zeros_like(pos)).long())
    buckets = _fill_buckets(
        C.replicate(xf, psum_group).repeat_interleave(top_k, dim=0), dest,
        keep, e_loc * capacity)
    y = ffn(w1, w3, w2, buckets.reshape(e_loc, capacity, D))
    wgt = C.replicate(weights, psum_group).reshape(-1)
    out = C.sum_partials(_combine(y.reshape(e_loc * capacity, D), dest,
                                  wgt * keep, t, top_k), psum_group)
    tally[n_experts] = _psum((mine & (pos >= capacity)).float().sum(),
                             drop_group)
    return out.to(xb.dtype).reshape(B, S, D), tally, aux


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def moe_layer(p, x: torch.Tensor, *, top_k: int, n_experts: int,
              rules: Optional[ShardingRules] = None,
              slots_of: Optional[torch.Tensor] = None,
              n_copies: Optional[torch.Tensor] = None,
              copy_cdf: Optional[torch.Tensor] = None,
              route_seed=None, phase: str = "train",
              row_valid: Optional[torch.Tensor] = None,
              rows: Optional[Tuple[bool, bool]] = None):
    """Returns (y (B, S, D), tally (E+1,), aux_loss).

    ``rules=None`` means ``ShardingRules()``: the single-device ragged path
    (the reference's ``rules=None`` is its dense oracle). The dispatch is
    chosen as the reference chooses it (``moe.py:676-700``), with
    the grid (or ``rules.ep_ranks=1``) in place of its mesh:

    * no group (no grid, ``ep_ranks=0``): ragged → the single-device ragged
      dispatch; capacity → the dense oracle;
    * a group: the a2a body (prefill, train, chunk) or the replicated body
      (decode), as ``rules.moe_dispatch`` selects; a2a falls back to
      replicated when ``S`` is not a multiple of the group, and, a
      departure from the reference (whose a2a ``shard_map`` needs the
      batch to split), when ``dp`` does not divide the batch: a prefill of
      one request on a grid with ``dp > 1`` runs the replicated body on
      the a2a layout, every rank routing the whole batch, so the tally is
      global without a sum over the group (a sum over ``dp`` would count
      it ``dp`` times). On a one-rank
      group without a grid ragged runs the single-device ragged dispatch,
      which computes what the reference's one-rank ragged bodies compute
      (summed in another order);
    * ``moe_dispatch="dense"`` on a grid: the reference's oracle under
      GSPMD. Every rank gathers the whole batch and the whole expert
      weights and runs what ``rules`` without a grid runs (ragged: the
      single-device ragged dispatch through the kernels; capacity: the
      dense oracle), then keeps its rows: the replica draw hashes the
      global assignment index, and the tally and ``aux`` are the global
      ones, counted once.

    On a grid, ``p`` holds the rank's slice of the expert weights
    (``launch.sharding.shard_params`` for this ``phase``: the a2a layout
    for train and prefill, the decode fleet's for decode) and the tables
    are replicated. ``rows=None``: ``x`` is replicated, and so is ``y``.
    ``rows=(batch, seq)``: ``x`` holds the rank's rows, its ``B/dp`` of
    the batch where ``batch`` and its ``S/tp`` of the sequence where
    ``seq``, and ``y`` the same rows; the tally and ``aux`` are global in
    both.

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
    if rules.grouped:
        if rules.moe_dispatch != "auto":
            mode = rules.moe_dispatch
        elif phase == "decode":
            mode = "replicated"
        else:
            mode = "a2a"
        # the global sequence: under sequence parallelism x holds S/tp
        seq_whole = S * (rules.tp_size if rules.grid is not None and rows
                         and rows[1] else 1)
        if mode == "a2a" and seq_whole % rules.ep_size != 0:
            mode = "replicated"
        # the global batch: where the batch splits x holds B/dp rows. A
        # batch that dp does not divide (the engine's one-request prefill)
        # has no a2a block on every rank: every rank routes it whole
        batch_whole = B * (rules.dp_size if rules.grid is not None and rows
                           and rows[0] else 1)
        if mode == "a2a" and batch_whole % rules.dp_size != 0:
            mode = "replicated"
        if row_valid is not None and (mode != "dense"
                                      or rules.grid is not None):
            raise NotImplementedError(
                "row_valid (chunked-prefill padding mask) is only supported "
                "without an expert-parallel group")

    ragged = rules.moe_impl == "ragged"
    grid = rules.grid
    rows = rows if grid is not None and rows is not None and any(rows) \
        else None
    if mode == "dense" or (grid is None and ragged):
        # the reference's oracle under GSPMD: on a grid every rank runs it
        # on the whole batch with the whole expert weights
        xw, back = _whole_batch(x, rows, rules)
        w = _whole_experts(p, rules, phase)
        xf = xw.reshape(-1, D)
        if ragged:
            out, tally, aux = _dense_dispatch_ragged(
                w, xf, route_seed, top_k=top_k, n_experts=n_experts,
                bm=rules.moe_block_m, ffn=ops.ragged_moe_ffn,
                row_valid=row_valid, **tables)
        else:
            out, tally, aux = _dense_dispatch(
                w, xf, route_seed, top_k=top_k, n_experts=n_experts,
                row_valid=row_valid, **tables)
        return back(out.reshape(xw.shape)), tally, aux

    group = (lambda axes: None) if grid is None else grid.group
    ffn = ops.ragged_moe_ffn if ragged else ops.fused_moe_ffn
    cf = rules.capacity_factor
    args = (p["router"], p["w1"], p["w3"], p["w2"], slots_of, n_copies,
            copy_cdf, route_seed)
    dp_axes, ep_axes, tp_axes = rules.dp_axes, rules.ep_axes, rules.tp_axes
    if mode == "a2a":
        ep = rules.ep_size
        dp = rules.axis_size(dp_axes)
        n_slots = p["w1"].shape[0] * ep
        blk = dp_axes + ep_axes
        if rows is None:
            t_loc = (B // dp) * (S // ep)
            xb, undo = x, None
            if grid is not None:
                coords = [(grid.index(dp_axes, c), grid.index(ep_axes, c))
                          for c in grid.members(blk)]
                me = grid.index(blk)
                xb = C.take_block(x, group(blk), coords, me)
                undo = lambda y: C.gather_blocks(  # noqa: E731
                    y, group(blk), coords, me, x.shape)
        else:
            # the rank's rows of the global (Bg, Sg)
            Bg = B * rules.axis_size(dp_axes) if rows[0] else B
            Sg = S * rules.axis_size(tp_axes) if rows[1] else S
            t_loc = (Bg // dp) * (Sg // ep)
            xb, undo = _to_a2a_block(x, rows, rules, Sg)
        kw = dict(top_k=top_k, n_experts=n_experts, n_slots=n_slots, ep=ep,
                  ffn=ffn, ep_group=group(ep_axes), stat_group=group(blk),
                  fsdp_group=group(rules.fsdp_axes),
                  rep_group=group(tuple(a for a in dp_axes
                                        if a not in rules.fsdp_axes)),
                  fsdp_summed=rules.fsdp_summed(blk))
        if ragged:
            out, tally, aux = _a2a_body_ragged(xb, *args, bm=rules.moe_block_m,
                                               **kw)
        else:
            capacity = _round_up(
                max(math.ceil(t_loc * top_k / n_slots * cf), 1), 4)
            out, tally, aux = _a2a_body(xb, *args, capacity=capacity, **kw)
        return (out if undo is None else undo(out)), tally, aux

    # replicated: the decode fleet's layout at decode; at train / prefill
    # (a fallback, or asked for) the a2a layout, slots over ep, the FSDP
    # shards gathered, every batch replica doing the same work. Every rank
    # of the psum group routes the same tokens: the rank's rows are
    # gathered to the whole batch first and taken back after.
    xr, back = _whole_batch(x, rows, rules)
    w = (p["w1"], p["w3"], p["w2"])
    if phase == "decode":
        slot_axes, ftp_axes = rules.decode_axes
    else:
        slot_axes, ftp_axes = rules.ep_axes, ()
        w = _expert_weights(*w, group(rules.fsdp_axes), None, summed=False)
    args = (p["router"],) + tuple(w) + args[4:]
    n_slots = w[0].shape[0] * rules.axis_size(slot_axes)
    my_rank = 0 if grid is None else grid.index(slot_axes)
    psum_group = group(slot_axes + ftp_axes)
    Bw, Sw = xr.shape[:2]
    if ragged:
        out, tally, aux = _replicated_body_ragged(
            xr, *args, top_k=top_k, n_experts=n_experts, bm=rules.moe_block_m,
            my_rank=my_rank, psum_group=psum_group, ffn=ffn)
    else:
        capacity = _round_up(
            max(math.ceil(Bw * Sw * top_k / n_slots * max(cf, 2.0)), 4), 4)
        out, tally, aux = _replicated_body(
            xr, *args, top_k=top_k, n_experts=n_experts, capacity=capacity,
            ffn=ffn, my_rank=my_rank, psum_group=psum_group,
            drop_group=group(slot_axes))
    return back(out), tally, aux


def _whole_batch(x, rows, rules):
    """The whole batch from the rank's rows ``x`` (``rows``: its ``B/dp``
    of the batch, its ``S/tp`` of the sequence; ``None``: ``x`` is whole),
    and the function that takes the rank's rows back from an output on
    the whole batch. Every rank then does the same work, so each step's
    backward is its inverse's forward: the gradient of the whole batch,
    whole on every rank, gives the rank its rows' gradient."""
    if rows is None:
        return x, lambda y: y
    grid = rules.grid
    dp_axes, tp_axes = rules.dp_axes, rules.tp_axes
    B, S, D = x.shape
    Bg = B * rules.axis_size(dp_axes) if rows[0] else B
    Sg = S * rules.axis_size(tp_axes) if rows[1] else S
    r_axes = (dp_axes if rows[0] else ()) + (tp_axes if rows[1] else ())
    coords = [(grid.index(dp_axes, c) if rows[0] else 0,
               grid.index(tp_axes, c) if rows[1] else 0)
              for c in grid.members(r_axes)]
    me, group = grid.index(r_axes), grid.group(r_axes)
    xw = C.gather_blocks(x, group, coords, me, (Bg, Sg, D))
    return xw, lambda y: C.take_block(y, group, coords, me)


def _whole_experts(p, rules, phase: str) -> dict:
    """The MoE layer's params with the rank's expert slices gathered whole
    (the dense oracle on a grid): the slices ``shard_params`` cut for
    ``phase`` undone, the last cut first — at train and prefill D (F of
    w2) over ``fsdp`` and the slots over ``ep``, at decode F over the
    expert-TP axes and the slots over the decode fleet. Every rank reads
    them on the whole batch, so the gradient comes back as each rank's own
    slice. Without a grid ``p`` as it is."""
    if rules.grid is None:
        return p
    group = rules.grid.group
    out = dict(p)
    for k in ("w1", "w3", "w2"):
        if phase == "decode":
            slot_axes, ftp_axes = rules.decode_axes
            inner = (1 if k == "w2" else 2, ftp_axes)
        else:
            slot_axes, inner = rules.ep_axes, (1, rules.fsdp_axes)
        w = C.gather_shards(p[k], group(inner[1]), inner[0], summed=False)
        out[k] = C.gather_shards(w, group(slot_axes), 0, summed=False)
    return out


def _to_a2a_block(x, rows, rules, Sg):
    """The rank's a2a block ``(B/dp, S/ep)`` from its rows ``x`` (its
    ``B/dp`` batch rows, and its ``S/tp`` positions where ``rows[1]``),
    and the function that takes the block's output back to the rows.
    Under sequence parallelism over the ``ep`` axes the rows are the block.
    Otherwise the sequence is gathered over ``tp`` (where it is split) and
    the block's positions taken over ``ep``, and back the same way; each
    step's backward is its inverse's forward, so the gradient of a tensor
    held whole is whole on every rank."""
    ep_axes, tp_axes = rules.ep_axes, rules.tp_axes
    if rows[1] and ep_axes == tp_axes:
        return x, None
    grid = rules.grid
    B, _, D = x.shape
    whole = (B, Sg, D)
    seq = (grid.group(tp_axes), [(0, j) for j in range(rules.tp_size)],
           grid.index(tp_axes))
    blk = (grid.group(ep_axes), [(0, j) for j in range(rules.ep_size)],
           grid.index(ep_axes))
    xs = C.gather_blocks(x, *seq, whole) if rows[1] else x

    def undo(y):
        y = C.gather_blocks(y, *blk, whole)
        return C.take_block(y, *seq) if rows[1] else y

    return C.take_block(xs, *blk), undo


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


def expand_experts(expert_params: dict, perm_a2a: np.ndarray,
                   perm_dec: np.ndarray) -> dict:
    """Decode-fleet expert tensors (replicated slots) from the a2a layout:
    decode slot p holds logical expert ``perm_dec[l, p]``, fetched from the
    first a2a slot holding that expert; a decode expert absent from the
    a2a layout is an error (the reference's, ``moe.py:842-866``)."""
    perm_dec = np.atleast_2d(perm_dec)
    perm_a2a = np.atleast_2d(perm_a2a)
    L = perm_dec.shape[0]
    n_ids = int(max(perm_a2a.max(), perm_dec.max())) + 1
    inv = _first_slot_of(perm_a2a, n_ids)
    gi = inv[np.arange(L)[:, None], perm_dec]
    if (gi < 0).any():
        missing = sorted(set(perm_dec[gi < 0].tolist()))
        raise KeyError(f"decode experts absent from a2a layout: {missing}")
    out = dict(expert_params)
    for k in ("w1", "w2", "w3"):
        if k in out:
            leaf = out[k]
            g = torch.as_tensor(gi, dtype=torch.int64, device=leaf.device)
            lidx = torch.arange(L, device=leaf.device)[:, None]
            out[k] = leaf[lidx, g]
    return out
