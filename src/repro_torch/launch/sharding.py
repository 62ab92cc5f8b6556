"""Per-arch rules on a rank grid, and a rank's slice of the params and of
the decode cache.

The counterpart of ``repro.launch.sharding`` (``make_rules``,
``param_specs``, ``batch_specs``, ``cache_specs``;
``src/repro/launch/sharding.py:39-234``). No parameter is split by the
batch: the batch axes ``dp`` split the activations, each rank its
``B/dp`` rows (``ShardingRules.batch_rows``, the counterpart of
``batch_specs``), and the leaves are sliced by ``tp``
and ``fsdp`` only. A rank's tree differs from the whole tree in

* the experts — train and prefill (the a2a layout): the slot axis over
  ``ep``, and over ``fsdp`` a slice of axis 1 of each matrix (D of w1 and
  w3, F of w2); decode (the decode fleet's layout,
  :func:`repro_torch.models.moe.expand_experts`): the slot axis over
  ``ep_all``; with ``decode_expert_tp`` over ``ep``, and F over the rest
  of ``ep_all`` (the last axis of w1 and w3, axis 1 of w2);
* the dense leaves, in every phase — over ``tp``: ``wq``/``wk``/``wv``'s
  columns and ``wo``'s rows where attention splits by heads, the dense
  MLP's (and shared experts') F, the vocabulary of ``embed`` (rows) and
  ``head`` (columns) where it divides, ``frontend``'s d_model; over
  ``fsdp``: the d_model axis of every one of them
  (:data:`repro_torch.models.sharding.DENSE_D_AXIS`);
* the recurrent mixers, in every phase — over ``tp``
  (:data:`repro_torch.models.sharding.MIXER_TP_CUT`): Mamba by channels
  where ``tp`` divides ``di``, mLSTM and sLSTM by heads where it divides
  the heads (else the mixer stays whole); over ``fsdp``: the d_model axis
  of ``in_proj``, ``out_proj``, ``up`` and ``down``
  (:data:`~repro_torch.models.sharding.MIXER_D_AXIS`).

Norms and the router stay whole. :func:`param_cuts` describes these cuts
leaf by leaf (the counterpart of ``param_specs``): :func:`shard_params`
and :func:`cut_tree` take the rank's slices by it, :func:`gather_params`
gathers them whole again, and the optimizer's norm and the checkpoints
read it too; the optimizer state takes the params' cuts
(:func:`opt_cuts`). :func:`rank_cache` gives a rank's decode cache: its
``B/dp`` lanes where ``dp`` divides the batch (every attention cache and
every recurrent state), its KV heads when attention splits by heads or
its ``S_max/tp`` rows in context mode, and a split mixer's state slice.

Departures from the reference's storage layout. Each rank computes with
the slices it holds, so where the reference's ``param_specs`` or
``cache_specs`` lays a leaf out in a way no rank could compute with, the
port cuts it otherwise. Values do not depend on the layout, and a
checkpoint is written whole, so no file differs:

* Mamba ``in_proj``: a grouped cut of its columns (the rank's block of
  u and of z); the reference cuts 2 di contiguously, which gives one rank
  all of u and the other all of z.
* mLSTM ``up``: a grouped cut of the z half only, the u half whole (every
  head's q, k and v read all of u: computing it beats gathering it); the
  reference cuts 2 di contiguously.
* mLSTM ``wq``/``wk``/``wv``: their columns by heads in both attention
  modes, no FSDP cut; the reference matches them with attention's leaves
  (its xLSTM branch is dead), so their columns split only in "heads"
  mode and FSDP cuts their rows (di, not d_model).
* mLSTM ``w_if``: a grouped cut of its columns (the rank's input- and
  forget-gate heads); the reference cuts its rows.
* mLSTM ``ln_scale``: the rank's channels; the reference keeps it whole.
* sLSTM ``w_gates``: its columns by heads (each head's 4 hd columns); the
  reference cuts its rows.
* sLSTM ``up``: whole over ``tp`` (every head reads all of u); the
  reference cuts its columns.
* Where ``tp`` does not divide the heads, mLSTM and sLSTM stay whole over
  ``tp`` (and run on the gathered sequence); the reference still cuts
  ``up``, ``w_if``, ``w_gates`` and ``down`` (and ``wq``/``wk``/``wv`` in
  "heads" mode).
* States: mLSTM's ``m`` by heads, where ``cache_specs`` keeps it whole;
  where ``tp`` does not divide the heads the xLSTM states stay whole,
  where ``cache_specs`` cuts the 4-d ones (mLSTM ``n``, every sLSTM
  state) along hd.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import collectives as C
from repro_torch.models.model import (block_layout, default_moe_perm,
                                      init_params)
from repro_torch.models.moe import expand_experts, placement_gather_indices
from repro_torch.models.sharding import (DENSE_D_AXIS, DENSE_TP_AXIS,
                                         MIXER_D_AXIS, MIXER_STATE_TP_AXIS,
                                         MIXER_TP_CUT, ShardingRules,
                                         heads_ok, rank_group_sizes)
from repro_torch.training.optimizer import OptState
from repro_torch.tree import tree_map

__all__ = ["make_rules", "Cuts", "param_cuts", "opt_cuts", "cut_tree",
           "gather_params", "gather_to_rank0", "shard_params",
           "shard_experts", "migrate_experts",
           "decode_params", "rank_cache", "FSDP_THRESHOLD"]

#: params above this (count) get the experts' FSDP sharding over
#: ("pod", "data"), as the reference's ``FSDP_THRESHOLD``
FSDP_THRESHOLD = 1e9


def make_rules(cfg: ArchConfig, grid, phase: str = "train",
               moe_impl: str = "ragged") -> ShardingRules:
    """The reference's rules for ``cfg`` on ``grid`` (``None``: no group):
    the dense layers TP over "model", attention by heads where
    :func:`~repro_torch.models.sharding.heads_ok` holds, else by context;
    EP over "model" for train and prefill, over every axis at decode;
    expert-TP at decode where one expert matrix passes 256 MiB; FSDP of
    the weights over ("pod", "data") for archs above 1e9 params; capacity
    factor 1.25 for training and 1.5 for serving; remat for training."""
    if grid is None:
        return ShardingRules(moe_impl=moe_impl)
    expert_tp = (cfg.is_moe
                 and cfg.d_model * cfg.moe_d_ff * 2 > 256 * 1024 * 1024)
    heads = heads_ok(cfg.n_heads, cfg.n_kv_heads, grid.axis_size("model"))
    return ShardingRules(
        moe_impl=moe_impl, grid=grid, dp=("pod", "data"), tp="model",
        ep=("model",), ep_all=("pod", "data", "model"),
        fsdp=("pod", "data") if cfg.n_params() > FSDP_THRESHOLD else None,
        attn_mode="heads" if heads else "context",
        capacity_factor=1.25 if phase == "train" else 1.5,
        remat=(phase == "train"), decode_expert_tp=expert_tp)


@dataclasses.dataclass(frozen=True)
class Cuts:
    """How one leaf is cut on a grid: pairs, applied in order, each a cut
    of one axis into the group over ``axes`` (more than one rank; ``axes``
    in grid order). ``(dim, axes)``: the rank takes the contiguous block at
    its index in that group. ``(dim, axes, groups)`` (a grouped cut): axis
    ``dim`` seen as ``len(groups)`` equal groups, the rank taking its block
    of each group flagged True and each group flagged False whole (a leaf
    whose last axis is halves split after the product, e.g. Mamba's
    ``in_proj``). No pair: the leaf stays whole. The counterpart of one
    ``PartitionSpec``; a tree leaf, not a sequence."""

    pairs: Tuple[tuple, ...] = ()

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis that cuts the leaf (in the pairs' order)."""
        return tuple(a for p in self.pairs for a in p[1])

    def pieces(self, t: torch.Tensor, grid) -> list:
        """``(piece, axes)`` of the rank's slice ``t``: the axes that cut
        each piece, the whole groups of a grouped cut apart (the same on
        every rank of that cut's group); one piece without such a group."""
        for dim, axes, groups in map(_pair, self.pairs):
            if groups and not all(groups):
                sizes = rank_group_sizes(t.shape[dim], groups,
                                         grid.axis_size(axes))
                rest = tuple(a for a in self.axes if a not in axes)
                return [(p, self.axes if cut else rest)
                        for p, cut in zip(t.split(sizes, dim), groups)]
        return [(t, self.axes)]


def _pair(pair) -> tuple:
    """``(dim, axes, groups)`` of a pair of :class:`Cuts` (``groups``
    ``None`` for a contiguous cut)."""
    return pair if len(pair) == 3 else (*pair, None)


def _cuts(rules: ShardingRules, *pairs) -> Cuts:
    """The pairs that cut on ``rules``' grid: ``dim`` not None, ``axes``
    over more than one rank; a pair may carry a grouped cut's ``groups``
    (None: contiguous). A leaf cut twice over one axis would not be tiled
    by its ranks' blocks, and is refused."""
    grid = rules.grid
    kept = []
    for dim, axes, groups in map(_pair, pairs):
        if dim is None or not axes or grid.axis_size(axes) == 1:
            continue
        kept.append((dim, grid.canon(axes)) + ((tuple(groups),) if groups
                                               else ()))
    out = Cuts(tuple(kept))
    if len(set(out.axes)) != len(out.axes):
        raise ValueError(f"a leaf cut twice over one axis: {kept}")
    return out


def _expert_cuts(rules: ShardingRules, phase: str, k: str) -> Cuts:
    """An expert matrix's (``w1``, ``w3``, ``w2``, ``(..., n_slots, a,
    b)``) cuts: train and prefill the slots over ``ep`` and axis 1 over
    ``fsdp``; decode the slots over the decode fleet and, with
    ``decode_expert_tp``, F over the rest of ``ep_all``."""
    if phase == "decode":
        slot_axes, ftp_axes = rules.decode_axes
        return _cuts(rules, (-3, slot_axes),
                     (-2 if k == "w2" else -1, ftp_axes))
    return _cuts(rules, (-3, rules.ep_axes), (-2, rules.fsdp_axes))


def _dense_cuts(p: dict, rules: ShardingRules, split: bool) -> dict:
    """An attention mixer's or a dense MLP's stacked leaves, each cut on
    its d_model axis over ``fsdp`` and, with ``split``, on its TP axis
    over ``tp``."""
    return {k: _cuts(rules, (DENSE_D_AXIS[k] + 1, rules.fsdp_axes),
                     (DENSE_TP_AXIS[k] + 1 if split else None,
                      rules.tp_axes))
            for k in p}


def _mixer_cuts(p: dict, rules: ShardingRules, mixer: str,
                split: bool) -> dict:
    """A recurrent mixer's stacked leaves, each cut on its d_model axis
    over ``fsdp`` (:data:`~repro_torch.models.sharding.MIXER_D_AXIS`) and,
    with ``split``, over ``tp`` as
    :data:`~repro_torch.models.sharding.MIXER_TP_CUT` says."""
    tp_cut = MIXER_TP_CUT[mixer] if split else {}
    out = {}
    for k in p:
        axis, groups = tp_cut.get(k, (None, None))
        out[k] = _cuts(rules, (MIXER_D_AXIS[k] + 1 if k in MIXER_D_AXIS
                               else None, rules.fsdp_axes),
                       (None if axis is None else axis + 1, rules.tp_axes,
                        groups))
    return out


def param_cuts(cfg: ArchConfig, rules: ShardingRules,
               phase: str = "train") -> Any:
    """A tree of :class:`Cuts` matching the params tree of ``cfg`` (the
    whole one, or the decode fleet's from :func:`decode_params`), each
    leaf's cuts as the reference's ``param_specs`` cuts it on ``rules``'
    grid (see the module's docstring, which lists where the port departs
    from it; every leaf whole without a grid): the experts
    (:func:`shard_experts`), the attention and dense MLP leaves, the
    recurrent mixers (:func:`_mixer_cuts`), the embedding and head (the
    vocabulary over ``tp`` where it divides), the frontend; norms and the
    router whole."""
    whole = Cuts()
    # the tree's structure, as the reference's eval_shape gives it
    out = tree_map(lambda _: whole, init_params(cfg, None, device="meta"))
    if rules.grid is None:
        return out
    _, specs = block_layout(cfg)
    vocab = rules.tp_axes if rules.splits(cfg.vocab) else ()
    f_axes = rules.fsdp_axes
    out["embed"] = _cuts(rules, (0, vocab), (1, f_axes))
    if "head" in out:
        out["head"] = _cuts(rules, (0, f_axes), (1, vocab))
    if "frontend" in out and rules.splits(cfg.d_model):
        out["frontend"] = _cuts(rules, (1, rules.tp_axes))
    for spec, sub in zip(specs, out["blocks"]):
        if spec.mixer == "attn":
            sub["mixer"] = _dense_cuts(sub["mixer"], rules,
                                       rules.heads_split(cfg))
        else:
            sub["mixer"] = _mixer_cuts(sub["mixer"], rules, spec.mixer,
                                       rules.mixer_split(cfg, spec.mixer))
        if spec.ffn == "dense":
            sub["ffn"] = _dense_cuts(sub["ffn"], rules,
                                     rules.splits(cfg.d_ff))
        elif spec.ffn == "moe":
            for k in ("w1", "w3", "w2"):
                sub["ffn"][k] = _expert_cuts(rules, phase, k)
        if "shared" in sub:
            sub["shared"] = _dense_cuts(
                sub["shared"], rules,
                rules.splits(cfg.n_shared_experts * cfg.moe_d_ff))
    return out


def opt_cuts(cuts: Any, master: bool = True) -> OptState:
    """The AdamW state's cuts from the params' ``cuts``: the step whole,
    the moments and the f32 master cut as the params (the reference's
    ``OptState(P(), pspecs, pspecs, pspecs)``, ``launch/dryrun.py:87``);
    ``master=False`` for a state without one."""
    return OptState(Cuts(), cuts, cuts, cuts if master else None)


def _part(t: torch.Tensor, pair: tuple, n: int, i: int) -> torch.Tensor:
    """Rank ``i`` of ``n``'s block of ``t`` by one pair of :class:`Cuts`
    (a view for a contiguous cut, a new tensor for a grouped one)."""
    dim, _, groups = _pair(pair)
    size, g = t.shape[dim], len(groups or (True,))
    if size % (g * n):
        raise ValueError(f"shard_params: axis {dim} of {tuple(t.shape)} "
                         f"in {g} group(s) over {n} ranks")
    if groups is None:
        return t.narrow(dim, i * (size // n), size // n)
    unit = size // g
    return torch.cat([p.narrow(dim, i * (unit // n), unit // n) if cut
                      else p for p, cut in zip(t.split(unit, dim), groups)],
                     dim)


def _map_cuts(fn, tree: Any, cuts: Any) -> Any:
    """``fn(leaf, leaf's Cuts)`` over ``tree``, which has the structure of
    ``cuts``; dicts keep their order."""
    if isinstance(cuts, Cuts):
        return fn(tree, cuts)
    if isinstance(tree, dict) and isinstance(cuts, dict) \
            and set(tree) == set(cuts):
        return {k: _map_cuts(fn, v, cuts[k]) for k, v in tree.items()}
    if tree is None and cuts is None:
        return None
    if isinstance(tree, (list, tuple)) and type(tree) is type(cuts) \
            and len(tree) == len(cuts):
        vals = [_map_cuts(fn, v, c) for v, c in zip(tree, cuts)]
        return type(tree)(*vals) if hasattr(tree, "_fields") \
            else type(tree)(vals)
    raise ValueError("the tree and its cuts differ in structure")


def _cut_leaf(t: torch.Tensor, c: Cuts, grid) -> torch.Tensor:
    part = t
    for pair in c.pairs:
        axes = pair[1]
        part = _part(part, pair, grid.axis_size(axes), grid.index(axes))
    if part is t:
        return t
    return part.clone(memory_format=torch.contiguous_format)


def cut_tree(tree: Any, cuts: Any, grid) -> Any:
    """The rank's slice of each leaf of ``tree`` (whole), cut by the
    matching leaf of ``cuts`` on ``grid`` (this rank's place in it). Cut
    leaves are contiguous copies; the others are the same tensors."""
    return _map_cuts(lambda t, c: _cut_leaf(t, c, grid), tree, cuts)


def _gather_leaf(t: torch.Tensor, c: Cuts, grid) -> torch.Tensor:
    for dim, axes, groups in map(_pair, reversed(c.pairs)):
        group = grid.group(axes)
        if groups is None:
            t = C.gather_shards(t, group, dim, summed=False)
            continue
        sizes = rank_group_sizes(t.shape[dim], groups, grid.axis_size(axes))
        t = torch.cat([C.gather_shards(p, group, dim, summed=False) if cut
                       else p for p, cut in zip(t.split(sizes, dim),
                                                groups)], dim)
    return t


@torch.no_grad()
def gather_params(tree: Any, cuts: Any, grid) -> Any:
    """The inverse of :func:`cut_tree`: each leaf of the rank's ``tree``
    gathered whole over the groups of its cuts, the last cut undone first
    (``collectives.gather_shards``, clocked). A collective: every rank of
    ``grid`` calls it on its own slices, and every rank gets the whole
    tree. It gathers a leaf at a time, so a caller that takes one leaf
    whole at a time (the checkpoint's save) holds one whole leaf at most;
    whole leaves are the same tensors."""
    return _map_cuts(lambda t, c: _gather_leaf(t, c, grid), tree, cuts)


@torch.no_grad()
def gather_to_rank0(t: torch.Tensor, c: Cuts, grid):
    """Rank 0's host copy of a whole leaf from the ranks' slices ``t`` cut
    by ``c``: the slices of rank 0's group over the cutting axes are sent
    to rank 0 alone, as bytes on the host (``collectives.gather_to``), and
    placed where :func:`cut_tree` takes them; ranks outside that group
    (their slices repeat its members') send nothing. Every rank of
    ``grid`` calls it; ``None`` on ranks other than 0. The result is a
    contiguous host tensor of its own."""
    axes = grid.canon(c.axes)
    if any(grid.coords[a] for a in grid.axes if a not in axes):
        return None
    part = t.detach().to("cpu", copy=True).contiguous()
    if not c.pairs:
        return part
    parts = C.gather_to(part.view(-1).view(torch.uint8), grid.group(axes),
                        dst=0)
    if grid.rank != 0:
        return None
    shape = list(part.shape)
    for dim, ax, groups in map(_pair, c.pairs):
        shape[dim] = _whole_size(shape[dim], groups, grid.axis_size(ax))
    whole = part.new_empty(shape)
    for coords, raw in zip(grid.members(axes), parts):
        _place(whole, raw.view(part.dtype).view(part.shape), c.pairs, grid,
               coords)
    return whole


def _whole_size(size: int, groups, n: int) -> int:
    """The whole size of an axis whose rank's slice has ``size``."""
    if groups is None:
        return size * n
    sizes = rank_group_sizes(size, groups, n)
    return sum(s * n if cut else s for s, cut in zip(sizes, groups))


def _place(view: torch.Tensor, raw: torch.Tensor, pairs, grid, coords
           ) -> None:
    """Copy ``raw``, the slice the rank at ``coords`` holds by ``pairs``,
    to where :func:`cut_tree` takes it in ``view``."""
    if not pairs:
        view.copy_(raw)
        return
    dim, ax, groups = _pair(pairs[0])
    n, i = grid.axis_size(ax), grid.index(ax, coords)
    if groups is None:
        size = view.shape[dim] // n
        _place(view.narrow(dim, i * size, size), raw, pairs[1:], grid,
               coords)
        return
    unit = view.shape[dim] // len(groups)
    sizes = rank_group_sizes(raw.shape[dim], groups, n)
    for j, (piece, cut) in enumerate(zip(raw.split(sizes, dim), groups)):
        sub = view.narrow(dim, j * unit, unit)
        if cut:
            sub = sub.narrow(dim, i * (unit // n), unit // n)
        _place(sub, piece, pairs[1:], grid, coords)


def shard_experts(p: dict, rules: ShardingRules, phase: str) -> dict:
    """The rank's slice of one MoE layer's params ``{"router", "w1", "w3",
    "w2"}`` whose matrices are ``(..., n_slots, a, b)``; the router and any
    other entry stay whole. Sliced leaves are contiguous copies."""
    if rules.grid is None:
        return p
    out = dict(p)
    for k in ("w1", "w3", "w2"):
        out[k] = cut_tree(p[k], _expert_cuts(rules, phase, k), rules.grid)
    return out


@torch.no_grad()
def migrate_experts(leaf: torch.Tensor, cuts: Cuts, old: np.ndarray,
                    new: np.ndarray, grid) -> Tuple[torch.Tensor, int]:
    """The rank's slice of a stacked expert matrix after a placement
    change, and the bytes it sent to other ranks.

    ``leaf`` (L, slots a rank, a, b) is the rank's slice, cut by ``cuts``
    (:func:`param_cuts`' for an expert matrix: the slot axis, -3, over
    some axes, possibly another axis over others) of a whole leaf whose
    ``L`` rows follow the permutations ``old`` and ``new`` (L, n_slots).
    The result is the rank's slice, by the same cuts, of
    :func:`repro_torch.models.moe.apply_placement` of the whole leaf:
    new slot ``p`` takes old slot ``g = placement_gather_indices(old,
    new)[l, p]``. A slot whose old and new homes are the same rank is
    copied in place; the others travel in one :func:`collectives.exchange
    <repro_torch.models.collectives.exchange>` over the group of the slot
    axes (each rank sending its piece of each such slot to the slot's new
    home, in (layer, slot) order), and not at all when no slot of the
    group changes rank. Every rank of the grid calls it with the same
    permutations."""
    old, new = np.atleast_2d(old), np.atleast_2d(new)
    gi = placement_gather_indices(old, new)
    L, n_slots = gi.shape
    axes = next((ax for dim, ax, _ in map(_pair, cuts.pairs)
                 if dim % leaf.dim() == leaf.dim() - 3), ())
    n = grid.axis_size(axes) if axes else 1
    r = grid.index(axes) if axes else 0
    e = n_slots // n
    flat = leaf.reshape((L, e) + tuple(leaf.shape[-2:]))
    if flat.shape[0] != L or e * n != n_slots:
        raise ValueError(f"migrate_experts: a slice {tuple(leaf.shape)} of "
                         f"{n_slots} slots over {n} ranks, {L} layers")
    dst = np.broadcast_to(np.arange(n_slots) // e, gi.shape)
    src = gi // e
    out = torch.empty_like(flat)
    here = np.nonzero((dst == r) & (src == r))
    if here[0].size:
        li = torch.as_tensor(here[0], device=leaf.device)
        out[li, torch.as_tensor(here[1] - r * e, device=leaf.device)] = \
            flat[li, torch.as_tensor(gi[here] - r * e, device=leaf.device)]
    sent = 0
    if (src != dst).any():
        def moves(mask, by):
            ls, ps = np.nonzero(mask)
            order = np.argsort(by[ls, ps], kind="stable")
            ls, ps = ls[order], ps[order]
            return ls, ps, np.bincount(by[ls, ps], minlength=n)

        ls, ps, n_send = moves((src == r) & (dst != r), dst)
        lr, pr, n_recv = moves((dst == r) & (src != r), src)
        rows = flat[torch.as_tensor(ls, device=leaf.device),
                    torch.as_tensor(gi[ls, ps] - r * e, device=leaf.device)]
        got = C.exchange(rows.flatten(1), grid.group(axes),
                         n_send, n_recv)
        if lr.size:
            out[torch.as_tensor(lr, device=leaf.device),
                torch.as_tensor(pr - r * e, device=leaf.device)] = \
                got.view((len(lr),) + tuple(flat.shape[2:]))
        sent = rows.numel() * rows.element_size()
    return out.view(leaf.shape), sent


def shard_params(cfg: ArchConfig, params: Any, rules: ShardingRules,
                 phase: str = "train") -> Any:
    """The rank's tree from a whole one (``models.init_params`` with the
    same rules and phase, or ``bridge.params_from_numpy`` of a reference
    checkpoint), or from a tree of its structure (gradients, the AdamW
    moments and master), cut by :func:`param_cuts`. Cut leaves are
    contiguous copies. In the serving phases the others are the same
    tensors (the whole tree's memory serves every rank of a process);
    ``phase="train"`` gives every leaf a tensor of the rank's own, outside
    the whole tree's graph and requiring a gradient where the whole
    leaf does, so that a gradient of the rank's leaf never reaches (and
    adds into) the whole tree's ``.grad``."""
    if rules.grid is None:
        return params
    tree = cut_tree(params, param_cuts(cfg, rules, phase), rules.grid)
    if phase != "train":
        return tree
    return tree_map(lambda p, w: (p.detach().clone() if p is w
                                  else p.detach()).requires_grad_(
                                      w.requires_grad), tree, params)


def rank_cache(cfg: ArchConfig, cache: list, rules: ShardingRules) -> list:
    """The rank's decode cache from a whole one (``models.init_cache``'s
    layout: per layer position a (k, v) pair of (n_blocks, B, S_max, KV,
    hd), or a recurrent mixer's state, every leaf (n_blocks, B, ...)), as
    the reference's ``cache_specs`` lays it out: the rank's ``B/dp`` lanes
    where ``dp`` divides B (its ``b_ax``), every attention cache and
    recurrent state; and of an attention cache the rank's ``KV/tp`` heads
    where attention splits by heads, in context mode its global rows
    ``[r S_max/tp, (r + 1) S_max/tp)`` (``tp`` must divide ``S_max``, as
    the reference's layout needs). Where the batch does not split, the
    reference's heads-mode layout puts ``tp`` on the rows (a storage
    layout under GSPMD); the port keeps the rank's KV heads there too. A
    recurrent mixer split over ``tp`` (``rules.mixer_split``) holds its
    state's slice too: Mamba's ``h`` (n_blocks, B, di, ds) and ``conv``
    (n_blocks, B, k-1, di) by channels, mLSTM's ``C``, ``n`` and ``m`` and
    sLSTM's ``c``, ``n``, ``h`` and ``m`` by heads (the departures from
    ``cache_specs`` are in the module's docstring). Cut leaves are
    contiguous copies."""
    if rules.grid is None:
        return cache
    _, specs = block_layout(cfg)
    lanes = ((1, rules.dp_axes),)
    if rules.tp_size == 1:
        attn = ()
    elif rules.heads_split(cfg):
        attn = ((3, rules.tp_axes),)
    elif rules.attn_mode == "context":
        attn = ((2, rules.tp_axes),)
    else:
        attn = ()
    out = []
    for spec, c in zip(specs, cache):
        first = next(iter(c.values())) if isinstance(c, dict) else c[0]
        cuts = lanes if rules.batch_split(first.shape[1]) else ()
        if spec.mixer == "attn":
            c = cut_tree(c, tuple(_cuts(rules, *cuts, *attn) for _ in c),
                         rules.grid)
        else:
            axis = (MIXER_STATE_TP_AXIS[spec.mixer]
                    if rules.mixer_split(cfg, spec.mixer) else {})
            c = cut_tree(c, {k: _cuts(rules, *cuts, (
                None if k not in axis else axis[k] + 1, rules.tp_axes))
                for k in c}, rules.grid)
        out.append(c)
    return out


def decode_params(cfg: ArchConfig, params: Any,
                  rules: ShardingRules) -> Any:
    """The decode fleet's whole tree from the a2a layout's
    (:func:`repro_torch.models.moe.expand_experts` on every MoE layer),
    both layouts the defaults ``make_moe_tables`` builds for ``rules`` in
    the train and decode phases. Leaves other than the experts are the
    same tensors."""
    nb, specs = block_layout(cfg)
    perm_a2a = default_moe_perm(cfg, rules, "train")
    perm_dec = default_moe_perm(cfg, rules, "decode")
    moe_pos = [i for i, sp in enumerate(specs) if sp.ffn == "moe"]
    m = len(moe_pos)
    blocks = list(params["blocks"])
    for j, i in enumerate(moe_pos):
        rows = np.arange(nb) * m + j                # the layers at position i
        ffn = expand_experts(blocks[i]["ffn"], perm_a2a[rows],
                             perm_dec[rows])
        blocks[i] = dict(blocks[i], ffn=ffn)
    return dict(params, blocks=blocks)
