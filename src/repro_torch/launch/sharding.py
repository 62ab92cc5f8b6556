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
  (:data:`repro_torch.models.sharding.DENSE_D_AXIS`).

Norms, the router and the recurrent mixers (Mamba, mLSTM, sLSTM) stay
whole. :func:`param_cuts` describes these cuts leaf by leaf (the
counterpart of ``param_specs``): :func:`shard_params` and :func:`cut_tree`
take the rank's slices by it, :func:`gather_params` gathers them whole
again, and the optimizer's norm and the checkpoints read it too; the
optimizer state takes the params' cuts (:func:`opt_cuts`).
:func:`rank_cache` gives a rank's decode cache: its ``B/dp`` lanes where
``dp`` divides the batch (every attention cache and every recurrent
state), and its KV heads when attention splits by heads or its
``S_max/tp`` rows in context mode.
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
from repro_torch.models.moe import expand_experts
from repro_torch.models.sharding import (DENSE_D_AXIS, DENSE_TP_AXIS,
                                         ShardingRules, heads_ok)
from repro_torch.training.optimizer import OptState
from repro_torch.tree import tree_map

__all__ = ["make_rules", "Cuts", "param_cuts", "opt_cuts", "cut_tree",
           "gather_params", "gather_to_rank0", "shard_params",
           "shard_experts",
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
    """How one leaf is cut on a grid: ``(dim, axes)`` pairs, applied in
    order, each a cut of axis ``dim`` into the group over ``axes`` (more
    than one rank; ``axes`` in grid order), the rank taking the block at
    its index in that group. No pair: the leaf stays whole. The
    counterpart of one ``PartitionSpec``; a tree leaf, not a sequence."""

    pairs: Tuple[Tuple[int, Tuple[str, ...]], ...] = ()

    @property
    def axes(self) -> Tuple[str, ...]:
        """Every axis that cuts the leaf (in the pairs' order)."""
        return tuple(a for _, axes in self.pairs for a in axes)


def _cuts(rules: ShardingRules, *pairs) -> Cuts:
    """The pairs that cut on ``rules``' grid: ``dim`` not None, ``axes``
    over more than one rank. A leaf cut twice over one axis would not be
    tiled by its ranks' blocks, and is refused."""
    grid = rules.grid
    kept = tuple((dim, grid.canon(axes)) for dim, axes in pairs
                 if dim is not None and axes and grid.axis_size(axes) > 1)
    out = Cuts(kept)
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


def param_cuts(cfg: ArchConfig, rules: ShardingRules,
               phase: str = "train") -> Any:
    """A tree of :class:`Cuts` matching the params tree of ``cfg`` (the
    whole one, or the decode fleet's from :func:`decode_params`), each
    leaf's cuts as the reference's ``param_specs`` cuts it on ``rules``'
    grid (see the module's docstring; every leaf whole without a grid):
    the experts (:func:`shard_experts`), the attention and dense MLP
    leaves, the embedding and head (the vocabulary over ``tp`` where it
    divides), the frontend; norms, the router and the recurrent mixers
    whole."""
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


def _part(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"shard_params: axis {dim} of {tuple(t.shape)} "
                         f"over {n} ranks")
    return t.narrow(dim, i * (size // n), size // n)


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
    for dim, axes in c.pairs:
        part = _part(part, dim, grid.axis_size(axes), grid.index(axes))
    if part is t:
        return t
    return part.clone(memory_format=torch.contiguous_format)


def cut_tree(tree: Any, cuts: Any, grid) -> Any:
    """The rank's slice of each leaf of ``tree`` (whole), cut by the
    matching leaf of ``cuts`` on ``grid`` (this rank's place in it). Cut
    leaves are contiguous copies; the others are the same tensors."""
    return _map_cuts(lambda t, c: _cut_leaf(t, c, grid), tree, cuts)


def _gather_leaf(t: torch.Tensor, c: Cuts, grid) -> torch.Tensor:
    for dim, axes in reversed(c.pairs):
        t = C.gather_shards(t, grid.group(axes), dim, summed=False)
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
    for dim, ax in c.pairs:
        shape[dim] *= grid.axis_size(ax)
    whole = part.new_empty(shape)
    for coords, raw in zip(grid.members(axes), parts):
        view = whole
        for dim, ax in c.pairs:
            size = view.shape[dim] // grid.axis_size(ax)
            view = view.narrow(dim, grid.index(ax, coords) * size, size)
        view.copy_(raw.view(part.dtype).view(part.shape))
    return whole


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


def shard_params(cfg: ArchConfig, params: Any, rules: ShardingRules,
                 phase: str = "train") -> Any:
    """The rank's tree from a whole one (``models.init_params`` with the
    same rules and phase, or ``bridge.params_from_numpy`` of a reference
    checkpoint), or from a tree of its structure (gradients, the AdamW
    moments and master), cut by :func:`param_cuts`. Cut leaves are
    contiguous copies; the others are the same tensors."""
    if rules.grid is None:
        return params
    return cut_tree(params, param_cuts(cfg, rules, phase), rules.grid)


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
    layout under GSPMD); the port keeps the rank's KV heads there too.
    Cut leaves are contiguous copies."""
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
            c = cut_tree(c, {k: _cuts(rules, *cuts) for k in c}, rules.grid)
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
