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
whole. :func:`rank_cache` gives a rank's decode cache: its ``B/dp``
lanes where ``dp`` divides the batch (every attention cache and every
recurrent state), and its KV heads when attention splits by heads or its
``S_max/tp`` rows in context mode.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import block_layout, default_moe_perm
from repro_torch.models.moe import expand_experts
from repro_torch.models.sharding import (DENSE_D_AXIS, DENSE_TP_AXIS,
                                         ShardingRules, heads_ok)

__all__ = ["make_rules", "shard_params", "shard_experts", "decode_params",
           "rank_cache", "FSDP_THRESHOLD"]

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


def _part(t: torch.Tensor, dim: int, n: int, i: int) -> torch.Tensor:
    size = t.shape[dim]
    if size % n:
        raise ValueError(f"shard_params: axis {dim} of {tuple(t.shape)} "
                         f"over {n} ranks")
    return t.narrow(dim, i * (size // n), size // n)


def shard_experts(p: dict, rules: ShardingRules, phase: str) -> dict:
    """The rank's slice of one MoE layer's params ``{"router", "w1", "w3",
    "w2"}`` whose matrices are ``(..., n_slots, a, b)``; the router and any
    other entry stay whole. Sliced leaves are contiguous copies."""
    grid = rules.grid
    if grid is None:
        return p
    if phase == "decode":
        slot_axes, ftp_axes = rules.decode_axes
        fsdp_axes = ()
    else:
        slot_axes, ftp_axes = rules.ep_axes, ()
        fsdp_axes = rules.fsdp_axes
    out = dict(p)
    for k in ("w1", "w3", "w2"):
        t = _part(p[k], -3, grid.axis_size(slot_axes), grid.index(slot_axes))
        if fsdp_axes:
            t = _part(t, -2, grid.axis_size(fsdp_axes), grid.index(fsdp_axes))
        if ftp_axes:
            t = _part(t, -2 if k == "w2" else -1, grid.axis_size(ftp_axes),
                      grid.index(ftp_axes))
        out[k] = t.clone(memory_format=torch.contiguous_format)
    return out


def _slice(t: torch.Tensor, rules: ShardingRules, cuts) -> torch.Tensor:
    """``t`` cut by ``(dim, axes)`` pairs (``dim`` None: not cut), as a
    contiguous copy when cut at all."""
    grid = rules.grid
    out = t
    for dim, axes in cuts:
        if dim is not None and axes and grid.axis_size(axes) > 1:
            out = _part(out, dim, grid.axis_size(axes), grid.index(axes))
    if out is t:
        return t
    return out.clone(memory_format=torch.contiguous_format)


def _shard_dense(p: dict, rules: ShardingRules, split: bool) -> dict:
    """An attention mixer's or a dense MLP's stacked leaves, each cut on
    its d_model axis over ``fsdp`` and, with ``split``, on its TP axis
    over ``tp``."""
    return {k: _slice(w, rules, ((DENSE_D_AXIS[k] + 1, rules.fsdp_axes),
                                 (DENSE_TP_AXIS[k] + 1 if split else None,
                                  rules.tp_axes)))
            for k, w in p.items()}


def shard_params(cfg: ArchConfig, params: Any, rules: ShardingRules,
                 phase: str = "train") -> Any:
    """The rank's tree from a whole one (``models.init_params`` with the
    same rules and phase, or ``bridge.params_from_numpy`` of a reference
    checkpoint), cut as the reference's ``param_specs`` cuts it (see the
    module's docstring): every MoE layer's experts
    (:func:`shard_experts`), the attention and dense MLP leaves, the
    embedding and head. Cut leaves are contiguous copies; the others are
    the same tensors."""
    if rules.grid is None:
        return params
    _, specs = block_layout(cfg)
    vocab = rules.tp_axes if rules.splits(cfg.vocab) else ()
    f_axes = rules.fsdp_axes
    out = dict(params)
    out["embed"] = _slice(params["embed"], rules, ((0, vocab), (1, f_axes)))
    if "head" in params:
        out["head"] = _slice(params["head"], rules, ((0, f_axes), (1, vocab)))
    if "frontend" in params and rules.splits(cfg.d_model):
        out["frontend"] = _slice(params["frontend"], rules,
                                 ((1, rules.tp_axes),))
    blocks = []
    for spec, sub in zip(specs, params["blocks"]):
        sub = dict(sub)
        if spec.mixer == "attn":
            sub["mixer"] = _shard_dense(sub["mixer"], rules,
                                        rules.heads_split(cfg))
        if spec.ffn == "dense":
            sub["ffn"] = _shard_dense(sub["ffn"], rules,
                                      rules.splits(cfg.d_ff))
        elif spec.ffn == "moe":
            sub["ffn"] = shard_experts(sub["ffn"], rules, phase)
        if "shared" in sub:
            sub["shared"] = _shard_dense(
                sub["shared"], rules,
                rules.splits(cfg.n_shared_experts * cfg.moe_d_ff))
        blocks.append(sub)
    out["blocks"] = blocks
    return out


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
            c = tuple(_slice(t, rules, cuts + attn) for t in c)
        else:
            c = {k: _slice(t, rules, cuts) for k, t in c.items()}
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
