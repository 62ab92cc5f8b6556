"""Per-arch rules on a rank grid, and a rank's slice of the params.

The counterpart of the expert part of ``repro.launch.sharding``
(``make_rules`` and the MoE leaves of ``param_specs``,
``src/repro/launch/sharding.py:39-68, 83-121``). The port keeps its dense
layers replicated on every rank, so a rank's tree differs from the whole
tree only in the expert weights:

* train and prefill (the a2a layout): the slot axis over ``ep``, and over
  ``fsdp`` a slice of axis 1 of each matrix (D of w1 and w3, F of w2);
* decode (the decode fleet's layout, :func:`repro_torch.models.moe.
  expand_experts`): the slot axis over ``ep_all``; with
  ``decode_expert_tp`` over ``ep``, and F over the rest of ``ep_all``
  (the last axis of w1 and w3, axis 1 of w2).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.model import block_layout, default_moe_perm
from repro_torch.models.moe import expand_experts
from repro_torch.models.sharding import ShardingRules

__all__ = ["make_rules", "shard_params", "shard_experts", "decode_params",
           "FSDP_THRESHOLD"]

#: params above this (count) get the experts' FSDP sharding over
#: ("pod", "data"), as the reference's ``FSDP_THRESHOLD``
FSDP_THRESHOLD = 1e9


def make_rules(cfg: ArchConfig, grid, phase: str = "train",
               moe_impl: str = "ragged") -> ShardingRules:
    """The reference's rules for ``cfg`` on ``grid`` (``None``: no group):
    EP over "model" for train and prefill, over every axis at decode;
    expert-TP at decode where one expert matrix passes 256 MiB; FSDP of
    the experts over ("pod", "data") for archs above 1e9 params; capacity
    factor 1.25 for training and 1.5 for serving; remat for training."""
    if grid is None:
        return ShardingRules(moe_impl=moe_impl)
    expert_tp = (cfg.is_moe
                 and cfg.d_model * cfg.moe_d_ff * 2 > 256 * 1024 * 1024)
    return ShardingRules(
        moe_impl=moe_impl, grid=grid, dp=("pod", "data"), ep=("model",),
        ep_all=("pod", "data", "model"),
        fsdp=("pod", "data") if cfg.n_params() > FSDP_THRESHOLD else None,
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


def shard_params(params: Any, rules: ShardingRules,
                 phase: str = "train") -> Any:
    """The rank's tree from a whole one (``models.init_params`` with the
    same rules and phase, or ``bridge.params_from_numpy`` of a reference
    checkpoint): every MoE layer's experts sliced (:func:`shard_experts`),
    every other leaf the same tensor."""
    if isinstance(params, dict):
        if "router" in params and "w1" in params:
            return shard_experts(params, rules, phase)
        return {k: shard_params(v, rules, phase) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(shard_params(v, rules, phase) for v in params)
    return params


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
