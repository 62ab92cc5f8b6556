"""AdamW with f32 master weights and moments, in tensor ops.

The counterpart of ``repro.training.optimizer`` with its semantics: one
global norm over every gradient in f32 and the clip scale from it, bias
corrections from the incremented step, decay decoupled and applied to the
f32 master, the new parameter the master cast to the parameter's dtype.
The reference computes it outside any Pallas kernel, and so does the port:
plain tensor ops, no kernel of its own. ``torch.optim.AdamW`` is not used:
it keeps no f32 master for bf16 parameters and clips nothing.

Unlike the reference, which returns new arrays, :func:`adamw_update`
updates the parameters and the state in place, leaf by leaf and, for a
large leaf, in slices along its first axis: at full width the state is
three f32 copies of the parameters already, so no fourth may be live.
Every scalar of the step (the clip scale, the bias corrections, the
learning rate) stays a tensor on the parameters' device, so a step never
waits for the card.

On a rank grid each rank holds its slices of the parameters, gradients
and state (``launch.sharding.param_cuts`` / ``opt_cuts``, as the
reference's state mirrors its param specs). The update is elementwise and
runs on the slices as they are; only the clip's norm is the whole tree's:
:func:`global_norm` with the tree's cuts adds each rank's sums of squares
over the ranks that hold the other slices of the same leaves.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, NamedTuple, Optional, Tuple

import torch

from repro_torch.models import collectives as C
from repro_torch.tree import leaves, tree_map

__all__ = ["AdamWConfig", "OptState", "adamw_init", "adamw_update",
           "adamw_apply", "clip_scale", "global_norm", "norm_partials",
           "cosine_lr"]

#: most elements of a leaf updated at once (256 MB of f32 temporaries)
_SLICE = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    master_fp32: bool = True     # keep fp32 master weights (bf16 params)


class OptState(NamedTuple):
    step: torch.Tensor           # scalar int32
    mu: Any                      # first moments (f32)
    nu: Any                      # second moments (f32)
    master: Optional[Any]        # f32 master weights (or None)


def _zeros_tree(tree):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), tree)


def adamw_init(params, cfg: AdamWConfig = AdamWConfig()) -> OptState:
    """Zero moments and step; the master a copy of every parameter in f32
    (a copy even where the parameter is f32 already, since the update
    writes it in place)."""
    dev = leaves(params)[0].device
    master = (tree_map(lambda p: p.detach().to(torch.float32, copy=True),
                       params) if cfg.master_fp32 else None)
    return OptState(torch.zeros((), dtype=torch.int32, device=dev),
                    _zeros_tree(params), _zeros_tree(params), master)


def _slices(*tensors) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching slices along the first axis of same-shaped tensors, each
    at most ``_SLICE`` elements where the shape allows."""
    t0 = tensors[0]
    if t0.dim() == 0 or t0.numel() <= _SLICE:
        yield tensors
        return
    step = max(1, _SLICE // max(1, t0[0].numel()))
    for i in range(0, t0.shape[0], step):
        yield tuple(t[i:i + step] for t in tensors)


@torch.no_grad()
def norm_partials(tree, cuts=None, grid=None
                  ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """This rank's f32 sums of squares of the leaves of ``tree``, one sum
    for each set of grid axes that cuts some leaf (``cuts``, a tree of
    ``launch.sharding.Cuts`` matching ``tree``; ``()`` for the whole
    leaves, every leaf without ``cuts``), keyed by the set in grid order,
    in the order the leaves first show each set. A leaf whose grouped cut
    keeps some groups whole counts those with the axes that cut them
    (``Cuts.pieces``). Each sum adds its leaves in tree order, each leaf in
    slices of at most ``_SLICE`` elements."""
    flat = leaves(tree)
    flat_cuts = [None] * len(flat) if cuts is None else leaves(cuts)
    if len(flat_cuts) != len(flat):
        raise ValueError("global_norm: the tree and its cuts differ in "
                         "structure")
    out: Dict[Tuple[str, ...], torch.Tensor] = {}
    for leaf, c in zip(flat, flat_cuts):
        parts = ([(leaf, ())] if c is None or grid is None
                 else c.pieces(leaf, grid))
        for piece, axes in parts:
            key = () if grid is None else grid.canon(axes)
            for (s,) in _slices(piece):
                v = torch.sum(torch.square(s.to(torch.float32)))
                out[key] = out[key] + v if key in out else v
    return out


@torch.no_grad()
def global_norm(tree, cuts=None, grid=None) -> torch.Tensor:
    """sqrt of the sum of every leaf's squares, in f32. With ``cuts`` (and
    the ``grid`` they cut on) ``tree`` holds this rank's slices and the
    norm is the whole tree's, equal on every rank: each set of axes'
    partial sum (:func:`norm_partials`) is summed over the group of those
    axes, one ``all_reduce`` a set, and the sets' totals are added in
    order. Over the axes that do not cut it, a leaf is counted once: its
    slice is the same on those ranks (its gradient was summed over them in
    the backward)."""
    total = None
    for axes, part in norm_partials(tree, cuts, grid).items():
        if axes:
            part = C.all_reduce_(part, grid.group(axes))
        total = part if total is None else total + part
    return torch.sqrt(total)


def cosine_lr(cfg: AdamWConfig, step, warmup: int = 100,
              total: int = 10_000) -> torch.Tensor:
    """Linear warmup, then a cosine from ``lr`` to 0.1 ``lr``; f32."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = s / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < warmup, warm, 0.1 + 0.9 * cos)


def clip_scale(gnorm: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """The gradients' factor for a global norm ``gnorm`` (``grad_clip >
    0``): ``grad_clip / gnorm``, at most 1."""
    return torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)


@torch.no_grad()
def adamw_update(grads, state: OptState, params,
                 cfg: AdamWConfig = AdamWConfig(),
                 lr: Optional[torch.Tensor] = None, cuts=None,
                 grid=None) -> Tuple[Any, OptState]:
    """One AdamW step, in place, clipped by the global norm of ``grads``
    (the whole tree's, with the ``cuts`` of a rank's slices on ``grid``:
    :func:`global_norm`). Returns ``(params, state)``: the same tensors,
    updated."""
    if cfg.grad_clip > 0:
        scale = clip_scale(global_norm(grads, cuts, grid), cfg)
    else:
        scale = torch.ones((), dtype=torch.float32, device=state.step.device)
    return adamw_apply(grads, state, params, cfg, lr, scale)


@torch.no_grad()
def adamw_apply(grads, state: OptState, params, cfg: AdamWConfig,
                lr: Optional[torch.Tensor], scale: torch.Tensor
                ) -> Tuple[Any, OptState]:
    """The per-leaf update of :func:`adamw_update` with the gradients'
    clip factor ``scale`` given: elementwise and in place, no exchange."""
    step = state.step + 1
    dev = step.device
    if lr is None:
        lr = torch.tensor(cfg.lr, dtype=torch.float32, device=dev)
    t = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(cfg.b1, t)
    bc2 = 1.0 - torch.pow(cfg.b2, t)
    flat_p = leaves(params)
    flat_g = leaves(grads)
    flat_mu = leaves(state.mu)
    flat_nu = leaves(state.nu)
    flat_ma = (leaves(state.master) if state.master is not None
               else [None] * len(flat_p))
    if not len(flat_p) == len(flat_g) == len(flat_mu) == len(flat_nu) \
            == len(flat_ma):
        raise ValueError("adamw_update: params, grads and state differ in "
                         "structure")
    for p, g, mu, nu, ma in zip(flat_p, flat_g, flat_mu, flat_nu, flat_ma):
        parts = (p, g, mu, nu) if ma is None else (p, g, mu, nu, ma)
        for sl in _slices(*parts):
            ps, gs, mus, nus = sl[:4]
            gf = gs.to(torch.float32) * scale
            mus.mul_(cfg.b1).add_((1.0 - cfg.b1) * gf)
            nus.mul_(cfg.b2).add_((1.0 - cfg.b2) * gf * gf)
            upd = (mus / bc1) / (torch.sqrt(nus / bc2) + cfg.eps)
            base = sl[4] if ma is not None else ps.to(torch.float32)
            if cfg.weight_decay:
                upd = upd + cfg.weight_decay * base
            new = base - lr * upd
            if ma is not None:
                sl[4].copy_(new)
            ps.copy_(new.to(ps.dtype))
    return params, OptState(step, state.mu, state.nu, state.master)
