"""Training driver of the port: data → model → backward → AdamW →
checkpoint.

The counterpart of ``repro.launch.train``, with its arguments and printout,
plus ``device``: it runs on the card unless the caller asks for the CPU
(``--device cpu``). The model trains through the single-device ragged
path, so on the card every MoE layer's routing stage and expert FFN run
their kernels forward and backward (``repro_torch.kernels.ops``). Each
step's batch is ``synthetic_batch``'s, whole: tokens and labels, or an
audio arch's f32 frames and labels, or a vision arch's patches, tokens
and labels (``models.loss_fn`` takes each). It resumes from the newest
committed checkpoint, saves every ``ckpt_every`` steps on a background
thread, and adds up the routing tallies' logical columns: training is
where activation profiling happens, and the tallies feed a ViBE
placement for the serving fleet.

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \\
        --arch granite-moe-3b-a800m --steps 10
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --full --steps 4 --seq-len 256 --batch 4
"""

from __future__ import annotations

import argparse
import time
from typing import List, Optional

import torch

from repro_torch.configs import get, get_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.launch.sharding import param_cuts
from repro_torch.models import (ShardingRules, init_params, loss_fn,
                                make_moe_tables)
from repro_torch.training import (AdamWConfig, Checkpointer, DataConfig,
                                  adamw_init, adamw_update, cosine_lr,
                                  synthetic_batch)
from repro_torch.tree import leaves, tree_map

__all__ = ["make_train_step", "train", "main"]


def make_train_step(cfg: ArchConfig, ocfg: AdamWConfig, total: int,
                    rules: Optional[ShardingRules] = None):
    """The training step ``step(params, opt, batch, tables) -> (params,
    opt, loss, tallies)``: the loss and its backward, then AdamW at
    ``cosine_lr(ocfg, opt.step, total=total)``, in place (the reference's
    ``step_fn``, ``src/repro/launch/train.py:53-60``, and the mesh step
    ``launch/dryrun.py`` lowers). On a grid (``rules.grid``) ``params``
    and ``opt`` are the rank's slices (``shard_params``; the state of
    ``adamw_init`` on them, or restored with ``opt_cuts``), and the clip
    takes the whole tree's norm over the ranks. Every leaf of ``params``
    must require its gradient; the step leaves their ``grad`` unset."""
    lossf = loss_fn(cfg, rules)
    grid = None if rules is None else rules.grid
    cuts = None if grid is None else param_cuts(cfg, rules, "train")

    def step(params, opt, batch, tables):
        loss, (tallies, _) = lossf(params, batch, tables)
        loss.backward()
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), params)
        lr = cosine_lr(ocfg, opt.step, total=max(total, 1))
        params, opt = adamw_update(grads, opt, params, ocfg, lr, cuts=cuts,
                                   grid=grid)
        for p in leaves(params):
            p.grad = None
        return params, opt, loss.detach(), tallies.detach()

    return step


def train(arch: str, *, smoke: bool = True, steps: int = 20,
          seq_len: int = 64, batch: int = 4, ckpt_dir: str = "",
          ckpt_every: int = 10, seed: int = 0, log_every: int = 5,
          resume: bool = True, device=None,
          step_times: Optional[List[float]] = None):
    """Train ``arch`` for ``steps`` steps; returns ``(params, opt state,
    losses, tallies (n_moe, E) summed over the steps, or None)``.
    ``step_times``, when given, receives each step's wall time in seconds
    (the host clock around a step that ends in reading its loss)."""
    dev = resolve_device(device)
    cfg = get_smoke(arch) if smoke else get(arch)
    data = DataConfig(seq_len=seq_len, global_batch=batch, seed=seed)
    ocfg = AdamWConfig()
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = init_params(cfg, gen, device=dev)
    opt = adamw_init(params, ocfg)
    mt = make_moe_tables(cfg, None, device=dev)
    start = 0
    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ck is not None and resume:
        step0, tree, extras = ck.restore_latest({"params": params,
                                                 "opt": opt})
        if step0 is not None:
            params, opt = tree["params"], tree["opt"]
            start = step0
            print(f"[train] resumed from step {start}")
    for p in leaves(params):
        p.requires_grad_(True)
    step_fn = make_train_step(cfg, ocfg, steps)

    tallies_acc = None
    losses = []
    for s in range(start, steps):
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg, data, s).items()}
        t0 = time.time()
        params, opt, loss, tallies = step_fn(params, opt, b, mt)
        loss = float(loss)
        dt = time.time() - t0
        if step_times is not None:
            step_times.append(dt)
        losses.append(loss)
        if cfg.is_moe:
            # keep the logical-expert columns; the last column is the
            # capacity-dropped-assignment count (see models.moe_layer)
            t = tallies[:, :cfg.n_experts].cpu().numpy()
            tallies_acc = t if tallies_acc is None else tallies_acc + t
        if s % log_every == 0 or s == steps - 1:
            print(f"[train] step {s} loss {loss:.4f} ({dt:.2f}s)")
        if ck is not None and (s + 1) % ckpt_every == 0:
            ck.save(s + 1, {"params": params, "opt": opt},
                    extras={"loss": loss})
    if ck is not None:
        ck.save(steps, {"params": params, "opt": opt},
                extras={"loss": losses[-1] if losses else None},
                blocking=True)
    return params, opt, losses, tallies_acc


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "host)")
    args = ap.parse_args()
    _, _, losses, tallies = train(
        args.arch, smoke=args.smoke, steps=args.steps, seq_len=args.seq_len,
        batch=args.batch, ckpt_dir=args.ckpt_dir, seed=args.seed,
        device=args.device)
    print(f"[train] done: loss {losses[0]:.4f} → {losses[-1]:.4f}")
    if tallies is not None:
        spread = tallies.sum(0)
        print("[train] expert tally spread: max/min = "
              f"{spread.max() / max(spread.min(), 1):.2f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
