"""Shared by the tests of the recurrent mixers' tensor parallelism
(tests/test_torch_mixer_tp.py).

Three cases at smoke size, f32, each on a grid over ("data", "model"),
in the layout of ``tests/_torch_sp_ranks.py``'s cases (whose runs they
reuse):

* ``xlstm`` — xlstm-350m on (2, 2) from ``make_rules``: the batch over
  "data", the residual's positions over "model", the sLSTM and the mLSTM
  mixer each split by heads (one of 2 a rank);
* ``xlstm_whole`` — xlstm on (1, 4) from ``make_rules``: 4 ranks do not
  divide 2 heads, so both mixers stay whole and run on the gathered
  sequence;
* ``jamba_fsdp`` — jamba-1.5-large-398b on (2, 2) with FSDP over "data":
  seven Mamba mixers split by channels (128 of 256 a rank), their
  ``in_proj``/``out_proj`` d_model axis gathered over "data", attention by
  heads, the MoE layer (E 4, K 2) and the dense MLP.

Each case runs the loss and its gradients, the prefill (logits, tallies,
the rank's cache) and three decode steps (``_torch_sp_ranks._run_port``).
:func:`mixer_rank` also runs ``xlstm``'s AdamW and training steps on its
grid (``_torch_grid_train_ranks.port_steps``), saves the trained state
from the grid, restores it onto the (1, 4) grid and gathers it, and
round-trips each case's whole params through ``cut_tree`` and
``gather_params`` / ``gather_to_rank0``. :func:`jax_mixer` and
:func:`jax_mixer_train` run the reference on fake devices.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import numpy as np

import _torch_grid_train_ranks as gt
import _torch_sp_ranks as sp

AXES = sp.AXES
XLSTM, JAMBA = "xlstm-350m", "jamba-1.5-large-398b"

#: case → (arch, grid shape, the rules' fields or "make_rules", B, S)
CASES = {
    "xlstm": (XLSTM, (2, 2), "make_rules", 2, 8),
    "xlstm_whole": (XLSTM, (1, 4), "make_rules", 2, 8),
    "jamba_fsdp": (JAMBA, (2, 2), dict(
        dp=("data",), tp="model", ep=("model",), ep_all=("data", "model"),
        fsdp="data", attn_mode="heads", moe_block_m=8), 2, 8),
}
#: the case whose training steps run, and the grid its state is restored
#: onto
TRAIN, RESTORE_SHAPE = "xlstm", (1, 4)
TRAIN_CASES = {TRAIN: CASES[TRAIN][:3]}


def _np(t):
    return t.detach().numpy().copy()


def mixer_rank(rank: int, trees, caches, ckpt_dir):
    """One gloo rank of the port: every case on its grid (every rank builds
    every grid, in the same order) from the rank's slice of the whole
    params ``trees[name]`` (numpy) for each phase and of the whole decode
    cache ``caches[name]``; the shapes of the rank's mixer leaves; then
    :data:`TRAIN`'s steps, its state saved from the grid into
    ``ckpt_dir``, restored onto :data:`RESTORE_SHAPE` and gathered; and
    each case's params cut and gathered back. Rank 0 returns the whole
    states."""
    torch = sp._torch()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (cut_tree, decode_params,
                                             gather_params, gather_to_rank0,
                                             param_cuts, rank_cache,
                                             shard_params)
    from repro_torch.models import model as tmodel
    from repro_torch.training import checkpoint
    from repro_torch.tree import leaves
    out, grids = {}, {}
    for name, (arch, shape, _, _, _) in CASES.items():
        cfg = get_smoke(arch)
        grid = grids.get(shape) or grids.setdefault(shape,
                                                    make_mesh(shape, AXES))

        def rules_for(phase, grid=grid, name=name):
            return sp.port_rules(name, grid, phase, CASES)

        def params_for(phase, cfg=cfg, name=name):
            # a fresh tree each call: the uncut leaves are the whole
            # tree's tensors, whose gradients would add up over runs
            whole = params_from_numpy(trees[name])
            rules = rules_for(phase)
            tree = (decode_params(cfg, whole, rules)
                    if phase == "decode" and cfg.is_moe else whole)
            return shard_params(cfg, tree, rules, phase)

        res = sp._run_port(
            torch, name, cfg, params_for, rules_for,
            lambda phase, cfg=cfg: tmodel.make_moe_tables(
                cfg, rules_for(phase), phase=phase),
            caches[name],
            lambda c, cfg=cfg: rank_cache(cfg, c, rules_for("decode")),
            CASES)
        res["mixer_shapes"] = [
            {k: tuple(t.shape) for k, t in sub["mixer"].items()}
            for sub in params_for("train")["blocks"]]
        # the whole params cut by the rank's cuts and gathered back: over
        # the groups (every rank), and to rank 0 alone
        whole = params_from_numpy(trees[name])
        cuts = param_cuts(cfg, rules_for("train"))
        mine = cut_tree(whole, cuts, grid)
        back = gather_params(mine, cuts, grid)
        res["round_trip"] = all(torch.equal(a, b) for a, b in
                                zip(leaves(back), leaves(whole)))
        to0 = [gather_to_rank0(t, c, grid)
               for t, c in zip(leaves(mine), leaves(cuts))]
        if rank == 0:
            res["to_rank0"] = all(torch.equal(a, b) for a, b in
                                  zip(to0, leaves(whole)))
        out[name] = res
    grid = grids[CASES[TRAIN][1]]
    res, state, cuts = gt.port_steps(TRAIN, trees[TRAIN], grid, TRAIN_CASES)
    checkpoint.save_checkpoint(ckpt_dir, gt.CKPT_STEP, state, n_shards=2,
                               cuts=cuts, grid=grid)
    out["train"] = res if rank == 0 else {"norms": res["norms"],
                                          "losses": res["losses"]}
    cfg = get_smoke(CASES[TRAIN][0])
    grid = grids.get(RESTORE_SHAPE) or make_mesh(RESTORE_SHAPE, AXES)
    restored, rcuts = gt._restore(
        cfg, trees[TRAIN], ckpt_dir, gt.CKPT_STEP, grid,
        gt.port_rules(TRAIN, grid, TRAIN_CASES))
    whole = [_np(t) for t in leaves(gather_params(restored, rcuts, grid))]
    if rank == 0:
        out["restored"] = whole
    return out


def jax_mixer(path: str, caches_path: str, names) -> None:
    """The cases of ``names`` through the reference on meshes of fake
    devices (``_torch_sp_ranks.jax_sp``)."""
    sp.jax_sp(path, caches_path, names, CASES)


def jax_mixer_train(path: str) -> None:
    """:data:`TRAIN`'s steps through the reference's mesh train step
    (``_torch_grid_train_ranks.jax_grid_train``)."""
    gt.jax_grid_train(path, [TRAIN], TRAIN_CASES)
