"""Shared by the tests of FSDP over more axes than the batch splits
(tests/test_torch_grid_fsdp.py).

The grid is (2, 2, 1) over ("pod", "data", "model") with the batch over
"data" alone and FSDP over ("pod", "data"): the two "pod" ranks of a
"data" coordinate hold the same rows and different FSDP slices, so a
gathered leaf's gradient sums over "data" and each rank keeps its own
slice over "pod". Beside it every case runs with FSDP over "data" alone
(:data:`NARROW`), where the same sums run over the same ranks.

* the battery (``_torch_ep_ranks``' inputs in f32: E 16, D 64, F 128,
  top-4, x (4, 8, D)) through the a2a ragged and capacity bodies and the
  replicated body at train: y, tally, aux and the gradients of
  ``mean(y²) + 0.01 aux`` (each rank its slice of the experts);
* granite-moe-3b-a800m's and smollm-360m's smoke configs in f32:
  ``loss_fn`` and its gradients, gathered whole;
* one ``make_train_step`` step of granite, the state gathered whole and
  saved from the grid.

:func:`fsdp_rank` runs them on a gloo rank; :func:`jax_fsdp` runs the
reference's ``moe_layer`` and ``loss_fn`` on a mesh of 4 fake devices
with the same rules, its params placed by ``param_specs``.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import numpy as np

import _torch_ep_ranks as ep

SHAPE, AXES = (2, 2, 1), ("pod", "data", "model")
#: the rules' fields on the grid: FSDP wider than the batch's axes
WIDE = dict(dp=("data",), tp="model", ep=("model",), ep_all=AXES,
            fsdp=("pod", "data"), moe_block_m=8)
#: the same with FSDP over the batch's axis alone
NARROW = dict(WIDE, fsdp=("data",))
#: battery case → the rules' further fields
BATTERY = {"a2a": dict(moe_impl="ragged", capacity_factor=8.0),
           "capacity": dict(moe_impl="capacity", capacity_factor=8.0),
           "replicated": dict(moe_impl="ragged", moe_dispatch="replicated",
                              capacity_factor=8.0)}
GRANITE, SMOLLM = "granite-moe-3b-a800m", "smollm-360m"
ARCHS = (GRANITE, SMOLLM)
B, S = 2, 8
#: the optimizer's step before the training step: past the warmup, so
#: the step moves the params at about ``cfg.lr``
START_STEP = 100
TOTAL = 10_000
CKPT_STEP = START_STEP + 1


def batch(vocab: int):
    """The loss's tokens and labels, each (B, S)."""
    rng = np.random.default_rng(23)
    return (rng.integers(0, vocab, size=(B, S)).astype(np.int32),
            rng.integers(0, vocab, size=(B, S)).astype(np.int32))


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def battery_rank_slice(full: dict, rank: int, fields: dict) -> dict:
    """Rank ``rank``'s slice (numpy) of a whole MoE param dict under
    ``fields`` on the grid (a grid object that only places the rank)."""
    torch = ep._torch_setup()
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.sharding import shard_experts
    from repro_torch.models.sharding import ShardingRules
    rules = ShardingRules(grid=Grid(SHAPE, AXES, rank, {}), **fields)
    part = shard_experts({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in full.items()}, rules, "train")
    return {k: v.numpy() for k, v in part.items()}


def _battery(torch, grid, fields, inp):
    from repro_torch.launch.sharding import shard_experts
    from repro_torch.models import moe as tmoe
    from repro_torch.models.sharding import ShardingRules
    rules = ShardingRules(grid=grid, **fields)
    p = shard_experts({k: torch.from_numpy(v) for k, v in inp["p"].items()},
                      rules, "train")
    for v in p.values():
        v.requires_grad_(True)
    x = torch.from_numpy(inp["x"]).requires_grad_(True)
    y, tally, aux = tmoe.moe_layer(p, x, top_k=ep.K, n_experts=ep.E,
                                   rules=rules, phase="train")
    loss = (y ** 2).mean() + 0.01 * aux
    loss.backward()
    out = {k: v.grad.numpy() for k, v in p.items()}
    out |= {"x": x.grad.numpy(), "y": y.detach().numpy(),
            "tally": tally.numpy(), "aux": float(aux.detach()),
            "loss": float(loss.detach())}
    return out


def _loss_grads(torch, cfg, tree, rules):
    """``loss_fn`` of ``cfg`` on the rank's slices of ``tree`` (numpy)
    and its gradients gathered whole (numpy leaves)."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.sharding import (gather_params, param_cuts,
                                             shard_params)
    from repro_torch.models import model as tmodel
    from repro_torch.training import optimizer as topt
    from repro_torch.tree import leaves, tree_map
    params = shard_params(cfg, params_from_numpy(tree), rules, "train")
    for p in leaves(params):
        p.requires_grad_(True)
    tokens, labels = batch(cfg.vocab)
    tables = tmodel.make_moe_tables(cfg, rules, phase="train")
    loss, (tallies, _) = tmodel.loss_fn(cfg, rules)(
        params, {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}, tables)
    loss.backward()
    grads = tree_map(lambda p: p.grad, params)
    cuts = param_cuts(cfg, rules)
    whole = gather_params(grads, cuts, rules.grid)
    return {"loss": float(loss.detach()), "tallies": tallies.numpy(),
            "grads": [g.numpy() for g in leaves(whole)],
            "norm": float(topt.global_norm(grads, cuts, rules.grid)),
            "norm_whole": float(topt.global_norm(whole))}


def train_step(cfg, tree, rules, save_dir=None):
    """One ``make_train_step`` step of ``cfg`` from ``tree`` (numpy) at
    step :data:`START_STEP`, on the rank's slices (``rules`` on a grid)
    or on one process (``rules=None``); the loss and the ``{"params",
    "opt"}`` state after it, gathered whole (numpy leaves). With
    ``save_dir`` the state is saved from the grid first."""
    torch = ep._torch_setup()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.sharding import (gather_params, opt_cuts,
                                             param_cuts, shard_params)
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import model as tmodel
    from repro_torch.training import checkpoint, optimizer as topt
    from repro_torch.tree import leaves
    grid = None if rules is None else rules.grid
    ocfg = topt.AdamWConfig()
    params = params_from_numpy(tree)
    if grid is not None:
        params = shard_params(cfg, params, rules, "train")
    for p in leaves(params):
        p.requires_grad_(True)
    opt = topt.adamw_init(params, ocfg)._replace(
        step=torch.tensor(START_STEP, dtype=torch.int32))
    tokens, labels = batch(cfg.vocab)
    step = make_train_step(cfg, ocfg, TOTAL, rules)
    params, opt, loss, _ = step(params, opt, {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels)},
        tmodel.make_moe_tables(cfg, rules, phase="train"))
    state = {"params": params, "opt": opt}
    out = {"loss": float(loss)}
    if grid is not None:
        cuts = param_cuts(cfg, rules)
        cuts = {"params": cuts, "opt": opt_cuts(cuts)}
        if save_dir is not None:
            checkpoint.save_checkpoint(save_dir, CKPT_STEP, state,
                                       n_shards=2, cuts=cuts, grid=grid)
            # restored onto the grid with the cuts: the rank's slices
            whole = params_from_numpy(tree)
            back, _ = checkpoint.load_checkpoint(
                save_dir, CKPT_STEP, {"params": whole,
                                      "opt": topt.adamw_init(whole, ocfg)},
                cuts=cuts, grid=grid)
            out["restored_equal"] = [bool(torch.equal(a, b.detach()))
                                     for a, b in zip(leaves(back),
                                                     leaves(state))]
        state = gather_params(state, cuts, grid)
    out["state"] = [t.detach().numpy().copy() for t in leaves(state)]
    return out


def _case(fn, *args):
    """``fn(*args)``, or the traceback of what it raised: a case that
    fails on every rank alike (a refusal) fails its own test, and the
    other cases still run."""
    import traceback
    try:
        return fn(*args)
    except Exception:                      # reported to the case's test
        return {"error": traceback.format_exc()}


def fsdp_rank(rank, trees, save_dir):
    """One gloo rank of the (2, 2, 1) grid: the battery's cases and both
    archs' losses under :data:`WIDE` and :data:`NARROW`, then granite's
    training step under :data:`WIDE`, saved from the grid into
    ``save_dir``. ``trees``: each arch's f32 params (numpy)."""
    torch = ep._torch_setup()
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models.sharding import ShardingRules
    grid = make_mesh(SHAPE, AXES)
    inp = ep.battery_inputs()
    out = {}
    for way, fields in (("wide", WIDE), ("narrow", NARROW)):
        for name, extra in BATTERY.items():
            out[f"{way}/{name}"] = _case(_battery, torch, grid,
                                         fields | extra, inp)
        for arch in ARCHS:
            out[f"{way}/{arch}"] = _case(
                _loss_grads, torch, get_smoke(arch), trees[arch],
                ShardingRules(grid=grid, **fields))
    out["step"] = _case(train_step, get_smoke(GRANITE), trees[GRANITE],
                        ShardingRules(grid=grid, **WIDE), save_dir)
    return out


# ---------------------------------------------------------------------------
# the reference, on 4 fake devices
# ---------------------------------------------------------------------------

def jax_fsdp(path: str) -> None:
    """The reference on a (2, 2, 1) mesh under :data:`WIDE`: the battery's
    cases (``moe_layer`` and ``jax.value_and_grad`` of the battery's loss)
    and each arch's ``loss_fn`` with its gradients (params placed by
    ``param_specs``, the batch by ``rules.dp``); written to ``path``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from repro import compat
    from repro.configs import get_smoke
    from repro.launch.sharding import param_specs, tree_shardings
    from repro.models import model as jmodel
    from repro.models import moe as MOE
    from repro.models.sharding import ShardingRules
    from _torch_grid_train_ranks import reference_params
    mesh = compat.make_mesh(SHAPE, AXES, devices=jax.devices()[:4])
    inp = ep.battery_inputs()
    res = {}
    for name, extra in BATTERY.items():
        rules = ShardingRules(mesh=mesh, **WIDE, **extra)

        def loss(p, x, rules=rules):
            y, t, a = MOE.moe_layer(p, x, top_k=ep.K, n_experts=ep.E,
                                    rules=rules, phase="train")
            return (y ** 2).mean() + 0.01 * a, (y, t, a)

        with compat.use_mesh(mesh):
            (val, (y, t, a)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, (0, 1), has_aux=True))(
                    {k: jnp.asarray(v) for k, v in inp["p"].items()},
                    jnp.asarray(inp["x"]))
        res |= {f"{name}/y": np.asarray(y), f"{name}/tally": np.asarray(t),
                f"{name}/aux": np.asarray(a), f"{name}/loss": np.asarray(val),
                f"{name}/x": np.asarray(gx)}
        res |= {f"{name}/{k}": np.asarray(v) for k, v in gp.items()}
    for arch in ARCHS:
        cfg = get_smoke(arch)
        rules = ShardingRules(mesh=mesh, **WIDE)
        jp = jax.tree.map(jnp.asarray, reference_params(arch))
        tokens, labels = batch(cfg.vocab)
        bshard = NamedSharding(mesh, rules.spec(rules.dp, None))
        with compat.use_mesh(mesh):
            params = jax.device_put(jp, tree_shardings(
                mesh, param_specs(cfg, rules, "train")))
            tab = jmodel.make_moe_tables(cfg, rules, phase="train")
            (loss, (tal, _)), g = jax.jit(jax.value_and_grad(
                jmodel.loss_fn(cfg, rules), has_aux=True))(
                    params, {"tokens": jax.device_put(tokens, bshard),
                             "labels": jax.device_put(labels, bshard)}, tab)
        res[f"{arch}/loss"] = np.asarray(loss)
        res[f"{arch}/tallies"] = np.asarray(tal)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            res[f"{arch}/grad/{i}"] = np.asarray(leaf)
    np.savez(path, **res)
