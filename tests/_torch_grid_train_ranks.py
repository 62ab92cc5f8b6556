"""Shared by the tests of the training step on the rank grid
(tests/test_torch_grid_train.py).

Three cases at smoke size, f32, each on a grid over ("data", "model"):

* ``heads`` — granite-moe-3b-a800m on (2, 2): the batch over "data",
  attention by heads over "model", the dense and expert weights FSDP-
  sliced over "data", EP over "model": attention leaves, the experts and
  the embedding and head are cut over both axes, the norms and the router
  are whole;
* ``context`` — granite on (1, 4) in context mode, no FSDP: the experts
  and the vocabulary over "model", attention whole;
* ``jamba`` — jamba-1.5-large-398b on (2, 2) from ``make_rules``: seven
  Mamba mixers, the norms and the router whole, the rest over "model"
  only, so most leaves are counted once over one axis or both.

Each case runs, on every rank of its grid, two AdamW steps on seeded
gradients (:func:`given_grads`, at ``cfg.lr``) with the grid's global
norm, and three training steps through ``launch.train.make_train_step``
from a state past the learning rate's warmup (:data:`START_STEP`, so the
steps move the params at about ``cfg.lr``). Rank 0 returns the states
gathered whole. After them :func:`grid_rank` saves the ``heads`` state
from its grid, restores it onto the ``context`` grid and gathers it, and
restores a ``{"params", "opt"}`` checkpoint the reference wrote onto the
``heads`` grid. :func:`reference_adamw` runs the same AdamW steps through
the reference's ``adamw_update`` on the whole tree, and
:func:`jax_grid_train` the three steps through its mesh train step,
jitted as ``launch/dryrun.py`` jits it.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import numpy as np

AXES = ("data", "model")
B, S, STEPS = 2, 8, 3
#: the optimizer's step before the three training steps: past cosine_lr's
#: warmup of 100, so the learning rate is about ``cfg.lr`` (at step 0 it
#: is 0 and the params would not move)
START_STEP = 100
#: the schedule's length, as the reference's mesh step takes it
TOTAL = 10_000
GRANITE, JAMBA = "granite-moe-3b-a800m", "jamba-1.5-large-398b"
_GRANITE_RULES = dict(dp=("data",), tp="model", ep=("model",),
                      ep_all=("data", "model"), moe_block_m=8)

#: case → (arch, grid shape, the rules' fields or "make_rules")
CASES = {
    "heads": (GRANITE, (2, 2), dict(_GRANITE_RULES, fsdp="data",
                                    attn_mode="heads")),
    "context": (GRANITE, (1, 4), dict(_GRANITE_RULES, fsdp=None,
                                      attn_mode="context")),
    "jamba": (JAMBA, (2, 2), "make_rules"),
}
#: the case whose trained state is saved from its grid, and the case whose
#: grid it is restored onto
SAVE, RESTORE = "heads", "context"
CKPT_STEP = START_STEP + STEPS


def given_grads(shapes, k: int):
    """Step ``k``'s seeded gradients (f32), one array per leaf shape."""
    rng = np.random.default_rng(40 + k)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def batches(vocab: int):
    """The three training steps' tokens and labels, each (B, S)."""
    rng = np.random.default_rng(21)
    return [(rng.integers(0, vocab, size=(B, S)).astype(np.int32),
             rng.integers(0, vocab, size=(B, S)).astype(np.int32))
            for _ in range(STEPS)]


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def _torch():
    import torch
    torch.set_num_threads(1)
    return torch


def port_rules(name: str, grid, cases=None):
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models.sharding import ShardingRules
    arch, _, fields = (cases or CASES)[name][:3]
    if fields == "make_rules":
        return make_rules(get_smoke(arch), grid, "train")
    return ShardingRules(grid=grid, **fields)


def _numpy(tree):
    from repro_torch.tree import leaves
    return [t.detach().numpy().copy() for t in leaves(tree)]


def port_steps(name: str, tree, grid=None, cases=None):
    """Case ``name``'s (of ``cases``, None: :data:`CASES`) two AdamW
    steps on the given gradients and its three training steps, on
    ``grid`` (each rank its slices, the states gathered
    whole) or, without one, on one process (``rules=None``). Returns the
    norms, the losses and each final ``{"params", "opt"}`` state's leaves
    (numpy, in ``tree.flatten``'s order), and the trained state itself."""
    torch = _torch()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import (cut_tree, gather_params,
                                             opt_cuts, param_cuts,
                                             shard_params)
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import model as tmodel
    from repro_torch.training import optimizer as topt
    from repro_torch.tree import flatten, leaves, unflatten
    cfg = get_smoke((cases or CASES)[name][0])
    ocfg = topt.AdamWConfig()
    rules = None if grid is None else port_rules(name, grid, cases)
    cuts = None if grid is None else param_cuts(cfg, rules)
    state_cuts = (None if grid is None else
                  {"params": cuts, "opt": opt_cuts(cuts)})

    def local(whole):
        return whole if grid is None else shard_params(cfg, whole, rules)

    def gathered(state):
        return state if grid is None else gather_params(state, state_cuts,
                                                        grid)

    out = {"norms": []}
    params = local(params_from_numpy(tree))
    opt = topt.adamw_init(params, ocfg)
    _, spec = flatten(tree)
    shapes = [t.shape for t in leaves(params_from_numpy(tree))]
    lr = torch.tensor(ocfg.lr)
    for k in range(2):
        g = unflatten(spec, [torch.from_numpy(a)
                             for a in given_grads(shapes, k)])
        if grid is not None:
            g = cut_tree(g, cuts, grid)
        out["norms"].append(float(topt.global_norm(g, cuts, grid)))
        params, opt = topt.adamw_update(g, opt, params, ocfg, lr, cuts=cuts,
                                        grid=grid)
    out["given"] = _numpy(gathered({"params": params, "opt": opt}))

    params = local(params_from_numpy(tree))
    for p in leaves(params):
        p.requires_grad_(True)
    opt = topt.adamw_init(params, ocfg)._replace(
        step=torch.tensor(START_STEP, dtype=torch.int32))
    step = make_train_step(cfg, ocfg, TOTAL, rules)
    tables = tmodel.make_moe_tables(cfg, rules, phase="train")
    out["losses"] = []
    for tokens, labels in batches(cfg.vocab):
        params, opt, loss, _ = step(params, opt, {
            "tokens": torch.from_numpy(tokens),
            "labels": torch.from_numpy(labels)}, tables)
        out["losses"].append(float(loss))
    state = {"params": params, "opt": opt}
    out["trained"] = _numpy(gathered(state))
    return out, state, state_cuts


def _restore(cfg, tree, directory, step, grid, rules):
    """The ``{"params", "opt"}`` checkpoint at ``directory`` restored onto
    ``grid`` (the rank's slices, by the cuts of ``rules``), into the
    structure of the whole state of ``tree``'s params."""
    from repro_torch.bridge import params_from_numpy
    from repro_torch.launch.sharding import opt_cuts, param_cuts
    from repro_torch.training import checkpoint, optimizer as topt
    whole = params_from_numpy(tree)
    like = {"params": whole, "opt": topt.adamw_init(whole)}
    cuts = param_cuts(cfg, rules)
    cuts = {"params": cuts, "opt": opt_cuts(cuts)}
    state, _ = checkpoint.load_checkpoint(directory, step, like, cuts=cuts,
                                          grid=grid)
    return state, cuts


def grid_rank(rank, trees, save_dir, ref_dir, ref_state):
    """One gloo rank of the port: every case's steps on its grid (every
    rank builds every grid, in the same order); the ``SAVE`` case's state
    saved from its grid into ``save_dir``, restored onto the ``RESTORE``
    case's grid and gathered whole; the reference's ``{"params", "opt"}``
    checkpoint in ``ref_dir`` (step 1) restored onto the ``SAVE`` case's
    grid, each leaf held against the rank's slice of ``ref_state`` (its
    leaves, numpy). Rank 0 returns the whole trees."""
    torch = _torch()
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import cut_tree, gather_params
    from repro_torch.training import checkpoint
    from repro_torch.tree import flatten, leaves, unflatten
    out, grids = {}, {}
    for name, (arch, shape, _) in CASES.items():
        grid = grids.get(shape) or grids.setdefault(shape,
                                                    make_mesh(shape, AXES))
        res, state, cuts = port_steps(name, trees[name], grid)
        if name == SAVE:
            checkpoint.save_checkpoint(save_dir, CKPT_STEP, state,
                                       n_shards=2, cuts=cuts, grid=grid)
        out[name] = res if rank == 0 else {"norms": res["norms"],
                                           "losses": res["losses"]}
    arch, shape, _ = CASES[RESTORE]
    cfg = get_smoke(arch)
    grid = grids[shape]
    state, cuts = _restore(cfg, trees[RESTORE], save_dir, CKPT_STEP, grid,
                           port_rules(RESTORE, grid))
    whole = _numpy(gather_params(state, cuts, grid))
    if rank == 0:
        out["restored"] = whole
    arch, shape, _ = CASES[SAVE]
    cfg = get_smoke(arch)
    grid = grids[shape]
    state, cuts = _restore(cfg, trees[SAVE], ref_dir, 1, grid,
                           port_rules(SAVE, grid))
    _, spec = flatten(state)
    want = cut_tree(unflatten(spec, [torch.from_numpy(a.copy())
                                     for a in ref_state]), cuts, grid)
    got, want = leaves(state), leaves(want)
    out["reference_restored"] = {
        "equal": [bool(a.dtype == b.dtype and torch.equal(a, b))
                  for a, b in zip(got, want)],
        "shapes": [tuple(a.shape) for a in got]}
    return out


# ---------------------------------------------------------------------------
# the reference, on fake devices
# ---------------------------------------------------------------------------

def reference_params(arch: str):
    """The reference's f32 smoke params of ``arch`` from key 0, numpy
    (``init_params`` jitted: eager, it dispatches op by op)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import get_smoke
    from repro.models import model as jmodel
    cfg = get_smoke(arch)
    jp = jax.jit(lambda key: jmodel.init_params(cfg, key, dtype=jnp.float32))(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp)


def reference_adamw(tree, steps: int = 2):
    """The reference's ``adamw_update`` (jitted) at ``lr`` on
    :func:`given_grads` from ``adamw_init`` of the params ``tree``
    (numpy), ``steps`` times: each step's ``{"params", "opt"}`` state and
    the global norm of its gradients."""
    import jax
    import jax.numpy as jnp
    from repro.training import optimizer as jopt
    ocfg = jopt.AdamWConfig()
    jp = jax.tree.map(jnp.asarray, tree)
    flat, treedef = jax.tree.flatten(jp)

    @jax.jit
    def step(g, opt, params):
        params, opt = jopt.adamw_update(g, opt, params, ocfg,
                                        jnp.float32(ocfg.lr))
        return params, opt, jopt.global_norm(g)

    params, opt, states, norms = jp, jopt.adamw_init(jp, ocfg), [], []
    for k in range(steps):
        g = treedef.unflatten([jnp.asarray(a) for a in given_grads(
            [leaf.shape for leaf in flat], k)])
        params, opt, norm = step(g, opt, params)
        states.append({"params": params, "opt": opt})
        norms.append(float(norm))
    return states, norms


def jax_grid_train(path: str, names, cases=None) -> None:
    """For each case of ``names`` (of ``cases``, None: :data:`CASES`):
    three steps of the reference's mesh
    train step (``value_and_grad`` and ``adamw_update`` jitted with
    ``param_specs`` and the opt specs that mirror them,
    ``launch/dryrun.py:84-124``), each step's loss and gradient norm and
    the state after them; written to ``path`` (.npz). Run in a process
    whose XLA_FLAGS fake 8 devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro import compat
    from repro.configs import get_smoke
    from repro.launch.sharding import make_rules, param_specs, \
        tree_shardings
    from repro.models import model as jmodel
    from repro.models.sharding import ShardingRules
    from repro.training import optimizer as jopt
    res = {}
    for name in names:
        arch, shape, fields = (cases or CASES)[name][:3]
        cfg = get_smoke(arch)
        ocfg = jopt.AdamWConfig()
        jp = jax.tree.map(jnp.asarray, reference_params(arch))
        n = shape[0] * shape[1]
        mesh = compat.make_mesh(shape, AXES, devices=jax.devices()[:n])
        rules = (make_rules(cfg, mesh, "train") if fields == "make_rules"
                 else ShardingRules(mesh=mesh, **fields))
        lossf = jmodel.loss_fn(cfg, rules)

        def step(params, opt, batch, mt, lossf=lossf, ocfg=ocfg):
            (loss, (tallies, _)), grads = jax.value_and_grad(
                lossf, has_aux=True)(params, batch, mt)
            lr = jopt.cosine_lr(ocfg, opt.step)
            gnorm = jopt.global_norm(grads)
            params, opt = jopt.adamw_update(grads, opt, params, ocfg, lr)
            return params, opt, loss, gnorm

        pspecs = param_specs(cfg, rules, "train")
        ospecs = jopt.OptState(P(), pspecs, pspecs, pspecs)
        pshard = tree_shardings(mesh, pspecs)
        oshard = tree_shardings(mesh, ospecs)
        scalar = NamedSharding(mesh, P())
        bshard = NamedSharding(mesh, rules.spec(rules.dp, None))
        with compat.use_mesh(mesh):
            fn = jax.jit(step, out_shardings=(pshard, oshard, scalar,
                                              scalar))
            params = jax.device_put(jp, pshard)
            opt = jopt.adamw_init(jp, ocfg)._replace(
                step=jnp.int32(START_STEP))
            opt = jax.device_put(opt, oshard)
            tab = jmodel.make_moe_tables(cfg, rules, phase="train")
            for s, (tokens, labels) in enumerate(batches(cfg.vocab)):
                batch = {"tokens": jax.device_put(tokens, bshard),
                         "labels": jax.device_put(labels, bshard)}
                params, opt, loss, gnorm = fn(params, opt, batch, tab)
                res[f"{name}/loss/{s}"] = np.asarray(loss)
                res[f"{name}/gnorm/{s}"] = np.asarray(gnorm)
        for i, leaf in enumerate(jax.tree.leaves({"params": params,
                                                  "opt": opt})):
            res[f"{name}/trained/{i}"] = np.asarray(leaf)
    np.savez(path, **res)
