"""Shared by the tests of the dense MoE oracle on a rank grid
(tests/test_torch_grid_dense.py).

``moe_dispatch="dense"`` on a (2, 2) grid over ("data", "model"): every
rank gathers the whole batch and the whole expert weights and runs the
dispatch that the rules run without a grid (the single-device ragged
dispatch, or the capacity oracle), then keeps its rows: the reference's
oracle under GSPMD.

* :data:`LAYER`: the battery's inputs (``_torch_ep_ranks``: E 16, D 64,
  F 128, top-4, x (4, 8, D)) in f32 through ``moe_layer`` at train,
  prefill and decode on both paths; decode on the decode fleet's 24
  slots with two copies of 8 experts and their traffic shares (the
  replica draw, ``r_max`` 2), also with expert-TP (the slots over
  "model", F over "data"). Each case gives a rank its rows (``rows``), or
  the whole batch (``None``), and the gradients of the battery's loss
  (``mean(y²) + 0.01 aux``; the y part as the sum of the ranks' partial
  sums over the rows' ranks).
* :data:`MODEL`: granite's smoke config with the dense dispatch, as
  ``tests/_torch_sp_ranks.py``'s cases (its runner): the batch over
  "data" and the sequence over "model" (ragged), and 7 positions, so the
  batch splits and the sequence does not (capacity).

:func:`dense_rank` runs both on a gloo rank; :func:`jax_dense` runs the
layer cases through the reference's ``moe_layer`` on a (2, 2) mesh of
fake devices, and ``_torch_sp_ranks.jax_sp`` the model cases.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import numpy as np

import _torch_ep_ranks as ep
import _torch_sp_ranks as sp

SHAPE, AXES = (2, 2), ("data", "model")
#: the layer cases' rules on the grid
RULES = dict(dp=("data",), tp="model", ep=("model",), ep_all=AXES,
             fsdp="data", moe_dispatch="dense", moe_block_m=8)
#: case → (the rules' further fields, phase, params, tables, rows)
LAYER = {
    "train-ragged": (dict(moe_impl="ragged"), "train", "p", None,
                     (True, True)),
    "train-capacity": (dict(moe_impl="capacity"), "train", "p", None,
                       (True, True)),
    "prefill-ragged": (dict(moe_impl="ragged"), "prefill", "p", None, None),
    "prefill-capacity": (dict(moe_impl="capacity"), "prefill", "p", None,
                         None),
    "decode-ragged": (dict(moe_impl="ragged"), "decode", "p8", "weighted",
                      (True, False)),
    "decode-capacity": (dict(moe_impl="capacity"), "decode", "p8",
                        "weighted", (True, False)),
    "decode-expert-tp": (dict(moe_impl="ragged", decode_expert_tp=True),
                         "decode", "p8", "weighted", (True, False)),
}
_DENSE = dict(sp._GRANITE_RULES, fsdp="data", attn_mode="heads",
              moe_dispatch="dense")
#: ``_torch_sp_ranks``' cases: (arch, grid shape, rules' fields, B, S)
MODEL = {
    "dense-rows": (sp.GRANITE, SHAPE, _DENSE, 2, 8),
    "dense-batch": (sp.GRANITE, SHAPE, dict(_DENSE, moe_impl="capacity"),
                    2, 7),
}


def rows_of(case: str, coords) -> tuple:
    """The (batch, sequence) slices of x that the rank at ``coords`` holds
    in layer case ``case`` (every row where the case has no ``rows``)."""
    rows = LAYER[case][4]
    B, S = ep.battery_inputs()["x"].shape[:2]
    b, s = slice(0, B), slice(0, S)
    if rows is not None and rows[0]:
        n = B // SHAPE[0]
        b = slice(coords["data"] * n, (coords["data"] + 1) * n)
    if rows is not None and rows[1]:
        n = S // SHAPE[1]
        s = slice(coords["model"] * n, (coords["model"] + 1) * n)
    return b, s


def layer_tables(inp, case: str, slots_of, copy_cdf):
    """Case ``case``'s (slots_of, n_copies, copy_cdf) numpy, or None."""
    return ep.tables(inp, LAYER[case][3], slots_of, copy_cdf)


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def port_layer(case: str, grid=None):
    """Layer case ``case`` through the port's ``moe_layer`` on this rank
    of ``grid`` (the rank's expert slices and rows), or without one on
    one process: y (the rank's rows), tally, aux, the loss and the
    gradients of the params (the rank's slices) and of x (its rows)."""
    torch = ep._torch_setup()
    from repro_torch.launch.sharding import shard_experts
    from repro_torch.models import collectives as C
    from repro_torch.models import moe as tmoe
    from repro_torch.models.sharding import (ShardingRules, build_copy_cdf,
                                             build_slots_of)
    extra, phase, pk, _, rows = LAYER[case]
    inp = ep.battery_inputs()
    fields = dict(RULES, **extra)
    if grid is None:
        rules = ShardingRules(moe_impl=fields["moe_impl"], moe_block_m=8)
        rows, b, s = None, slice(None), slice(None)
    else:
        rules = ShardingRules(grid=grid, **fields)
        b, s = rows_of(case, grid.coords)
    p = shard_experts({k: torch.from_numpy(v) for k, v in inp[pk].items()},
                      rules, phase)
    for v in p.values():
        v.requires_grad_(True)
    x = torch.from_numpy(inp["x"][b, s].copy()).requires_grad_(True)
    tab = ep.port_tables(torch, layer_tables(inp, case, build_slots_of,
                                             build_copy_cdf))
    y, tally, aux = tmoe.moe_layer(p, x, top_k=ep.K, n_experts=ep.E,
                                   rules=rules, phase=phase, rows=rows,
                                   **tab)
    part = (y ** 2).sum() / inp["x"].size
    if rows is not None:
        axes = (rules.dp_axes if rows[0] else ()) + (
            rules.tp_axes if rows[1] else ())
        part = C.sum_partials(part, rules.group(axes))
    loss = part + 0.01 * aux
    loss.backward()
    out = {k: v.grad.numpy() for k, v in p.items()}
    out |= {"x": x.grad.numpy(), "y": y.detach().numpy(),
            "tally": tally.numpy(), "aux": float(aux.detach()),
            "loss": float(loss.detach())}
    return out


def dense_rank(rank, trees, caches):
    """One gloo rank of the (2, 2) grid: every layer case, then every
    model case (``_torch_sp_ranks.rank_case``) on the rank's slices of
    ``trees[name]`` (numpy) and of the whole decode cache
    ``caches[name]``."""
    ep._torch_setup()
    from repro_torch.launch.mesh import make_mesh
    grid = make_mesh(SHAPE, AXES)
    out = {case: port_layer(case, grid) for case in LAYER}
    for name in MODEL:
        out[name] = sp.rank_case(name, grid, trees[name], caches[name],
                                 MODEL)
    return out


# ---------------------------------------------------------------------------
# the reference, on 4 fake devices
# ---------------------------------------------------------------------------

def jax_dense(path: str) -> None:
    """Every layer case through the reference's ``moe_layer`` with
    ``moe_dispatch="dense"`` on a (2, 2) mesh, its loss (the battery's,
    on the whole batch) by ``jax.value_and_grad``; written to ``path``."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.models import moe as MOE
    from repro.models.sharding import (ShardingRules, build_copy_cdf,
                                       build_slots_of)
    mesh = compat.make_mesh(SHAPE, AXES, devices=jax.devices()[:4])
    inp = ep.battery_inputs()
    res = {}
    for case, (extra, phase, pk, _, _) in LAYER.items():
        rules = ShardingRules(mesh=mesh, **RULES, **extra)
        tab = layer_tables(inp, case, build_slots_of, build_copy_cdf)
        kw = {} if tab is None else {
            "slots_of": jnp.asarray(tab[0]), "n_copies": jnp.asarray(tab[1]),
            "copy_cdf": jnp.asarray(tab[2])}

        def loss(p, x, rules=rules, phase=phase, kw=kw):
            y, t, a = MOE.moe_layer(p, x, top_k=ep.K, n_experts=ep.E,
                                    rules=rules, phase=phase, **kw)
            return (y ** 2).sum() / inp["x"].size + 0.01 * a, (y, t, a)

        with compat.use_mesh(mesh):
            (val, (y, t, a)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, (0, 1), has_aux=True))(
                    {k: jnp.asarray(v) for k, v in inp[pk].items()},
                    jnp.asarray(inp["x"]))
        res |= {f"{case}/y": np.asarray(y), f"{case}/tally": np.asarray(t),
                f"{case}/aux": np.asarray(a), f"{case}/loss": np.asarray(val),
                f"{case}/x": np.asarray(gx)}
        res |= {f"{case}/{k}": np.asarray(v) for k, v in gp.items()}
    np.savez(path, **res)
