"""Shared by the expert-parallel tests of the port (tests/test_torch_ep*.py).

* The inputs, made with numpy from fixed seeds, as the reference's battery
  (tests/test_ep_dispatch.py) builds them: E=16 experts, D=64, F=128,
  top-4, x (4, 8, D) and a longer x9 (4, 32, D), bf16 weights, an f32
  router; the permuted, phantom-padded (E=6 on 8 slots) and replicated
  (24 slots, 0.25 / 0.75 shares) placements.
* ``CHECKS``: the battery's eleven checks, each a set of rules fields, a
  phase and its inputs.
* :func:`battery_rank` runs the checks on one rank of a (2, 4) gloo grid
  over ("data", "model") through the port (``repro_torch``);
  :func:`jax_battery` runs them through the reference on an 8-device
  mesh, in a process started with
  ``--xla_force_host_platform_device_count=8``; :func:`model_rank` and
  :func:`jax_model` do the same for the model's loss, prefill and decode
  at smoke size on a (1, 4) grid.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np

E, D, F, K = 16, 64, 128, 4
SHAPE, AXES = (2, 4), ("data", "model")
BF16_TOL = 5e-2        # the port against the reference (tests/test_kernels.py)

#: name → (rules fields, phase, x, params, tables, top_k, n_experts)
CHECKS = {
    "a2a": (dict(fsdp=None, capacity_factor=8.0), "train", "x", "p", None,
            K, E),
    "a2a+fsdp": (dict(fsdp="data", capacity_factor=8.0), "train", "x", "p",
                 None, K, E),
    "replicated": (dict(ep_all=("data", "model"), fsdp=None,
                        moe_dispatch="replicated", capacity_factor=8.0),
                   "decode", "x", "p", None, K, E),
    "expert-tp": (dict(ep_all=("data", "model"), fsdp=None,
                       moe_dispatch="replicated", capacity_factor=8.0,
                       decode_expert_tp=True), "decode", "x", "p", None, K,
                  E),
    "permuted": (dict(fsdp=None, capacity_factor=8.0), "train", "x", "p2",
                 "perm", K, E),
    "phantom": (dict(fsdp=None, capacity_factor=8.0), "train", "x", "p3",
                "phantom", 2, 6),
    "a2a+weighted": (dict(fsdp=None, capacity_factor=8.0), "train", "x",
                     "p8", "weighted", K, E),
    "replicated+weighted": (dict(ep_all=("data", "model"), fsdp=None,
                                 moe_dispatch="replicated",
                                 capacity_factor=8.0), "decode", "x", "p8",
                            "weighted", K, E),
    "capacity-drops": (dict(fsdp=None, capacity_factor=0.25,
                            moe_impl="capacity"), "train", "x9", "p", None,
                       K, E),
    "capacity-baseline": (dict(fsdp=None, capacity_factor=8.0,
                               moe_impl="capacity"), "train", "x", "p", None,
                          K, E),
    "ragged-starved": (dict(fsdp=None, capacity_factor=0.25,
                            moe_impl="ragged"), "train", "x9", "p", None, K,
                       E),
    "ragged-starved-replicated": (dict(ep_all=("data", "model"), fsdp=None,
                                       moe_dispatch="replicated",
                                       capacity_factor=0.25,
                                       moe_impl="ragged"), "decode", "x9",
                                  "p", None, K, E),
}
#: gradient checks → the check whose rules, phase and x they run: the
#: battery's check 5 (a2a + FSDP), the same loss through the replicated
#: body and its expert-TP variant (their psum and F slices), and through
#: the capacity a2a body dropless (factor 8) and starved (factor 0.25)
GRADS = {"grads": "a2a+fsdp", "grads-replicated": "replicated",
         "grads-expert-tp": "expert-tp",
         "grads-capacity-baseline": "capacity-baseline",
         "grads-capacity-drops": "capacity-drops"}
#: the gradient checks whose drops depend on each rank's token count, and
#: so differ from one process's (``rules=None``: no drops)
GRADS_WITH_DROPS = ("grads-capacity-drops",)
GRAD_RULES = GRADS["grads"]


def _moe(rng, d, f, e, n_slots):
    return {"router": (rng.standard_normal((d, e)) / np.sqrt(d)
                       ).astype(np.float32),
            "w1": (rng.standard_normal((n_slots, d, f)) / np.sqrt(d)
                   ).astype(np.float32),
            "w3": (rng.standard_normal((n_slots, d, f)) / np.sqrt(d)
                   ).astype(np.float32),
            "w2": (rng.standard_normal((n_slots, f, d)) / np.sqrt(f)
                   ).astype(np.float32)}


def battery_inputs():
    """f32 numpy arrays; each side rounds the expert weights and x to bf16
    (round to nearest even on both)."""
    rng = np.random.default_rng(0)
    p = _moe(rng, D, F, E, E)
    x = rng.standard_normal((4, 8, D)).astype(np.float32)
    x9 = rng.standard_normal((4, 32, D)).astype(np.float32)
    perm = rng.permutation(E).astype(np.int32)
    p2 = dict(p, **{k: p[k][perm] for k in ("w1", "w3", "w2")})
    p3 = _moe(np.random.default_rng(2), D, F, 6, 8)
    perm8 = np.concatenate([np.arange(E), np.arange(8)]).astype(np.int32)
    p8 = dict(p, **{k: p[k][perm8] for k in ("w1", "w3", "w2")})
    share8 = np.ones((1, 24))
    share8[0, :8] = 0.25
    share8[0, 16:] = 0.75
    return dict(p=p, p2=p2, p3=p3, p8=p8, x=x, x9=x9, perm=perm[None],
                perm3=np.tile(np.arange(8, dtype=np.int32), (1, 1)),
                perm8=perm8[None], share8=share8)


def tables(inp, kind, build_slots_of, build_copy_cdf):
    """(slots_of, n_copies, copy_cdf) numpy for a check's placement, or
    ``None``; the table functions are passed in (the reference's or the
    port's copies)."""
    if kind is None:
        return None
    if kind == "perm":
        so, nc = build_slots_of(inp["perm"], E, E)
        return so[0], nc[0], None
    if kind == "phantom":
        so, nc = build_slots_of(inp["perm3"], 6, 8)
        return so[0], nc[0], None
    so, nc = build_slots_of(inp["perm8"], E, 24)
    cdf = build_copy_cdf(inp["perm8"], E, 24, share=inp["share8"])
    return so[0], nc[0], cdf[0]


# ---------------------------------------------------------------------------
# the port, one rank
# ---------------------------------------------------------------------------

def _torch_setup():
    import torch
    torch.set_num_threads(1)
    return torch


def _t(torch, a, bf16):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.to(torch.bfloat16) if bf16 else t


def port_params(torch, p):
    return {k: _t(torch, v, k != "router") for k, v in p.items()}


def port_tables(torch, tab):
    if tab is None:
        return {}
    so, nc, cdf = tab
    out = {"slots_of": torch.from_numpy(so), "n_copies": torch.from_numpy(nc)}
    if cdf is not None:
        out["copy_cdf"] = torch.from_numpy(cdf)
    return out


def battery_rank(rank: int, names):
    """One rank of the (2, 4) grid: each named check through the port's
    ``moe_layer`` on the rank's slice of the weights, and the gradient
    check. Returns {name: (y, tally, aux)} and the rank's gradients."""
    torch = _torch_setup()
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import shard_experts
    from repro_torch.models import moe as tmoe
    from repro_torch.models.sharding import (ShardingRules, build_copy_cdf,
                                             build_slots_of)
    grid = make_mesh(SHAPE, AXES)
    inp = battery_inputs()
    out, grads = {}, {}
    for name in names:
        if name in GRADS:
            grads[name] = _rank_grads(torch, grid, inp, GRADS[name])
            continue
        fields, phase, xk, pk, tk, top_k, n_exp = CHECKS[name]
        rules = ShardingRules(grid=grid, dp=("data",), ep=("model",),
                              **fields)
        p = shard_experts(port_params(torch, inp[pk]), rules, phase)
        tab = port_tables(torch, tables(inp, tk, build_slots_of,
                                        build_copy_cdf))
        y, tally, aux = tmoe.moe_layer(p, _t(torch, inp[xk], True),
                                       top_k=top_k, n_experts=n_exp,
                                       rules=rules, phase=phase, **tab)
        out[name] = (y.float().numpy(), tally.numpy(), float(aux))
    return out, grads


def _rank_grads(torch, grid, inp, check):
    """The rank's gradients of ``mean(y²) + 0.01·aux`` under ``check``'s
    rules on its x: the router and x whole, the experts the rank's
    slice."""
    from repro_torch.launch.sharding import shard_experts
    from repro_torch.models import moe as tmoe
    from repro_torch.models.sharding import ShardingRules
    fields, phase, xk = CHECKS[check][:3]
    rules = ShardingRules(grid=grid, dp=("data",), ep=("model",), **fields)
    p = shard_experts(port_params(torch, inp["p"]), rules, phase)
    for v in p.values():
        v.requires_grad_(True)
    x = _t(torch, inp[xk], True).requires_grad_(True)
    y, _, aux = tmoe.moe_layer(p, x, top_k=K, n_experts=E, rules=rules,
                               phase=phase)
    loss = (y.float() ** 2).mean() + 0.01 * aux
    loss.backward()
    grads = {k: v.grad.float().numpy() for k, v in p.items()}
    grads["x"] = x.grad.float().numpy()
    grads["loss"] = float(loss.detach())
    return grads


def rank_slice(full: dict, name: str, rank: int, torch=None) -> dict:
    """Rank ``rank``'s slice of a whole MoE param dict (numpy) under the
    rules of check ``name``: the port's ``shard_experts`` on a grid object
    that only places the rank (no process group)."""
    torch = torch or _torch_setup()
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.sharding import shard_experts
    from repro_torch.models.sharding import ShardingRules
    fields, phase = CHECKS[name][:2]
    rules = ShardingRules(grid=Grid(SHAPE, AXES, rank, {}), dp=("data",),
                          ep=("model",), **fields)
    part = shard_experts({k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in full.items()}, rules, phase)
    return {k: v.numpy() for k, v in part.items()}


def single_rank(name):
    """Check ``name``'s inputs through the port's ``rules=None`` on one
    process: (y, tally, aux)."""
    torch = _torch_setup()
    from repro_torch.models import moe as tmoe
    from repro_torch.models.sharding import build_copy_cdf, build_slots_of
    inp = battery_inputs()
    _, _, xk, pk, tk, top_k, n_exp = CHECKS[name]
    tab = port_tables(torch, tables(inp, tk, build_slots_of, build_copy_cdf))
    y, tally, aux = tmoe.moe_layer(port_params(torch, inp[pk]),
                                   _t(torch, inp[xk], True), top_k=top_k,
                                   n_experts=n_exp, rules=None, **tab)
    return y.float().numpy(), tally.numpy(), float(aux)


def hold(ranks, ref, name, tol=1e-6):
    """Hold check ``name``'s rank outputs: the same on every rank, within
    ``tol`` of the port's ``rules=None`` (tallies and aux equal), and
    against the reference's mesh run ``ref`` (tallies exactly, outputs
    within ``BF16_TOL``). Returns rank 0's (y, tally)."""
    y, tally, aux = ranks[0][0][name]
    for r, (out, _) in enumerate(ranks[1:], 1):
        np.testing.assert_array_equal(out[name][0], y, err_msg=f"rank {r}")
        np.testing.assert_array_equal(out[name][1], tally)
    y1, t1, a1 = single_rank(name)
    err = float(np.abs(y - y1).max())
    assert err <= tol, f"{name}: max |y - y(rules=None)| {err} > {tol}"
    np.testing.assert_array_equal(tally, t1)
    np.testing.assert_allclose(aux, a1, rtol=1e-6)
    np.testing.assert_array_equal(tally, ref[f"{name}/tally"])
    np.testing.assert_allclose(y, ref[f"{name}/y"], rtol=BF16_TOL,
                               atol=BF16_TOL)
    np.testing.assert_allclose(aux, float(ref[f"{name}/aux"]), rtol=1e-4)
    return y, tally


# ---------------------------------------------------------------------------
# the reference, on 8 (or 4) fake devices
# ---------------------------------------------------------------------------

def jax_battery(path: str, names) -> None:
    """The reference's ``moe_layer`` on a (2, 4) mesh for each named check
    (and ``jax.grad`` of the gradient check's loss), written to ``path``
    (.npz). Run in a process whose XLA_FLAGS fake 8 devices."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.models import moe as MOE
    from repro.models.sharding import (ShardingRules, build_copy_cdf,
                                       build_slots_of)
    mesh = compat.make_mesh(SHAPE, AXES)
    inp = battery_inputs()

    def jp(p):
        return {k: jnp.asarray(v, jnp.float32 if k == "router"
                               else jnp.bfloat16) for k, v in p.items()}

    res = {}
    for name in names:
        if name in GRADS:
            continue
        fields, phase, xk, pk, tk, top_k, n_exp = CHECKS[name]
        rules = ShardingRules(mesh=mesh, dp=("data",), ep=("model",),
                              **fields)
        tab = tables(inp, tk, build_slots_of, build_copy_cdf)
        kw = {} if tab is None else {
            "slots_of": jnp.asarray(tab[0]), "n_copies": jnp.asarray(tab[1]),
            "copy_cdf": None if tab[2] is None else jnp.asarray(tab[2])}
        with compat.use_mesh(mesh):
            y, t, a = jax.jit(lambda p, x: MOE.moe_layer(
                p, x, top_k=top_k, n_experts=n_exp, rules=rules, phase=phase,
                **kw))(jp(inp[pk]), jnp.asarray(inp[xk], jnp.bfloat16))
        res[f"{name}/y"] = np.asarray(y, np.float32)
        res[f"{name}/tally"] = np.asarray(t)
        res[f"{name}/aux"] = np.asarray(a)
    for name in (n for n in names if n in GRADS):
        fields, phase, xk = CHECKS[GRADS[name]][:3]
        rules = ShardingRules(mesh=mesh, dp=("data",), ep=("model",),
                              **fields)

        def loss(p, x, rules=rules, phase=phase):
            y, _, a = MOE.moe_layer(p, x, top_k=K, n_experts=E, rules=rules,
                                    phase=phase)
            return (y.astype(jnp.float32) ** 2).mean() + 0.01 * a

        with compat.use_mesh(mesh):
            val, (gp, gx) = jax.jit(jax.value_and_grad(loss, (0, 1)))(
                jp(inp["p"]), jnp.asarray(inp[xk], jnp.bfloat16))
        for k, v in gp.items():
            res[f"{name}/{k}"] = np.asarray(v, np.float32)
        res[f"{name}/x"] = np.asarray(gx, np.float32)
        res[f"{name}/loss"] = np.asarray(val)
    np.savez(path, **res)


def start_reference(fn: str, path: str, n_devices: int, *args):
    """Start ``fn(path, *args)`` of this module (or ``"module.fn"`` of
    another test helper) in a fresh interpreter with ``n_devices`` fake CPU
    devices; returns the ``Popen``."""
    module, _, fn = fn.rpartition(".")
    here = os.path.dirname(os.path.abspath(__file__))
    src = os.path.join(here, "..", "src")
    env = dict(os.environ)
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={n_devices}"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join([here, src])
    code = (f"import {module or '_torch_ep_ranks'} as h; "
            f"h.{fn}({path!r}, *{args!r})")
    return subprocess.Popen([sys.executable, "-c", code], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def wait_reference(proc, path: str, timeout: float = 600.0) -> dict:
    out, err = proc.communicate(timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed ({proc.returncode}):\n"
                           f"{out[-2000:]}\n{err[-4000:]}")
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


# ---------------------------------------------------------------------------
# the model at smoke size on a (1, 4) grid
# ---------------------------------------------------------------------------

MODEL_ARCH = "granite-moe-3b-a800m"
MODEL_SHAPE = (1, 4)
MODEL_B, MODEL_S, DEC_B, DEC_S_MAX, DEC_STEPS = 2, 8, 2, 16, 3


def model_inputs(vocab: int):
    rng = np.random.default_rng(7)
    tokens = rng.integers(0, vocab, size=(MODEL_B, MODEL_S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(MODEL_B, MODEL_S)).astype(np.int32)
    dec = rng.integers(0, vocab, size=(DEC_STEPS, DEC_B, 1)).astype(np.int32)
    pos = np.array([3, 0], np.int32)
    return tokens, labels, dec, pos


def model_rank(rank, tree, remat=False):
    """One rank of a (1, 4) grid over ("data", "model"): the port's loss
    (and its gradients, the rank's slice), prefill and three decode steps
    (the decode fleet's weights from ``decode_params``) on the rank's
    slice of the f32 smoke params ``tree`` (numpy)."""
    torch = _torch_setup()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import decode_params, shard_params
    from repro_torch.models import model as tmodel
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.tree import leaves
    cfg = get_smoke(MODEL_ARCH)
    grid = make_mesh(MODEL_SHAPE, AXES)
    rules = ShardingRules(grid=grid, dp=("data",), ep=("model",),
                          ep_all=("data", "model"), fsdp=None,
                          moe_block_m=8, remat=remat)
    tokens, labels, dec, pos = model_inputs(cfg.vocab)
    whole = params_from_numpy(tree)
    params = shard_params(cfg, whole, rules, "train")
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    tables = tmodel.make_moe_tables(cfg, rules, phase="train")
    loss, (tallies, aux) = tmodel.loss_fn(cfg, rules)(
        params, {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}, tables)
    loss.backward()
    out = {"loss": float(loss.detach()), "train_tallies": tallies.numpy(),
           "grads": [leaf.grad.numpy() for leaf in leaves(params)]}
    with torch.no_grad():
        params = shard_params(cfg, whole, rules, "prefill")
        lg, _, tal = tmodel.prefill_fn(cfg, rules)(
            params, {"tokens": torch.from_numpy(tokens)}, tables)
        out["prefill"] = (lg.numpy(), tal.numpy())
        params = shard_params(cfg, decode_params(cfg, whole, rules), rules,
                              "decode")
        tables = tmodel.make_moe_tables(cfg, rules, phase="decode")
        cache = tmodel.init_cache(cfg, DEC_B, DEC_S_MAX, dtype=torch.float32)
        step = tmodel.decode_fn(cfg, rules)
        out["decode"] = []
        p_ = pos
        for tok in dec:
            lg, cache, tal = step(params, torch.from_numpy(tok), cache,
                                  torch.from_numpy(p_), tables)
            out["decode"].append((lg.numpy(), tal.numpy()))
            p_ = p_ + 1
    return out


def jax_model(path: str) -> None:
    """The reference's loss (``jax.value_and_grad``), prefill and decode of
    the smoke config on a (1, 4) mesh over ("data", "model"), EP over
    "model" and decode over both axes, on the f32 params of
    ``init_params(cfg, PRNGKey(0))`` (the decode fleet's from
    ``expand_experts``); written to ``path``."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.configs import get_smoke
    from repro.models import model as jmodel
    from repro.models import moe as MOE
    from repro.models.sharding import ShardingRules
    cfg = get_smoke(MODEL_ARCH)
    mesh = compat.make_mesh(MODEL_SHAPE, AXES)
    rules = ShardingRules(mesh=mesh, dp=("data",), ep=("model",),
                          ep_all=("data", "model"), fsdp=None,
                          moe_block_m=8)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tokens, labels, dec, pos = model_inputs(cfg.vocab)
    res = {}
    with compat.use_mesh(mesh):
        tab = jmodel.make_moe_tables(cfg, rules, phase="train")
        lossf = jmodel.loss_fn(cfg, rules)
        (loss, (tal, _)), g = jax.jit(jax.value_and_grad(
            lossf, has_aux=True))(jp, {"tokens": jnp.asarray(tokens),
                                       "labels": jnp.asarray(labels)}, tab)
        res["loss"] = np.asarray(loss)
        res["train_tallies"] = np.asarray(tal)
        for i, leaf in enumerate(jax.tree.leaves(g)):
            res[f"grad/{i}"] = np.asarray(leaf)
        lg, _, tal = jax.jit(jmodel.prefill_fn(cfg, rules))(
            jp, {"tokens": jnp.asarray(tokens)}, tab)
        res["prefill/logits"], res["prefill/tallies"] = (np.asarray(lg),
                                                         np.asarray(tal))
        n_moe, _ = jmodel.moe_perm_shape(cfg, rules, "decode")
        perm_dec = MOE.default_perm_replicated(n_moe, cfg.n_experts, 4)
        perm_a2a = MOE.default_perm_a2a(n_moe, cfg.n_experts, 4)
        blocks = [dict(b, ffn=MOE.expand_experts(b["ffn"], perm_a2a,
                                                 perm_dec))
                  if "router" in b.get("ffn", {}) else b
                  for b in jp["blocks"]]
        jd = dict(jp, blocks=blocks)
        tab = jmodel.make_moe_tables(cfg, rules, phase="decode")
        cache = jmodel.init_cache(cfg, DEC_B, DEC_S_MAX, rules,
                                  dtype=jnp.float32)
        step = jax.jit(jmodel.decode_fn(cfg, rules))
        p_ = pos
        for i, tok in enumerate(dec):
            lg, cache, tal = step(jd, jnp.asarray(tok), cache,
                                  jnp.asarray(p_), tab)
            res[f"decode/{i}/logits"] = np.asarray(lg)
            res[f"decode/{i}/tallies"] = np.asarray(tal)
            p_ = p_ + 1
    np.savez(path, **res)
