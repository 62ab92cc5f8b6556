"""Shared by the tensor-parallel tests of the port (tests/test_torch_tp.py).

Three cases at smoke size, f32, each on a grid over ("data", "model"):

* ``heads`` — granite-moe-3b-a800m on (2, 2): attention by heads (4 heads
  and 2 KV heads over 2), the dense weights FSDP-sliced over "data", the
  vocabulary (512) over "model", EP over "model";
* ``context`` — granite on (1, 4) with ``attn_mode="context"``: 8 query
  rows and 16 cache rows over 4 ranks;
* ``smollm`` — smollm-360m on (1, 2) with the rules of ``make_rules``:
  3 heads and 1 KV head force context mode; the tied embedding is vocab-
  parallel and the dense MLP's F split.

Each case runs the loss and its gradients (``heads`` and ``smollm``),
the prefill, and three decode steps continuing the single-rank port's
prefill (its cache, padded to ``S_MAX`` rows, is the whole cache the
ranks take their slices of; lane 1 restarts at row 5). :func:`tp_rank`
runs the cases of one world size on one gloo rank of the port;
:func:`jax_tp` runs every case through the reference on meshes of fake
devices, and the context cases also with ``rules=None`` (the reference's
context path has no test of its own); :func:`single` runs the port with
``rules=None``.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import numpy as np

AXES = ("data", "model")
B, S, S_MAX, STEPS = 2, 8, 16, 3
POS0 = (8, 5)              # the decode's first position a lane
GRANITE, SMOLLM = "granite-moe-3b-a800m", "smollm-360m"

#: case → (arch, grid shape, the rules' fields or "make_rules", loss run)
CASES = {
    "heads": (GRANITE, (2, 2), dict(
        dp=("data",), tp="model", ep=("model",), ep_all=("data", "model"),
        fsdp="data", attn_mode="heads", moe_block_m=8), True),
    "context": (GRANITE, (1, 4), dict(
        dp=("data",), tp="model", ep=("model",), ep_all=("data", "model"),
        fsdp=None, attn_mode="context", moe_block_m=8), False),
    "smollm": (SMOLLM, (1, 2), "make_rules", True),
}
WORLDS = {4: ("heads", "context"), 2: ("smollm",)}


def inputs(vocab: int):
    rng = np.random.default_rng(19)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    dec = rng.integers(0, vocab, size=(STEPS, B, 1)).astype(np.int32)
    return tokens, labels, dec


def positions(step: int) -> np.ndarray:
    return np.asarray(POS0, np.int32) + step


def padded_cache(prefill_cache, s_max: int = S_MAX):
    """A prefill's cache (numpy; per position a (k, v) of (nb, B, S, KV,
    hd)) as a decode cache of ``s_max`` rows, the rest zeros."""
    out = []
    for k, v in prefill_cache:
        pad = [(0, 0)] * k.ndim
        pad[2] = (0, s_max - k.shape[2])
        out.append((np.pad(k, pad), np.pad(v, pad)))
    return out


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def _torch():
    import torch
    torch.set_num_threads(1)
    return torch


def port_rules(name: str, grid, phase: str):
    """The port's rules for case ``name`` on ``grid`` (a ``Grid``, with or
    without process groups) in ``phase``."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models.sharding import ShardingRules
    arch, _, fields, _ = CASES[name]
    if fields == "make_rules":
        return make_rules(get_smoke(arch), grid, phase)
    return ShardingRules(grid=grid, **fields)


def _run_port(torch, cfg, params_for, rules_for, tables_for, whole_cache,
              cache_for, with_loss, remat_twice=False):
    """The loss (and gradients), prefill and decode of one model, with the
    params, rules, tables and decode cache each phase's callables give.
    Returns numpy results."""
    from repro_torch.models import model as tmodel
    from repro_torch.tree import leaves, tree_map
    tokens, labels, dec = inputs(cfg.vocab)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    out = {}
    if with_loss:
        runs = []
        for remat in ((False, True) if remat_twice else (None,)):
            rules = rules_for("train")
            if remat is not None:
                import dataclasses
                rules = dataclasses.replace(rules, remat=remat)
            params = params_for("train")
            for leaf in leaves(params):
                leaf.requires_grad_(True)
            loss, (tal, _) = tmodel.loss_fn(cfg, rules)(
                params, batch, tables_for("train"))
            loss.backward()
            runs.append((loss.detach(), tal,
                         [leaf.grad for leaf in leaves(params)]))
        loss, tal, grads = runs[-1]
        out["loss"] = float(loss)
        out["train_tallies"] = tal.numpy()
        out["grads"] = [g.numpy() for g in grads]
        if remat_twice:
            (l0, _, g0), (l1, _, g1) = runs
            out["remat_bit_equal"] = bool(torch.equal(l0, l1)) and all(
                torch.equal(a, b) for a, b in zip(g0, g1))
    with torch.no_grad():
        lg, cache, tal = tmodel.prefill_fn(cfg, rules_for("prefill"))(
            params_for("prefill"), {"tokens": batch["tokens"]},
            tables_for("prefill"))
        out["prefill"] = (lg.numpy(), tal.numpy())
        out["prefill_cache"] = [tuple(t.numpy() for t in c) for c in cache]
        cache = cache_for(tree_map(lambda a: torch.from_numpy(a.copy()),
                                   whole_cache))
        step = tmodel.decode_fn(cfg, rules_for("decode"))
        params = params_for("decode")
        out["decode"] = []
        for i, tok in enumerate(dec):
            lg, cache, tal = step(params, torch.from_numpy(tok), cache,
                                  torch.from_numpy(positions(i)),
                                  tables_for("decode"))
            out["decode"].append((lg.numpy(), tal.numpy()))
    return out


def single(name: str, tree, whole_cache=None):
    """Case ``name``'s model through the port's ``rules=None`` on one
    process; ``whole_cache`` None: decode from this run's own prefill."""
    torch = _torch()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as tmodel
    cfg = get_smoke(CASES[name][0])
    tables = tmodel.make_moe_tables(cfg)
    if whole_cache is None:
        tokens = inputs(cfg.vocab)[0]
        with torch.no_grad():
            _, cache, _ = tmodel.prefill_fn(cfg)(
                params_from_numpy(tree), {"tokens": torch.from_numpy(tokens)},
                tables)
        whole_cache = padded_cache([tuple(t.numpy() for t in c)
                                    for c in cache])
    out = _run_port(torch, cfg, lambda phase: params_from_numpy(tree),
                    lambda phase: None, lambda phase: tables, whole_cache,
                    lambda c: c, CASES[name][3])
    out["whole_cache"] = whole_cache
    return out


def tp_rank(rank: int, names, trees, caches):
    """One gloo rank of the port: for each case of ``names``, its grid
    (every rank builds every grid, in the same order), the rank's slice of
    the whole params ``trees[name]`` (numpy) for each phase, and the
    rank's slice of the whole decode cache ``caches[name]``."""
    torch = _torch()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (decode_params, rank_cache,
                                             shard_params)
    from repro_torch.models import model as tmodel
    out = {}
    for name in names:
        arch, shape, _, with_loss = CASES[name]
        cfg = get_smoke(arch)
        grid = make_mesh(shape, AXES)

        def params_for(phase, cfg=cfg, grid=grid, name=name):
            # a fresh tree each call: the uncut leaves are the whole
            # tree's tensors, whose gradients would add up over runs
            whole = params_from_numpy(trees[name])
            rules = port_rules(name, grid, phase)
            tree = (decode_params(cfg, whole, rules)
                    if phase == "decode" and cfg.is_moe else whole)
            return shard_params(cfg, tree, rules, phase)

        res = _run_port(
            torch, cfg, params_for,
            lambda phase, grid=grid, name=name: port_rules(name, grid, phase),
            lambda phase, cfg=cfg, grid=grid, name=name:
                tmodel.make_moe_tables(cfg, port_rules(name, grid, phase),
                                       phase=phase),
            caches[name],
            lambda c, cfg=cfg, grid=grid, name=name:
                rank_cache(cfg, c, port_rules(name, grid, "decode")),
            with_loss, remat_twice=(name == "heads"))
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# the reference, on fake devices
# ---------------------------------------------------------------------------

def jax_tp(path: str, caches_path: str) -> None:
    """Every case through the reference on a mesh of its shape (the loss by
    ``jax.value_and_grad``, the prefill, three decode steps from the whole
    cache in ``caches_path``, written by the test), and the context cases
    also with ``rules=None``; written to ``path`` (.npz). Run in a
    process whose XLA_FLAGS fake 8 devices."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.configs import get_smoke
    from repro.launch.sharding import make_rules
    from repro.models import model as jmodel
    from repro.models import moe as MOE
    from repro.models.sharding import ShardingRules
    with np.load(caches_path) as f:
        stored = {k: f[k] for k in f.files}
    res = {}
    for name, (arch, shape, fields, with_loss) in CASES.items():
        cfg = get_smoke(arch)
        n = shape[0] * shape[1]
        mesh = compat.make_mesh(shape, AXES, devices=jax.devices()[:n])

        def rules_for(phase, fields=fields, cfg=cfg, mesh=mesh):
            if fields == "make_rules":
                return make_rules(cfg, mesh, phase)
            return ShardingRules(mesh=mesh, **fields)

        ways = [("", rules_for)]
        if name != "heads":
            ways.append(("none/", lambda phase: None))
        jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        tokens, labels, dec = inputs(cfg.vocab)
        n_attn = sum(1 for k in stored if k.startswith(f"{name}/k/"))
        whole = [(stored[f"{name}/k/{i}"], stored[f"{name}/v/{i}"])
                 for i in range(n_attn)]
        for tag, rf in ways:
            key = f"{name}/{tag}"
            with compat.use_mesh(mesh):
                tab = jmodel.make_moe_tables(cfg, rf("train"), phase="train")
                if with_loss:
                    (loss, (tal, _)), g = jax.jit(jax.value_and_grad(
                        jmodel.loss_fn(cfg, rf("train")), has_aux=True))(
                            jp, {"tokens": jnp.asarray(tokens),
                                 "labels": jnp.asarray(labels)}, tab)
                    res[key + "loss"] = np.asarray(loss)
                    res[key + "train_tallies"] = np.asarray(tal)
                    for i, leaf in enumerate(jax.tree.leaves(g)):
                        res[key + f"grad/{i}"] = np.asarray(leaf)
                tab = jmodel.make_moe_tables(cfg, rf("prefill"),
                                             phase="prefill")
                lg, _, tal = jax.jit(jmodel.prefill_fn(cfg, rf("prefill")))(
                    jp, {"tokens": jnp.asarray(tokens)}, tab)
                res[key + "prefill/logits"] = np.asarray(lg)
                res[key + "prefill/tallies"] = np.asarray(tal)
                rd = rf("decode")
                jd = jp
                if cfg.is_moe and rd is not None:
                    fleet = rd.ep_all_size
                    n_moe, _ = jmodel.moe_perm_shape(cfg, rd, "decode")
                    perm_dec = MOE.default_perm_replicated(
                        n_moe, cfg.n_experts, fleet)
                    perm_a2a = MOE.default_perm_a2a(n_moe, cfg.n_experts,
                                                    rd.ep_size)
                    jd = dict(jp, blocks=[
                        dict(b, ffn=MOE.expand_experts(b["ffn"], perm_a2a,
                                                       perm_dec))
                        if "router" in b.get("ffn", {}) else b
                        for b in jp["blocks"]])
                tab = jmodel.make_moe_tables(cfg, rd, phase="decode")
                cache = [(jnp.asarray(k), jnp.asarray(v)) for k, v in whole]
                step = jax.jit(jmodel.decode_fn(cfg, rd))
                for i, tok in enumerate(dec):
                    lg, cache, tal = step(jd, jnp.asarray(tok), cache,
                                          jnp.asarray(positions(i)), tab)
                    res[key + f"decode/{i}/logits"] = np.asarray(lg)
                    res[key + f"decode/{i}/tallies"] = np.asarray(tal)
    np.savez(path, **res)
