"""Shared by the port's tests of the batch over ``dp`` and the sequence-
sharded residual (tests/test_torch_sp.py).

Eight cases at smoke size, f32, each on a grid over ("data", "model"):

* ``heads`` — granite-moe-3b-a800m on (2, 2): the batch (2) over "data",
  the residual's 8 positions over "model", attention by heads, the dense
  weights FSDP-sliced over "data", EP over "model";
* ``context`` — granite on (1, 4) with ``attn_mode="context"``: the
  rank's 2 positions are its query rows against the gathered keys;
* ``smollm`` — smollm-360m on (2, 2) from ``make_rules``: context mode,
  the dense MLP's F and the tied vocabulary split under SP;
* ``jamba`` — jamba-1.5-large-398b on (2, 2) from ``make_rules``: seven
  Mamba mixers run on the gathered sequence, one attention layer by
  heads, the MoE layer (E 4, K 2) and the dense MLP under SP;
* ``odd_batch`` — smollm on (2, 2) with a batch of 3: ``dp`` does not
  divide it, so the batch stays whole (the sequence still splits);
* ``odd_seq`` — granite on (2, 2) with 7 positions: ``tp`` does not
  divide them, so the sequence stays whole (the batch still splits) and
  the MoE layer falls back to its replicated body at train and prefill;
* ``dp_only`` — granite on (2, 2) with ``tp`` over an axis the grid
  lacks (both packages drop it: the dense layers replicated, as phase 13
  runs them): the batch splits, the sequence does not, and the MoE layer
  takes its a2a block's positions over "model" and gives them back;
* ``ep_data`` — granite on (2, 2) with hand-built rules: no ``dp``, the
  sequence over "model" and the experts over "data", so the MoE layer
  gathers the sequence over "model" and takes its a2a block's positions
  over "data", and back.

Each case runs the loss and its gradients, the prefill (logits, tallies,
the rank's cache) and three decode steps continuing the single-rank
port's prefill (its cache padded to ``S_MAX`` rows is the whole cache the
ranks take their slices of). :func:`sp_rank` runs every case on one gloo
rank of the port and records the shape of the residual stream entering
each block; it also restores a checkpoint written whole onto the
``heads`` grid and computes the loss. :func:`jax_sp` runs every case
through the reference on meshes of fake devices; :func:`single` runs the
port with ``rules=None``.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import numpy as np

AXES = ("data", "model")
S_MAX, STEPS = 16, 3
GRANITE, SMOLLM, JAMBA = ("granite-moe-3b-a800m", "smollm-360m",
                          "jamba-1.5-large-398b")
_GRANITE_RULES = dict(dp=("data",), tp="model", ep=("model",),
                      ep_all=("data", "model"), moe_block_m=8)

#: case → (arch, grid shape, the rules' fields or "make_rules", B, S)
CASES = {
    "heads": (GRANITE, (2, 2), dict(_GRANITE_RULES, fsdp="data",
                                    attn_mode="heads"), 2, 8),
    "context": (GRANITE, (1, 4), dict(_GRANITE_RULES, fsdp=None,
                                      attn_mode="context"), 2, 8),
    "smollm": (SMOLLM, (2, 2), "make_rules", 2, 8),
    "jamba": (JAMBA, (2, 2), "make_rules", 2, 8),
    "odd_batch": (SMOLLM, (2, 2), "make_rules", 3, 8),
    "odd_seq": (GRANITE, (2, 2), dict(_GRANITE_RULES, fsdp="data",
                                      attn_mode="heads"), 2, 7),
    "dp_only": (GRANITE, (2, 2), dict(_GRANITE_RULES, tp="replica",
                                      fsdp="data"), 2, 8),
    "ep_data": (GRANITE, (2, 2), dict(_GRANITE_RULES, dp=(), ep=("data",),
                                      fsdp=None, attn_mode="heads"), 2, 8),
}
#: the case whose grid a whole checkpoint is restored onto
RESTORE = "heads"


def inputs(name: str, vocab: int, cases=None):
    """Tokens and labels (B, S) and three decode steps' tokens (B, 1) of
    case ``name`` of ``cases`` (None: :data:`CASES`)."""
    _, _, _, B, S = (cases or CASES)[name]
    rng = np.random.default_rng(20)
    tokens = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(B, S)).astype(np.int32)
    dec = rng.integers(0, vocab, size=(STEPS, B, 1)).astype(np.int32)
    return tokens, labels, dec


def positions(name: str, step: int, cases=None) -> np.ndarray:
    """The decode's positions: lane j continues from row ``S - j``."""
    _, _, _, B, S = (cases or CASES)[name]
    return (S - np.arange(B) % 3 + step).astype(np.int32)


def padded_cache(prefill_cache, s_max: int = S_MAX):
    """A prefill's cache (numpy; per position a (k, v) of (nb, B, S, KV,
    hd), or a recurrent state dict) as a decode cache of ``s_max`` rows,
    the rest zeros; recurrent states as they are."""
    out = []
    for c in prefill_cache:
        if isinstance(c, dict):
            out.append(dict(c))
            continue
        pad = [(0, 0)] * c[0].ndim
        pad[2] = (0, s_max - c[0].shape[2])
        out.append(tuple(np.pad(t, pad) for t in c))
    return out


def flat_cache(cache):
    """A cache as ``{key: array}`` (for an .npz), keys ``i/k``, ``i/v`` or
    ``i/<state>``."""
    out = {}
    for i, c in enumerate(cache):
        items = c.items() if isinstance(c, dict) else zip("kv", c)
        for k, t in items:
            out[f"{i}/{k}"] = t
    return out


def unflat_cache(flat, kinds):
    """The inverse of :func:`flat_cache`; ``kinds`` per position: "attn"
    or a recurrent mixer's name."""
    out = []
    for i, kind in enumerate(kinds):
        if kind == "attn":
            out.append((flat[f"{i}/k"], flat[f"{i}/v"]))
        else:
            pre = f"{i}/"
            out.append({k[len(pre):]: v for k, v in flat.items()
                        if k.startswith(pre)})
    return out


def _np(c):
    return ({k: v.numpy() for k, v in c.items()} if isinstance(c, dict)
            else tuple(t.numpy() for t in c))


# ---------------------------------------------------------------------------
# the port
# ---------------------------------------------------------------------------

def _torch():
    import torch
    torch.set_num_threads(1)
    return torch


def port_rules(name: str, grid, phase: str, cases=None):
    """The port's rules for case ``name`` of ``cases`` (None:
    :data:`CASES`) on ``grid`` (a ``Grid``, with or without process
    groups) in ``phase``."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models.sharding import ShardingRules
    arch, _, fields, _, _ = (cases or CASES)[name]
    if fields == "make_rules":
        return make_rules(get_smoke(arch), grid, phase)
    return ShardingRules(grid=grid, **fields)


class _Shapes:
    """Records the shape of the residual stream entering each block, per
    phase, while installed over ``model._block_body``."""

    def __init__(self, tmodel):
        self.tmodel, self.seen = tmodel, {}

    def __enter__(self):
        real = self.real = self.tmodel._block_body

        def body(*args, **kw):
            self.seen.setdefault(kw["phase"], set()).add(
                tuple(args[4].shape[:2]))
            return real(*args, **kw)

        self.tmodel._block_body = body
        return self

    def __exit__(self, *exc):
        self.tmodel._block_body = self.real


def _run_port(torch, name, cfg, params_for, rules_for, tables_for,
              whole_cache, cache_for, cases=None):
    """The loss (and gradients), prefill and decode of case ``name`` of
    ``cases`` (None: :data:`CASES`), with the params, rules, tables and
    decode cache each phase's callables give. Returns numpy results."""
    from repro_torch.models import model as tmodel
    from repro_torch.tree import leaves, tree_map
    tokens, labels, dec = inputs(name, cfg.vocab, cases)
    batch = {"tokens": torch.from_numpy(tokens),
             "labels": torch.from_numpy(labels)}
    out = {}
    with _Shapes(tmodel) as shapes:
        params = params_for("train")
        for leaf in leaves(params):
            leaf.requires_grad_(True)
        loss, (tal, _) = tmodel.loss_fn(cfg, rules_for("train"))(
            params, batch, tables_for("train"))
        loss.backward()
        out["loss"] = float(loss.detach())
        out["train_tallies"] = tal.detach().numpy()
        out["grads"] = [leaf.grad.numpy() for leaf in leaves(params)]
        with torch.no_grad():
            lg, cache, tal = tmodel.prefill_fn(cfg, rules_for("prefill"))(
                params_for("prefill"), {"tokens": batch["tokens"]},
                tables_for("prefill"))
            out["prefill"] = (lg.numpy(), tal.numpy())
            out["prefill_cache"] = [_np(c) for c in cache]
            cache = cache_for(tree_map(lambda a: torch.from_numpy(a.copy()),
                                       whole_cache))
            step = tmodel.decode_fn(cfg, rules_for("decode"))
            params = params_for("decode")
            out["decode"] = []
            for i, tok in enumerate(dec):
                lg, cache, tal = step(params, torch.from_numpy(tok), cache,
                                      torch.from_numpy(positions(name, i,
                                                                 cases)),
                                      tables_for("decode"))
                out["decode"].append((lg.numpy(), tal.numpy()))
    out["shapes"] = {k: sorted(v) for k, v in shapes.seen.items()}
    return out


def single(name: str, tree, cases=None):
    """Case ``name`` of ``cases`` (None: :data:`CASES`): its model through
    the port's ``rules=None`` on one process, decoding from its own
    prefill's cache (returned as ``whole_cache``)."""
    torch = _torch()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as tmodel
    cfg = get_smoke((cases or CASES)[name][0])
    tables = tmodel.make_moe_tables(cfg)
    tokens = inputs(name, cfg.vocab, cases)[0]
    with torch.no_grad():
        _, cache, _ = tmodel.prefill_fn(cfg)(
            params_from_numpy(tree), {"tokens": torch.from_numpy(tokens)},
            tables)
    whole_cache = padded_cache([_np(c) for c in cache])
    out = _run_port(torch, name, cfg, lambda phase: params_from_numpy(tree),
                    lambda phase: None, lambda phase: tables, whole_cache,
                    lambda c: c, cases)
    out["whole_cache"] = whole_cache
    return out


def rank_case(name: str, grid, tree, cache, cases=None):
    """Case ``name`` of ``cases`` (None: :data:`CASES`) on this rank of
    ``grid``: its model on the rank's slice of the whole params ``tree``
    (numpy) for each phase, decoding from its slice of the whole decode
    cache ``cache`` (:func:`_run_port`)."""
    torch = _torch()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import (decode_params, rank_cache,
                                             shard_params)
    from repro_torch.models import model as tmodel
    cfg = get_smoke((cases or CASES)[name][0])

    def rules_for(phase):
        return port_rules(name, grid, phase, cases)

    def params_for(phase):
        # a fresh tree each call: the uncut leaves are the whole tree's
        # tensors, whose gradients would add up over runs
        whole = params_from_numpy(tree)
        rules = rules_for(phase)
        whole = (decode_params(cfg, whole, rules)
                 if phase == "decode" and cfg.is_moe else whole)
        return shard_params(cfg, whole, rules, phase)

    return _run_port(
        torch, name, cfg, params_for, rules_for,
        lambda phase: tmodel.make_moe_tables(cfg, rules_for(phase),
                                             phase=phase),
        cache, lambda c: rank_cache(cfg, c, rules_for("decode")), cases)


def sp_rank(rank: int, trees, caches, ckpt_dir):
    """One gloo rank of the port: every case (every rank builds every
    grid, in the same order) on the rank's slice of the whole params
    ``trees[name]`` (numpy) for each phase and of the whole decode cache
    ``caches[name]``; then the loss after restoring the checkpoint in
    ``ckpt_dir`` (step 1, written whole) onto :data:`RESTORE`'s grid."""
    torch = _torch()
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as tmodel
    from repro_torch.training import checkpoint
    out = {}
    grids = {}
    for name, (arch, shape, _, _, _) in CASES.items():
        grid = grids.get(shape) or grids.setdefault(shape,
                                                    make_mesh(shape, AXES))
        out[name] = rank_case(name, grid, trees[name], caches[name])
    arch, shape = CASES[RESTORE][:2]
    cfg = get_smoke(arch)
    rules = port_rules(RESTORE, grids[shape], "train")
    like = params_from_numpy(trees[RESTORE])
    params, _ = checkpoint.load_checkpoint(ckpt_dir, 1, like, rules=rules,
                                           cfg=cfg)
    tokens, labels, _ = inputs(RESTORE, cfg.vocab)
    with torch.no_grad():
        loss, _ = tmodel.loss_fn(cfg, rules)(
            params, {"tokens": torch.from_numpy(tokens),
                     "labels": torch.from_numpy(labels)},
            tmodel.make_moe_tables(cfg, rules, phase="train"))
    out["restored_loss"] = float(loss)
    return out


# ---------------------------------------------------------------------------
# the reference, on fake devices
# ---------------------------------------------------------------------------

#: cases whose loss the reference also differentiates with ``rules=None``
#: (keys ``<case>/none/...``): on a batch that ``dp`` does not divide, the
#: reference's mesh run gives its tied embedding another gradient than its
#: ``rules=None`` run and than the port (the loss and the other leaves
#: agree), so that case's gradients are held against ``rules=None``
GRADS_WITHOUT_MESH = ("odd_batch",)


def jax_sp(path: str, caches_path: str, names=None, cases=None) -> None:
    """Every case of ``names`` (None: all) of ``cases`` (None:
    :data:`CASES`) through the reference on a mesh
    of its shape (the loss by ``jax.value_and_grad``, the prefill, three
    decode steps from the whole cache in ``caches_path``, written by the
    test), written to ``path`` (.npz); the loss of
    :data:`GRADS_WITHOUT_MESH` also with ``rules=None``. Run in a process
    whose XLA_FLAGS fake 8 devices."""
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
    for name, (arch, shape, fields, _, _) in (cases or CASES).items():
        if names is not None and name not in names:
            continue
        cfg = get_smoke(arch)
        n = shape[0] * shape[1]
        mesh = compat.make_mesh(shape, AXES, devices=jax.devices()[:n])

        def rf(phase, fields=fields, cfg=cfg, mesh=mesh):
            if fields == "make_rules":
                return make_rules(cfg, mesh, phase)
            return ShardingRules(mesh=mesh, **fields)

        jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        tokens, labels, dec = inputs(name, cfg.vocab, cases)
        _, specs = jmodel.block_layout(cfg)
        whole = unflat_cache(
            {k[len(name) + 1:]: v for k, v in stored.items()
             if k.startswith(name + "/")}, [s.mixer for s in specs])
        key = f"{name}/"
        with compat.use_mesh(mesh):
            tab = jmodel.make_moe_tables(cfg, rf("train"), phase="train")
            (loss, (tal, _)), g = jax.jit(jax.value_and_grad(
                jmodel.loss_fn(cfg, rf("train")), has_aux=True))(
                    jp, {"tokens": jnp.asarray(tokens),
                         "labels": jnp.asarray(labels)}, tab)
            res[key + "loss"] = np.asarray(loss)
            res[key + "train_tallies"] = np.asarray(tal)
            for i, leaf in enumerate(jax.tree.leaves(g)):
                res[key + f"grad/{i}"] = np.asarray(leaf)
            if name in GRADS_WITHOUT_MESH:
                _, g = jax.jit(jax.value_and_grad(
                    jmodel.loss_fn(cfg, None), has_aux=True))(
                        jp, {"tokens": jnp.asarray(tokens),
                             "labels": jnp.asarray(labels)}, tab)
                for i, leaf in enumerate(jax.tree.leaves(g)):
                    res[key + f"none/grad/{i}"] = np.asarray(leaf)
            tab = jmodel.make_moe_tables(cfg, rf("prefill"), phase="prefill")
            lg, _, tal = jax.jit(jmodel.prefill_fn(cfg, rf("prefill")))(
                jp, {"tokens": jnp.asarray(tokens)}, tab)
            res[key + "prefill/logits"] = np.asarray(lg)
            res[key + "prefill/tallies"] = np.asarray(tal)
            rd = rf("decode")
            jd = jp
            if cfg.is_moe:
                n_moe, _ = jmodel.moe_perm_shape(cfg, rd, "decode")
                perm_dec = MOE.default_perm_replicated(
                    n_moe, cfg.n_experts, rd.ep_all_size)
                perm_a2a = MOE.default_perm_a2a(n_moe, cfg.n_experts,
                                                rd.ep_size)
                nb = len(jp["blocks"][0]["ln1"])
                m = sum(1 for s in specs if s.ffn == "moe")
                blocks, j = [], 0
                for b, s in zip(jp["blocks"], specs):
                    if s.ffn == "moe":
                        rows = np.arange(nb) * m + j
                        b = dict(b, ffn=MOE.expand_experts(
                            b["ffn"], perm_a2a[rows], perm_dec[rows]))
                        j += 1
                    blocks.append(b)
                jd = dict(jp, blocks=blocks)
            tab = jmodel.make_moe_tables(cfg, rd, phase="decode")
            cache = jax.tree.map(jnp.asarray, whole)
            step = jax.jit(jmodel.decode_fn(cfg, rd))
            for i, tok in enumerate(dec):
                lg, cache, tal = step(jd, jnp.asarray(tok), cache,
                                      jnp.asarray(positions(name, i, cases)),
                                      tab)
                res[key + f"decode/{i}/logits"] = np.asarray(lg)
                res[key + f"decode/{i}/tallies"] = np.asarray(tal)
    np.savez(path, **res)
