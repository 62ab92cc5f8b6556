"""Shared by the port's tests of the modality frontends on a rank grid
(tests/test_torch_frontend_grid.py).

Three cases at smoke size, f32, each on (2, 2) over ("data", "model")
from ``make_rules``, a batch of 2 and 20 positions (the batch over
"data", the residual's 20 positions over "model", 10 a rank):

* ``hubert`` — hubert-xlarge: 20 audio frames projected by the frontend
  (its d_model over "model"), non-causal attention by heads, the
  vocabulary (64) over "model";
* ``pixtral`` — pixtral-12b: 8 patches before 12 tokens, so the split
  over "model" crosses the boundary (rank 0 of "model" holds the 8
  patches and 2 tokens, rank 1 ten tokens); the vocabulary (512) over
  "model", whose lookup's partials are zero at the patch positions;
* ``pixtral_odd_vocab`` — the same with a vocabulary of 511, which
  "model" does not divide: each rank embeds and labels its own positions,
  so the two ranks of "model" hold 2 and 10 labelled rows, and the loss
  is their sum over the global count.

Each case runs the loss and its gradients (each rank's slice) and the
prefill (the logits, the rank's cache). :func:`frontend_rank` runs every
case on one gloo rank of the port and records the residual's shape
entering each block; :func:`jax_frontend` runs them through the
reference on meshes of fake devices; :func:`single` runs the port with
``rules=None``.

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np

AXES = ("data", "model")
B, S = 2, 20

#: case → (arch, grid shape, config overrides)
CASES = {
    "hubert": ("hubert-xlarge", (2, 2), {}),
    "pixtral": ("pixtral-12b", (2, 2), {}),
    "pixtral_odd_vocab": ("pixtral-12b", (2, 2), {"vocab": 511}),
}


def config(name: str, get_smoke):
    """Case ``name``'s config through a package's ``get_smoke``."""
    arch, _, over = CASES[name]
    return dataclasses.replace(get_smoke(arch), **over)


def inputs(cfg) -> dict:
    """The case's batch (numpy): 2 x 20 f32 frames and their labels, or 8
    f32 patches, 12 tokens and their labels."""
    rng = np.random.default_rng(26)
    if cfg.frontend == "audio":
        return {"feats": rng.normal(size=(B, S, cfg.frontend_dim))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    text = S - cfg.n_patches
    return {"tokens": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32),
            "patches": rng.normal(size=(B, cfg.n_patches, cfg.frontend_dim))
            .astype(np.float32)}


def _run_port(torch, cfg, params_for, rules_for):
    """The loss (and every leaf's gradient, zeros where none) and the
    prefill of ``cfg`` with the params and rules each phase's callables
    give. Returns numpy results."""
    from _torch_sp_ranks import _Shapes
    from repro_torch.models import model as tmodel
    from repro_torch.tree import leaves
    batch = {k: torch.from_numpy(v) for k, v in inputs(cfg).items()}
    out = {}
    with _Shapes(tmodel) as shapes:
        params = params_for("train")
        for leaf in leaves(params):
            leaf.requires_grad_(True)
        loss, _ = tmodel.loss_fn(cfg, rules_for("train"))(params, batch)
        loss.backward()
        out["loss"] = float(loss.detach())
        out["grads"] = [np.zeros(tuple(p.shape), np.float32)
                        if p.grad is None else p.grad.numpy()
                        for p in leaves(params)]
        with torch.no_grad():
            lg, cache, _ = tmodel.prefill_fn(cfg, rules_for("prefill"))(
                params_for("prefill"),
                {k: v for k, v in batch.items() if k != "labels"})
        out["prefill"] = lg.numpy()
        out["prefill_cache"] = [tuple(t.numpy() for t in c) for c in cache]
    out["shapes"] = {k: sorted(v) for k, v in shapes.seen.items()}
    return out


def single(name: str, tree):
    """Case ``name`` through the port's ``rules=None`` on one process."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    return _run_port(torch, config(name, get_smoke),
                     lambda phase: params_from_numpy(tree),
                     lambda phase: None)


def frontend_rank(rank: int, trees):
    """One gloo rank of the port: every case (every rank builds the grid
    once) on the rank's slice of the whole params ``trees[name]`` (numpy)
    for each phase."""
    import torch
    torch.set_num_threads(1)
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import make_rules, shard_params
    grid = make_mesh((2, 2), AXES)
    out = {}
    for name in CASES:
        cfg = config(name, get_smoke)

        def params_for(phase, cfg=cfg, name=name):
            return shard_params(cfg, params_from_numpy(trees[name]),
                                make_rules(cfg, grid, phase), phase)

        out[name] = _run_port(torch, cfg, params_for,
                              lambda phase, cfg=cfg: make_rules(cfg, grid,
                                                                phase))
    return out


def jax_frontend(path: str) -> None:
    """Every case through the reference on a (2, 2) mesh of fake devices
    from its ``make_rules`` (the loss by ``jax.value_and_grad``, the
    prefill), written to ``path`` (.npz). Run in a process whose
    XLA_FLAGS fake at least 4 devices."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro.configs import get_smoke
    from repro.launch.sharding import make_rules
    from repro.models import model as jmodel
    mesh = compat.make_mesh((2, 2), AXES, devices=jax.devices()[:4])
    res = {}
    for name in CASES:
        cfg = config(name, get_smoke)
        jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
        batch = {k: jnp.asarray(v) for k, v in inputs(cfg).items()}
        key = f"{name}/"
        with compat.use_mesh(mesh):
            (loss, _), g = jax.jit(jax.value_and_grad(
                jmodel.loss_fn(cfg, make_rules(cfg, mesh, "train")),
                has_aux=True))(jp, batch)
            res[key + "loss"] = np.asarray(loss)
            for i, leaf in enumerate(jax.tree.leaves(g)):
                res[key + f"grad/{i}"] = np.asarray(leaf)
            lg, _, _ = jax.jit(jmodel.prefill_fn(
                cfg, make_rules(cfg, mesh, "prefill")))(
                    jp, {k: v for k, v in batch.items() if k != "labels"})
            res[key + "prefill/logits"] = np.asarray(lg)
    np.savez(path, **res)
