"""The modality frontends of the port on gloo ranks of a (2, 2) grid from
``make_rules``, at smoke size (f32), against the reference's own mesh
run and the single-rank port.

The three cases of ``tests/_torch_frontend_ranks.py`` — hubert-xlarge's
20 frames, pixtral-12b's 8 patches before 12 tokens (the sequence's split
over "model" crosses the patch/text boundary) and the same with a
vocabulary that "model" does not divide (the ranks of "model" then hold
2 and 10 labelled rows) — each run the loss and its gradients (each
rank's slice, ``params["frontend"]``'s columns included) and the
prefill; each is held against the reference's run of the same functions
on a (2, 2) mesh of fake devices (one subprocess) and against the
single-rank port: loss, every gradient leaf (relative L2), logits and
the rank's cache within ``F32_TOL``. Every rank records the residual's
shape entering each block: its 1 of the 2 rows and 10 of the 20
positions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_frontend_ranks as h  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (make_rules,  # noqa: E402
                                         rank_cache, shard_params)
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
NAMES = list(h.CASES)


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rules(name, rank, phase="train"):
    """Case ``name``'s rules for ``rank``, placed by a grid object without
    a process group."""
    return make_rules(h.config(name, t_get_smoke),
                      Grid((2, 2), h.AXES, rank, {}), phase)


@pytest.fixture(scope="module")
def trees():
    return {name: jax.tree.map(np.asarray, jmodel.init_params(
        h.config(name, get_smoke), jax.random.PRNGKey(0),
        dtype=jnp.float32)) for name in NAMES}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("frontend") / "ref.npz")
    proc = ep.start_reference("_torch_frontend_ranks.jax_frontend", path, 4)
    try:
        ranks = run_ranks(h.frontend_rank, 4, args=(trees,), timeout_s=300)
        single = {name: h.single(name, trees[name]) for name in NAMES}
    except BaseException:
        proc.kill()
        raise
    return ranks, single, ep.wait_reference(proc, path)


def _tree(tree, flat):
    return params_from_numpy(jax.tree.unflatten(jax.tree.structure(tree),
                                                flat))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_slice_match_single_rank_and_jax_mesh(
        runs, trees, name):
    ranks, single, ref = runs
    cfg = h.config(name, t_get_smoke)
    one = single[name]
    n = len(jax.tree.leaves(trees[name]))
    jgrads = _tree(trees[name], [ref[f"{name}/grad/{i}"] for i in range(n)])
    sgrads = _tree(trees[name], one["grads"])
    for r, outs in enumerate(ranks):
        out = outs[name]
        assert out["loss"] == ranks[0][name]["loss"]
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(out["loss"], float(ref[f"{name}/loss"]),
                                   rtol=F32_TOL)
        rules = _rules(name, r)
        want = leaves(shard_params(cfg, sgrads, rules, "train"))
        want_j = leaves(shard_params(cfg, jgrads, rules, "train"))
        assert len(out["grads"]) == len(want)
        for i, (g, w, wj) in enumerate(zip(out["grads"], want, want_j)):
            assert g.shape == tuple(w.shape), (r, i)
            assert _rel(g, w.numpy()) <= F32_TOL, (r, i, _rel(g, w.numpy()))
            assert _rel(g, wj.numpy()) <= F32_TOL, (r, i,
                                                    _rel(g, wj.numpy()))


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_rank_cache_match_single_rank_and_jax_mesh(
        runs, name):
    """Whole logits on every rank; the cache is the rank's lane and KV
    heads over every one of the 20 positions, patches included."""
    ranks, single, ref = runs
    cfg = h.config(name, t_get_smoke)
    one = single[name]
    whole = [tuple(torch.from_numpy(t) for t in c)
             for c in one["prefill_cache"]]
    for r, outs in enumerate(ranks):
        lg = outs[name]["prefill"]
        np.testing.assert_allclose(lg, one["prefill"], rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(lg, ref[f"{name}/prefill/logits"],
                                   rtol=F32_TOL, atol=F32_TOL)
        want = rank_cache(cfg, whole, _rules(name, r, "prefill"))
        for got, w in zip(outs[name]["prefill_cache"], want):
            for a, b in zip(got, w):
                assert a.shape == tuple(b.shape) and a.shape[2] == h.S
                np.testing.assert_allclose(a, b.numpy(), rtol=F32_TOL,
                                           atol=F32_TOL)


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_its_rows_across_the_patch_boundary(runs, name):
    """The residual entering every block holds the rank's 1 of 2 batch
    rows and 10 of the 20 positions, at train and prefill: for pixtral
    rank 0 of "model" the 8 patches and 2 tokens, rank 1 ten tokens."""
    ranks, _, _ = runs
    rules = _rules(name, 0)
    assert rules.batch_split(h.B) and rules.seq_split(h.S, "train")
    for outs in ranks:
        assert outs[name]["shapes"] == {"train": [(1, 10)],
                                        "prefill": [(1, 10)]}
