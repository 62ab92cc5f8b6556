"""The dense MoE oracle on a rank grid: ``moe_dispatch="dense"`` on a (2, 2)
grid of 4 gloo ranks over ("data", "model")
(``tests/_torch_grid_dense_ranks.py``).

Every rank gathers the whole batch and the whole expert weights, runs what
the rules run without a grid and keeps its rows, as GSPMD runs the
reference's oracle. So the replica draw hashes the global assignment
index, and the tally and aux are the global ones, counted once.

* ``moe_layer`` in f32 at train, prefill and decode on the ragged and
  capacity paths (decode on 24 slots with two copies of 8 experts and
  their shares, with and without expert-TP): each rank's y, the tally
  and aux against the reference's dense run on a mesh of 4 fake devices
  (``F32_TOL``, tallies exactly) and bit for bit against the port's run
  without a grid; each rank's gradient slices against ``jax.grad``
  (``GRAD_TOL``) and bit for bit against the port's.
* granite's smoke ``loss_fn``, ``prefill_fn`` and ``decode_fn`` with the
  dense dispatch, with the batch's rows over "data" and the sequence's
  over "model", and with the batch's alone (capacity), against the
  reference's mesh runs and the port without a grid, as
  ``tests/test_torch_sp.py`` holds its cases.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_grid_dense_ranks as h  # noqa: E402
import _torch_sp_ranks as sp  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (rank_cache,  # noqa: E402
                                         shard_experts, shard_params)
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
GRAD_TOL = 1e-4      # relative L2 of each f32 gradient leaf


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)


def _grid(rank):
    return Grid(h.SHAPE, h.AXES, rank, {})


@pytest.fixture(scope="module")
def trees():
    jp = jmodel.init_params(get_smoke(sp.GRANITE), jax.random.PRNGKey(0),
                            dtype=jnp.float32)
    tree = jax.tree.map(np.asarray, jp)
    return {name: tree for name in h.MODEL}


@pytest.fixture(scope="module")
def single(trees):
    return {"layer": {case: h.port_layer(case) for case in h.LAYER},
            "model": {name: sp.single(name, trees[name], h.MODEL)
                      for name in h.MODEL}}


@pytest.fixture(scope="module")
def runs(trees, single, tmp_path_factory):
    d = tmp_path_factory.mktemp("grid_dense")
    caches = {name: single["model"][name]["whole_cache"]
              for name in h.MODEL}
    np.savez(d / "caches.npz", **{
        f"{name}/{k}": v for name, cache in caches.items()
        for k, v in sp.flat_cache(cache).items()})
    procs = [(ep.start_reference("_torch_grid_dense_ranks.jax_dense",
                                 str(d / "layer.npz"), 4),
              str(d / "layer.npz")),
             (ep.start_reference("_torch_sp_ranks.jax_sp",
                                 str(d / "model.npz"), 4,
                                 str(d / "caches.npz"), None, h.MODEL),
              str(d / "model.npz"))]
    try:
        ranks = run_ranks(h.dense_rank, 4, args=(trees, caches),
                          timeout_s=300)
    except BaseException:
        for proc, _ in procs:
            proc.kill()
        raise
    ref = {}
    for proc, path in procs:
        ref |= ep.wait_reference(proc, path)
    return ranks, ref


def _layer_rules(case, rank):
    extra, phase = h.LAYER[case][:2]
    return ShardingRules(grid=_grid(rank), **h.RULES, **extra), phase


@pytest.mark.parametrize("case", list(h.LAYER))
def test_layer_matches_reference_dense_and_port_without_grid(
        runs, single, case):
    """Each rank's rows of y, the global tally and aux: the reference's
    dense run on the mesh, and bit for bit the port's without a grid (the
    same dispatch on the same whole batch: with the copies' shares at
    decode, a rank that drew its rows' copies by their local index would
    pick others)."""
    ranks, ref = runs
    one = single["layer"][case]
    for r, out in enumerate(ranks):
        got = out[case]
        b, s = h.rows_of(case, _grid(r).coords)
        np.testing.assert_array_equal(got["y"], one["y"][b, s])
        np.testing.assert_array_equal(got["tally"], one["tally"])
        assert got["aux"] == one["aux"]
        # the y part is the sum of the ranks' partial sums over their rows
        np.testing.assert_allclose(got["loss"], one["loss"], rtol=1e-6)
        _close(got["y"], ref[f"{case}/y"][b, s])
        np.testing.assert_array_equal(got["tally"], ref[f"{case}/tally"])
        np.testing.assert_allclose(got["aux"], float(ref[f"{case}/aux"]),
                                   rtol=1e-5)
        np.testing.assert_allclose(got["loss"], float(ref[f"{case}/loss"]),
                                   rtol=F32_TOL)
    # the tally counts every token once: top_k assignments a row
    n_rows = int(np.prod(ep.battery_inputs()["x"].shape[:2]))
    assert float(ranks[0][case]["tally"][:ep.E].sum()) == n_rows * ep.K


@pytest.mark.parametrize("case", list(h.LAYER))
def test_layer_gradients_match_jax_grad_and_port_without_grid(
        runs, single, case):
    """Each rank's gradient slices of the expert weights (its slots, and
    its FSDP or expert-TP slice), the router's and its rows of x's: the
    reference's ``jax.grad`` within ``GRAD_TOL``, the port's without a
    grid bit for bit."""
    ranks, ref = runs
    one = single["layer"][case]
    pk = h.LAYER[case][2]
    for r, out in enumerate(ranks):
        got = out[case]
        rules, phase = _layer_rules(case, r)
        b, s = h.rows_of(case, _grid(r).coords)
        cut = {k: torch.from_numpy(v) for k, v in
               {k: one[k] for k in ("router", "w1", "w3", "w2")}.items()}
        want = {k: v.numpy() for k, v in
                shard_experts(cut, rules, phase).items()}
        jcut = {k: torch.from_numpy(ref[f"{case}/{k}"])
                for k in ("router", "w1", "w3", "w2")}
        want_j = {k: v.numpy() for k, v in
                  shard_experts(jcut, rules, phase).items()}
        for k in ("router", "w1", "w3", "w2"):
            assert got[k].shape == want[k].shape, (r, k)
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"rank {r} {k}")
            assert _rel(got[k], want_j[k]) <= GRAD_TOL, (r, k)
        np.testing.assert_array_equal(got["x"], one["x"][b, s])
        assert _rel(got["x"], ref[f"{case}/x"][b, s]) <= GRAD_TOL, r
    assert ep.battery_inputs()[pk]["w1"].shape[0] == (24 if pk == "p8"
                                                       else ep.E)


def _jax_grads(ref, key, tree):
    n = len(jax.tree.leaves(tree))
    return params_from_numpy(jax.tree.unflatten(
        jax.tree.structure(tree), [ref[f"{key}grad/{i}"] for i in range(n)]))


@pytest.mark.parametrize("name", list(h.MODEL))
def test_model_loss_and_gradients_with_dense_dispatch(runs, single, trees,
                                                      name):
    """granite's loss on the grid with the dense dispatch: the loss and
    tallies on every rank, and each rank's gradient slices, against the
    reference's mesh run and the port without a grid."""
    ranks, ref = runs
    cfg = t_get_smoke(sp.GRANITE)
    one = single["model"][name]
    jgrads = _jax_grads(ref, f"{name}/", trees[name])
    sgrads = params_from_numpy(jax.tree.unflatten(
        jax.tree.structure(trees[name]), one["grads"]))
    for r, outs in enumerate(ranks):
        out = outs[name]
        assert out["loss"] == ranks[0][name]["loss"]
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(out["loss"], float(ref[f"{name}/loss"]),
                                   rtol=F32_TOL)
        np.testing.assert_array_equal(out["train_tallies"],
                                      one["train_tallies"])
        np.testing.assert_array_equal(out["train_tallies"],
                                      ref[f"{name}/train_tallies"])
        rules = sp.port_rules(name, _grid(r), "train", h.MODEL)
        want = leaves(shard_params(cfg, sgrads, rules, "train"))
        want_j = leaves(shard_params(cfg, jgrads, rules, "train"))
        assert len(out["grads"]) == len(want)
        for i, (g, w, wj) in enumerate(zip(out["grads"], want, want_j)):
            assert g.shape == tuple(w.shape), (r, i)
            assert _rel(g, w.numpy()) <= GRAD_TOL, (r, i)
            assert _rel(g, wj.numpy()) <= GRAD_TOL, (r, i)


@pytest.mark.parametrize("name", list(h.MODEL))
def test_model_prefill_and_decode_with_dense_dispatch(runs, single, name):
    """The prefill's logits, tallies and the rank's cache, and three decode
    steps on the decode fleet's weights, against the reference's mesh runs
    and the port without a grid; each rank's residual holds its rows."""
    ranks, ref = runs
    cfg = t_get_smoke(sp.GRANITE)
    one = single["model"][name]
    _, _, _, B, S = h.MODEL[name]
    for r, outs in enumerate(ranks):
        out = outs[name]
        lg, tal = out["prefill"]
        np.testing.assert_array_equal(tal, one["prefill"][1])
        np.testing.assert_array_equal(tal, ref[f"{name}/prefill/tallies"])
        _close(lg, one["prefill"][0])
        _close(lg, ref[f"{name}/prefill/logits"])
        rules = sp.port_rules(name, _grid(r), "prefill", h.MODEL)
        want = rank_cache(cfg, [tuple(torch.from_numpy(t) for t in c)
                                for c in one["prefill_cache"]], rules)
        for c, w in zip(out["prefill_cache"], want):
            for a, b in zip(c, w):
                assert a.shape == tuple(b.shape), (name, r)
                _close(a, b.numpy())
        for i, (lg, tal) in enumerate(out["decode"]):
            np.testing.assert_array_equal(tal, one["decode"][i][1])
            np.testing.assert_array_equal(tal,
                                          ref[f"{name}/decode/{i}/tallies"])
            _close(lg, one["decode"][i][0])
            _close(lg, ref[f"{name}/decode/{i}/logits"])
        rows = (B // 2, S // 2 if S % 2 == 0 else S)
        assert out["shapes"]["train"] == [rows]
        assert out["shapes"]["decode"] == [(B // 2, 1)]


def test_dense_dispatch_refuses_row_valid_on_a_grid():
    """The chunk mask stays refused on a group, as in the reference."""
    x = torch.zeros((2, 4, ep.D))
    p = {k: torch.from_numpy(v) for k, v in
         ep.battery_inputs()["p"].items()}
    rules = ShardingRules(grid=_grid(0), **h.RULES)
    with pytest.raises(NotImplementedError, match="row_valid"):
        tmoe.moe_layer(p, x, top_k=ep.K, n_experts=ep.E, rules=rules,
                       row_valid=torch.ones(8, dtype=torch.bool))
