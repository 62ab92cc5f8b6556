"""The port's training step on the rank grid, on gloo ranks at smoke size
(f32), against the reference's ``adamw_update`` on the whole tree, its
mesh train step and the single-rank port.

The three cases of ``tests/_torch_grid_train_ranks.py`` — granite on
(2, 2) by heads with dense and expert FSDP over "data", granite on (1, 4)
in context mode, jamba on (2, 2) from ``make_rules`` — each run two AdamW
steps on seeded gradients with the grid's global norm and three training
steps through ``make_train_step``. The states, gathered whole, the norms
and the losses are held against the reference (one subprocess a case, on
8 fake devices) and the single-rank port: the AdamW steps within
``ADAMW_TOL`` (elementwise, and the norms relatively), the training steps
within ``F32_TOL`` (the relative L2 of each leaf). The clip is active in
every case (the norm exceeds ``grad_clip``), so a norm taken over a
rank's own slices would show. A ``{"params", "opt"}`` checkpoint saved
from the (2, 2) grid restores onto (1, 4) and onto one device bit for bit
and reads in the reference; one the reference wrote restores onto (2, 2)
as each rank's slices.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_grid_train_ranks as h  # noqa: E402
from repro.training import checkpoint as jckpt  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (Cuts, make_rules,  # noqa: E402
                                         opt_cuts, param_cuts,
                                         shard_params)
from repro_torch.models import init_params  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
ADAMW_TOL = 1e-6
NAMES = list(h.CASES)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's runs, one subprocess a case on 8 fake devices,
    started first: their compiles are the long pole."""
    d = tmp_path_factory.mktemp("grid_train_ref")
    procs = [(ep.start_reference("_torch_grid_train_ranks.jax_grid_train",
                                 str(d / f"{name}.npz"), 8, [name]),
              str(d / f"{name}.npz")) for name in NAMES]
    yield procs
    for proc, _ in procs:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope="module")
def trees(reference):
    by_arch = {}
    for arch, *_ in h.CASES.values():
        if arch not in by_arch:
            by_arch[arch] = h.reference_params(arch)
    return {name: by_arch[arch] for name, (arch, *_) in h.CASES.items()}


@pytest.fixture(scope="module")
def runs(reference, trees, tmp_path_factory):
    d = tmp_path_factory.mktemp("grid_train")
    given = {}
    arch = h.CASES[h.SAVE][0]
    given[arch] = h.reference_adamw(trees[h.SAVE])
    # a {"params", "opt"} state of the reference one AdamW step in
    ref_state = given[arch][0][0]
    jckpt.save_checkpoint(str(d / "ref_ckpt"), 1, ref_state, n_shards=2)
    ranks = run_ranks(h.grid_rank, 4, args=(
        trees, str(d / "grid_ckpt"), str(d / "ref_ckpt"),
        [np.asarray(x) for x in jax.tree.leaves(ref_state)]),
        timeout_s=300)
    ref = {}
    for name, (arch, *_) in h.CASES.items():
        if arch not in given:
            given[arch] = h.reference_adamw(trees[name])
        states, norms = given[arch]
        ref[f"{name}/given/norm"] = norms
        ref[f"{name}/given"] = [np.asarray(x)
                                for x in jax.tree.leaves(states[-1])]
    for proc, path in reference:
        ref |= ep.wait_reference(proc, path)
    return ranks, ref, d


@pytest.fixture(scope="module")
def single(trees):
    return {name: h.port_steps(name, trees[name])[0] for name in NAMES}


def _ref_leaves(ref, key):
    n = sum(1 for k in ref if k.startswith(key + "/") and
            k[len(key) + 1:].isdigit())
    return [ref[f"{key}/{i}"] for i in range(n)]


def _hold(got, wants, tol=None):
    """Each leaf of ``got`` against the matching leaf of each of ``wants``:
    within ``tol`` of relative L2, or, without one, within ``ADAMW_TOL``
    elementwise, as tests/test_torch_train.py holds AdamW."""
    for want in wants:
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape, i
            if tol is None:
                np.testing.assert_allclose(a, b, rtol=ADAMW_TOL,
                                           atol=ADAMW_TOL, err_msg=str(i))
            else:
                assert _rel(a, b) <= tol, (i, _rel(a, b))


@pytest.mark.parametrize("name", NAMES)
def test_grid_norm_and_two_adamw_steps_match_reference_and_single_rank(
        runs, single, name):
    """Every rank's ``global_norm`` with the cuts is the whole tree's (the
    reference's on the whole gradients) and the same on every rank; two
    clipped AdamW steps on the ranks' slices, gathered, are the
    reference's and the single-rank port's."""
    ranks, ref, _ = runs
    grad_clip = topt.AdamWConfig().grad_clip
    for k in range(2):
        want = ref[f"{name}/given/norm"][k]
        assert want > grad_clip                      # the clip is active
        assert single[name]["norms"][k] == pytest.approx(want, rel=ADAMW_TOL)
        for r in ranks:
            assert r[name]["norms"][k] == ranks[0][name]["norms"][k]
            assert r[name]["norms"][k] == pytest.approx(want, rel=ADAMW_TOL)
    _hold(ranks[0][name]["given"], [ref[f"{name}/given"],
                                    single[name]["given"]])


@pytest.mark.parametrize("name", NAMES)
def test_three_train_steps_match_reference_mesh_step_and_single_rank(
        runs, single, name):
    """Three steps of ``make_train_step`` on the grid: each loss, and the
    params and state after them, gathered, are the reference's mesh train
    step's (jitted with ``param_specs`` and the mirrored opt specs) and
    the single-rank port's. The clip is active at every step."""
    ranks, ref, _ = runs
    grad_clip = topt.AdamWConfig().grad_clip
    for s in range(h.STEPS):
        assert float(ref[f"{name}/gnorm/{s}"]) > grad_clip
        want = float(ref[f"{name}/loss/{s}"])
        assert single[name]["losses"][s] == pytest.approx(want, rel=F32_TOL)
        for r in ranks:
            assert r[name]["losses"][s] == ranks[0][name]["losses"][s]
            assert r[name]["losses"][s] == pytest.approx(want, rel=F32_TOL)
    got = ranks[0][name]["trained"]
    assert int(got[0]) == h.START_STEP + h.STEPS       # the opt's step
    _hold(got, [_ref_leaves(ref, f"{name}/trained"),
                single[name]["trained"]], F32_TOL)


def test_checkpoint_saved_on_grid_restores_bit_for_bit(runs, trees):
    """The (2, 2) grid's trained state, saved from the grid, is a whole
    checkpoint in the reference's layout; restored onto the (1, 4) grid
    and gathered, and restored onto one device, it is the saved state bit
    for bit."""
    ranks, _, d = runs
    saved = ranks[0][h.SAVE]["trained"]
    path = str(d / "grid_ckpt")
    with open(os.path.join(path, f"ckpt_{h.CKPT_STEP}", "manifest.json")) \
            as f:
        manifest = json.load(f)
    assert [info["shape"] for info in manifest["leaves"]] == \
        [list(a.shape) for a in saved]
    for a, b in zip(ranks[0]["restored"], saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    whole = params_from_numpy(trees[h.SAVE])
    state, _ = tckpt.load_checkpoint(path, h.CKPT_STEP, {
        "params": whole, "opt": topt.adamw_init(whole)})
    for a, b in zip(leaves(state), saved):
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


def test_reference_reads_the_checkpoint_saved_on_grid(runs, trees):
    ranks, _, d = runs
    jp = jax.tree.map(jnp.asarray, trees[h.SAVE])
    like = {"params": jp, "opt": jopt.adamw_init(jp)}
    state, _ = jckpt.load_checkpoint(str(d / "grid_ckpt"), h.CKPT_STEP,
                                     like)
    got = jax.tree.leaves(state)
    saved = ranks[0][h.SAVE]["trained"]
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        assert np.array_equal(np.asarray(a), b)


def test_reference_checkpoint_restores_onto_grid_as_each_ranks_slices(
        runs, trees):
    """A ``{"params", "opt"}`` checkpoint the reference wrote (its
    ``OptState`` one step in) restores onto the (2, 2) grid with
    ``opt_cuts``: every leaf is the rank's slice of the reference's, the
    moments and the master cut as the params."""
    ranks, _, _ = runs
    cfg = t_get_smoke(h.CASES[h.SAVE][0])
    whole = params_from_numpy(trees[h.SAVE])
    for r, out in enumerate(ranks):
        rules = h.port_rules(h.SAVE, Grid(h.CASES[h.SAVE][1], h.AXES, r, {}))
        want = shard_params(cfg, whole, rules)
        shapes = [tuple(t.shape) for t in leaves(
            {"params": want, "opt": topt.adamw_init(want)})]
        got = out["reference_restored"]
        assert got["shapes"] == shapes
        assert all(got["equal"]) and len(got["equal"]) == len(shapes)
    pc = param_cuts(cfg, rules)
    # the moments and the master are cut as the params, the step whole
    oc = opt_cuts(pc)
    assert oc.step == Cuts() and oc.mu is oc.nu is oc.master is pc
    assert any(c.pairs for c in leaves(pc))


def _axes_of(tree_cuts):
    return {c.axes for c in leaves(tree_cuts)}


def test_param_cuts_say_which_leaves_stay_whole():
    """``param_cuts`` reads the same tests as the slicing: at full width
    granite's vocabulary (49155) does not split over "model", so the
    embedding and head are cut over "data" alone under FSDP and counted
    once over "model"; the norms and the router stay whole; attention and
    the experts are cut over both axes. ``shard_params`` on the meta
    device gives the shapes the cuts say. A leaf cut twice over one axis
    is refused."""
    cfg = t_get("granite-moe-3b-a800m")
    grid = Grid((2, 2), h.AXES, 3, {})
    rules = make_rules(cfg, grid, "train")
    rules = dataclasses.replace(rules, fsdp=("pod", "data"))
    pc = param_cuts(cfg, rules)
    assert pc["embed"] == Cuts(((1, ("data",)),))
    assert pc["head"] == Cuts(((0, ("data",)),))
    assert pc["final_norm"] == Cuts()
    blk = pc["blocks"][0]
    assert blk["ln1"] == blk["ln2"] == blk["ffn"]["router"] == Cuts()
    assert blk["ffn"]["w1"] == Cuts(((-3, ("model",)), (-2, ("data",))))
    assert blk["mixer"]["wo"] == Cuts(((2, ("data",)), (1, ("model",))))
    assert _axes_of(pc) == {(), ("data",), ("data", "model"),
                            ("model", "data")}
    meta = init_params(cfg, None, device="meta")
    part = shard_params(cfg, meta, rules)
    for t, p, c in zip(leaves(meta), leaves(part), leaves(pc)):
        shape = list(t.shape)
        for dim, axes in c.pairs:
            shape[dim] //= grid.axis_size(axes)
        assert list(p.shape) == shape
    _, spec = flatten(meta)
    assert flatten(pc)[1] == spec
    with pytest.raises(ValueError, match="twice over one axis"):
        param_cuts(cfg, ShardingRules(grid=grid, fsdp="model", tp="model"))
