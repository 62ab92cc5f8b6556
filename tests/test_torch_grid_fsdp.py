"""FSDP over more axes than the batch splits: the port on a (2, 2, 1) grid
of 4 gloo ranks over ("pod", "data", "model"), the batch over "data" and
FSDP over ("pod", "data") (``tests/_torch_grid_fsdp_ranks.py``).

The "pod" ranks of a "data" coordinate route the same rows, so the
gradient of a gathered leaf sums over "data" only and each rank keeps its
own slice over "pod" (``ShardingRules.fsdp_summed``). Summing over the
whole FSDP group would count those rows twice: the expert gradients came
out 2x the reference's. Each case is held against the reference's own
mesh run of the same rules (one subprocess on 4 fake devices), and the
model's against the port with FSDP over "data" alone, where the same sums
run over the same ranks: bit for bit.

* the battery's a2a ragged and capacity bodies and the replicated body
  at train, in f32: y within ``BF16_TOL`` of the reference's, tallies
  exactly, every rank's gradient slice within ``GRAD_TOL``;
* granite's and smollm's smoke ``loss_fn`` and gradients in f32, within
  ``F32_TOL`` / ``GRAD_TOL`` of the reference's mesh run;
* one ``make_train_step`` step against the single-process port (the
  grid's global norm counting each slice once), and the state saved from
  the grid restored onto the grid with its cuts and onto one device, bit
  for bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_grid_fsdp_ranks as h  # noqa: E402
import _torch_grid_train_ranks as gt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

#: tests/test_torch_ep_model.py's: f32 logits and losses, and the
#: relative L2 of each f32 gradient leaf
F32_TOL = 1e-4
GRAD_TOL = 1e-4


def _ok(out, key):
    """Case ``key``'s results on a rank; its traceback fails the test."""
    assert "error" not in out[key], out[key].get("error")
    return out[key]


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def trees():
    return {arch: gt.reference_params(arch) for arch in h.ARCHS}


@pytest.fixture(scope="module")
def runs(trees, tmp_path_factory):
    d = tmp_path_factory.mktemp("grid_fsdp")
    path = str(d / "ref.npz")
    proc = ep.start_reference("_torch_grid_fsdp_ranks.jax_fsdp", path, 4)
    try:
        ranks = run_ranks(h.fsdp_rank, 4, args=(trees, str(d / "ckpt")),
                          timeout_s=300)
    except BaseException:
        proc.kill()
        raise
    return ranks, ep.wait_reference(proc, path), d


@pytest.mark.parametrize("name", list(h.BATTERY))
def test_battery_matches_reference_mesh_with_pod_slices(runs, name):
    """Each rank's y, tally and aux are the reference's on the same mesh;
    its expert gradient slices, the router's and x's are the reference's
    (the a2a bodies' were 2x before the "pod" ranks' partials were
    counted once), and bit for bit the ranks' under FSDP over "data"
    alone."""
    ranks, ref, _ = runs
    fields = h.WIDE | h.BATTERY[name]
    for r, out in enumerate(ranks):
        got = _ok(out, f"wide/{name}")
        np.testing.assert_array_equal(got["tally"], ref[f"{name}/tally"])
        np.testing.assert_allclose(got["y"], ref[f"{name}/y"],
                                   rtol=ep.BF16_TOL, atol=ep.BF16_TOL)
        np.testing.assert_allclose(got["aux"], float(ref[f"{name}/aux"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(got["loss"], float(ref[f"{name}/loss"]),
                                   rtol=F32_TOL)
        want = h.battery_rank_slice(
            {k: ref[f"{name}/{k}"] for k in ("router", "w1", "w3", "w2")},
            r, fields)
        for k in ("router", "w1", "w3", "w2"):
            assert got[k].shape == want[k].shape, (r, k)
            ratio = np.linalg.norm(got[k]) / np.linalg.norm(want[k])
            assert _rel(got[k], want[k]) <= GRAD_TOL, (r, k, ratio)
        assert _rel(got["x"], ref[f"{name}/x"]) <= GRAD_TOL, (r, "x")
        narrow = _ok(out, f"narrow/{name}")
        np.testing.assert_array_equal(got["y"], narrow["y"])
        np.testing.assert_array_equal(got["x"], narrow["x"])
        np.testing.assert_array_equal(got["router"], narrow["router"])


def test_battery_gradients_sum_each_row_once(runs):
    """The ranks' expert slices, put together, are the single-process
    port's gradient (``rules=None``) within ``GRAD_TOL``: the norm ratio
    reads 1, not 2."""
    ranks, _, _ = runs
    inp = ep.battery_inputs()
    p = {k: torch.from_numpy(v).requires_grad_(True)
         for k, v in inp["p"].items()}
    y, _, aux = tmoe.moe_layer(p, torch.from_numpy(inp["x"]), top_k=ep.K,
                               n_experts=ep.E)
    ((y ** 2).mean() + 0.01 * aux).backward()
    full = {k: v.grad.numpy() for k, v in p.items()}
    for name in h.BATTERY:
        fields = h.WIDE | h.BATTERY[name]
        for r, out in enumerate(ranks):
            want = h.battery_rank_slice(full, r, fields)
            for k in ("w1", "w3", "w2"):
                got = _ok(out, f"wide/{name}")[k]
                ratio = np.linalg.norm(got) / np.linalg.norm(want[k])
                assert abs(ratio - 1.0) <= GRAD_TOL, (name, r, k, ratio)
                assert _rel(got, want[k]) <= GRAD_TOL, (name, r, k)


@pytest.mark.parametrize("arch", h.ARCHS)
def test_loss_and_gradients_match_reference_mesh_and_narrow_fsdp(
        runs, arch):
    """``loss_fn`` on the grid (the refusal of an FSDP group that the rows
    cut is gone): the loss and tallies on every rank, and the gradients
    gathered whole, against the reference's mesh run of the same rules
    and bit for bit against FSDP over "data" alone."""
    ranks, ref, _ = runs
    first = _ok(ranks[0], f"wide/{arch}")
    want = [ref[f"{arch}/grad/{i}"] for i in range(len(first["grads"]))]
    for out in ranks:
        got, narrow = _ok(out, f"wide/{arch}"), _ok(out, f"narrow/{arch}")
        assert got["loss"] == narrow["loss"] == first["loss"]
        np.testing.assert_allclose(got["loss"], float(ref[f"{arch}/loss"]),
                                   rtol=F32_TOL)
        np.testing.assert_array_equal(got["tallies"], ref[f"{arch}/tallies"])
        for i, (g, n, w) in enumerate(zip(got["grads"], narrow["grads"],
                                          want)):
            assert g.shape == w.shape, (arch, i)
            np.testing.assert_array_equal(g, n, err_msg=f"{arch} leaf {i}")
            assert _rel(g, w) <= GRAD_TOL, (arch, i, _rel(g, w))
        # the grid's global norm counts each leaf's slice once: the whole
        # gradient's (AdamW's clip, whose first step moves by sign(g)
        # whatever its factor, would not show a slice counted twice)
        for way in (got, narrow):
            assert way["norm"] == pytest.approx(way["norm_whole"], rel=1e-6)


@pytest.fixture(scope="module")
def single_step(trees):
    return h.train_step(get_smoke(h.GRANITE), trees[h.GRANITE], None)


def test_train_step_matches_single_process(runs, single_step):
    """One ``make_train_step`` step on the grid (AdamW on each rank's
    slices, clipped by the grid's norm, each slice counted once): the
    loss and the state after it, gathered whole, are the single-process
    port's within ``F32_TOL`` (the relative L2 of each leaf)."""
    ranks, _, _ = runs
    for out in ranks:
        assert _ok(out, "step")["loss"] == ranks[0]["step"]["loss"]
        assert out["step"]["loss"] == pytest.approx(single_step["loss"],
                                                    rel=F32_TOL)
    got = ranks[0]["step"]["state"]
    assert int(got[0]) == h.START_STEP + 1
    assert len(got) == len(single_step["state"])
    for i, (a, b) in enumerate(zip(got, single_step["state"])):
        assert a.shape == b.shape, i
        assert _rel(a, b) <= F32_TOL, (i, _rel(a, b))


def test_checkpoint_saved_on_grid_restores_onto_one_device(runs, trees):
    """The state saved from the grid restores onto one device bit for bit
    as the ranks gathered it, and onto the grid with the cuts as each
    rank's slices."""
    ranks, _, d = runs
    for out in ranks:
        got = _ok(out, "step")["restored_equal"]
        assert got and all(got), got
    whole = params_from_numpy(trees[h.GRANITE])
    state, _ = tckpt.load_checkpoint(str(d / "ckpt"), h.CKPT_STEP, {
        "params": whole, "opt": topt.adamw_init(whole)})
    saved = _ok(ranks[0], "step")["state"]
    assert len(leaves(state)) == len(saved)
    for a, b in zip(leaves(state), saved):
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


def test_fsdp_summed_splits_the_group_by_rows():
    """``ShardingRules.fsdp_summed`` without a process group: all FSDP
    axes among the rows' axes → True, none → False, some → the subgroup
    over them (None here: a grid object holds no groups) and the shards'
    indices in the FSDP group its members hold."""
    from repro_torch.launch.mesh import Grid
    for r in range(4):
        grid = Grid(h.SHAPE, h.AXES, r, {})
        rules = ShardingRules(grid=grid, **h.WIDE)
        assert rules.fsdp_summed(("pod", "data")) is True
        assert rules.fsdp_summed(("model",)) is False
        assert rules.fsdp_summed(()) is False
        pod, data = grid.coords["pod"], grid.coords["data"]
        summed = ShardingRules(grid=Grid(h.SHAPE, h.AXES, r, {
            ("data",): "g"}), **h.WIDE).fsdp_summed(("data",))
        assert summed == ("g", [pod * 2, pod * 2 + 1])
        summed = ShardingRules(grid=Grid(h.SHAPE, h.AXES, r, {
            ("pod",): "g"}), **h.WIDE).fsdp_summed(("pod", "model"))
        assert summed == ("g", [data, 2 + data])
    narrow = ShardingRules(grid=Grid(h.SHAPE, h.AXES, 0, {}), **h.NARROW)
    assert narrow.fsdp_summed(("data",)) is True
