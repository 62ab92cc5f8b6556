"""Expert-parallel dispatch of the port on 8 gloo ranks: the reference's
battery (tests/test_ep_dispatch.py), checks 1-5.

The port runs each check on a (2, 4) grid over ("data", "model") of 8
spawned processes joined by gloo on the CPU (``launch.mesh.run_ranks``),
each rank holding its slice of the expert weights
(``launch.sharding.shard_experts``). Every output is held against the
port's ``rules=None`` on the same inputs at the reference's tolerances
(it computes what the reference's dense oracle does, summed in the
same order as the bodies: bit for bit where the reference asks 1e-6) and
against the reference's own mesh run on the same numpy inputs (its
``moe_layer`` on an 8-device mesh, in a subprocess started with
``--xla_force_host_platform_device_count=8``): tallies exactly, outputs
within the repo's bf16 tolerance. Every rank must return the same
replicated outputs. The gradient check holds each rank's gradients —
the router and x whole, the expert weights its FSDP slice — against
``jax.grad`` on the mesh, value for value: a collective that scaled a
gradient by the group's size would fail it.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as h  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

torch.set_num_threads(1)

NAMES = ["a2a", "a2a+fsdp", "replicated", "expert-tp"]
#: the reference's tolerances against its oracle (tests/test_ep_dispatch.py)
REF_TOL = {"expert-tp": 2e-2}
# bf16 gradients summed in other orders: relative L2 of each leaf
GRAD_TOL = 2e-2


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep") / "ref.npz")
    names = NAMES + list(h.GRADS)
    proc = h.start_reference("jax_battery", path, 8, names)
    try:
        ranks = run_ranks(h.battery_rank, 8, args=(names,), timeout_s=300)
    except BaseException:
        proc.kill()
        raise
    return ranks, h.wait_reference(proc, path)


@pytest.mark.parametrize("name", NAMES)
def test_ep_check_matches_rules_none_and_jax_mesh(runs, name):
    h.hold(*runs, name, REF_TOL.get(name, 1e-6))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("grad", list(h.GRADS))
def test_gradients_match_jax_grad_on_the_mesh(runs, grad):
    """Check 5 (a2a + FSDP; the reference asserts only non-zero norms) and
    the same loss through the replicated body and its expert-TP variant,
    and through the capacity a2a body dropless and with drops (each rank
    drops what the reference's mesh rank drops), held value for value
    against ``jax.grad``."""
    ranks, ref = runs
    loss = ranks[0][1][grad]["loss"]
    assert all(g[grad]["loss"] == loss for _, g in ranks)
    np.testing.assert_allclose(loss, float(ref[f"{grad}/loss"]), rtol=1e-3)
    full = {k: ref[f"{grad}/{k}"] for k in ("router", "w1", "w3", "w2")}
    for r, (_, g) in enumerate(ranks):
        g = g[grad]
        want = h.rank_slice(full, h.GRADS[grad], r, torch)
        for k in ("router", "w1", "w3", "w2"):
            assert g[k].shape == want[k].shape, (r, k)
            assert float(np.linalg.norm(g[k])) > 0, f"zero grad {k}"
            assert _rel(g[k], want[k]) <= GRAD_TOL, (r, k, _rel(g[k], want[k]))
        assert _rel(g["x"], ref[f"{grad}/x"]) <= GRAD_TOL, (r, "x")
    # the router and x gradients are replicated: equal on every rank
    for _, g in ranks[1:]:
        np.testing.assert_array_equal(g[grad]["router"],
                                      ranks[0][1][grad]["router"])
        np.testing.assert_array_equal(g[grad]["x"], ranks[0][1][grad]["x"])


@pytest.mark.parametrize("grad", [g for g in h.GRADS
                                  if g not in h.GRADS_WITH_DROPS])
def test_gradients_match_the_single_rank_port(runs, grad):
    """The same loss through ``rules=None`` on one process: every rank's
    gradient slice against the single-rank gradient's slice (the dropless
    checks only: drops depend on each rank's token count)."""
    from repro_torch.models import moe as tmoe
    inp = h.battery_inputs()
    p = h.port_params(torch, inp["p"])
    for v in p.values():
        v.requires_grad_(True)
    x = h._t(torch, inp["x"], True).requires_grad_(True)
    y, _, aux = tmoe.moe_layer(p, x, top_k=h.K, n_experts=h.E)
    loss = (y.float() ** 2).mean() + 0.01 * aux
    loss.backward()
    full = {k: v.grad.float().numpy() for k, v in p.items()}
    ranks, _ = runs
    for r, (_, g) in enumerate(ranks):
        g = g[grad]
        np.testing.assert_allclose(g["loss"], float(loss), rtol=1e-3)
        want = h.rank_slice(full, h.GRADS[grad], r, torch)
        for k in ("router", "w1", "w3", "w2"):
            assert _rel(g[k], want[k]) <= GRAD_TOL, (r, k, _rel(g[k], want[k]))
        assert _rel(g["x"], x.grad.float().numpy()) <= GRAD_TOL, (r, "x")


def test_rank_grids_place_ranks_row_major():
    """The grid's coordinates, group indices and members, without a
    process group: rank r of (2, 4) sits at (r // 4, r % 4)."""
    from repro_torch.launch.mesh import Grid
    for r in range(8):
        g = Grid(h.SHAPE, h.AXES, r, {})
        assert g.coords == {"data": r // 4, "model": r % 4}
        assert g.index("model") == r % 4 and g.index("data") == r // 4
        assert g.index(("model", "data")) == r          # grid order
        assert g.axis_size(("data", "model", "pod")) == 8
        members = g.members("data")
        assert [m["data"] for m in members] == [0, 1]
        assert all(m["model"] == r % 4 for m in members)

