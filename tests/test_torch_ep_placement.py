"""Expert-parallel dispatch of the port on 8 gloo ranks: the reference's
battery (tests/test_ep_dispatch.py), checks 6-11 — the permuted
placement, phantom padding, share-weighted replicas on both paths, the
capacity path's drops and baseline, and ragged dispatch at the starved
capacity factor. Run and held as tests/test_torch_ep.py runs checks 1-5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as h  # noqa: E402
from repro_torch.launch.mesh import run_ranks  # noqa: E402

torch.set_num_threads(1)

NAMES = ["permuted", "phantom", "a2a+weighted", "replicated+weighted",
         "capacity-drops", "capacity-baseline", "ragged-starved",
         "ragged-starved-replicated"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep") / "ref.npz")
    proc = h.start_reference("jax_battery", path, 8, NAMES)
    try:
        ranks = run_ranks(h.battery_rank, 8, args=(NAMES,), timeout_s=300)
    except BaseException:
        proc.kill()
        raise
    return ranks, h.wait_reference(proc, path)


def test_permuted_placement(runs):
    """ViBE permutation: migrated weights + slot tables == identity
    semantics; the port's ``apply_placement`` builds the migrated weights
    the check uses."""
    from repro_torch.models import moe as tmoe
    inp = h.battery_inputs()
    p = h.port_params(torch, inp["p"])
    migrated, moved = tmoe.apply_placement(
        {k: v[None] for k, v in p.items() if k != "router"},
        np.arange(h.E)[None], inp["perm"])
    assert moved > 0
    for k in ("w1", "w3", "w2"):
        assert torch.equal(migrated[k][0],
                           h.port_params(torch, inp["p2"])[k])
    h.hold(*runs, "permuted")


def test_phantom_padding(runs):
    from repro_torch.models import moe as tmoe
    assert tmoe.n_slots_a2a(6, 4) == 8
    np.testing.assert_array_equal(tmoe.default_perm_a2a(1, 6, 4),
                                  np.arange(8)[None])
    h.hold(*runs, "phantom")


@pytest.mark.parametrize("name", ["a2a+weighted", "replicated+weighted"])
def test_share_weighted_replicas(runs, name):
    h.hold(*runs, name)


def test_capacity_drops_surface_in_the_tally(runs):
    ranks, ref = runs
    y, tally, _ = ranks[0][0]["capacity-drops"]
    assert float(tally[-1]) > 0, "starved capacity produced no drops"
    assert float(tally[:h.E].sum()) == 4 * 32 * h.K
    np.testing.assert_array_equal(tally, ref["capacity-drops/tally"])
    np.testing.assert_allclose(y, ref["capacity-drops/y"], rtol=h.BF16_TOL,
                               atol=h.BF16_TOL)
    for out, _ in ranks[1:]:
        np.testing.assert_array_equal(out["capacity-drops"][0], y)


def test_capacity_baseline(runs):
    h.hold(*runs, "capacity-baseline")


@pytest.mark.parametrize("name", ["ragged-starved",
                                  "ragged-starved-replicated"])
def test_ragged_is_dropless_at_the_starved_factor(runs, name):
    _, tally = h.hold(*runs, name, 1e-3)
    assert float(tally[-1]) == 0, f"{name} reported drops"
