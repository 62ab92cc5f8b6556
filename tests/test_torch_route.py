"""The port's fused routing stage against the JAX package's routing.

``ref.route_select_ref`` (the plain version of ``csrc/route_select.cu``)
must compute what the reference's ``route`` → ``_select_slots`` →
``_masked_tally`` → ``_aux_loss`` compute on the same numpy inputs:
indices, slots and the tally exactly (they decide placements and drops),
gate weights, mean probabilities and the aux loss within 1e-6 (the f32
router product is summed in another order). The kernel itself runs only on
the card (``tests/test_torch_gpu.py``); here its launch plan is checked for
the invariants the CUDA source relies on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.models import moe as jmoe  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import route_select as t_route  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-6


def _tables(rng, E, R, n_slots):
    """Replica tables with R copy columns: each expert 1..R copies on
    distinct random slots, a non-uniform cumulative share over its copies,
    padded with the last slot and 1.0 as the reference pads them."""
    if R == 1:
        so = rng.permutation(n_slots)[:E].astype(np.int32)[:, None]
        return so, np.ones(E, np.int32), np.ones((E, 1), np.float32)
    so = np.zeros((E, R), np.int32)
    nc = rng.integers(1, R + 1, size=E).astype(np.int32)
    nc[0] = R                                   # at least one full row
    cdf = np.ones((E, R), np.float32)
    for e in range(E):
        so[e] = rng.choice(n_slots, size=R, replace=False)
        share = rng.uniform(0.1, 1.0, size=nc[e])
        c = np.cumsum(share / share.sum()).astype(np.float32)
        cdf[e, :nc[e]] = c
        cdf[e, nc[e]:] = 1.0
        so[e, nc[e]:] = so[e, nc[e] - 1]
    return so, nc, cdf


def _jax_route(x, w, so, nc, cdf, seed, K, rv):
    """The reference's routing stage, composed as its dispatch bodies
    compose it."""
    weights, idx, mean_prob = jmoe.route(jnp.asarray(w), x, K)
    if rv is not None:
        weights = weights * jnp.asarray(rv)[:, None].astype(weights.dtype)
    slots = jmoe._select_slots(idx, jnp.asarray(so), jnp.asarray(nc),
                               jnp.asarray(cdf), jnp.int32(seed))
    tally = jmoe._masked_tally(idx, w.shape[1],
                               None if rv is None else jnp.asarray(rv))
    aux = jmoe._aux_loss(tally, mean_prob, w.shape[1])
    return [np.asarray(a) for a in (weights, idx, slots, tally, mean_prob,
                                    aux)]


def _torch_route(x, w, so, nc, cdf, seed, K, rv, fn=ref.route_select_ref):
    out = fn(x, torch.from_numpy(w), torch.from_numpy(so),
             torch.from_numpy(nc), torch.from_numpy(cdf),
             torch.tensor(seed, dtype=torch.int32), K,
             None if rv is None else torch.from_numpy(rv))
    return [o.detach().float().numpy() if o.dtype == torch.bfloat16
            else o.detach().numpy() for o in out]


def _compare(got, want, E):
    w_t, i_t, s_t, t_t, mp_t, aux_t = got
    w_j, i_j, s_j, t_j, mp_j, aux_j = want
    np.testing.assert_array_equal(i_t, i_j)                       # exact
    np.testing.assert_array_equal(s_t, s_j)                       # exact
    assert t_t.shape == (E + 1,) and t_t[E] == 0.0
    np.testing.assert_array_equal(t_t[:E], t_j)                   # exact
    np.testing.assert_allclose(w_t, w_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(mp_t, mp_j, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux_t, aux_j, rtol=TOL, atol=TOL)


def _inputs(rng, T, D, E, dtype):
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    if dtype == "bf16":
        xt = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(x, dtype=jnp.bfloat16)
    else:
        xt, xj = torch.from_numpy(x), jnp.asarray(x)
    return xt, xj, w


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("R", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_route_select_ref_matches_jax(seed, R, masked):
    rng = np.random.default_rng(100 * seed + 10 * R + masked)
    T, D, E, K = 37, 48, 16, 4
    xt, xj, w = _inputs(rng, T, D, E, "f32")
    so, nc, cdf = _tables(rng, E, R, n_slots=24)
    rv = (rng.random(T) < 0.7) if masked else None
    route_seed = [0, 12345, -7][seed]
    got = _torch_route(xt, w, so, nc, cdf, route_seed, K, rv)
    want = _jax_route(xj, w, so, nc, cdf, route_seed, K, rv)
    _compare(got, want, E)
    if R > 1:   # replicas are really chosen among: some expert's
        # assignments land on more than one of its slots
        assert any(len(np.unique(got[2][got[1] == e])) > 1 for e in range(E))
    if masked:
        assert (got[0][~rv] == 0).all() and got[3][:E].sum() == rv.sum() * K


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("T", [1, 8, 13, 200])
def test_route_select_ref_matches_jax_at_granite_widths(T, dtype):
    """granite's router widths (E 40, K 8) with three-copy tables, T from
    one row to not a multiple of 8, activations in f32 and bf16."""
    rng = np.random.default_rng(T)
    D, E, K = 96, 40, 8
    xt, xj, w = _inputs(rng, T, D, E, dtype)
    so, nc, cdf = _tables(rng, E, 3, n_slots=64)
    rv = rng.random(T) < 0.5
    rv[0] = True
    got = _torch_route(xt, w, so, nc, cdf, T + 3, K, rv)
    want = _jax_route(xj, w, so, nc, cdf, T + 3, K, rv)
    _compare(got, want, E)


@pytest.mark.parametrize("R", [1, 3])
def test_route_select_ref_ties_go_to_the_smaller_column(R):
    """Duplicated router columns and integer-valued inputs make the logits
    exact in any summation order, so equal columns tie exactly: both sides
    pick the smaller column first, as ``lax.top_k`` does."""
    rng = np.random.default_rng(7 + R)
    T, D, E, K = 21, 16, 12, 5
    x = rng.integers(-3, 4, size=(T, D)).astype(np.float32)
    w = rng.integers(-2, 3, size=(D, E)).astype(np.float32) / 8.0
    for a, b in ((1, 4), (2, 9), (0, 11), (4, 7)):
        w[:, b] = w[:, a]
    so, nc, cdf = _tables(rng, E, R, n_slots=16)
    got = _torch_route(torch.from_numpy(x), w, so, nc, cdf, 5, K, None)
    want = _jax_route(jnp.asarray(x), w, so, nc, cdf, 5, K, None)
    _compare(got, want, E)
    idx = got[1]
    pairs = [(1, 4), (2, 9), (0, 11), (4, 7)]
    both = [(r, a, b) for r in range(T) for a, b in pairs
            if a in idx[r] and b in idx[r]]
    assert both                     # ties really occurred
    for r, a, b in both:
        ka, kb = list(idx[r]).index(a), list(idx[r]).index(b)
        assert got[0][r, ka] == got[0][r, kb] and ka < kb


def test_ops_route_select_on_cpu_is_the_plain_version_and_counts_nothing():
    rng = np.random.default_rng(3)
    T, D, E, K = 19, 32, 10, 3
    xt, _, w = _inputs(rng, T, D, E, "bf16")
    so, nc, cdf = _tables(rng, E, 2, n_slots=14)
    rv = rng.random(T) < 0.6
    ops.reset_launch_counts()
    got = _torch_route(xt, w, so, nc, cdf, 9, K, rv, fn=ops.route_select)
    want = _torch_route(xt, w, so, nc, cdf, 9, K, rv)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert ops.launch_counts()["route_select"] == 0
    assert all(v == 0 for v in ops.launch_counts().values())


def test_route_select_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: no silent plain-version path."""
    E = 8
    args = (torch.zeros((4, 16), dtype=torch.bfloat16), torch.zeros((16, E)),
            torch.zeros((E, 1), dtype=torch.int32),
            torch.ones(E, dtype=torch.int32), torch.ones((E, 1)),
            torch.tensor(0, dtype=torch.int32))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        t_route.route_select(*args, 2)
    with pytest.raises(ValueError, match="CUDA"):
        t_route.router_topk(torch.zeros((4, E)), 2)
    assert all(v == 0 for v in ops.launch_counts().values())


@pytest.mark.parametrize("T,D,E", [
    (1, 1536, 40), (8, 1536, 40), (128, 1536, 40), (512, 1536, 40),
    (4096, 1536, 40), (513, 1536, 128), (8, 7168, 256), (300, 100, 1024),
    (7, 20, 3)])
def test_route_select_plan_fits_the_kernel(T, D, E):
    """The launch plan keeps what ``csrc/route_select.cu`` checks and
    relies on: every row in a row block, 4 x 4 outputs for at most 256
    threads, chunks a multiple of 8 deep covering D with no empty split,
    and shared memory within the 200 KB the kernel allows (replica tables
    of up to 8 copies)."""
    tr, dc, split, cps, n_rb = t_route.plan(T, D, E)
    ncg = -(-E // 4)
    assert tr % 4 == 0 and (tr // 4) * ncg <= t_route.THREADS
    assert n_rb == -(-T // tr) and n_rb * tr >= T
    assert dc % 8 == 0 and split * cps * dc >= D
    assert (split - 1) * cps * dc < D                  # no empty split
    assert 1 <= split <= t_route.MAX_SPLIT
    ep = 4 * ncg
    stage = 2 * (tr * (dc + 8) * 2 + dc * ep * 4)
    epi = (tr * ep + 3 * ep + 2 * t_route.THREADS + E * (2 * 8 + 1)) * 4
    assert max(stage, epi) <= 200 * 1024
    if n_rb == 1:       # decode: D is split so several blocks read w
        n_chunks = -(-D // dc)
        assert cps == -(-n_chunks // min(t_route.MAX_SPLIT, n_chunks))
