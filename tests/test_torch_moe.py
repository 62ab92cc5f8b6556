"""The port's MoE layer against the JAX package on identical inputs.

Routing, replica choice, the sort-based plan, the bucket positions and the
tallies (the drop column included) must be bit for bit the reference's
(they decide placements and drops); outputs are held to the tolerances of
tests/test_kernels.py: 1e-4 in f32, 5e-2 in bf16. The JAX side runs its
Pallas kernels in interpret mode: the ragged one through
``ShardingRules(mesh=None, moe_impl="ragged", moe_block_m=8,
use_kernel=True)``, the capacity one through the real ``shard_map`` bodies
on a one-device mesh (``use_kernel=True``, inside ``compat.use_mesh``),
as tests/test_capacity_overflow.py runs them.
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro.models.sharding import build_copy_cdf, build_slots_of  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.kernels import ragged_moe_ffn as t_ragged  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 5e-2
J_RULES = JRules(mesh=None, moe_impl="ragged", moe_block_m=8, use_kernel=True)
T_RULES = ShardingRules(moe_block_m=8)


def _np(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


def _replicated_tables(seed, E=6, n_slots=10, L=1):
    """A vibe_r-style placement: every expert once, four extra replicas,
    random traffic shares → (slots_of, n_copies, copy_cdf), r_max > 1."""
    rng = np.random.default_rng(seed)
    perm = np.concatenate([np.arange(E), rng.integers(0, E, n_slots - E)])
    perm = np.stack([rng.permutation(perm) for _ in range(L)]).astype(np.int32)
    share = rng.uniform(0.2, 1.0, size=perm.shape)
    so, nc = build_slots_of(perm, E, n_slots)
    cdf = build_copy_cdf(perm, E, n_slots, share=share, r_max=so.shape[-1])
    assert so.shape[-1] > 1
    return perm, so[0], nc[0], cdf[0]


def test_route_matches_jax():
    rng = np.random.default_rng(0)
    router = (rng.standard_normal((32, 8)) / 6).astype(np.float32)
    xf = rng.standard_normal((50, 32)).astype(np.float32)
    w_j, i_j, mp_j = jmoe.route(jnp.asarray(router), jnp.asarray(xf), 3)
    w_t, i_t, mp_t = tmoe.route(torch.from_numpy(router),
                                torch.from_numpy(xf), 3)
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_j))   # exact
    # the f32 router product sums in another order: within 1e-6
    np.testing.assert_allclose(_np(w_t), np.asarray(w_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(_np(mp_t), np.asarray(mp_j), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seed", [0, 1, 77, 12345, 2 ** 31 - 1, -7, -2 ** 31])
def test_assignment_uniforms_bit_exact(seed):
    u_j = np.asarray(jmoe._assignment_uniforms(37, 8, jnp.int32(seed)))
    u_t = _np(tmoe._assignment_uniforms(37, 8, torch.tensor(seed,
                                                             dtype=torch.int32)))
    np.testing.assert_array_equal(u_t, u_j)                    # exact


@pytest.mark.parametrize("route_seed", [0, 3, 1000, 2 ** 30 + 5, -11])
@pytest.mark.parametrize("weighted", [True, False])
def test_select_slots_replicas_bit_exact(route_seed, weighted):
    _, so, nc, cdf = _replicated_tables(route_seed & 0xFF)
    idx = np.random.default_rng(route_seed & 0xFFFF).integers(
        0, so.shape[0], size=(40, 3)).astype(np.int32)
    s_j = jmoe._select_slots(jnp.asarray(idx), jnp.asarray(so),
                             jnp.asarray(nc),
                             jnp.asarray(cdf) if weighted else None,
                             jnp.int32(route_seed))
    s_t = tmoe._select_slots(torch.from_numpy(idx), torch.from_numpy(so),
                             torch.from_numpy(nc),
                             torch.from_numpy(cdf) if weighted else None,
                             torch.tensor(route_seed, dtype=torch.int32))
    np.testing.assert_array_equal(_np(s_t), np.asarray(s_j))   # exact
    assert len(np.unique(np.asarray(s_j))) > so.shape[0]       # replicas hit


@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("n_slots,bm", [(6, 4), (10, 8)])
def test_sort_and_ragged_plan_bit_exact(with_active, n_slots, bm):
    rng = np.random.default_rng(n_slots + bm)
    slot_flat = rng.integers(0, n_slots, size=57).astype(np.int32)
    slot_flat[slot_flat == 2] = 1                  # slot 2 stays empty
    active = rng.random(57) < 0.7 if with_active else None
    ja = None if active is None else jnp.asarray(active)
    ta = None if active is None else torch.from_numpy(active)
    sj = jmoe._sort_by_slot(jnp.asarray(slot_flat), n_slots, ja)
    st = tmoe._sort_by_slot(torch.from_numpy(slot_flat), n_slots, ta)
    for a, b in zip(st, sj):
        np.testing.assert_array_equal(_np(a), np.asarray(b))   # exact
    pj = jmoe._ragged_plan(jnp.asarray(slot_flat), n_slots, bm, ja)
    pt = tmoe._ragged_plan(torch.from_numpy(slot_flat), n_slots, bm, ta)
    for a, b in zip(pt[:3], pj[:3]):
        np.testing.assert_array_equal(_np(a), np.asarray(b))   # exact
    assert pt[3] == pj[3]
    # the real rows of each tile, as the kernel works them out from the
    # plan's row offsets and sizes: the active assignments the JAX plan
    # puts into that tile's rows
    rows_j = np.asarray(pj[1])
    want = np.bincount(rows_j[rows_j < pj[3]] // bm,
                       minlength=pt[2].shape[0])
    tile_rows = t_ragged.ragged_tile_rows(pt[4], pt[5], pt[2], bm)
    np.testing.assert_array_equal(_np(tile_rows), want)


def _moe_params(seed, d, f, E, n_slots, dtype):
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w1": rng.standard_normal((n_slots, d, f)) / np.sqrt(d),
         "w3": rng.standard_normal((n_slots, d, f)) / np.sqrt(d),
         "w2": rng.standard_normal((n_slots, f, d)) / np.sqrt(f)}
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else dtype)
          for k, v in p.items()}
    tp = {k: tensor_from_numpy(np.asarray(v)) for k, v in jp.items()}
    return jp, tp


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("replicated", [False, True])
def test_moe_layer_matches_jax_ragged_kernel(dtype, replicated):
    E, d, f, K = 6, 32, 48, 2
    n_slots = 10 if replicated else E
    jp, tp = _moe_params(1, d, f, E, n_slots, dtype)
    x = np.random.default_rng(2).standard_normal((2, 9, d)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = tensor_from_numpy(np.asarray(jx))
    tables_j, tables_t = {}, {}
    if replicated:
        _, so, nc, cdf = _replicated_tables(5, E=E, n_slots=n_slots)
        for k, v in (("slots_of", so), ("n_copies", nc), ("copy_cdf", cdf)):
            tables_j[k] = jnp.asarray(v)
            tables_t[k] = torch.from_numpy(v)
    y_j, tal_j, aux_j = jmoe.moe_layer(jp, jx, top_k=K, n_experts=E,
                                       rules=J_RULES, route_seed=jnp.int32(7),
                                       **tables_j)
    y_t, tal_t, aux_t = tmoe.moe_layer(tp, tx, top_k=K, n_experts=E,
                                       rules=T_RULES, route_seed=7,
                                       **tables_t)
    np.testing.assert_array_equal(_np(tal_t), np.asarray(tal_j))   # exact
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=F32_TOL)


@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("n_slots", [5, 12])
def test_bucket_positions_bit_exact(with_active, n_slots):
    rng = np.random.default_rng(n_slots)
    slot_flat = rng.integers(0, n_slots, size=83).astype(np.int32)
    slot_flat[slot_flat == 3] = 0                  # one hot, one empty slot
    active = rng.random(83) < 0.6 if with_active else None
    p_j = np.asarray(jmoe._bucket_positions(
        jnp.asarray(slot_flat), n_slots,
        None if active is None else jnp.asarray(active)))
    p_t = _np(tmoe._bucket_positions(
        torch.from_numpy(slot_flat), n_slots,
        None if active is None else torch.from_numpy(active)))
    assert p_t.dtype == np.int32
    np.testing.assert_array_equal(p_t, p_j)                    # exact


MESH = compat.make_mesh((1,), ("model",))


def _j_mesh_rules(impl, cf=1.25, dispatch="auto"):
    """The reference's one-device mesh, as its EP tests build it."""
    return JRules(mesh=MESH, dp=(), ep=("model",), ep_all=("model",),
                  fsdp=None, moe_dispatch=dispatch, moe_impl=impl,
                  capacity_factor=cf, moe_block_m=8, use_kernel=True)


def _layer_inputs(dtype, replicated, skewed, E=6, d=32, f=48):
    """Params, tokens and (optional) replica tables on both sides. A
    skewed router sends almost every token to expert 0, so buckets
    overflow at decode too (where the capacity factor is raised to 2)."""
    n_slots = 10 if replicated else E
    jp, tp = _moe_params(1, d, f, E, n_slots, dtype)
    x = np.random.default_rng(2).standard_normal((2, 9, d)).astype(np.float32)
    if skewed:
        x = x + 1.0
        router = np.asarray(jp["router"]).copy()
        router[:, 0] += 2.0
        jp["router"] = jnp.asarray(router)
        tp["router"] = torch.from_numpy(router)
    jx = jnp.asarray(x, dtype)
    tx = tensor_from_numpy(np.asarray(jx))
    tables_j, tables_t = {}, {}
    if replicated:
        _, so, nc, cdf = _replicated_tables(5, E=E, n_slots=n_slots)
        for k, v in (("slots_of", so), ("n_copies", nc), ("copy_cdf", cdf)):
            tables_j[k] = jnp.asarray(v)
            tables_t[k] = torch.from_numpy(v)
    return jp, tp, jx, tx, tables_j, tables_t


def _j_mesh_layer(jp, jx, rules, phase, tables, K=2, E=6):
    with compat.use_mesh(MESH):
        return jax.jit(lambda p, x, t: jmoe.moe_layer(
            p, x, top_k=K, n_experts=E, rules=rules, phase=phase,
            route_seed=jnp.int32(7), **t))(jp, jx, tables)


def _hold(y_t, tal_t, aux_t, y_j, tal_j, aux_j, dtype):
    np.testing.assert_array_equal(_np(tal_t), np.asarray(tal_j))   # exact
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=F32_TOL)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("replicated", [False, True])
@pytest.mark.parametrize("starved", [False, True])
def test_capacity_bodies_match_jax_one_device_mesh(dtype, phase, replicated,
                                                   starved):
    """The a2a (prefill) and replicated (decode) capacity bodies at one
    rank against the reference's shard_map bodies on a one-device mesh
    with the capacity Pallas kernel: drop column and tallies exact."""
    cf = 0.25 if starved else 1.25
    jp, tp, jx, tx, tj, tt = _layer_inputs(dtype, replicated, starved)
    y_j, tal_j, aux_j = _j_mesh_layer(jp, jx, _j_mesh_rules("capacity", cf),
                                      phase, tj)
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1,
                          capacity_factor=cf)
    y_t, tal_t, aux_t = tmoe.moe_layer(tp, tx, top_k=2, n_experts=6,
                                       rules=rules, route_seed=7,
                                       phase=phase, **tt)
    _hold(y_t, tal_t, aux_t, y_j, tal_j, aux_j, dtype)
    if starved:
        assert float(tal_t[-1]) > 0               # the buckets overflow
    assert float(tal_t[:-1].sum()) == 2 * 9 * 2   # pre-capacity counts


@pytest.mark.parametrize("dispatch,phase", [
    ("replicated", "prefill"), ("a2a", "decode"), ("dense", "prefill")])
def test_capacity_dispatch_override_matches_jax(dispatch, phase):
    """``moe_dispatch`` overrides the phase's body as the reference's does
    (``"dense"`` on a group: the oracle)."""
    dtype = jnp.float32
    jp, tp, jx, tx, tj, tt = _layer_inputs(dtype, True, True)
    y_j, tal_j, aux_j = _j_mesh_layer(
        jp, jx, _j_mesh_rules("capacity", dispatch=dispatch), phase, tj)
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1,
                          moe_dispatch=dispatch)
    y_t, tal_t, aux_t = tmoe.moe_layer(tp, tx, top_k=2, n_experts=6,
                                       rules=rules, route_seed=7,
                                       phase=phase, **tt)
    _hold(y_t, tal_t, aux_t, y_j, tal_j, aux_j, dtype)
    assert (float(tal_t[-1]) > 0) == (dispatch != "dense")


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("replicated", [False, True])
@pytest.mark.parametrize("masked", [False, True])
def test_dense_oracle_matches_jax_rules_none(dtype, replicated, masked):
    """Capacity without a group is the dense oracle: the reference's
    ``rules=None``, padding mask included."""
    jp, tp, jx, tx, tj, tt = _layer_inputs(dtype, replicated, False)
    rv = np.arange(18) % 7 != 3 if masked else None
    y_j, tal_j, aux_j = jmoe.moe_layer(
        jp, jx, top_k=2, n_experts=6, rules=None, route_seed=jnp.int32(7),
        row_valid=None if rv is None else jnp.asarray(rv), **tj)
    y_t, tal_t, aux_t = tmoe.moe_layer(
        tp, tx, top_k=2, n_experts=6,
        rules=ShardingRules(moe_impl="capacity"), route_seed=7,
        row_valid=None if rv is None else torch.from_numpy(rv), **tt)
    _hold(y_t, tal_t, aux_t, y_j, tal_j, aux_j, dtype)
    assert float(tal_t[-1]) == 0.0


@pytest.mark.parametrize("phase", ["prefill", "decode"])
@pytest.mark.parametrize("replicated", [False, True])
def test_one_rank_ragged_matches_jax_ragged_bodies(phase, replicated):
    """Ragged on a one-rank group: the reference's ragged a2a (prefill)
    and replicated (decode) bodies on a one-device mesh compute what the
    port's single-device ragged dispatch does."""
    dtype = jnp.float32
    jp, tp, jx, tx, tj, tt = _layer_inputs(dtype, replicated, True)
    y_j, tal_j, aux_j = _j_mesh_layer(jp, jx, _j_mesh_rules("ragged"), phase,
                                      tj)
    rules = ShardingRules(moe_block_m=8, ep_ranks=1)
    y_t, tal_t, aux_t = tmoe.moe_layer(tp, tx, top_k=2, n_experts=6,
                                       rules=rules, route_seed=7,
                                       phase=phase, **tt)
    _hold(y_t, tal_t, aux_t, y_j, tal_j, aux_j, dtype)
    assert float(tal_t[-1]) == 0.0


def test_group_refuses_row_valid_and_more_than_one_rank():
    _, tp = _moe_params(0, 16, 16, 4, 4, jnp.float32)
    x = torch.zeros((1, 3, 16))
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1)
    with pytest.raises(NotImplementedError, match="row_valid"):
        tmoe.moe_layer(tp, x, top_k=2, n_experts=4, rules=rules,
                       phase="prefill", row_valid=torch.ones(3, dtype=bool))
    # a group of more than one rank lives on a grid of ranks
    with pytest.raises(ValueError, match="needs a grid"):
        ShardingRules(moe_impl="capacity", ep_ranks=2)
    with pytest.raises(ValueError, match="moe_dispatch"):
        ShardingRules(moe_dispatch="ring")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_placement_gather_and_apply_exact(seed):
    rng = np.random.default_rng(seed)
    L, E, NS = 3, 5, 8
    old = np.stack([rng.permutation(np.arange(NS) % E) for _ in range(L)])
    new = np.stack([rng.permutation(np.arange(NS) % E) for _ in range(L)])
    gi_j = jmoe.placement_gather_indices(old, new)
    gi_t = tmoe.placement_gather_indices(old, new)
    np.testing.assert_array_equal(gi_t, gi_j)                   # exact
    w = rng.standard_normal((L, NS, 4, 3)).astype(np.float32)
    leaf = {"w1": w, "w2": w[..., :2], "w3": -w, "router": w[0, 0]}
    out_j, moved_j = jmoe.apply_placement(
        {k: jnp.asarray(v) for k, v in leaf.items()}, old, new)
    out_t, moved_t = tmoe.apply_placement(
        {k: torch.from_numpy(np.array(v)) for k, v in leaf.items()}, old,
        new)
    assert moved_t == moved_j > 0
    for k in leaf:
        np.testing.assert_array_equal(_np(out_t[k]), np.asarray(out_j[k]))
