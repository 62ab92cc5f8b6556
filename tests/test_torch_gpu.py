"""The port's kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: each test skips on a host without a CUDA device, where the
kernels cannot run (they have no CPU mode; the CPU tests hold the plain
versions against the JAX package instead). This file imports neither jax
nor the reference package, so it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

The FFN kernels have two routes: the TMA route (TMA ring and wgmma) for D
and F multiples of 8, the general route (WMMA) otherwise; the cases below
name the route they take and check it on the per-route counters.

Tolerances: bf16 outputs within 5e-2 (tests/test_kernels.py's bf16
tolerance; kernel and plain version round the f32 accumulators at the same
points but sum in another order), router indices exactly equal and weights
within 1e-5. The recurrent mixers (torch ops, no kernel of their own) on
CUDA tensors against the same functions on CPU tensors in f32: each output
and state leaf within 1e-5 relative L2.
"""

import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.kernels import moe_ffn as t_capacity  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ragged_moe_ffn as t_ragged  # noqa: E402
from repro_torch.kernels import route_select as t_route  # noqa: E402
from repro_torch.models import model as t_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as t_ssm  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.tree import leaves as t_leaves  # noqa: E402

pytestmark = pytest.mark.gpu

BF16_TOL = 5e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _ragged_inputs(dev, sizes, D, F, bm, seed=0, with_rows=False):
    g = torch.Generator().manual_seed(seed)
    E = len(sizes)
    sizes_t = torch.tensor(sizes, dtype=torch.int32)
    n_tiles = t_ragged.ragged_n_tiles(int(sizes_t.sum()), E, bm)
    ro, tg = t_ragged.ragged_tile_metadata(sizes_t, bm, n_tiles)
    toks = torch.zeros((n_tiles * bm, D))
    for e in range(E):
        toks[ro[e]:ro[e] + sizes[e]] = torch.randn((sizes[e], D), generator=g)
    w = [torch.randn(s, generator=g) / math.sqrt(s[1])
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    bf = [t.to(dev, torch.bfloat16) for t in (*w, toks)]
    if with_rows:
        # the layout's row offsets, the sizes, and each tile's real rows
        tr = t_ragged.ragged_tile_rows(ro, sizes_t, tg, bm)
        return bf, tg.to(dev), (ro.to(dev), sizes_t.to(dev), tr.to(dev))
    return bf, tg.to(dev)


def _routed_sizes(tokens, E, K, seed):
    """Per-expert row counts of ``tokens`` tokens, each routed to K
    distinct experts drawn Zipf-skewed, as the router does."""
    g = torch.Generator().manual_seed(seed)
    p = 1.0 / torch.arange(1, E + 1, dtype=torch.float64) ** 1.2
    picks = torch.stack([torch.multinomial(p, K, generator=g)
                         for _ in range(tokens)])
    return torch.bincount(picks.reshape(-1), minlength=E).tolist()


def _tma_expected(D, F):
    return D % 8 == 0 and F % 8 == 0


@pytest.mark.parametrize("sizes,D,F,bm", [
    ([70, 0, 130, 3], 128, 192, 64),      # aligned, one empty expert: TMA
    ([5, 300, 0, 0, 9], 160, 130, 128),   # F not a multiple of 8: general
    ([33, 1, 64], 200, 100, 64),          # D, F not multiples of 8: general
])
def test_ragged_moe_ffn_kernel_matches_plain(cuda, sizes, D, F, bm):
    (w1, w3, w2, toks), tg = _ragged_inputs(cuda, sizes, D, F, bm)
    ops.reset_launch_counts()
    y = ops.ragged_moe_ffn(w1, w3, w2, toks, tg)
    y_ref = ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ragged_moe_ffn"] == 1
    assert ops.launch_counts()["ragged_moe_ffn.tma"] == int(
        _tma_expected(D, F))
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    sentinel = (tg >= len(sizes)).repeat_interleave(bm)
    assert sentinel.any() and bool((y[sentinel] == 0).all())


@pytest.mark.parametrize("case,tokens,max_rows,bm,give_rows,rows", [
    ("decode-8", 8, 8, 128, True, 8),        # granite's 8-lane decode
    ("decode-16", 16, 16, 128, True, 16),
    ("prefill-512", 512, 512, 128, True, 128),
    ("hint-exceeded", 64, 8, 128, True, 8),  # tiles hold up to 64 rows
    ("no-tile-rows", 8, 8, 128, False, 8),   # every tile taken as full
    ("bm-64", 200, None, 64, True, 64),
    ("off-grid-decode", 8, 8, 128, True, 8),       # D=160, F=136
    ("off-grid-prefill", 300, None, 128, True, 128),
])
def test_ragged_moe_ffn_tma_route(cuda, case, tokens, max_rows, bm,
                                  give_rows, rows):
    """The TMA route at granite's widths (E 40, K 8, D 1536, F 512; the
    off-grid cases D 160 and F 136, whose last column block is partial)
    against the plain version: padding and sentinel rows exactly zero,
    two calls bitwise equal, the hint ``max_rows`` never trusted."""
    E, K = 40, 8
    D, F = (160, 136) if case.startswith("off-grid") else (1536, 512)
    sizes = _routed_sizes(tokens, E, K, seed=tokens)
    if case == "hint-exceeded":
        assert max(sizes) > max_rows
    (w1, w3, w2, toks), tg, (ro, sz, tr) = _ragged_inputs(
        cuda, sizes, D, F, bm, with_rows=True)
    kw = dict(row_offsets=ro if give_rows else None,
              sizes=sz if give_rows else None, max_rows=max_rows)
    ops.reset_launch_counts()
    y = ops.ragged_moe_ffn(w1, w3, w2, toks, tg, **kw)
    y2 = ops.ragged_moe_ffn(w1, w3, w2, toks, tg, **kw)
    y_ref = ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ragged_moe_ffn"] == counts["ragged_moe_ffn.tma"] == 2
    assert t_ragged.ragged_moe_ffn.last_route == f"tma rows={rows}"
    assert torch.equal(y, y2)                                 # bit-stable
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    # every row that is no real row (padding and sentinel tiles): exact 0
    pos = torch.arange(toks.shape[0], device=cuda) % bm
    real = pos < tr.repeat_interleave(bm)
    assert (~real).any() and bool((y[~real] == 0).all())


@pytest.mark.parametrize("kind", ["ragged", "capacity"])
def test_ffn_routes_agree_on_the_same_inputs(cuda, kind):
    """``route="general"`` forces the general route: on granite's decode
    shapes it and the TMA route the wrapper picks agree within the bf16
    tolerance, each counted on its own."""
    E, D, F = 40, 1536, 512
    if kind == "ragged":
        (w1, w3, w2, toks), tg = _ragged_inputs(
            cuda, _routed_sizes(8, E, 8, seed=8), D, F, 128)
        fn = t_ragged.ragged_moe_ffn
        args = (w1, w3, w2, toks, tg)
    else:
        fn = t_capacity.fused_moe_ffn
        args = tuple(_capacity_inputs(cuda, E, 4, D, F, empty_rows=1))
    ops.reset_launch_counts()
    y_tma = fn(*args)
    assert fn.last_route.startswith("tma")
    y_gen = fn(*args, route="general")
    torch.cuda.synchronize()
    assert fn.last_route == "general"
    assert fn.launches == 2 and fn.tma_launches == 1
    torch.testing.assert_close(y_tma.float(), y_gen.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    with pytest.raises(ValueError, match="route"):
        fn(*args, route="tma")


def test_ragged_moe_ffn_kernel_refuses_what_it_does_not_take(cuda):
    (w1, w3, w2, toks), tg = _ragged_inputs(cuda, [40, 3], 64, 64, 64)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.ragged_moe_ffn(w1.float(), w3, w2, toks, tg)
    with pytest.raises(ValueError, match="multiple of 64"):
        ops.ragged_moe_ffn(w1, w3, w2, toks, tg.repeat_interleave(2))
    with pytest.raises(ValueError, match="contiguous"):
        ops.ragged_moe_ffn(w1.transpose(1, 2).contiguous().transpose(1, 2),
                           w3, w2, toks, tg)


def _capacity_inputs(dev, E, C, D, F, empty_rows, seed=0):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randn((E, C, D), generator=g)
    toks[:, C - empty_rows:] = 0.0
    w = [torch.randn(s, generator=g) / math.sqrt(s[1])
         for s in ((E, D, F), (E, D, F), (E, F, D))]
    return [t.to(dev, torch.bfloat16) for t in (*w, toks)]


@pytest.mark.parametrize("E,C,D,F", [
    (40, 4, 1536, 512),     # granite's 8-lane decode buckets: TMA, 8 rows
    (6, 130, 256, 192),     # C past one 128-row block: TMA
    (3, 5, 200, 136),       # C, D and F all off the tile grid: TMA
    (2, 9, 100, 70),        # D, F not multiples of 8: general
])
def test_capacity_moe_ffn_kernel_matches_plain(cuda, E, C, D, F):
    w1, w3, w2, toks = _capacity_inputs(cuda, E, C, D, F, empty_rows=2)
    ops.reset_launch_counts()
    y = ops.fused_moe_ffn(w1, w3, w2, toks)
    y_ref = ref.moe_ffn_ref(w1, w3, w2, toks)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_moe_ffn"] == 1
    assert ops.launch_counts()["fused_moe_ffn.tma"] == int(
        _tma_expected(D, F))
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert bool((y[:, C - 2:] == 0).all())           # empty rows: exact 0


@pytest.mark.parametrize("E,C,D,F,empty,rows", [
    (40, 4, 1536, 512, 1, 8),       # granite's 8-lane decode buckets
    (40, 13, 1536, 512, 3, 16),
    (40, 128, 1536, 512, 16, 128),  # granite's 512-token prefill buckets
    (5, 40, 256, 192, 7, 64),
    (4, 300, 256, 264, 5, 128),     # three row blocks, F off the 64 grid
])
def test_capacity_moe_ffn_tma_route(cuda, E, C, D, F, empty, rows):
    """The TMA route against the plain version: empty bucket rows exactly
    zero, nothing written past C, two calls bitwise equal."""
    w1, w3, w2, toks = _capacity_inputs(cuda, E, C, D, F, empty_rows=empty)
    ops.reset_launch_counts()
    y = ops.fused_moe_ffn(w1, w3, w2, toks)
    y2 = ops.fused_moe_ffn(w1, w3, w2, toks)
    y_ref = ref.moe_ffn_ref(w1, w3, w2, toks)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["fused_moe_ffn"] == counts["fused_moe_ffn.tma"] == 2
    assert t_capacity.fused_moe_ffn.last_route == f"tma rows={rows}"
    assert torch.equal(y, y2)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert bool((y[:, C - empty:] == 0).all())


def test_capacity_moe_ffn_kernel_refuses_what_it_does_not_take(cuda):
    w1, w3, w2, toks = _capacity_inputs(cuda, 2, 4, 64, 64, empty_rows=0)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.fused_moe_ffn(w1, w3, w2, toks.float())
    with pytest.raises(ValueError, match="do not fit"):
        ops.fused_moe_ffn(w1, w3, w2[:, :32].contiguous(), toks)
    with pytest.raises(ValueError, match="contiguous"):
        ops.fused_moe_ffn(w1, w3, w2, toks.transpose(1, 2).contiguous()
                          .transpose(1, 2))


@pytest.mark.parametrize("phase", ["prefill", "decode"])
def test_capacity_moe_layer_on_card_matches_cpu(cuda, phase):
    """The capacity bodies on a one-rank group — buckets, kernel, gather
    combine — on the card against the same layer on the CPU; tallies and
    the drop column exactly equal."""
    g = torch.Generator().manual_seed(4)
    E, D, F, K = 8, 256, 192, 2
    p = tmoe.moe_init(g, d=D, f=F, n_experts=E, n_slots=E)
    x = torch.randn((3, 50, D), generator=g).to(torch.bfloat16)
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1,
                          capacity_factor=0.5)
    kw = dict(top_k=K, n_experts=E, rules=rules, route_seed=5, phase=phase)
    y_c, t_c, _ = tmoe.moe_layer(p, x, **kw)
    y_g, t_g, _ = tmoe.moe_layer({k: v.to(cuda) for k, v in p.items()},
                                 x.to(cuda), **kw)
    torch.testing.assert_close(t_g.cpu(), t_c, rtol=0, atol=0)
    torch.testing.assert_close(y_g.float().cpu(), y_c.float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("T,E,K,ties", [(4096, 40, 8, False),
                                        (513, 128, 8, False),
                                        (7, 4, 1, False), (300, 40, 8, True),
                                        (300, 256, 8, False),
                                        (33, 1000, 5, False),
                                        (8, 8, 8, False)])
def test_router_kernel_matches_plain(cuda, T, E, K, ties):
    """The logits-in entry of the routing source (the TPU kernel's
    function), one launch a call, at 2 to 32 columns a lane."""
    g = torch.Generator().manual_seed(T)
    logits = (torch.randint(0, 3, (T, E), generator=g).float() if ties
              else torch.randn((T, E), generator=g)).to(cuda)
    ops.reset_launch_counts()
    w, i = ops.router_topk(logits, K)
    w_ref, i_ref = ref.router_topk_ref(logits, K)
    torch.cuda.synchronize()
    assert ops.launch_counts()["router_topk"] == 1
    assert torch.equal(i, i_ref)                                 # exact
    torch.testing.assert_close(w, w_ref, rtol=1e-5, atol=1e-5)


def test_moe_layer_on_card_matches_cpu(cuda):
    """The whole ragged layer — plan, kernels, gather-combine — on the card
    against the same layer's plain path on the CPU."""
    g = torch.Generator().manual_seed(3)
    E, D, F, K = 8, 256, 192, 2
    p = tmoe.moe_init(g, d=D, f=F, n_experts=E, n_slots=E)
    x = torch.randn((3, 50, D), generator=g).to(torch.bfloat16)
    y_c, t_c, _ = tmoe.moe_layer(p, x, top_k=K, n_experts=E, route_seed=5)
    y_g, t_g, _ = tmoe.moe_layer({k: v.to(cuda) for k, v in p.items()},
                                 x.to(cuda), top_k=K, n_experts=E,
                                 route_seed=5)
    torch.testing.assert_close(t_g.cpu(), t_c, rtol=0, atol=0)
    torch.testing.assert_close(y_g.float().cpu(), y_c.float(),
                               rtol=BF16_TOL, atol=BF16_TOL)


# ---------------------------------------------------------------------------
# the fused routing stage (csrc/route_select.cu)
# ---------------------------------------------------------------------------

ROUTE_TOL = 1e-5      # f32 weights and mean probabilities; aux relative
NEAR_TIE = 1e-5       # adjacent top-(K+1) probabilities closer than this


def _route_inputs(dev, T, D, E, R, masked, seed, dup=()):
    """Seeded activations (bf16), router (f32, N(0, 1/D) as the model's),
    replica tables with R copy columns and a non-uniform cumulative share,
    the seed tensor and an optional row mask, all on ``dev``."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((T, D), generator=g).to(torch.bfloat16)
    w = torch.randn((D, E), generator=g) / math.sqrt(D)
    for a, b in dup:
        w[:, b] = w[:, a]
    n_slots = E * R
    so = torch.randperm(n_slots, generator=g)[:E * R].reshape(E, R)
    nc = torch.randint(1, R + 1, (E,), generator=g)
    share = torch.rand((E, R), generator=g) + 0.1
    share = share * (torch.arange(R)[None, :] < nc[:, None])
    cdf = torch.cumsum(share / share.sum(-1, keepdim=True), -1)
    cdf = torch.where(torch.arange(R)[None, :] < nc[:, None], cdf, 1.0)
    rv = (torch.rand(T, generator=g) < 0.6) if masked else None
    seed_t = torch.tensor(seed * 7919 - 3, dtype=torch.int32)
    args = (x, w, so.to(torch.int32), nc.to(torch.int32),
            cdf.to(torch.float32), seed_t)
    return ([a.to(dev) for a in args],
            None if rv is None else rv.to(dev))


def _near_tie_rows(x, w, K):
    """Rows whose top-(K+1) probabilities have an adjacent gap below
    ``NEAR_TIE``: there the kernel's summation order may pick another
    column than the plain version's, and both are right."""
    p = torch.softmax(x.float() @ w, dim=-1)
    top = torch.topk(p, min(K + 1, p.shape[1]), dim=-1).values
    return ((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(-1)


def _check_route(got, want, x, w, K, rv):
    """Exact indices, slots and tally on rows that are not near ties (the
    tally with those rows' counts taken out of both sides), weights, mean
    probabilities and aux within ``ROUTE_TOL``. Returns the near-tie
    rows' count."""
    w_k, i_k, s_k, t_k, mp_k, aux_k = got
    w_r, i_r, s_r, t_r, mp_r, aux_r = want
    E = w.shape[1]
    near = _near_tie_rows(x, w, K)
    ok = ~near
    assert torch.equal(i_k[ok], i_r[ok])
    assert torch.equal(s_k[ok], s_r[ok].to(torch.int32))
    torch.testing.assert_close(w_k[ok], w_r[ok], rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    valid = near if rv is None else near & rv
    for t, i in ((t_k, i_k), (t_r, i_r)):
        t[:E] -= torch.bincount(i[valid].reshape(-1).long(),
                                minlength=E).float()
    assert torch.equal(t_k, t_r) and float(t_k[E]) == 0.0
    torch.testing.assert_close(mp_k, mp_r, rtol=ROUTE_TOL, atol=ROUTE_TOL)
    torch.testing.assert_close(aux_k, aux_r, rtol=ROUTE_TOL, atol=ROUTE_TOL)
    if rv is not None:
        assert bool((w_k[~rv] == 0).all())
    return int(near.sum())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("T", [1, 8, 513, 4096])
@pytest.mark.parametrize("K", [1, 2, 8])
@pytest.mark.parametrize("E", [8, 40, 64, 128])
def test_route_select_kernel_matches_plain(cuda, E, K, T, R, masked):
    """The fused kernel at granite's D (1536) against its plain version on
    the same inputs; two calls bit-identical; one launch a call."""
    (x, w, so, nc, cdf, seed), rv = _route_inputs(
        cuda, T, 1536, E, R, masked, seed=E + K + T + R)
    ops.reset_launch_counts()
    got = ops.route_select(x, w, so, nc, cdf, seed, K, rv)
    again = ops.route_select(x, w, so, nc, cdf, seed, K, rv)
    want = ref.route_select_ref(x, w, so, nc, cdf, seed, K, rv)
    torch.cuda.synchronize()
    assert ops.launch_counts()["route_select"] == 2
    for a, b in zip(got, again):
        assert torch.equal(a, b)                              # bit-stable
    assert [tuple(t.shape) for t in got] == [
        (T, K), (T, K), (T, K), (E + 1,), (E,), ()]
    _check_route(list(got), list(want), x, w, K, rv)


@pytest.mark.parametrize("T,D,E,K,R", [
    (100, 1536, 256, 8, 2),    # 8 columns a lane
    (37, 100, 1000, 4, 3),     # 32 columns a lane; D not a multiple of 8
    (50, 200, 38, 6, 3),       # E not a multiple of 4: element loads
    (3000, 7168, 256, 8, 1),   # deepseek-v3's router widths
    (9000, 1536, 40, 8, 3),    # 282 row blocks: no split of D (S = 1)
    (64, 24, 40, 8, 3),        # one chunk of D: no split (S = 1)
])
def test_route_select_kernel_off_grid_and_wide(cuda, T, D, E, K, R):
    (x, w, so, nc, cdf, seed), rv = _route_inputs(cuda, T, D, E, R, True,
                                                  seed=T)
    got = ops.route_select(x, w, so, nc, cdf, seed, K, rv)
    want = ref.route_select_ref(x, w, so, nc, cdf, seed, K, rv)
    torch.cuda.synchronize()
    _check_route(list(got), list(want), x, w, K, rv)


def test_route_select_duplicated_columns_go_to_the_smaller(cuda):
    """Equal router columns give bitwise-equal logits in the kernel (every
    column is summed in the same order), so the smaller column always wins
    first, as ``lax.top_k``'s rule."""
    pairs = ((1, 4), (2, 9), (0, 31), (5, 6))
    (x, w, so, nc, cdf, seed), _ = _route_inputs(cuda, 513, 1536, 40, 1,
                                                 False, seed=11, dup=pairs)
    _, idx, _, _, _, _ = ops.route_select(x, w, so, nc, cdf, seed, 8)
    idx = idx.cpu()
    hits = 0
    for a, b in pairs:
        has_b = (idx == b).any(-1)
        assert bool((idx[has_b] == a).any(-1).all())
        ka = (idx == a).int().argmax(-1)
        kb = (idx == b).int().argmax(-1)
        assert bool((ka[has_b] < kb[has_b]).all())
        hits += int(has_b.sum())
    assert hits > 0


def test_route_select_tickets_reset_between_shapes(cuda):
    """Calls at other row counts and splits right after one another each
    find their tickets reset: correct results, no hang."""
    for T in (4096, 8, 513, 1, 4096, 130):
        (x, w, so, nc, cdf, seed), rv = _route_inputs(cuda, T, 1536, 40, 3,
                                                      T % 2 == 0, seed=T)
        got = ops.route_select(x, w, so, nc, cdf, seed, 8, rv)
        want = ref.route_select_ref(x, w, so, nc, cdf, seed, 8, rv)
        torch.cuda.synchronize()
        _check_route(list(got), list(want), x, w, 8, rv)


def test_route_select_refuses_what_it_does_not_take(cuda):
    (x, w, so, nc, cdf, seed), rv = _route_inputs(cuda, 16, 64, 8, 2, True,
                                                  seed=0)
    with pytest.raises(TypeError, match="bfloat16"):
        ops.route_select(x.float(), w, so, nc, cdf, seed, 2, rv)
    with pytest.raises(TypeError, match="float32"):
        ops.route_select(x, w.double(), so, nc, cdf, seed, 2, rv)
    with pytest.raises(TypeError, match="contiguous"):
        ops.route_select(x, w.t().contiguous().t(), so, nc, cdf, seed, 2, rv)
    with pytest.raises(TypeError, match="bool"):
        ops.route_select(x, w, so, nc, cdf, seed, 2, rv.float())
    with pytest.raises(ValueError, match="top_k"):
        ops.route_select(x, w, so, nc, cdf, seed, 9, rv)
    with pytest.raises(ValueError, match="route_seed"):
        ops.route_select(x, w, so, nc, cdf, 5, 2, rv)


# ---------------------------------------------------------------------------
# backward kernels (training)
# ---------------------------------------------------------------------------

# K1 and K2 against the plain backward: both round da, db and the outputs
# to bf16 at the same points, so only f32 sums in another order differ;
# f32 sums rounded to bf16 every 16 terms read 3e-3 to 1e-2
BWD_TOL = 1e-3


def _rel_l2(a, b):
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def _real_rows(n_rows, ro, sizes, dev):
    real = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    for e, n in enumerate(sizes):
        real[ro[e]:ro[e] + n] = True
    return real


# the training shape: ~220 rows an expert (1024 tokens x top-8 over 40
# experts), bm 128, at granite's widths
_TRAIN_SIZES = [220, 231, 0, 198, 245, 210, 17, 230]


@pytest.mark.parametrize("route", [None, "general"])
@pytest.mark.parametrize("sizes,D,F,bm", [
    ([70, 0, 130, 3], 128, 192, 64),      # an empty expert, ragged tails
    ([5, 300, 0, 0, 9], 160, 136, 128),   # two empty experts, bm 128
    ([33, 1, 64], 200, 100, 64),          # F not a multiple of 8
    # K1's 64-row block with D, F not multiples of 64 (a block partly and
    # K2's second 64-row half wholly past the edge)
    ([70, 0, 130, 3, 64], 200, 136, 64),
    ([1000, 200, 0, 40], 1536, 512, 128),  # granite's widths
    (_TRAIN_SIZES, 1536, 512, 128),        # the training shape
])
def test_ragged_ffn_backward_kernels_match_plain(cuda, sizes, D, F, bm,
                                                 route):
    """K1 (dx, da, db) and K2 (dW1, dW3, dW2) against the plain backward,
    relative L2 within ``BWD_TOL``; padding and sentinel rows of dx
    and empty experts' dW exactly zero; two calls bit-identical. Route
    None takes the TMA route wherever D and F are multiples of 8 (checked
    on the route each call took), "general" the WMMA route."""
    (w1, w3, w2, toks), tg, (ro, sz, _) = _ragged_inputs(
        cuda, sizes, D, F, bm, with_rows=True)
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn(toks.shape, generator=g, device=cuda).to(torch.bfloat16)
    _, h = t_ragged.ragged_moe_ffn(w1, w3, w2, toks, tg, row_offsets=ro,
                                   sizes=sz, keep_h=True)
    runs = []
    for _ in range(2):
        dx, da, db = t_ragged.ragged_moe_ffn_dgrad(w1, w3, w2, toks, tg, ro,
                                                   sz, dy, route=route)
        runs.append((dx, *t_ragged.ragged_moe_ffn_wgrad(
            toks, h, da, db, dy, ro, sz, route=route)))
    want = ref.ragged_moe_ffn_bwd_ref(w1, w3, w2, toks, tg, dy)
    torch.cuda.synchronize()
    tma = route is None and _tma_expected(D, F)
    assert t_ragged.ragged_moe_ffn_dgrad.last_route == \
        (f"tma rows={t_ragged.bwd_rows(bm)}" if tma else "general")
    assert t_ragged.ragged_moe_ffn_wgrad.last_route == \
        ("tma" if tma else "general")
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    dx, dw1, dw3, dw2 = runs[0]
    for name, got, exp in zip(("dx", "dw1", "dw3", "dw2"),
                              (dx, dw1, dw3, dw2), want):
        assert got.dtype == torch.bfloat16 and got.shape == exp.shape
        err = _rel_l2(got, exp)
        assert err <= BWD_TOL, (name, err)
    for e, n in enumerate(sizes):
        if n == 0:
            assert not dw1[e].any() and not dw3[e].any() and not dw2[e].any()
    assert not dx[~_real_rows(toks.shape[0], ro, sizes, cuda)].any()


@pytest.mark.parametrize("route", [None, "general"])
@pytest.mark.parametrize("sizes,D,F,bm", [
    ([70, 0, 130, 3], 128, 192, 64),
    ([5, 300, 0, 0, 9], 160, 136, 128),
    (_TRAIN_SIZES, 1536, 512, 128),
])
def test_ragged_ffn_backward_ignores_what_padding_rows_hold(cuda, sizes, D,
                                                            F, bm, route):
    """NaN in the padding rows of dy (before K1) and of h, da, db and dy
    (before K2) changes nothing: every gradient is finite and bit-equal to
    the run on zero padding (0 * NaN would be NaN, so a row past an
    expert's real ones must never enter a sum)."""
    (w1, w3, w2, toks), tg, (ro, sz, _) = _ragged_inputs(
        cuda, sizes, D, F, bm, with_rows=True)
    real = _real_rows(toks.shape[0], ro, sizes, cuda)[:, None]
    g = torch.Generator(device=cuda).manual_seed(3)
    dy = (torch.randn(toks.shape, generator=g, device=cuda)
          * real).to(torch.bfloat16)
    _, h = t_ragged.ragged_moe_ffn(w1, w3, w2, toks, tg, row_offsets=ro,
                                   sizes=sz, keep_h=True)
    out = {}
    for pad in (0.0, float("nan")):
        dy_p = torch.where(real, dy, pad)
        dx, da, db = t_ragged.ragged_moe_ffn_dgrad(w1, w3, w2, toks, tg, ro,
                                                   sz, dy_p, route=route)
        h_p, da_p, db_p = (torch.where(real, t, pad) for t in (h, da, db))
        out[pad == 0.0] = (dx, da[real[:, 0]], db[real[:, 0]],
                           *t_ragged.ragged_moe_ffn_wgrad(
                               toks, h_p, da_p, db_p, dy_p, ro, sz,
                               route=route))
    torch.cuda.synchronize()
    for clean, poisoned in zip(out[True], out[False]):
        assert bool(torch.isfinite(poisoned.float()).all())
        assert torch.equal(clean, poisoned)


def test_ragged_ffn_backward_routes_agree_on_the_same_inputs(cuda):
    """The TMA route and the general route on the same inputs at the
    training shape: every output within ``BWD_TOL`` of the other."""
    (w1, w3, w2, toks), tg, (ro, sz, _) = _ragged_inputs(
        cuda, _TRAIN_SIZES, 1536, 512, 128, with_rows=True)
    real = _real_rows(toks.shape[0], ro, _TRAIN_SIZES, cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    dy = torch.randn(toks.shape, generator=g, device=cuda).to(torch.bfloat16)
    _, h = t_ragged.ragged_moe_ffn(w1, w3, w2, toks, tg, row_offsets=ro,
                                   sizes=sz, keep_h=True)
    got = {}
    for route in (None, "general"):
        dx, da, db = t_ragged.ragged_moe_ffn_dgrad(w1, w3, w2, toks, tg, ro,
                                                   sz, dy, route=route)
        got[route] = (dx, da[real], db[real], *t_ragged.ragged_moe_ffn_wgrad(
            toks, h, da, db, dy, ro, sz, route=route))
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "da", "db", "dw1", "dw3", "dw2"),
                          got[None], got["general"]):
        assert _rel_l2(a, b) <= BWD_TOL, name


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,E,K", [(1024, 40, 8), (33, 8, 2), (64, 128, 4),
                                   (16, 600, 32)])
def test_route_select_backward_kernel_matches_plain(cuda, T, E, K, masked):
    """K3 against the plain backward to the logits on the same forward
    outputs, within 1e-5; two calls bit-identical."""
    (x, w, so, nc, cdf, seed), rv = _route_inputs(cuda, T, 256, E, 1, masked,
                                                  seed=T + E)
    wts, idx, _, tally, _, _, probs = t_route.route_select(
        x, w, so, nc, cdf, seed, K, rv, with_probs=True)
    g = torch.Generator(device=cuda).manual_seed(2)
    dw = torch.randn((T, K), generator=g, device=cuda)
    dm = torch.randn((E,), generator=g, device=cuda)
    daux = torch.randn((), generator=g, device=cuda)
    counts = tally[:E].contiguous()
    got = t_route.route_select_bwd(probs, idx, wts, counts, dw, dm, daux, rv)
    again = t_route.route_select_bwd(probs, idx, wts, counts, dw, dm, daux,
                                     rv)
    want = ref.route_select_dlogits_ref(probs, idx, wts, counts, dw, dm, daux,
                                        rv)
    torch.cuda.synchronize()
    assert torch.equal(got, again)
    assert (got - want).abs().max().item() <= 1e-5
    # the forward's probabilities are the plain version's softmax
    p_ref = torch.softmax(x.float() @ w, dim=-1)
    assert (probs - p_ref).abs().max().item() <= 1e-5


def test_ops_backward_launches_the_kernels(cuda):
    """Through autograd on the card: the forward kernels once, each
    backward kernel once (the FFN's on the TMA route), no plain
    version."""
    (w1, w3, w2, toks), tg, (ro, sz, _) = _ragged_inputs(
        cuda, [40, 0, 9], 64, 64, 64, with_rows=True)
    (x, w, so, nc, cdf, seed), _ = _route_inputs(cuda, 32, 64, 8, 1, False,
                                                 seed=5)
    ins = [t.clone().requires_grad_(True) for t in (w1, w3, w2, toks, x, w)]
    ops.reset_launch_counts()
    y = ops.ragged_moe_ffn(*ins[:4], tg, row_offsets=ro, sizes=sz)
    wts, _, _, _, _, aux = ops.route_select(ins[4], ins[5], so, nc, cdf, seed,
                                            2)
    (y.float().sum() + wts.sum() + aux).backward()
    torch.cuda.synchronize()
    c = ops.launch_counts()
    assert c["ragged_moe_ffn"] == c["ragged_moe_ffn_dgrad"] == \
        c["ragged_moe_ffn_wgrad"] == c["route_select"] == \
        c["route_select_bwd"] == 1
    # D and F multiples of 8: both backward kernels on the TMA route
    assert c["ragged_moe_ffn.tma"] == c["ragged_moe_ffn_dgrad.tma"] == \
        c["ragged_moe_ffn_wgrad.tma"] == 1
    assert all(torch.isfinite(t.grad.float()).all() for t in ins)


def test_capacity_gradients_on_the_card_run_the_kernels(cuda):
    """A loss through ``moe_impl="capacity"`` on the card: each layer's
    capacity FFN forward, bucket K1 (dgrad) and bucket K2 (wgrad) launch
    once, all on the TMA route, beside the routing stage and its backward;
    the ragged FFN never. Every gradient finite, every expert weight's
    too."""
    cfg = dataclasses.replace(t_get_smoke("granite-moe-3b-a800m"), n_layers=2)
    gen = torch.Generator(device=cuda).manual_seed(0)
    params = t_model.init_params(cfg, gen, device=cuda)
    for p in t_leaves(params):
        p.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab, (2, 16), generator=gen, device=cuda)
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1)
    ops.reset_launch_counts()
    loss, _ = t_model.loss_fn(cfg, rules)(
        params, {"tokens": tok, "labels": tok.roll(-1, 1)},
        t_model.make_moe_tables(cfg, rules, device=cuda))
    loss.backward()
    torch.cuda.synchronize()
    c = ops.launch_counts()
    L = cfg.n_layers
    for name in ("fused_moe_ffn", "moe_ffn_dgrad", "moe_ffn_wgrad"):
        assert c[name] == c[f"{name}.tma"] == L, (name, c)
    assert c["route_select"] == c["route_select_bwd"] == L
    assert c["ragged_moe_ffn"] == c["ragged_moe_ffn_dgrad"] == \
        c["ragged_moe_ffn_wgrad"] == 0
    assert bool(torch.isfinite(loss))
    for p in t_leaves(params):
        assert p.grad is not None and bool(torch.isfinite(p.grad).all())
    for blk in params["blocks"]:
        for k in ("w1", "w3", "w2"):
            assert blk["ffn"][k].grad.float().norm() > 0


def _bucket_dy(dev, toks, seed):
    """An upstream gradient for the buckets: zero on the empty rows (x = 0),
    as the combine leaves it."""
    g = torch.Generator(device=dev).manual_seed(seed)
    dy = torch.randn(toks.shape, generator=g, device=dev)
    return (dy * (toks != 0).any(-1, keepdim=True)).to(torch.bfloat16)


def _bucket_bwd(w1, w3, w2, toks, dy):
    """The forward kernel's h, then K1 and K2 over the buckets:
    ``(dx, da, db, dw1, dw3, dw2)``."""
    _, h = t_capacity.fused_moe_ffn(w1, w3, w2, toks, keep_h=True)
    dx, da, db = t_capacity.moe_ffn_dgrad(w1, w3, w2, toks, dy)
    return (dx, da, db, *t_capacity.moe_ffn_wgrad(toks, h, da, db, dy))


@pytest.mark.parametrize("E,C,empty", [
    (40, 4, 1),         # granite's 8-lane decode buckets
    (10, 36, 5),        # a bucket shorter than one 64-row block
    (10, 208, 16),      # a rank's a2a buckets at factor 8 (4 x 52): 128 + 80
    (40, 1024, 205),    # granite's training buckets at 16 x 256, factor 1.25
])
def test_capacity_ffn_backward_kernels_match_plain(cuda, E, C, empty):
    """The bucket K1 (dx, da, db) and K2 (dW1, dW3, dW2) at granite's
    widths against ``moe_ffn_bwd_ref``: relative L2 within ``BWD_TOL``,
    the empty rows of dx (x = 0, dy = 0) exactly zero, the TMA route with
    the row block ``bwd_rows(C)``."""
    w1, w3, w2, toks = _capacity_inputs(cuda, E, C, 1536, 512,
                                        empty_rows=empty)
    dy = _bucket_dy(cuda, toks, seed=C)
    ops.reset_launch_counts()
    dx, _, _, dw1, dw3, dw2 = _bucket_bwd(w1, w3, w2, toks, dy)
    want = ref.moe_ffn_bwd_ref(w1, w3, w2, toks, dy)
    torch.cuda.synchronize()
    c = ops.launch_counts()
    assert c["moe_ffn_dgrad"] == c["moe_ffn_dgrad.tma"] == 1
    assert c["moe_ffn_wgrad"] == c["moe_ffn_wgrad.tma"] == 1
    assert t_capacity.moe_ffn_dgrad.last_route == \
        f"tma rows={t_capacity.bwd_rows(C)}"
    for name, got, exp in zip(("dx", "dw1", "dw3", "dw2"),
                              (dx, dw1, dw3, dw2), want):
        assert got.dtype == torch.bfloat16 and got.shape == exp.shape
        err = _rel_l2(got, exp)
        assert err <= BWD_TOL, (name, err)
    assert not dx[:, C - empty:].any()


def test_capacity_ffn_backward_two_runs_bit_identical(cuda):
    """Forward and backward through ``ops`` twice at a rank's a2a buckets
    at factor 8 (4 x 256 tokens, ep 4: 10 slots of 4 x 412 rows): every
    gradient bitwise equal (no atomics, fixed sum order)."""
    w1, w3, w2, toks = _capacity_inputs(cuda, 10, 4 * 412, 1536, 512,
                                        empty_rows=40)
    dy = _bucket_dy(cuda, toks, seed=7)
    runs = []
    for _ in range(2):
        ins = [t.clone().requires_grad_(True) for t in (w1, w3, w2, toks)]
        ops.fused_moe_ffn(*ins).backward(dy)
        runs.append([t.grad for t in ins])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("C", [36, 208])
def test_capacity_ffn_backward_ignores_the_next_bucket_and_the_tail(cuda,
                                                                   C):
    """A bucket whose rows are not a multiple of 64: K2's last 64-row chunk
    of each bucket runs into the next bucket's rows, and of the last bucket
    past the tensor. With NaN in every row of bucket 1 (x, dy, h, da, db)
    and in the memory right after each tensor, the other buckets' dx, da,
    db and dW are finite and bitwise those of a clean run: the next
    bucket's rows are zeroed in shared memory before they are read, and
    TMA reads nothing past the tensor."""
    E, D, F, bad = 3, 1536, 512, 1
    w1, w3, w2, toks = _capacity_inputs(cuda, E, C, D, F, empty_rows=3)
    dy = _bucket_dy(cuda, toks, seed=11)
    clean = _bucket_bwd(w1, w3, w2, toks, dy)
    _, h = t_capacity.fused_moe_ffn(w1, w3, w2, toks, keep_h=True)

    def poisoned(t):
        """``t`` with bucket ``bad`` NaN, in a buffer holding NaN past its
        end."""
        buf = torch.full((t.numel() + 64 * t.shape[-1],), float("nan"),
                         dtype=t.dtype, device=t.device)
        out = buf[:t.numel()].view(t.shape)
        out.copy_(t)
        out[bad] = float("nan")
        return out

    x_p, dy_p = poisoned(toks), poisoned(dy)
    dx, da, db = t_capacity.moe_ffn_dgrad(w1, w3, w2, x_p, dy_p)
    dws = t_capacity.moe_ffn_wgrad(x_p, poisoned(h), poisoned(clean[1]),
                                   poisoned(clean[2]), dy_p)
    torch.cuda.synchronize()
    keep = [e for e in range(E) if e != bad]
    for got, want in zip((dx, da, db, *dws), clean):
        assert bool(torch.isfinite(got[keep].float()).all())
        assert torch.equal(got[keep], want[keep])


def test_capacity_ffn_backward_refuses_what_it_does_not_take(cuda):
    """The bucket backward has the TMA route only: a D or F that is not a
    multiple of 8 raises a ValueError naming the shapes, from the wrappers
    and through autograd (whose forward took the general route)."""
    w1, w3, w2, toks = _capacity_inputs(cuda, 2, 9, 100, 70, empty_rows=2)
    dy = _bucket_dy(cuda, toks, seed=1)
    with pytest.raises(ValueError, match="multiples of 8"):
        t_capacity.moe_ffn_dgrad(w1, w3, w2, toks, dy)
    h = torch.zeros((2, 9, 70), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="multiples of 8"):
        t_capacity.moe_ffn_wgrad(toks, h, h, h, dy)
    ins = [t.clone().requires_grad_(True) for t in (w1, w3, w2, toks)]
    y = ops.fused_moe_ffn(*ins)
    with pytest.raises(ValueError, match="multiples of 8"):
        y.backward(dy)


@pytest.mark.parametrize("T", [1, 8, 48, 512])
def test_kernels_at_jamba_smoke_shapes_match_plain(cuda, T):
    """jamba smoke's MoE layer (E 4, K 2, D 128, F 256), which the serve
    driver runs on the card: the routing stage (served and replica tables)
    and the ragged FFN on the TMA route against their plain versions."""
    E, K, D, F, bm = 4, 2, 128, 256, 128
    for R in (1, 3):
        (x, w, so, nc, cdf, seed), rv = _route_inputs(cuda, T, D, E, R,
                                                      False, seed=T + R)
        got = ops.route_select(x, w, so, nc, cdf, seed, K, rv)
        want = ref.route_select_ref(x, w, so, nc, cdf, seed, K, rv)
        torch.cuda.synchronize()
        _check_route(list(got), list(want), x, w, K, rv)
    sizes = _routed_sizes(T, E, K, seed=T)
    (w1, w3, w2, toks), tg, (ro, sz, tr) = _ragged_inputs(
        cuda, sizes, D, F, bm, with_rows=True)
    ops.reset_launch_counts()
    y = ops.ragged_moe_ffn(w1, w3, w2, toks, tg, row_offsets=ro, sizes=sz,
                           max_rows=T)
    y_ref = ref.ragged_moe_ffn_ref(w1, w3, w2, toks, tg)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ragged_moe_ffn"] == counts["ragged_moe_ffn.tma"] == 1
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    pos = torch.arange(toks.shape[0], device=cuda) % bm
    real = pos < tr.repeat_interleave(bm)
    assert bool((y[~real] == 0).all())


def _rel_l2_leaves(got, want):
    return max(_rel_l2(got[k].cpu(), want[k]) for k in want)


@pytest.mark.parametrize("S,chunk", [(24, 8), (13, 8), (1, 1)])
@pytest.mark.parametrize("mixer", ["mamba", "mlstm", "slstm"])
def test_recurrent_mixers_on_card_match_cpu(cuda, mixer, S, chunk):
    """Each mixer's sequence form (S 1 is the decode step) from a fresh
    state and from the state it left, f32, card against host."""
    gen = torch.Generator().manual_seed(0)
    d, heads = 64, 2
    if mixer == "mamba":
        p = t_ssm.mamba_init(gen, d, d_state=8, dtype=torch.float32)
    else:
        init = t_ssm.mlstm_init if mixer == "mlstm" else t_ssm.slstm_init
        p = init(gen, d, n_heads=heads, dtype=torch.float32)
    fn = getattr(t_ssm, f"{mixer}_seq")
    kw = {} if mixer == "slstm" else {"chunk": chunk}
    x = torch.randn((2, S, d), generator=gen)
    p_c = {k: v.to(cuda) for k, v in p.items()}
    y, st = fn(p, x, None, **kw)
    y_c, st_c = fn(p_c, x.to(cuda), None, **kw)
    assert _rel_l2(y_c.cpu(), y) <= 1e-5
    assert _rel_l2_leaves(st_c, st) <= 1e-5
    y, st = fn(p, x, st, **kw)
    y_c, st_c = fn(p_c, x.to(cuda), st_c, **kw)
    assert _rel_l2(y_c.cpu(), y) <= 1e-5
    assert _rel_l2_leaves(st_c, st) <= 1e-5


# ---------------------------------------------------------------------------
# the kernels at one rank's shapes of the expert-parallel bodies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e_loc,ep", [(10, 4), (5, 8), (2, 20)])
def test_ragged_ffn_on_a_receiver_buffer(cuda, e_loc, ep):
    """The a2a ragged body's receiver: ``ep`` frames of ``A = t_loc·8``
    rows (granite's 40 experts over ``ep`` ranks, 1024 tokens in all),
    each row a local slot or the padding id ``e_loc``, laid out by the
    body's own plan; the kernel against the plain version, padding rows
    and sentinel tiles exactly zero."""
    D, F, K, bm = 1536, 512, 8, 128
    A = 1024 // ep * K
    g = torch.Generator().manual_seed(e_loc)
    rloc = torch.randint(0, e_loc, (ep * A,), generator=g, dtype=torch.int32)
    rloc[torch.rand(ep * A, generator=g) < 1 - 1 / ep] = e_loc   # padding
    order, rows, tg, n_rows, ro, sz = tmoe._ragged_plan(
        rloc.to(cuda), e_loc, bm, active=rloc.to(cuda) < e_loc)
    buf = torch.zeros((n_rows + 1, D), device=cuda, dtype=torch.bfloat16)
    buf[rows.long()] = torch.randn((ep * A, D), generator=g).to(
        cuda, torch.bfloat16)[order]
    buf = buf[:n_rows]
    w = [(torch.randn(s, generator=g) / math.sqrt(s[1])).to(
        cuda, torch.bfloat16) for s in ((e_loc, D, F), (e_loc, D, F),
                                        (e_loc, F, D))]
    ops.reset_launch_counts()
    # a slot gets at most t_loc rows from each of the ep senders
    y = ops.ragged_moe_ffn(*w, buf, tg, row_offsets=ro, sizes=sz,
                           max_rows=1024)
    y_ref = ref.ragged_moe_ffn_ref(*w, buf, tg)
    torch.cuda.synchronize()
    assert ops.launch_counts()["ragged_moe_ffn.tma"] == 1
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    tr = t_ragged.ragged_tile_rows(ro, sz, tg, bm)
    real = (torch.arange(n_rows, device=cuda) % bm) < tr.repeat_interleave(bm)
    assert (~real).any() and bool((y[~real] == 0).all())


@pytest.mark.parametrize("e_loc,rows", [(10, 4 * 64), (10, 4 * 412),
                                        (5, 8 * 36)])
def test_capacity_ffn_at_rank_bucket_shapes(cuda, e_loc, rows):
    """The a2a capacity body's FFN input ``(e_loc, ep·C, D)``: ep 4 at
    capacity factor 1.25 (C 64) and 8 (C 412, dropless), ep 8 at 1.25
    (C 36), 256 or 128 tokens a rank, granite's widths."""
    w1, w3, w2, toks = _capacity_inputs(cuda, e_loc, rows, 1536, 512,
                                        empty_rows=3)
    ops.reset_launch_counts()
    y = ops.fused_moe_ffn(w1, w3, w2, toks)
    y_ref = ref.moe_ffn_ref(w1, w3, w2, toks)
    torch.cuda.synchronize()
    assert ops.launch_counts()["fused_moe_ffn.tma"] == 1
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=BF16_TOL,
                               atol=BF16_TOL)
    assert bool((y[:, rows - 3:] == 0).all())


@pytest.mark.parametrize("T", [8, 128, 256, 1024])
def test_route_select_at_rank_rows(cuda, T):
    """The routing stage at the rows one rank routes (a 1024-token batch
    over ep 4 and 8, the 8-lane decode every rank routes whole) and the
    single rank's 1024: the kernel against its plain version."""
    (x, w, so, nc, cdf, seed), _ = _route_inputs(cuda, T, 1536, 40, 1,
                                                 False, seed=T)
    got = ops.route_select(x, w, so, nc, cdf, seed, 8)
    want = ref.route_select_ref(x, w, so, nc, cdf, seed, 8)
    torch.cuda.synchronize()
    _check_route(list(got), list(want), x, w, 8, None)


# the attention kernels (csrc/flash_attention.cu) against their plain
# versions (repro_torch.models.flash), each output row (hd values) by its
# relative L2 error, the largest over rows: bf16 within ATTN_REL (both
# round p and the output to bf16, from running maxima over other tiles:
# ~3e-3 a row), f32 within ATTN_REL_F32 (three TF32 products a product
# on the tf32x3 route, summed in another order than the plain version's
# einsums). A zeroed row reads 1; a row
# that lost half its keys reads far above the bound.
ATTN_REL = 2e-2
ATTN_REL_F32 = 1e-4


def _row_rel(got, want):
    """The largest relative L2 error of a row (the last dimension)."""
    d = (got.float() - want.float()).flatten(0, -2).norm(dim=-1)
    return (d / want.float().flatten(0, -2).norm(dim=-1).clamp(min=1e-30)
            ).max().item()


def _attn_tol(dtype):
    return ATTN_REL if dtype == torch.bfloat16 else ATTN_REL_F32


ATTN_CASES = [
    # (B, Sq, Skv, KV, G, hd, dtype, causal, window, rows, n_valid)
    (2, 300, 300, 8, 3, 64, torch.bfloat16, True, 0, None, None),
    (1, 128, 1024, 8, 3, 64, torch.bfloat16, True, 0, (512, 640), 640),
    (2, 77, 301, 2, 4, 128, torch.bfloat16, True, 0, (224, 301), None),
    (1, 200, 200, 2, 2, 256, torch.bfloat16, True, 64, None, None),
    (2, 96, 96, 2, 8, 32, torch.bfloat16, True, 0, None, None),
    (2, 130, 130, 4, 1, 80, torch.float32, False, 0, None, 100),
    # qwen3's 16 query heads a KV head, codeqwen's 1, starcoder's 9
    (1, 200, 200, 2, 16, 128, torch.bfloat16, True, 0, None, None),
    (2, 100, 100, 4, 1, 128, torch.bfloat16, True, 0, None, None),
    (1, 150, 150, 2, 9, 128, torch.bfloat16, True, 0, None, None),
    # a chunk against a lane of 70000 rows (547 key tiles of 128 on the
    # Hopper route)
    (1, 128, 70000, 8, 3, 64, torch.bfloat16, True, 0, (68000, 68128),
     68128),
    # past 1024 key tiles, whose states the kernels take a window at a
    # time: 1094 tiles of 128 on the Hopper route
    (1, 128, 140000, 8, 3, 64, torch.bfloat16, True, 0, (138000, 138128),
     138128),
    (1, 128, 70000, 2, 3, 32, torch.bfloat16, True, 0, (68000, 68128),
     68128),
    (1, 128, 140000, 2, 2, 32, torch.bfloat16, True, 0, (138000, 138128),
     138128),
    # past 1024 key tiles of 64 on the hd 256 Hopper route and the tf32x3
    # route (1065 live tiles), the latter with keys cut by kv_valid
    (1, 128, 70000, 2, 2, 256, torch.bfloat16, True, 0, (68000, 68128),
     68128),
    (1, 128, 70000, 2, 2, 80, torch.float32, True, 0, (68000, 68128),
     67000),
    # hubert's head size in bf16, and f32 at hd 128 and 256 (the wide
    # tf32x3 kernel: 64- and 32-key tiles), past 1024 of those tiles too
    (2, 130, 130, 4, 1, 80, torch.bfloat16, False, 0, None, 100),
    (2, 77, 301, 2, 4, 128, torch.float32, True, 0, (224, 301), None),
    (1, 200, 200, 2, 2, 256, torch.float32, True, 64, None, None),
    (1, 128, 70000, 2, 2, 128, torch.float32, True, 0, (68000, 68128),
     67000),
    (1, 128, 40000, 2, 2, 256, torch.float32, True, 0, (38000, 38128),
     38128),
]


@pytest.mark.parametrize("case", ATTN_CASES,
                         ids=lambda c: f"hd{c[5]}-{str(c[6])[6:]}-{c[1]}")
def test_flash_attn_fwd_matches_plain(cuda, case):
    from repro_torch.models import flash as t_flash
    B, Sq, Skv, KV, G, hd, dtype, causal, window, rows, n_valid = case
    g = torch.Generator().manual_seed(hd)
    q = torch.randn((B, Sq, KV, G, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    qpos = torch.arange(*(rows or (Sq,)), device=cuda)
    kpos = torch.arange(Skv, device=cuda)
    kval = None if n_valid is None else kpos < n_valid
    kw = dict(causal=causal, window=window, q_positions=qpos,
              kv_positions=kpos, kv_valid=kval)
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    want = t_flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attn_fwd"] == 1
    assert _row_rel(got, want) <= _attn_tol(dtype)


@pytest.mark.parametrize("S_max,stats,window,G,hd", [
    (1024, False, 0, 3, 64), (3000, False, 0, 3, 64),
    (3000, True, 700, 3, 64), (512, True, 0, 3, 64),
    # more query heads than a block takes (8): two and three groups
    (1024, False, 0, 16, 128), (700, True, 0, 9, 128),
    (600, False, 0, 2, 256), (600, False, 0, 1, 80)])
def test_flash_decode_matches_plain(cuda, S_max, stats, window, G, hd):
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(S_max)
    B, KV = 8, 8 if hd < 128 else 2
    q = torch.randn((B, KV, G, hd), generator=g).to(cuda, torch.bfloat16)
    kc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda, torch.bfloat16)
    vc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda, torch.bfloat16)
    pos = torch.randint(0, S_max, (B,), generator=g).to(cuda)
    off = S_max // 2 if stats else 0          # a shard: some lanes empty
    kw = dict(window=window, kpos_offset=off, return_stats=stats)
    got = ops.flash_decode(q, kc, vc, pos, **kw)
    want = t_flash.flash_decode(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    if not stats:
        assert _row_rel(got, want) <= ATTN_REL
        return
    (acc, m, l), (acc_p, m_p, l_p) = got, want
    empty = l_p == 0                   # lanes with no row in this shard
    assert bool(empty.any()) and bool((~empty).any())
    assert bool((l[empty] == 0).all()) and bool((acc[empty] == 0).all())
    assert bool((m[empty] == m_p[empty]).all())
    torch.testing.assert_close(m[~empty], m_p[~empty], rtol=1e-5, atol=1e-5)
    for a, b in ((acc, acc_p), (l, l_p)):
        rel = ((a - b).norm() / b.norm()).item()
        assert rel <= 1e-2, rel          # p rounded to bf16 on both sides


def test_flash_kernels_refuse_unsupported_head_size(cuda):
    q = torch.zeros((1, 4, 1, 2, 48), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, 48), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="48"):
        ops.flash_attention(q, k, k)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_rows_without_a_valid_key(cuda, dtype):
    """Causal rows before the first valid key have none: the kernel's own
    pass gives them the plain version's sum(v) over the padded key count
    (1024 keys a chunk: 300 keys pad to 300), the other rows as usual."""
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(7)
    B, S, KV, G, hd = 2, 300, 2, 3, 64
    q = torch.randn((B, S, KV, G, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    pos = torch.arange(S, device=cuda)
    kw = dict(causal=True, q_positions=pos, kv_positions=pos,
              kv_valid=pos >= 100)
    got = ops.flash_attention(q, k, v, **kw)
    want = t_flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert _row_rel(got, want) <= _attn_tol(dtype)
    mean = v.float().sum(1) / t_flash.padded_keys(S)
    assert _row_rel(got[:, :100], mean[:, None, :, None].expand(
        B, 100, KV, G, hd)) <= _attn_tol(dtype)


def test_flash_decode_lane_without_a_valid_row(cuda):
    """Without ``return_stats`` a lane whose cache holds no valid row (its
    position before the cache's first row) takes the plain version's mean
    of v over every row."""
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(8)
    B, S_max, KV, G, hd = 4, 1100, 2, 3, 64
    q = torch.randn((B, KV, G, hd), generator=g).to(cuda, torch.bfloat16)
    kc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda, torch.bfloat16)
    vc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda, torch.bfloat16)
    pos = torch.tensor([5, 50, 600, 1500], device=cuda)
    kw = dict(kpos_offset=100)
    got = ops.flash_decode(q, kc, vc, pos, **kw)
    want = t_flash.flash_decode(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    assert _row_rel(got, want) <= ATTN_REL


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_stats_match_plain(cuda, dtype):
    """``return_stats``: the kernel's rows' (m, l) against the plain
    version's, rows with no valid key (m, l) = (_NEG, the padded key
    count) exactly."""
    from repro_torch.kernels import flash as k_flash
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(11)
    B, S, KV, G, hd = 2, 300, 2, 3, 64
    q = torch.randn((B, S, KV, G, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    pos = torch.arange(S, device=cuda)
    kw = dict(causal=True, window=0, q_positions=pos, kv_positions=pos,
              kv_valid=pos >= 100)
    out, m, l = k_flash.flash_attn_fwd(q, k, v, return_stats=True, **kw)
    out_p, m_p, l_p = t_flash.flash_attention(q, k, v, return_stats=True,
                                              **kw)
    torch.cuda.synchronize()
    assert _row_rel(out, out_p) <= _attn_tol(dtype)
    empty = torch.zeros_like(m, dtype=torch.bool)
    empty[..., :100] = True
    assert bool((m[empty] == t_flash._NEG).all())
    assert bool((l[empty] == t_flash.padded_keys(S)).all())
    assert bool((m_p[empty] == m[empty]).all())
    torch.testing.assert_close(m[~empty], m_p[~empty], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l[~empty], l_p[~empty], rtol=1e-4, atol=0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attention_gradient_through_the_kernel(cuda, dtype):
    """A call that requires a gradient launches the forward kernel once
    (``FlashAttention``) and its backward each of its two kernels once;
    the gradients against autograd of the plain version, relative L2 a
    tensor (bf16: both round p to bf16, the plain version's products in
    bf16)."""
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(12)
    B, S, KV, G, hd = 2, 700, 2, 3, 64
    base = [torch.randn(shape, generator=g).to(cuda, dtype)
            for shape in ((B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd))]
    w = torch.randn((B, S, KV, G, hd), generator=g).to(cuda)
    pos = torch.arange(S, device=cuda)
    kw = dict(causal=True, window=256, q_positions=pos, kv_positions=pos,
              kv_valid=pos >= 50)
    grads = []
    for fn in (ops.flash_attention, t_flash.flash_attention):
        ts = [t.clone().requires_grad_(True) for t in base]
        ops.reset_launch_counts()
        (fn(*ts, **kw).float() * w).sum().backward()
        torch.cuda.synchronize()
        want = 1 if fn is ops.flash_attention else 0
        counts = ops.launch_counts()
        for name in ("flash_attn_fwd", "flash_attn_bwd_dq",
                     "flash_attn_bwd_dkdv"):
            assert counts[name] == want, (name, counts[name])
        grads.append([t.grad.float() for t in ts])
    tol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for a, b in zip(*grads):
        assert ((a - b).norm() / b.norm()).item() <= tol


# the backward's kernels (csrc/flash_attention_bwd.cu) against the plain
# backward (models.flash.flash_attention_bwd) on the same forward outputs
# (the kernel's out, m, l): relative L2 of each gradient, bf16 within
# ATTN_REL (the kernels round P and dS to bf16 for their products, the
# plain version computes in f32), f32 within ATTN_REL_F32 (three TF32
# products a product, each tile's sum added in f32).
BWD_ATTN_CASES = [
    # (B, Sq, Skv, KV, G, hd, dtype, causal, window, rows, n_valid)
    (2, 300, 300, 2, 3, 64, torch.bfloat16, True, 0, None, None),
    (1, 128, 1024, 2, 3, 64, torch.bfloat16, True, 0, (512, 640), 640),
    (2, 77, 301, 2, 4, 128, torch.bfloat16, True, 0, (224, 301), None),
    (1, 200, 200, 2, 2, 256, torch.bfloat16, True, 64, None, None),
    (2, 96, 96, 2, 8, 32, torch.bfloat16, True, 0, None, None),
    (2, 130, 130, 4, 1, 80, torch.bfloat16, False, 0, None, 100),
    (1, 200, 200, 2, 16, 128, torch.bfloat16, True, 0, None, None),
    (2, 100, 100, 4, 1, 128, torch.bfloat16, True, 0, None, None),
    (1, 150, 150, 2, 9, 128, torch.bfloat16, True, 0, None, None),
    (2, 96, 96, 2, 8, 32, torch.float32, True, 0, None, None),
    (2, 300, 300, 2, 3, 64, torch.float32, True, 100, None, None),
    (2, 130, 130, 4, 1, 80, torch.float32, False, 0, None, 100),
    (2, 77, 301, 2, 4, 128, torch.float32, True, 0, (224, 301), None),
    (1, 200, 200, 2, 2, 256, torch.float32, True, 64, None, None),
    # many rows against few keys: 96 row blocks a key tile
    (1, 2048, 64, 2, 3, 64, torch.bfloat16, False, 0, None, None),
    (1, 1024, 48, 2, 2, 256, torch.float32, False, 0, None, None),
    # a chunk against a long lane: 1065 key tiles a row block in f32, the
    # sums of dK and dV over few rows, dQ's over many keys
    (1, 128, 70000, 2, 3, 80, torch.float32, True, 0, (68000, 68128),
     67000),
    (1, 128, 70000, 2, 3, 64, torch.bfloat16, True, 0, (68000, 68128),
     68128),
]


def _bwd_inputs(dev, case, seed):
    B, Sq, Skv, KV, G, hd, dtype, causal, window, rows, n_valid = case
    g = torch.Generator().manual_seed(seed)
    q, dout = (torch.randn((B, Sq, KV, G, hd), generator=g).to(dev, dtype)
               for _ in range(2))
    k, v = (torch.randn((B, Skv, KV, hd), generator=g).to(dev, dtype)
            for _ in range(2))
    kpos = torch.arange(Skv, device=dev)
    kw = dict(causal=causal, window=window,
              q_positions=torch.arange(*(rows or (Sq,)), device=dev),
              kv_positions=kpos,
              kv_valid=None if n_valid is None else kpos < n_valid)
    return q, k, v, dout, kw


def _bwd_both(q, k, v, dout, kw):
    """The kernels' gradients and the plain backward's, on the kernel
    forward's out, m and l."""
    from repro_torch.kernels import flash as k_flash
    from repro_torch.models import flash as t_flash
    out, m, l = k_flash.flash_attn_fwd(q, k, v, return_stats=True, **kw)
    got = k_flash.flash_attn_bwd(q, k, v, out, dout, m, l, **kw)
    want = t_flash.flash_attention_bwd(q, k, v, out, dout, m, l, **kw)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize(
    "case", BWD_ATTN_CASES,
    ids=lambda c: f"hd{c[5]}-{str(c[6])[6:]}-{c[1]}x{c[2]}-G{c[4]}")
def test_flash_attn_bwd_matches_plain(cuda, case):
    """Both kernels once a call, on the route ``route_of`` names, their
    dq, dk and dv against the plain backward's."""
    from repro_torch.kernels import flash as k_flash
    q, k, v, dout, kw = _bwd_inputs(cuda, case, case[5])
    ops.reset_launch_counts()
    got, want = _bwd_both(q, k, v, dout, kw)
    route = k_flash.route_of(q.dtype, q.shape[-1])
    counts = ops.launch_counts()
    for name in ("flash_attn_bwd_dq", "flash_attn_bwd_dkdv"):
        assert counts[name] == counts[f"{name}.{route}"] == 1
    for a, b, x in zip(got, want, (q, k, v)):
        assert a.shape == x.shape and a.dtype == x.dtype
        assert bool(torch.isfinite(a).all())
        assert _rel_l2(a.float(), b.float()) <= _attn_tol(q.dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd", [64, 256])
def test_flash_attn_bwd_rows_without_a_valid_key(cuda, dtype, hd):
    """Causal rows before the first valid key have none: dq 0 there, and
    every key's dv takes their dout / l (the plain backward's), with the
    other rows' gradients as usual."""
    case = (2, 300, 300, 2, 3, hd, dtype, True, 0, None, None)
    q, k, v, dout, kw = _bwd_inputs(cuda, case, 7)
    kw["kv_valid"] = kw["kv_positions"] >= 100
    got, want = _bwd_both(q, k, v, dout, kw)
    assert bool((got[0][:, :100] == 0).all())
    assert bool((want[0][:, :100] == 0).all())
    for a, b in zip(got, want):
        assert _rel_l2(a.float(), b.float()) <= _attn_tol(dtype)
    # dv of the keys no row may see is those rows' sum alone
    assert _rel_l2(got[2][:, :100].float(), want[2][:, :100].float()) \
        <= _attn_tol(dtype)
    assert float(want[2][:, :100].float().norm()) > 0


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_bwd_two_calls_bit_for_bit(cuda, hd, dtype):
    """No atomics: two calls on the same inputs give the same bits, at
    every (dtype, hd), through causal, window and kv_valid masks."""
    from repro_torch.kernels import flash as k_flash
    case = (2, 200, 330, 2, 3, hd, dtype, True, 96, (130, 330), 300)
    q, k, v, dout, kw = _bwd_inputs(cuda, case, hd)
    out, m, l = k_flash.flash_attn_fwd(q, k, v, return_stats=True, **kw)
    first = k_flash.flash_attn_bwd(q, k, v, out, dout, m, l, **kw)
    again = k_flash.flash_attn_bwd(q, k, v, out, dout, m, l, **kw)
    torch.cuda.synchronize()
    for a, b in zip(first, again):
        assert torch.equal(a, b)


def test_flash_attn_bwd_int32_positions_and_strided_views(cuda):
    """int32 positions, and q, k, v, out, dout as strided views (rows
    contiguous, other strides padded), against the same call on
    contiguous copies with int64 positions: bit for bit."""
    from repro_torch.kernels import flash as k_flash
    case = (2, 150, 250, 2, 3, 64, torch.bfloat16, True, 0, (100, 250),
            None)
    q, k, v, dout, kw = _bwd_inputs(cuda, case, 3)
    out, m, l = k_flash.flash_attn_fwd(q, k, v, return_stats=True, **kw)
    want = k_flash.flash_attn_bwd(q, k, v, out, dout, m, l, **kw)

    def padded(t):
        big = torch.zeros(t.shape[:-1] + (t.shape[-1] + 8,), device=cuda,
                          dtype=t.dtype)
        big[..., :t.shape[-1]] = t
        return big[..., :t.shape[-1]]

    kv = torch.stack([k, v], 2)           # (B, Skv, 2, KV, hd)
    kw32 = dict(kw, q_positions=kw["q_positions"].int(),
                kv_positions=kw["kv_positions"].int())
    got = k_flash.flash_attn_bwd(padded(q), kv[:, :, 0], kv[:, :, 1],
                                 padded(out), padded(dout), m, l, **kw32)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_flash_attn_bwd_refuses_unsupported_head_size(cuda):
    from repro_torch.kernels import flash as k_flash
    q = torch.zeros((1, 4, 1, 2, 48), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 4, 1, 48), device=cuda, dtype=torch.bfloat16)
    st = torch.zeros((1, 1, 2, 4), device=cuda)
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="48"):
        k_flash.flash_attn_bwd(q, k, k, q, q, st, st)
    assert ops.launch_counts()["flash_attn_bwd_dq"] == 0


def test_flash_decode_gradient_through_the_kernel(cuda):
    """A decode call that requires a gradient launches the kernel once
    (``FlashDecode``); its gradients, autograd of the plain version on the
    same inputs, match those of the plain call."""
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(13)
    B, S_max, KV, G, hd = 4, 1100, 2, 3, 64
    base = [torch.randn(shape, generator=g).to(cuda, torch.bfloat16)
            for shape in ((B, KV, G, hd), (B, S_max, KV, hd),
                          (B, S_max, KV, hd))]
    pos = torch.tensor([5, 300, 700, 1099], device=cuda)
    grads = []
    for fn in (ops.flash_decode, t_flash.flash_decode):
        ts = [t.clone().requires_grad_(True) for t in base]
        ops.reset_launch_counts()
        fn(*ts, pos, window=512).float().sum().backward()
        torch.cuda.synchronize()
        want = 1 if fn is ops.flash_decode else 0
        assert ops.launch_counts()["flash_decode"] == want
        grads.append([t.grad.float() for t in ts])
    for a, b in zip(*grads):
        assert ((a - b).norm() / b.norm()).item() <= 1e-6


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_fwd_each_head_size_on_its_route(cuda, hd, dtype):
    """Every head size the kernel takes, in bf16 and f32, on the route
    ``route_of`` names (the Hopper route for bf16, the tf32x3 route for
    f32, at every head size; each one's launches counted apart), against
    the plain version; a causal call whose query rows start mid-prompt and
    whose keys have a hole, over several key tiles."""
    from repro_torch.kernels import flash as k_flash
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(hd)
    B, Sq, Skv, KV, G = 2, 150, 400, 2, 3
    q = torch.randn((B, Sq, KV, G, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, Skv, KV, hd), generator=g).to(cuda, dtype)
    qpos = torch.arange(Skv - Sq, Skv, device=cuda)
    kpos = torch.arange(Skv, device=cuda)
    kw = dict(causal=True, window=0, q_positions=qpos, kv_positions=kpos,
              kv_valid=(kpos < 100) | (kpos >= 180))
    ops.reset_launch_counts()
    got = ops.flash_attention(q, k, v, **kw)
    want = t_flash.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    route = k_flash.route_of(dtype, hd)
    assert route == ("tma" if dtype == torch.bfloat16 else "tf32x3")
    assert ops.launch_counts()["flash_attn_fwd"] == 1
    assert k_flash.flash_attn_fwd.tma_launches == int(route == "tma")
    assert k_flash.flash_attn_fwd.tf32x3_launches == int(route == "tf32x3")
    assert _row_rel(got, want) <= _attn_tol(dtype)


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_lane_alone_matches_its_lane_in_a_batch(cuda, hd, dtype):
    """Lane i of a batch of 8 against lane i alone, bit for bit: a row's
    result depends on its own lane only (each lane a strided view of the
    batch's tensors, as a rank's cut), on every route."""
    g = torch.Generator().manual_seed(20 + hd)
    B, S, KV, G = 8, 300, 2, 3
    q = torch.randn((B, S, KV, G, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    pos = torch.arange(S, device=cuda)
    kw = dict(causal=True, q_positions=pos, kv_positions=pos)
    whole = ops.flash_attention(q, k, v, **kw)
    for i in (0, 3, 7):
        alone = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    **kw)
        assert torch.equal(alone[0], whole[i])


@pytest.mark.parametrize("hd", [64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_chunk_matches_the_whole_prompt(cuda, hd, dtype):
    """A 128-row chunk against the cache's lane (keys past the chunk not
    yet valid) gives the same rows, bit for bit, as the whole prompt's
    call: the key tiles start at row 0 with a fixed length, and skipped
    tiles are what computing them gives (on every kernel of both
    routes)."""
    g = torch.Generator().manual_seed(30 + hd)
    S, KV, G = 640, 2, 3
    q = torch.randn((1, S, KV, G, hd), generator=g).to(cuda, dtype)
    k = torch.randn((1, 1024, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((1, 1024, KV, hd), generator=g).to(cuda, dtype)
    pos = torch.arange(S, device=cuda)
    kpos = torch.arange(1024, device=cuda)
    whole = ops.flash_attention(q, k[:, :S], v[:, :S], causal=True,
                                q_positions=pos, kv_positions=pos)
    for r0 in (0, 256, 512):
        chunk = ops.flash_attention(
            q[:, r0:r0 + 128], k, v, causal=True,
            q_positions=pos[r0:r0 + 128], kv_positions=kpos,
            kv_valid=kpos < r0 + 128)
        assert torch.equal(chunk, whole[:, r0:r0 + 128])


@pytest.mark.parametrize("hd", [32, 64, 80, 128, 256])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_attn_fwd_two_calls_bit_for_bit(cuda, hd, dtype):
    """Two calls of the prefill kernel on the same inputs give the same
    bits, out and the rows' stats (no atomics, no order that depends on the
    schedule), at every head size of the Hopper and tf32x3 routes; a window
    and a hole in the keys, so that some tiles are skipped and some
    masked."""
    from repro_torch.kernels import flash as k_flash
    g = torch.Generator().manual_seed(40 + hd)
    B, S, KV, G = 2, 700, 2, 3
    q = torch.randn((B, S, KV, G, hd), generator=g).to(cuda, dtype)
    k = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    v = torch.randn((B, S, KV, hd), generator=g).to(cuda, dtype)
    pos = torch.arange(S, device=cuda)
    kw = dict(causal=True, window=300, q_positions=pos, kv_positions=pos,
              kv_valid=(pos < 200) | (pos >= 260), return_stats=True)
    ops.reset_launch_counts()
    first = k_flash.flash_attn_fwd(q, k, v, **kw)
    again = k_flash.flash_attn_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    route = k_flash.route_of(dtype, hd)
    assert route in ("tma", "tf32x3")
    assert getattr(k_flash.flash_attn_fwd, f"{route}_launches") == 2
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("S_max", [256, 1024, 32768])
def test_flash_decode_one_launch_bit_stable_tickets_back_to_zero(cuda,
                                                                 S_max):
    """One split (256 rows: the block writes the output) and many (4, 32):
    one launch a call, two calls bit for bit, the tickets zero after each;
    against the plain version, with and without stats."""
    from repro_torch.kernels import flash as k_flash
    from repro_torch.models import flash as t_flash
    g = torch.Generator().manual_seed(S_max)
    B, KV, G, hd = 8, 8, 3, 64
    q = torch.randn((B, KV, G, hd), generator=g).to(cuda, torch.bfloat16)
    kc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda,
                                                          torch.bfloat16)
    vc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda,
                                                          torch.bfloat16)
    pos = torch.randint(0, S_max, (B,), generator=g).to(cuda)
    assert k_flash.decode_splits(S_max) == {256: 1, 1024: 4, 32768: 32}[S_max]
    for stats in (False, True):
        ops.reset_launch_counts()
        runs = []
        for _ in range(2):
            out = ops.flash_decode(q, kc, vc, pos, return_stats=stats)
            torch.cuda.synchronize()
            assert int(k_flash._TICKETS[torch.cuda.current_device()]
                       .abs().sum()) == 0
            runs.append(out if stats else (out,))
        assert ops.launch_counts()["flash_decode"] == 2
        assert all(torch.equal(a, b) for a, b in zip(*runs))
        want = t_flash.flash_decode(q, kc, vc, pos, return_stats=stats)
        if stats:
            (acc, m, l), (acc_p, m_p, l_p) = runs[0], want
            assert _row_rel(acc, acc_p) <= ATTN_REL
            torch.testing.assert_close(m, m_p, rtol=1e-5, atol=1e-5)
            assert ((l - l_p).abs() / l_p).max().item() <= ATTN_REL
        else:
            assert _row_rel(runs[0][0], want) <= ATTN_REL


@pytest.mark.parametrize("G", [1, 2, 3, 4, 8, 9])
def test_flash_decode_lane_alone_matches_its_lane_in_a_batch(cuda, G):
    """Lane i alone against lane i of a batch of 8, bit for bit, at each
    head group size (1, 2, 4, 8 query heads a block; 9: two groups)."""
    g = torch.Generator().manual_seed(40 + G)
    B, S_max, KV, hd = 8, 1500, 2, 128
    q = torch.randn((B, KV, G, hd), generator=g).to(cuda, torch.bfloat16)
    kc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda,
                                                          torch.bfloat16)
    vc = torch.randn((B, S_max, KV, hd), generator=g).to(cuda,
                                                          torch.bfloat16)
    pos = torch.tensor([5, 300, 700, 1099, 1499, 256, 511, 1024],
                       device=cuda)
    whole = ops.flash_decode(q, kc, vc, pos, window=600)
    for i in range(B):
        alone = ops.flash_decode(q[i:i + 1], kc[i:i + 1], vc[i:i + 1],
                                 pos[i:i + 1], window=600)
        assert torch.equal(alone[0], whole[i])
