"""The port's kernel layer against the JAX package on identical inputs.

Inputs are made with numpy from a seed and handed to both sides. The
Pallas kernels run in interpret mode, as tests/test_kernels.py runs them.
Tolerances are those of tests/test_kernels.py: 1e-4 in f32, 5e-2 in bf16
(bf16 keeps 8 mantissa bits; the two sides round the f32 accumulators of
the three products at different points).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_ffn import fused_moe_ffn_pallas  # noqa: E402
from repro.kernels.ragged_moe_ffn import (  # noqa: E402
    ragged_moe_ffn_pallas, ragged_tile_metadata as j_tile_metadata)
from repro.kernels.router import router_topk_pallas  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import flash as t_flash  # noqa: E402
from repro_torch.kernels import moe_ffn as t_capacity  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ragged_moe_ffn as t_ragged  # noqa: E402
from repro_torch.kernels import route_select as t_route  # noqa: E402
from repro_torch.kernels import router as t_router  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 5e-2


def _np(t):
    return t.detach().float().cpu().numpy() if t.dtype == torch.bfloat16 \
        else t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# router
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("T,E,K,ties", [
    (64, 16, 4, False), (100, 8, 2, False), (300, 128, 8, False),
    (7, 4, 1, False), (513, 40, 8, False), (64, 16, 4, True),
    (513, 40, 8, True)])
def test_router_topk_ref_matches_pallas_and_lax(T, E, K, ties):
    rng = np.random.default_rng(T + E)
    if ties:   # few distinct values: the first-index tie rule decides
        logits = rng.integers(0, 3, size=(T, E)).astype(np.float32)
    else:
        logits = rng.standard_normal((T, E)).astype(np.float32)
    w_p, i_p = router_topk_pallas(jnp.asarray(logits), K, bt=64,
                                  interpret=True)
    w_l, i_l = jref.router_topk_ref(jnp.asarray(logits), K)
    w_t, i_t = ref.router_topk_ref(torch.from_numpy(logits), K)
    assert i_t.dtype == torch.int32
    # indices: exactly equal to both the Pallas kernel and lax.top_k
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_p))
    np.testing.assert_array_equal(_np(i_t), np.asarray(i_l))
    # weights: within 1e-5 (softmax sums in another order)
    np.testing.assert_allclose(_np(w_t), np.asarray(w_p), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(_np(w_t), np.asarray(w_l), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# ragged layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("part", ["layout", "tile_rows"])
@pytest.mark.parametrize("sizes,bm", [
    ([0, 5, 0, 17, 3], 4),          # empty groups in the middle
    ([0, 0, 0], 8),                 # nothing routed: all sentinel
    ([8, 8, 16, 1], 8),             # exact multiples and a remainder
    ([33, 0, 2, 0, 0, 7, 1], 16),   # skewed, empty tail groups
])
def test_ragged_tile_metadata_matches_jax(sizes, bm, part):
    sizes = np.asarray(sizes, np.int32)
    G = len(sizes)
    n_tiles = t_ragged.ragged_n_tiles(int(sizes.sum()), G, bm) + 2
    ro_j, tg_j = map(np.asarray, j_tile_metadata(jnp.asarray(sizes), bm,
                                                 n_tiles))
    ro_t, tg_t = t_ragged.ragged_tile_metadata(torch.from_numpy(sizes), bm,
                                               n_tiles)
    assert ro_t.dtype == tg_t.dtype == torch.int32
    if part == "layout":
        # exactly equal, sentinel tiles (id G) included
        np.testing.assert_array_equal(_np(ro_t), ro_j)
        np.testing.assert_array_equal(_np(tg_t), tg_j)
        assert (_np(tg_t)[-2:] == G).all()
    else:
        # the real rows of each tile, as the TMA route's CTAs work them out
        # from row_offsets and sizes, against those worked out from the JAX
        # layout: tile i of group g holds rows [i bm, (i + 1) bm) of the
        # buffer, of which those below the end of g's sizes[g] rows are real
        tr_t = t_ragged.ragged_tile_rows(ro_t, torch.from_numpy(sizes), tg_t,
                                         bm)
        assert tr_t.dtype == torch.int32
        want = np.zeros(n_tiles, np.int32)
        for i, g in enumerate(tg_j):
            if g < G:
                end = ro_j[g] + sizes[g]
                want[i] = np.clip(end - i * bm, 0, bm)
        np.testing.assert_array_equal(_np(tr_t), want)
        assert want.sum() == sizes.sum()


def _ragged_inputs(seed, sizes, D, F, bm, dtype):
    """A group-sorted buffer (padding rows zero), its tile map and weights."""
    rng = np.random.default_rng(seed)
    sizes = np.asarray(sizes, np.int32)
    E = len(sizes)
    n_tiles = t_ragged.ragged_n_tiles(int(sizes.sum()), E, bm)
    ro, tg = j_tile_metadata(jnp.asarray(sizes), bm, n_tiles)
    ro = np.asarray(ro)
    toks = np.zeros((n_tiles * bm, D), np.float32)
    for e in range(E):
        toks[ro[e]:ro[e] + sizes[e]] = rng.standard_normal((sizes[e], D))
    w1 = rng.standard_normal((E, D, F)) / np.sqrt(D)
    w3 = rng.standard_normal((E, D, F)) / np.sqrt(D)
    w2 = rng.standard_normal((E, F, D)) / np.sqrt(F)
    arrs = [a.astype(np.float32) for a in (w1, w3, w2, toks)]
    jx = [jnp.asarray(a, dtype) for a in arrs]
    tx = [tensor_from_numpy(np.asarray(a)) for a in jx]
    return jx, tx, np.array(tg)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("sizes,D,F,bm", [
    ([5, 0, 19, 3], 64, 160, 8),     # F not a multiple of the 128 block
    ([0, 12, 1], 32, 128, 16),       # leading empty expert
    ([40, 2, 0, 0, 9], 96, 64, 8),   # skewed, two empty experts
])
def test_ragged_moe_ffn_ref_matches_pallas(dtype, sizes, D, F, bm):
    (w1, w3, w2, toks), tx, tg = _ragged_inputs(len(sizes) + D, sizes, D, F,
                                                bm, dtype)
    y_p = np.asarray(ragged_moe_ffn_pallas(w1, w3, w2, toks, jnp.asarray(tg),
                                           bf=128, interpret=True),
                     np.float32)
    y_t = ref.ragged_moe_ffn_ref(*tx, torch.from_numpy(tg))
    assert y_t.dtype == tx[3].dtype and y_t.shape == tx[3].shape
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(_np(y_t), y_p, rtol=tol, atol=tol)
    # sentinel tiles: exactly zero
    sentinel = np.repeat(tg >= len(sizes), bm)
    assert sentinel.any()
    assert (_np(y_t)[sentinel] == 0.0).all()


def test_moe_ffn_ref_matches_jax_f32():
    rng = np.random.default_rng(9)
    E, C, D, F = 3, 10, 32, 48
    arrs = [rng.standard_normal(s).astype(np.float32) / np.sqrt(s[1])
            for s in ((E, D, F), (E, D, F), (E, F, D))]
    toks = rng.standard_normal((E, C, D)).astype(np.float32)
    y_j = jref.moe_ffn_ref(*map(jnp.asarray, arrs), jnp.asarray(toks))
    y_t = ref.moe_ffn_ref(*map(torch.from_numpy, arrs), torch.from_numpy(toks))
    np.testing.assert_allclose(_np(y_t), np.asarray(y_j), rtol=F32_TOL,
                               atol=F32_TOL)


def _capacity_inputs(seed, E, C, D, F, dtype, empty_rows=0):
    """Buckets (E, C, D) whose last ``empty_rows`` rows are zero, as the
    dispatch leaves unused capacity rows, and the experts' weights."""
    rng = np.random.default_rng(seed)
    toks = rng.standard_normal((E, C, D))
    toks[:, C - empty_rows:] = 0.0
    arrs = [rng.standard_normal(s) / np.sqrt(s[1])
            for s in ((E, D, F), (E, D, F), (E, F, D))] + [toks]
    jx = [jnp.asarray(a.astype(np.float32), dtype) for a in arrs]
    tx = [tensor_from_numpy(np.asarray(a)) for a in jx]
    return jx, tx


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("E,C,D,F,bm,bf", [
    (3, 13, 64, 160, 8, 128),    # C off the row block, F off the 128 block
    (4, 20, 32, 136, 16, 128),   # both padded by the reference wrapper
    (2, 8, 48, 256, 8, 128),     # aligned
])
def test_moe_ffn_ref_matches_capacity_pallas(dtype, E, C, D, F, bm, bf):
    """``ref.moe_ffn_ref`` — the capacity kernel's plain version — against
    ``fused_moe_ffn_pallas`` in interpret mode; unused (zero) bucket rows
    come out exactly zero."""
    (w1, w3, w2, toks), tx = _capacity_inputs(C + F, E, C, D, F, dtype,
                                              empty_rows=3)
    y_p = np.asarray(fused_moe_ffn_pallas(w1, w3, w2, toks, bm=bm, bf=bf,
                                          interpret=True), np.float32)
    y_t = ref.moe_ffn_ref(*tx)
    assert y_t.dtype == tx[3].dtype and y_t.shape == tx[3].shape
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    np.testing.assert_allclose(_np(y_t), y_p, rtol=tol, atol=tol)
    assert (_np(y_t)[:, -3:] == 0.0).all()


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain versions, and only kernels count
# ---------------------------------------------------------------------------

def test_ops_on_cpu_use_plain_versions_and_count_nothing():
    ops.reset_launch_counts()
    (_, _, _, _), tx, tg = _ragged_inputs(3, [4, 0, 9], 32, 64, 8,
                                          jnp.bfloat16)
    tg = torch.from_numpy(tg)
    y = ops.ragged_moe_ffn(*tx, tg)
    torch.testing.assert_close(y, ref.ragged_moe_ffn_ref(*tx, tg), rtol=0,
                               atol=0)
    logits = torch.from_numpy(
        np.random.default_rng(0).standard_normal((20, 8)).astype(np.float32))
    w, i = ops.router_topk(logits, 2)
    w_r, i_r = ref.router_topk_ref(logits, 2)
    assert torch.equal(i, i_r) and torch.equal(w, w_r)
    _, cx = _capacity_inputs(5, 3, 5, 32, 40, jnp.bfloat16)
    torch.testing.assert_close(ops.fused_moe_ffn(*cx), ref.moe_ffn_ref(*cx),
                               rtol=0, atol=0)
    assert ops.launch_counts() == dict.fromkeys(_COUNTERS, 0)


_COUNTERS = ("fused_moe_ffn", "fused_moe_ffn.tma", "moe_ffn_dgrad",
             "moe_ffn_dgrad.tma", "moe_ffn_wgrad", "moe_ffn_wgrad.tma",
             "ragged_moe_ffn",
             "ragged_moe_ffn.tma", "router_topk", "route_select",
             "ragged_moe_ffn_dgrad", "ragged_moe_ffn_dgrad.tma",
             "ragged_moe_ffn_wgrad", "ragged_moe_ffn_wgrad.tma",
             "route_select_bwd", "flash_attn_fwd", "flash_attn_fwd.tma",
             "flash_attn_fwd.tf32x3", "flash_decode", "flash_attn_bwd_dq",
             "flash_attn_bwd_dq.tma", "flash_attn_bwd_dq.tf32x3",
             "flash_attn_bwd_dkdv", "flash_attn_bwd_dkdv.tma",
             "flash_attn_bwd_dkdv.tf32x3")


@pytest.mark.parametrize("max_rows", [None, 1, 8, 16, 500])
def test_ops_ragged_hints_do_not_change_the_cpu_result(max_rows):
    """``row_offsets``/``sizes`` (each tile's real rows) and ``max_rows``
    are hints for the kernel; the result is the same with and without
    them, whatever the hint says (1 is below the real rows of every
    occupied tile here)."""
    ops.reset_launch_counts()
    sizes = torch.tensor([4, 0, 9, 13], dtype=torch.int32)
    (_, _, _, _), tx, tg = _ragged_inputs(7, sizes.tolist(), 32, 64, 8,
                                          jnp.bfloat16)
    ro_t, tg_t = t_ragged.ragged_tile_metadata(sizes, 8, tg.shape[0])
    assert np.array_equal(_np(tg_t), tg)
    y = ops.ragged_moe_ffn(*tx, tg_t)
    y_h = ops.ragged_moe_ffn(*tx, tg_t, row_offsets=ro_t, sizes=sizes,
                             max_rows=max_rows)
    torch.testing.assert_close(y_h, y, rtol=0, atol=0)
    assert ops.launch_counts() == dict.fromkeys(_COUNTERS, 0)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: no silent plain-version path."""
    (_, _, _, _), tx, tg = _ragged_inputs(4, [4, 2], 32, 64, 8, jnp.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        t_ragged.ragged_moe_ffn(*tx, torch.from_numpy(tg))
    with pytest.raises(ValueError, match="CUDA"):
        t_router.router_topk(torch.zeros((4, 8)), 2)
    _, cx = _capacity_inputs(6, 2, 4, 32, 64, jnp.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        t_capacity.fused_moe_ffn(*cx)
    # the backward kernels' wrappers too
    w1, w3, w2, toks = tx
    tg_t = torch.from_numpy(tg)
    sz = (torch.bincount(tg_t.long(), minlength=w1.shape[0] + 1)
          [:w1.shape[0]] * (toks.shape[0] // tg_t.shape[0])).to(torch.int32)
    ro = torch.cat([sz.new_zeros((1,)), torch.cumsum(sz, 0,
                                                     dtype=torch.int32)])
    with pytest.raises(ValueError, match="CUDA"):
        t_ragged.ragged_moe_ffn_dgrad(w1, w3, w2, toks, tg_t, ro, sz, toks)
    h = torch.zeros((toks.shape[0], w1.shape[2]), dtype=toks.dtype)
    with pytest.raises(ValueError, match="CUDA"):
        t_ragged.ragged_moe_ffn_wgrad(toks, h, h, h, toks, ro, sz)
    with pytest.raises(ValueError, match="CUDA"):
        t_route.route_select_bwd(torch.zeros((4, 8)), None, None, None, None,
                                 None, None)
    # and the capacity FFN's (the bucket K1 and K2)
    cw1, cw3, cw2, ctoks = cx
    ch = torch.zeros(ctoks.shape[:2] + (cw1.shape[2],), dtype=ctoks.dtype)
    with pytest.raises(ValueError, match="CUDA"):
        t_capacity.moe_ffn_dgrad(cw1, cw3, cw2, ctoks, ctoks)
    with pytest.raises(ValueError, match="CUDA"):
        t_capacity.moe_ffn_wgrad(ctoks, ch, ch, ch, ctoks)
    # and the attention's backward (its two kernels)
    aq = torch.zeros((1, 4, 1, 2, 64), dtype=torch.bfloat16)
    ak = torch.zeros((1, 4, 1, 64), dtype=torch.bfloat16)
    stats = torch.zeros((1, 1, 2, 4))
    with pytest.raises(ValueError, match="CUDA"):
        t_flash.flash_attn_bwd(aq, ak, ak, aq, aq, stats, stats)
    assert ops.launch_counts() == dict.fromkeys(_COUNTERS, 0)


def test_ffn_tiles_fit_hopper_static_shared_memory():
    """The general route's static tiles fit the 48 KB a block may take
    statically; the TMA route's row blocks are those the wrappers pick.
    (The TMA route's dynamic shared memory is planned in
    ``csrc/moe_ffn_hopper.cuh`` alone, which asserts at compile time that
    each variant fits a block's 232,448 B and two fit an SM.)"""
    rb, bn, bk = ops.FFN_TILES
    smem = rb * (bk + 8) * 2 + 2 * bk * (bn + 8) * 2 + rb * (bn + 4) * 4
    assert smem <= 48 * 1024
    assert rb == t_ragged.ROW_BLOCK and rb % 16 == 0 and bn % 16 == 0
    assert [t_ragged.tma_rows(m, 128) for m in (None, 1, 8, 9, 16, 17)] == \
        [128, 8, 8, 16, 16, 128]
    assert t_ragged.tma_rows(None, 64) == 64
    assert [t_capacity.tma_rows(c) for c in (4, 8, 9, 16, 40, 64, 128)] == \
        [8, 8, 16, 16, 64, 64, 128]


def _bwd_operands(E=3, D=64, F=64, T=256):
    bf = torch.bfloat16
    w1, w3 = torch.zeros((E, D, F), dtype=bf), torch.zeros((E, D, F), dtype=bf)
    w2 = torch.zeros((E, F, D), dtype=bf)
    toks, dy = torch.zeros((T, D), dtype=bf), torch.zeros((T, D), dtype=bf)
    h = torch.zeros((T, F), dtype=bf)
    return w1, w3, w2, toks, dy, h


@pytest.mark.parametrize("D,F,route,want", [
    (64, 64, None, True), (1536, 512, None, True), (200, 136, None, True),
    (200, 100, None, False), (100, 64, None, False),
    (1536, 512, "general", False)])
def test_backward_route_choice_without_a_card(D, F, route, want):
    """K1 and K2 take the TMA route exactly where every operand's rows are
    a multiple of 16 bytes (D and F multiples of 8) and nothing forces the
    general route; the choice needs shapes and pointers only."""
    w1, w3, w2, toks, dy, h = _bwd_operands(D=D, F=F)
    T, D1, F1, E, bm, tma, rows = t_ragged.dgrad_plan(w1, w3, w2, toks, dy,
                                                      2, route)
    assert (T, D1, F1, E, bm, tma) == (256, D, F, 3, 128, want)
    assert rows == (128 if want else t_ragged.ROW_BLOCK)
    assert t_ragged.wgrad_plan(toks, h, h, h, dy, route) == \
        (256, D, F, want)


def test_backward_route_needs_aligned_operands():
    """An operand whose base is not 16-byte aligned (contiguous, 8 bytes
    into its storage) has no TMA descriptor: the general route."""
    w1, w3, w2, toks, dy, h = _bwd_operands()

    def shifted(t):
        flat = torch.zeros(t.numel() + 4, dtype=t.dtype)
        return flat[4:].view(t.shape)

    assert t_ragged.dgrad_plan(w1, w3, w2, toks, dy, 2)[5]
    assert not t_ragged.dgrad_plan(w1, w3, w2, toks, shifted(dy), 2)[5]
    assert not t_ragged.dgrad_plan(shifted(w1), w3, w2, toks, dy, 2)[5]
    assert t_ragged.wgrad_plan(toks, h, h, h, dy)[3]
    assert not t_ragged.wgrad_plan(toks, h, shifted(h), h, dy)[3]


def test_backward_row_block_and_tile_choices():
    """K1's TMA row block follows the row tile bm (128 where it divides
    bm, else 64); K2's tile is fixed, so its plan names none; an unknown
    route is refused."""
    assert [t_ragged.bwd_rows(bm) for bm in (64, 128, 192, 256)] == \
        [64, 128, 64, 128]
    w1, w3, w2, toks, dy, h = _bwd_operands()
    assert [t_ragged.dgrad_plan(w1, w3, w2, toks, dy, n)[4:]
            for n in (1, 2, 4)] == [(256, True, 128), (128, True, 128),
                                    (64, True, 64)]
    assert t_ragged.dgrad_plan(w1, w3, w2, toks, dy, 4, "general")[4:] == \
        (64, False, t_ragged.ROW_BLOCK)
    with pytest.raises(ValueError, match="route"):
        t_ragged.dgrad_plan(w1, w3, w2, toks, dy, 2, route="fast")
    with pytest.raises(ValueError, match="route"):
        t_ragged.wgrad_plan(toks, h, h, h, dy, route="fast")


def test_backward_shape_checks_without_a_card():
    """What K1 and K2 refuse, checked before any launch."""
    w1, w3, w2, toks, dy, h = _bwd_operands()
    with pytest.raises(ValueError, match="shapes"):
        t_ragged.dgrad_plan(w1, w3, w2.transpose(1, 2)[:, :32], toks, dy, 2)
    with pytest.raises(ValueError, match="shapes"):
        t_ragged.dgrad_plan(w1, w3, w2, toks, dy[:128], 2)
    with pytest.raises(ValueError, match="row tile"):
        t_ragged.dgrad_plan(w1, w3, w2, toks, dy, 8)   # bm 32
    with pytest.raises(ValueError, match="row tile"):
        t_ragged.dgrad_plan(w1, w3, w2, toks, dy, 3)
    with pytest.raises(ValueError, match=r"\(T, F\)"):
        t_ragged.wgrad_plan(toks, h[:128], h, h, dy)
    with pytest.raises(ValueError, match=r"\(T, F\)"):
        t_ragged.wgrad_plan(toks, h, h, h, dy[:, :32])


def test_launch_counts_report_and_reset_the_backward_tma_counters():
    ops.reset_launch_counts()
    t_ragged.ragged_moe_ffn_dgrad.launches = 3
    t_ragged.ragged_moe_ffn_dgrad.tma_launches = 2
    t_ragged.ragged_moe_ffn_wgrad.launches = 5
    t_ragged.ragged_moe_ffn_wgrad.tma_launches = 4
    t_capacity.moe_ffn_dgrad.launches = 7
    t_capacity.moe_ffn_dgrad.tma_launches = 6
    t_capacity.moe_ffn_wgrad.launches = 9
    t_capacity.moe_ffn_wgrad.tma_launches = 8
    c = ops.launch_counts()
    assert (c["ragged_moe_ffn_dgrad"], c["ragged_moe_ffn_dgrad.tma"],
            c["ragged_moe_ffn_wgrad"], c["ragged_moe_ffn_wgrad.tma"]) == \
        (3, 2, 5, 4)
    assert (c["moe_ffn_dgrad"], c["moe_ffn_dgrad.tma"], c["moe_ffn_wgrad"],
            c["moe_ffn_wgrad.tma"]) == (7, 6, 9, 8)
    ops.reset_launch_counts()
    assert ops.launch_counts() == dict.fromkeys(_COUNTERS, 0)


def test_resolve_device_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
