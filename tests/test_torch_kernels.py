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
from repro.kernels.ragged_moe_ffn import (  # noqa: E402
    ragged_moe_ffn_pallas, ragged_tile_metadata as j_tile_metadata)
from repro.kernels.router import router_topk_pallas  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels import ragged_moe_ffn as t_ragged  # noqa: E402
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

@pytest.mark.parametrize("sizes,bm", [
    ([0, 5, 0, 17, 3], 4),          # empty groups in the middle
    ([0, 0, 0], 8),                 # nothing routed: all sentinel
    ([8, 8, 16, 1], 8),             # exact multiples and a remainder
    ([33, 0, 2, 0, 0, 7, 1], 16),   # skewed, empty tail groups
])
def test_ragged_tile_metadata_matches_jax(sizes, bm):
    sizes = np.asarray(sizes, np.int32)
    n_tiles = t_ragged.ragged_n_tiles(int(sizes.sum()), len(sizes), bm) + 2
    ro_j, tg_j = j_tile_metadata(jnp.asarray(sizes), bm, n_tiles)
    ro_t, tg_t = t_ragged.ragged_tile_metadata(torch.from_numpy(sizes), bm,
                                               n_tiles)
    assert ro_t.dtype == torch.int32 and tg_t.dtype == torch.int32
    # exactly equal, sentinel tiles (id G) included
    np.testing.assert_array_equal(_np(ro_t), np.asarray(ro_j))
    np.testing.assert_array_equal(_np(tg_t), np.asarray(tg_j))
    assert (_np(tg_t)[-2:] == len(sizes)).all()


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
    assert ops.launch_counts() == {"ragged_moe_ffn": 0, "router_topk": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: no silent plain-version path."""
    (_, _, _, _), tx, tg = _ragged_inputs(4, [4, 2], 32, 64, 8, jnp.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        t_ragged.ragged_moe_ffn(*tx, torch.from_numpy(tg))
    with pytest.raises(ValueError, match="CUDA"):
        t_router.router_topk(torch.zeros((4, 8)), 2)
    assert ops.launch_counts() == {"ragged_moe_ffn": 0, "router_topk": 0}


def test_ffn_tiles_fit_hopper_static_shared_memory():
    rb, bn, bk = ops.FFN_TILES
    smem = rb * (bk + 8) * 2 + 2 * bk * (bn + 8) * 2 + rb * (bn + 4) * 4
    assert smem <= 48 * 1024
    assert rb == t_ragged.ROW_BLOCK and rb % 16 == 0 and bn % 16 == 0


def test_resolve_device_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            resolve_device(None)
    assert resolve_device("cpu").type == "cpu"
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
