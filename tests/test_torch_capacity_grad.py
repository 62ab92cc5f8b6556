"""The port's gradient through the capacity path against the JAX package.

The capacity FFN's backward (``kernels.ref.moe_ffn_bwd_ref``, the plain
version of the bucket kernels in ``csrc/moe_ffn_bwd.cu``) and its autograd
Function (``kernels.ops.FusedMoeFFN``) against ``jax.vjp`` of the
reference's ``expert_ffn_ref`` (the FFN its capacity bodies train through:
``use_kernel`` False); the capacity bodies' gradients (a2a at train,
replicated at decode) against ``jax.grad`` through the reference's
``shard_map`` bodies on a one-device mesh; and a traced capacity step on
``meta``. Inputs come from numpy with fixed seeds.

Tolerances: relative L2 of each gradient, 1e-4 in f32 (the same
function, sums in another order) and 5e-2 for the FFN in bf16 (both round
h, the reference also its einsums' outputs, where the port keeps f32 and
rounds da and db as its kernels do); ``GRAD_TOL`` 2e-2 for the bodies in
bf16, as tests/test_torch_ep.py holds the bodies' gradients, and the loss
within ``LOSS_TOL_BF16`` 5e-3 (mean(y²) of bf16 outputs that the reference
rounds after each einsum; 1.8e-3 read at most).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.bridge import tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.launch.cost_analysis import count_costs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402
from test_torch_moe import MESH, _layer_inputs  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 5e-2
GRAD_TOL = 2e-2
LOSS_TOL_BF16 = 5e-3


def _np(t):
    return t.detach().float().numpy()


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _ffn_inputs(E, C, D, F, dtype, empty, seed=0):
    """Weights, buckets and an upstream gradient as numpy in ``dtype``'s
    values (rounded through jnp): the last ``empty`` rows of each bucket
    hold no assignment, x = 0 and dy = 0 there, as the combine leaves
    them."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((E, D, F)) / np.sqrt(D),
            rng.standard_normal((E, D, F)) / np.sqrt(D),
            rng.standard_normal((E, F, D)) / np.sqrt(F),
            rng.standard_normal((E, C, D)),
            rng.standard_normal((E, C, D))]
    for a in arrs[3:]:
        a[:, C - empty:] = 0.0
    return [np.asarray(jnp.asarray(a, dtype)) for a in arrs]


def _jax_vjp(w1, w3, w2, toks, dy):
    """``(dtoks, dw1, dw3, dw2)`` of the reference's jnp FFN."""
    _, vjp = jax.vjp(jmoe.expert_ffn_ref, *map(jnp.asarray,
                                               (w1, w3, w2, toks)))
    dw1, dw3, dw2, dtoks = vjp(jnp.asarray(dy))
    return [np.asarray(t, np.float32) for t in (dtoks, dw1, dw3, dw2)]


FFN_CASES = [(3, 4, 32, 48, 1), (6, 36, 64, 48, 5), (4, 64, 48, 48, 9),
             (5, 36, 32, 48, 36)]          # the last: a bucket left empty


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("E,C,D,F,empty", FFN_CASES)
def test_moe_ffn_bwd_ref_matches_jax_vjp(E, C, D, F, empty, dtype):
    """(a) The plain backward of the bucket FFN against ``jax.vjp`` of
    ``expert_ffn_ref``; an empty bucket row's dx exactly zero."""
    arrs = _ffn_inputs(E, C, D, F, dtype, empty)
    want = _jax_vjp(*arrs)
    w1, w3, w2, toks, dy = (tensor_from_numpy(a) for a in arrs)
    got = ref.moe_ffn_bwd_ref(w1, w3, w2, toks, dy)
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    for name, g, w in zip(("dx", "dw1", "dw3", "dw2"), got, want):
        assert g.dtype == toks.dtype and tuple(g.shape) == w.shape
        assert _rel(_np(g), w) <= tol, (name, _rel(_np(g), w))
    assert not got[0][:, C - empty:].any()
    assert np.all(want[0][:, C - empty:] == 0)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("E,C,D,F,empty", FFN_CASES[:2])
def test_fused_moe_ffn_function_on_the_host(E, C, D, F, empty, dtype):
    """(b) ``ops.fused_moe_ffn`` under autograd on the CPU goes through
    :class:`FusedMoeFFN`: its forward is the plain forward and its
    gradients are exactly ``moe_ffn_bwd_ref``'s (and so within (a)'s
    tolerance of ``jax.vjp``); without a gradient the plain forward is
    called directly, with the same output."""
    arrs = _ffn_inputs(E, C, D, F, dtype, empty, seed=1)
    w1, w3, w2, toks, dy = (tensor_from_numpy(a) for a in arrs)
    ins = [t.clone().requires_grad_(True) for t in (w1, w3, w2, toks)]
    y = ops.fused_moe_ffn(*ins)
    assert y.grad_fn is not None and "FusedMoeFFN" in type(y.grad_fn).__name__
    with torch.no_grad():
        assert torch.equal(y, ops.fused_moe_ffn(w1, w3, w2, toks))
    y.backward(dy)
    dx, dw1, dw3, dw2 = ref.moe_ffn_bwd_ref(w1, w3, w2, toks, dy)
    for got, want in zip((t.grad for t in ins), (dw1, dw3, dw2, dx)):
        assert torch.equal(got, want)
    tol = F32_TOL if dtype == jnp.float32 else BF16_TOL
    for g, w in zip((ins[3].grad, *(t.grad for t in ins[:3])),
                    _jax_vjp(*arrs)):
        assert _rel(_np(g), w) <= tol


def _j_rules(cf):
    """The reference's one-device mesh rules with its jnp FFN (the one its
    bodies train through: ``use_kernel`` False)."""
    return JRules(mesh=MESH, dp=(), ep=("model",), ep_all=("model",),
                  fsdp=None, moe_impl="capacity", capacity_factor=cf,
                  moe_block_m=8, use_kernel=False)


def _loss_terms(y, aux):
    return (y ** 2).mean() + 0.01 * aux


def _j_grads(jp, jx, rules, phase, tables, K=2, E=6):
    def loss(p, x):
        y, tal, aux = jmoe.moe_layer(p, x, top_k=K, n_experts=E, rules=rules,
                                     phase=phase, route_seed=jnp.int32(7),
                                     **tables)
        return _loss_terms(y.astype(jnp.float32), aux), tal

    with compat.use_mesh(MESH):
        (val, tal), (gp, gx) = jax.jit(jax.value_and_grad(
            loss, (0, 1), has_aux=True))(jp, jx)
    return (float(val), np.asarray(tal),
            {k: np.asarray(v, np.float32) for k, v in gp.items()},
            np.asarray(gx, np.float32))


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("phase", ["train", "decode"])
@pytest.mark.parametrize("replicated", [False, True])
@pytest.mark.parametrize("starved", [False, True])
def test_capacity_body_gradients_match_jax_grad(dtype, phase, replicated,
                                                starved):
    """(c) ``mean(y²) + 0.01·aux`` through the port's capacity bodies at
    one rank (a2a at train, replicated at decode; replica tables on and
    off; a starved factor and the default) against ``jax.grad`` through
    the reference's bodies on a one-device mesh: the drop column and the
    tallies exact, the loss, each weight's and x's gradient within
    tolerance."""
    cf = 0.25 if starved else 1.25
    jp, tp, jx, tx, tj, tt = _layer_inputs(dtype, replicated, starved)
    val_j, tal_j, gp_j, gx_j = _j_grads(jp, jx, _j_rules(cf), phase, tj)
    for v in tp.values():
        v.requires_grad_(True)
    x = tx.clone().requires_grad_(True)
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1,
                          capacity_factor=cf)
    y, tal, aux = tmoe.moe_layer(tp, x, top_k=2, n_experts=6, rules=rules,
                                 route_seed=7, phase=phase, **tt)
    loss = _loss_terms(y.float(), aux)
    loss.backward()
    np.testing.assert_array_equal(tal.numpy(), tal_j)
    if starved:
        assert float(tal[-1]) > 0                 # the buckets overflow
    f32 = dtype == jnp.float32
    tol = F32_TOL if f32 else GRAD_TOL
    np.testing.assert_allclose(float(loss.detach()), val_j,
                               rtol=F32_TOL if f32 else LOSS_TOL_BF16)
    for k in ("router", "w1", "w3", "w2"):
        g = _np(tp[k].grad)
        assert np.linalg.norm(g) > 0, k
        assert _rel(g, gp_j[k]) <= tol, (k, _rel(g, gp_j[k]))
    assert _rel(_np(x.grad), gx_j) <= tol, ("x", _rel(_np(x.grad), gx_j))


def test_capacity_step_traced_on_meta_reports_the_backward():
    """(e) A capacity training step traced on ``meta`` (the dry run's
    device): every layer reports the forward, dgrad and wgrad cost entries
    of the bucket FFN (10 E C D F and 6 E C D F operations, C the bucket
    rows at factor 1.25), launches nothing, and gives every parameter,
    each expert weight included, a gradient of its shape."""
    cfg = t_get_smoke("granite-moe-3b-a800m")
    tree = tree_map(lambda t: t.to("meta").requires_grad_(True),
                    tmodel.init_params(cfg, torch.Generator().manual_seed(0),
                                       dtype=torch.bfloat16))
    params = leaves(tree)
    B, S = 2, 16
    tok = torch.zeros((B, S), dtype=torch.long, device="meta")
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1)
    ops.reset_launch_counts()
    with count_costs() as c:
        loss, _ = tmodel.loss_fn(cfg, rules)(
            tree, {"tokens": tok, "labels": tok},
            tmodel.make_moe_tables(cfg, rules, device="meta"))
        loss.backward()
    L, E, D, F = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    C = tmoe._round_up(int(np.ceil(B * S * cfg.top_k / E * 1.25)), 4)
    assert c.kernel_calls["fused_moe_ffn"] == L
    assert c.kernel_calls["moe_ffn_dgrad"] == L
    assert c.kernel_calls["moe_ffn_wgrad"] == L
    assert c.kernel_flops["moe_ffn_dgrad"] == L * 10 * E * C * D * F
    assert c.kernel_flops["moe_ffn_wgrad"] == L * 6 * E * C * D * F
    assert "ragged_moe_ffn" not in c.kernel_calls
    assert all(v == 0 for v in ops.launch_counts().values())
    for p in params:
        assert p.grad is not None and p.grad.shape == p.shape
        assert p.grad.device.type == "meta"
