"""The port's training loss against the JAX package's, value and gradients.

``repro_torch.models.loss_fn`` with ``backward()`` on the CPU (the plain
versions of the kernels, forward and backward) against
``jax.value_and_grad`` of ``repro.models.loss_fn`` under both dispatches
the reference trains with: the ragged rules
(``JRules(mesh=None, moe_impl="ragged", moe_block_m=8)``, its jnp ragged
reference) and ``rules=None`` (its dense oracle, what its ``train.py``
runs). The reference's params cross by ``bridge.params_from_numpy``; the
batch comes from numpy.

Tolerances. f32: the loss within 1e-4 relative, every gradient leaf within
1e-4 relative L2 error ``|a - b| / |b|``, tallies exactly equal. bf16: the
loss within 5e-2 relative; the gradients are held against the reference's
f32 gradients of the same bf16 parameters, each leaf within
max(5e-2, the error of the reference's own bf16 gradients there). The bound
has to be wider than 5e-2 against the reference's bf16 gradients: the
reference rounds every einsum output to bf16, and on granite smoke its
bf16 gradients sit 11–51% (relative L2) from its f32 gradients of the same
parameters, and its two bf16 dispatches 1–10% from each other, while the
port's sit 2–11% from them (the port keeps the expert products and the
router's softmax in f32).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 5e-2
J_RAGGED = JRules(mesh=None, moe_impl="ragged", moe_block_m=8)
T_RULES = ShardingRules(moe_block_m=8)
ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "smollm-360m"]


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(cfg):
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    return tok, np.roll(tok, -1, axis=1)


def _jax_loss(arch, params, rules):
    cfg = get_smoke(arch)
    tok, lab = _batch(cfg)
    (loss, (tal, _)), grads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn(cfg, rules), has_aux=True))(
        params, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
        jmodel.make_moe_tables(cfg, None))
    return (float(loss), np.asarray(tal),
            [np.asarray(g, np.float32) for g in jax.tree.leaves(grads)])


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jmodel.init_params(get_smoke(arch), jax.random.PRNGKey(0),
                              dtype=jd)


@functools.lru_cache(maxsize=None)
def _jax_f32_on_bf16_params(arch):
    """The reference's f32 loss and gradients of the bf16 parameters."""
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32),
                       _params(arch, "bfloat16"))
    return _jax_loss(arch, p32, J_RAGGED)


@pytest.mark.parametrize("jrules", ["ragged", "dense"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_value_and_grad_match_jax(arch, dtype, jrules):
    jp = _params(arch, dtype)
    jl, jtal, jg = _jax_loss(arch, jp, J_RAGGED if jrules == "ragged"
                             else None)
    tcfg = t_get_smoke(arch)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    for p in leaves(tp):
        p.requires_grad_(True)
    tok, lab = _batch(tcfg)
    tl, (ttal, _) = tmodel.loss_fn(tcfg, T_RULES)(
        tp, {"tokens": torch.from_numpy(tok), "labels": torch.from_numpy(lab)},
        tmodel.make_moe_tables(tcfg))
    tl.backward()
    tg = [p.grad.float().numpy() for p in leaves(tp)]
    assert len(tg) == len(jg)
    tl = float(tl.detach())
    ttal = ttal.numpy()
    if dtype == "float32":
        assert abs(tl - jl) <= F32_TOL * abs(jl)
        np.testing.assert_array_equal(ttal, jtal)
        errs = [_rel(a, b) for a, b in zip(tg, jg)]
        assert max(errs) <= F32_TOL, f"gradient leaf errors {errs}"
        return
    assert abs(tl - jl) <= BF16_TOL * abs(jl)
    # every token still routes top_k (bf16 may flip a near tie)
    np.testing.assert_array_equal(ttal.sum(-1), jtal.sum(-1))
    _, _, g32 = _jax_f32_on_bf16_params(arch)
    for i, (a, b, r) in enumerate(zip(tg, g32, jg)):
        bound = max(BF16_TOL, _rel(r, b))
        assert _rel(a, b) <= bound, (
            f"leaf {i}: port bf16 {_rel(a, b):.3g} from the reference's f32 "
            f"gradient, bound {bound:.3g}")
