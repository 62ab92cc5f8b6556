"""The modality frontends of the port on one device against the JAX
package: hubert-xlarge's audio frames and pixtral-12b's image patches
through the loss, the prefill and the train driver; and ``count_params``.

The reference's params (``repro.models.init_params``, seed 0) cross by
``bridge.params_from_numpy``; the batch comes from numpy (seed 3): hubert
2 x 16 f32 frames, pixtral 2 x (8 patches + 12 tokens) with f32 patches,
as ``training/data.py::synthetic_batch`` makes them. Both run against the
reference's ``rules=None``.

Tolerances, those of ``tests/test_torch_loss.py`` for the loss and its
gradients and of ``tests/test_torch_model.py`` for the prefill and
decode. f32: the loss within 1e-4 relative, every gradient leaf
(``params["frontend"]`` included; hubert's unread ``embed`` has none in
the port and zeros in the reference) within 1e-4 relative L2, logits and
caches within 1e-4 elementwise. bf16: the loss within 5e-2 relative; the
gradients against the reference's f32 gradients of the same bf16
parameters, each leaf within max(5e-2, the error of the reference's own
bf16 gradients there); logits and caches within 5e-2 relative L2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ALL_ARCHS, EXTRA_ARCHS, get, get_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get as t_get  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import count_params  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
BF16_TOL = 5e-2
ARCHS = ["hubert-xlarge", "pixtral-12b"]
DTYPES = ["float32", "bfloat16"]
B, S_AUDIO, TEXT, DEC_STEPS = 2, 16, 12, 3


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _batch(arch, seed=3):
    """The reference's batch (numpy): frames, or patches and tokens."""
    cfg = get_smoke(arch)
    rng = np.random.default_rng(seed)
    if cfg.frontend == "audio":
        return {"feats": rng.normal(size=(B, S_AUDIO, cfg.frontend_dim))
                .astype(np.float32),
                "labels": rng.integers(0, cfg.vocab, (B, S_AUDIO))
                .astype(np.int32)}
    return {"tokens": rng.integers(0, cfg.vocab, (B, TEXT)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (B, TEXT)).astype(np.int32),
            "patches": rng.normal(size=(B, cfg.n_patches, cfg.frontend_dim))
            .astype(np.float32)}


def _j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _no_labels(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


@functools.lru_cache(maxsize=None)
def _params(arch, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return jmodel.init_params(get_smoke(arch), jax.random.PRNGKey(0),
                              dtype=jd)


def _jax_loss(arch, params, batch):
    (loss, _), grads = jax.jit(jax.value_and_grad(
        jmodel.loss_fn(get_smoke(arch), None), has_aux=True))(
            params, _j(batch))
    return float(loss), [np.asarray(g, np.float32)
                         for g in jax.tree.leaves(grads)]


def _port_loss(arch, jparams, batch):
    tp = params_from_numpy(jax.tree.map(np.asarray, jparams))
    for p in leaves(tp):
        p.requires_grad_(True)
    loss, _ = tmodel.loss_fn(t_get_smoke(arch))(tp, _t(batch))
    loss.backward()
    grads = [np.zeros(p.shape, np.float32) if p.grad is None
             else p.grad.float().numpy() for p in leaves(tp)]
    # the frontend's projection has a gradient of its own
    assert tp["frontend"].grad.abs().sum() > 0
    return float(loss.detach()), grads


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_jax(arch, dtype):
    batch = _batch(arch)
    jp = _params(arch, dtype)
    jl, jg = _jax_loss(arch, jp, batch)
    tl, tg = _port_loss(arch, jp, batch)
    assert len(tg) == len(jg)
    if dtype == "float32":
        assert abs(tl - jl) <= F32_TOL * abs(jl)
        errs = [_rel(a, b) for a, b in zip(tg, jg)]
        assert max(errs) <= F32_TOL, f"gradient leaf errors {errs}"
        return
    assert abs(tl - jl) <= BF16_TOL * abs(jl)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), jp)
    _, g32 = _jax_loss(arch, p32, batch)
    for i, (a, b, r) in enumerate(zip(tg, g32, jg)):
        bound = max(BF16_TOL, _rel(r, b))
        assert _rel(a, b) <= bound, (
            f"leaf {i}: port bf16 {_rel(a, b):.3g} from the reference's f32 "
            f"gradient, bound {bound:.3g}")


def _prefill(arch, dtype, batch):
    jp = _params(arch, dtype)
    jl, jc, _ = jax.jit(jmodel.prefill_fn(get_smoke(arch), None))(
        jp, _j(_no_labels(batch)))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    with torch.no_grad():
        tl, tc, _ = tmodel.prefill_fn(t_get_smoke(arch))(
            tp, _t(_no_labels(batch)))
    return (jl, jc), (tl, tc), tp


def _hold(a, b, dtype):
    a = a.detach().float().numpy()
    b = np.asarray(b, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)
    else:
        assert _rel(a, b) <= BF16_TOL, _rel(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_jax(arch, dtype):
    """The logits at the last (text) position and a cache of every
    position, a vision arch's patches too: P + T rows."""
    cfg = t_get_smoke(arch)
    batch = _batch(arch)
    (jl, jc), (tl, tc), _ = _prefill(arch, dtype, batch)
    _hold(tl, jl, dtype)
    rows = S_AUDIO if cfg.frontend == "audio" else cfg.n_patches + TEXT
    j_leaves = jax.tree.leaves(jc)
    t_leaves = [t for c in tc for t in c]
    assert len(t_leaves) == len(j_leaves)
    for a, b in zip(t_leaves, j_leaves):
        assert tuple(a.shape) == b.shape and a.shape[2] == rows
        assert str(a.dtype).split(".")[-1] == str(b.dtype)
        _hold(a, b, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pixtral_decodes_text_after_its_prefill(dtype):
    """Three text-only decode steps from the prefill's cache (padded to
    P + T + 3 rows), at positions P + T, P + T + 1, ..."""
    arch = "pixtral-12b"
    cfg = t_get_smoke(arch)
    batch = _batch(arch)
    (_, jc), (_, tc), tp = _prefill(arch, dtype, batch)
    S = cfg.n_patches + TEXT
    pad = [(0, 0), (0, 0), (0, DEC_STEPS), (0, 0), (0, 0)]
    jcache = jax.tree.map(lambda a: jnp.pad(a, pad), jc)
    tcache = [tuple(torch.nn.functional.pad(t, (0, 0, 0, 0, 0, DEC_STEPS))
                    for t in c) for c in tc]
    jp = _params(arch, dtype)
    jstep = jax.jit(jmodel.decode_fn(get_smoke(arch), None))
    tstep = tmodel.decode_fn(cfg)
    rng = np.random.default_rng(5)
    for i in range(DEC_STEPS):
        tok = rng.integers(0, cfg.vocab, (B, 1)).astype(np.int32)
        pos = np.full((B,), S + i, np.int32)
        jl, jcache, _ = jstep(jp, jnp.asarray(tok), jcache, jnp.asarray(pos))
        with torch.no_grad():
            tl, tcache, _ = tstep(tp, torch.from_numpy(tok), tcache,
                                  torch.from_numpy(pos))
        _hold(tl, jl, dtype)


def test_hubert_residual_is_f32_from_f32_frames():
    """f32 frames through the bf16 frontend give an f32 residual stream
    through the bf16 blocks, as the reference's dtype promotion does (its
    cache is f32 too); bf16 frames (the dry run's) keep it bf16."""
    arch = "hubert-xlarge"
    jp = _params(arch, "bfloat16")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    feats = _batch(arch)["feats"]
    seen = []
    real = tmodel._block_body

    def body(*args, **kw):
        seen.append(args[4].dtype)
        return real(*args, **kw)

    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        _, jc, _ = jmodel.prefill_fn(get_smoke(arch), None)(
            jp, {"feats": jnp.asarray(feats).astype(jd)})
        seen.clear()
        tmodel._block_body = body
        try:
            with torch.no_grad():
                _, tc, _ = tmodel.prefill_fn(t_get_smoke(arch))(
                    tp, {"feats": torch.from_numpy(feats).to(td)})
        finally:
            tmodel._block_body = real
        assert set(seen) == {td}
        assert tc[0][0].dtype == td
        assert jax.tree.leaves(jc)[0].dtype == jd


def test_pixtral_loss_moves_with_the_patches():
    """The same tokens and labels with the patches drawn again give
    another loss, in the port as in the reference, each the reference's
    (the port once read the tokens only and gave one loss for both)."""
    arch = "pixtral-12b"
    jp = _params(arch, "float32")
    batch = _batch(arch)
    other = dict(batch, patches=_batch(arch, seed=4)["patches"])
    losses = []
    for b in (batch, other):
        jl, _ = _jax_loss(arch, jp, b)
        tl, _ = _port_loss(arch, jp, b)
        assert abs(tl - jl) <= F32_TOL * abs(jl)
        losses.append(tl)
    assert abs(losses[0] - losses[1]) > 10 * F32_TOL * abs(losses[0])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_driver_runs_the_frontends(arch):
    """``launch.train.train`` on the smoke config takes the synthetic
    batch whole (hubert's has no tokens): finite losses."""
    _, _, losses, tallies = train(arch, smoke=True, steps=2, seq_len=24,
                                  batch=2, log_every=10, device="cpu")
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert tallies is None


@pytest.mark.parametrize("arch", ALL_ARCHS + EXTRA_ARCHS)
def test_count_params_matches_jax(arch):
    """The smoke config's whole tree against the reference's, and the
    published config's tree on ``meta`` against the reference's
    ``jax.eval_shape`` of its own."""
    gen = torch.Generator().manual_seed(0)
    small = tmodel.init_params(t_get_smoke(arch), gen)
    assert count_params(small) == jmodel.count_params(
        jmodel.init_params(get_smoke(arch), jax.random.PRNGKey(0)))
    full = tmodel.init_params(t_get(arch), None, device="meta")
    assert count_params(full) == jmodel.count_params(jax.eval_shape(
        lambda: jmodel.init_params(get(arch), jax.random.PRNGKey(0))))
