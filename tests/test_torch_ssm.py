"""The port's recurrent mixers and the models built on them, against the
JAX package (``repro.models.ssm``, ``repro.models.model``).

Same inputs (numpy, seeded) and the reference's params carried across by
``repro_torch.bridge.params_from_numpy``.

* Each of ``mamba_seq``, ``mlstm_seq`` and ``slstm_seq``, with and without
  an incoming state (the reference's own state after a 5-token prefix), at
  S = 24 with chunk 8 and at a prime S = 13 (one token a chunk), and each
  ``*_step`` from such a state: output and every state leaf within 1e-5
  relative L2 in f32, and within the reference's own 2e-2
  (``tests/test_models.py``) elementwise in bf16.
* Gradients of each mixer in f32 against ``jax.grad``, through the first
  chunk, where the mLSTM stabiliser starts at -1e30: every leaf within
  1e-4 relative L2, all finite.
* The port's chunked forms against its own token-by-token steps, at the
  reference's tolerances for the same property.
* xlstm-350m and jamba-1.5-large-398b at smoke size in f32: prefill logits
  and the cache tree within 1e-4, 8 decode steps of three lanes at their
  own positions, the loss within 1e-5 relative and every gradient leaf
  within 1e-4 relative L2 (jamba's MoE layers on the ragged path on both
  sides), and ``prefill_chunk_fn`` refusing both with the reference's
  reason, also through the engine.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.train import train  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.serving import Engine, EngineConfig, SchedulerConfig  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-5            # mixers, relative L2
BF16_TOL = 2e-2           # the reference's own (tests/test_models.py)
MODEL_TOL = 1e-4          # logits and caches, elementwise
GRAD_TOL = 1e-4           # relative L2 a gradient leaf
LOSS_TOL = 1e-5           # relative
B, D, H = 2, 32, 2
MIXERS = ["mamba", "mlstm", "slstm"]
ARCHS = ["xlstm-350m", "jamba-1.5-large-398b"]
J_RULES = JRules(mesh=None, moe_impl="ragged", moe_block_m=8, use_kernel=True)
T_RULES = ShardingRules(moe_block_m=8)


def _np(t):
    return t.detach().float().cpu().numpy()


def _rel(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _hold(t, j, dtype):
    """One output or state leaf of the port's against the reference's."""
    if dtype == "float32":
        assert _rel(_np(t), j) <= F32_TOL, _rel(_np(t), j)
    else:
        np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                                   atol=BF16_TOL, rtol=BF16_TOL)


@functools.lru_cache(maxsize=None)
def _jparams(mixer, dtype):
    jd, key = getattr(jnp, dtype), jax.random.PRNGKey(0)
    if mixer == "mamba":
        return jssm.mamba_init(key, D, d_state=8, dtype=jd)
    init = jssm.mlstm_init if mixer == "mlstm" else jssm.slstm_init
    return init(key, D, n_heads=H, dtype=jd)


def _tree(x):
    return params_from_numpy(jax.tree.map(np.asarray, x))


def _x(S, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal((B, S, D))
    return jnp.asarray(x, jnp.float32).astype(getattr(jnp, dtype))


def _seq(pkg, mixer, p, x, state, chunk):
    fn = getattr(pkg, f"{mixer}_seq")
    if mixer == "slstm":            # a chunk changes no sum of the sLSTM
        return fn(p, x, state) if pkg is tssm else fn(p, x, state,
                                                      chunk=chunk)
    return fn(p, x, state, chunk=chunk)


def _incoming(mixer, dtype):
    """The reference's state after a 5-token prefix."""
    return _seq(jssm, mixer, _jparams(mixer, dtype), _x(5, dtype, seed=2),
                None, 8)[1]


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("S,chunk", [(24, 8), (13, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_seq_matches_jax(mixer, dtype, S, chunk, with_state):
    jp = _jparams(mixer, dtype)
    xj = _x(S, dtype)
    st = _incoming(mixer, dtype) if with_state else None
    yj, sj = _seq(jssm, mixer, jp, xj, st, chunk)
    yt, stt = _seq(tssm, mixer, _tree(jp), _tree(xj),
                   None if st is None else _tree(st), chunk)
    assert yt.dtype == getattr(torch, dtype)
    _hold(yt, yj, dtype)
    assert sorted(stt) == sorted(sj)
    for k in sj:
        assert stt[k].dtype == _tree(sj[k]).dtype, k
        _hold(stt[k], sj[k], dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_step_matches_jax(mixer, dtype):
    jp = _jparams(mixer, dtype)
    st = _incoming(mixer, dtype)
    xj = _x(1, dtype)
    yj, sj = getattr(jssm, f"{mixer}_step")(jp, xj, st)
    yt, stt = getattr(tssm, f"{mixer}_step")(_tree(jp), _tree(xj), _tree(st))
    _hold(yt, yj, dtype)
    for k in sj:
        _hold(stt[k], sj[k], dtype)


@pytest.mark.parametrize("mixer", MIXERS)
def test_mixer_gradients_match_jax(mixer):
    """d(sum(y * r)) / d(params, x) in f32, three chunks of 8 from a fresh
    state: the first chunk runs from m0 = -1e30 in the mLSTM."""
    jp = _jparams(mixer, "float32")
    xj = _x(24, "float32")
    r = np.random.default_rng(5).standard_normal((B, 24, D)).astype(
        np.float32)

    def jloss(p, x):
        y, _ = _seq(jssm, mixer, p, x, None, 8)
        return jnp.sum(y * r)

    gj = jax.grad(jloss, argnums=(0, 1))(jp, xj)
    tp, xt = _tree(jp), _tree(xj)
    for t in leaves(tp) + [xt]:
        t.requires_grad_(True)
    y, _ = _seq(tssm, mixer, tp, xt, None, 8)
    (y * torch.from_numpy(r)).sum().backward()
    got = [t.grad for t in leaves(tp)] + [xt.grad]
    want = jax.tree.leaves(gj)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        assert _rel(_np(g), w) <= GRAD_TOL, _rel(_np(g), w)


def _steps(mixer, p, x, state):
    ys = []
    for t in range(x.shape[1]):
        y, state = getattr(tssm, f"{mixer}_step")(p, x[:, t:t + 1], state)
        ys.append(y)
    return torch.cat(ys, dim=1), state


def test_mamba_chunked_equals_step():
    p = _tree(_jparams("mamba", "bfloat16"))
    x = _tree(_x(24, "bfloat16"))
    y_full, st_full = tssm.mamba_seq(p, x, chunk=8)
    y_step, st = _steps("mamba", p, x,
                        tssm.mamba_state_init(B, D, d_state=8))
    np.testing.assert_allclose(_np(y_full), _np(y_step), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(_np(st_full["h"]), _np(st["h"]), atol=1e-4,
                               rtol=1e-3)


def test_mlstm_chunked_equals_step():
    p = _tree(_jparams("mlstm", "bfloat16"))
    x = _tree(_x(16, "bfloat16"))
    y_full, _ = tssm.mlstm_seq(p, x, chunk=4)
    y_step, _ = _steps("mlstm", p, x, None)
    np.testing.assert_allclose(_np(y_full), _np(y_step), atol=3e-2,
                               rtol=3e-2)


def test_slstm_seq_equals_step():
    p = _tree(_jparams("slstm", "bfloat16"))
    x = _tree(_x(16, "bfloat16"))
    y_full, st_full = tssm.slstm_seq(p, x)
    y_step, st = _steps("slstm", p, x, None)
    np.testing.assert_allclose(_np(y_full), _np(y_step), atol=1e-3,
                               rtol=1e-3)
    for k in st:
        np.testing.assert_allclose(_np(st_full[k]), _np(st[k]), atol=1e-3,
                                   rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _model(arch):
    cfg = get_smoke(arch)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return cfg, jp


def _close(t, j):
    np.testing.assert_allclose(_np(t), np.asarray(j, np.float32),
                               rtol=MODEL_TOL, atol=MODEL_TOL)


def _hold_cache(ct, cj):
    lt, lj = leaves(ct), jax.tree.leaves(cj)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        assert tuple(a.shape) == b.shape
        _close(a, b)


@pytest.mark.parametrize("arch", ARCHS)
def test_model_prefill_then_decode_match_jax(arch):
    cfg, jp = _model(arch)
    tcfg = t_get_smoke(arch)
    tp = _tree(jp)
    jt, tt = jmodel.make_moe_tables(cfg, None), tmodel.make_moe_tables(tcfg)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=(1, 13)).astype(np.int32)
    lg_j, c_j, tal_j = jax.jit(jmodel.prefill_fn(cfg, J_RULES))(
        jp, {"tokens": jnp.asarray(prompt)}, jt)
    lg_t, c_t, tal_t = tmodel.prefill_fn(tcfg, T_RULES)(
        tp, {"tokens": torch.from_numpy(prompt)}, tt)
    _close(lg_t, lg_j)
    _hold_cache(c_t, c_j)
    np.testing.assert_array_equal(_np(tal_t), np.asarray(tal_j))
    # decode: three lanes at their own positions, from the empty cache
    n_lanes, s_max = 3, 24
    jc = jmodel.init_cache(cfg, n_lanes, s_max, dtype=jnp.float32)
    tc = tmodel.init_cache(tcfg, n_lanes, s_max, dtype=torch.float32)
    _hold_cache(tc, jc)
    pos = np.array([4, 0, 11], np.int32)
    dec_j = jax.jit(jmodel.decode_fn(cfg, J_RULES))
    dec_t = tmodel.decode_fn(tcfg, T_RULES)
    for _ in range(8):
        tok = rng.integers(0, cfg.vocab, size=(n_lanes, 1)).astype(np.int32)
        lg_j, jc, tal_j = dec_j(jp, jnp.asarray(tok), jc, jnp.asarray(pos),
                                jt)
        lg_t, tc2, tal_t = dec_t(tp, torch.from_numpy(tok), tc,
                                 torch.from_numpy(pos), tt)
        assert tc2 is tc                              # updated in place
        _close(lg_t, lg_j)
        _hold_cache(tc, jc)
        np.testing.assert_array_equal(_np(tal_t), np.asarray(tal_j))
        pos = pos + 1


@pytest.mark.parametrize("arch", ARCHS)
def test_model_loss_and_gradients_match_jax(arch):
    cfg, jp = _model(arch)
    tcfg = t_get_smoke(arch)
    rng = np.random.default_rng(1)
    tok = rng.integers(0, cfg.vocab, (2, 16)).astype(np.int32)
    lab = np.roll(tok, -1, axis=1)
    (jl, (jtal, _)), jg = jax.jit(jax.value_and_grad(
        jmodel.loss_fn(cfg, JRules(mesh=None, moe_impl="ragged",
                                   moe_block_m=8)), has_aux=True))(
        jp, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab)},
        jmodel.make_moe_tables(cfg, None))
    tp = _tree(jp)
    for p in leaves(tp):
        p.requires_grad_(True)
    tl, (ttal, _) = tmodel.loss_fn(tcfg, T_RULES)(
        tp, {"tokens": torch.from_numpy(tok),
             "labels": torch.from_numpy(lab)}, tmodel.make_moe_tables(tcfg))
    tl.backward()
    assert abs(float(tl.detach()) - float(jl)) <= LOSS_TOL * abs(float(jl))
    np.testing.assert_array_equal(_np(ttal), np.asarray(jtal))
    got, want = leaves(tp), jax.tree.leaves(jg)
    assert len(got) == len(want)
    errs = [_rel(_np(p.grad), g) for p, g in zip(got, want)]
    assert max(errs) <= GRAD_TOL, f"gradient leaf errors {errs}"


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_refuses_recurrent_mixers(arch):
    reason = "resumable per-position cache"
    with pytest.raises(NotImplementedError, match=reason):
        jmodel.prefill_chunk_fn(get_smoke(arch))
    with pytest.raises(NotImplementedError, match=reason):
        tmodel.prefill_chunk_fn(t_get_smoke(arch))
    with pytest.raises(NotImplementedError, match=reason):
        Engine(t_get_smoke(arch),
               EngineConfig(max_batch=2, max_seq=32,
                            scheduler=SchedulerConfig(prefill_chunk=16)),
               device="cpu")


def test_train_driver_runs_xlstm():
    _, _, losses, tallies = train("xlstm-350m", steps=2, seq_len=16, batch=2,
                                  device="cpu", log_every=100)
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert tallies is None                            # no MoE layers
