"""The port's model entry points against the JAX package, same weights.

The reference's params (``repro.models.init_params``) are carried across
with ``repro_torch.bridge.params_from_numpy``; tokens and positions come
from numpy. f32 runs hold logits and caches within 1e-4 elementwise and
tallies exactly equal (tests/test_kernels.py's f32 tolerance). bf16 runs
hold them within 5e-2 as a relative L2 error, ``|a - b| / |b|``: after
three layers of bf16 rounding the reference does not agree with itself
elementwise to 5e-2 (its ragged Pallas kernel and its jnp ragged path
differ by up to 0.12 on granite smoke's logits), so an elementwise bound
would test rounding order, not the port. The JAX side runs its ragged
dispatch with the Pallas kernel in interpret mode, and its capacity
dispatch through the real ``shard_map`` bodies on a one-device mesh with
the capacity Pallas kernel (inside ``compat.use_mesh``).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import compat  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import flash as jflash  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.bridge import params_from_numpy, tensor_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

J_RULES = JRules(mesh=None, moe_impl="ragged", moe_block_m=8, use_kernel=True)
T_RULES = ShardingRules(moe_block_m=8)
TOL = {jnp.float32: 1e-4, jnp.bfloat16: 5e-2}
ARCHS = ["granite-moe-3b-a800m", "qwen3-moe-235b-a22b", "smollm-360m"]


def _np(t):
    return t.detach().float().cpu().numpy()


def _close(a_t, b_j, tol):
    np.testing.assert_allclose(_np(a_t), np.asarray(b_j, np.float32),
                               rtol=tol, atol=tol)


def _close_rel(a_t, b_j, tol):
    a, b = _np(a_t), np.asarray(b_j, np.float32)
    err = np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)
    assert err <= tol, f"relative L2 error {err:.3g} > {tol}"


def _setup(arch, dtype):
    cfg = get_smoke(arch)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=dtype)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    jt = jmodel.make_moe_tables(cfg, None)
    tt = tmodel.make_moe_tables(t_get_smoke(arch))
    return cfg, t_get_smoke(arch), jp, tp, jt, tt


def _check_step(dtype, lg_t, lg_j, cache_t, cache_j, tal_t, tal_j):
    """Hold one model call's outputs against the reference's. Returns the
    number of assignments whose expert differs (always 0 in f32)."""
    tal_t, tal_j = _np(tal_t), np.asarray(tal_j)
    if dtype == jnp.float32:
        np.testing.assert_array_equal(tal_t, tal_j)              # exact
        close, tol = _close, TOL[jnp.float32]
    else:
        # bf16 can flip a near-tie in the router's top-k; a flipped
        # assignment changes that token's layer output by design, so such
        # a call is counted, not compared. Every token still routes top_k.
        np.testing.assert_array_equal(tal_t.sum(-1), tal_j.sum(-1))
        moved = int(np.abs(tal_t - tal_j).sum()) // 2
        if moved:
            return moved
        close, tol = _close_rel, TOL[jnp.bfloat16]
    close(lg_t, lg_j, tol)
    for (kt, vt), (kj, vj) in zip(cache_t, cache_j):
        close(kt, kj, tol)
        close(vt, vj, tol)
    return 0


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_then_decode_match_jax(arch, dtype):
    cfg, tcfg, jp, tp, jt, tt = _setup(arch, dtype)
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, cfg.vocab, size=(1, 13)).astype(np.int32)

    lg_j, c_j, tal_j = jax.jit(jmodel.prefill_fn(cfg, J_RULES))(
        jp, {"tokens": jnp.asarray(prompt)}, jt)
    lg_t, c_t, tal_t = tmodel.prefill_fn(tcfg, T_RULES)(
        tp, {"tokens": torch.from_numpy(prompt)}, tt)
    moved = [_check_step(dtype, lg_t, lg_j, c_t, c_j, tal_t, tal_j)]

    # decode: three lanes at their own positions, several steps
    B, S_max = 3, 24
    jc = jmodel.init_cache(cfg, B, S_max, dtype=dtype)
    tc = tmodel.init_cache(tcfg, B, S_max, dtype=tp["embed"].dtype)
    pos = np.array([4, 0, 11], np.int32)
    dec_j = jax.jit(jmodel.decode_fn(cfg, J_RULES))
    dec_t = tmodel.decode_fn(tcfg, T_RULES)
    for _ in range(3):
        tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
        lg_j, jc, tal_j = dec_j(jp, jnp.asarray(tok), jc, jnp.asarray(pos), jt)
        lg_t, tc, tal_t = dec_t(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(pos), tt)
        moved.append(_check_step(dtype, lg_t, lg_j, tc, jc, tal_t, tal_j))
        pos = pos + 1
    # at most one near-tie flip, of one assignment, in the four bf16 calls
    assert sum(moved) <= 1, f"assignments moved per call: {moved}"


MESH = compat.make_mesh((1,), ("model",))
J_CAP_RULES = JRules(mesh=MESH, dp=(), ep=("model",), ep_all=("model",),
                     fsdp=None, moe_impl="capacity", use_kernel=True)
T_CAP_RULES = ShardingRules(moe_impl="capacity", ep_ranks=1)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_capacity_prefill_then_decode_match_jax_one_device_mesh(dtype):
    """Capacity rules on a one-rank group against the reference's
    ``prefill_fn``/``decode_fn`` on a one-device mesh: the a2a body at
    prefill, the replicated body at decode, drop column included."""
    arch = "granite-moe-3b-a800m"
    cfg, tcfg, jp, tp, _, _ = _setup(arch, dtype)
    jt = jmodel.make_moe_tables(cfg, J_CAP_RULES)
    tt = tmodel.make_moe_tables(tcfg, T_CAP_RULES)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, cfg.vocab, size=(1, 23)).astype(np.int32)
    B, S_max = 3, 40
    pos = np.array([23, 5, 17], np.int32)
    with compat.use_mesh(MESH):
        lg_j, c_j, tal_j = jax.jit(jmodel.prefill_fn(cfg, J_CAP_RULES))(
            jp, {"tokens": jnp.asarray(prompt)}, jt)
        jc = jmodel.init_cache(cfg, B, S_max, J_CAP_RULES, dtype=dtype)
        dec_j = jax.jit(jmodel.decode_fn(cfg, J_CAP_RULES))
        steps_j = []
        p_ = pos
        for _ in range(3):
            tok = rng.integers(0, cfg.vocab, size=(B, 1)).astype(np.int32)
            out = dec_j(jp, jnp.asarray(tok), jc, jnp.asarray(p_), jt)
            jc = out[1]
            steps_j.append((tok, p_, out))
            p_ = p_ + 1
    lg_t, c_t, tal_t = tmodel.prefill_fn(tcfg, T_CAP_RULES)(
        tp, {"tokens": torch.from_numpy(prompt)}, tt)
    assert float(np.asarray(tal_j)[:, -1].sum()) > 0     # prefill drops
    moved = [_check_step(dtype, lg_t, lg_j, c_t, c_j, tal_t, tal_j)]
    tc = tmodel.init_cache(tcfg, B, S_max, dtype=tp["embed"].dtype)
    dec_t = tmodel.decode_fn(tcfg, T_CAP_RULES)
    for tok, p_, (lg_j, jc, tal_j) in steps_j:
        lg_t, tc, tal_t = dec_t(tp, torch.from_numpy(tok), tc,
                                torch.from_numpy(p_), tt)
        moved.append(_check_step(dtype, lg_t, lg_j, tc, jc, tal_t, tal_j))
    assert sum(moved) <= 1, f"assignments moved per call: {moved}"


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "smollm-360m"])
def test_prefill_chunk_matches_jax_and_whole_prefill_f32(arch):
    """Chunked prefill of a 21-token prompt in 8-token chunks into lane 1
    of a shared cache: every chunk's cache and tallies against the
    reference's ``prefill_chunk_fn``, the last chunk's logits against the
    reference's and against the port's own whole-prompt prefill."""
    dtype = jnp.float32
    cfg, tcfg, jp, tp, jt, tt = _setup(arch, dtype)
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, size=(1, 21)).astype(np.int32)
    B, S_max, C, lane = 3, 32, 8, 1
    jc = jmodel.init_cache(cfg, B, S_max, dtype=dtype)
    tc = tmodel.init_cache(tcfg, B, S_max, dtype=tp["embed"].dtype)
    chunk_j = jax.jit(jmodel.prefill_chunk_fn(cfg, J_RULES))
    chunk_t = tmodel.prefill_chunk_fn(tcfg, T_RULES)
    for off in range(0, prompt.shape[1], C):
        n_valid = min(C, prompt.shape[1] - off)
        buf = np.zeros((1, C), np.int32)
        buf[0, :n_valid] = prompt[0, off:off + n_valid]
        lg_j, jc, tal_j = chunk_j(jp, jnp.asarray(buf), jc, lane, off,
                                  n_valid, jt)
        lg_t, tc, tal_t = chunk_t(tp, torch.from_numpy(buf), tc, lane, off,
                                  n_valid, tt)
        assert _check_step(dtype, lg_t, lg_j, tc, jc, tal_t, tal_j) == 0
    lg_w, c_w, _ = tmodel.prefill_fn(tcfg, T_RULES)(
        tp, {"tokens": torch.from_numpy(prompt)}, tt)
    _close(lg_t, _np(lg_w), TOL[dtype])
    for (kt, vt), (kw, vw) in zip(tc, c_w):
        _close(kt[:, lane, :21], _np(kw[:, 0]), TOL[dtype])
        _close(vt[:, lane, :21], _np(vw[:, 0]), TOL[dtype])


def test_prefill_chunk_refuses_an_expert_parallel_group():
    with pytest.raises(NotImplementedError, match="expert-parallel group"):
        tmodel.prefill_chunk_fn(t_get_smoke("granite-moe-3b-a800m"),
                                T_CAP_RULES)


def _qkv(seed, B, Sq, Skv, KV, G, hd):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, Sq, KV, G, hd)).astype(np.float32)
    k = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    v = rng.standard_normal((B, Skv, KV, hd)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("causal,window,n_valid", [
    (True, None, None), (True, 5, None), (True, 0, None), (False, None, 9),
    (True, 4, 11)])
def test_flash_attention_matches_jax_f32(causal, window, n_valid):
    q, k, v = _qkv(0, 2, 16, 16, 2, 3, 8)
    qpos = np.arange(16, dtype=np.int32)
    kv_valid = None if n_valid is None else np.arange(16) < n_valid
    o_j = jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=None if window is None else jnp.int32(window),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(qpos),
        kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    o_t = tflash.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_positions=torch.from_numpy(qpos),
        kv_positions=torch.from_numpy(qpos),
        kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid))
    _close(o_t, o_j, 1e-4)                            # f32 tolerance


@pytest.mark.parametrize("window", [None, 3])
def test_flash_decode_matches_jax_f32(window):
    q, k, v = _qkv(1, 3, 1, 20, 2, 2, 8)
    q = q[:, 0]
    pos = np.array([0, 7, 19], np.int32)
    o_j = jflash.flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(pos), window=window)
    o_t = tflash.flash_decode(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), torch.from_numpy(pos),
                              window=window)
    _close(o_t, o_j, 1e-4)                            # f32 tolerance


def test_bridge_carries_bf16_bit_for_bit():
    a = np.asarray(jnp.asarray(np.linspace(-3, 3, 37), jnp.bfloat16))
    t = tensor_from_numpy(a)
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  a.view(np.int16))
