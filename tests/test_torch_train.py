"""The port's training slice against the JAX package, on the CPU.

The reference has no gradient for its Pallas kernels and trains through
its jnp references, so the JAX side here is ``jax.vjp`` of
``repro.kernels.ref.ragged_moe_ffn_ref`` and of the routing stage
(``route`` plus ``_masked_tally`` and ``_aux_loss``), and the reference's
AdamW. The port side runs its plain backward versions (``kernels/ref.py``),
its ``autograd.Function`` wrappers on CPU tensors, its AdamW, checkpoint and
train driver. Inputs come from numpy with fixed seeds; trees cross by
``bridge.params_from_numpy``. ``loss_fn`` against the reference's is in
``tests/test_torch_loss.py``.

Tolerances. The plain FFN backward in f32 within 1e-4 elementwise (the
repo's f32 tolerance, tests/test_kernels.py), in bf16 within 5e-2
relative L2 error ``|a - b| / |b|`` (the repo's bf16 tolerance; the
reference rounds ``x W1`` and ``x W3`` to bf16 where the port keeps them
in f32); the routing backward within 1e-5 with indices equal; the
Functions' CPU backward against autograd of the plain forward within 1e-5
(f32) and 5e-2 relative L2 (bf16: the backward rounds ``da`` and ``db``
to bf16 as the kernels do); AdamW within 1e-6, the schedule to f32
rounding; resume against a straight run bit for bit.
"""

import os
import shutil
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.ragged_moe_ffn import ragged_tile_metadata  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
ROUTE_TOL = 1e-5
BF16_TOL = 5e-2
ADAMW_TOL = 1e-6


def _np(t):
    return t.detach().float().cpu().numpy()


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _t(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


# ---------------------------------------------------------------------------
# plain backward versions against jax.vjp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sizes,D,F,bm", [
    ([5, 0, 13, 2], 16, 24, 8),        # an empty expert, sentinel tiles
    ([0, 0, 9], 8, 16, 8),             # two empty experts
    ([17, 3, 0, 30, 1], 24, 16, 16),   # bm 16, ragged tails
    ([16, 32], 16, 8, 16),             # full tiles
])
def test_ragged_ffn_bwd_ref_matches_jax_vjp(sizes, D, F, bm, dtype):
    rng = np.random.default_rng(len(sizes) * 100 + D + bm)
    E = len(sizes)
    sizes_t = torch.tensor(sizes, dtype=torch.int32)
    n_tiles = sum(sizes) // bm + E
    ro, tg = ragged_tile_metadata(sizes_t, bm, n_tiles)
    T = n_tiles * bm
    toks = np.zeros((T, D), np.float32)
    for e in range(E):
        toks[ro[e]:ro[e] + sizes[e]] = rng.standard_normal((sizes[e], D))
    w1 = rng.standard_normal((E, D, F)) / np.sqrt(D)
    w3 = rng.standard_normal((E, D, F)) / np.sqrt(D)
    w2 = rng.standard_normal((E, F, D)) / np.sqrt(F)
    dy = rng.standard_normal((T, D)).astype(np.float32)
    assert int((tg == E).sum()) > 0                     # sentinel tiles

    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = torch.float32 if dtype == "float32" else torch.bfloat16
    jtg = jnp.asarray(tg.numpy())
    args = [jnp.asarray(a, jd) for a in (w1, w3, w2, toks)]
    _, vjp = jax.vjp(lambda a, b, c, x: jref.ragged_moe_ffn_ref(a, b, c, x,
                                                                 jtg), *args)
    jg = vjp(jnp.asarray(dy, jd))
    dx, dw1, dw3, dw2 = ref.ragged_moe_ffn_bwd_ref(
        _t(w1, td), _t(w3, td), _t(w2, td), _t(toks, td), tg, _t(dy, td))
    for got, want in zip((dw1, dw3, dw2, dx), jg):
        assert got.dtype == td
        if dtype == "float32":
            np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                       rtol=F32_TOL, atol=F32_TOL)
        else:
            assert _rel(_np(got), want) <= BF16_TOL
    # an expert with no rows gets exact zeros; padding rows get zero dx
    for e in range(E):
        if sizes[e] == 0:
            assert not dw1[e].any() and not dw2[e].any()
    real = torch.zeros(T, dtype=torch.bool)
    for e in range(E):
        real[ro[e]:ro[e] + sizes[e]] = True
    assert not dx[~real].any()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("T,E,K", [(24, 8, 2), (40, 40, 8)])
def test_route_select_bwd_ref_matches_jax_vjp(T, E, K, masked):
    rng = np.random.default_rng(T + E + K + masked)
    D = 32
    x = rng.standard_normal((T, D)).astype(np.float32)
    w = (rng.standard_normal((D, E)) / np.sqrt(D)).astype(np.float32)
    rv = (rng.random(T) < 0.7) if masked else None
    dw = rng.standard_normal((T, K)).astype(np.float32)
    dm = rng.standard_normal(E).astype(np.float32)
    da = np.float32(rng.standard_normal())

    def jf(xj, wj):
        weights, idx, mean_prob = jmoe.route(wj, xj, K)
        rvj = None if rv is None else jnp.asarray(rv)
        if rvj is not None:
            weights = weights * rvj[:, None].astype(weights.dtype)
        tally = jmoe._masked_tally(idx, E, rvj)
        return (weights, mean_prob, jmoe._aux_loss(tally, mean_prob, E)), idx

    _, vjp, jidx = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w), has_aux=True)
    jdx, jdw = vjp((jnp.asarray(dw), jnp.asarray(dm), jnp.asarray(da)))

    slots_of = torch.arange(E, dtype=torch.int32)[:, None]
    n_copies = torch.ones(E, dtype=torch.int32)
    cdf = torch.ones((E, 1))
    rv_t = None if rv is None else torch.from_numpy(rv)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    weights, idx, _, tally, _, _, probs = ref.route_select_ref(
        xt, wt, slots_of, n_copies, cdf, torch.tensor(0, dtype=torch.int32),
        K, rv_t, with_probs=True)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    dx, dwr = ref.route_select_bwd_ref(
        xt, wt, probs, idx, weights, tally, torch.from_numpy(dw),
        torch.from_numpy(dm), torch.tensor(da), rv_t)
    np.testing.assert_allclose(_np(dx), np.asarray(jdx), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(_np(dwr), np.asarray(jdw), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)


# ---------------------------------------------------------------------------
# the autograd Functions' CPU backward against autograd of the plain forward
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, BF16_TOL)])
def test_ragged_ffn_function_backward_equals_autograd_of_plain(dtype, tol):
    rng = np.random.default_rng(7)
    sizes, D, F, bm = [9, 0, 4, 20], 16, 24, 8
    E = len(sizes)
    n_tiles = sum(sizes) // bm + E
    ro, tg = ragged_tile_metadata(torch.tensor(sizes, dtype=torch.int32), bm,
                                  n_tiles)
    toks = torch.zeros((n_tiles * bm, D))
    for e in range(E):
        toks[ro[e]:ro[e] + sizes[e]] = torch.from_numpy(
            rng.standard_normal((sizes[e], D)).astype(np.float32))
    ws = [_t(rng.standard_normal(s) / np.sqrt(s[1]), dtype)
          for s in ((E, D, F), (E, D, F), (E, F, D))]
    dy = _t(rng.standard_normal(toks.shape), dtype)

    def grads(fn):
        ins = [t.clone().requires_grad_(True) for t in (*ws, toks.to(dtype))]
        fn(*ins, tg).backward(dy)
        return [t.grad for t in ins]

    got = grads(ops.ragged_moe_ffn)
    want = grads(ref.ragged_moe_ffn_ref)
    for g, w in zip(got, want):
        assert g.dtype == dtype
        assert _rel(_np(g), _np(w)) <= tol


@pytest.mark.parametrize("masked", [False, True])
def test_route_select_function_backward_equals_autograd_of_plain(masked):
    rng = np.random.default_rng(8)
    T, D, E, K = 30, 16, 8, 2
    x = torch.from_numpy(rng.standard_normal((T, D)).astype(np.float32))
    w = torch.from_numpy(
        (rng.standard_normal((D, E)) / 4).astype(np.float32))
    rv = torch.from_numpy(rng.random(T) < 0.6) if masked else None
    cw, cm = torch.randn((T, K)), torch.randn(E)
    tables = (torch.arange(E, dtype=torch.int32)[:, None],
              torch.ones(E, dtype=torch.int32), torch.ones((E, 1)))
    seed = torch.tensor(3, dtype=torch.int32)

    def grads(fn):
        xi, wi = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        out = fn(xi, wi, *tables, seed, K, rv)
        ((out[0] * cw).sum() + (out[4] * cm).sum() + 0.7 * out[5]).backward()
        return xi.grad, wi.grad, out[1]

    gx, gw, idx = grads(ops.route_select)
    px, pw, pidx = grads(ref.route_select_ref)
    assert torch.equal(idx, pidx)
    np.testing.assert_allclose(_np(gx), _np(px), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)
    np.testing.assert_allclose(_np(gw), _np(pw), rtol=ROUTE_TOL,
                               atol=ROUTE_TOL)


def test_buffer_fill_backward_is_the_gather_of_autograd():
    rng = np.random.default_rng(9)
    t, K, D, E, bm = 12, 2, 8, 4, 4
    xf = torch.from_numpy(rng.standard_normal((t, D)).astype(np.float32))
    slots = torch.from_numpy(np.stack([rng.choice(E, K, replace=False)
                                       for _ in range(t)]).astype(np.int32))
    order, rows, _, n_rows, _, _ = tmoe._ragged_plan(slots.reshape(-1), E, bm)
    rows = rows.long()
    src = torch.div(order, K, rounding_mode="floor")
    row_full = torch.empty_like(rows)
    row_full[order] = rows
    dbuf = torch.randn((n_rows, D))
    a = xf.clone().requires_grad_(True)
    tmoe._FillBuffer.apply(a, rows, src, row_full.reshape(t, K),
                           n_rows).backward(dbuf)
    b = xf.clone().requires_grad_(True)
    buf = b.new_zeros((n_rows + 1, D))
    buf[rows] = b[src]
    buf[:n_rows].backward(dbuf)
    np.testing.assert_allclose(_np(a.grad), _np(b.grad), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# AdamW, the schedule, the bridge of an optimizer state
# ---------------------------------------------------------------------------

def _tree_np(rng, dtype):
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    return {"a": jnp.asarray(rng.standard_normal((6, 5)), jd),
            "b": [jnp.asarray(rng.standard_normal((3,)), jnp.float32),
                  jnp.asarray(rng.standard_normal((2, 2, 4)), jd)]}


@pytest.mark.parametrize("master", [True, False])
def test_adamw_step_matches_jax_with_the_clip_active(master):
    rng = np.random.default_rng(10)
    cfg = jopt.AdamWConfig(master_fp32=master)
    tcfg = topt.AdamWConfig(master_fp32=master)
    jp = _tree_np(rng, "bfloat16")
    jg = jax.tree.map(lambda p: (100 * p).astype(p.dtype), _tree_np(rng,
                                                                 "bfloat16"))
    assert float(jopt.global_norm(jg)) > 10 * cfg.grad_clip   # clip active
    js = jopt.adamw_init(jp, cfg)
    # a state two steps in, so the moments and the master are not trivial
    for _ in range(2):
        jp, js = jopt.adamw_update(jg, js, jp, cfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tg = params_from_numpy(jax.tree.map(np.asarray, jg))
    ts = topt.OptState(*params_from_numpy(jax.tree.map(np.asarray, js)))
    assert (ts.master is None) == (not master)
    lr = jopt.cosine_lr(cfg, js.step, warmup=2, total=10)
    jp2, js2 = jopt.adamw_update(jg, js, jp, cfg, lr)
    tp2, ts2 = topt.adamw_update(tg, ts, tp, tcfg,
                                 topt.cosine_lr(tcfg, ts.step, warmup=2,
                                                total=10))
    assert int(ts2.step) == int(js2.step) == 3
    pairs = [(tp2, jp2), (ts2.mu, js2.mu), (ts2.nu, js2.nu)]
    if master:
        pairs.append((ts2.master, js2.master))
    for t_tree, j_tree in pairs:
        for a, b in zip(leaves(t_tree), jax.tree.leaves(j_tree)):
            np.testing.assert_allclose(_np(a), np.asarray(b, np.float32),
                                       rtol=ADAMW_TOL, atol=ADAMW_TOL)


def test_cosine_lr_matches_jax():
    cfg, tcfg = jopt.AdamWConfig(), topt.AdamWConfig()
    for s in (0, 50, 100, 5000):
        j = float(jopt.cosine_lr(cfg, jnp.int32(s)))
        t = float(topt.cosine_lr(tcfg, torch.tensor(s, dtype=torch.int32)))
        assert t == pytest.approx(j, rel=1e-6, abs=1e-12)


def test_global_norm_matches_jax_across_slices(monkeypatch):
    rng = np.random.default_rng(11)
    jt = _tree_np(rng, "float32")
    tt = params_from_numpy(jax.tree.map(np.asarray, jt))
    want = float(jopt.global_norm(jt))
    # slices of 8 elements: the sum runs over several pieces of a leaf
    monkeypatch.setattr(topt, "_SLICE", 8)
    assert float(topt.global_norm(tt)) == pytest.approx(want, rel=1e-6)


def test_bridge_carries_an_adamw_state():
    p = {"w": jnp.ones((4, 4), jnp.bfloat16), "n": [jnp.zeros((3,))]}
    for master in (True, False):
        js = jopt.adamw_init(p, jopt.AdamWConfig(master_fp32=master))
        ts = params_from_numpy(jax.tree.map(np.asarray, js))
        assert type(ts) is type(js)
        assert ts.step.dtype == torch.int32 and int(ts.step) == 0
        assert ts.mu["w"].dtype == torch.float32
        assert (ts.master is None) == (not master)
        if master:
            assert ts.master["w"].dtype == torch.float32


# ---------------------------------------------------------------------------
# checkpoints and the train driver on the CPU
# ---------------------------------------------------------------------------

def test_checkpoint_round_trip_ignores_tmp_and_keep_prunes(tmp_path):
    tree = {"a": torch.arange(24, dtype=torch.bfloat16).reshape(6, 4),
            "b": {"c": torch.tensor(3.5), "d": torch.arange(5,
                                                            dtype=torch.int32)},
            "s": topt.OptState(torch.tensor(2, dtype=torch.int32),
                               [torch.ones(2)], [torch.zeros(2)], None)}
    d = str(tmp_path)
    tckpt.save_checkpoint(d, 7, tree, extras={"k": 1}, n_shards=3)
    os.makedirs(os.path.join(d, "ckpt_9.tmp"))             # a crashed save
    assert tckpt.latest_step(d) == 7
    like = {"a": torch.zeros((6, 4), dtype=torch.bfloat16),
            "b": {"c": torch.tensor(0.0),
                  "d": torch.zeros(5, dtype=torch.int32)},
            "s": topt.OptState(torch.tensor(0, dtype=torch.int32),
                               [torch.zeros(2)], [torch.ones(2)], None)}
    back, extras = tckpt.load_checkpoint(d, 7, like)
    assert extras == {"k": 1}
    for a, b in zip(leaves(back), leaves(tree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert back["s"].master is None and isinstance(back["s"], topt.OptState)
    ck = tckpt.Checkpointer(d, keep=2)                      # clean() on open
    assert not os.path.exists(os.path.join(d, "ckpt_9.tmp"))
    for s in (10, 20, 30):
        ck.save(s, tree)
    ck.wait()
    assert sorted(os.listdir(d)) == ["ckpt_20", "ckpt_30"]
    assert ck.restore_latest(like)[0] == 30


def test_async_save_writes_the_tree_as_it_was_at_save(tmp_path,
                                                      monkeypatch):
    """The background write sees the values of the call to ``save``, not
    the in-place updates made after it (on the CPU a leaf's ``.cpu()`` is
    the leaf itself)."""
    tree = {"w": torch.arange(6, dtype=torch.bfloat16),
            "m": torch.ones(3)}
    gate = threading.Event()
    write = tckpt._write_snapshot

    def held(*args):
        assert gate.wait(30)
        return write(*args)

    monkeypatch.setattr(tckpt, "_write_snapshot", held)
    ck = tckpt.Checkpointer(str(tmp_path))
    ck.save(1, tree)
    tree["w"].add_(100)                     # the next step, in place
    tree["m"].mul_(-3)
    gate.set()
    ck.wait()
    like = {"w": torch.zeros(6, dtype=torch.bfloat16), "m": torch.zeros(3)}
    back, _ = tckpt.load_checkpoint(str(tmp_path), 1, like)
    assert torch.equal(back["w"], torch.arange(6, dtype=torch.bfloat16))
    assert torch.equal(back["m"], torch.ones(3))


ARCH = "granite-moe-3b-a800m"


def test_train_driver_resume_equals_a_straight_run(tmp_path):
    kw = dict(seq_len=16, batch=2, device="cpu", log_every=100)
    p_straight, o_straight, l_straight, _ = ttrain.train(ARCH, steps=4, **kw)
    d = str(tmp_path / "ck")
    _, _, l_first, _ = ttrain.train(ARCH, steps=2, ckpt_dir=d, **kw)
    p_resumed, o_resumed, l_rest, _ = ttrain.train(ARCH, steps=4, ckpt_dir=d,
                                                   **kw)
    assert l_first + l_rest == l_straight                  # bit for bit
    for a, b in zip(leaves((p_resumed, o_resumed)),
                    leaves((p_straight, o_straight))):
        assert torch.equal(a, b)


def test_train_driver_resume_from_a_mid_run_async_save(tmp_path,
                                                      monkeypatch):
    """A checkpoint saved on the background thread while training goes on
    (``ckpt_every`` < ``steps``) resumes to the straight run, bit for
    bit. The write is delayed so that the next step's update comes first."""
    kw = dict(seq_len=16, batch=2, device="cpu", log_every=100)
    p_straight, o_straight, l_straight, _ = ttrain.train(ARCH, steps=4, **kw)
    write = tckpt._write_snapshot

    def late(*args):
        time.sleep(0.5)
        return write(*args)

    monkeypatch.setattr(tckpt, "_write_snapshot", late)
    d = str(tmp_path / "ck")
    _, _, l_saving, _ = ttrain.train(ARCH, steps=4, ckpt_dir=d,
                                     ckpt_every=2, **kw)
    assert sorted(os.listdir(d)) == ["ckpt_2", "ckpt_4"]
    shutil.rmtree(os.path.join(d, "ckpt_4"))
    p_resumed, o_resumed, l_rest, _ = ttrain.train(ARCH, steps=4, ckpt_dir=d,
                                                   **kw)
    assert l_saving == l_straight and l_saving[2:] == l_rest
    for a, b in zip(leaves((p_resumed, o_resumed)),
                    leaves((p_straight, o_straight))):
        assert torch.equal(a, b)


def test_train_driver_loss_falls_on_the_host():
    cfg = t_get_smoke(ARCH)
    params, _, losses, tallies = ttrain.train(
        ARCH, steps=10, seq_len=32, batch=4, device="cpu", log_every=100)
    assert all(np.isfinite(losses)) and len(losses) == 10
    assert tallies.shape == (cfg.n_layers, cfg.n_experts)
    assert tallies.sum() == 10 * 4 * 32 * cfg.top_k * cfg.n_layers
    from repro_torch.training import DataConfig, synthetic_batch
    b = {k: torch.as_tensor(v) for k, v in synthetic_batch(
        cfg, DataConfig(seq_len=32, global_batch=4), 0).items()}
    with torch.no_grad():
        after = float(tmodel.loss_fn(cfg)(params, b,
                                          tmodel.make_moe_tables(cfg))[0])
    assert after < losses[0]          # the first batch, before and after


def test_train_driver_state_is_freed_without_the_garbage_collector():
    """Dropping the returned params and state frees them at once: no
    reference cycle (a self-calling closure in a tree walk) keeps them for
    the collector, which at full width held 50 GiB on the card."""
    import gc
    import weakref
    gc.disable()
    try:
        p, o, _, _ = ttrain.train(ARCH, steps=1, seq_len=16, batch=2,
                                  device="cpu", log_every=100)
        refs = [weakref.ref(t) for t in leaves((p, o))]
        del p, o
        assert sum(r() is not None for r in refs) == 0
    finally:
        gc.enable()


def test_train_driver_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA device"):
        ttrain.train(ARCH, steps=1)


def test_capacity_gradients_on_the_host_run_plain_versions():
    """On the CPU the capacity bodies train through their plain versions:
    the capacity FFN's autograd Function (``ops.FusedMoeFFN``) runs the
    plain forward and ``moe_ffn_bwd_ref``, as the card runs the bucket
    kernels."""
    cfg = t_get_smoke(ARCH)
    gen = torch.Generator().manual_seed(0)
    params = tmodel.init_params(cfg, gen, dtype=torch.float32)
    for p in leaves(params):
        p.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab, (2, 8), generator=gen)
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1)
    loss, _ = tmodel.loss_fn(cfg, rules)(
        params, {"tokens": tok, "labels": tok.roll(-1, 1)},
        tmodel.make_moe_tables(cfg, rules))
    loss.backward()
    assert all(torch.isfinite(p.grad).all() for p in leaves(params))
