"""The port's chunked attention against the reference's, on the CPU.

``repro_torch.models.flash`` (the plain versions of the attention kernels)
against ``repro.models.flash`` run directly, on seeded numpy inputs in f32,
with small ``q_chunk`` / ``kv_chunk`` and lengths that are no chunk
multiple, so that the online softmax crosses several chunks in both
dimensions and the padding runs. Tolerance: a relative L2 error of 1e-5,
``|a - b| / |b|``, for outputs, stats and gradients (both sides take the
same f32 steps in another summation order). The backward that the card
runs after the kernel's forward (``flash_attention_bwd``, from the
output and the rows' softmax stats) is held against ``jax.grad`` the
same way. Then the dispatch on ``meta``: the plain version with a
checkpoint a key chunk, and the kernel's forward with that backward,
never allocate more than one chunk pair's scores; a call without a
gradient allocates what the kernel's wrapper allocates and reports one
cost entry. The kernels themselves run on the card only
(``tests/test_torch_gpu.py``, marked ``gpu``).
"""

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.models import flash as jflash  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import flash as kflash  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch.cost_analysis import count_costs  # noqa: E402
from repro_torch.models import decode_fn, init_cache, init_params  # noqa: E402
from repro_torch.models import flash as tflash  # noqa: E402
from repro_torch.models import make_moe_tables, prefill_fn  # noqa: E402

torch.set_num_threads(1)

REL = 1e-5        # relative L2, f32 on both sides
B, KV, G, HD = 2, 2, 3, 8
QC, KC = 8, 16    # chunks small enough that 37 or 45 rows span several


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def _np(t):
    return t.detach().float().numpy()


def _inputs(seed, Sq, Skv, b=B):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, Sq, KV, G, HD)).astype(np.float32)
    k = rng.standard_normal((b, Skv, KV, HD)).astype(np.float32)
    v = rng.standard_normal((b, Skv, KV, HD)).astype(np.float32)
    return q, k, v


# (causal, window, Sq, Skv, q_positions, kv_valid): the prefill call sites'
# mask kinds — whole prompt, a window, an encoder with a fill mask, context
# mode's rows against every key, a chunk against a lane's cache
CASES = {
    "causal": (True, None, 37, 37, None, None),
    "window": (True, 5, 37, 37, None, None),
    "window-0": (True, 0, 37, 37, None, None),
    "encoder-kv_valid": (False, None, 37, 37, None, 29),
    "context-rows": (True, None, 13, 45, (20, 33), None),
    "chunk-vs-cache": (True, 7, 11, 45, (24, 35), 35),
    "window-kv_valid": (True, 4, 37, 37, None, 30),
}


def _case(name):
    causal, window, Sq, Skv, rows, n_valid = CASES[name]
    qpos = (np.arange(Sq) if rows is None else np.arange(*rows)).astype(
        np.int32)
    kpos = np.arange(Skv, dtype=np.int32)
    kval = None if n_valid is None else kpos < n_valid
    return causal, window, Sq, Skv, qpos, kpos, kval


def _ref_attention(q, k, v, causal, window, qpos, kpos, kval):
    return jflash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=None if window is None else jnp.int32(window),
        q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
        kv_valid=None if kval is None else jnp.asarray(kval),
        q_chunk=QC, kv_chunk=KC)


def _port_attention(q, k, v, causal, window, qpos, kpos, kval):
    return tflash.flash_attention(
        q, k, v, causal=causal, window=window,
        q_positions=torch.from_numpy(qpos),
        kv_positions=torch.from_numpy(kpos),
        kv_valid=None if kval is None else torch.from_numpy(kval),
        q_chunk=QC, kv_chunk=KC)


@pytest.mark.parametrize("name", sorted(CASES))
def test_attention_across_chunks_matches_reference(name):
    causal, window, Sq, Skv, qpos, kpos, kval = _case(name)
    q, k, v = _inputs(0, Sq, Skv)
    want = _ref_attention(q, k, v, causal, window, qpos, kpos, kval)
    got = _port_attention(*map(torch.from_numpy, (q, k, v)), causal, window,
                          qpos, kpos, kval)
    assert got.shape == (B, Sq, KV, G, HD) and got.dtype == torch.float32
    assert _rel(_np(got), want) <= REL


@pytest.mark.parametrize("name", ["causal", "window", "context-rows",
                                  "chunk-vs-cache"])
def test_attention_gradients_match_reference(name):
    """Gradients of q, k and v through the per-chunk checkpoint against
    ``jax.grad`` of the reference (its ``jax.checkpoint`` a chunk pair)."""
    causal, window, Sq, Skv, qpos, kpos, kval = _case(name)
    q, k, v = _inputs(1, Sq, Skv)
    w = np.random.default_rng(2).standard_normal(
        (B, Sq, KV, G, HD)).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(_ref_attention(q_, k_, v_, causal, window, qpos, kpos,
                                      kval) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = _port_attention(*ts, causal, window, qpos, kpos, kval)
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        assert _rel(_np(t.grad), g) <= REL


def _ref_grads(q, k, v, w, causal, window, qpos, kpos, kval):
    def loss(q_, k_, v_):
        return jnp.sum(_ref_attention(q_, k_, v_, causal, window, qpos, kpos,
                                      kval) * w)

    return jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_backward_from_stats_matches_reference(name):
    """``flash_attention_bwd`` from the forward's output and rows' stats
    (``return_stats``), across several chunks in both dimensions, against
    ``jax.grad`` of the reference; ``encoder-kv_valid`` and
    ``window-kv_valid`` hold rows that keep few keys, and the chunk case
    rows with no valid key outside its lane."""
    causal, window, Sq, Skv, qpos, kpos, kval = _case(name)
    q, k, v = _inputs(6, Sq, Skv)
    w = np.random.default_rng(7).standard_normal(
        (B, Sq, KV, G, HD)).astype(np.float32)
    want = _ref_grads(q, k, v, w, causal, window, qpos, kpos, kval)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=causal, window=window,
              q_positions=torch.from_numpy(qpos),
              kv_positions=torch.from_numpy(kpos),
              kv_valid=None if kval is None else torch.from_numpy(kval),
              q_chunk=QC, kv_chunk=KC)
    out, m, l = tflash.flash_attention(tq, tk, tv, return_stats=True, **kw)
    assert m.shape == l.shape == (B, KV, G, Sq)
    got = tflash.flash_attention_bwd(tq, tk, tv, out, torch.from_numpy(w),
                                     m, l, **kw)
    for t, g in zip(got, want):
        assert t.dtype == torch.float32
        assert _rel(_np(t), g) <= REL


@pytest.mark.parametrize("name", ["causal", "encoder-kv_valid",
                                  "context-rows"])
def test_function_gradients_match_reference(name):
    """``ops.FlashAttention`` (the card's gradient path: the kernel's
    forward, then ``flash_attention_bwd``) with its plain forward on the
    CPU, at the default chunks, against ``jax.grad``."""
    causal, window, Sq, Skv, qpos, kpos, kval = _case(name)
    q, k, v = _inputs(8, Sq, Skv)
    w = np.random.default_rng(9).standard_normal(
        (B, Sq, KV, G, HD)).astype(np.float32)

    def loss(q_, k_, v_):
        return jnp.sum(jflash.flash_attention(
            q_, k_, v_, causal=causal,
            window=None if window is None else jnp.int32(window),
            q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
            kv_valid=None if kval is None else jnp.asarray(kval)) * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = ops.FlashAttention.apply(
        *ts, causal, window, torch.from_numpy(qpos), torch.from_numpy(kpos),
        None if kval is None else torch.from_numpy(kval))
    (out * torch.from_numpy(w)).sum().backward()
    for t, g in zip(ts, want):
        assert _rel(_np(t.grad), g) <= REL


def test_row_without_a_valid_key_takes_the_reference_value():
    """Causal rows before the first valid key have no valid key: every key,
    the padding too, takes exp(_NEG - _NEG) = 1, so the row is sum(v) over
    the padded key count."""
    Sq = Skv = 37
    q, k, v = _inputs(3, Sq, Skv)
    pos = np.arange(Sq, dtype=np.int32)
    kval = pos >= 10
    want = _ref_attention(q, k, v, True, None, pos, pos, kval)
    got = _port_attention(*map(torch.from_numpy, (q, k, v)), True, None,
                          pos, pos, kval)
    assert _rel(_np(got), want) <= REL
    mean = v.sum(1) / tflash.padded_keys(Skv, KC)          # (B, KV, hd)
    np.testing.assert_allclose(_np(got)[:, :10],
                               np.broadcast_to(mean[:, None, :, None],
                                               (B, 10, KV, G, HD)),
                               rtol=1e-5, atol=1e-6)


def _decode_inputs(seed, S_max):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((3, KV, G, HD)).astype(np.float32)
    k = rng.standard_normal((3, S_max, KV, HD)).astype(np.float32)
    v = rng.standard_normal((3, S_max, KV, HD)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("window", [None, 0, 6])
@pytest.mark.parametrize("offset", [0, 11])
def test_decode_across_chunks_matches_reference(window, offset):
    """A 48-row cache walked in chunks of 16 (32 halved until it divides
    48), per-lane positions, a window and a shard's row offset; with
    ``return_stats`` the same (acc, m, l) as the reference wherever the
    lane has a valid row."""
    S_max, chunk = 48, 32
    q, k, v = _decode_inputs(4, S_max)
    pos = np.array([offset + 3, offset + 20, offset + 47], np.int32)
    args = [jnp.asarray(a) for a in (q, k, v, pos)]
    targs = [torch.from_numpy(a) for a in (q, k, v, pos)]
    kw = dict(window=window, kv_chunk=chunk, kpos_offset=offset)
    jw = dict(kw, window=None if window is None else jnp.int32(window))
    want = jflash.flash_decode(*args, **jw)
    got = tflash.flash_decode(*targs, **kw)
    assert _rel(_np(got), want) <= REL
    for a, b in zip(tflash.flash_decode(*targs, return_stats=True, **kw),
                    jflash.flash_decode(*args, return_stats=True, **jw)):
        assert _rel(_np(a), b) <= REL


def test_decode_stats_of_shards_merge_as_the_whole_cache():
    """Two shards of a 64-row cache, attended alone with ``return_stats``
    and merged as ``model._merge_decode`` merges them (max, rescale, sum),
    give the reference's decode over the whole cache. Lane 0's position
    lies in shard 0, so shard 1 holds no valid row of it: m = _NEG, l = 0,
    acc = 0 exactly."""
    S_max, n = 64, 32
    q, k, v = _decode_inputs(5, S_max)
    pos = np.array([9, 40, 63], np.int32)
    want = jflash.flash_decode(*(jnp.asarray(a) for a in (q, k, v, pos)),
                               window=jnp.int32(30), kv_chunk=16)
    tq, tk, tv, tpos = (torch.from_numpy(a) for a in (q, k, v, pos))
    stats = [tflash.flash_decode(tq, tk[:, r * n:(r + 1) * n],
                                 tv[:, r * n:(r + 1) * n], tpos, window=30,
                                 kv_chunk=16, kpos_offset=r * n,
                                 return_stats=True) for r in range(2)]
    acc1, m1, l1 = (t[0] for t in stats[1])
    assert bool((m1 == tflash._NEG).all()) and bool((l1 == 0).all())
    assert bool((acc1 == 0).all())
    m_g = torch.maximum(stats[0][1], stats[1][1])
    num = sum(acc * torch.exp(m - m_g)[..., None] for acc, m, _ in stats)
    den = sum(l * torch.exp(m - m_g) for _, m, l in stats)
    got = num / torch.clamp(den, min=1e-30)[..., None]
    assert _rel(_np(got), want) <= REL


# ---------------------------------------------------------------------------
# the dispatch on meta
# ---------------------------------------------------------------------------

class _Largest(TorchDispatchMode):
    """The largest tensor any operation allocates, in bytes."""

    def __init__(self):
        super().__init__()
        self.largest = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in out if isinstance(out, (tuple, list)) else (out,):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest,
                                   t.numel() * t.element_size())
        return out


def test_gradient_call_holds_one_chunk_pair_of_scores():
    """Forward and backward of a 200 x 200 call of the plain version that
    requires a gradient (a checkpoint a key chunk): no tensor larger than
    one (B, KV, G, q_chunk, kv_chunk) f32 score block, where one softmax
    over all keys would take (200 / 64)² times more."""
    Sq, qc, kc = 200, 64, 64
    q = torch.empty((1, Sq, 1, 2, HD), device="meta", requires_grad=True)
    k = torch.empty((1, Sq, 1, HD), device="meta", requires_grad=True)
    v = torch.empty((1, Sq, 1, HD), device="meta", requires_grad=True)
    with _Largest() as seen, count_costs() as c:
        out = tflash.flash_attention(q, k, v, q_chunk=qc, kv_chunk=kc)
        out.sum().backward()
    assert q.grad.shape == q.shape and v.grad.shape == v.shape
    pair = 1 * 1 * 2 * qc * kc * 4
    assert 0 < seen.largest <= pair < 2 * Sq * Sq * 4
    assert not c.kernel_calls


def test_gradient_dispatch_runs_the_kernel_then_chunk_pairs():
    """A call that requires a gradient off the CPU goes through
    ``FlashAttention``: one forward kernel call, its output and the f32
    stats kept, then the backward's two kernel calls (``flash_attn_bwd_dq``,
    ``flash_attn_bwd_dkdv``), whose entries count the five products of the
    plain backward over every pair (the scores again, dv, dp, dq, dk) and
    which allocate no tensor as large as a score block (what the plain
    backward's chunk pairs held: 512 x 1024 scores); nothing launches on
    meta. (The name is kept from when the backward ran the plain version's
    chunk pairs.)"""
    B_, Sq, kv, g, hd = 1, 1100, 1, 2, 64
    q = torch.empty((B_, Sq, kv, g, hd), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    k = torch.empty((B_, Sq, kv, hd), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    v = torch.empty_like(k, requires_grad=True)
    ops.reset_launch_counts()
    with _Largest() as seen, count_costs() as c:
        out = ops.flash_attention(q, k, v)
        fwd = c.flops
        out.float().sum().backward()
    assert q.grad.shape == q.shape and k.grad.dtype == torch.bfloat16
    assert c.kernel_calls == {"flash_attn_fwd": 1, "flash_attn_bwd_dq": 1,
                              "flash_attn_bwd_dkdv": 1}
    assert fwd == 4 * B_ * kv * g * Sq * Sq * hd
    assert c.flops - fwd == 10 * B_ * kv * g * Sq * Sq * hd
    assert c.kernel_flops["flash_attn_bwd_dq"] + c.kernel_flops[
        "flash_attn_bwd_dkdv"] == 10 * B_ * kv * g * Sq * Sq * hd
    # the largest: the test's own f32 copy of the output and its gradient
    assert seen.largest == q.numel() * 4
    assert seen.largest < B_ * kv * g * 512 * 1024 * 4
    assert all(n == 0 for n in ops.launch_counts().values())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_backward_call_allocates_gradients_and_scratch(dtype):
    """The backward's allocation helper on meta: dq, dk and dv in their
    inputs' shapes and dtypes; the scratch (each row's f32 D, a row
    block's f32 unseen-row sum and int64 bounds and flag, in row blocks of
    ``bwd_rows``: 64 rows, 32 in f32 at hd 128); one entry a kernel, whose
    FLOPs add up to the five products over every pair and whose bytes are
    each kernel's inputs read once and outputs and scratch written once."""
    Sq, Skv, hd = 24, 40, 128
    q = torch.empty((B, Sq, KV, G, hd), device="meta", dtype=dtype)
    k = torch.empty((B, Skv, KV, hd), device="meta", dtype=dtype)
    st = torch.empty((B, KV, G, Sq), device="meta")
    kpos = torch.empty(Skv, dtype=torch.int64, device="meta")
    rows = kflash.bwd_rows(dtype, hd)
    assert rows == (64 if dtype == torch.bfloat16 else 32)
    with count_costs(q, k, st, kpos) as c:
        (dq, dk, dv), scratch = kflash.attn_bwd_outputs(
            q, k, k, q, q, st, st, kv_positions=kpos, kind="meta")
    assert [(t.shape, t.dtype) for t in (dq, dk, dv)] == [
        (q.shape, dtype), (k.shape, dtype), (k.shape, dtype)]
    n = -(-Sq * G // rows)
    assert [(tuple(t.shape), t.dtype) for t in scratch] == [
        ((B, KV, Sq * G), torch.float32), ((B, KV, n, hd), torch.float32),
        ((B, KV, n, 3), torch.int64)]
    pairs = B * KV * G * Sq * Skv * hd
    assert c.kernel_calls == {"flash_attn_bwd_dq": 1,
                              "flash_attn_bwd_dkdv": 1}
    assert c.kernel_flops == {"flash_attn_bwd_dq": 6 * pairs,
                              "flash_attn_bwd_dkdv": 4 * pairs}
    size = torch.finfo(dtype).bits // 8
    qb, kb, sb = q.numel() * size, k.numel() * size, st.numel() * 4
    ins = 2 * qb + 2 * kb + 2 * sb + Skv * 8      # q, dout, k, v, m, l, kpos
    made = (B * KV * Sq * G + B * KV * n * hd) * 4 + B * KV * n * 3 * 8
    assert c.kernel_bytes == {"flash_attn_bwd_dq": ins + 2 * qb + made,
                              "flash_attn_bwd_dkdv": ins + made + 2 * kb}
    with pytest.raises(ValueError, match="m"):
        kflash.attn_bwd_outputs(q, k, k, q, q, st[..., :-1], st,
                                kind="meta")
    with pytest.raises(ValueError, match="48"):
        kflash.attn_bwd_outputs(q[..., :48], k[..., :48], k[..., :48],
                                q[..., :48], q[..., :48], st, st,
                                kind="meta")


def test_training_cell_on_meta_reports_each_backward_kernel_once_a_layer():
    """The dry run's training step of granite's smoke config on one
    device's grid, traced on meta: each layer's attention launches the
    forward twice (remat runs it again in the backward) and each backward
    kernel once."""
    from repro_torch.configs import ShapeSpec
    from repro_torch.launch import dryrun
    cfg = get_smoke("granite-moe-3b-a800m")
    ops.reset_launch_counts()
    c = dryrun.measure(cfg, ShapeSpec("t", 32, 2, "train"), (1, 1))["costs"]
    L = cfg.n_layers
    assert c.kernel_calls["flash_attn_bwd_dq"] == L
    assert c.kernel_calls["flash_attn_bwd_dkdv"] == L
    assert c.kernel_calls["flash_attn_fwd"] == 2 * L
    assert all(n == 0 for n in ops.launch_counts().values())


def test_decode_function_gradients_match_the_plain_version():
    """``ops.FlashDecode`` (the card's gradient path for a decode call)
    with its plain forward on the CPU: outputs and gradients of q and both
    caches equal to autograd of the plain version, with and without
    ``return_stats``."""
    S_max = 48
    q, k, v = _decode_inputs(10, S_max)
    pos = torch.tensor([3, 20, 47])
    for stats in (False, True):
        kw = dict(window=6, kpos_offset=0, return_stats=stats)
        grads = []
        for fn in (lambda *a: ops.FlashDecode.apply(*a, 6, 0, stats),
                   lambda *a: tflash.flash_decode(*a, **kw)):
            ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
            outs = fn(ts[0], ts[1], ts[2], pos)
            outs = outs if isinstance(outs, tuple) else (outs,)
            sum(o.sum() * (i + 1) for i, o in enumerate(outs)).backward()
            grads.append([_np(o) for o in outs] + [_np(t.grad) for t in ts])
        for a, b in zip(*grads):
            assert _rel(a, b) <= REL


def _blocks(n):
    return -(-n // 512) * 512


def test_prefill_call_allocates_the_output_and_reports_its_entry():
    Sq, Skv = 24, 40
    q = torch.empty((B, Sq, KV, G, 64), device="meta", dtype=torch.bfloat16)
    k = torch.empty((B, Skv, KV, 64), device="meta", dtype=torch.bfloat16)
    qpos = torch.empty(Sq, dtype=torch.int64, device="meta")
    kpos = torch.empty(Skv, dtype=torch.int64, device="meta")
    kval = torch.empty(Skv, dtype=torch.bool, device="meta")
    with count_costs(q, k, qpos, kpos, kval) as c:
        out = ops.flash_attention(q, k, k, q_positions=qpos,
                                  kv_positions=kpos, kv_valid=kval)
    nbytes = out.numel() * 2
    assert out.shape == q.shape and out.dtype == q.dtype
    assert c.kernel_calls == {"flash_attn_fwd": 1}
    assert c.kernel_flops["flash_attn_fwd"] == 4 * B * KV * G * Sq * Skv * 64
    assert c.kernel_bytes["flash_attn_fwd"] == (
        2 * nbytes + 2 * k.numel() * 2 + (Sq + Skv) * 8 + Skv)
    assert c.peak_bytes == _blocks(nbytes)


@pytest.mark.parametrize("stats", [False, True])
def test_decode_call_allocates_outputs_and_split_partials(stats):
    """A 1500-row cache takes 6 splits of 256 rows: the outputs, then the
    splits' f32 partials (written once and read back by the merge in the
    last split's block)."""
    S_max, b = 1500, 4
    q = torch.empty((b, KV, G, 128), device="meta", dtype=torch.bfloat16)
    kc = torch.empty((b, S_max, KV, 128), device="meta",
                     dtype=torch.bfloat16)
    pos = torch.empty(b, dtype=torch.int64, device="meta")
    n = kflash.decode_splits(S_max)
    assert n == 6
    with count_costs(q, kc, pos) as c:
        out = ops.flash_decode(q, kc, kc, pos, return_stats=stats)
    outs = list(out) if stats else [out]
    out_bytes = [t.numel() * t.element_size() for t in outs]
    scratch = [b * KV * n * G * 128 * 4, b * KV * n * G * 2 * 4]
    assert [t.shape for t in outs] == ([(b, KV, G, 128), (b, KV, G),
                                        (b, KV, G)] if stats
                                       else [(b, KV, G, 128)])
    assert c.kernel_calls == {"flash_decode": 1}
    assert c.kernel_flops["flash_decode"] == 4 * b * KV * G * S_max * 128
    assert c.kernel_bytes["flash_decode"] == (
        q.numel() * 2 + 2 * kc.numel() * 2 + b * 8 + sum(out_bytes)
        + 2 * sum(scratch))
    assert c.peak_bytes == sum(_blocks(x) for x in out_bytes + scratch)


@pytest.mark.parametrize("S_max,n", [(256, 1), (1024, 4), (32768, 32)])
def test_decode_scratch_of_one_split_and_of_many(S_max, n):
    """One split writes the output itself: no partials. Many: one f32
    partial (acc, m, l) a split, written once and read back once, in the
    cost entry and the call's allocations on meta."""
    b, hd = 8, 64
    q = torch.empty((b, KV, G, hd), device="meta", dtype=torch.bfloat16)
    kc = torch.empty((b, S_max, KV, hd), device="meta", dtype=torch.bfloat16)
    pos = torch.empty(b, dtype=torch.int64, device="meta")
    assert kflash.decode_splits(S_max) == n
    outs, scratch = kflash.decode_outputs(q, kc, kc, pos, kind="meta")
    assert outs.shape == (b, KV, G, hd)
    if n == 1:
        assert scratch is None
    else:
        assert [t.shape for t in scratch] == [(b, KV, n, G, hd),
                                              (b, KV, n, G, 2)]
        assert all(t.dtype == torch.float32 for t in scratch)
    scratch_bytes = 0 if n == 1 else b * KV * n * G * (hd + 2) * 4
    with count_costs(q, kc, pos) as c:
        ops.flash_decode(q, kc, kc, pos)
    assert c.kernel_calls == {"flash_decode": 1}
    assert c.kernel_bytes["flash_decode"] == (
        q.numel() * 2 + 2 * kc.numel() * 2 + b * 8 + q.numel() * 2
        + 2 * scratch_bytes)


@pytest.mark.parametrize("S_max", [1, 255, 256, 257, 1024, 1500, 8192,
                                   8193, 16384, 16385, 32768, 70000])
def test_decode_splits_depend_on_the_cache_length_alone(S_max):
    """The split length is a function of S_max alone (never of the lanes,
    the heads or the card): 256 rows up to 8192, then doubling up to 1024;
    the splits cover the cache, the last one not empty; a call's partials
    have that many splits whatever its batch."""
    rows = kflash.decode_split_rows(S_max)
    n = kflash.decode_splits(S_max)
    assert rows in (256, 512, 1024)
    assert rows == (256 if S_max <= 8192 else 512 if S_max <= 16384
                    else 1024)
    assert (n - 1) * rows < S_max <= n * rows
    for b, kv, g in ((1, 1, 1), (8, 8, 3), (3, 2, 16)):
        q = torch.empty((b, kv, g, 64), device="meta", dtype=torch.bfloat16)
        kc = torch.empty((b, S_max, kv, 64), device="meta",
                         dtype=torch.bfloat16)
        pos = torch.empty(b, dtype=torch.int64, device="meta")
        _, scratch = kflash.decode_outputs(q, kc, kc, pos, kind="meta")
        assert (1 if scratch is None else scratch[0].shape[2]) == n


@pytest.mark.parametrize("hd", kflash.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_prefill_route_depends_on_dtype_and_head_size_alone(hd, dtype):
    """Two routes: the Hopper route takes bf16, the tf32x3 route f32, at
    every head size of the table; a function of (dtype, hd) with no shape,
    batch or device among its inputs, so a chunk and the whole prompt, a
    rank and one device take the same route. A pair outside the table has
    no route."""
    import inspect
    assert list(inspect.signature(kflash.route_of).parameters) == [
        "dtype", "hd"]
    want = "tma" if dtype == torch.bfloat16 else "tf32x3"
    assert kflash.route_of(dtype, hd) == want
    with pytest.raises(ValueError, match=str(hd + 1)):
        kflash.route_of(dtype, hd + 1)
    with pytest.raises(ValueError):
        kflash.route_of(torch.float16, hd)


@pytest.mark.parametrize("hd,dtype,route", [
    (32, torch.bfloat16, "tma"), (80, torch.bfloat16, "tma"),
    (128, torch.float32, "tf32x3"), (256, torch.float32, "tf32x3")])
def test_prefill_on_meta_reports_the_entry_of_its_route(hd, dtype, route):
    """The pairs the retired general route took (bf16 at hd 32 and 80, f32
    at 128 and 256): on meta ``ops.flash_attention`` allocates the output
    and reports one ``flash_attn_fwd`` entry, the call's FLOPs and bytes,
    on the route ``route_of`` names for it; nothing launches."""
    Sq, Skv = 24, 40
    q = torch.empty((B, Sq, KV, G, hd), device="meta", dtype=dtype)
    k = torch.empty((B, Skv, KV, hd), device="meta", dtype=dtype)
    qpos = torch.empty(Sq, dtype=torch.int64, device="meta")
    kpos = torch.empty(Skv, dtype=torch.int64, device="meta")
    ops.reset_launch_counts()
    with count_costs(q, k, qpos, kpos) as c:
        out = ops.flash_attention(q, k, k, q_positions=qpos,
                                  kv_positions=kpos)
    size = q.element_size()
    assert kflash.route_of(dtype, hd) == route
    assert out.shape == q.shape and out.dtype == dtype
    assert c.kernel_calls == {"flash_attn_fwd": 1}
    assert c.kernel_flops["flash_attn_fwd"] == 4 * B * KV * G * Sq * Skv * hd
    assert c.kernel_bytes["flash_attn_fwd"] == (
        2 * out.numel() * size + 2 * k.numel() * size + (Sq + Skv) * 8)
    assert all(n == 0 for n in ops.launch_counts().values())
    assert kflash.flash_attn_fwd.tma_launches == 0
    assert kflash.flash_attn_fwd.tf32x3_launches == 0


@pytest.mark.parametrize("hd,dtype", [(48, torch.bfloat16),
                                      (64, torch.float16),
                                      (96, torch.float32)])
def test_kernel_checks_refuse_head_size_or_dtype(hd, dtype):
    """What the kernels do not take raises, naming the shape: the checks
    the CUDA wrapper runs before it launches, here on meta."""
    q = torch.empty((1, 4, 1, 2, hd), device="meta", dtype=dtype)
    k = torch.empty((1, 4, 1, hd), device="meta", dtype=dtype)
    with pytest.raises(ValueError, match=str(hd)):
        ops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match=str(hd)):
        ops.flash_decode(q[:, 0], k, k, torch.zeros(1, dtype=torch.int64,
                                                    device="meta"))


def test_model_reaches_the_kernels_once_a_layer():
    """granite smoke on meta: a prefill calls ``flash_attn_fwd`` once an
    attention layer and a decode step ``flash_decode`` once; nothing
    launches."""
    cfg = get_smoke("granite-moe-3b-a800m")
    dev = torch.device("meta")
    gen = torch.Generator().manual_seed(0)
    params = init_params(cfg, gen, device="cpu")
    params = {k: v for k, v in params.items()}
    from repro_torch.tree import tree_map
    params = tree_map(lambda t: t.to(dev), params)
    tables = tree_map(lambda t: t.to(dev), make_moe_tables(cfg))
    tokens = torch.zeros((2, 16), dtype=torch.int32, device=dev)
    ops.reset_launch_counts()
    with count_costs() as c:
        _, cache, _ = prefill_fn(cfg)(params, {"tokens": tokens}, tables)
    assert c.kernel_calls["flash_attn_fwd"] == cfg.n_layers
    full = init_cache(cfg, 2, 32, dtype=torch.bfloat16, device=dev)
    with count_costs() as c:
        decode_fn(cfg)(params, tokens[:, :1], full,
                       torch.zeros(2, dtype=torch.int64, device=dev), tables)
    assert c.kernel_calls["flash_decode"] == cfg.n_layers
    assert "flash_attn_fwd" not in c.kernel_calls
    assert all(n == 0 for n in ops.launch_counts().values())


def test_wrappers_refuse_cpu_tensors():
    """The CUDA wrappers launch or raise: a CPU tensor never reaches a
    launch (``ops`` sends it to the plain version instead)."""
    q = torch.zeros((1, 4, 1, 2, 64))
    k = torch.zeros((1, 4, 1, 64))
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_attn_fwd(q, k, k)
    with pytest.raises(ValueError, match="CUDA"):
        kflash.flash_decode(q[:, 0], k, k, torch.zeros(1, dtype=torch.int64))
    assert kflash.flash_attn_fwd.launches == kflash.flash_decode.launches == 0


ATTN_REL_F32 = 1e-4   # the f32 route's bound on the card (chip_smoke.py)


def _tf32(x):
    """x with the low 13 mantissa bits masked: a TF32 value."""
    return (x.view(torch.int32) & -8192).view(torch.float32)


def _route_mm(a, b, products):
    """a @ b as the tf32x3 route takes it: each f32 operand split into big
    (masked) and small (x - big, masked), three TF32 products accumulated
    in f32, small.big, big.small, big.big; or one, big.big."""
    ab, bb = _tf32(a), _tf32(b)
    if products == 1:
        return ab @ bb
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


def _route_attention(q, k, v, products, causal, window, tile):
    """The tf32x3 route's arithmetic on CPU tensors: rows (s, g) of each
    (lane, KV head), ``tile``-key tiles from key 0, the online softmax in
    base 2 with the difference first (m the running max of q.k, p =
    2^((q.k - m) scale log2 e)), a masked pair -inf, S and P V each by
    ``_route_mm``."""
    B, Sq, KV, G, hd = q.shape
    Skv = k.shape[1]
    c2 = tflash._scale(hd) * float(np.log2(np.e))
    qr = q.permute(0, 2, 1, 3, 4).reshape(B, KV, Sq * G, hd)
    kr, vr = (t.permute(0, 2, 1, 3) for t in (k, v))
    qp = torch.arange(Sq).repeat_interleave(G)[:, None]
    m = torch.full((B, KV, Sq * G, 1), tflash._NEG)
    l = torch.zeros((B, KV, Sq * G, 1))
    o = torch.zeros((B, KV, Sq * G, hd))
    for t0 in range(0, Skv, tile):
        kp = torch.arange(t0, min(t0 + tile, Skv))[None, :]
        ok = torch.ones((Sq * G, kp.shape[1]), dtype=torch.bool)
        if causal:
            ok &= kp <= qp
        if window:
            ok &= qp - kp < window
        s = _route_mm(qr, kr[:, :, t0:t0 + tile].transpose(-1, -2),
                      products).masked_fill(~ok, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp2((m - m_new) * c2)
        p = torch.exp2((s - m_new) * c2)
        l = l * corr + p.sum(-1, keepdim=True)
        o = o * corr + _route_mm(p, vr[:, :, t0:t0 + tile], products)
        m = m_new
    out = o / l.clamp(min=1e-30)
    return out.reshape(B, KV, Sq, G, hd).permute(0, 2, 1, 3, 4)


@pytest.mark.parametrize("hd,tile", [(80, 64), (128, 64), (256, 32)])
@pytest.mark.parametrize("causal,window", [(False, 0), (True, 100)])
def test_tf32x3_products_hold_the_f32_bound_where_one_tf32_product_fails(
        causal, window, hd, tile):
    """The tf32x3 route's arithmetic, emulated at each head size of its two
    kernels' shapes (hd 80, hubert-xlarge's, on ``attn_fwd_tf32x3`` with
    64-key tiles; 128 and 256 on ``attn_fwd_tf32x3_wide`` with 64- and
    32-key tiles; hubert's encoder has no causal mask, the route also takes
    causal and windowed calls) against the plain version in f32: each
    operand split in registers into big (its top 19 bits, masked) and
    small (the rest, masked), as the kernels split them; each row's
    relative L2 error within the f32 route's ATTN_REL_F32 (1e-4) with three
    TF32 products for S and P V, and far outside it with one (a row reads
    ~2e-6 and ~3e-3 at hd 80)."""
    rng = np.random.default_rng(29)
    B, Sq, KV, G = 1, 192, 4, 1
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)) for shape in ((B, Sq, KV, G, hd), (B, Sq, KV, hd),
                                   (B, Sq, KV, hd)))
    pos = torch.arange(Sq)
    want = tflash.flash_attention(q, k, v, causal=causal, window=window,
                                  q_positions=pos, kv_positions=pos)

    def row_rel(got):
        d = (got - want).flatten(0, -2).norm(dim=-1)
        return (d / want.flatten(0, -2).norm(dim=-1)).max().item()

    three = row_rel(_route_attention(q, k, v, 3, causal, window, tile))
    one = row_rel(_route_attention(q, k, v, 1, causal, window, tile))
    assert three <= ATTN_REL_F32 / 10, three
    assert one > ATTN_REL_F32, one
