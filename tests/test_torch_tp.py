"""Tensor parallelism of the port's dense layers on gloo ranks, at smoke
size (f32), against the reference's mesh runs and the single-rank port.

The three cases of ``tests/_torch_tp_ranks.py`` — granite on (2, 2) split
by heads with the dense weights FSDP-sliced and a vocab-parallel
embedding; granite on (1, 4) in context mode; smollm-360m on (1, 2) from
``make_rules`` (context mode, a tied vocab-parallel embedding, the dense
MLP split) — each run the loss and its gradients (each rank's slice),
the prefill and three decode steps; each output is held against the
reference's run of the same functions on a mesh of fake devices (one
subprocess for the file) and against the single-rank port: tallies
exactly, logits, loss and every gradient leaf within ``F32_TOL``
(tests/test_torch_ep_model.py's).

Beside them, on one process: ``flash_decode``'s stats merged over
sequence shards, the heads split's (KV, G) pairing, ``shard_params``
round trips of every leaf kind, ``rank_cache`` against the reference's
``cache_specs``, checkpoint restore onto a grid, and ``max_over``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_tp_ranks as h  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.launch.sharding import cache_specs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (make_rules,  # noqa: E402
                                         rank_cache, shard_params)
from repro_torch.models import collectives  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.flash import _NEG, flash_decode  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.training import checkpoint  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)


def _rules(name, rank, phase="train"):
    """Case ``name``'s rules for ``rank``, placed by a grid object without
    a process group."""
    return h.port_rules(name, Grid(h.CASES[name][1], h.AXES, rank, {}),
                        phase)


@pytest.fixture(scope="module")
def trees():
    out = {}
    for name, (arch, *_) in h.CASES.items():
        jp = jmodel.init_params(get_smoke(arch), jax.random.PRNGKey(0),
                                dtype=jnp.float32)
        out[name] = jax.tree.map(np.asarray, jp)
    return out


@pytest.fixture(scope="module")
def single(trees):
    """The single-rank port on each case's weights (granite once, with its
    loss)."""
    granite = h.single("heads", trees["heads"])
    return {"heads": granite, "context": granite,
            "smollm": h.single("smollm", trees["smollm"])}


@pytest.fixture(scope="module")
def runs(trees, single, tmp_path_factory):
    d = tmp_path_factory.mktemp("tp")
    caches = {name: single[name]["whole_cache"] for name in h.CASES}
    np.savez(d / "caches.npz", **{
        f"{name}/{kv}/{i}": c[j] for name, cache in caches.items()
        for i, c in enumerate(cache) for j, kv in enumerate("kv")})
    path = str(d / "ref.npz")
    proc = ep.start_reference("_torch_tp_ranks.jax_tp", path, 8,
                              str(d / "caches.npz"))
    try:
        ranks = {}
        for world, names in h.WORLDS.items():
            res = run_ranks(h.tp_rank, world, args=(names, trees, caches),
                            timeout_s=300)
            for name in names:
                ranks[name] = [r[name] for r in res]
    except BaseException:
        proc.kill()
        raise
    return ranks, ep.wait_reference(proc, path)


def _jax_grads(ref, key, tree):
    n = len(jax.tree.leaves(tree))
    return params_from_numpy(jax.tree.unflatten(
        jax.tree.structure(tree), [ref[f"{key}grad/{i}"] for i in range(n)]))


@pytest.mark.parametrize("name", ["heads", "smollm"])
def test_loss_and_gradients_match_single_rank_and_jax_mesh(runs, single,
                                                           trees, name):
    ranks, ref = runs
    cfg = t_get_smoke(h.CASES[name][0])
    one = single[name]
    jgrads = _jax_grads(ref, f"{name}/", trees[name])
    sgrads = params_from_numpy(jax.tree.unflatten(
        jax.tree.structure(trees[name]), one["grads"]))
    for r, out in enumerate(ranks[name]):
        assert out["loss"] == ranks[name][0]["loss"]
        np.testing.assert_allclose(out["loss"], one["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(out["loss"], float(ref[f"{name}/loss"]),
                                   rtol=F32_TOL)
        np.testing.assert_array_equal(out["train_tallies"],
                                      one["train_tallies"])
        np.testing.assert_array_equal(out["train_tallies"],
                                      ref[f"{name}/train_tallies"])
        rules = _rules(name, r)
        want = leaves(shard_params(cfg, sgrads, rules, "train"))
        want_j = leaves(shard_params(cfg, jgrads, rules, "train"))
        assert len(out["grads"]) == len(want)
        for i, (g, w, wj) in enumerate(zip(out["grads"], want, want_j)):
            assert g.shape == tuple(w.shape), (r, i)
            assert _rel(g, w.numpy()) <= F32_TOL, (r, i, _rel(g, w.numpy()))
            assert _rel(g, wj.numpy()) <= F32_TOL, (r, i,
                                                    _rel(g, wj.numpy()))


@pytest.mark.parametrize("name", list(h.CASES))
def test_prefill_matches_single_rank_and_jax_mesh(runs, single, name):
    ranks, ref = runs
    cfg = t_get_smoke(h.CASES[name][0])
    one = single[name]
    for r, out in enumerate(ranks[name]):
        lg, tal = out["prefill"]
        np.testing.assert_array_equal(tal, one["prefill"][1])
        np.testing.assert_array_equal(tal, ref[f"{name}/prefill/tallies"])
        _close(lg, one["prefill"][0])
        _close(lg, ref[f"{name}/prefill/logits"])
        # the returned cache is the rank's decode layout over the S rows:
        # its KV heads split by heads, whole in context mode
        whole = [tuple(torch.from_numpy(t) for t in c)
                 for c in one["prefill_cache"]]
        rules = _rules(name, r, "prefill")
        want = (whole if rules.attn_mode == "context"
                else rank_cache(cfg, whole, rules))
        for got, w in zip(out["prefill_cache"], want):
            for a, b in zip(got, w):
                assert a.shape == tuple(b.shape)
                _close(a, b.numpy())


@pytest.mark.parametrize("name", list(h.CASES))
def test_decode_matches_single_rank_and_jax_mesh(runs, single, name):
    ranks, ref = runs
    one = single[name]
    for out in ranks[name]:
        for i, (lg, tal) in enumerate(out["decode"]):
            np.testing.assert_array_equal(tal, one["decode"][i][1])
            np.testing.assert_array_equal(tal,
                                          ref[f"{name}/decode/{i}/tallies"])
            _close(lg, one["decode"][i][0])
            _close(lg, ref[f"{name}/decode/{i}/logits"])


def test_remat_with_tp_keeps_loss_and_gradients_bit_for_bit(runs):
    """On the (2, 2) grid, heads split and the dense weights FSDP-gathered
    inside each checkpointed block: the recompute's collectives run in the
    same order on every rank, and the loss and every gradient equal those
    without remat."""
    ranks, _ = runs
    assert all(out["remat_bit_equal"] for out in ranks["heads"])


@pytest.mark.parametrize("name", ["context", "smollm"])
def test_reference_context_path_matches_its_single_device_run(runs, name):
    """The reference's own context-parallel path (no test of its own in the
    reference's suite) against its ``rules=None`` run."""
    _, ref = runs
    for key in ("prefill/logits",) + tuple(f"decode/{i}/logits"
                                           for i in range(h.STEPS)):
        _close(ref[f"{name}/{key}"], ref[f"{name}/none/{key}"])
    if h.CASES[name][3]:
        np.testing.assert_allclose(float(ref[f"{name}/loss"]),
                                   float(ref[f"{name}/none/loss"]),
                                   rtol=F32_TOL)


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------

def _merged(q, k, v, pos, window, ways):
    """``flash_decode`` over ``ways`` row shards, merged as the model's
    context-parallel decode merges them."""
    n = k.shape[1] // ways
    stats = [flash_decode(q, k[:, r * n:(r + 1) * n], v[:, r * n:(r + 1) * n],
                          pos, window=window, kpos_offset=r * n,
                          return_stats=True) for r in range(ways)]
    m_g = torch.stack([m for _, m, _ in stats]).amax(0)
    num = sum(acc * torch.exp(m - m_g)[..., None] for acc, m, _ in stats)
    den = sum(l * torch.exp(m - m_g) for _, m, l in stats)
    return (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype), stats


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("ways", [2, 4])
def test_flash_decode_stats_merge_over_shards(ways, window):
    """Merged over 2 and 4 row shards (lane 1 at position 2: every shard
    past the first holds no valid row of it), with and without a sliding
    window, the stats give the whole call's output."""
    g = torch.Generator().manual_seed(3)
    B, S_max, KV, G, hd = 3, 16, 2, 3, 8
    q = torch.randn(B, KV, G, hd, generator=g)
    k = torch.randn(B, S_max, KV, hd, generator=g)
    v = torch.randn(B, S_max, KV, hd, generator=g)
    pos = torch.tensor([13, 2, 7])
    got, stats = _merged(q, k, v, pos, window, ways)
    want = flash_decode(q, k, v, pos, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    _, m, l = stats[-1]                       # lane 1 has nothing there
    assert torch.all(m[1] == _NEG) and torch.all(l[1] == 0)


def test_heads_split_pairs_kv_groups():
    """A rank's contiguous slices of wq, wk and wv give the KV heads [r
    KV/tp, (r + 1) KV/tp) with all their G query heads: q, k and v equal
    the whole projection's at those KV groups, bit for bit."""
    cfg = t_get_smoke(h.GRANITE)
    jp = jmodel.init_params(get_smoke(h.GRANITE), jax.random.PRNGKey(0),
                            dtype=jnp.float32)
    whole = params_from_numpy(jax.tree.map(np.asarray, jp))
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    rope = torch.arange(5)[None, :]
    p = {k: w[0] for k, w in whole["blocks"][0]["mixer"].items()}
    q, k, v = tmodel._qkv(p, x, cfg, rope)
    tp, kv = 2, cfg.n_kv_heads // 2
    for r in range(tp):
        rules = ShardingRules(grid=Grid((1, tp), h.AXES, r, {}), fsdp=None)
        assert rules.heads_split(cfg)
        part = shard_params(cfg, whole, rules)["blocks"][0]["mixer"]
        qr, kr, vr = tmodel._qkv({n: w[0] for n, w in part.items()}, x, cfg,
                                 rope)
        heads = slice(r * kv, (r + 1) * kv)
        assert qr.shape == (2, 5, kv, cfg.n_heads // cfg.n_kv_heads, cfg.hd)
        assert torch.equal(qr, q[:, :, heads])
        assert torch.equal(kr, k[:, :, heads])
        assert torch.equal(vr, v[:, :, heads])


def _cuts(a, parts_grid, dims, groups=1):
    """Concatenate a (data, model) grid of parts back: ``dims`` = (dim
    over model or None, dim over data or None); uncut axes must agree.
    ``groups``: the model dim is that many equal groups, each part holding
    its block of each."""
    md, dd = dims
    rows = []
    for row in parts_grid:
        if md is None:
            assert all(torch.equal(x, row[0]) for x in row), a
            rows.append(row[0])
        else:
            pieces = [x.chunk(groups, md) for x in row]
            rows.append(torch.cat([torch.cat([p[g] for p in pieces], md)
                                   for g in range(groups)], md))
    if dd is None:
        assert all(torch.equal(x, rows[0]) for x in rows), a
        return rows[0]
    return torch.cat(rows, dd)


def _own_copy(x, w):
    """``x`` holds ``w``'s values in a tensor of its own."""
    return x is not w and x.data_ptr() != w.data_ptr() and torch.equal(x, w)


@pytest.mark.parametrize("arch,attn_mode", [
    (h.GRANITE, "heads"), (h.SMOLLM, "context"),
    ("jamba-1.5-large-398b", "heads")])
def test_shard_params_cuts_every_leaf_kind(arch, attn_mode):
    """On a (2, 2) grid with FSDP over "data" and TP over "model": every
    cut leaf rebuilds from the ranks' slices (attention by heads or whole
    heads, the dense MLP's F, the (tied) vocabulary, FSDP's d_model, the
    Mamba mixers' channels, ``in_proj`` as u and z halves); the norms,
    routers and Mamba's ``dt_bias`` and ``D_skip`` are whole: in this
    training cut each rank's own copy."""
    cfg = t_get_smoke(arch)
    jp = jmodel.init_params(get_smoke(arch), jax.random.PRNGKey(0),
                            dtype=jnp.float32)
    whole = params_from_numpy(jax.tree.map(np.asarray, jp))
    parts = [[shard_params(cfg, whole, ShardingRules(
        grid=Grid((2, 2), h.AXES, d * 2 + m, {}), dp=("data",),
        ep=("model",), ep_all=("data", "model"), fsdp="data",
        attn_mode=attn_mode)) for m in range(2)] for d in range(2)]
    rules = ShardingRules(grid=Grid((2, 2), h.AXES, 0, {}), fsdp="data",
                          attn_mode=attn_mode)
    heads = rules.heads_split(cfg)
    vocab = 0 if rules.splits(cfg.vocab) else None

    def grid_of(get):
        return [[get(p) for p in row] for row in parts]

    assert torch.equal(_cuts("embed", grid_of(lambda p: p["embed"]),
                             (vocab, 1)), whole["embed"])
    if "head" in whole:
        assert torch.equal(_cuts("head", grid_of(lambda p: p["head"]),
                                 (None if vocab is None else 1, 0)),
                           whole["head"])
    _, specs = tmodel.block_layout(cfg)
    for i, spec in enumerate(specs):
        sub = whole["blocks"][i]
        for kind in ("mixer", "ffn", "shared"):
            if kind not in sub:
                continue
            dense = {"mixer": spec.mixer == "attn",
                     "ffn": spec.ffn == "dense", "shared": True}[kind]
            split = heads if kind == "mixer" else rules.splits(
                sub[kind]["w1"].shape[-1]) if dense else False
            for n, w in sub[kind].items():
                got = grid_of(lambda p: p["blocks"][i][kind][n])
                if kind == "mixer" and spec.mixer == "mamba":
                    dims = MAMBA_DIMS[n]
                    if dims is None:
                        assert all(_own_copy(x, w) for row in got
                                   for x in row), n
                    else:
                        assert torch.equal(_cuts(n, got, dims, 2 if n ==
                                                 "in_proj" else 1), w), n
                    continue
                if not dense:
                    if kind == "mixer" or n == "router":
                        assert all(_own_copy(x, w) for row in got
                                   for x in row), n
                    continue
                dims = (h_dim(n) if split else None, d_dim(n))
                assert torch.equal(_cuts(n, got, dims), w), (arch, i, n)
        for n in ("ln1", "ln2"):
            if n in sub:
                assert all(_own_copy(p["blocks"][i][n], sub[n])
                           for row in parts for p in row)


#: a Mamba leaf's (dim over model, dim over data), None: whole
MAMBA_DIMS = {"in_proj": (2, 1), "conv_w": (2, None), "x_proj": (1, None),
              "dt_proj": (2, None), "A_log": (1, None), "out_proj": (1, 2),
              "dt_bias": None, "D_skip": None}


def h_dim(n):
    return {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "w1": 2, "w3": 2, "w2": 1}[n]


def d_dim(n):
    return {"wq": 1, "wk": 1, "wv": 1, "wo": 2, "w1": 1, "w3": 1, "w2": 2}[n]


#: cases beside ``h.CASES``: (arch, grid shape, the rules' fields or
#: "make_rules")
CACHE_CASES = {
    "jamba": ("jamba-1.5-large-398b", (2, 2), dict(dp=("data",),
                                                   fsdp=None)),
    "xlstm": ("xlstm-350m", (2, 2), "make_rules"),
    "xlstm_whole": ("xlstm-350m", (1, 4), "make_rules"),
}


def _spec_slice(shape, spec, mesh):
    """The shape of a rank's slice of ``shape`` cut by ``spec``."""
    want = list(shape)
    for d, part in enumerate(spec):
        axes = (part,) if isinstance(part, str) else (part or ())
        for a in axes:
            want[d] //= mesh.shape[a]
    return want


@pytest.mark.parametrize("name", list(h.CASES) + list(CACHE_CASES))
def test_rank_cache_gives_cache_specs_shapes(name):
    """Each rank's decode cache has the shape of the reference's
    ``cache_specs`` slice: the lanes over ``dp`` (every batch here divides
    over "data"), the KV heads or the rows over "model", a split mixer's
    state by channels (Mamba's ``h`` and ``conv``) or by heads (mLSTM's
    ``C`` and ``n``, sLSTM's states) over "model". Two departures, named
    in ``launch/sharding.py``'s docstring: mLSTM's ``m`` is cut by heads
    where ``cache_specs`` keeps it whole, and where "model" does not
    divide the heads the xLSTM states stay whole where ``cache_specs``
    cuts the 4-d ones along hd."""
    if name in CACHE_CASES:
        arch, shape, fields = CACHE_CASES[name]
    else:
        arch, shape, fields, _ = h.CASES[name]
    cfg, jcfg = t_get_smoke(arch), get_smoke(arch)
    mesh = types.SimpleNamespace(axis_names=h.AXES,
                                 shape=dict(zip(h.AXES, shape)))
    if fields == "make_rules":
        from repro.launch.sharding import make_rules as j_make_rules
        jrules = j_make_rules(jcfg, mesh, "decode")
    else:
        jrules = JRules(mesh=mesh, **{k: v for k, v in fields.items()
                                      if k != "moe_block_m"})
    batch = 2 * shape[0]
    shapes, specs = cache_specs(jcfg, jrules, batch, h.S_MAX)
    whole = tmodel.init_cache(cfg, batch, h.S_MAX, dtype=torch.float32)
    _, lay = tmodel.block_layout(cfg)
    departed = set()
    for rank in range(shape[0] * shape[1]):
        grid = Grid(shape, h.AXES, rank, {})
        if name not in CACHE_CASES:
            rules = h.port_rules(name, grid, "decode")
        elif fields == "make_rules":
            rules = make_rules(cfg, grid, "decode")
        else:
            rules = ShardingRules(grid=grid, **fields)
        got = rank_cache(cfg, whole, rules)
        for spec, c, sh, sp in zip(lay, got, shapes, specs):
            if spec.mixer == "attn":
                want = _spec_slice(sh[0].shape, sp[0], mesh)
                assert [list(t.shape) for t in c] == [want, want], (name,
                                                                    rank)
                continue
            split = rules.mixer_split(cfg, spec.mixer)
            for k, a in c.items():
                want = _spec_slice(sh[k].shape, sp[k], mesh)
                if spec.mixer == "mlstm" and k == "m" and split:
                    want[2] //= rules.tp_size
                    departed.add(("m by heads", k))
                elif spec.mixer != "mamba" and not split and a.dim() == 4:
                    assert want[3] < sh[k].shape[3], (name, k)
                    want[3] = sh[k].shape[3]
                    departed.add(("whole, not along hd", k))
                assert list(a.shape) == want, (name, rank, spec.mixer, k)
    assert departed == {"xlstm": {("m by heads", "m")},
                        "xlstm_whole": {("whole, not along hd", k)
                                        for k in ("n", "c", "h", "m")}
                        }.get(name, set()), departed


def test_checkpoint_restores_each_ranks_slice(tmp_path, trees):
    """A checkpoint written whole on one device restores onto a (2, 2)
    grid as each rank's ``shard_params`` slice, exactly (the reference's
    re-mesh restore), into a whole or a rank-shaped target."""
    cfg = t_get_smoke(h.GRANITE)
    whole = params_from_numpy(trees["heads"])
    checkpoint.save_checkpoint(str(tmp_path), 4, whole, n_shards=2)
    for rank in range(4):
        rules = _rules("heads", rank)
        want = shard_params(cfg, whole, rules, "train")
        for like in (whole, want):
            got, _ = checkpoint.load_checkpoint(str(tmp_path), 4, like,
                                                rules=rules, cfg=cfg)
            for a, b in zip(leaves(got), leaves(want)):
                assert a.shape == b.shape and torch.equal(a, b)
    with pytest.raises(ValueError, match="needs the model's cfg"):
        checkpoint.load_checkpoint(str(tmp_path), 4, whole,
                                   rules=_rules("heads", 0))


def test_max_over_refuses_a_tensor_that_requires_grad():
    x = torch.zeros(3, requires_grad=True)
    with pytest.raises(ValueError, match="requires grad"):
        collectives.max_over(x, None)
    assert collectives.max_over(x.detach(), None) is not None
