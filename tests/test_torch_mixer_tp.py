"""Tensor parallelism of the port's recurrent mixers on gloo ranks, at
smoke size (f32), against the reference's mesh runs and the single-rank
port.

The three cases of ``tests/_torch_mixer_tp_ranks.py`` — xlstm on (2, 2)
from ``make_rules`` (mLSTM and sLSTM split by heads, the sequence over
"model"), xlstm on (1, 4) (the heads do not divide, the mixers stay whole)
and jamba on (2, 2) with FSDP over "data" (Mamba split by channels, its
d_model axis gathered) — each run the loss and its gradients (each rank's
slice), the prefill (logits, tallies, the rank's cache) and three decode
steps, each held against the reference's run on a mesh of fake devices
and against the single-rank port: tallies exactly, the rest within
``F32_TOL``. xlstm on (2, 2) also takes two AdamW steps on seeded
gradients with the grid's global norm and three training steps
(``make_train_step``); its trained state, saved from the grid, restores
onto (1, 4) and onto one device bit for bit. Each rank holds only its
slice of each mixer leaf and state; the grouped cuts round-trip through
``cut_tree``, ``gather_params`` and ``gather_to_rank0`` bit for bit; and
``param_cuts`` is held against the reference's ``param_specs`` leaf by
leaf, the departures named.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_grid_train_ranks as gt  # noqa: E402
import _torch_mixer_tp_ranks as h  # noqa: E402
import _torch_sp_ranks as sp  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.launch.sharding import make_rules as j_make_rules  # noqa: E402
from repro.launch.sharding import param_specs  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch import sharding as tsharding  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (param_cuts, rank_cache,  # noqa: E402
                                         shard_params)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.training import checkpoint as tckpt  # noqa: E402
from repro_torch.training import optimizer as topt  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
ADAMW_TOL = 1e-6
NAMES = list(h.CASES)


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=F32_TOL, atol=F32_TOL)


def _rules(name, rank, phase="train"):
    """Case ``name``'s rules for ``rank``, placed by a grid object without
    a process group."""
    return sp.port_rules(name, Grid(h.CASES[name][1], h.AXES, rank, {}),
                         phase, h.CASES)


@pytest.fixture(scope="module")
def trees():
    by_arch = {arch: gt.reference_params(arch)
               for arch in {c[0] for c in h.CASES.values()}}
    return {name: by_arch[arch] for name, (arch, *_) in h.CASES.items()}


@pytest.fixture(scope="module")
def single(trees):
    return {name: sp.single(name, trees[name], h.CASES) for name in NAMES}


@pytest.fixture(scope="module")
def runs(trees, single, tmp_path_factory):
    d = tmp_path_factory.mktemp("mixer_tp")
    caches = {name: single[name]["whole_cache"] for name in NAMES}
    np.savez(d / "caches.npz", **{
        f"{name}/{k}": v for name, cache in caches.items()
        for k, v in sp.flat_cache(cache).items()})
    # the reference's compiles take most of the time: one process a case
    procs = [(ep.start_reference("_torch_mixer_tp_ranks.jax_mixer",
                                 str(d / f"{name}.npz"), 8,
                                 str(d / "caches.npz"), [name]),
              str(d / f"{name}.npz")) for name in NAMES]
    procs.append((ep.start_reference("_torch_mixer_tp_ranks.jax_mixer_train",
                                     str(d / "train.npz"), 8),
                  str(d / "train.npz")))
    try:
        ranks = run_ranks(h.mixer_rank, 4, args=(trees, caches,
                                                 str(d / "ckpt")),
                          timeout_s=300)
        given = gt.reference_adamw(trees[h.TRAIN])
    except BaseException:
        for proc, _ in procs:
            proc.kill()
        raise
    ref = {}
    for proc, path in procs:
        ref |= ep.wait_reference(proc, path)
    return ranks, ref, given, d


@pytest.fixture(scope="module")
def single_train(trees):
    return gt.port_steps(h.TRAIN, trees[h.TRAIN], None, h.TRAIN_CASES)[0]


def _grads(flat, tree):
    return params_from_numpy(jax.tree.unflatten(jax.tree.structure(tree),
                                                flat))


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_every_gradient_leaf_match_single_rank_and_jax_mesh(
        runs, single, trees, name):
    """The loss on every rank, and each rank's slice of every gradient
    leaf: the split mixers' slices, and the leaves a rank holds whole but
    reads in part (Mamba's ``dt_bias`` and ``D_skip``, the u half of
    mLSTM's ``up``, sLSTM's ``up``) summed over "model"."""
    ranks, ref, _, _ = runs
    cfg = t_get_smoke(h.CASES[name][0])
    tree = trees[name]
    n = len(jax.tree.leaves(tree))
    jgrads = _grads([ref[f"{name}/grad/{i}"] for i in range(n)], tree)
    sgrads = _grads(single[name]["grads"], tree)
    for r, outs in enumerate(ranks):
        out = outs[name]
        assert out["loss"] == ranks[0][name]["loss"]
        np.testing.assert_allclose(out["loss"], single[name]["loss"],
                                   rtol=F32_TOL)
        np.testing.assert_allclose(out["loss"], float(ref[f"{name}/loss"]),
                                   rtol=F32_TOL)
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


@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_rank_cache_match_single_rank_and_jax_mesh(
        runs, single, name):
    """Whole logits and tallies on every rank; the returned cache is the
    rank's: its lanes over "data", and a split mixer's state slice."""
    ranks, ref, _, _ = runs
    cfg = t_get_smoke(h.CASES[name][0])
    one = single[name]
    for r, outs in enumerate(ranks):
        lg, tal = outs[name]["prefill"]
        np.testing.assert_array_equal(tal, ref[f"{name}/prefill/tallies"])
        _close(lg, one["prefill"][0])
        _close(lg, ref[f"{name}/prefill/logits"])
        whole = [{k: torch.from_numpy(t) for k, t in c.items()}
                 if isinstance(c, dict) else
                 tuple(torch.from_numpy(t) for t in c)
                 for c in one["prefill_cache"]]
        want = rank_cache(cfg, whole, _rules(name, r, "prefill"))
        for got, w in zip(outs[name]["prefill_cache"], want):
            pairs = (zip(got.values(), w.values()) if isinstance(got, dict)
                     else zip(got, w))
            for a, b in pairs:
                assert a.shape == tuple(b.shape), (name, r)
                _close(a, b.numpy())


@pytest.mark.parametrize("name", NAMES)
def test_three_decode_steps_match_single_rank_and_jax_mesh(runs, single,
                                                          name):
    ranks, ref, _, _ = runs
    one = single[name]
    for outs in ranks:
        for i, (lg, tal) in enumerate(outs[name]["decode"]):
            np.testing.assert_array_equal(tal, one["decode"][i][1])
            np.testing.assert_array_equal(tal,
                                          ref[f"{name}/decode/{i}/tallies"])
            _close(lg, one["decode"][i][0])
            _close(lg, ref[f"{name}/decode/{i}/logits"])


#: the axes (with the leading ``n_blocks``) of each mixer leaf and state
#: that "model" (``tp``) and "data" (FSDP, in ``jamba_fsdp``) divide on a
#: rank where the mixer splits: Mamba by channels, mLSTM and sLSTM by heads
SPLIT_LEAVES = {
    "mamba": {"in_proj": {2: "tp", 1: "fsdp"}, "conv_w": {2: "tp"},
              "x_proj": {1: "tp"}, "dt_proj": {2: "tp"},
              "dt_bias": {}, "A_log": {1: "tp"}, "D_skip": {},
              "out_proj": {1: "tp", 2: "fsdp"}},
    "mlstm": {"wq": {2: "tp"}, "wk": {2: "tp"}, "wv": {2: "tp"},
              "w_if": {2: "tp"}, "ln_scale": {1: "tp"}, "down": {1: "tp"}},
    "slstm": {"up": {}, "w_gates": {2: "tp"}, "r_gates": {1: "tp"},
              "down": {1: "tp"}},
}
SPLIT_STATES = {"mamba": {"h": 2, "conv": 3},
                "mlstm": {"C": 2, "n": 2, "m": 2},
                "slstm": {"c": 2, "n": 2, "h": 2, "m": 2}}


@pytest.mark.parametrize("name", NAMES)
def test_each_rank_holds_only_its_slice_of_each_mixer_leaf_and_state(
        runs, single, trees, name):
    """Each rank's mixer leaves and prefill states: where the mixer
    splits, the rank's heads or channels (mLSTM's ``up`` its z half's:
    d_model by di + di/2), else whole."""
    ranks, _, _, _ = runs
    arch, shape, _, B, _ = h.CASES[name]
    cfg = t_get_smoke(arch)
    rules = _rules(name, 0)
    tp, dp = rules.tp_size, rules.dp_size
    fsdp = rules.axis_size(rules.fsdp_axes)
    div = {"tp": tp, "fsdp": fsdp}
    whole = params_from_numpy(trees[name])
    _, specs = tmodel.block_layout(cfg)
    split = {spec.mixer: rules.mixer_split(cfg, spec.mixer)
             for spec in specs if spec.mixer != "attn"}
    assert split == {"xlstm": {"slstm": True, "mlstm": True},
                     "xlstm_whole": {"slstm": False, "mlstm": False},
                     "jamba_fsdp": {"mamba": True}}[name]
    for outs in ranks:
        for spec, got, sub, st, st_whole in zip(
                specs, outs[name]["mixer_shapes"], whole["blocks"],
                outs[name]["prefill_cache"], single[name]["prefill_cache"]):
            if spec.mixer == "attn":
                continue
            for k, t in sub["mixer"].items():
                want = list(t.shape)
                if split[spec.mixer] and k in SPLIT_LEAVES[spec.mixer]:
                    for dim, by in SPLIT_LEAVES[spec.mixer][k].items():
                        want[dim] //= div[by]
                if k == "up" and spec.mixer == "mlstm" and split["mlstm"]:
                    want[2] = want[2] // 2 + want[2] // 2 // tp
                assert got[k] == tuple(want), (name, spec.mixer, k)
            for k, t in st_whole.items():
                want = list(t.shape)
                want[1] = B // dp
                if split[spec.mixer]:
                    want[SPLIT_STATES[spec.mixer][k]] //= tp
                assert st[k].shape == tuple(want), (name, spec.mixer, k)


def test_grouped_cuts_take_each_groups_block(trees):
    """Rank r of "model" holds block r of each group: of Mamba's u and z
    halves of ``in_proj``, of mLSTM's z half of ``up`` (its u half whole)
    and of ``w_if``'s input- and forget-gate heads."""
    for name, leaf, mixer in (("jamba_fsdp", "in_proj", 1),
                              ("xlstm", "up", 1), ("xlstm", "w_if", 1)):
        cfg = t_get_smoke(h.CASES[name][0])
        w = params_from_numpy(trees[name])["blocks"][mixer]["mixer"][leaf]
        half = w.shape[2] // 2
        for r in range(2):
            rules = _rules(name, r)
            got = shard_params(cfg, params_from_numpy(trees[name]),
                               rules)["blocks"][mixer]["mixer"][leaf]
            if rules.fsdp_axes:
                n = w.shape[1] // 2
                w_d = w[:, :n] if rules.index(rules.fsdp_axes) == 0 \
                    else w[:, n:]
            else:
                w_d = w
            q = half // 2
            z = w_d[..., half + r * q:half + (r + 1) * q]
            u = w_d[..., :half] if leaf == "up" else \
                w_d[..., r * q:(r + 1) * q]
            assert torch.equal(got, torch.cat([u, z], -1)), (name, leaf, r)


@pytest.mark.parametrize("name", NAMES)
def test_cut_tree_gather_params_and_gather_to_rank0_round_trip(runs, name):
    """Every case's whole params, cut by the rank's ``param_cuts`` (the
    grouped cuts with them), come back bit for bit through
    ``gather_params`` on every rank and ``gather_to_rank0`` on rank 0."""
    ranks, _, _, _ = runs
    assert all(outs[name]["round_trip"] for outs in ranks)
    assert ranks[0][name]["to_rank0"]


def test_grid_norm_adamw_and_train_steps_match_reference(runs, single_train):
    """xlstm on (2, 2): the grid's global norm of seeded gradients (the u
    half of mLSTM's ``up`` counted once over "model") and two clipped
    AdamW steps, gathered, are the reference's ``adamw_update`` on the
    whole tree; three training steps of ``make_train_step`` give the
    reference's mesh step's losses, params and state."""
    ranks, ref, (states, norms), _ = runs
    for k in range(2):
        assert norms[k] > topt.AdamWConfig().grad_clip
        assert single_train["norms"][k] == pytest.approx(norms[k],
                                                         rel=ADAMW_TOL)
        for r in ranks:
            assert r["train"]["norms"][k] == ranks[0]["train"]["norms"][k]
            assert r["train"]["norms"][k] == pytest.approx(norms[k],
                                                           rel=ADAMW_TOL)
    want = [np.asarray(x) for x in jax.tree.leaves(states[-1])]
    got = ranks[0]["train"]["given"]
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        np.testing.assert_allclose(a, b, rtol=ADAMW_TOL, atol=ADAMW_TOL,
                                   err_msg=str(i))
    for s in range(gt.STEPS):
        loss = float(ref[f"{h.TRAIN}/loss/{s}"])
        assert single_train["losses"][s] == pytest.approx(loss, rel=F32_TOL)
        for r in ranks:
            assert r["train"]["losses"][s] == ranks[0]["train"]["losses"][s]
            assert r["train"]["losses"][s] == pytest.approx(loss,
                                                            rel=F32_TOL)
    got = ranks[0]["train"]["trained"]
    n = len(single_train["trained"])
    want = [ref[f"{h.TRAIN}/trained/{i}"] for i in range(n)]
    assert len(got) == n
    for i, (a, b, c) in enumerate(zip(got, want, single_train["trained"])):
        assert _rel(a, b) <= F32_TOL, (i, _rel(a, b))
        assert _rel(a, c) <= F32_TOL, (i, _rel(a, c))


def test_checkpoint_saved_from_split_grid_restores_bit_for_bit(runs, trees):
    """The trained state saved from (2, 2), where the mixers split by
    heads, restores onto (1, 4), where they are whole, and onto one
    device, the saved state bit for bit."""
    ranks, _, _, d = runs
    saved = ranks[0]["train"]["trained"]
    for a, b in zip(ranks[0]["restored"], saved):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    whole = params_from_numpy(trees[h.TRAIN])
    state, _ = tckpt.load_checkpoint(str(d / "ckpt"), gt.CKPT_STEP, {
        "params": whole, "opt": topt.adamw_init(whole)})
    got = leaves(state)
    assert len(got) == len(saved)
    for a, b in zip(got, saved):
        assert a.numpy().dtype == b.dtype and np.array_equal(a.numpy(), b)


#: the cases' layouts, and xlstm on (2, 2) in context mode with FSDP over
#: "data" (hand-built: ``make_rules`` splits xlstm's attention-shaped
#: leaves by heads wherever its mixers split)
PARAM_CASES = dict(h.CASES, xlstm_context=(h.XLSTM, (2, 2), dict(
    dp=("data",), tp="model", ep=("model",), ep_all=("data", "model"),
    fsdp="data", attn_mode="context"), 2, 8))

#: leaves whose cuts depart from ``param_specs``'s (the module docstring
#: of ``launch/sharding.py`` says why), by case: where the mixers split
#: (mLSTM's ``wq``/``wk``/``wv`` where the reference matches them with
#: attention's leaves in context mode), and (xlstm on (1, 4)) where ``tp``
#: does not divide the heads
DEPARTURES = {
    "xlstm": {"mlstm": {"up", "w_if", "ln_scale"},
              "slstm": {"up", "w_gates"}},
    "xlstm_whole": {"mlstm": {"up", "w_if", "down"},
                    "slstm": {"up", "w_gates", "down"}},
    "jamba_fsdp": {"mamba": {"in_proj"}},
    "xlstm_context": {"mlstm": {"up", "wq", "wk", "wv", "w_if", "ln_scale"},
                      "slstm": {"up", "w_gates"}},
}


def _spec_dims(spec, ndim):
    """A reference ``PartitionSpec`` as the axes that cut each dim."""
    parts = list(spec) + [None] * (ndim - len(spec))
    return [() if p is None else (p,) if isinstance(p, str) else tuple(p)
            for p in parts]


def _cut_dims(c, ndim):
    """A port ``Cuts`` as the axes that cut each dim, a grouped cut's axes
    marked."""
    dims = [()] * ndim
    for pair in c.pairs:
        dim, axes = pair[0] % ndim, pair[1]
        dims[dim] = dims[dim] + ((("grouped", axes),) if len(pair) == 3
                                 else axes)
    return dims


@pytest.mark.parametrize("name", list(PARAM_CASES))
def test_param_cuts_hold_to_param_specs_with_the_departures_named(name):
    """Leaf by leaf, ``param_cuts`` cuts as the reference's
    ``param_specs`` on the same mesh, but for :data:`DEPARTURES`; each
    departure differs, and the module docstring names it."""
    arch, shape, fields, _, _ = PARAM_CASES[name]
    cfg, jcfg = t_get_smoke(arch), get_smoke(arch)
    mesh = types.SimpleNamespace(axis_names=h.AXES,
                                 shape=dict(zip(h.AXES, shape)))
    jrules = (j_make_rules(jcfg, mesh, "train") if fields == "make_rules"
              else JRules(mesh=mesh, **fields))
    specs = param_specs(jcfg, jrules, "train")
    cuts = param_cuts(cfg, sp.port_rules(name, Grid(shape, h.AXES, 0, {}),
                                         "train", PARAM_CASES))
    shapes = jax.tree.leaves(jax.eval_shape(
        lambda: j_init_params(jcfg, jax.random.PRNGKey(0), jrules, "train")))
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))
    _, layout = tmodel.block_layout(cfg)
    # the port's leaves in the reference's (sorted-key) order, named
    named = []
    for k in sorted(cuts):
        if k != "blocks":
            named.append((None, k, cuts[k]))
            continue
        for spec, sub in zip(layout, cuts["blocks"]):
            for part in sorted(sub):
                if not isinstance(sub[part], dict):         # a norm
                    named.append((None, part, sub[part]))
                    continue
                for leaf in sorted(sub[part]):
                    named.append((spec.mixer if part == "mixer" else None,
                                  leaf, sub[part][leaf]))
    assert len(named) == len(flat_specs) == len(shapes)
    departed = {}
    for (mixer, leaf, c), spec, sds in zip(named, flat_specs, shapes):
        got, want = _cut_dims(c, sds.ndim), _spec_dims(spec, sds.ndim)
        if got != want:
            departed.setdefault(mixer, set()).add(leaf)
    assert departed == DEPARTURES[name]
    doc = tsharding.__doc__
    for mixer, names in departed.items():
        for leaf in names:
            assert f"``{leaf}``" in doc, leaf
