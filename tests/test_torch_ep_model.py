"""The port's model on an expert-parallel group of 4 gloo ranks, at smoke
size (granite-moe-3b-a800m's smoke config, f32).

``loss_fn`` (and its gradients), ``prefill_fn`` and three ``decode_fn``
steps run on a (1, 4) grid over ("data", "model") — the a2a ragged body
for the loss and prefill, the replicated ragged body for decode on the
decode fleet's weights (``expand_experts``) — each rank on its slice of
the weights. Each output is held against the single-rank port on the same
weights and against the reference's run of the same functions on a
(1, 4) mesh of fake devices (a subprocess): tallies exactly, logits and
the loss within the f32 tolerance of tests/test_torch_model.py, every
gradient leaf (the rank's slice of the experts) within 1e-4 relative L2.

Beside them, on one process: ``shard_params`` round trips, the
mesh-aware ``moe_perm_shape`` / ``make_moe_tables`` against the
reference's, and ``rules.remat``: the same loss and gradients with and
without it, and no checkpoint under ``rules=None``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as h  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (decode_params,  # noqa: E402
                                         make_rules, shard_params)
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
GRAD_TOL = 1e-4      # relative L2 of each leaf, f32


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rank_rules(rank, **kw):
    """The ranks' rules, placed by a grid object without a process
    group."""
    return ShardingRules(grid=Grid(h.MODEL_SHAPE, h.AXES, rank, {}),
                         dp=("data",), ep=("model",),
                         ep_all=("data", "model"), fsdp=None,
                         moe_block_m=8, **kw)


@pytest.fixture(scope="module")
def tree():
    cfg = get_smoke(h.MODEL_ARCH)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    return jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def single(tree):
    """The single-rank port on the same weights and inputs."""
    cfg = t_get_smoke(h.MODEL_ARCH)
    tokens, labels, dec, pos = h.model_inputs(cfg.vocab)
    params = params_from_numpy(tree)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    tables = tmodel.make_moe_tables(cfg)
    loss, (tallies, _) = tmodel.loss_fn(cfg)(
        params, {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)}, tables)
    loss.backward()
    out = {"loss": float(loss.detach()), "train_tallies": tallies.numpy(),
           "grads": tree_map(lambda p: p.grad, params)}
    with torch.no_grad():
        lg, _, tal = tmodel.prefill_fn(cfg)(
            params, {"tokens": torch.from_numpy(tokens)}, tables)
        out["prefill"] = (lg.numpy(), tal.numpy())
        cache = tmodel.init_cache(cfg, h.DEC_B, h.DEC_S_MAX,
                                  dtype=torch.float32)
        out["decode"] = []
        p_ = pos
        for tok in dec:
            lg, cache, tal = tmodel.decode_fn(cfg)(
                params, torch.from_numpy(tok), cache, torch.from_numpy(p_),
                tables)
            out["decode"].append((lg.numpy(), tal.numpy()))
            p_ = p_ + 1
    return out


@pytest.fixture(scope="module")
def runs(tree, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ep_model") / "ref.npz")
    proc = h.start_reference("jax_model", path, 4)
    try:
        ranks = run_ranks(h.model_rank, 4, args=(tree,), timeout_s=300)
    except BaseException:
        proc.kill()
        raise
    return ranks, h.wait_reference(proc, path)


def test_loss_and_gradients_match_single_rank_and_jax_mesh(runs, single):
    ranks, ref = runs
    for r, out in enumerate(ranks):
        assert out["loss"] == ranks[0]["loss"]
        np.testing.assert_allclose(out["loss"], single["loss"], rtol=F32_TOL)
        np.testing.assert_allclose(out["loss"], float(ref["loss"]),
                                   rtol=F32_TOL)
        np.testing.assert_array_equal(out["train_tallies"],
                                      single["train_tallies"])
        np.testing.assert_array_equal(out["train_tallies"],
                                      ref["train_tallies"])
        rules = _rank_rules(r)
        cfg = t_get_smoke(h.MODEL_ARCH)
        want = [g.numpy() for g in leaves(shard_params(
            cfg, single["grads"], rules, "train"))]
        jgrads = params_from_numpy(
            jax.tree.unflatten(jax.tree.structure(
                tree_map(lambda g: 0, single["grads"])),
                [ref[f"grad/{i}"] for i in range(len(want))]))
        want_j = [g.numpy() for g in leaves(shard_params(cfg, jgrads, rules,
                                                         "train"))]
        assert len(out["grads"]) == len(want)
        for i, (g, w, wj) in enumerate(zip(out["grads"], want, want_j)):
            assert g.shape == w.shape, (r, i)
            assert _rel(g, w) <= GRAD_TOL, (r, i, _rel(g, w))
            assert _rel(g, wj) <= GRAD_TOL, (r, i, _rel(g, wj))


def test_prefill_matches_single_rank_and_jax_mesh(runs, single):
    ranks, ref = runs
    for out in ranks:
        lg, tal = out["prefill"]
        np.testing.assert_array_equal(tal, single["prefill"][1])
        np.testing.assert_array_equal(tal, ref["prefill/tallies"])
        np.testing.assert_allclose(lg, single["prefill"][0], rtol=F32_TOL,
                                   atol=F32_TOL)
        np.testing.assert_allclose(lg, ref["prefill/logits"], rtol=F32_TOL,
                                   atol=F32_TOL)


def test_decode_with_expanded_experts_matches_single_rank_and_jax(runs,
                                                                  single):
    ranks, ref = runs
    for out in ranks:
        for i, (lg, tal) in enumerate(out["decode"]):
            np.testing.assert_array_equal(tal, single["decode"][i][1])
            np.testing.assert_array_equal(tal, ref[f"decode/{i}/tallies"])
            np.testing.assert_allclose(lg, single["decode"][i][0],
                                       rtol=F32_TOL, atol=F32_TOL)
            np.testing.assert_allclose(lg, ref[f"decode/{i}/logits"],
                                       rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("phase,expert_tp,fsdp", [
    ("train", False, None), ("train", False, "data"),
    ("decode", False, None), ("decode", True, None)])
def test_shard_params_round_trips(tree, phase, expert_tp, fsdp):
    """On a (2, 4) grid (rank r at data r // 4, model r % 4) the ranks'
    slices, concatenated back, rebuild every expert leaf, the vocab-
    parallel embedding and head (the smoke vocab of 512 over "model") and
    the attention weights (4 heads and 2 KV heads do not split over 4:
    only FSDP's d_model slice); norms and the router are whole on every
    rank: the same tensor in the serving phases, in the training cut a
    copy of the rank's own."""
    cfg = t_get_smoke(h.MODEL_ARCH)
    whole = params_from_numpy(tree)
    if phase == "decode":
        whole = decode_params(cfg, whole, _rank_rules(0))
    parts = [shard_params(cfg, whole, ShardingRules(
        grid=Grid((2, 4), h.AXES, r, {}), dp=("data",), ep=("model",),
        ep_all=("data", "model"), fsdp=fsdp, decode_expert_tp=expert_tp),
        phase) for r in range(8)]
    for part in parts:
        for get in (lambda t: t["final_norm"],
                    lambda t: t["blocks"][0]["ln1"],
                    lambda t: t["blocks"][0]["ffn"]["router"]):
            if phase == "train":
                assert get(part) is not get(whole)
                assert torch.equal(get(part), get(whole))
            else:
                assert get(part) is get(whole)

    def back(get, model_dim, data_dim):
        rows = [[get(parts[d * 4 + m]) for m in range(4)] for d in range(2)]
        if model_dim is not None:
            rows = [[torch.cat(r, model_dim)] for r in rows]
        if fsdp and data_dim is not None:
            return torch.cat([r[0] for r in rows], data_dim)
        assert all(torch.equal(a, b) for a, b in zip(rows[0], rows[1]))
        return rows[0][0]

    assert torch.equal(back(lambda p: p["embed"], 0, 1), whole["embed"])
    assert torch.equal(back(lambda p: p["head"], 1, 0), whole["head"])
    for k, d_axis in (("wq", 1), ("wk", 1), ("wv", 1), ("wo", 2)):
        got = back(lambda p: p["blocks"][0]["mixer"][k], None, d_axis)
        assert torch.equal(got, whole["blocks"][0]["mixer"][k]), k
    for k in ("w1", "w3", "w2"):
        got = [p["blocks"][0]["ffn"][k] for p in parts]
        if phase == "decode" and not expert_tp:      # slots over all 8
            whole_k = torch.cat(got, 1)
        else:                                        # slots over model
            inner = 2 if fsdp or k == "w2" else 3    # FSDP / the F slice
            if fsdp or expert_tp:
                cols = [torch.cat([got[m], got[4 + m]], inner)
                        for m in range(4)]
            else:                                    # replicated over data
                assert all(torch.equal(got[m], got[4 + m]) for m in range(4))
                cols = got[:4]
            whole_k = torch.cat(cols, 1)
        assert torch.equal(whole_k, whole["blocks"][0]["ffn"][k]), k


@pytest.mark.parametrize("ep_ranks", [2, 4])
def test_grid_alone_gives_the_group_size(ep_ranks):
    """On a grid the group's size comes from its ep axes only: an
    ``ep_ranks`` beside it is refused, even one that agrees."""
    rules = _rank_rules(0)
    assert (rules.ep_ranks, rules.ep_size, rules.grouped) == (0, 4, True)
    with pytest.raises(ValueError, match="leave ep_ranks 0"):
        _rank_rules(0, ep_ranks=ep_ranks)


@pytest.mark.parametrize("phase", ["train", "prefill", "decode"])
@pytest.mark.parametrize("expert_tp", [False, True])
@pytest.mark.parametrize("grid_shape", [(1, 4), (2, 4), (1, 3)])
def test_moe_perm_shape_and_tables_match_reference(phase, expert_tp,
                                                   grid_shape):
    """The slot count and default tables for each group against the
    reference's (its rules read only the mesh's names and sizes)."""
    cfg = get_smoke(h.MODEL_ARCH)
    tcfg = t_get_smoke(h.MODEL_ARCH)
    mesh = types.SimpleNamespace(axis_names=h.AXES,
                                 shape=dict(zip(h.AXES, grid_shape)))
    jrules = JRules(mesh=mesh, dp=("data",), ep=("model",),
                    ep_all=("data", "model"), fsdp=None,
                    decode_expert_tp=expert_tp)
    trules = ShardingRules(grid=Grid(grid_shape, h.AXES, 0, {}),
                           dp=("data",), ep=("model",),
                           ep_all=("data", "model"), fsdp=None,
                           decode_expert_tp=expert_tp)
    assert tmodel.moe_perm_shape(tcfg, trules, phase) == \
        jmodel.moe_perm_shape(cfg, jrules, phase)
    for jt, tt in zip(jmodel.make_moe_tables(cfg, jrules, phase=phase),
                      tmodel.make_moe_tables(tcfg, trules, phase=phase)):
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))


def test_make_rules_follows_the_reference():
    cfg = t_get_smoke(h.MODEL_ARCH)
    grid = Grid((2, 4), h.AXES, 5, {})
    train, dec = make_rules(cfg, grid, "train"), make_rules(cfg, grid,
                                                            "decode")
    assert train.remat and not dec.remat
    assert (train.capacity_factor, dec.capacity_factor) == (1.25, 1.5)
    assert train.dp_axes == ("data",) and train.ep_axes == ("model",)
    assert train.ep_all_axes == ("data", "model") and train.ep_size == 4
    assert not train.decode_expert_tp and train.fsdp is None
    assert make_rules(cfg, None).grid is None
    # every config's attention mode, FSDP and expert-TP against the
    # reference's rules on meshes of the same names and sizes
    from repro.configs import ALL_ARCHS, EXTRA_ARCHS, get as j_get
    from repro.launch.sharding import make_rules as j_make_rules
    from repro_torch.configs import get as t_get
    for arch in ALL_ARCHS + EXTRA_ARCHS:
        for shape in ((2, 4), (1, 2), (4, 16)):
            mesh = types.SimpleNamespace(axis_names=h.AXES,
                                         shape=dict(zip(h.AXES, shape)))
            want = j_make_rules(j_get(arch), mesh, "train")
            got = make_rules(t_get(arch), Grid(shape, h.AXES, 0, {}),
                             "train")
            assert (got.tp, got.attn_mode, got.decode_expert_tp) == \
                (want.tp, want.attn_mode, want.decode_expert_tp), arch
            assert got.fsdp == want.fsdp, arch


def _loss_and_grads(rules, tree, cfg):
    tokens, labels, _, _ = h.model_inputs(cfg.vocab)
    params = params_from_numpy(tree)
    for leaf in leaves(params):
        leaf.requires_grad_(True)
    loss, _ = tmodel.loss_fn(cfg, rules)(
        params, {"tokens": torch.from_numpy(tokens),
                 "labels": torch.from_numpy(labels)},
        tmodel.make_moe_tables(cfg))
    loss.backward()
    return loss.detach(), [p.grad for p in leaves(params)]


def test_remat_gives_the_same_loss_and_gradients(tree, monkeypatch):
    """Checkpointed blocks recompute the same forward: loss and every
    gradient equal bit for bit; ``rules.remat`` checkpoints each block
    once, ``rules=None`` and the default rules never."""
    cfg = t_get_smoke(h.MODEL_ARCH)
    calls = []
    real = torch.utils.checkpoint.checkpoint

    def counting(*a, **kw):
        calls.append(kw.get("use_reentrant"))
        return real(*a, **kw)

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counting)
    loss0, g0 = _loss_and_grads(None, tree, cfg)
    assert calls == []
    _loss_and_grads(ShardingRules(), tree, cfg)
    assert calls == []
    loss1, g1 = _loss_and_grads(ShardingRules(remat=True), tree, cfg)
    nb, _ = tmodel.block_layout(cfg)
    assert calls == [False] * nb
    assert torch.equal(loss0, loss1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)


def test_remat_is_off_outside_training(tree, monkeypatch):
    cfg = t_get_smoke(h.MODEL_ARCH)
    calls = []
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint",
                        lambda *a, **kw: calls.append(1))
    tokens, _, _, _ = h.model_inputs(cfg.vocab)
    with torch.no_grad():
        tmodel.prefill_fn(cfg, ShardingRules(remat=True))(
            params_from_numpy(tree), {"tokens": torch.from_numpy(tokens)},
            tmodel.make_moe_tables(cfg))
    assert calls == []
