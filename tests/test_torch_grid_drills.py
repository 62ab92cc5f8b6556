"""The serve driver's drills and the capacity path on the port's grid
engine, on 4 gloo ranks at smoke size (f32), against the JAX package.

granite smoke on (2, 2) from ``make_rules(cfg, grid, "prefill")``, on
the reference's weights; the rank programs live in
``tests/_torch_grid_drills_ranks.py``. Held:

* the drills (the elasticity drill, virtual rank 1 at step 4; the chaos
  drill under the default schedule and a DSL schedule; ``vibe_h`` on a 2
  x 4 topology) against the JAX engine on one device
  (``tests/test_torch_drills.py``'s setup: the ragged Pallas kernel in
  interpret mode) and the port's one-rank engine: the reports field for
  field (``at_time`` within 1e-9 relative), the skipped faults, the
  requeues, the counts and the virtual clock, every request finished, no
  KV block held, the stall's event and the DCN window; every rank the
  same tokens and tallies at every step, and the same faults; each rank's
  expert slices of both trees after every placement change against
  ``cut_tree`` of ``apply_placement`` on the whole tree; each rank's final
  cache, after a shorter prompt into the drained lane, the one-rank
  engine's cut as ``rank_cache`` cuts it;
* a fail and a recover with no traffic between restore the placement,
  the tables and every rank's slices of both trees bit for bit;
* ``_expand_slots`` after the cut: every rank's slices of both trees the
  one-rank engine's grown tree cut by ``cut_tree``, ``_dec_follows``
  re-evaluated; a width that ``ep`` does not divide refused;
* the capacity path on (2, 2) (every call the replicated body) and on
  (1, 4) (a prefill whose length 4 divides runs the a2a body): each call
  kind's tallies, drop column included, exactly the reference's own mesh
  call's on the same inputs and its logits within ``F32_TOL``;
  ``stats.dropped_assignments`` the sum of the calls' drop columns, each
  call's drops a numpy recount from its routing (counted once), drops
  seen at ``make_rules``' factor 1.5.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_ep_ranks as ep  # noqa: E402
import _torch_grid_drills_ranks as d  # noqa: E402
import _torch_grid_engine_ranks as h  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe_perm_shape as j_moe_perm_shape  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro.serving import engine as j_engine_mod  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (cut_tree, make_rules,  # noqa: E402
                                         param_cuts, rank_cache)
from repro_torch.models.model import default_moe_perm  # noqa: E402
from repro_torch.models.moe import expand_experts  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

F32_TOL = 1e-4
#: the stats the JAX engine must match exactly (the virtual clock within
#: 1e-9 relative; the port's one-rank engine matches every stat exactly)
EXACT = ("steps", "prefill_steps", "decode_steps", "prefill_tokens",
         "decode_tokens", "useful_tokens", "lost_tokens", "migrations",
         "migrated_slots", "migration_bytes")


def _jax_drill_engine(cfg):
    f32 = jax.numpy.float32
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_engine_mod, "init_params",
                   functools.partial(j_init_params, dtype=f32))
        mp.setattr(j_engine_mod, "init_cache",
                   functools.partial(j_init_cache, dtype=f32))
        return d.drill_engine(jcore, jserving, cfg,
                              *j_moe_perm_shape(cfg, None, "train"),
                              rules=JRules(mesh=None, moe_impl="ragged",
                                           moe_block_m=8, use_kernel=True))


def _one_rank_engine(tree):
    cfg = t_get_smoke(d.ARCH)
    return d.drill_engine(tcore, tserving, cfg,
                          *j_moe_perm_shape(cfg, None, "train"),
                          rules=ShardingRules(moe_block_m=8), device="cpu",
                          params=params_from_numpy(tree))


def _parent_runs(cfg, tree):
    """The JAX engine's and the one-rank engine's drills, round trips and
    widenings."""
    jax_runs, one = {}, {}
    for name in d.DRILLS:
        jax_runs[name] = d.run_drill(jserving, _jax_drill_engine(cfg), name)
        eng = _one_rank_engine(tree)
        log = h.record(eng)
        run = d.run_drill(tserving, eng, name) | {"log": log}
        if name == "failure":
            with torch.no_grad():
                run["short_logits"] = d.short_prefill(eng)
        run["engine"] = eng
        one[name] = run
    for runs_, (eng, serving) in ((jax_runs, (_jax_drill_engine(cfg),
                                              jserving)),
                                  (one, (_one_rank_engine(tree), tserving))):
        f = serving.fail_rank(eng, d.ROUNDTRIP_RANK)
        r = serving.recover_rank(eng, d.ROUNDTRIP_RANK)
        runs_["roundtrip"] = {"fail": dataclasses.asdict(f),
                              "recover": dataclasses.asdict(r)}
    tcfg = t_get_smoke(d.ARCH)
    fresh = d.capacity_engine(tcore, tserving, tcfg,
                              ShardingRules(moe_block_m=8), device="cpu",
                              params=params_from_numpy(tree))
    grown = {"fresh": fresh, "after_chaos": one["chaos_default"]["engine"]}
    for case, (_, n) in d.EXPAND.items():
        grown[case]._expand_slots(n)
    return jax_runs, one, grown


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks (started first, in a thread: they are other processes)
    and the reference's mesh calls (a process of 4 fake devices) beside
    the JAX and one-rank engines in this process, on the reference's
    weights."""
    cfg = get_smoke(d.ARCH)
    tree = jax.tree.map(np.asarray, j_init_params(
        cfg, jax.random.PRNGKey(0), dtype=jax.numpy.float32))
    path = str(tmp_path_factory.mktemp("grid_drills") / "reference.npz")
    ref = ep.start_reference("_torch_grid_drills_ranks.jax_capacity", path,
                             4)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, d.grid_drills_rank, 4, args=(tree,),
                            timeout_s=300)
        jax_runs, one, grown = _parent_runs(cfg, tree)
        ranks = ranks.result()
    return {"ranks": ranks, "jax": jax_runs, "one": one, "grown": grown,
            "tree": tree, "ref": ep.wait_reference(ref, path)}


def _rules(rank):
    return make_rules(t_get_smoke(d.ARCH), Grid(d.SHAPE, d.AXES, rank, {}),
                      "prefill")


def _same_report(got, want, exact):
    got, want = dict(got), dict(want)
    for key in ("at_time", "t_start"):
        if key in want:
            if exact:
                assert got.pop(key) == want.pop(key), key
            else:
                np.testing.assert_allclose(got.pop(key), want.pop(key),
                                           rtol=1e-9)
    assert got == want


def _same_drill(got, want, exact):
    assert [k for k, _ in got["reports"]] == [k for k, _ in want["reports"]]
    for (_, g), (_, w) in zip(got["reports"], want["reports"]):
        _same_report(g, w, exact)
    for f in ("specs", "skipped", "steps", "requeues", "finished", "dead"):
        assert got.get(f) == want.get(f), f
    assert got["violations"] == want["violations"] == []
    assert got["kv"] == want["kv"] and got["kv"][:2] == (0, 0)
    assert all(got["finished"])
    assert len(got["events"]) == len(want["events"])
    for g, w in zip(got["events"], want["events"]):
        np.testing.assert_allclose(g[1], w[1], rtol=0 if exact else 1e-9)
        assert g[:1] + g[2:] == w[:1] + w[2:]
    for f in EXACT:
        assert got["stats"][f] == want["stats"][f], f
    np.testing.assert_allclose(got["stats"]["virtual_time"],
                               want["stats"]["virtual_time"],
                               rtol=0 if exact else 1e-9)
    np.testing.assert_array_equal(got["perm"], want["perm"])


@pytest.mark.parametrize("name", list(d.DRILLS))
def test_grid_drill_matches_jax_engine(runs, name):
    """The drill on the grid engine against the JAX engine on one device:
    the reports, skipped faults, requeues, counts, clock and events."""
    want = runs["jax"][name]
    for r in runs["ranks"]:
        got = r["drills"][name]
        _same_drill(got, want, exact=False)
        if name == "failure":
            assert got["reports"][0][1]["drained_decodes"] >= 1
        else:
            assert len(got["reports"]) >= 3
    assert runs["ranks"][0]["drills"][name]["stats"]["migrations"] >= 2


@pytest.mark.parametrize("name", list(d.DRILLS))
def test_grid_drill_matches_one_rank_engine(runs, name):
    """The same against the port's one-rank engine, every stat and the
    clock exactly, and the same tokens and tallies at every step; every
    rank the same steps and faults."""
    want = runs["one"][name]
    first = runs["ranks"][0]["drills"][name]
    for r in runs["ranks"]:
        got = r["drills"][name]
        _same_drill(got, want, exact=True)
        assert got["stats"] == want["stats"]
        assert got["ttft"] == want["ttft"]
        assert len(got["log"]) == len(want["log"]) == got["stats"]["steps"]
        for (ta, ka), (tb, kb), (tc, kc) in zip(got["log"], want["log"],
                                                first["log"]):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(ka, kb)
            np.testing.assert_array_equal(ta, tc)
            np.testing.assert_array_equal(ka, kc)
        assert got["reports"] == first["reports"]


@pytest.mark.parametrize("name", list(d.DRILLS))
def test_grid_drill_slices_and_cache(runs, name):
    """After every placement change each rank's expert slices of both
    trees against the whole tree migrated on one device (the decode tree
    in the fleet's default layout: 16 slots against 8); each rank's final
    cache the one-rank engine's cut as ``rank_cache`` cuts it. After the
    elasticity drill a 9-token prompt went into the lane the failure
    drained: the owning rank rewrote the whole lane."""
    cfg = t_get_smoke(d.ARCH)
    whole = params_from_numpy(runs["tree"])
    one = runs["one"][name]
    for r in runs["ranks"]:
        got = r["drills"][name]
        rules = _rules(r["rank"])
        assert got["n_slots"] == 16 and not got["follows"]
        assert len(got["migrations"]) == got["stats"]["migrations"] + 1
        h.hold_migrations(cfg, rules, whole, got["migrations"], False)
        want = rank_cache(cfg, one["engine"].cache, rules)
        for g, w in zip(got["cache"], want):
            for a, b in zip(g, w):
                assert a.shape == tuple(b.shape)
                np.testing.assert_allclose(a, b.numpy(), rtol=F32_TOL,
                                           atol=F32_TOL)
        if name == "failure":
            np.testing.assert_allclose(got["short_logits"],
                                       one["short_logits"], rtol=F32_TOL,
                                       atol=F32_TOL)


def test_fail_then_recover_restores_every_slice(runs):
    """Virtual rank 3 failed and recovered with no traffic between: the
    reports those of the JAX engine and the one-rank engine, and the
    placement, both trees' tables and every rank's slices of both trees
    bit for bit as before; the failure moved slots between ranks."""
    cfg = t_get_smoke(d.ARCH)
    whole = params_from_numpy(runs["tree"])
    crossed = 0
    for r in runs["ranks"]:
        got = r["roundtrip"]
        for key in ("fail", "recover"):
            _same_report(got[key], runs["one"]["roundtrip"][key], True)
            _same_report(got[key], runs["jax"]["roundtrip"][key], False)
        assert got["fail"]["moved_experts"] > 0
        assert got["recover"]["dead_after"] == ()
        b, a = got["before"], got["after"]
        np.testing.assert_array_equal(a["perm"], b["perm"])
        for ta, tb in zip(a["tables"], b["tables"]):
            for x, y in zip(ta, tb):
                np.testing.assert_array_equal(x, y)
        for phase in ("prefill", "decode"):
            for x, y in zip(a["slices"][phase], b["slices"][phase]):
                for k in x:
                    assert np.array_equal(x[k], y[k]), (phase, k)
        migs = got["migrations"]
        assert len(migs) == 2
        h.hold_migrations(cfg, _rules(r["rank"]), whole, migs, False)
        crossed += migs[0][3]
    assert crossed > 0


@pytest.mark.parametrize("case", list(d.EXPAND))
def test_expand_slots_after_the_cut(runs, case):
    """``_expand_slots`` on the grid after the cut: each rank's slices of
    both trees the cut of the one-rank engine's grown tree (the decode
    tree ``expand_experts`` of it into the fleet's default layout), the
    decode layout re-evaluated (8 → 12 slots: it followed the placement
    and no longer does)."""
    cfg = t_get_smoke(d.ARCH)
    one = runs["grown"][case]
    n = d.EXPAND[case][1]
    for r in runs["ranks"]:
        got = r["expand"][case]
        rules = _rules(r["rank"])
        assert got["n_slots"] == one.n_slots == n
        assert got["follows"][1] is False
        if case == "fresh":
            assert got["follows"] == (True, False)
        np.testing.assert_array_equal(got["perm"], one._perm)
        cuts = {ph: param_cuts(cfg, rules, ph) for ph in ("prefill",
                                                          "decode")}
        dec_perm = default_moe_perm(cfg, rules, "decode")
        moe = [i for i, b in enumerate(one.params["blocks"])
               if "router" in b.get("ffn", {})]
        for j, i in enumerate(moe):
            ffn = one.params["blocks"][i]["ffn"]
            dec = expand_experts(ffn, one._perm, dec_perm)
            for phase, tree in (("prefill", ffn), ("decode", dec)):
                c = cuts[phase]["blocks"][i]["ffn"]
                for k in ("w1", "w3", "w2"):
                    want = cut_tree(tree[k], c[k], rules.grid).numpy()
                    assert np.array_equal(got["slices"][phase][j][k],
                                          want), (phase, k)


def test_expand_slots_refuses_a_width_ep_does_not_divide():
    cfg = t_get_smoke(d.ARCH)
    eng = tserving.Engine(cfg, tserving.EngineConfig(
        max_batch=d.MAX_BATCH, max_seq=d.MAX_SEQ), rules=_rules(0),
        device="cpu")
    with pytest.raises(ValueError, match="9 slots .* ep 2"):
        eng._expand_slots(9)
    assert eng.n_slots == 8


def _tables_hold(got, ref, key):
    for i, t in enumerate(got):
        np.testing.assert_array_equal(t, ref[f"{key}/{i}"])


@pytest.mark.parametrize("case", list(d.CAPACITY))
def test_capacity_calls_match_the_reference(runs, case):
    """Each call kind of the capacity engine (its prefills of one request
    and a decode step of 4 lanes, on the construction's placement and
    tables) against the reference's own call on a mesh of the same shape:
    the tables equal, the tallies with their drop column equal, the
    logits within ``F32_TOL``; every rank the same. On (1, 4) the
    48-token prefill ran the a2a body (each rank routed its 12 rows)."""
    ref = runs["ref"]
    shape, lengths = d.CAPACITY[case]
    first = runs["ranks"][0]["capacity"][case]
    for r in runs["ranks"]:
        got = r["capacity"][case]
        assert got["follows"]
        _tables_hold(got["tables"], ref, f"{case}/tables")
        _tables_hold(got["decode_tables"], ref, f"{case}/decode_tables")
        for n in lengths:
            lg, tal, _ = got["prefills"][n]
            np.testing.assert_array_equal(tal, ref[f"{case}/prefill/{n}/"
                                                   "tallies"])
            np.testing.assert_allclose(lg, ref[f"{case}/prefill/{n}/logits"],
                                       rtol=F32_TOL, atol=F32_TOL)
            np.testing.assert_array_equal(tal, first["prefills"][n][1])
        lg, tal, _ = got["decode"]
        np.testing.assert_array_equal(tal, ref[f"{case}/decode/tallies"])
        np.testing.assert_allclose(lg, ref[f"{case}/decode/logits"],
                                   rtol=F32_TOL, atol=F32_TOL)
        np.testing.assert_array_equal(tal, first["decode"][1])
    rows = {n: {r["capacity"][case]["prefills"][n][2][0].shape[0]
                for r in runs["ranks"]} for n in lengths}
    want = {n: {n // 4 if shape == (1, 4) and n % 4 == 0 else n}
            for n in lengths}
    assert rows == want


def _recount(case, routes, rows, tallies, n_slots):
    """The call's drops a layer, recounted from each rank's routing, held
    against its tallies' drop column; returns (drops, a2a)."""
    cfg = t_get_smoke(d.ARCH)
    n_moe = tallies.shape[0]
    total, a2a = 0, False
    for layer in range(n_moe):
        got, a2a = d.recount_drops([rt[layer] for rt in routes], rows,
                                   cfg.top_k, n_slots, 1.5)
        assert tallies[layer, cfg.n_experts] == got, (case, layer)
        total += got
    return total, a2a


@pytest.mark.parametrize("case", list(d.CAPACITY))
def test_capacity_drops_counted_once(runs, case):
    """The capacity engine serving 5 sharegpt requests: every request
    finished, every rank the same tokens and tallies at every step;
    ``stats.dropped_assignments`` the sum of the calls' drop columns, and
    each call's drops (the controlled calls' too) a numpy recount of the
    assignments past their slot's bucket from its routing (every rank's
    block for the a2a body): counted once, not ``dp`` or ``tp`` times.
    At ``make_rules``' factor 1.5 (the replicated body sizes its buckets
    from at least 2.0) the prompts' skewed routing drops assignments."""
    ranks = runs["ranks"]
    cfg = t_get_smoke(d.ARCH)
    n_moe = cfg.n_layers
    first = ranks[0]["capacity"][case]
    lengths = d.CAPACITY[case][1]
    for n in lengths:
        _recount(case, [r["capacity"][case]["prefills"][n][2]
                               for r in ranks], n, first["prefills"][n][1], 8)
    _recount(case, [r["capacity"][case]["decode"][2] for r in ranks],
             d.MAX_BATCH, first["decode"][1], 8)
    total, seen_a2a = 0, False
    for c, (kind, rows, tallies) in enumerate(first["calls"]):
        routes = [r["capacity"][case]["routes"][c * n_moe:(c + 1) * n_moe]
                  for r in ranks]
        drops, a2a = _recount(case, routes, rows, tallies, 8)
        seen_a2a |= a2a
        total += drops
        assert np.all(tallies[:, :cfg.n_experts].sum(1) == cfg.top_k * rows)
    summary = first["summary"]
    assert summary["stats"]["dropped_assignments"] == total > 0
    assert sum(t[:, -1].sum() for t, _ in summary["log"]) == total
    assert seen_a2a == (d.CAPACITY[case][0] == (1, 4))
    assert all(summary["finished"])
    for r in ranks[1:]:
        got = r["capacity"][case]["summary"]
        assert got["stats"] == summary["stats"]
        for (ta, ka), (tb, kb) in zip(got["log"], summary["log"]):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(ka, kb)
