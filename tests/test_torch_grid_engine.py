"""The port's serving engine on the rank grid, on 4 gloo ranks at smoke size
(f32), against the JAX engine on one device and the port's one-rank engine.

granite smoke on (2, 2) from ``make_rules(cfg, grid, "prefill")`` (and
with FSDP over "data"): each rank holds its slices of the prefill tree
(EP 2) and of the decode tree (EP 4) and its two lanes of the cache; the
``vibe`` controller recalibrates while 5 sharegpt requests run, and each
recalibration moves expert slots between ranks. Under ``vibe_r`` the
experts grow to 16 slots and the decode tree keeps the decode fleet's
default 8 (against the port's one-rank engine only; the JAX engine's
``vibe_r`` is held in ``tests/test_torch_engine.py``). The rank programs
live in ``tests/_torch_grid_engine_ranks.py``. Held:

* against the JAX engine (``tests/test_torch_engine.py``'s harness: the
  ragged Pallas kernel in interpret mode, f32): identical step, token and
  KV counts and migrations, the same tokens after every step, tallies
  within 1% of the assignments, TTFT and TPOT within 1%;
* against the port's one-rank engine: the same, the tallies and the
  virtual clock equal; its final cache, cut as ``rank_cache`` cuts it,
  against each rank's;
* every rank the same tokens and tallies at every step;
* after each placement change, each rank's expert slices of both trees bit
  for bit against ``cut_tree`` of ``apply_placement`` on the whole tree;
* a prefill of one request on dp 2 (the replicated body) against one
  device, its tallies counted once;
* the grid engine's two refusals (chunked prefill, a ``dp`` that does
  not divide ``max_batch``), and ``migrate_experts`` alone.
"""

import concurrent.futures
import dataclasses
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import _torch_grid_engine_ranks as h  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro.serving import engine as j_engine_mod  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch.mesh import Grid, run_ranks  # noqa: E402
from repro_torch.launch.sharding import (cut_tree, make_rules,  # noqa: E402
                                         param_cuts, rank_cache)
from repro_torch.models import moe_perm_shape, prefill_fn  # noqa: E402
from repro_torch.models.moe import (apply_placement,  # noqa: E402
                                    placement_gather_indices)
from repro_torch.models.sharding import ShardingRules  # noqa: E402

torch.set_num_threads(1)

CASES = list(h.CASES)
COUNTS = ("steps", "prefill_steps", "decode_steps", "prefill_tokens",
          "decode_tokens", "migrations")
F32_TOL = 1e-4


def _jax_engine(cfg, tree):
    """The JAX engine on one device in f32 (its draw and cache patched to
    f32, as tests/test_torch_engine.py does), on the requests."""
    f32 = jax.numpy.float32
    mp = pytest.MonkeyPatch()
    mp.setattr(j_engine_mod, "init_params",
               functools.partial(j_init_params, dtype=f32))
    mp.setattr(j_engine_mod, "init_cache",
               functools.partial(j_init_cache, dtype=f32))
    try:
        ctl, cluster = h.controller(jcore, cfg, *moe_perm_shape(cfg))
        eng = jserving.Engine(
            cfg, jserving.EngineConfig(max_batch=h.MAX_BATCH,
                                       max_seq=h.MAX_SEQ, seed=0),
            rules=JRules(mesh=None, moe_impl="ragged", moe_block_m=8,
                         use_kernel=True),
            controller=ctl, cluster=cluster)
    finally:
        mp.undo()
    log = h.record(eng)
    eng.submit(h.requests(jserving))
    eng.run()
    return h.summary(eng, log)


def _one_rank_engine(tree, policy):
    cfg = t_get_smoke(h.ARCH)
    ctl, cluster = h.controller(tcore, cfg, *moe_perm_shape(cfg), policy)
    eng = tserving.Engine(
        cfg, tserving.EngineConfig(max_batch=h.MAX_BATCH, max_seq=h.MAX_SEQ,
                                   seed=0),
        rules=ShardingRules(moe_block_m=8), controller=ctl, cluster=cluster,
        device="cpu", params=params_from_numpy(tree))
    log = h.record(eng)
    eng.submit(h.requests(tserving))
    eng.run()
    return eng, h.summary(eng, log)


@pytest.fixture(scope="module")
def runs():
    """The ranks (started first, in a thread: they are other processes),
    the JAX engine and the one-rank engine, on the reference's weights."""
    cfg = get_smoke(h.ARCH)
    tree = jax.tree.map(np.asarray, j_init_params(
        cfg, jax.random.PRNGKey(0), dtype=jax.numpy.float32))
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, h.grid_rank, 4, args=(tree, CASES),
                            timeout_s=300)
        jax_run = _jax_engine(cfg, tree)
        one = {p: _one_rank_engine(tree, p) for p in ("vibe", "vibe_r")}
        ranks = ranks.result()
    return {"ranks": ranks, "jax": jax_run, "tree": tree,
            "one": {p: run for p, (_, run) in one.items()},
            "one_engine": {p: eng for p, (eng, _) in one.items()}}


def _rules(name, rank):
    grid = Grid(h.SHAPE, h.AXES, rank, {})
    return dataclasses.replace(make_rules(t_get_smoke(h.ARCH), grid,
                                          "prefill"), **h.CASES[name][0])


def _policy(name):
    return h.CASES[name][1]


def _hold_counts(got, want):
    for f in COUNTS:
        assert got["stats"][f] == want["stats"][f], f
    assert got["kv_peak"] == want["kv_peak"]
    assert all(got["finished"]) and len(got["finished"]) == h.N_REQUESTS
    assert len(got["log"]) == len(want["log"])
    for (_, a), (_, b) in zip(got["log"], want["log"]):   # the same tokens
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", [n for n in CASES if _policy(n) == "vibe"])
def test_grid_engine_matches_jax_engine(runs, name):
    got, want = runs["ranks"][0][name]["summary"], runs["jax"]
    _hold_counts(got, want)
    assert got["stats"]["migrations"] >= 1
    E = get_smoke(h.ARCH).n_experts
    moved = sum(np.abs(a[:, :E] - b[:, :E]).sum() / 2
                for (a, _), (b, _) in zip(got["log"], want["log"]))
    total = sum(b[:, :E].sum() for b, _ in want["log"])
    assert moved <= 0.01 * total, (moved, total)
    assert set(got["records"]) == set(want["records"])
    for rid, w in want["records"].items():
        np.testing.assert_allclose(got["records"][rid], w, rtol=0.01)


@pytest.mark.parametrize("name", CASES)
def test_grid_engine_matches_one_rank_engine(runs, name):
    """The same counts and tokens, the same tallies, migrations and
    virtual clock; every rank the same steps. Under ``vibe_r`` the experts
    sit in 16 slots, the decode tree in the decode fleet's default 8."""
    want = runs["one"][_policy(name)]
    assert all(r[name]["follows"] == (name != "vibe_r")
               for r in runs["ranks"])
    for r in runs["ranks"]:
        got = r[name]["summary"]
        _hold_counts(got, want)
        assert got["stats"] == want["stats"]
        for (a, _), (b, _) in zip(got["log"], want["log"]):
            np.testing.assert_array_equal(a, b)
        assert got["records"] == want["records"]
    first = runs["ranks"][0][name]["summary"]["log"]
    for r in runs["ranks"][1:]:
        for (ta, ka), (tb, kb) in zip(r[name]["summary"]["log"], first):
            np.testing.assert_array_equal(ta, tb)
            np.testing.assert_array_equal(ka, kb)


@pytest.mark.parametrize("name", CASES)
def test_grid_cache_is_the_one_rank_engines_cut(runs, name):
    """Each rank's final cache against the one-rank engine's, cut as
    ``rank_cache`` cuts it: its two lanes, its KV heads. A prefill written
    into a lane on a dp rank that does not hold it would show here."""
    cfg = t_get_smoke(h.ARCH)
    whole = runs["one_engine"][_policy(name)].cache
    for r in runs["ranks"]:
        want = rank_cache(cfg, whole, _rules(name, r["rank"]))
        got = r[name]["cache"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            for a, b in zip(g, w if isinstance(w, tuple) else w.values()):
                assert a.shape == tuple(b.shape)
                np.testing.assert_allclose(a, b.numpy(), rtol=F32_TOL,
                                           atol=F32_TOL)


@pytest.mark.parametrize("name", CASES)
def test_grid_migrations_match_the_whole_trees(runs, name):
    """After each placement change (the construction's first), each
    rank's expert slices of both trees bit for bit against ``cut_tree`` of
    ``apply_placement`` on the whole tree (grown to the controller's slots
    first, as the engine grows it) and, where the decode layout does not
    follow the placement, of ``expand_experts`` into the decode fleet's
    default layout; slots crossed ranks."""
    cfg = t_get_smoke(h.ARCH)
    whole0 = params_from_numpy(runs["tree"])
    crossed = 0
    for r in runs["ranks"]:
        migs = r[name]["migrations"]
        assert len(migs) == r[name]["summary"]["stats"]["migrations"] + 1
        h.hold_migrations(cfg, _rules(name, r["rank"]), whole0, migs,
                          r[name]["follows"])
        crossed += migs[-1][3]
    assert crossed > 0


@pytest.mark.parametrize("name", CASES)
def test_prefill_of_one_request_on_dp2(runs, name):
    """``prefill_fn`` of one request on the grid (dp 2 does not divide the
    batch: the replicated body, every rank routing the whole prompt;
    even and odd lengths, the residual split over "model" and not)
    against one device on the same placement: the logits within
    ``F32_TOL``, the tallies equal, ``top_k`` assignments a token."""
    cfg = t_get_smoke(h.ARCH)
    eng = runs["one_engine"][_policy(name)]
    fn = prefill_fn(cfg, eng.rules)
    for n in h.PREFILL_LENGTHS:
        with torch.no_grad():
            lg, _, tal = fn(eng.params, {"tokens": torch.as_tensor(
                h.prompt(cfg, n), dtype=torch.int32)}, eng.moe_tables)
        for r in runs["ranks"]:
            glg, gtal = r[name]["prefills"][n]
            np.testing.assert_allclose(glg, lg.numpy(), rtol=F32_TOL,
                                       atol=F32_TOL)
            np.testing.assert_array_equal(gtal, tal.numpy())
            assert np.all(gtal[:, :cfg.n_experts].sum(1) == cfg.top_k * n)


@pytest.mark.parametrize("refusal", ["chunk", "dp"])
def test_grid_engine_refusals(refusal):
    cfg = t_get_smoke(h.ARCH)
    grid = Grid(h.SHAPE, h.AXES, 0, {})
    rules = make_rules(cfg, grid, "prefill")
    kw = {"max_batch": h.MAX_BATCH, "max_seq": h.MAX_SEQ}
    if refusal == "chunk":
        kw["scheduler"] = tserving.SchedulerConfig(prefill_chunk=16)
        match = "chunked prefill"
    else:
        kw["max_batch"] = 3
        match = "dp must divide"
    with pytest.raises(ValueError, match=match):
        tserving.Engine(cfg, tserving.EngineConfig(**kw), rules=rules,
                        device="cpu")


@pytest.mark.parametrize("name", list(h.MIGRATIONS))
def test_migrate_experts(runs, name):
    """``migrate_experts`` alone: each rank's migrated slice bit for bit
    against its cut of ``apply_placement`` on the whole leaf, and the
    bytes it sent those of its pieces of the slots that leave it."""
    cfg = t_get_smoke(h.ARCH)
    phase, over, _, n_slots, _ = h.MIGRATIONS[name]
    for r in runs["ranks"]:
        grid = Grid(h.SHAPE, h.AXES, r["rank"], {})
        rules = dataclasses.replace(make_rules(cfg, grid, "prefill"), **over)
        ffn = param_cuts(cfg, rules, phase)["blocks"][0]["ffn"]
        whole, old, new = h.migration_leaf(name)
        moved, _ = apply_placement({"w1": torch.as_tensor(whole)}, old, new)
        gi = placement_gather_indices(old, new)
        for k in ("w1", "w2"):
            got, sent = r["migrate"][name][k]
            assert np.array_equal(got, cut_tree(moved["w1"], ffn[k],
                                                grid).numpy())
            slot_axes = ffn[k].pairs[0][1]
            n = grid.axis_size(slot_axes)
            e, me = n_slots // n, grid.index(slot_axes)
            leaving = ((gi // e == me)
                       & (np.arange(n_slots)[None, :] // e != me)).sum()
            assert sent == leaving * got[0, 0].nbytes
