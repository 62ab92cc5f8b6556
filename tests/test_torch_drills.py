"""The port's serving drills against the JAX package's, on the same engine.

Both engines serve granite smoke on the same weights (the reference's
params carried across by ``repro_torch.bridge``) in f32, as
``tests/test_torch_engine.py`` runs them: the JAX engine's ragged Pallas
kernel in interpret mode, the port's ragged path on the CPU with the same
row tile. The drills are the reference's modules, copied
(``serving/elastic.py``, ``serving/faults.py``); what differs is the
engine under them. Both controllers run ``vibe_h`` on a 2 x 4 topology,
the reference's CI drill setup: ``vibe`` places one expert a slot and
cannot spread 8 experts over 7 survivors.

Held: the elasticity drill's ``FailureReport`` field for field
(``at_time`` within 1e-9 relative), each record's requeues, every request
finished and no KV block held; a fail and a recover with no traffic
between restore the placement, the tables and the expert weights bit for
bit; the chaos drill's applied faults, skipped faults and steps under the
default schedule and a DSL schedule, with no invariant violated. The CLI
prints the reference's drill lines and refuses ``--chaos`` with
``--fail-rank`` as the reference does.
"""

import contextlib
import dataclasses
import functools
import io
import re
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro import serving as jserving  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe_perm_shape  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro.serving import engine as j_engine_mod  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch import serving as tserving  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
MAX_BATCH, MAX_SEQ = 4, 96
DSL = "fail@4:1,stall@6:2x0.4+0.5,recover@9:1"


def _engine(core, serving, cfg, **kw):
    n_moe, n_slots = moe_perm_shape(cfg, None, "train")
    ranks = min(8, n_slots)
    cluster = core.make_cluster(ranks, "mi325x", d_model=cfg.d_model,
                                d_ff=cfg.moe_d_ff,
                                experts_per_rank=max(n_slots // ranks, 1),
                                seed=0)
    topo = core.parse_topology("2x4", ici_bw=cluster.ici_bw)
    ctl = core.ViBEController(
        n_moe, n_slots, ranks, cluster.fit_models(),
        core.ViBEConfig(policy="vibe_h",
                        drift=core.DriftConfig(window=20, interval=5,
                                               cooldown=5),
                        expert_bytes=3 * cfg.d_model * cfg.moe_d_ff * 2,
                        topology=topo))
    config = serving.EngineConfig(max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                                  seed=0, topology=topo)
    return serving.Engine(cfg, config, controller=ctl, cluster=cluster, **kw)


@pytest.fixture
def engines(monkeypatch):
    """A fresh (JAX, port) pair of f32 engines on the same weights."""
    f32 = jax.numpy.float32
    monkeypatch.setattr(j_engine_mod, "init_params",
                        functools.partial(j_init_params, dtype=f32))
    monkeypatch.setattr(j_engine_mod, "init_cache",
                        functools.partial(j_init_cache, dtype=f32))
    cfg = get_smoke(ARCH)
    j_eng = _engine(jcore, jserving, cfg,
                    rules=JRules(mesh=None, moe_impl="ragged",
                                 moe_block_m=8, use_kernel=True))
    params = params_from_numpy(jax.tree.map(
        np.asarray, j_init_params(cfg, jax.random.PRNGKey(0), dtype=f32)))
    t_eng = _engine(tcore, tserving, t_get_smoke(ARCH),
                    rules=ShardingRules(moe_block_m=8), device="cpu",
                    params=params)
    return j_eng, t_eng


def _requests(serving):
    reqs = serving.sample_requests(serving.WORKLOADS["sharegpt"], 6,
                                   qps=50.0, seed=0)
    return [dataclasses.replace(r, prompt_len=min(r.prompt_len, MAX_SEQ // 2),
                                output_len=min(r.output_len, MAX_SEQ // 2 - 1))
            for r in reqs]


def _fields(report):
    return dataclasses.asdict(report)


def _same_report(t_rep, j_rep):
    t, j = _fields(t_rep), _fields(j_rep)
    np.testing.assert_allclose(t.pop("at_time"), j.pop("at_time"), rtol=1e-9)
    assert t == j


def _same_stats(t_eng, j_eng):
    for f in ("steps", "prefill_steps", "decode_steps", "prefill_tokens",
              "decode_tokens", "useful_tokens", "lost_tokens", "migrations",
              "migrated_slots", "migration_bytes"):
        assert getattr(t_eng.stats, f) == getattr(j_eng.stats, f), f
    np.testing.assert_allclose(t_eng.stats.virtual_time,
                               j_eng.stats.virtual_time, rtol=1e-9)


def test_failure_drill_matches_jax(engines):
    j_eng, t_eng = engines
    j_rec, j_rep = jserving.run_with_failure(j_eng, _requests(jserving),
                                             rank=3, at_step=5)
    t_rec, t_rep = tserving.run_with_failure(t_eng, _requests(tserving),
                                             rank=3, at_step=5)
    assert t_rep.rank == 3 and t_rep.drained_decodes >= 1
    _same_report(t_rep, j_rep)
    assert [r.requeues for r in t_rec] == [r.requeues for r in j_rec]
    assert sum(r.requeues for r in t_rec) >= 1
    assert all(np.isfinite(r.finished_at) for r in t_rec)
    assert t_eng.kv.used_blocks == 0 and t_eng.kv.n_seqs == 0
    _same_stats(t_eng, j_eng)
    assert t_eng.controller.dead_ranks == j_eng.controller.dead_ranks == (3,)


def test_fail_then_recover_restores_the_placement_bit_for_bit(engines):
    j_eng, t_eng = engines
    before = (t_eng._perm.copy(), [t.clone() for t in t_eng.moe_tables],
              [t.clone() for t in leaves(t_eng.params)])
    reports = []
    for eng, serving in ((j_eng, jserving), (t_eng, tserving)):
        f = serving.fail_rank(eng, 3)
        r = serving.recover_rank(eng, 3)
        reports.append((f, r))
    (jf, jr), (tf, tr) = reports
    _same_report(tf, jf)
    _same_report(tr, jr)
    assert tf.moved_experts > 0 and tr.dead_after == ()
    np.testing.assert_array_equal(t_eng._perm, before[0])
    np.testing.assert_array_equal(t_eng._perm, j_eng._perm)
    for a, b in zip(t_eng.moe_tables, before[1]):
        assert torch.equal(a, b)
    for a, b in zip(leaves(t_eng.params), before[2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("schedule", ["default", DSL])
def test_chaos_drill_matches_jax(engines, schedule):
    j_eng, t_eng = engines
    j_rep = jserving.run_chaos(j_eng, _requests(jserving),
                               jserving.FaultSchedule.parse(schedule, 8))
    t_rep = tserving.run_chaos(t_eng, _requests(tserving),
                               tserving.FaultSchedule.parse(schedule, 8))
    assert t_rep.violations == [] and j_rep.violations == []
    assert t_rep.ok
    assert t_rep.steps == j_rep.steps
    assert len(t_rep.applied) == len(j_rep.applied) >= 3
    for (ts, tres), (js, jres) in zip(t_rep.applied, j_rep.applied):
        assert dataclasses.astuple(ts) == dataclasses.astuple(js)
        if ts.kind in ("rank_fail", "rank_recover"):
            _same_report(tres, jres)
    assert [(dataclasses.astuple(s), why) for s, why in t_rep.skipped] == \
        [(dataclasses.astuple(s), why) for s, why in j_rep.skipped]
    _same_stats(t_eng, j_eng)


def _cli(main, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["serve", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main()
    return rc, out.getvalue().splitlines()


def _drill_lines(lines):
    """The drill's own lines, their numbers masked (the CLI runs bf16, where
    the two frameworks round at other points)."""
    start = next(i for i, ln in enumerate(lines)
                 if ln.startswith(("[serve] failure drill",
                                   "[serve] chaos:")))
    return [re.sub(r"\d+(\.\d+)?", "#", ln) for ln in lines[start:]]


@pytest.mark.parametrize("drill", [["--fail-rank", "3"],
                                   ["--chaos", "default"]])
def test_serve_cli_prints_the_reference_drill_lines(drill, monkeypatch):
    argv = ["--arch", ARCH, "--requests", "8", "--policy", "vibe_h",
            "--topology", "2x4", *drill]
    t_rc, t_lines = _cli(tserve.main, argv + ["--device", "cpu"],
                         monkeypatch)
    j_rc, j_lines = _cli(jserve.main, argv, monkeypatch)
    assert t_rc == j_rc == 0
    assert _drill_lines(t_lines) == _drill_lines(j_lines)
    assert any("8/8" in ln for ln in t_lines)


def test_serve_refuses_chaos_with_fail_rank(monkeypatch):
    msg = "mutually exclusive"
    with pytest.raises(SystemExit, match=msg):
        tserve.serve(ARCH, n_requests=1, chaos="default", fail_rank=1,
                     device="cpu")
    with pytest.raises(SystemExit, match=msg):
        jserve.serve(ARCH, n_requests=1, chaos="default", fail_rank=1)
    with pytest.raises(SystemExit, match=msg):
        _cli(tserve.main, ["--arch", ARCH, "--device", "cpu", "--chaos",
                           "default", "--fail-rank", "3"], monkeypatch)
