"""The port's serving engine against the JAX engine, end to end.

Both engines serve the same sharegpt requests on granite smoke under the
same controller construction (the port's controller is its copy of
``repro.core``), on the same weights: the reference's params carried across
by ``repro_torch.bridge``. The JAX engine runs the ragged Pallas kernel in
interpret mode (``ShardingRules(mesh=None, moe_impl="ragged",
moe_block_m=8, use_kernel=True)``); the port runs its ragged path on the
CPU with the same row tile.

Both run in f32 (the JAX engine's params and cache are drawn in f32 by
patching the names its module binds; the package is unchanged). In bf16
the two frameworks round at other points, a near-tie in a random model's
greedy argmax flips a token within a few steps, and from then on that lane
decodes another sequence: the comparison would measure rounding order.

Held: identical step, token and KV counts, and the same generated tokens
after every step; per-step routing tallies that differ in at most 1% of
assignments; TTFT and TPOT per request within 1%
relative. Three dispatch configurations: the ragged path; the capacity
path, which the JAX engine runs through its ``shard_map`` bodies on a
one-device mesh with the capacity Pallas kernel (its drops must show on
both sides, within the same 1%); and chunked prefill on the ragged path.
jamba smoke runs the ragged path with its Mamba states in the cache.
"""

import contextlib
import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import compat  # noqa: E402
from repro import core as jcore  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe_perm_shape  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import engine as j_engine_mod  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import SchedulerConfig as JSchedulerConfig  # noqa: E402
from repro.serving import WORKLOADS, sample_requests  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.serving import Engine as TEngine  # noqa: E402
from repro_torch.serving import EngineConfig as TEngineConfig  # noqa: E402
from repro_torch.serving import SchedulerConfig as TSchedulerConfig  # noqa: E402

torch.set_num_threads(1)

ARCH = "granite-moe-3b-a800m"
MAX_BATCH, MAX_SEQ = 4, 96


def _controller(core, cfg, policy):
    n_moe, n_slots = moe_perm_shape(cfg, None, "train")
    ranks = min(8, n_slots)
    cluster = core.make_cluster(ranks, "mi325x", d_model=cfg.d_model,
                                d_ff=cfg.moe_d_ff,
                                experts_per_rank=max(n_slots // ranks, 1),
                                seed=0)
    ctl = core.ViBEController(
        n_moe, n_slots, ranks, cluster.fit_models(),
        core.ViBEConfig(policy=policy,
                        drift=core.DriftConfig(window=20, interval=5,
                                               cooldown=5),
                        expert_bytes=3 * cfg.d_model * cfg.moe_d_ff * 2))
    return ctl, cluster


def _record_tallies(engine):
    """Log each step's tallies, and the lanes' next tokens, as the step
    reports them to the controller."""
    log = []
    observe = engine.observe_step

    def recording(tallies, tokens, latencies=None):
        nxt = engine.tokens
        nxt = nxt.numpy() if hasattr(nxt, "numpy") else np.asarray(nxt)
        log.append((np.asarray(tallies, np.float64).copy(), nxt.copy()))
        return observe(tallies, tokens, latencies)

    engine.observe_step = recording
    return log


def _requests():
    reqs = sample_requests(WORKLOADS["sharegpt"], 4, qps=50.0, seed=0)
    return [dataclasses.replace(r, prompt_len=min(r.prompt_len, MAX_SEQ // 2),
                                output_len=min(r.output_len, MAX_SEQ // 2 - 1))
            for r in reqs]


def _ttft_tpot(rec):
    ttft = rec.first_token_at - rec.arrival
    tpot = ((rec.finished_at - rec.first_token_at) / (rec.output_len - 1)
            if rec.output_len > 1 else 0.0)
    return ttft, tpot


def _run_both(policy, monkeypatch, *, j_rules, t_rules, prefill_chunk=0,
              mesh=None, arch=ARCH):
    """Serve the same requests on both engines; returns (j_eng, t_eng,
    j_log, t_log, j_rec, t_rec). The JAX engine is built and run inside
    ``compat.use_mesh(mesh)`` when a mesh is given."""
    f32 = jax.numpy.float32
    monkeypatch.setattr(j_engine_mod, "init_params",
                        functools.partial(j_init_params, dtype=f32))
    monkeypatch.setattr(j_engine_mod, "init_cache",
                        functools.partial(j_init_cache, dtype=f32))
    cfg = get_smoke(arch)
    j_ctl, j_cluster = _controller(jcore, cfg, policy)
    t_ctl, t_cluster = _controller(tcore, t_get_smoke(arch), policy)
    j_sched = JSchedulerConfig(prefill_chunk=prefill_chunk)
    t_sched = TSchedulerConfig(prefill_chunk=prefill_chunk)
    with (compat.use_mesh(mesh) if mesh is not None
          else contextlib.nullcontext()):
        j_eng = JEngine(cfg, JEngineConfig(max_batch=MAX_BATCH,
                                           max_seq=MAX_SEQ, seed=0,
                                           scheduler=j_sched),
                        rules=j_rules, controller=j_ctl, cluster=j_cluster)
        j_log = _record_tallies(j_eng)
        j_eng.submit(_requests())
        j_rec = {r.req_id: r for r in j_eng.run()}
    params = params_from_numpy(jax.tree.map(
        np.asarray, j_init_params(cfg, jax.random.PRNGKey(0), dtype=f32)))
    assert j_eng.params["embed"].dtype == f32
    t_eng = TEngine(t_get_smoke(arch),
                    TEngineConfig(max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                                  seed=0, scheduler=t_sched),
                    rules=t_rules, controller=t_ctl, cluster=t_cluster,
                    device="cpu", params=params)
    if policy == "vibe_r":       # replica slots exist on both sides
        assert t_eng.n_slots == j_eng.n_slots > cfg.n_experts
        assert t_eng.moe_tables[0].shape[-1] > 1
    t_log = _record_tallies(t_eng)
    t_eng.submit(_requests())
    t_rec = {r.req_id: r for r in t_eng.run()}
    return j_eng, t_eng, j_log, t_log, j_rec, t_rec


def _hold_engines(policy, j_eng, t_eng, j_log, t_log, j_rec, t_rec,
                  arch=ARCH):
    js, ts = j_eng.stats, t_eng.stats
    for f in ("steps", "prefill_steps", "chunk_steps", "decode_steps",
              "prefill_tokens", "decode_tokens"):
        assert getattr(ts, f) == getattr(js, f), f
    assert t_eng.kv.peak_blocks == j_eng.kv.peak_blocks
    assert len(t_log) == len(j_log)
    E = get_smoke(arch).n_experts
    moved = sum(np.abs(a[:, :E] - b[:, :E]).sum() / 2
                for (a, _), (b, _) in zip(t_log, j_log))
    total = sum(b[:, :E].sum() for b, _ in j_log)
    print(f"{policy}: {moved:.0f} of {total:.0f} routed assignments differ")
    assert moved <= 0.01 * total, \
        f"{moved:.0f} of {total:.0f} assignments differ (limit 1%)"
    drops_t, drops_j = ts.dropped_assignments, js.dropped_assignments
    assert abs(drops_t - drops_j) <= 0.01 * total, (drops_t, drops_j)
    for (_, a), (_, b) in zip(t_log, j_log):         # the same tokens
        np.testing.assert_array_equal(a, b)
    assert set(t_rec) == set(j_rec)
    for rid, jr in j_rec.items():
        assert np.isfinite(t_rec[rid].finished_at)
        for a, b in zip(_ttft_tpot(t_rec[rid]), _ttft_tpot(jr)):
            np.testing.assert_allclose(a, b, rtol=0.01)   # within 1%
    return ts


@pytest.mark.parametrize("policy", ["vibe", "vibe_r"])
def test_engine_matches_jax_engine_on_ragged_kernel(policy, monkeypatch):
    run = _run_both(policy, monkeypatch,
                    j_rules=JRules(mesh=None, moe_impl="ragged",
                                   moe_block_m=8, use_kernel=True),
                    t_rules=ShardingRules(moe_block_m=8))
    ts = _hold_engines(policy, *run)
    assert ts.dropped_assignments == 0


@pytest.mark.parametrize("policy", ["vibe", "vibe_r"])
def test_engine_capacity_matches_jax_engine_on_one_device_mesh(policy,
                                                             monkeypatch):
    """The capacity path: the JAX engine on a one-device mesh with the
    capacity Pallas kernel, the port on a one-rank group."""
    mesh = compat.make_mesh((1,), ("model",))
    j_rules = JRules(mesh=mesh, dp=(), ep=("model",), ep_all=("model",),
                     fsdp=None, moe_impl="capacity", use_kernel=True)
    run = _run_both(policy, monkeypatch, j_rules=j_rules,
                    t_rules=ShardingRules(moe_impl="capacity", ep_ranks=1),
                    mesh=mesh)
    j_eng, t_eng = run[0], run[1]
    assert t_eng.moe_impl == j_eng.moe_impl == "capacity"
    ts = _hold_engines(policy, *run)
    assert ts.dropped_assignments > 0 and j_eng.stats.dropped_assignments > 0


def test_engine_jamba_matches_jax_engine(monkeypatch):
    """jamba smoke (one attention and seven Mamba layers, four of them with
    a MoE FFN): the engine carries the recurrent states from prefill into
    the decode lanes, and every lane steps its state each decode step,
    as the reference's does."""
    arch = "jamba-1.5-large-398b"
    run = _run_both("vibe", monkeypatch,
                    j_rules=JRules(mesh=None, moe_impl="ragged",
                                   moe_block_m=8, use_kernel=True),
                    t_rules=ShardingRules(moe_block_m=8), arch=arch)
    _hold_engines("vibe", *run, arch=arch)
    t_eng = run[1]
    assert isinstance(t_eng.cache[1], dict)        # a Mamba position's state
    assert t_eng.stats.migrations > 0


def test_engine_chunked_prefill_matches_jax_engine(monkeypatch):
    """Chunked prefill (16-token chunks) on the ragged path."""
    run = _run_both("vibe", monkeypatch,
                    j_rules=JRules(mesh=None, moe_impl="ragged",
                                   moe_block_m=8, use_kernel=True),
                    t_rules=ShardingRules(moe_block_m=8), prefill_chunk=16)
    ts = _hold_engines("vibe", *run)
    assert ts.chunk_steps > ts.prefill_steps > 0


def test_serve_driver_runs_on_cpu_and_prints_summary(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen3-moe-235b-a22b", "--requests", "4",
        "--device", "cpu"])
    assert tserve.main() == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) >= 3
    assert "steps" in lines[0] and "TTFT" in lines[1] and "KV pool" in lines[2]


@pytest.mark.parametrize("extra,expect", [
    (["--moe-impl", "capacity"], "capacity FFN"),
    (["--prefill-chunk", "16"], "chunk=16"),
])
def test_serve_driver_capacity_and_chunked_prefill_on_cpu(monkeypatch,
                                                          capsys, extra,
                                                          expect):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", ARCH, "--requests", "3", "--device", "cpu",
        *extra])
    assert tserve.main() == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) >= 4 and expect in lines[0]
    assert "dropped assignments" in lines[3]


def test_slots_that_fit_counts_every_moe_layer():
    """A slot holds its expert in every MoE layer: granite (32 MoE layers,
    3 x 1536 x 512 bf16 = 4.72 MB an expert) on 8 emulated ranks."""
    expert = 3 * 1536 * 512 * 2
    fit = tserve.slots_that_fit
    # 16 GB free: 0.8 * 2 GB a rank / (32 * 4.72 MB) = 10 slots, where one
    # layer's bytes would allow 339 and clamp to E - 1 = 39
    assert fit(16 * 10**9, 8, 40, 32, expert) == 10
    assert fit(16 * 10**9, 8, 40, 1, expert) == 39
    # 80 GB free: 52 fit, clamped to E - 1 = 39 (47.1 GB of experts in all)
    assert fit(80 * 10**9, 8, 40, 32, expert) == 39
    # too little memory: the policy default (ceil(E / ranks) = 5, plus one
    # spare slot since 8 ranks divide 40 experts evenly)
    assert fit(10**9, 8, 40, 32, expert) == 6
    # the budget the card gets stays inside 80% of the free memory
    free = 40 * 10**9
    per_rank = fit(free, 8, 40, 32, expert)
    assert 8 * per_rank * 32 * expert <= 0.8 * free
    assert tserve.derive_slot_budget(8, 40, expert, "auto", device="cpu",
                                     n_moe_layers=32).tolist() == [6] * 8

