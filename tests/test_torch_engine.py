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

Held: identical step, token and KV counts; per-step routing tallies that
differ in at most 1% of assignments; TTFT and TPOT per request within 1%
relative.
"""

import dataclasses
import functools
import sys

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import core as jcore  # noqa: E402
from repro.configs import get_smoke  # noqa: E402
from repro.models import init_params as j_init_params  # noqa: E402
from repro.models import moe_perm_shape  # noqa: E402
from repro.models.sharding import ShardingRules as JRules  # noqa: E402
from repro.models import init_cache as j_init_cache  # noqa: E402
from repro.serving import Engine as JEngine  # noqa: E402
from repro.serving import engine as j_engine_mod  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import WORKLOADS, sample_requests  # noqa: E402
from repro_torch import core as tcore  # noqa: E402
from repro_torch.bridge import params_from_numpy  # noqa: E402
from repro_torch.configs import get_smoke as t_get_smoke  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models.sharding import ShardingRules  # noqa: E402
from repro_torch.serving import Engine as TEngine  # noqa: E402
from repro_torch.serving import EngineConfig as TEngineConfig  # noqa: E402

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
    log = []
    observe = engine.observe_step

    def recording(tallies, tokens, latencies=None):
        log.append(np.asarray(tallies, np.float64).copy())
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


@pytest.mark.parametrize("policy", ["vibe", "vibe_r"])
def test_engine_matches_jax_engine_on_ragged_kernel(policy, monkeypatch):
    f32 = jax.numpy.float32
    monkeypatch.setattr(j_engine_mod, "init_params",
                        functools.partial(j_init_params, dtype=f32))
    monkeypatch.setattr(j_engine_mod, "init_cache",
                        functools.partial(j_init_cache, dtype=f32))
    cfg = get_smoke(ARCH)
    j_ctl, j_cluster = _controller(jcore, cfg, policy)
    t_ctl, t_cluster = _controller(tcore, t_get_smoke(ARCH), policy)
    j_eng = JEngine(cfg, JEngineConfig(max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                                       seed=0),
                    rules=JRules(mesh=None, moe_impl="ragged", moe_block_m=8,
                                 use_kernel=True),
                    controller=j_ctl, cluster=j_cluster)
    params = params_from_numpy(jax.tree.map(
        np.asarray, j_init_params(cfg, jax.random.PRNGKey(0), dtype=f32)))
    assert j_eng.params["embed"].dtype == f32
    t_eng = TEngine(t_get_smoke(ARCH),
                    TEngineConfig(max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                                  seed=0),
                    rules=ShardingRules(moe_block_m=8), controller=t_ctl,
                    cluster=t_cluster, device="cpu", params=params)
    if policy == "vibe_r":       # replica slots exist on both sides
        assert t_eng.n_slots == j_eng.n_slots > cfg.n_experts
        assert t_eng.moe_tables[0].shape[-1] > 1
    j_log, t_log = _record_tallies(j_eng), _record_tallies(t_eng)
    j_eng.submit(_requests())
    t_eng.submit(_requests())
    j_rec = {r.req_id: r for r in j_eng.run()}
    t_rec = {r.req_id: r for r in t_eng.run()}

    js, ts = j_eng.stats, t_eng.stats
    for f in ("steps", "prefill_steps", "decode_steps", "prefill_tokens",
              "decode_tokens"):
        assert getattr(ts, f) == getattr(js, f), f
    assert t_eng.kv.peak_blocks == j_eng.kv.peak_blocks
    assert len(t_log) == len(j_log)
    E = cfg.n_experts
    moved = sum(np.abs(a[:, :E] - b[:, :E]).sum() / 2
                for a, b in zip(t_log, j_log))
    total = sum(b[:, :E].sum() for b in j_log)
    print(f"{policy}: {moved:.0f} of {total:.0f} routed assignments differ")
    assert moved <= 0.01 * total, \
        f"{moved:.0f} of {total:.0f} assignments differ (limit 1%)"
    assert set(t_rec) == set(j_rec)
    for rid, jr in j_rec.items():
        assert np.isfinite(t_rec[rid].finished_at)
        for a, b in zip(_ttft_tpot(t_rec[rid]), _ttft_tpot(jr)):
            np.testing.assert_allclose(a, b, rtol=0.01)   # within 1%


def test_serve_driver_runs_on_cpu_and_prints_summary(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", [
        "serve", "--arch", "qwen3-moe-235b-a22b", "--requests", "4",
        "--device", "cpu"])
    assert tserve.main() == 0
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith("[serve]")]
    assert len(lines) >= 3
    assert "steps" in lines[0] and "TTFT" in lines[1] and "KV pool" in lines[2]


def test_serve_refuses_unported_drills():
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tserve.serve(ARCH, n_requests=1, chaos="default", device="cpu")
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tserve.serve(ARCH, n_requests=1, fail_rank=1, device="cpu")
