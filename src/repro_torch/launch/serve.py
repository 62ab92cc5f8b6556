"""Serving driver of the port: the PyTorch engine with ViBE on real routing.

Brings up a model in the continuous-batching engine, profiles the cluster
(Alg 1 Phase 1), computes the initial placement (Phase 2), serves with
drift-aware recalibration (Phase 3) and reports SLO metrics against the
virtual clock, as ``python -m repro.launch.serve`` does — on the card
unless ``--device cpu`` asks for the host.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --arch granite-moe-3b-a800m --requests 8 --policy vibe

The elasticity and chaos drills (``--fail-rank``, ``--chaos``) are not
ported yet. :func:`build_engine` builds controller, cluster and engine for
any :class:`ArchConfig`, so a caller can serve a published config (not
only the smoke one) through the same code.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Union

import numpy as np
import torch

from repro_torch.configs import get_smoke
from repro_torch.configs.base import ArchConfig
from repro_torch.core import (DriftConfig, PerfDriftConfig, SCENARIOS,
                              StealConfig, ViBEConfig, ViBEController,
                              default_slots_per_rank, get_policy,
                              make_cluster, make_scenario, parse_topology,
                              registered_policies)
from repro_torch.device import resolve_device
from repro_torch.models import moe_perm_shape
from repro_torch.serving import (Engine, EngineConfig, KVCacheConfig,
                                 SchedulerConfig, TRACES, WORKLOADS,
                                 registered_schedulers, sample_requests,
                                 sample_trace, summarize)

__all__ = ["serve", "build_engine", "make_requests", "derive_slot_budget",
           "main"]


def derive_slot_budget(n_ranks: int, n_experts: int, expert_bytes: int,
                       spec: Union[str, int, None] = "auto", device=None):
    """Per-rank physical slot budget from device memory telemetry.

    ``"auto"`` reads the card's free memory (``torch.cuda.mem_get_info``),
    emulates ``n_ranks`` devices sharing it, and sizes each rank's replica
    budget by how many expert tensors fit in 80% of its share, clamped to
    [policy default, E) — the reference's formula. On the CPU it returns
    the policy-default budget, deterministically. ``"default"``/None →
    None (the policy chooses); an integer → that uniform budget.
    """
    if spec in (None, "default", ""):
        return None
    if not isinstance(spec, str) or spec.lstrip("-").isdigit():
        return np.full(n_ranks, int(spec), dtype=np.int64)
    if spec != "auto":
        raise ValueError("slots_per_rank must be 'auto', 'default' or an "
                         f"integer, got {spec!r}")
    base = default_slots_per_rank(n_experts, n_ranks)
    dev = resolve_device(device)
    if dev.type != "cuda":
        return np.full(n_ranks, base, dtype=np.int64)
    free = int(torch.cuda.mem_get_info(dev)[0])
    if free <= 0:
        return np.full(n_ranks, base, dtype=np.int64)
    fit = int(0.8 * free / n_ranks / max(expert_bytes, 1))
    per_rank = int(np.clip(fit, base, max(n_experts - 1, base)))
    return np.full(n_ranks, per_rank, dtype=np.int64)


def build_engine(cfg: ArchConfig, *, policy: str = "vibe",
                 regime: str = "mi325x", max_batch: int = 4,
                 max_seq: int = 96, adaptive: bool = True,
                 weighted_routing: bool = True, moe_impl: str = "ragged",
                 scheduler: str = "fcfs", kv_blocks: Optional[int] = None,
                 block_size: int = 16,
                 slots_per_rank: Union[str, int, None] = "auto",
                 variability_scenario: str = "none",
                 scenario_start: float = 0.0, scenario_duration: float = 2.0,
                 perf_drift_delta: float = 0.0, steal: bool = False,
                 steal_headroom: float = 0.1, topology: Optional[str] = None,
                 shed_watermark: float = 0.0, preempt: bool = False,
                 seed: int = 0, device=None) -> Engine:
    """Ground-truth cluster, fitted per-rank models, ViBE controller and
    engine for ``cfg`` — the construction ``serve`` runs, for any config."""
    if not cfg.is_moe:
        raise SystemExit(f"{cfg.name} has no MoE layers — ViBE serving n/a")
    dev = resolve_device(device)
    n_moe, n_slots = moe_perm_shape(cfg)
    ranks = min(8, n_slots)
    events = ([] if variability_scenario in ("none", "")
              else make_scenario(variability_scenario, ranks,
                                 t0=scenario_start,
                                 duration=scenario_duration))
    cluster = make_cluster(ranks, regime, d_model=cfg.d_model,
                           d_ff=cfg.moe_d_ff,
                           experts_per_rank=max(n_slots // ranks, 1),
                           seed=seed, events=events)
    perf = cluster.fit_models()                    # Phase 1: profiling (t=0)
    topo = None
    if topology:
        topo = parse_topology(topology, ici_bw=cluster.ici_bw)
        if topo.n_ranks != ranks:
            raise SystemExit(f"topology {topology!r} has {topo.n_ranks} "
                             f"ranks but the engine runs {ranks}")
    expert_bytes = 3 * cfg.d_model * cfg.moe_d_ff * 2
    budget = None
    if get_policy(policy).capabilities.accepts_slot_budget:
        budget = derive_slot_budget(ranks, cfg.n_experts, expert_bytes,
                                    slots_per_rank, device=dev)
    controller = ViBEController(
        n_moe, n_slots, ranks, perf,
        ViBEConfig(policy=policy, adaptive=adaptive,
                   drift=DriftConfig(window=20, interval=5, cooldown=5),
                   perf_drift=(PerfDriftConfig(delta_perf=perf_drift_delta,
                                               window=64, interval=5,
                                               cooldown=10, min_samples=8)
                               if perf_drift_delta > 0 else None),
                   expert_bytes=expert_bytes,
                   slot_budget=budget,
                   steal=(StealConfig(headroom=steal_headroom)
                          if steal else None),
                   topology=topo))
    econfig = EngineConfig(
        max_batch=max_batch, max_seq=max_seq, moe_impl=moe_impl, seed=seed,
        weighted_routing=weighted_routing,
        scheduler=SchedulerConfig(name=scheduler,
                                  shed_watermark=shed_watermark,
                                  preempt_decodes=preempt),
        kv=(KVCacheConfig(block_size=block_size, n_blocks=kv_blocks)
            if kv_blocks else None),
        topology=topo)
    return Engine(cfg, econfig, controller=controller, cluster=cluster,
                  device=dev)


def make_requests(workload: str, n_requests: int, *, qps: float,
                  max_seq: int, seed: int = 0):
    """Sampled requests, prompts capped at ``max_seq // 2`` and outputs at
    ``max_seq // 2 - 1``, as the reference driver caps them."""
    if workload in TRACES:
        reqs = sample_trace(TRACES[workload], n_requests, qps=qps, seed=seed)
    else:
        reqs = sample_requests(WORKLOADS[workload], n_requests, qps=qps,
                               seed=seed)
    return [dataclasses.replace(r, prompt_len=min(r.prompt_len, max_seq // 2),
                                output_len=min(r.output_len,
                                               max_seq // 2 - 1))
            for r in reqs]


def serve(arch: str, *, policy: str = "vibe", n_requests: int = 12,
          qps: float = 50.0, workload: str = "sharegpt",
          regime: str = "mi325x", max_batch: int = 4, max_seq: int = 96,
          adaptive: bool = True, weighted_routing: bool = True,
          moe_impl: str = "ragged", scheduler: str = "fcfs",
          prefill_chunk: int = 0, kv_blocks: Optional[int] = None,
          block_size: int = 16, slots_per_rank: Union[str, int, None] = "auto",
          variability_scenario: str = "none",
          scenario_start: float = 0.0, scenario_duration: float = 2.0,
          perf_drift_delta: float = 0.0, steal: bool = False,
          steal_headroom: float = 0.1, topology: Optional[str] = None,
          fail_rank: int = -1,
          chaos: Optional[str] = None, shed_watermark: float = 0.0,
          preempt: bool = False, seed: int = 0, device=None):
    """Serve ``n_requests`` on the smoke config of ``arch``. Returns
    ``(engine, records, None)``, the reference's shape (its third item is
    a drill report, and the drills are not ported yet)."""
    if chaos or fail_rank >= 0:
        raise NotImplementedError(
            "--chaos / --fail-rank are not yet ported: they need the "
            "elastic and fault-injection serving modules (a later slice)")
    if prefill_chunk > 0:
        raise NotImplementedError(
            "--prefill-chunk is not yet ported (chunked prefill is a later "
            "slice)")
    engine = build_engine(
        get_smoke(arch), policy=policy, regime=regime, max_batch=max_batch,
        max_seq=max_seq, adaptive=adaptive,
        weighted_routing=weighted_routing, moe_impl=moe_impl,
        scheduler=scheduler, kv_blocks=kv_blocks, block_size=block_size,
        slots_per_rank=slots_per_rank,
        variability_scenario=variability_scenario,
        scenario_start=scenario_start, scenario_duration=scenario_duration,
        perf_drift_delta=perf_drift_delta, steal=steal,
        steal_headroom=steal_headroom, topology=topology,
        shed_watermark=shed_watermark, preempt=preempt, seed=seed,
        device=device)
    engine.submit(make_requests(workload, n_requests, qps=qps,
                                max_seq=max_seq, seed=seed))
    records = engine.run()
    return engine, records, None


def summary_lines(engine: Engine, records, *, policy: str, arch: str,
                  weighted_routing: bool, moe_impl: str, scheduler: str,
                  prefill_chunk: int = 0):
    """The reference driver's ``[serve]`` summary lines."""
    s = summarize(records)
    st = engine.stats
    routing = ("share-weighted" if weighted_routing
               else "uniform") + f" replica routing, {moe_impl} FFN"
    sched = (f"{scheduler}"
             + (f", chunk={prefill_chunk}" if prefill_chunk
                else ", whole-prompt"))
    lines = [
        f"[serve] {policy} on {arch} ({routing}; {sched}): "
        f"{st.steps} steps "
        f"({st.prefill_steps} prefill / {st.chunk_steps} chunks / "
        f"{st.decode_steps} decode), "
        f"virtual time {st.virtual_time:.3f}s",
        f"[serve] TTFT p50/p90 = {s['ttft_p50']:.4f}/{s['ttft_p90']:.4f}s "
        f"TPOT p50 = {s['tpot_p50']:.5f}s",
        f"[serve] KV pool: {engine.kv.config.n_blocks} blocks x "
        f"{engine.kv.config.block_size} tokens, peak used "
        f"{engine.kv.peak_blocks}",
    ]
    kinds = {}
    for u in engine.controller.updates:
        kinds[u.kind] = kinds.get(u.kind, 0) + 1
    by_kind = (" (" + ", ".join(f"{k}: {v}" for k, v in sorted(kinds.items()))
               + ")") if kinds else ""
    lines.append(f"[serve] recalibrations: {st.migrations}{by_kind}, "
                 f"migrated slots {st.migrated_slots}, bytes "
                 f"{st.migration_bytes}, dropped assignments "
                 f"{st.dropped_assignments:.0f}")
    if st.rejected or st.preemptions:
        by_r = ", ".join(f"{k}: {v}" for k, v in sorted(st.rejected.items()))
        lines.append(f"[serve] overload: rejected {sum(st.rejected.values())}"
                     + (f" ({by_r})" if by_r else "")
                     + f", preemptions {st.preemptions}")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-moe-235b-a22b")
    ap.add_argument("--policy", default="vibe",
                    choices=list(registered_policies()))
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--workload", default="sharegpt",
                    choices=sorted(WORKLOADS) + sorted(TRACES))
    ap.add_argument("--qps", type=float, default=50.0)
    ap.add_argument("--regime", default="mi325x")
    ap.add_argument("--scheduler", default="fcfs",
                    choices=list(registered_schedulers()))
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill (not yet ported: must be 0)")
    ap.add_argument("--kv-blocks", type=int, default=0)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--slots-per-rank", default="auto")
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=96)
    ap.add_argument("--static", dest="adaptive", action="store_false")
    ap.add_argument("--uniform-replica-routing", dest="weighted_routing",
                    action="store_false")
    ap.add_argument("--moe-impl", choices=("ragged", "capacity"),
                    default="ragged",
                    help="grouped-FFN implementation the virtual clock "
                         "prices (the dispatch itself is ragged)")
    ap.add_argument("--variability-scenario", default="none",
                    choices=("none",) + tuple(sorted(SCENARIOS)))
    ap.add_argument("--scenario-start", type=float, default=0.0)
    ap.add_argument("--scenario-duration", type=float, default=2.0)
    ap.add_argument("--steal", action="store_true")
    ap.add_argument("--steal-headroom", type=float, default=0.1)
    ap.add_argument("--topology", default=None)
    ap.add_argument("--fail-rank", type=int, default=-1,
                    help="elasticity drill (not yet ported)")
    ap.add_argument("--chaos", default=None,
                    help="chaos drill (not yet ported)")
    ap.add_argument("--shed-watermark", type=float, default=0.0)
    ap.add_argument("--preempt", action="store_true")
    ap.add_argument("--perf-drift-delta", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "versions of the kernels on the host)")
    args = ap.parse_args()
    engine, records, _ = serve(
        args.arch, policy=args.policy, n_requests=args.requests,
        qps=args.qps, workload=args.workload, regime=args.regime,
        max_batch=args.max_batch, max_seq=args.max_seq,
        adaptive=args.adaptive, weighted_routing=args.weighted_routing,
        moe_impl=args.moe_impl, scheduler=args.scheduler,
        prefill_chunk=args.prefill_chunk, kv_blocks=args.kv_blocks or None,
        block_size=args.block_size, slots_per_rank=args.slots_per_rank,
        variability_scenario=args.variability_scenario,
        scenario_start=args.scenario_start,
        scenario_duration=args.scenario_duration,
        perf_drift_delta=args.perf_drift_delta, steal=args.steal,
        steal_headroom=args.steal_headroom, topology=args.topology,
        fail_rank=args.fail_rank, chaos=args.chaos,
        shed_watermark=args.shed_watermark, preempt=args.preempt,
        seed=args.seed, device=args.device)
    for line in summary_lines(engine, records, policy=args.policy,
                              arch=args.arch,
                              weighted_routing=args.weighted_routing,
                              moe_impl=args.moe_impl,
                              scheduler=args.scheduler):
        print(line)
    if args.steal:
        rs = engine.controller.rescheduler
        print(f"[serve] stealing: {engine.stats.steal_updates} share updates "
              f"({rs.steals} steal steps, {rs.share_moved:.3f} total share "
              f"moved, headroom {args.steal_headroom:g})")
    if args.variability_scenario != "none":
        print(f"[serve] hardware drift: scenario {args.variability_scenario} "
              f"from t={args.scenario_start:.2f}s, perf-drift delta "
              f"{args.perf_drift_delta:g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
