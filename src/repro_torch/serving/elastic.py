"""Live serving elasticity: survive losing an EP rank mid-traffic.

A fleet-scale deployment loses devices — hardware faults, preemptions,
scheduled node drains. The elastic path keeps the engine serving through
the loss instead of crashing or leaking state:

1. **Drain** — every in-flight lane the dead rank owned (lane ``b`` is
   owned by rank ``b % G``: its KV shard lives there) is torn down: the
   KV blocks go back to the pool, the request goes back to the head of
   the waiting queue (its :class:`~repro_torch.serving.metrics.RequestRecord`
   persists, so TTFT keeps measuring from the *original* first token).
2. **Re-solve** — :meth:`ViBEController.mask_ranks` marks the rank dead
   and runs a topology-masked full solve over the survivors: the dead
   rank's window becomes all-phantom zero-share slots, so dispatch stops
   sending it tokens while the slot-table geometry (and the compiled step
   functions) stay put.
3. **Remap** — the engine applies the survivor placement through the
   normal migration path (``_apply_perm``), so the weight-shuffle stall
   is priced on the virtual clock exactly like a recalibration
   (topology-aware when ``EngineConfig.topology`` is set).
4. **Re-admit** — the drained requests flow back through the paged-KV
   admission gate and re-prefill on the survivor fleet.

The result is a bounded goodput dip rather than an outage: every admitted
request still completes (pinned by ``tests/test_serving_elastic.py``
together with the no-leaked-KV-blocks invariant), at the price of the
redone prefill/decode tokens tallied in :class:`FailureReport`.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple


from .engine import Engine
from .metrics import RequestRecord
from .workload import Request

__all__ = ["FailureReport", "RecoveryReport", "fail_rank", "recover_rank",
           "run_with_failure"]


@dataclasses.dataclass
class FailureReport:
    """What one injected rank failure cost the serving fleet."""

    rank: int                        # the rank that died
    at_time: float                   # virtual-clock time of the failure
    drained_prefills: int            # in-flight prefills torn down
    drained_decodes: int             # decode lanes torn down
    redone_tokens: int               # prefill+decode tokens to be replayed
    moved_experts: int               # slots migrated by the survivor solve
    migration_bytes: int             # weight bytes the remap shipped


def fail_rank(engine: Engine, rank: int) -> FailureReport:
    """Inject the loss of ``rank`` into a running engine.

    Drains the dead rank's in-flight lanes, masks the rank out of the
    controller's solve, and remaps the engine onto the survivor placement
    (migration stall charged to the virtual clock). Idempotent per rank:
    failing an already-dead rank raises.
    """
    ctl = engine.controller
    if ctl is None:
        raise ValueError("fail_rank needs a controller-driven engine")
    G = ctl.G
    if not 0 <= rank < G:
        raise ValueError(f"rank {rank} outside [0, {G})")
    if rank in ctl.dead_ranks:
        raise ValueError(f"rank {rank} is already dead")

    drained_p = drained_d = redone = 0
    # drain in-flight prefills whose lane (KV shard) lived on the dead rank
    for req_id, st in list(engine._prefilling.items()):
        if st.lane % G != rank:
            continue
        del engine._prefilling[req_id]
        engine.kv.free_seq(req_id)
        redone += st.prefilled
        engine.records[req_id].requeues += 1
        engine.waiting.appendleft(st.req)
        drained_p += 1
    # drain decode lanes: the produced-so-far tokens are lost with the KV
    # shard, so the request replays prompt + generation from scratch
    for b in range(engine.max_batch):
        r = engine.slot_req[b]
        if r is None or b % G != rank:
            continue
        decoded = int(r.output_len - 1 - engine.slot_left[b])
        redone += r.prompt_len + max(decoded, 0)
        engine.slot_req[b] = None
        engine.slot_left[b] = 0
        engine.pos[b] = 0
        engine.kv.free_seq(r.req_id)
        # re-queue the original Request, bypassing submit(): the record
        # already exists and must persist (TTFT measures the first byte
        # the client saw, not the recovery replay)
        engine.records[r.req_id].requeues += 1
        engine.waiting.appendleft(r)
        drained_d += 1
    # drained work feeds the token-conservation ledger: those processed
    # tokens are no longer attributable to any finished request
    engine.stats.lost_tokens += redone

    upd = ctl.mask_ranks(tuple(set(ctl.dead_ranks) | {rank}))
    # the masked solve keeps the original G-rank geometry whenever the
    # default budget allows; an explicit budget can still widen the table
    want = ctl.placement.perm.shape[1]
    if want > engine.n_slots:
        engine._expand_slots(want)
        engine._r_max = min(ctl.G, engine.n_slots - ctl.E + 1)
    engine._apply_perm(engine._controller_perm())
    return FailureReport(rank=rank, at_time=engine.stats.virtual_time,
                         drained_prefills=drained_p,
                         drained_decodes=drained_d, redone_tokens=redone,
                         moved_experts=upd.moved_experts,
                         migration_bytes=upd.migration_bytes)


@dataclasses.dataclass
class RecoveryReport:
    """What re-adding a recovered rank cost (and restored)."""

    rank: int                        # the rank that came back
    at_time: float                   # virtual-clock time of the recovery
    moved_experts: int               # slots migrated by the grow re-solve
    migration_bytes: int             # weight bytes rehydrated onto the fleet
    dead_after: Tuple[int, ...]      # remaining dead set ((), when healthy)


def recover_rank(engine: Engine, rank: int) -> RecoveryReport:
    """Elastic *grow*: bring a previously failed ``rank`` back into the
    serving fleet — the inverse of :func:`fail_rank`.

    :meth:`ViBEController.unmask_ranks` re-solves over the enlarged
    survivor set, so traffic shares flow back onto the recovered rank; the
    engine re-expands slot geometry if the solve asks for it and applies
    the placement through the normal migration path, so the weight
    *rehydration* (shipping the recovered rank its expert shards) is
    priced on the virtual clock exactly like any recalibration. No lanes
    are drained — recovery only adds capacity. A fail→recover round trip
    with no interleaved traffic restores the healthy placement
    bit-identically (property-tested at the controller level).
    """
    ctl = engine.controller
    if ctl is None:
        raise ValueError("recover_rank needs a controller-driven engine")
    if not 0 <= rank < ctl.G:
        raise ValueError(f"rank {rank} outside [0, {ctl.G})")
    if rank not in ctl.dead_ranks:
        raise ValueError(f"rank {rank} is not dead — nothing to recover")
    upd = ctl.unmask_ranks((rank,))
    want = ctl.placement.perm.shape[1]
    if want > engine.n_slots:
        engine._expand_slots(want)
        engine._r_max = min(ctl.G, engine.n_slots - ctl.E + 1)
    engine._apply_perm(engine._controller_perm())
    return RecoveryReport(rank=rank, at_time=engine.stats.virtual_time,
                          moved_experts=upd.moved_experts,
                          migration_bytes=upd.migration_bytes,
                          dead_after=ctl.dead_ranks)


def run_with_failure(engine: Engine, requests: Sequence[Request], rank: int,
                     at_step: int = 5, max_steps: int = 10_000,
                     ) -> Tuple[List[RequestRecord], Optional[FailureReport]]:
    """Serve ``requests`` end to end, killing ``rank`` after ``at_step``
    engine steps — the elasticity drill.

    Returns the request records plus the :class:`FailureReport` (None only
    if the engine never ran a step). The drill asserts nothing itself;
    tests and the CI lane check completion + KV-leak + goodput-dip bounds
    on the returned records.
    """
    engine.submit(list(requests))
    report: Optional[FailureReport] = None
    for _ in range(max_steps):
        if report is None and engine.stats.steps >= at_step:
            report = fail_rank(engine, rank)
        if not engine.step():
            if report is None:
                # traffic drained before the failure point — inject now so
                # the drill still exercises the mask/remap path, then give
                # the (empty) queue one more chance to run
                report = fail_rank(engine, rank)
                if engine.step():
                    continue
            break
    return list(engine.records.values()), report
