"""Pluggable continuous-batching schedulers (SLO-aware serving loop).

Mirrors the placement-policy registry (``repro_torch.core.policy``): a scheduler
is any object with a ``name`` and a ``schedule(ctx) -> Action`` method;
registering it exposes it to the engine, the simulator's scheduled loop,
``launch/serve.py --scheduler`` and every benchmark at once.

Per step the serving loop builds a :class:`SchedulerContext` — who is
waiting (arrived, not admitted), who is mid-prefill, how many sequences
are decoding, how many new admissions the KV pool + lane budget allow —
and the scheduler answers with an :class:`Action`: a list of prefill
:class:`Chunk` s to run (respecting ``ctx.chunk_budget``), a decode step,
or idle. Built-ins:

* ``fcfs``            — prefill-priority in arrival order; with
  ``prefill_chunk = 0`` this replicates the legacy engine loop exactly.
* ``slo_edf``         — earliest-deadline-first over TTFT deadlines
  (``arrival + ttft_slo``), with a decode-starvation bound: after
  ``decode_starvation_bound`` consecutive prefill steps a decode step is
  forced whenever sequences are running (property-tested).
* ``decode_priority`` — decode whenever anything runs; prefill only on an
  empty decode batch (the TPOT-protective extreme).

Registering a custom scheduler::

    from repro_torch.serving.scheduler import Action, register_scheduler

    @register_scheduler
    class MyScheduler:
        name = "mine"
        def schedule(self, ctx):
            ...
            return Action("decode")
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Protocol, Tuple, runtime_checkable

from .config import SchedulerConfig

__all__ = [
    "RequestView", "Chunk", "Action", "SchedulerContext", "Scheduler",
    "UnknownSchedulerError", "register_scheduler", "get_scheduler",
    "registered_schedulers", "shed_victims",
]


@dataclasses.dataclass(frozen=True)
class RequestView:
    """What a scheduler may know about one request."""

    req_id: int
    arrival: float
    prompt_len: int
    output_len: int
    prefilled: int = 0               # prompt tokens already in the cache
    ttft_slo: Optional[float] = None # per-request override (multi-tenant)

    @property
    def remaining(self) -> int:
        return self.prompt_len - self.prefilled

    def deadline(self, default_slo: float) -> float:
        return self.arrival + (self.ttft_slo if self.ttft_slo is not None
                               else default_slo)

    def headroom(self, now: float, default_slo: float) -> float:
        """Seconds until (negative: since) this request's TTFT deadline —
        the load-shedding priority key (lowest headroom sheds first)."""
        return self.deadline(default_slo) - now


@dataclasses.dataclass(frozen=True)
class Chunk:
    """One prefill slice: ``n_tokens`` of request ``req_id``'s prompt."""

    req_id: int
    n_tokens: int


@dataclasses.dataclass(frozen=True)
class Action:
    kind: str                        # "prefill" | "decode" | "idle"
    chunks: Tuple[Chunk, ...] = ()

    def __post_init__(self):
        if self.kind not in ("prefill", "decode", "idle"):
            raise ValueError(f"unknown action kind {self.kind!r}")
        if self.kind == "prefill" and not self.chunks:
            raise ValueError("prefill action needs at least one chunk")


@dataclasses.dataclass
class SchedulerContext:
    """One step's scheduling state, as the serving loop sees it."""

    now: float
    config: SchedulerConfig
    waiting: List[RequestView]       # arrived, unadmitted (arrival order)
    prefilling: List[RequestView]    # admitted, prompt partially in cache
    n_running: int                   # sequences in the decode batch
    prefill_streak: int              # consecutive prefill steps so far
    can_start: int                   # new admissions allowed (lanes + KV)
    chunk_budget: int                # prefill tokens allowed this step
    blocked: List[RequestView] = dataclasses.field(default_factory=list)
    #                                  waiting but NOT KV-admissible right
    #                                  now (the shed/preempt candidates)
    kv_utilization: float = 0.0      # used / total KV blocks this step

    def build_chunks(self, ordered: List[RequestView]) -> Tuple[Chunk, ...]:
        """Greedy chunk packing over ``ordered`` candidates.

        Each candidate contributes one chunk of ``config.prefill_chunk``
        tokens (0 = its whole remaining prompt), until ``chunk_budget`` is
        spent. New (unprefilled) requests count against ``can_start``.
        """
        chunks: List[Chunk] = []
        budget = self.chunk_budget
        starts = self.can_start
        for v in ordered:
            if v.remaining <= 0:
                continue
            if v.prefilled == 0:
                if starts <= 0:
                    continue
            size = v.remaining if self.config.prefill_chunk <= 0 \
                else min(self.config.prefill_chunk, v.remaining)
            if chunks and size > budget:
                break
            if v.prefilled == 0:
                starts -= 1
            chunks.append(Chunk(v.req_id, size))
            budget -= size
            if budget <= 0:
                break
        return tuple(chunks)


@runtime_checkable
class Scheduler(Protocol):
    """Protocol every registered scheduler satisfies."""

    name: str

    def schedule(self, ctx: SchedulerContext) -> Action:
        ...


class UnknownSchedulerError(ValueError):
    """Raised for a scheduler name absent from the registry."""


_REGISTRY: Dict[str, Scheduler] = {}


def register_scheduler(sched, *, replace: bool = False):
    """Add a scheduler to the registry; usable as a class decorator."""
    inst = sched() if isinstance(sched, type) else sched
    name = getattr(inst, "name", "")
    if not name or not isinstance(name, str):
        raise ValueError("scheduler needs a non-empty string .name")
    if not isinstance(inst, Scheduler):
        raise TypeError(f"{name!r} does not satisfy the Scheduler protocol "
                        "(name/schedule)")
    if name in _REGISTRY and not replace:
        raise ValueError(f"scheduler {name!r} already registered "
                         "(pass replace=True to override)")
    _REGISTRY[name] = inst
    return sched


def get_scheduler(name: str) -> Scheduler:
    """Registry lookup; unknown names list what *is* registered."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise UnknownSchedulerError(
            f"unknown scheduler {name!r}; registered schedulers: "
            f"{', '.join(registered_schedulers())}") from None


def registered_schedulers() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# ---------------------------------------------------------------------------
# built-in schedulers
# ---------------------------------------------------------------------------

@register_scheduler
class FcfsScheduler:
    """Prefill-priority, arrival order — the legacy engine loop as a
    policy. Mid-prefill requests finish before new admissions."""

    name = "fcfs"

    def schedule(self, ctx: SchedulerContext) -> Action:
        chunks = ctx.build_chunks(list(ctx.prefilling) + list(ctx.waiting))
        if chunks:
            return Action("prefill", chunks)
        if ctx.n_running > 0:
            return Action("decode")
        return Action("idle")


@register_scheduler
class SloEdfScheduler:
    """Earliest-TTFT-deadline-first prefill with a decode-starvation bound.

    Prefill candidates (mid-prefill and admissible waiting alike) are
    ordered by ``arrival + ttft_slo``; after ``decode_starvation_bound``
    consecutive prefill steps, a decode step is forced whenever sequences
    are running, so TPOT can never be starved indefinitely by a deep
    prefill backlog.
    """

    name = "slo_edf"

    def schedule(self, ctx: SchedulerContext) -> Action:
        cfg = ctx.config
        if ctx.n_running > 0 \
                and ctx.prefill_streak >= cfg.decode_starvation_bound:
            return Action("decode")
        cand = sorted(list(ctx.prefilling) + list(ctx.waiting),
                      key=lambda v: (v.deadline(cfg.ttft_slo), v.arrival,
                                     v.req_id))
        chunks = ctx.build_chunks(cand)
        if chunks:
            return Action("prefill", chunks)
        if ctx.n_running > 0:
            return Action("decode")
        return Action("idle")


# ---------------------------------------------------------------------------
# overload protection: watermark load shedding
# ---------------------------------------------------------------------------

def shed_victims(ctx: SchedulerContext) -> Tuple[int, ...]:
    """Watermark-based load-shedding policy: req_ids to reject this step.

    Fires only when ``config.shed_watermark > 0`` and KV-pool utilization
    has reached it. Victims are the not-yet-admitted requests (admissible
    and KV-blocked alike) whose TTFT deadline has already lapsed — they
    cannot meet their SLO even if admitted immediately, so under memory
    pressure completing them only delays requests that still can. Ordered
    lowest-SLO-headroom first, so the engine rejects the most hopeless
    work first when it caps how much to shed. Mid-prefill requests are
    never shed here (their KV investment is the engine's preemption
    problem, not admission's).
    """
    wm = ctx.config.shed_watermark
    if wm <= 0.0 or ctx.kv_utilization < wm:
        return ()
    cand = [(v.headroom(ctx.now, ctx.config.ttft_slo), v.req_id)
            for v in list(ctx.waiting) + list(ctx.blocked)]
    return tuple(req_id for h, req_id in sorted(cand) if h <= 0.0)


@register_scheduler
class DecodePriorityScheduler:
    """Decode whenever anything runs; prefill only on an empty decode
    batch. Protects TPOT at the cost of TTFT under sustained load."""

    name = "decode_priority"

    def schedule(self, ctx: SchedulerContext) -> Action:
        if ctx.n_running > 0:
            return Action("decode")
        chunks = ctx.build_chunks(list(ctx.prefilling) + list(ctx.waiting))
        if chunks:
            return Action("prefill", chunks)
        return Action("idle")
