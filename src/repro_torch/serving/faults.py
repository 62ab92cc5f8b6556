"""Declarative fault injection + the chaos drill harness.

A production fleet does not fail on cue: devices die, recover, stall,
and the cross-node fabric degrades — often while the workload itself is
bursting. This module turns those hazards into *declarative, seed-
deterministic schedules* so robustness is a regression-testable property
instead of an incident report:

* :class:`FaultSpec` — one fault: ``kind`` ∈ {``rank_fail``,
  ``rank_recover``, ``transient_stall``, ``dcn_degrade``}, fired when the
  serving loop reaches ``at_step`` engine steps.
* :class:`FaultSchedule` — an ordered bundle of specs.
  :meth:`FaultSchedule.default` draws a randomized-but-reproducible
  drill (fail → stall → DCN brownout → recover) from a seed;
  :meth:`FaultSchedule.parse` reads the compact CLI DSL used by
  ``serve --chaos`` (``fail@4:1,stall@6:2x0.4+0.5,recover@9:1``).
* :class:`FaultInjector` — applies due faults to a live
  :class:`~repro_torch.serving.engine.Engine` between steps. ``rank_fail`` /
  ``rank_recover`` route through the elastic shrink/grow path
  (:func:`~repro_torch.serving.elastic.fail_rank` /
  :func:`~repro_torch.serving.elastic.recover_rank`); ``transient_stall``
  appends a ``transient`` :class:`~repro_torch.core.variability.VariabilityEvent`
  to the live :class:`~repro_torch.core.variability.ClusterVariability` — it
  *composes* with any pre-scheduled variability scenario, both virtual
  clocks price it; ``dcn_degrade`` temporarily shrinks the topology's
  cross-node bandwidth (restored on the virtual clock after
  ``duration``). Infeasible faults (failing the last survivor,
  recovering a live rank) are skipped and logged, never raised — a chaos
  schedule must not crash the drill it is stressing.
* :func:`run_chaos` — the drill: serve a trace under a schedule, then
  check the **chaos invariants** on the quiesced engine:

  1. zero leaked KV blocks (``used_blocks == 0 and n_seqs == 0``),
  2. every submitted request finished *or* carries a typed
     :class:`~repro_torch.serving.metrics.RejectReason`,
  3. token conservation — ``prefill_tokens + decode_tokens ==
     useful_tokens + lost_tokens`` on the engine ledger,
  4. metric sanity — every finished request has a finite, non-negative
     TTFT.

``launch/serve.py --chaos`` and the CI smoke lane run this end to end;
``benchmarks/bench_fig_chaos.py`` gates the degraded-goodput floor.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.variability import VariabilityEvent

from .engine import Engine
from .metrics import RequestRecord
from .workload import Request

__all__ = ["FAULT_KINDS", "FaultSpec", "FaultSchedule", "FaultInjector",
           "ChaosReport", "chaos_invariants", "run_chaos"]

#: the fault vocabulary, with the CLI DSL aliases in parse().
FAULT_KINDS = ("rank_fail", "rank_recover", "transient_stall", "dcn_degrade")

_KIND_ALIASES = {"fail": "rank_fail", "recover": "rank_recover",
                 "stall": "transient_stall", "dcn": "dcn_degrade"}

#: DSL grammar: kind@step[:rank][xMAG][+DUR]  e.g. stall@6:2x0.4+0.5
_SPEC_RE = re.compile(
    r"^(?P<kind>[a-z_]+)@(?P<step>\d+)"
    r"(?::(?P<rank>\d+))?"
    r"(?:x(?P<mag>[0-9.]+))?"
    r"(?:\+(?P<dur>[0-9.]+))?$")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One declarative fault, fired at ``at_step`` serving-loop steps.

    ``rank`` targets one EP rank (required for ``rank_fail`` /
    ``rank_recover``; optional for ``transient_stall``, where ``-1``
    means fleet-wide; ignored by ``dcn_degrade``). ``magnitude`` is the
    fractional slowdown (stall) or fractional DCN-bandwidth loss
    (degrade); ``duration`` is the hazard window in virtual seconds for
    the two transient kinds.
    """

    kind: str
    at_step: int
    rank: int = -1
    magnitude: float = 0.5
    duration: float = 0.5

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {FAULT_KINDS}")
        if self.at_step < 0:
            raise ValueError(f"at_step must be >= 0, got {self.at_step}")
        if self.kind in ("rank_fail", "rank_recover") and self.rank < 0:
            raise ValueError(f"{self.kind} needs a target rank")
        if self.kind in ("transient_stall", "dcn_degrade"):
            if not 0.0 < self.magnitude < 1.0:
                raise ValueError(f"{self.kind} magnitude must be in (0, 1), "
                                 f"got {self.magnitude}")
            if self.duration <= 0.0:
                raise ValueError(f"{self.kind} duration must be > 0, "
                                 f"got {self.duration}")


@dataclasses.dataclass(frozen=True)
class FaultSchedule:
    """An ordered (by ``at_step``) bundle of :class:`FaultSpec` s."""

    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "faults", tuple(
            sorted(self.faults, key=lambda f: f.at_step)))

    def __len__(self) -> int:
        return len(self.faults)

    @classmethod
    def default(cls, n_ranks: int, seed: int = 0) -> "FaultSchedule":
        """Seed-deterministic randomized drill: one rank fails early, a
        *different* rank stalls, the DCN browns out, and the failed rank
        recovers — never killing the whole fleet. Same ``(n_ranks,
        seed)`` → same schedule, so CI chaos runs are reproducible."""
        if n_ranks < 2:
            raise ValueError("default chaos schedule needs >= 2 ranks "
                             "(it fails one and keeps serving)")
        rng = np.random.default_rng(seed)
        victim = int(rng.integers(0, n_ranks))
        fail_at = int(rng.integers(3, 7))
        stall_rank = (victim + 1 + int(rng.integers(0, n_ranks - 1))) \
            % n_ranks
        return cls((
            FaultSpec("rank_fail", fail_at, rank=victim),
            FaultSpec("transient_stall", fail_at + 1 + int(rng.integers(0, 3)),
                      rank=stall_rank,
                      magnitude=0.3 + 0.2 * float(rng.random()),
                      duration=0.3 + 0.5 * float(rng.random())),
            FaultSpec("dcn_degrade", fail_at + 2 + int(rng.integers(0, 3)),
                      magnitude=0.5,
                      duration=0.5 + 0.5 * float(rng.random())),
            FaultSpec("rank_recover", fail_at + 6 + int(rng.integers(0, 4)),
                      rank=victim),
        ))

    @classmethod
    def parse(cls, spec: str, n_ranks: int) -> "FaultSchedule":
        """Parse the ``--chaos`` CLI value.

        ``"default"`` / ``"default:SEED"`` draw :meth:`default`;
        otherwise a comma-separated DSL, one fault per item::

            fail@4:1               kill rank 1 at step 4
            recover@9:1            bring rank 1 back at step 9
            stall@6:2x0.4+0.5      rank 2 runs 40% slow for 0.5 s
            dcn@7x0.5+0.8          DCN bandwidth halves for 0.8 s
        """
        spec = spec.strip()
        if spec == "default":
            return cls.default(n_ranks)
        m = re.fullmatch(r"default:(\d+)", spec)
        if m:
            return cls.default(n_ranks, seed=int(m.group(1)))
        faults: List[FaultSpec] = []
        for item in spec.split(","):
            item = item.strip()
            if not item:
                continue
            m = _SPEC_RE.fullmatch(item)
            if m is None:
                raise ValueError(
                    f"bad fault spec {item!r}; expected "
                    "kind@step[:rank][xMAG][+DUR], e.g. fail@4:1 or "
                    "stall@6:2x0.4+0.5")
            kind = _KIND_ALIASES.get(m.group("kind"), m.group("kind"))
            kw: dict = {}
            if m.group("rank") is not None:
                kw["rank"] = int(m.group("rank"))
            if m.group("mag") is not None:
                kw["magnitude"] = float(m.group("mag"))
            if m.group("dur") is not None:
                kw["duration"] = float(m.group("dur"))
            faults.append(FaultSpec(kind, int(m.group("step")), **kw))
        if not faults:
            raise ValueError("empty chaos schedule")
        return cls(tuple(faults))


class FaultInjector:
    """Applies a :class:`FaultSchedule` to a live engine between steps.

    ``poll`` fires every spec whose ``at_step`` the engine has reached;
    ``flush`` fires everything still pending (the drill uses it when the
    queue drains before the schedule does, so every fault is exercised);
    ``finish`` restores any still-open DCN degradation window. Each
    applied fault lands in ``applied`` (spec, result) and each infeasible
    one in ``skipped`` (spec, reason) — chaos must not crash the system
    it is stressing.
    """

    def __init__(self, schedule: FaultSchedule):
        self._pending: List[FaultSpec] = list(schedule.faults)
        self.applied: List[Tuple[FaultSpec, Any]] = []
        self.skipped: List[Tuple[FaultSpec, str]] = []
        # open dcn_degrade window: (virtual-time expiry, healthy config)
        self._dcn_restore: Optional[Tuple[float, Any]] = None

    def pending(self) -> bool:
        return bool(self._pending)

    def poll(self, engine: Engine) -> None:
        """Apply every fault due at the engine's current step count."""
        self._expire_dcn(engine)
        while self._pending \
                and self._pending[0].at_step <= engine.stats.steps:
            self._apply(engine, self._pending.pop(0))

    def flush(self, engine: Engine) -> None:
        """Apply every remaining fault regardless of step count."""
        while self._pending:
            self._apply(engine, self._pending.pop(0))
        self._expire_dcn(engine)

    def finish(self, engine: Engine) -> None:
        """Close any open DCN window (drill teardown)."""
        if self._dcn_restore is not None:
            engine.config = self._dcn_restore[1]
            self._dcn_restore = None

    # -- application --------------------------------------------------------

    def _expire_dcn(self, engine: Engine) -> None:
        if self._dcn_restore is not None \
                and engine.stats.virtual_time >= self._dcn_restore[0]:
            engine.config = self._dcn_restore[1]
            self._dcn_restore = None

    def _apply(self, engine: Engine, spec: FaultSpec) -> None:
        try:
            if spec.kind == "rank_fail":
                self._apply_fail(engine, spec)
            elif spec.kind == "rank_recover":
                self._apply_recover(engine, spec)
            elif spec.kind == "transient_stall":
                self._apply_stall(engine, spec)
            else:
                self._apply_dcn(engine, spec)
        except ValueError as e:
            # infeasible under the current fleet state — log, don't crash
            self.skipped.append((spec, str(e)))

    def _apply_fail(self, engine: Engine, spec: FaultSpec) -> None:
        from .elastic import fail_rank
        ctl = engine.controller
        if ctl is None:
            self.skipped.append((spec, "no controller"))
            return
        if spec.rank in ctl.dead_ranks:
            self.skipped.append((spec, f"rank {spec.rank} already dead"))
            return
        if len(ctl.dead_ranks) + 1 >= ctl.G:
            self.skipped.append((spec, "would kill the last survivor"))
            return
        self.applied.append((spec, fail_rank(engine, spec.rank)))

    def _apply_recover(self, engine: Engine, spec: FaultSpec) -> None:
        from .elastic import recover_rank
        ctl = engine.controller
        if ctl is None:
            self.skipped.append((spec, "no controller"))
            return
        if spec.rank not in ctl.dead_ranks:
            self.skipped.append((spec, f"rank {spec.rank} is not dead"))
            return
        self.applied.append((spec, recover_rank(engine, spec.rank)))

    def _apply_stall(self, engine: Engine, spec: FaultSpec) -> None:
        if engine.cluster is None:
            self.skipped.append((spec, "no cluster variability model"))
            return
        ev = VariabilityEvent(
            "transient", t_start=engine.stats.virtual_time,
            magnitude=spec.magnitude,
            device=spec.rank if spec.rank >= 0 else None,
            duration=spec.duration)
        # events is the live schedule both virtual clocks consult — the
        # injected stall composes with any pre-scheduled scenario
        engine.cluster.events.append(ev)
        self.applied.append((spec, ev))

    def _apply_dcn(self, engine: Engine, spec: FaultSpec) -> None:
        topo = engine.config.topology
        if topo is None:
            self.skipped.append((spec, "no fleet topology (flat pricing)"))
            return
        if self._dcn_restore is None:
            healthy = engine.config
        else:
            # stacked windows: keep the original healthy config, extend
            healthy = self._dcn_restore[1]
        degraded = dataclasses.replace(
            topo, dcn_bw=topo.dcn_bw * (1.0 - spec.magnitude))
        engine.config = dataclasses.replace(engine.config, topology=degraded)
        self._dcn_restore = (
            engine.stats.virtual_time + spec.duration, healthy)
        self.applied.append((spec, degraded))


# ---------------------------------------------------------------------------
# the drill
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ChaosReport:
    """What one chaos drill did and whether the invariants held."""

    applied: List[Tuple[FaultSpec, Any]]
    skipped: List[Tuple[FaultSpec, str]]
    records: List[RequestRecord]
    violations: List[str]
    steps: int = 0

    @property
    def ok(self) -> bool:
        return not self.violations

    def summary(self) -> str:
        kinds = ",".join(s.kind for s, _ in self.applied) or "none"
        return (f"chaos: {len(self.applied)} faults applied [{kinds}], "
                f"{len(self.skipped)} skipped, "
                f"{len(self.violations)} violations")


def chaos_invariants(engine: Engine) -> List[str]:
    """Check the post-drill invariants on a quiesced engine; returns the
    violations (empty = healthy). See the module docstring for the list."""
    violations: List[str] = []
    kv = engine.kv
    if kv.used_blocks != 0 or kv.n_seqs != 0:
        violations.append(
            f"leaked KV: {kv.used_blocks} blocks / {kv.n_seqs} seqs still "
            "held after quiesce")
    st = engine.stats
    processed = st.prefill_tokens + st.decode_tokens
    accounted = st.useful_tokens + st.lost_tokens
    if processed != accounted:
        violations.append(
            f"token ledger broken: prefill+decode={processed} != "
            f"useful+lost={accounted} "
            f"(prefill={st.prefill_tokens} decode={st.decode_tokens} "
            f"useful={st.useful_tokens} lost={st.lost_tokens})")
    for rec in engine.records.values():
        finished = np.isfinite(rec.finished_at)
        if not finished and not rec.rejected:
            violations.append(
                f"request {rec.req_id} neither finished nor carries a "
                "typed rejection")
        if finished and not (np.isfinite(rec.ttft) and rec.ttft >= 0):
            violations.append(
                f"request {rec.req_id} finished with insane TTFT "
                f"{rec.ttft!r}")
    return violations


def run_chaos(engine: Engine, requests: Sequence[Request],
              schedule: FaultSchedule, max_steps: int = 20_000,
              ) -> ChaosReport:
    """Serve ``requests`` under ``schedule``, then audit the invariants.

    The drill never raises on a fault the fleet state makes infeasible —
    those are logged in ``ChaosReport.skipped``. If the queue drains
    before the schedule does, the remaining faults are flushed and the
    engine gets another chance to run (a flushed ``rank_fail`` requeues
    drained work).
    """
    injector = FaultInjector(schedule)
    engine.submit(list(requests))
    steps = 0
    while steps < max_steps:
        injector.poll(engine)
        if not engine.step():
            if injector.pending():
                injector.flush(engine)
                if engine.step():
                    steps += 1
                    continue
            break
        steps += 1
    injector.finish(engine)
    return ChaosReport(applied=injector.applied, skipped=injector.skipped,
                       records=list(engine.records.values()),
                       violations=chaos_invariants(engine), steps=steps)
