"""Unified serving configuration (the redesigned API surface).

One frozen hierarchy configures every serving consumer:

* :class:`ServingConfig` — knobs shared by the JAX engine and the
  discrete-event simulator (batching, MoE pricing impl, scheduler).
* :class:`EngineConfig`  — the engine's surface (KV cache, sequence
  budget, routing knobs). ``Engine(cfg, EngineConfig(...))`` replaces the
  accreted keyword sprawl; the legacy kwargs still work through
  :meth:`EngineConfig.from_kwargs` (bit-identical, ``DeprecationWarning``).
* :class:`SimConfig`     — the simulator's surface (previously a mutable
  dataclass in ``serving/simulator.py``; now frozen and part of the same
  hierarchy, re-exported there for back-compat).

Sub-configs:

* :class:`KVCacheConfig`   — paged/block KV cache geometry + watermark
  admission (``serving/kvcache.py``).
* :class:`SchedulerConfig` — which registered scheduler runs the
  continuous-batching loop, chunked-prefill sizing, SLO deadlines
  (``serving/scheduler.py``).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from repro_torch.core.topology import ClusterTopology

__all__ = ["KVCacheConfig", "SchedulerConfig", "ServingConfig",
           "EngineConfig", "SimConfig"]


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    """Paged KV-cache geometry: fixed-size blocks + free-list allocator.

    ``watermark`` holds back a fraction of the block pool from admission
    (headroom for in-flight growth); admission reserves a request's full
    worst-case block count up front (``min(prompt+output, max_seq)``
    rounded up to blocks), so allocation after admission can never fail.
    """

    block_size: int = 16             # tokens per KV block
    n_blocks: int = 64               # total block pool (memory budget)
    watermark: float = 0.0           # fraction of blocks kept free

    def __post_init__(self):
        if self.block_size < 1:
            raise ValueError(f"block_size must be >= 1, got {self.block_size}")
        if self.n_blocks < 1:
            raise ValueError(f"n_blocks must be >= 1, got {self.n_blocks}")
        if not 0.0 <= self.watermark < 1.0:
            raise ValueError("watermark must be in [0, 1), "
                             f"got {self.watermark}")

    def blocks_for(self, n_tokens: int) -> int:
        """Blocks needed to hold ``n_tokens`` cache rows."""
        return max(-(-int(n_tokens) // self.block_size), 1)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Continuous-batching scheduler selection + chunked-prefill sizing.

    ``name`` is a key in the ``serving/scheduler.py`` registry (``fcfs``,
    ``slo_edf``, ``decode_priority``, or anything third parties register).
    ``prefill_chunk = 0`` keeps the legacy whole-prompt prefill; > 0 splits
    prompts into fixed-token chunks interleaved with decode steps.
    ``decode_starvation_bound`` caps consecutive prefill-only steps while
    decodes are pending (enforced by the SLO-aware policies; pinned by a
    property test). ``ttft_slo``/``tpot_slo`` are the default per-request
    deadlines (a request's own ``ttft_slo`` field overrides).

    Overload protection (off by default — legacy behaviour unchanged):
    ``shed_watermark > 0`` enables watermark load shedding — when KV-pool
    utilization reaches the watermark, waiting requests whose TTFT
    deadline has already lapsed (lowest SLO headroom first) are rejected
    with ``RejectReason.SHED`` instead of queuing forever.
    ``preempt_decodes`` lets the engine evict a running decode lane (free
    its KV, requeue the request) when waiting work is starved by KV
    pressure; each request is preempted at most ``max_preemptions`` times
    (the bounded-retry guard — beyond that it is immune, which also rules
    out preemption livelock).
    """

    name: str = "fcfs"
    prefill_chunk: int = 0           # tokens per prefill chunk; 0 = whole
    max_prefill_tokens: int = 8192   # per-step prefill token budget
    decode_starvation_bound: int = 4
    ttft_slo: float = 0.35
    tpot_slo: float = 0.125
    shed_watermark: float = 0.0      # KV utilization triggering shedding;
    #                                  0 disables (legacy)
    preempt_decodes: bool = False    # evict decodes under KV pressure
    max_preemptions: int = 2         # per-request preemption cap (backoff)

    def __post_init__(self):
        if self.prefill_chunk < 0:
            raise ValueError("prefill_chunk must be >= 0, "
                             f"got {self.prefill_chunk}")
        if self.max_prefill_tokens < 1:
            raise ValueError("max_prefill_tokens must be >= 1, "
                             f"got {self.max_prefill_tokens}")
        if self.decode_starvation_bound < 1:
            raise ValueError("decode_starvation_bound must be >= 1, "
                             f"got {self.decode_starvation_bound}")
        if not 0.0 <= self.shed_watermark <= 1.0:
            raise ValueError("shed_watermark must be in [0, 1], "
                             f"got {self.shed_watermark}")
        if self.max_preemptions < 0:
            raise ValueError("max_preemptions must be >= 0, "
                             f"got {self.max_preemptions}")


@dataclasses.dataclass(frozen=True)
class ServingConfig:
    """Knobs shared by :class:`EngineConfig` and :class:`SimConfig`."""

    max_batch: int = 4               # concurrent decode lanes / batch cap
    moe_impl: Optional[str] = None   # "ragged" | "capacity" | None=derive
    capacity_factor: float = 1.25    # bucket sizing for moe_impl="capacity"
    seed: int = 0
    scheduler: Optional[SchedulerConfig] = None   # None = legacy loop/fcfs
    topology: Optional["ClusterTopology"] = None
    # fleet topology (repro_torch.core.topology): when set, both virtual clocks
    # price a2a / migration / steal-broadcast traffic through the two-level
    # ICI/DCN model instead of the flat ici_bw divide. None keeps the
    # legacy flat pricing bit-identical.

    def __post_init__(self):
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.moe_impl not in (None, "ragged", "capacity"):
            raise ValueError("moe_impl must be 'ragged' or 'capacity', "
                             f"got {self.moe_impl!r}")


#: legacy Engine(**kwargs) names from_kwargs accepts, with their defaults
_ENGINE_LEGACY_DEFAULTS = dict(max_batch=4, max_seq=64,
                               weighted_routing=True, moe_impl=None, seed=0)


@dataclasses.dataclass(frozen=True)
class EngineConfig(ServingConfig):
    """The JAX continuous-batching engine's configuration surface."""

    max_seq: int = 64
    weighted_routing: bool = True
    kv: Optional[KVCacheConfig] = None   # None = pool sized to the lanes

    def __post_init__(self):
        super().__post_init__()
        if self.max_seq < 2:
            raise ValueError(f"max_seq must be >= 2, got {self.max_seq}")
        sched = self.scheduler
        if sched is not None and sched.prefill_chunk > 0 \
                and self.max_seq % sched.prefill_chunk != 0:
            # chunk offsets must tile the cache exactly (the chunked
            # attention writes [offset, offset+chunk) windows)
            raise ValueError(
                f"prefill_chunk ({sched.prefill_chunk}) must divide "
                f"max_seq ({self.max_seq})")

    @classmethod
    def from_kwargs(cls, **kwargs) -> "EngineConfig":
        """Deprecated shim for the legacy ``Engine(**kwargs)`` surface.

        Produces a config whose behavior is bit-identical to the legacy
        engine: whole-prompt FCFS prefill, KV block pool sized to exactly
        cover the lanes (admission never binds before a free lane does),
        zero watermark.
        """
        unknown = set(kwargs) - set(_ENGINE_LEGACY_DEFAULTS)
        if unknown:
            raise TypeError(f"unknown Engine kwargs: {sorted(unknown)}")
        warnings.warn(
            "Engine(max_batch=..., max_seq=..., ...) keyword configuration "
            "is deprecated; pass an EngineConfig instead: "
            "Engine(cfg, EngineConfig(...), controller=..., cluster=...)",
            DeprecationWarning, stacklevel=3)
        kw = {**_ENGINE_LEGACY_DEFAULTS, **kwargs}
        return cls(max_batch=kw["max_batch"], max_seq=kw["max_seq"],
                   weighted_routing=kw["weighted_routing"],
                   moe_impl=kw["moe_impl"], seed=kw["seed"])

    def resolve(self) -> "EngineConfig":
        """Fill the ``None`` sub-configs with their legacy-equivalent
        defaults (KV pool covering every lane, FCFS whole-prompt
        scheduler) so the engine runs off one fully-specified object."""
        kv = self.kv
        if kv is None:
            bs = KVCacheConfig.block_size
            kv = KVCacheConfig(
                block_size=bs,
                n_blocks=self.max_batch * math.ceil(self.max_seq / bs),
                watermark=0.0)
        sched = self.scheduler if self.scheduler is not None \
            else SchedulerConfig()
        return dataclasses.replace(self, kv=kv, scheduler=sched)


@dataclasses.dataclass(frozen=True)
class SimConfig(ServingConfig):
    """Discrete-event EP simulator configuration (see simulator.py)."""

    max_batch: int = 64              # decode batch cap
    moe_impl: str = "ragged"         # what the MoE kernel computes per rank
    ep_degree: int = 8
    max_prefill_tokens: int = 8192   # prefill chunk budget per step
    ici_bw: Optional[float] = None   # aggregate bytes/s; None = cluster preset
    act_bytes: float = 1.0           # a2a payload bytes/elem (FP8, Table 2a)
    attn_flops_scale: float = 0.35   # MLA-compression adjustment (DESIGN §4)
    poisson_loads: bool = True       # Poisson approx to multinomial (fast)
    realized_loads: bool = False     # score token-granular dispatched loads
    record_layer_stats: bool = False
    migration_overhead: float = 2e-3 # fixed coordination cost per rearrange
    step_overhead: float = 8e-3      # engine scheduling/launch cost per step
    kv: Optional[KVCacheConfig] = None   # block-pool admission (scheduled
    # loop only); None = unbounded admission, the legacy behavior

    def __post_init__(self):
        super().__post_init__()
        if self.moe_impl not in ("ragged", "capacity"):
            raise ValueError("moe_impl must be 'ragged' or 'capacity', "
                             f"got {self.moe_impl!r}")
