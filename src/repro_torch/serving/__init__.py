# Serving substrate of the port: the copied numpy modules (config, kvcache,
# metrics, scheduler, workload, simulator) and the PyTorch engine. The
# elastic and fault-injection drills are a later slice. The scheduler
# registry here is the port's own object, separate from the reference's.
from .config import (EngineConfig, KVCacheConfig, SchedulerConfig,
                     ServingConfig, SimConfig)
from .engine import Engine, EngineStats
from .kvcache import BlockAllocator, PagedKVCache
from .metrics import PAPER_SLOS, SLO, RejectReason, RequestRecord, goodput, \
    per_tenant_ttft, slo_frontier, summarize
from .scheduler import (Action, Chunk, RequestView, Scheduler,
                        SchedulerContext, UnknownSchedulerError,
                        get_scheduler, register_scheduler,
                        registered_schedulers, shed_victims)
from .simulator import (EPSimulator, LayerStats, rank_latency_matrix,
                        realized_rank_loads)
from .workload import (TRACES, WORKLOADS, ArrivalSpec, Request, TenantSpec,
                       TraceSpec, WorkloadSpec, routing_profile,
                       sample_arrivals, sample_requests, sample_trace,
                       step_loads)

__all__ = [
    "EngineConfig", "KVCacheConfig", "SchedulerConfig", "ServingConfig",
    "SimConfig",
    "Engine", "EngineStats",
    "BlockAllocator", "PagedKVCache",
    "PAPER_SLOS", "SLO", "RejectReason", "RequestRecord", "goodput",
    "per_tenant_ttft", "slo_frontier", "summarize",
    "Action", "Chunk", "RequestView", "Scheduler", "SchedulerContext",
    "UnknownSchedulerError", "get_scheduler", "register_scheduler",
    "registered_schedulers", "shed_victims",
    "EPSimulator", "LayerStats", "rank_latency_matrix",
    "realized_rank_loads",
    "TRACES", "WORKLOADS", "ArrivalSpec", "Request", "TenantSpec",
    "TraceSpec", "WorkloadSpec", "routing_profile", "sample_arrivals",
    "sample_requests", "sample_trace", "step_loads",
]
