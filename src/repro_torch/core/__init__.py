# The paper's primary contribution: ViBE — Variability-Informed Binning of
# Experts. Hardware-aware expert placement for distributed MoE serving.
from .activation import ActivationProfiler, routing_tally
from .controller import PlacementUpdate, ViBEConfig, ViBEController
from .drift import (DriftConfig, DriftDetector, DriftEvent, PerfDriftConfig,
                    PerfDriftDetector, PerfDriftEvent, cosine_distance)
from .incremental import (IncrementalResult, SlotSwap, Swap,
                          incremental_update, incremental_update_replicated)
from .perf_model import (DeviceProfile, PerfModel, TelemetryBuffer,
                         fit_perf_model, profile_device, refit_from_samples)
from .placement import (Placement, ReplicatedPlacement, compact_placement,
                        contiguous_placement, default_slots_per_rank,
                        eplb_placement, gem_placement, harmoeny_placement,
                        inflate_placement, layer_latency_span,
                        normalize_slot_budget, pad_phantom_column,
                        placement_to_permutation, permutation_to_placement,
                        predicted_layer_latency, predicted_rank_latencies,
                        reweight_shares_by_speed, solve_model_placement,
                        vibe_placement, vibe_r_placement)
from .policy import (PlacementPolicy, PolicyCapabilities, SolveContext,
                     UnknownPolicyError, get_policy, register_policy,
                     registered_policies)
from .steal import StealConfig, TokenRescheduler
from .topology import ClusterTopology, parse_topology, vibe_h_placement
from .variability import (REGIMES, SCENARIOS, ClusterVariability,
                          VariabilityEvent, VariabilityRegime, make_cluster,
                          make_scenario)

__all__ = [
    "ActivationProfiler", "routing_tally",
    "PlacementUpdate", "ViBEConfig", "ViBEController",
    "DriftConfig", "DriftDetector", "DriftEvent", "cosine_distance",
    "PerfDriftConfig", "PerfDriftDetector", "PerfDriftEvent",
    "IncrementalResult", "SlotSwap", "Swap", "incremental_update",
    "incremental_update_replicated",
    "DeviceProfile", "PerfModel", "TelemetryBuffer", "fit_perf_model",
    "profile_device", "refit_from_samples",
    "Placement", "ReplicatedPlacement", "compact_placement",
    "contiguous_placement",
    "default_slots_per_rank", "eplb_placement", "gem_placement",
    "harmoeny_placement", "inflate_placement", "layer_latency_span",
    "normalize_slot_budget",
    "pad_phantom_column", "placement_to_permutation",
    "permutation_to_placement",
    "predicted_layer_latency", "predicted_rank_latencies",
    "reweight_shares_by_speed", "solve_model_placement", "vibe_placement",
    "vibe_r_placement",
    "PlacementPolicy", "PolicyCapabilities", "SolveContext",
    "UnknownPolicyError", "get_policy", "register_policy",
    "registered_policies",
    "StealConfig", "TokenRescheduler",
    "ClusterTopology", "parse_topology", "vibe_h_placement",
    "REGIMES", "SCENARIOS", "ClusterVariability", "VariabilityEvent",
    "VariabilityRegime", "make_cluster", "make_scenario",
]
