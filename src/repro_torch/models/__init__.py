# Model code of the port: params as dicts of tensors with the reference's
# keys, a Python loop over blocks, the ragged and capacity MoE paths.
from .model import (LayerSpec, block_layout, count_params, decode_fn,
                    init_cache, init_params, loss_fn, make_moe_tables,
                    moe_perm_shape, prefill_fn, prefill_chunk_fn,
                    refresh_moe_share_tables)
from .moe import apply_placement, moe_layer, placement_gather_indices, route
from .sharding import ShardingRules, build_copy_cdf, build_slots_of

__all__ = [
    "LayerSpec", "block_layout", "count_params", "decode_fn", "init_cache",
    "init_params", "loss_fn",
    "make_moe_tables", "moe_perm_shape", "prefill_fn", "prefill_chunk_fn",
    "refresh_moe_share_tables",
    "apply_placement", "moe_layer", "placement_gather_indices", "route",
    "ShardingRules", "build_copy_cdf", "build_slots_of",
]
