# Hand-written Hopper kernels for the MoE hot spot: the ragged grouped
# expert FFN (CUDA C++, csrc/ragged_moe_ffn.cu), the capacity-bucket expert
# FFN (CUDA C++, csrc/moe_ffn.cu; both share csrc/moe_ffn_hopper.cuh and
# csrc/moe_ffn_blocks.cuh) and the fused routing stage (CUDA C++,
# csrc/route_select.cu), and the attention's prefill and decode (CUDA C++,
# csrc/flash_attention.cu) and the prefill's backward (CUDA C++,
# csrc/flash_attention_bwd.cu; both share csrc/flash_common.cuh; flash.py,
# the plain versions models/flash.py).
# router.py is the earlier Triton router, on no path.
# ops.py = the CPU/CUDA dispatch; ref.py = the plain PyTorch versions;
# build.py = nvcc + ctypes.
from . import ops, ref

__all__ = ["ops", "ref"]
