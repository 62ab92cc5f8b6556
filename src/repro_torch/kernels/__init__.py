# Hand-written Hopper kernels for the MoE hot spot: the ragged grouped
# expert FFN (CUDA C++, csrc/ragged_moe_ffn.cu) and the fused router
# (Triton, router.py). ops.py = the CPU/CUDA dispatch; ref.py = the plain
# PyTorch versions; build.py = nvcc + ctypes.
from . import ops, ref

__all__ = ["ops", "ref"]
