"""ViBE on PyTorch and CUDA: the port of the JAX package ``repro``.

The port imports ``torch`` and never ``jax`` or anything of ``repro``.
Modules that hold no JAX in the reference are copied verbatim
(``configs``, ``core``, ``serving.{config,kvcache,metrics,scheduler,
workload,simulator}``; only ``repro.`` becomes ``repro_torch.``), and a
test holds each copy equal to its original. Their registries — placement
policies, schedulers — are the port's own objects, separate from the
reference's: registering a plugin in one does not reach the other.

Entry points run on the card unless the caller asks for the CPU
(:func:`repro_torch.device.resolve_device`). On a CUDA tensor the MoE layer
runs two hand-written Hopper kernels, the ragged grouped FFN (CUDA C++)
and the router (Triton); on a CPU tensor it runs their plain versions.
"""

__all__ = ["bridge", "configs", "core", "device", "kernels", "launch",
           "models", "serving"]
