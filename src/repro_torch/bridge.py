"""Carry the reference's params across: numpy pytree → the port's params.

``params_from_numpy(tree, device)`` takes the JAX package's params pytree
with every leaf already turned into a numpy array (the caller runs
``jax.tree.map(np.asarray, params)``; this module imports neither jax nor
the reference package) and returns the same dicts and lists of torch
tensors on ``device``. Keys, nesting and the leading ``n_blocks`` axis
match by construction, so the copy is leaf for leaf.

bf16 leaves arrive as ``ml_dtypes.bfloat16``, which ``torch.from_numpy``
rejects: they go through a ``uint16`` view and back to ``torch.bfloat16``
bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["params_from_numpy", "tensor_from_numpy"]


def tensor_from_numpy(a: np.ndarray, device=None) -> torch.Tensor:
    a = np.array(a, order="C")              # a writable copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_numpy(tree, device=None):
    """Dicts, lists and tuples of numpy arrays → the same of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)
