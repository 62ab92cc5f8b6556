"""Device resolution for the port's entry points.

Every entry point runs on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda``, and a missing card raises instead of
silently moving the run to the host. The CPU is reached only by naming it
(``device="cpu"``), as the tests do.

TF32 is switched off here, explicitly, for both matrix products and cuDNN:
the JAX reference computes its float32 products in full float32, and the
router's f32 logits decide top-k ties, so the port must not round them to
TF32's ten mantissa bits.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``None`` → ``cuda``; a CUDA device without a card raises.

    Never falls back to the CPU: pass ``device="cpu"`` to run there.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device=\"cpu\" to run on the host")
    return dev
