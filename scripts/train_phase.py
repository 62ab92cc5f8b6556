#!/usr/bin/env python3
"""The training phase of ``chip_smoke.py`` alone, for a short run on a card.

    python3 scripts/train_phase.py

Builds the kernels, then runs ``chip_smoke.py``'s training checks in its
order: the backward kernels against their plain versions at the training
shapes (1024 and 4096 tokens, K1 and K2 on both routes), 4 full-width
steps of granite-moe-3b-a800m with two seeded 2-step reruns, the step
profile at batch x sequence 4 x 256, 16 x 256 and
8 x 512 (the last is not in ``chip_smoke.py``: it peaks at 77 GiB), a
2-layer step through the kernels against one through the plain versions,
and the smoke-size checkpoint restart. Every check raises, as in
``chip_smoke.py``. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("train_phase: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import build
    build.build_all()
    cfg = get("granite-moe-3b-a800m")
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    cgen = torch.Generator(device=dev)
    cgen.manual_seed(0)
    t0 = time.perf_counter()
    cs.backward_ffn_case(cfg, gen, cgen, dev)
    cs.backward_ffn_case(cfg, gen, cgen, dev, tokens=4096, controls=False)
    cs.backward_route_case(cfg, cgen, dev)
    cs.train_phase(cfg, dev)
    cs.train_step_profile(cfg, dev)
    cs.train_step_profile(cfg, dev, seq_len=256, batch=16)
    cs.train_step_profile(cfg, dev, seq_len=512, batch=8)
    cs.kernel_vs_plain_step(cfg, dev)
    cs.checkpoint_restart(dev)
    print(f"[train_phase] done in {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
