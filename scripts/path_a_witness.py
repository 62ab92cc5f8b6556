#!/usr/bin/env python3
"""Path A's dropped assignments with the fused routing stage and with the
unfused sequence it replaced, on one card.

    python3 scripts/path_a_witness.py

Serves granite-moe-3b-a800m at full width on the capacity path as
``chip_smoke.py``'s path A does (8 sharegpt requests, the same seeds)
twice: first through ``ops.route_select`` (the fused kernel), then with
every MoE layer's routing call sent to ``chip_smoke.unfused_route`` (the
f32 product, the Triton router, the eager replica choice, tally and aux
loss). Prints each run's dropped assignments and steps; the last line of
standard output is both as JSON. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def serve_drops(cfg, dev, route_select=None):
    """Path A served once; ``route_select`` replaces ``ops.route_select``
    in the MoE layer while it runs. Returns (dropped assignments, steps)."""
    from repro_torch.launch.serve import build_engine, make_requests
    from repro_torch.models import moe as tmoe
    real = tmoe.ops

    class Ops:
        def __getattr__(self, name):
            return getattr(real, name)

    if route_select is not None:
        Ops.route_select = staticmethod(route_select)
        tmoe.ops = Ops()
    try:
        engine = build_engine(cfg, policy="vibe", regime="mi325x",
                              max_batch=8, max_seq=1024, seed=0, device=dev,
                              moe_impl="capacity")
        engine.submit(make_requests("sharegpt", 8, qps=50.0, max_seq=1024,
                                    seed=0))
        while engine.step():
            pass
    finally:
        tmoe.ops = real
    return float(engine.stats.dropped_assignments), engine.stats.steps


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("path_a_witness: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import build
    build.build_all()
    cfg = get("granite-moe-3b-a800m")
    dev = torch.device("cuda")

    def unfused(x, w, so, nc, cdf, seed, k, row_valid=None):
        return cs.unfused_route(x, w, (so, nc, cdf), seed, k, row_valid)

    res = {}
    for name, fn in (("fused", None), ("unfused", unfused)):
        drops, steps = serve_drops(cfg, dev, fn)
        print(f"[path A, {name} routing] {steps} steps, dropped "
              f"assignments {drops:.0f}", flush=True)
        res[name] = {"dropped_assignments": drops, "steps": steps}
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
