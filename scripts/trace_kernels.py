#!/usr/bin/env python3
"""Device kernels of a traced decode step, by name, and the difference
between two trees.

    python3 scripts/trace_kernels.py --root DIR --out FILE.json
    python3 scripts/trace_kernels.py --diff BEFORE.json AFTER.json

The first form serves granite-moe-3b-a800m at full width (seeded random
weights, 8 lanes, policy ``vibe``) with the port found under ``DIR/src``,
fills the batch, runs 4 decode steps untraced and then traces 16 with
``torch.profiler``, and writes each device kernel's launches a step to
``FILE.json``. Run it once for each of two checkouts (the same machine,
one after the other); the second form prints where their counts differ.
Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

STEPS = 16


def trace(root: pathlib.Path, out: pathlib.Path) -> int:
    sys.path.insert(0, str(root / "src"))
    import torch
    if not torch.cuda.is_available():
        print("trace_kernels: no CUDA device", file=sys.stderr)
        return 2
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.launch.serve import build_engine, make_requests
    engine = build_engine(get("granite-moe-3b-a800m"), policy="vibe",
                          regime="mi325x", max_batch=8, max_seq=1024, seed=0,
                          device="cuda")
    engine.submit(make_requests("sharegpt", 8, qps=50.0, max_seq=1024,
                                seed=1))
    while engine.waiting:
        engine.step()
    for _ in range(4):
        engine.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            engine.step()
        torch.cuda.synchronize()
    counts = {e.key: e.count / STEPS for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA}
    out.write_text(json.dumps(counts, indent=0))
    print(f"[trace] {root}: {sum(counts.values()):.2f} device kernels and "
          f"copies a decode step -> {out}")
    return 0


def diff(before: pathlib.Path, after: pathlib.Path) -> int:
    a = json.loads(before.read_text())
    b = json.loads(after.read_text())
    print(f"[diff] {sum(a.values()):.2f} -> {sum(b.values()):.2f} device "
          "kernels and copies a decode step")
    for k in sorted(set(a) | set(b),
                    key=lambda k: -abs(b.get(k, 0) - a.get(k, 0))):
        d = b.get(k, 0) - a.get(k, 0)
        if abs(d) > 0.01:
            print(f"[diff] {d:+8.2f}  {a.get(k, 0):7.2f} -> "
                  f"{b.get(k, 0):7.2f}  {k[:150]}")
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path)
    ap.add_argument("--out", type=pathlib.Path)
    ap.add_argument("--diff", nargs=2, type=pathlib.Path)
    args = ap.parse_args()
    if args.diff:
        return diff(*args.diff)
    if args.root is None or args.out is None:
        ap.error("--root and --out, or --diff")
    return trace(args.root.resolve(), args.out)


if __name__ == "__main__":
    raise SystemExit(main())
