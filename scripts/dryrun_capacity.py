#!/usr/bin/env python3
"""A dry-run cell on the capacity path beside the ragged path.

    PYTHONPATH=src python scripts/dryrun_capacity.py \
        [--arch granite-moe-3b-a800m] [--shape train_4k] [--mesh 16x16]

Traces rank 0's step of the cell on ``meta`` in a fake group
(``repro_torch.launch.dryrun.measure``) twice, each in a process of its
own (a fake default group a process): with the MoE layers on the ragged
path, as the dry run's sweep traces them, and on the capacity path
(``make_rules(..., moe_impl="capacity")``). Prints each one's memory a
device (the reference's four terms and their total), FLOPs, bytes,
collective bytes and the MoE kernels' calls and FLOPs; the last line of
standard output is the result as JSON. Needs no card.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))


def _cell(arch, shape, mesh, impl, out):
    from repro_torch.configs import SHAPES, get
    from repro_torch.launch.dryrun import measure
    m = measure(get(arch), SHAPES[shape], mesh, 0, moe_impl=impl)
    c = m["costs"]
    out.put({"memory": m["memory"], "flops": c.flops,
             "bytes": c.bytes_accessed,
             "collective_bytes": c.collective_bytes,
             "kernel_calls": dict(c.kernel_calls),
             "kernel_flops": dict(c.kernel_flops),
             "trace_s": m["trace_s"]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="granite-moe-3b-a800m")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--mesh", default="16x16")
    args = ap.parse_args()
    mesh = tuple(int(v) for v in args.mesh.split("x"))
    ctx = mp.get_context("spawn")
    res = {}
    for impl in ("ragged", "capacity"):
        q = ctx.Queue()
        proc = ctx.Process(target=_cell,
                           args=(args.arch, args.shape, mesh, impl, q))
        proc.start()
        res[impl] = q.get()
        proc.join()
        r = res[impl]
        mem = r["memory"]
        moe = {k: (r["kernel_calls"][k], r["kernel_flops"].get(k, 0.0))
               for k in sorted(r["kernel_calls"]) if "moe_ffn" in k}
        print(f"[dryrun] {args.arch} {args.shape} rank 0 of {args.mesh}, "
              f"{impl}: {mem['per_device_total_bytes'] / 2**30:.2f} GiB a "
              f"device (arguments {mem['argument_size_in_bytes'] / 2**30:.2f}"
              f", temporaries {mem['temp_size_in_bytes'] / 2**30:.2f}, "
              f"outputs {mem['output_size_in_bytes'] / 2**30:.2f}, aliased "
              f"{mem['alias_size_in_bytes'] / 2**30:.2f}); FLOPs "
              f"{r['flops']:.4g}, bytes {r['bytes']:.4g}, collective bytes "
              f"{r['collective_bytes']:.4g}; MoE kernels (calls, FLOPs) "
              f"{json.dumps(moe)}; traced in {r['trace_s']:.1f} s",
              flush=True)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
