#!/usr/bin/env python3
"""Where a full-width training step's forward spends its host-clock time,
for one checkout.

    python3 scripts/forward_trace.py --root DIR [--label NAME] [--steps 5]
        [--batch 16] [--seq-len 256]

Runs granite-moe-3b-a800m at full width on the card with the port under
``DIR/src`` (its kernels built into ``DIR/build``), as ``chip_smoke.py``'s
``train_step_profile`` steps it (seed 0, synthetic batches, AdamW): one
warm step, then ``--steps`` steps, each split on the host clock
(synchronised) into the forward, the backward and AdamW, with the caching
allocator's counters over each part (``cudaMalloc`` and ``cudaFree`` calls,
retries after a failed allocation, reserved bytes) and Python's garbage
collections in it (their time on the host clock and their count by
generation, from ``gc.callbacks``); then one more forward
under ``torch.profiler`` with the host's and the device's activity: its
wall, the device's busy time, the host operations that took the most time
(by self time, CUDA runtime calls included) and the device's largest
kernels. Only the port's public entry points are used, so that two
checkouts run the same script. To compare two checkouts, run it for each
in turns in one command on one card (parent, change, change, parent). The
last line of standard output is the result as JSON; with ``--out`` it is
also written there. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import gc
import json
import pathlib
import statistics
import sys
import time

ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries",
              "num_sync_all_streams")


class _GcClock:
    """Python's garbage collections since it was made: host-clock ms and
    the count of each generation's."""

    def __init__(self):
        self.t0 = 0.0
        self.counts = {"gc_ms": 0.0, "gc_gen0": 0, "gc_gen1": 0, "gc_gen2": 0}
        gc.callbacks.append(self)

    def __call__(self, phase, info):
        if phase == "start":
            self.t0 = time.perf_counter()
        else:
            self.counts["gc_ms"] += (time.perf_counter() - self.t0) * 1e3
            self.counts[f"gc_gen{info['generation']}"] += 1


def _counts(torch, gcc: _GcClock) -> dict:
    st = torch.cuda.memory_stats()
    out = {k: st.get(k, 0) for k in ALLOC_KEYS}
    out["reserved_bytes"] = st.get("reserved_bytes.all.current", 0)
    return out | gcc.counts


def _delta(a: dict, b: dict) -> dict:
    return {k: b[k] - a[k] for k in a}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path, required=True)
    ap.add_argument("--label", default=None)
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--out", type=pathlib.Path, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("forward_trace: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    label = args.label or root.name
    sys.path.insert(0, str(root / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import get
    from repro_torch.kernels import build
    from repro_torch.models import init_params, loss_fn, make_moe_tables
    from repro_torch.training import (AdamWConfig, DataConfig, adamw_init,
                                      adamw_update, cosine_lr,
                                      synthetic_batch)
    from repro_torch.tree import leaves, tree_map
    build.build_all()
    dev = torch.device("cuda")
    cfg = get("granite-moe-3b-a800m")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    mt = make_moe_tables(cfg, device=dev)
    lossf = loss_fn(cfg)
    data = DataConfig(seq_len=args.seq_len, global_batch=args.batch)
    gcc = _GcClock()

    def batch(s):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in synthetic_batch(cfg, data, s).items()}

    def step(s, prof=None):
        """One step of ``launch/train.py``'s kind: each part's host-clock
        seconds and allocator counters; under ``prof``, the forward alone
        is traced."""
        nonlocal params, opt
        b = batch(s)
        torch.cuda.synchronize()
        marks = [(time.perf_counter(), _counts(torch, gcc))]
        if prof is None:
            loss, _ = lossf(params, b, mt)
        else:
            with prof:
                loss, _ = lossf(params, b, mt)
                torch.cuda.synchronize()
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _counts(torch, gcc)))
        loss.backward()
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _counts(torch, gcc)))
        grads = tree_map(lambda p: p.grad, params)
        params, opt = adamw_update(grads, opt, params, ocfg,
                                   cosine_lr(ocfg, opt.step))
        for p in leaves(params):
            p.grad = None
        del grads
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), _counts(torch, gcc)))
        parts = ("forward", "backward", "adamw")
        return {k: {"ms": (marks[i + 1][0] - marks[i][0]) * 1e3,
                    **_delta(marks[i][1], marks[i + 1][1])}
                for i, k in enumerate(parts)}

    step(0)
    runs = [step(s) for s in range(1, 1 + args.steps)]
    for i, r in enumerate(runs, 1):
        print(f"[{label}] step {i}: " + "; ".join(
            f"{k} {v['ms']:.1f} ms (cudaMalloc {v['num_device_alloc']}, "
            f"cudaFree {v['num_device_free']}, retries "
            f"{v['num_alloc_retries']}; gc {v['gc_ms']:.1f} ms, "
            f"{v['gc_gen0']} / {v['gc_gen1']} / {v['gc_gen2']} by "
            f"generation)" for k, v in r.items()), flush=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    traced = step(1 + args.steps, prof)
    ev = prof.key_averages()
    dev_ev = [e for e in ev if e.device_type == DeviceType.CUDA]
    host_ev = [e for e in ev if e.device_type == DeviceType.CPU]
    busy_ms = sum(e.self_device_time_total for e in dev_ev) / 1e3
    top_host = sorted(host_ev, key=lambda e: -e.self_cpu_time_total)[:12]
    top_dev = sorted(dev_ev, key=lambda e: -e.self_device_time_total)[:8]
    fwd_ms = traced["forward"]["ms"]
    print(f"[{label}] traced forward: wall {fwd_ms:.1f} ms (the trace "
          f"included), device busy {busy_ms:.1f} ms", flush=True)
    for e in top_host:
        print(f"[{label}]   host {e.self_cpu_time_total / 1e3:8.2f} ms "
              f"{e.count:6d} x  {e.key[:90]}", flush=True)
    for e in top_dev:
        print(f"[{label}]   device {e.self_device_time_total / 1e3:8.2f} ms "
              f"{e.count:6d} x  {e.key[:90]}", flush=True)
    res = {
        "label": label, "root": str(root),
        "steps": runs,
        "median_ms": {k: statistics.median(r[k]["ms"] for r in runs)
                      for k in ("forward", "backward", "adamw")},
        "traced_forward": {
            "wall_ms": fwd_ms, "device_busy_ms": busy_ms,
            "alloc": {k: v for k, v in traced["forward"].items()
                      if k != "ms"},
            "host_top": [{"name": e.key, "count": e.count,
                          "self_ms": e.self_cpu_time_total / 1e3}
                         for e in top_host],
            "device_top": [{"name": e.key, "count": e.count,
                            "self_ms": e.self_device_time_total / 1e3}
                           for e in top_dev]},
        "peak_bytes": torch.cuda.max_memory_allocated()}
    line = json.dumps(res)
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
