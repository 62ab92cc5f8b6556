#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It

1. prints the torch and CUDA versions and the card's name and power limit;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and times the build;
3. holds each kernel against its plain PyTorch version on the card at the
   slice's shapes — the ragged grouped FFN for a 512-token prefill plan and
   an 8-lane decode plan (Zipf-skewed routing, some experts empty), the
   router at T=4096 and at the main path's T=512 and T=8 (E=40, K=8) — and
   times kernel, plain version and bound;
4. runs one full-width granite MoE layer through the ragged dispatch with
   the kernel and with the plain version;
5. serves 8 sharegpt requests with the published ``granite-moe-3b-a800m``
   config (32 layers, full widths, seeded random weights) through the
   port's serve construction under ``vibe``, and checks that every request
   finishes, the logits are finite, and both kernels launched exactly
   32 times per model call;
6. admits a second batch into the same engine and traces 16 decode steps
   with ``torch.profiler``: the device's busy and idle share of a step and
   its largest kernels.

Every check raises, so any failure exits non-zero. The last three lines of
standard output are the kernels' JSON record, the ``nvidia-smi`` name and
power-limit line, and ``{"ok": true, "device": {...}}``. Without a CUDA
device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, f32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12

BF16_TOL = 5e-2       # the repo's bf16 tolerance (tests/test_kernels.py)
ROUTER_W_TOL = 1e-5   # f32 weights; indices must be exactly equal


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


def median_ms(fn, reps: int, warmup: int = 2) -> float:
    """Median of ``reps`` single-call times from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    evs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        evs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in evs)


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_b, t_o = n_bytes / HBM_BPS * 1e3, n_ops / peak_ops * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def zipf_slots(gen, n: int, n_slots: int, empty):
    import torch
    p = 1.0 / torch.arange(1, n_slots + 1, dtype=torch.float64) ** 1.2
    p[[e for e in empty if e < n_slots]] = 0.0
    return torch.multinomial(p / p.sum(), n, replacement=True,
                             generator=gen).to(torch.int32)


def ragged_case(name, tokens, cfg, gen, cgen, dev):
    """A dispatch plan at the slice's shapes → kernel vs plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import _ragged_plan
    from repro_torch.models.sharding import ShardingRules
    E, D, F, K = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    bm = ShardingRules().moe_block_m
    A = tokens * K
    slot_flat = zipf_slots(gen, A, E, empty=(5, 17, 33)).to(dev)
    order, rows, tile_group, n_rows = _ragged_plan(slot_flat, E, bm)
    x = torch.randn((tokens, D), generator=cgen,
                    device=dev).to(torch.bfloat16)
    buf = x.new_zeros((n_rows + 1, D))
    buf[rows.long()] = x[torch.div(order, K, rounding_mode="floor")]
    buf = buf[:n_rows]
    w = [(torch.randn(s, generator=cgen, device=dev) / math.sqrt(s[1])).to(
        torch.bfloat16) for s in ((E, D, F), (E, D, F), (E, F, D))]
    y = ops.ragged_moe_ffn(w[0], w[1], w[2], buf, tile_group)
    y_ref = ref.ragged_moe_ffn_ref(w[0], w[1], w[2], buf, tile_group)
    torch.cuda.synchronize()
    err = (y.float() - y_ref.float()).abs().max().item()
    sentinel = (tile_group >= E).repeat_interleave(bm)
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    check(err <= BF16_TOL, f"{name}: max |kernel - plain| {err} > {BF16_TOL}")
    check(bool((y[sentinel] == 0).all()), f"{name}: sentinel rows not zero")
    ms = median_ms(lambda: ops.ragged_moe_ffn(w[0], w[1], w[2], buf,
                                              tile_group), reps=25)
    plain_ms = median_ms(lambda: ref.ragged_moe_ffn_ref(w[0], w[1], w[2], buf,
                                                        tile_group), reps=5)
    occupied = tile_group < E
    n_exp = len(torch.unique(tile_group[occupied]))
    occ_rows = int(occupied.sum()) * bm
    n_bytes = (occ_rows * D * 2 + n_rows * D * 2 + tile_group.numel() * 4
               + n_exp * 3 * D * F * 2)
    bound_ms, by = bound(n_bytes, 2 * 3 * D * F * A, BF16_FLOPS)
    print(f"[kernel] ragged_moe_ffn {name}: tokens={tokens} A={A} "
          f"T={n_rows} tiles={tile_group.numel()} occupied={int(occupied.sum())}"
          f" experts={n_exp}: max_abs_err={err:.3e} (tol {BF16_TOL}), "
          f"sentinel rows exactly 0, kernel {ms:.4f} ms, plain {plain_ms:.4f}"
          f" ms, bound {bound_ms:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB)")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by}


def router_case(cgen, dev, T, E=40, K=8):
    import torch
    from repro_torch.kernels import ops, ref
    logits = torch.randn((T, E), generator=cgen, device=dev)
    w, idx = ops.router_topk(logits, K)
    w_ref, idx_ref = ref.router_topk_ref(logits, K)
    torch.cuda.synchronize()
    check(bool(torch.equal(idx, idx_ref)), "router: indices differ")
    err = (w - w_ref).abs().max().item()
    check(err <= ROUTER_W_TOL, f"router: weights differ by {err}")
    ms = median_ms(lambda: ops.router_topk(logits, K), reps=50)
    plain_ms = median_ms(lambda: ref.router_topk_ref(logits, K), reps=10)
    n_bytes = T * E * 4 + T * K * 8
    # softmax ~5 ops/element, each of the K sweeps ~6 ops/element
    bound_ms, by = bound(n_bytes, T * E * (5 + 6 * K), F32_FLOPS)
    print(f"[kernel] router_topk T={T} E={E} K={K}: indices exactly equal, "
          f"max_abs_err(weights)={err:.3e} (tol {ROUTER_W_TOL}), kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
          f"({by})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by}


def layer_case(cfg, cgen, dev, tokens=512):
    """One full-width MoE layer, ffn=kernel vs ffn=plain version."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models.moe import _dense_dispatch_ragged, moe_init
    from repro_torch.models.sharding import ShardingRules
    E = cfg.n_experts
    p = moe_init(cgen, d=cfg.d_model, f=cfg.moe_d_ff, n_experts=E,
                 n_slots=E, device=dev)
    xf = torch.randn((tokens, cfg.d_model), generator=cgen,
                     device=dev).to(torch.bfloat16)
    tables = dict(slots_of=torch.arange(E, dtype=torch.int32,
                                        device=dev)[:, None],
                  n_copies=torch.ones(E, dtype=torch.int32, device=dev),
                  copy_cdf=torch.ones((E, 1), device=dev))
    seed = torch.tensor(7, dtype=torch.int32, device=dev)
    out = {}
    for name, ffn in (("kernel", ops.ragged_moe_ffn),
                      ("plain", ref.ragged_moe_ffn_ref)):
        out[name] = _dense_dispatch_ragged(
            p, xf, seed, top_k=cfg.top_k, n_experts=E,
            bm=ShardingRules().moe_block_m, ffn=ffn, **tables)
    torch.cuda.synchronize()
    (y_k, t_k, _), (y_p, t_p, _) = out["kernel"], out["plain"]
    check(bool(torch.equal(t_k, t_p)), "MoE layer: tallies differ")
    check(float(t_k.sum()) == tokens * cfg.top_k, "MoE layer: tally total")
    err = (y_k.float() - y_p.float()).abs().max().item()
    check(bool(torch.isfinite(y_k).all()) and err <= BF16_TOL,
          f"MoE layer: max |kernel - plain| {err} > {BF16_TOL}")
    print(f"[layer] granite MoE layer, {tokens} tokens, ffn=kernel vs "
          f"ffn=plain: tallies equal, max_abs_err={err:.3e} (tol {BF16_TOL})")


def serve_slice(cfg, dev):
    """The main path: the published config through the port's engine."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, make_requests
    from repro_torch.serving import summarize
    max_seq = 1024
    t0 = time.perf_counter()
    engine = build_engine(cfg, policy="vibe", regime="mi325x", max_batch=8,
                          max_seq=max_seq, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(engine.params))
    print(f"[slice] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, "
          f"{n_params / 1e9:.3f} B params in bf16, built in "
          f"{time.perf_counter() - t0:.1f} s")
    finite = []

    def watch(fn):
        def call(*args, **kw):
            res = fn(*args, **kw)
            finite.append(torch.isfinite(res[0]).all())
            return res
        return call

    engine._prefill = watch(engine._prefill)
    engine._decode = watch(engine._decode)
    engine.submit(make_requests("sharegpt", 8, qps=50.0, max_seq=max_seq,
                                seed=0))
    st = engine.stats
    t_prefill, t_decode = [], []
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    while True:
        p0 = st.prefill_steps
        ts = time.perf_counter()
        if not engine.step():
            break
        torch.cuda.synchronize()
        (t_prefill if st.prefill_steps > p0 else t_decode).append(
            time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    records = list(engine.records.values())
    calls = st.prefill_steps + st.decode_steps
    check(all(np.isfinite(r.finished_at) for r in records) and
          len(records) == 8, "not every request finished")
    check(all(bool(f) for f in finite) and len(finite) == calls,
          "non-finite logits")
    for name, n in counts.items():
        check(n == cfg.n_layers * calls,
              f"{name} launched {n} times, expected {cfg.n_layers} x "
              f"{calls} model calls")
    s = summarize(records)
    print(f"[slice] {st.steps} steps ({st.prefill_steps} prefill / "
          f"{st.decode_steps} decode), {st.prefill_tokens} prefill + "
          f"{st.decode_tokens} decode tokens, wall {wall:.2f} s, median "
          f"prefill step {statistics.median(t_prefill) * 1e3:.2f} ms, median "
          f"decode step {statistics.median(t_decode) * 1e3:.2f} ms")
    print(f"[slice] virtual clock: TTFT p50/p90 = {s['ttft_p50']:.4f}/"
          f"{s['ttft_p90']:.4f} s, TPOT p50 = {s['tpot_p50']:.5f} s; "
          f"recalibrations {st.migrations} (migrated slots "
          f"{st.migrated_slots})")
    print(f"[slice] launches: {json.dumps(counts)} = {cfg.n_layers} x "
          f"{calls} model calls; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return engine, counts


def trace_decode(engine, n_steps: int = 16) -> None:
    """Device busy share of full-width decode steps, from a profiler trace.

    Admits a fresh batch into the served engine (after the main path's
    counts were read), runs its prefills untraced, then traces ``n_steps``
    batched decode steps: the device's busy time is the sum of its kernel
    and copy durations, against the host-clock wall time of the window.
    """
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.launch.serve import make_requests
    engine.submit(make_requests("sharegpt", engine.max_batch, qps=50.0,
                                max_seq=engine.max_seq, seed=1))
    while engine.waiting:
        engine.step()
    lanes = sum(r is not None for r in engine.slot_req)
    torch.cuda.synchronize()
    d0 = engine.stats.decode_steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_steps):
            engine.step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = engine.stats.decode_steps - d0
    check(steps == n_steps, f"trace window ran {steps} decode steps, "
          f"expected {n_steps}")
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    if not dev_events or busy_ms <= 0:
        print(f"[trace] {n_steps} decode steps ({lanes} lanes), wall "
              f"{wall_ms / n_steps:.2f} ms/step under the profiler; device "
              "busy time not measured (the profiler saw no device events)")
        return
    launches = sum(e.count for e in dev_events)
    print(f"[trace] {n_steps} decode steps ({lanes} lanes) under the "
          f"profiler: wall {wall_ms / n_steps:.2f} ms/step, device busy "
          f"{busy_ms / n_steps:.2f} ms/step ({100 * busy_ms / wall_ms:.1f}%, "
          f"idle {100 - 100 * busy_ms / wall_ms:.1f}%), "
          f"{launches / n_steps:.0f} device kernels and copies per step")
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
    # the port's own kernels, wherever they rank
    top += [e for e in dev_events if e not in top and any(
        k in e.key for k in ("gate_up_kernel", "down_kernel", "router_topk"))]
    for e in top:
        print(f"[trace]   {e.self_device_time_total / 1e3 / n_steps:8.3f} "
              f"ms/step  {e.count / n_steps:6.1f} x/step  {e.key[:90]}")


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke test needs one",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get as get_config
    from repro_torch.kernels import build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"({smi})", flush=True)
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"[build] {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    cfg = get_config("granite-moe-3b-a800m")
    gen = torch.Generator().manual_seed(0)             # routing draws
    cgen = torch.Generator(device=dev)                 # tensors on the card
    cgen.manual_seed(0)
    prefill = ragged_case("prefill-512", 512, cfg, gen, cgen, dev)
    ragged_case("decode-8", 8, cfg, gen, cgen, dev)
    t0 = time.perf_counter()
    router_case(cgen, dev, T=4096)
    print(f"[build] router (Triton) compiled and checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the main path's shapes: one 512-token prompt, an 8-lane decode batch
    router = router_case(cgen, dev, T=512)
    router_case(cgen, dev, T=8)
    layer_case(cfg, cgen, dev)
    engine, counts = serve_slice(cfg, dev)
    trace_decode(engine)

    kernels = [
        {"name": "ragged_moe_ffn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ragged_moe_ffn.cu",
         "replaces": "src/repro/kernels/ragged_moe_ffn.py:101",
         "launches": counts["ragged_moe_ffn"], **prefill,
         "library_ms": None},
        {"name": "router_topk", "route": "triton",
         "source": "src/repro_torch/kernels/router.py",
         "replaces": "src/repro/kernels/router.py:46",
         "launches": counts["router_topk"], **router, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
