#!/usr/bin/env python3
"""Look inside the fused routing kernel (``csrc/route_select.cu``) on one GPU.

    python3 scripts/route_select_probe.py [--count] [--plans] [--host] [--phases]

Run from the repository root on a machine with an NVIDIA H100; with no
option it runs all four parts, at granite-moe-3b-a800m's router widths
(D 1536, E 40, K 8):

``--count``   device kernels a call of the unfused routing stage (f32
              product, Triton router, eager ops, the route salt from
              int32 positions, as the engine's decode gives them) and of
              the fused call, from ``torch.profiler``;
``--plans``   the fused kernel's device time (``chip_smoke.timings``)
              under other launch plans (rows a block, D splits, blocks
              aimed for) at T = 8, 128, 512 and 4096;
``--host``    the host's time for the wrapper's pieces (checks, one
              allocation, the raw stream, ``current_stream()``), and for
              a whole call while a spin kernel holds the card;
``--phases``  phase times of one launch: compiles a copy of the source
              into ``build/`` with ``%globaltimer`` stamps at the phase
              boundaries (and in warp 0's last row), and prints the last
              block's timeline at T = 8, 512 and 4096.

Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

D, E, K = 1536, 40, 8

PHASES = ["start", "product done", "ticket won", "sum and tables",
          "epilogue", "row-block sums", "before aux", "end"]
ROW_PHASES = ["row start", "softmax done", "top-k done", "stores done"]


def inputs(torch, T, seed=0):
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    x = torch.randn((T, D), generator=g, device=dev).to(torch.bfloat16)
    w = torch.randn((D, E), generator=g, device=dev) / math.sqrt(D)
    tables = (torch.arange(E, dtype=torch.int32, device=dev)[:, None],
              torch.ones(E, dtype=torch.int32, device=dev),
              torch.ones((E, 1), device=dev))
    seed_t = torch.tensor(3, dtype=torch.int32, device=dev)
    return x, w, tables, seed_t


def count(torch):
    """Device kernels a call: the unfused routing stage against the fused."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import router as t_router
    x, w, tables, seed = inputs(torch, 8)
    positions = torch.arange(8, dtype=torch.int32, device=x.device) + 100

    def unfused():
        salt = positions.sum().to(torch.int32)
        logits = x.float() @ w
        weights, idx = t_router.router_topk(logits, K)
        mean_prob = torch.softmax(logits, dim=-1).mean(dim=0)
        slots = ref.select_slots(idx, *tables, salt)
        tally = ref.masked_tally(idx, E)
        aux = ref.aux_loss(tally, mean_prob, E)
        return torch.cat([tally, tally.new_zeros((1,))]), aux, weights, slots

    def fused():
        return ops.route_select(x, w, *tables, seed, K)

    for name, fn in (("unfused routing stage and salt", unfused),
                     ("fused route_select", fused)):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
        print(f"[count] {name}: {sum(e.count for e in ev) / 10:.1f} device "
              "kernels and copies a call", flush=True)
        for e in ev:
            print(f"[count]   {e.count / 10:4.1f}  {e.key[:110]}")


def make_plan(rows_cap, target, max_split):
    def plan(T, D_, E_):
        ncg = -(-E_ // 4)
        nrg = max(1, min(256 // ncg, rows_cap // 4, -(-T // 4)))
        tr = 4 * nrg
        n_rb = -(-T // tr)
        dc = 32 if E_ <= 128 else 16 if E_ <= 512 else 8
        n_chunks = -(-D_ // dc)
        split = max(1, min(-(-target // n_rb), n_chunks, max_split))
        cps = -(-n_chunks // split)
        return tr, dc, -(-n_chunks // cps), cps, n_rb
    return plan


def plans(torch):
    """Device time of the fused kernel under other launch plans."""
    import chip_smoke
    from repro_torch.kernels import ref
    from repro_torch.kernels import route_select as t_route
    chosen = t_route.plan
    sweep = {8: [(32, 10 ** 4, m) for m in (2, 4, 8, 12, 16, 24, 48)],
             128: [(r, t, 16) for r in (16, 32) for t in (132, 264, 528)],
             512: [(r, t, 16) for r in (16, 32, 64) for t in (132, 264, 528)],
             4096: [(r, t, 16) for r in (16, 32, 64)
                    for t in (132, 264, 528, 1056)]}
    try:
        for T, variants in sweep.items():
            x, w, tables, seed = inputs(torch, T, seed=T)
            want = ref.route_select_ref(x, w, *tables, seed, K)
            # rows whose adjacent top-(K+1) probabilities are within 1e-5
            # may pick another column under another summation order
            top = torch.topk(torch.softmax(x.float() @ w, -1), K + 1).values
            clear = ((top[:, :-1] - top[:, 1:]) >= 1e-5).all(-1)
            for label, fn in [("chosen", chosen)] + [
                    (f"rows<={v[0]} blocks~{v[1]} S<={v[2]}", make_plan(*v))
                    for v in variants]:
                t_route.plan = fn
                got = t_route.route_select(x, w, *tables, seed, K)
                torch.cuda.synchronize()
                if not torch.equal(got[1][clear], want[1][clear]):
                    raise RuntimeError(f"plan {label}: indices differ "
                                       "outside near ties")
                r = chip_smoke.timings(
                    lambda: t_route.route_select(x, w, *tables, seed, K),
                    reps=50)
                print(f"[plans] T={T} {label} {fn(T, D, E)}: device "
                      f"{r['device_ms'] * 1e3:.1f} us", flush=True)
    finally:
        t_route.plan = chosen


def host(torch):
    """The host's time for the wrapper's pieces and for a whole call."""
    import chip_smoke
    from repro_torch.kernels import route_select as t_route
    x, w, (so, nc, cdf), seed = inputs(torch, 8)
    index = x.get_device()

    def bench(name, fn, n=2000):
        for _ in range(50):
            fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        print(f"[host] {name}: {(time.perf_counter() - t0) / n * 1e6:.2f} "
              "us", flush=True)

    specs = ((x, torch.bfloat16, (8, D)), (w, torch.float32, (D, E)),
             (so, torch.int32, (E, 1)), (nc, torch.int32, (E,)),
             (cdf, torch.float32, (E, 1)))
    bench("checks", lambda: any(t_route._bad(t, dt, sh, index)
                                for t, dt, sh in specs))
    bench("one torch.empty", lambda: torch.empty(
        (8, K), dtype=torch.float32, device=x.device))
    bench("raw stream", lambda: torch._C._cuda_getCurrentRawStream(index))
    bench("current_stream().cuda_stream",
          lambda: torch.cuda.current_stream(x.device).cuda_stream)
    _, host_us = chip_smoke.held_times(
        lambda: t_route.route_select(x, w, so, nc, cdf, seed, K), reps=50)
    print(f"[host] whole call, card held: {host_us:.2f} us", flush=True)


def stamped_source() -> str:
    """csrc/route_select.cu with %globaltimer stamps: per block at the
    phase boundaries, and in warp 0 around its last row."""
    from repro_torch.kernels import build
    src = (build.CSRC / "route_select.cu").read_text()

    def stamp(slot, i):
        return ("  if (threadIdx.x == 0) { unsigned long long t_; asm "
                "volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t_)); "
                f"g_probe[{slot} + (blockIdx.y * gridDim.x + blockIdx.x) * 8"
                f" + {i}] = t_; }}\n")

    block = [
        ("  const unsigned seed = static_cast<unsigned>(*p.seed);", 0, 0),
        ("  float* lg = reinterpret_cast<float*>(smem);\n", 1, -1),
        ("    __threadfence();\n    stage_tables();\n", 2, 1),
        ("  cp_async_wait<0>();\n  __syncthreads();\n", 3, 1),
        ("  // ---- this row block's counts and sum of p\n", 4, -1),
        ("  if (n_rb > 1) {\n", 5, -1),
        ("  if (warp == 0) {   // aux", 6, -1),
        ("      *p.aux = static_cast<float>(p.E) * dot;\n    }\n  }\n", 7, 1),
        ("    softmax_row<J>(v, p.E, lane);\n", 0, -2),
        ("    float my_w, total;\n    int my_i;\n    top_k<J>", 1, -2),
        ("    if (lane < p.K) {\n      const bool valid", 2, -2),
        ("      if (valid) atomicAdd(cnt + my_i, 1);\n    }\n", 3, 2),
    ]
    for needle, i, where in block:
        if src.count(needle) != 1:
            raise RuntimeError(f"stamp anchor not found once: {needle!r}")
        slot = "0" if abs(where) < 2 else "65536 * 8"
        mark = stamp(slot, i)
        if needle.startswith("  const unsigned seed"):
            end = src.index(needle) + src[src.index(needle):].index("\n") + 1
            src = src[:end] + mark + src[end:]
        elif where < 0:
            src = src.replace(needle, mark + needle)
        else:
            src = src.replace(needle, needle + mark)
    src = src.replace("namespace {\n\nconstexpr int THREADS",
                      "__device__ unsigned long long g_probe[2 * 65536 * 8];"
                      "\n\nnamespace {\n\nconstexpr int THREADS", 1)
    return src + '''
extern "C" int probe_read(void* host, int n) {
  const size_t bytes = n * 8 * sizeof(unsigned long long);
  cudaError_t e = cudaMemcpyFromSymbol(host, g_probe, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemcpyFromSymbol(
      static_cast<char*>(host) + bytes, g_probe, bytes,
      65536 * 8 * sizeof(unsigned long long)));
}

extern "C" int probe_clear() {
  void* ptr = nullptr;
  cudaError_t e = cudaGetSymbolAddress(&ptr, g_probe);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaMemset(ptr, 0, sizeof(g_probe)));
}
'''


def phases(torch):
    """Phase times of one launch of a stamped copy of the kernel."""
    from repro_torch.kernels import build
    from repro_torch.kernels import route_select as t_route
    out_dir = ROOT / "build"
    out_dir.mkdir(exist_ok=True)
    src_path = out_dir / "route_select_stamped.cu"
    src_path.write_text(stamped_source())
    lib_path = out_dir / "libroute_select_stamped.so"
    r = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I",
                        str(build.CSRC), "-o", str(lib_path), str(src_path)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(lib_path))
    lib.route_select_bf16.argtypes = [ctypes.c_void_p]
    lib.route_select_bf16.restype = ctypes.c_int
    lib.probe_read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    chosen = t_route._lib
    t_route._lib = lambda: lib
    try:
        for T in (8, 512, 4096):
            x, w, tables, seed = inputs(torch, T, seed=T)
            tr, dc, split, cps, n_rb = t_route.plan(T, D, E)
            for _ in range(4):          # warm, then stamp one launch
                t_route.route_select(x, w, *tables, seed, K)
            torch.cuda.synchronize()
            if lib.probe_clear() != 0:
                raise RuntimeError("probe_clear failed")
            t_route.route_select(x, w, *tables, seed, K)
            torch.cuda.synchronize()
            n = split * n_rb
            buf = (ctypes.c_uint64 * (2 * n * 8))()
            if lib.probe_read(buf, n) != 0:
                raise RuntimeError("probe_read failed")
            blocks = [[buf[b * 8 + i] for i in range(8)] for b in range(n)]
            rows = [[buf[n * 8 + b * 8 + i] for i in range(4)]
                    for b in range(n)]
            t0 = min(b[0] for b in blocks)
            done = sorted((b[1] - t0) / 1e3 for b in blocks)
            print(f"[phases] T={T} plan (TR, DC, S, cps, n_rb) = "
                  f"{(tr, dc, split, cps, n_rb)}: product done in "
                  f"{done[0]:.2f}..{done[-1]:.2f} us", flush=True)
            for b, stamps in enumerate(blocks):
                if stamps[7]:
                    print("[phases]   last block: " + ", ".join(
                        f"{nm} {(v - t0) / 1e3:.2f}"
                        for nm, v in zip(PHASES, stamps) if v))
                    print("[phases]   its warp 0, last row: " + ", ".join(
                        f"{nm} {(v - t0) / 1e3:.2f}"
                        for nm, v in zip(ROW_PHASES, rows[b]) if v))
    finally:
        t_route._lib = chosen


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    for part in ("count", "plans", "host", "phases"):
        ap.add_argument(f"--{part}", action="store_true")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("route_select_probe: no CUDA device", file=sys.stderr)
        return 2
    chosen = [p for p in ("count", "plans", "host", "phases")
              if getattr(args, p)] or ["count", "plans", "host", "phases"]
    print(f"[env] {torch.cuda.get_device_name(0)}, torch {torch.__version__}",
          flush=True)
    for part in chosen:
        globals()[part](torch)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
