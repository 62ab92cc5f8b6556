#!/usr/bin/env python3
"""The attention kernels' times at their call sites' shapes, for one checkout.

    python3 scripts/attn_compare.py --root DIR [--only NAME ...]

Imports the ``chip_smoke.py`` found in ``DIR`` with the port under
``DIR/src`` (its kernels built into ``DIR/build``) and times that
checkout's ``flash_attn_fwd`` and ``flash_decode`` wrappers on inputs made
from a fixed seed a case, so that two checkouts see the same values:
``ms`` (a single call's median CUDA-event time), ``device_ms`` (the same
with the card held by a spin kernel) and ``host_us`` (the host's time to
issue one call), beside one ``scaled_dot_product_attention`` call on the
same values and the bound (the larger of the bytes over 3.35 TB/s and the
valid pairs' FLOPs over the bf16 peak; in f32 on the tf32x3 route three
times the FLOPs over the TF32 peak, on an FMA route the FLOPs over the
FMA units' peak), with the exponentials' time beside it (an ex2 a valid
pair at the SMs' ex2 rate). A digest of each output lets two
checkouts' kernels be told apart or shown equal. To compare two
checkouts, run it for each in turns in one command on one card (parent,
change, change, parent). The last line of standard output is the result
as JSON. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import subprocess
import sys

# name: (B, Sq, Skv, KV, G, hd, dtype, causal, window, rows, n_valid)
PREFILL = {
    "prefill-4x512": (4, 512, 512, 8, 3, 64, "bf16", True, 0, None, None),
    "chunk-vs-lane": (1, 128, 1024, 8, 3, 64, "bf16", True, 0, (384, 512),
                      512),
    "pixtral-hd128-4x512": (4, 512, 512, 8, 4, 128, "bf16", True, 0, None,
                            None),
    "gemma3-hd256-window": (1, 2048, 2048, 4, 2, 256, "bf16", True, 1024,
                            None, None),
    "hubert-f32": (2, 512, 512, 16, 1, 80, "f32", False, 0, None, None),
    "prefill-1x32768": (1, 32768, 32768, 8, 3, 64, "bf16", True, 0, None,
                        None),
    "chunk-vs-140000": (1, 128, 140000, 8, 3, 64, "bf16", True, 0,
                        (138000, 138128), 138128),
    # gemma3-4b's global layers: causal, no window
    "gemma3-hd256-8192": (1, 8192, 8192, 4, 2, 256, "bf16", True, 0, None,
                          None),
    # the serve CLI's default prefill (smoke size, --max-batch 4
    # --max-seq 96) and its head size at length
    "serve-smoke-hd32": (4, 96, 96, 2, 2, 32, "bf16", True, 0, None, None),
    "hd32-1x32768": (1, 32768, 32768, 2, 2, 32, "bf16", True, 0, None,
                     None),
    # hubert's head layout in bf16
    "bf16-hd80-2x2048": (2, 2048, 2048, 16, 1, 80, "bf16", False, 0, None,
                         None),
    "f32-hd128-1x4096": (1, 4096, 4096, 8, 3, 128, "f32", True, 0, None,
                         None),
    "f32-hd256-1x4096": (1, 4096, 4096, 4, 2, 256, "f32", True, 0, None,
                         None),
    # the tf32x3 route's other head sizes, whose kernel is unchanged
    "f32-hd32-2x512": (2, 512, 512, 8, 3, 32, "f32", True, 0, None, None),
    "f32-hd64-2x512": (2, 512, 512, 8, 3, 64, "f32", True, 0, None, None),
}
# an H100 SXM's ex2 rate: 16 a clock on each of 132 SMs at the 1.98 GHz
# boost clock; one ex2 a (row, key) pair
EX2_PER_S = 16 * 132 * 1.98e9
LANES = [37, 100, 250, 511, 600, 800, 1000, 1023]
# name: (B, S_max, KV, G, hd, pos, kpos_offset, stats)
DECODE = {
    "decode-8": (8, 1024, 8, 3, 64, LANES, 0, False),
    "decode-8-stats": (8, 256, 8, 3, 64, LANES, 256, True),
    "decode-8x32768": (8, 32768, 8, 3, 64, [32767 - 3 * i for i in range(8)],
                       0, False),
}


def _digest(out) -> str:
    import torch
    ts = out if isinstance(out, tuple) else (out,)
    h = hashlib.sha256()
    for t in ts:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def prefill_case(cs, name, seed):
    import torch
    from repro_torch.kernels import flash as t_flash
    B, Sq, Skv, KV, G, hd, dt, causal, window, rows, n_valid = PREFILL[name]
    dtype = torch.bfloat16 if dt == "bf16" else torch.float32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, Sq, KV, G, hd), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=gen, device=dev).to(dtype)
    qpos = torch.arange(*(rows or (Sq,)), device=dev)
    kpos = torch.arange(Skv, device=dev)
    kval = None if n_valid is None else kpos < n_valid
    kw = dict(causal=causal, window=window, q_positions=qpos,
              kv_positions=kpos, kv_valid=kval)

    def call():
        return t_flash.flash_attn_fwd(q, k, v, **kw)

    out = call()
    torch.cuda.synchronize()
    digest = _digest(out)
    del out
    res = cs.timings(call)
    # PyTorch's flash backend takes 16-bit inputs only: f32 gets the mask
    full = (causal and rows is None and n_valid is None and not window
            and dtype == torch.bfloat16)
    mask = None
    if not full:
        mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
        if kval is not None:
            mask &= kval[None, :]
        if causal:
            mask &= kpos[None, :] <= qpos[:, None]
        if window:
            mask &= (qpos[:, None] - kpos[None, :]) < window
    sdpa_ms = cs.median_ms(cs._sdpa(q, k, v, mask, causal=full), reps=5)
    pairs = cs._valid_pairs(qpos, kpos, kval, causal, window) * B * KV * G
    n_bytes = (2 * q.numel() * q.element_size() + 2 * k.numel()
               * k.element_size() + (Sq + Skv) * 8
               + (0 if kval is None else Skv))
    route = t_flash.route_of(dtype, hd)
    if dtype == torch.bfloat16:
        bound_ms, by = cs.bound(n_bytes, 4 * hd * pairs, cs.BF16_FLOPS)
    elif route == "tf32x3":
        bound_ms, by = cs.bound(n_bytes, 3 * 4 * hd * pairs, cs.TF32_FLOPS)
    else:
        bound_ms, by = cs.bound(n_bytes, 4 * hd * pairs, cs.F32_FLOPS)
    return {**res, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms, "bound_by": by,
            "ex2_ms": pairs / EX2_PER_S * 1e3,
            "share": bound_ms / res["device_ms"], "digest": digest,
            "route": route}


def decode_case(cs, name, seed):
    import torch
    from repro_torch.kernels import flash as t_flash
    B, S_max, KV, G, hd, pos, koff, stats = DECODE[name]
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, KV, G, hd), generator=gen,
                    device=dev).to(torch.bfloat16)
    kc = torch.randn((B, S_max, KV, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn((B, S_max, KV, hd), generator=gen,
                     device=dev).to(torch.bfloat16)
    pos = torch.tensor(pos, device=dev)
    kw = dict(window=0, kpos_offset=koff, return_stats=stats)

    def call():
        return t_flash.flash_decode(q, kc, vc, pos, **kw)

    out = call()
    torch.cuda.synchronize()
    digest = _digest(out)
    del out
    res = cs.timings(call)
    kp = koff + torch.arange(S_max, device=dev)
    valid = kp[None, :] <= pos[:, None]
    sdpa_ms = cs.median_ms(cs._sdpa(q[:, None], kc, vc,
                                    valid[:, None, None, :]), reps=5)
    n_rows = int(valid.sum(1).sum())
    out_bytes = (B * KV * G * hd * 4 + 2 * B * KV * G * 4 if stats
                 else B * KV * G * hd * 2)
    n_bytes = q.numel() * 2 + 2 * n_rows * KV * hd * 2 + B * 8 + out_bytes
    bound_ms, by = cs.bound(n_bytes, 4 * hd * G * KV * n_rows,
                            cs.BF16_FLOPS)
    return {**res, "sdpa_ms": sdpa_ms, "bound_ms": bound_ms, "bound_by": by,
            "share": bound_ms / res["device_ms"], "digest": digest}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path, required=True)
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("attn_compare: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.kernels import build
    build.build_all(["flash_attention"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"root": str(root), "card": card, "prefill": {}, "decode": {}}
    for i, name in enumerate(PREFILL):
        if args.only is None or name in args.only:
            out["prefill"][name] = r = prefill_case(cs, name, 100 + i)
            print(f"[attn_compare] {root.name} {name} ({r['route']}): device "
                  f"{r['device_ms']:.4f} ms ({100 * r['share']:.1f}% of "
                  f"{r['bound_ms']:.4f}, {r['bound_by']}; ex2 "
                  f"{r['ex2_ms']:.4f}), ms {r['ms']:.4f}, host "
                  f"{r['host_us']:.1f} us, SDPA {r['sdpa_ms']:.4f} ms, digest "
                  f"{r['digest']}", flush=True)
            torch.cuda.empty_cache()
    for i, name in enumerate(DECODE):
        if args.only is None or name in args.only:
            out["decode"][name] = r = decode_case(cs, name, 200 + i)
            print(f"[attn_compare] {root.name} {name}: device "
                  f"{r['device_ms']:.4f} ms ({100 * r['share']:.1f}% of "
                  f"{r['bound_ms']:.4f}), ms {r['ms']:.4f}, host "
                  f"{r['host_us']:.1f} us, SDPA {r['sdpa_ms']:.4f} ms",
                  flush=True)
            torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
