#!/usr/bin/env python3
"""The f32 prefill kernel's accuracy as a row's key count grows, for one
checkout.

    python3 scripts/attn_accuracy.py --root DIR [--hd 80|128|256]

Imports the port under ``DIR/src`` (its kernels built into ``DIR/build``)
and, for each key count N in ``KEYS``, runs a 128-row chunk (rows
N - 2000 to N - 1873, causal, the keys from N - 3000 on cut by
``kv_valid``; KV 2 x G 2, f32, from seed 80; ``--hd``: hubert's 80 by
default, or 128 and 256, the wide tf32x3 kernel's) through
``ops.flash_attention`` and through the plain version in f32 and in f64.
Prints each output's largest row relative L2 against the others: a
kernel whose error grows with N while the plain f32 version's does not
carries a bias in its accumulation. The last line of standard output
is the result as JSON. Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

#: from one key tile's worth to past the 1024 tiles of 64 whose states the
#: kernels judge a window at a time
KEYS = (2048, 8192, 30000, 60000, 70000)


def row_rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b).norm(dim=-1)
                  / b.norm(dim=-1).clamp_min(1e-300)).max())


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path, required=True)
    ap.add_argument("--hd", type=int, default=80)
    args = ap.parse_args()
    hd = args.hd
    import torch
    if not torch.cuda.is_available():
        print("attn_accuracy: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    from repro_torch.kernels import build, ops
    from repro_torch.models import flash as plain
    build.build_all(["flash_attention"])
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()
    out = {"root": str(root), "card": card, "hd": hd, "keys": {}}
    for n in KEYS:
        g = torch.Generator().manual_seed(80)
        q = torch.randn((1, 128, 2, 2, hd), generator=g).cuda()
        k = torch.randn((1, n, 2, hd), generator=g).cuda()
        v = torch.randn((1, n, 2, hd), generator=g).cuda()
        kpos = torch.arange(n, device="cuda")
        kw = dict(causal=True, window=0, kv_positions=kpos,
                  q_positions=torch.arange(n - 2000, n - 1872,
                                           device="cuda"),
                  kv_valid=kpos < n - 3000)
        got = ops.flash_attention(q, k, v, **kw)
        want = plain.flash_attention(q, k, v, **kw)
        exact = plain.flash_attention(q.double(), k.double(), v.double(),
                                      **kw)
        out["keys"][n] = r = {"kernel_vs_plain": row_rel(got, want),
                              "kernel_vs_f64": row_rel(got, exact),
                              "plain_vs_f64": row_rel(want, exact)}
        print(f"[attn_accuracy] {root.name} hd {hd}, {n} keys: kernel "
              f"against the plain version {r['kernel_vs_plain']:.3e}, "
              f"against f64 {r['kernel_vs_f64']:.3e}; the plain version "
              f"against f64 {r['plain_vs_f64']:.3e}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
