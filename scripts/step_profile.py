#!/usr/bin/env python3
"""Where a full-width training step's time goes, for one checkout.

    python3 scripts/step_profile.py --root DIR [--batch 16] [--seq-len 256]

Runs ``train_step_profile`` of the ``chip_smoke.py`` found in ``DIR`` with
the port under ``DIR/src`` (its kernels built into ``DIR/build``):
granite-moe-3b-a800m at full width on the card, one warm step, three
steps split on the host clock into the forward, the backward and AdamW,
then one step traced with ``torch.profiler``. The last line of standard
output is the result as JSON, with the root. To compare two checkouts,
run it for each in turns in one command on one card (parent, change,
change, parent). Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", type=pathlib.Path, required=True)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=256)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("step_profile: no CUDA device", file=sys.stderr)
        return 2
    root = args.root.resolve()
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(0, str(root))
    import chip_smoke as cs
    from repro_torch.configs import get
    from repro_torch.kernels import build
    build.build_all()
    res = cs.train_step_profile(get("granite-moe-3b-a800m"),
                                torch.device("cuda"), seq_len=args.seq_len,
                                batch=args.batch)
    print(json.dumps({"root": str(root)} | res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
