#!/usr/bin/env python3
"""How far the attention's rounding alone moves a model's loss, on a card.

    python3 scripts/loss_rounding.py [--arch smollm-360m] [--batch 4]

One device, the published config at full width and depth, seed-0 bf16
weights that require their gradients (the forward of a training step),
random tokens and labels of ``batch`` x 256: the loss with the attention
through its kernel (``ops.flash_attention``, the training path), through
its plain version in bf16, and through the plain version in f32 (q, k, v
cast up, the output cast back); and the same three prefills' logits
(no gradient), each held against the f32 one by its relative L2. Prints
each loss and the relative differences; the last line of standard output
is the result as JSON.
Exits 2 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import types

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--batch", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("loss_rounding: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get
    from repro_torch.kernels import build, ops
    from repro_torch.models import (init_params, loss_fn, make_moe_tables,
                                    prefill_fn)
    from repro_torch.models import flash as tflash
    from repro_torch.models import model as tmodel
    from repro_torch.tree import leaves
    build.build_all()
    dev = torch.device("cuda")
    cfg = get(args.arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    g = torch.Generator().manual_seed(15)
    batch = {k: torch.randint(0, cfg.vocab, (args.batch, 256),
                              generator=g).to(dev)
             for k in ("tokens", "labels")}
    tables = make_moe_tables(cfg, device=dev)

    def f32(q, k, v, **kw):
        return tflash.flash_attention(q.float(), k.float(), v.float(),
                                      **kw).to(q.dtype)

    losses, logits = {}, {}
    for name, attn in (("kernel", ops.flash_attention),
                       ("plain", tflash.flash_attention), ("f32", f32)):
        saved = tmodel.ops
        tmodel.ops = types.SimpleNamespace(flash_attention=attn,
                                           flash_decode=ops.flash_decode)
        try:
            losses[name] = loss_fn(cfg)(params, batch, tables)[0].item()
            with torch.no_grad():
                logits[name] = prefill_fn(cfg)(
                    params, {"tokens": batch["tokens"]}, tables)[0].float()
        finally:
            tmodel.ops = saved
    lrel = {k: ((logits[k] - logits["f32"]).norm()
                / logits["f32"].norm()).item() for k in ("kernel", "plain")}

    def rel(a, b):
        return abs(losses[a] - losses[b]) / abs(losses[b])

    res = {"arch": cfg.name, "losses": losses,
           "kernel_vs_f32": rel("kernel", "f32"),
           "plain_vs_f32": rel("plain", "f32"),
           "kernel_vs_plain": rel("kernel", "plain"),
           "logits_rel_l2_vs_f32": lrel}
    print(f"[loss_rounding] {cfg.name}, {args.batch} x 256: losses "
          + ", ".join(f"{k} {v:.7f}" for k, v in losses.items())
          + f"; relative: kernel vs f32 {res['kernel_vs_f32']:.3e}, plain "
          f"vs f32 {res['plain_vs_f32']:.3e}, kernel vs plain "
          f"{res['kernel_vs_plain']:.3e}; prefill logits' relative L2 "
          f"against f32: kernel {lrel['kernel']:.3e}, plain "
          f"{lrel['plain']:.3e}")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
