"""Roofline terms of the dry run's records on an H100.

The counterpart of ``repro.launch.roofline`` over the port's records
(:mod:`repro_torch.launch.dryrun`). The records hold *per-rank* counts
(the rank's own step, traced), so

    compute    = flops_per_device            / PEAK_FLOPS
    memory     = bytes_per_device            / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

The constants are the NVIDIA H100 80GB HBM3's (SXM) at the 700 W limit
the card reports, from NVIDIA's data sheet, not measured: 989 TFLOP/s of
dense bf16 on the tensor cores, 3.35 TB/s of HBM. ``LINK_BW`` is one
NDR 400 Gb/s InfiniBand NIC a GPU (50 GB/s) across HGX nodes: a 16-wide
axis of the production grid spans two 8-GPU nodes, so that is the
conservative term; inside a node NVLink 4 gives 450 GB/s a direction.
gloo on one card measures nothing of either (PERF.md §7).

MODEL_FLOPS is 6·N·T (train) / 2·N·T (prefill) / 2·N_active·B (decode),
N the active params, over the grid's ranks; its ratio to the counted
FLOPs shows remat's recompute, the masked half of causal attention, the
ragged buffer's worst-case rows and the like.

    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dir results/dryrun_torch
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
from typing import Dict, List, Optional

from repro_torch.configs import SHAPES, get

__all__ = ["PEAK_FLOPS", "HBM_BW", "LINK_BW", "model_flops_per_device",
           "roofline_terms", "load_records", "format_table", "main"]

PEAK_FLOPS = 989e12        # dense bf16, tensor cores (H100 SXM data sheet)
HBM_BW = 3.35e12           # bytes/s of HBM3 (H100 SXM data sheet)
LINK_BW = 50e9             # bytes/s: one NDR 400 Gb/s NIC a GPU, across nodes


def _ranks(mesh: str) -> int:
    return math.prod(int(n) for n in mesh.split("x"))


def model_flops_per_device(rec: Dict) -> float:
    cfg = get(rec["arch"])
    shape = SHAPES[rec["shape"]]
    n_act = cfg.n_active_params()
    if shape.kind == "train":
        total = 6.0 * n_act * shape.global_batch * shape.seq_len
    elif shape.kind == "prefill":
        total = 2.0 * n_act * shape.global_batch * shape.seq_len
    else:                                      # decode: one token per seq
        total = 2.0 * n_act * shape.global_batch
    return total / _ranks(rec["mesh"])


def roofline_terms(rec: Dict) -> Optional[Dict]:
    if rec.get("status") != "ok" or "costs" not in rec:
        return None
    h = rec["costs"]
    compute = h["flops_per_device"] / PEAK_FLOPS
    memory = h["bytes_per_device"] / HBM_BW
    coll = h["collective_bytes_per_device"] / LINK_BW
    terms = {"compute_s": compute, "memory_s": memory, "collective_s": coll}
    dom = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    bound = max(terms.values())
    return {
        **terms,
        "dominant": dom.replace("_s", ""),
        "model_flops_per_device": mf,
        "useful_ratio": mf / max(h["flops_per_device"], 1.0),
        # the share of the bound the *useful* compute is: how close the
        # useful work runs to the roofline under all three ceilings
        "roofline_fraction": (mf / PEAK_FLOPS) / max(bound, 1e-12),
        "mem_gib": rec.get("memory", {}).get("per_device_total_bytes", 0)
        / 2 ** 30,
    }


def load_records(directory: str) -> List[Dict]:
    recs = []
    for path in sorted(glob.glob(os.path.join(directory, "*.json"))):
        with open(path) as f:
            recs.append(json.load(f))
    return recs


def format_table(recs: List[Dict], mesh: str = "16x16",
                 capacity_gib: Optional[float] = None) -> str:
    """The records of ``mesh`` as a markdown table: the rank's memory,
    FLOPs, bytes and collective bytes, the three terms, the dominant one,
    the useful ratio and the roofline fraction. ``capacity_gib`` (a
    card's memory) marks with ``>`` the cells whose rank does not fit."""
    hdr = ("| arch | shape | mem GiB | FLOPs | bytes | coll. bytes | "
           "compute (s) | memory (s) | collective (s) | dominant | useful | "
           "roofline frac |")
    sep = "|" + "---|" * 12
    lines = [hdr, sep]
    for rec in recs:
        if rec.get("mesh") != mesh:
            continue
        if rec.get("status") == "skipped":
            lines.append(f"| {rec['arch']} | {rec['shape']} | "
                         + "— | " * 7 + f"skipped: {rec['reason']} | — | — |")
            continue
        t = roofline_terms(rec)
        if t is None:
            err = rec.get("error", "").split(":")[0]
            lines.append(f"| {rec['arch']} | {rec['shape']} | "
                         + "— | " * 7 + f"ERROR ({err}) | — | — |")
            continue
        h = rec["costs"]
        over = (">" if capacity_gib is not None
                and t["mem_gib"] > capacity_gib else "")
        lines.append(
            f"| {rec['arch']} | {rec['shape']} | {over}{t['mem_gib']:.2f} "
            f"| {h['flops_per_device']:.3g} | {h['bytes_per_device']:.3g} "
            f"| {h['collective_bytes_per_device']:.3g} "
            f"| {t['compute_s']:.4f} | {t['memory_s']:.4f} "
            f"| {t['collective_s']:.4f} | {t['dominant']} "
            f"| {t['useful_ratio']:.2f} | {t['roofline_fraction']:.3f} |")
    return "\n".join(lines)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun_torch")
    ap.add_argument("--mesh", default="16x16")
    ap.add_argument("--capacity-gib", type=float, default=None,
                    help="a card's memory: mark the ranks that do not fit")
    args = ap.parse_args()
    recs = load_records(args.dir)
    print(format_table(recs, args.mesh, args.capacity_gib))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
