"""The dry run: one rank of the production grid, traced on the ``meta``
device, for every (arch, shape, grid) cell.

The counterpart of ``repro.launch.dryrun`` (``src/repro/launch/dryrun.py``),
which lowers and compiles each cell's step against stand-ins of the
production shardings. Eager PyTorch has no compiler to ask, so this runs
the rank's *real* step — ``launch.train.make_train_step``, ``prefill_fn``
or ``decode_fn`` on the rank's slices from ``make_rules`` — on tensors of
the ``meta`` device, which carry shapes and dtypes and no data, in a
``fake`` process group of the grid's size (``launch.mesh.fake_group``;
its collectives move nothing). The port's kernels take their meta branch
(``kernels.ops``): they allocate what the card would and launch nothing.
:func:`repro_torch.launch.cost_analysis.count_costs` counts the rank's
FLOPs, memory traffic, collective bytes by kind, kernel calls and peak
live bytes as the step runs. Its device is ``meta`` by design: it
computes nothing, and needs no card.

    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch qwen3-moe-235b-a22b --shape prefill_32k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both \\
        --include-extra

Each record is the reference's (``arch``, ``shape``, ``mesh``,
``n_params``, ``n_active_params``, ``status``, ``memory``) with the
counts under ``costs`` and the host seconds of the trace as ``trace_s``.
``memory`` follows ``memory_analysis()``: the rank's argument bytes, the
bytes of its results, the temporaries (the peak above the arguments less
the new results) and ``per_device_total_bytes`` as the reference computes
it. The port donates nothing: ``alias_size_in_bytes`` are the results that
are arguments updated in place (the training step's params and AdamW
state, decode's cache), 0 at prefill. The argument bytes differ from the
reference's ``argument_size_in_bytes`` in two ways only: the port's step
takes the global batch (and decode's global token) and reads the
rank's rows, where the reference's argument is the rank's ``dp`` shard;
and ``jax.jit`` drops the arguments a step never reads (the replica
tables ``n_copies`` and ``copy_cdf`` where every expert has one copy, an
audio arch's embedding, a vision arch's frontend at decode), which the
port passes and counts. A failure here (a shape a kernel
refuses, an operation without a meta kernel, a host read of a value) is a
fault of the port, as in the reference.
"""

from __future__ import annotations

import argparse
import json
import math
import multiprocessing as mp
import os
import time
import traceback
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import (ALL_ARCHS, EXTRA_ARCHS, SHAPES, ArchConfig,
                                 ShapeSpec, get, shape_applicable)
from repro_torch.launch.cost_analysis import count_costs
from repro_torch.launch.mesh import fake_group, make_mesh
from repro_torch.launch.sharding import (make_rules, rank_cache,
                                        shard_params)
from repro_torch.launch.train import make_train_step
from repro_torch.models import (decode_fn, init_cache, init_params,
                                make_moe_tables, prefill_fn)
from repro_torch.training import AdamWConfig, adamw_init
from repro_torch.tree import leaves

__all__ = ["rank_inputs", "input_specs", "step_call", "measure", "run_cell",
           "main", "GRID_AXES"]

#: the production grids' axes by rank count of the grid's shape
GRID_AXES = {2: ("data", "model"), 3: ("pod", "data", "model")}
#: the schedule's length for the training step's learning rate
TRAIN_TOTAL = 10_000


def _grid(grid_shape: Sequence[int], rank: int):
    """Rank ``rank`` of a fake default group of the grid's size, and the
    grid on it."""
    fake_group(math.prod(grid_shape), rank)
    return make_mesh(grid_shape, GRID_AXES[len(grid_shape)])


def rank_inputs(cfg: ArchConfig, shape: ShapeSpec, rules, *, whole=None,
                device="meta") -> Dict[str, Any]:
    """What the rank's step of ``shape.kind`` takes on ``rules``' grid:
    its slice of the params (``whole``, the whole tree of the phase's
    layout, or one drawn without a generator on ``meta``; for decode the
    decode fleet's tree, ``launch.sharding.decode_params``), for train
    leaves of its own (``shard_params``' train cut) that require their
    gradients, with the AdamW state of its slices (whose cuts are
    ``opt_cuts``'), the MoE tables of the phase, and the global batch of
    the reference's ``batch_specs`` (the step reads the rank's rows):
    ``tokens`` and ``labels`` (B, S) int32; for an audio arch ``feats``
    (B, S, F) bf16 and ``labels``; for a vision arch ``patches`` (B, P, F)
    bf16 and ``tokens`` and ``labels`` (B, S - P); no ``labels`` at
    prefill. For decode, the rank's cache (``rank_cache`` of
    ``init_cache(B, S)``) with the lanes' token and position. Off
    ``meta`` the ids and features are drawn from seed 0; on ``meta``
    there are no values."""
    phase = shape.kind
    if whole is None:
        whole = init_params(cfg, None, device=device, rules=rules,
                            phase=phase)
    params = shard_params(cfg, whole, rules, phase)
    if phase == "train":           # leaves of the rank's own
        for p in leaves(params):
            p.requires_grad_()
    out: Dict[str, Any] = {
        "params": params,
        "tables": make_moe_tables(cfg, rules, phase=phase, device=device)}
    B, S = shape.global_batch, shape.seq_len
    gen = None
    if torch.device(device).type != "meta":
        gen = torch.Generator(device=device)
        gen.manual_seed(0)

    def ids(*dims):
        if gen is None:
            return torch.empty(dims, dtype=torch.int32, device=device)
        return torch.randint(0, cfg.vocab, dims, generator=gen,
                             dtype=torch.int32, device=device)

    def feats(*dims):
        if gen is None:
            return torch.empty(dims, dtype=torch.bfloat16, device=device)
        return torch.randn(dims, generator=gen, device=device).to(
            torch.bfloat16)

    if phase == "decode":
        out["cache"] = rank_cache(cfg, init_cache(cfg, B, S, device=device),
                                  rules)
        out["token"] = ids(B, 1)
        out["pos"] = torch.full((B,), S // 2, dtype=torch.int32,
                                device=device)
        return out
    if cfg.frontend == "audio":
        batch = {"feats": feats(B, S, cfg.frontend_dim)}
        text = S
    elif cfg.frontend == "vision":
        text = S - cfg.n_patches
        batch = {"tokens": ids(B, text),
                 "patches": feats(B, cfg.n_patches, cfg.frontend_dim)}
    else:
        text = S
        batch = {"tokens": ids(B, S)}
    if phase == "train":
        out["opt"] = adamw_init(params)
        batch["labels"] = ids(B, text)
    out["batch"] = batch
    return out


def input_specs(arch: str, shape_name: str, grid) -> Dict[str, Any]:
    """The rank's inputs of one cell on ``grid`` (this process's rank of
    it), on ``meta``: :func:`rank_inputs` with the rules of
    ``make_rules(cfg, grid, phase)``, beside ``cfg``, ``rules``,
    ``shape`` and ``phase``."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    rules = make_rules(cfg, grid, shape.kind)
    return {"cfg": cfg, "rules": rules, "shape": shape, "phase": shape.kind,
            **rank_inputs(cfg, shape, rules)}


def step_call(cfg: ArchConfig, shape: ShapeSpec, rules, inputs):
    """``(call, arguments)``: the rank's step as a user calls it, with
    no argument, and the trees it is given. Train: one
    ``make_train_step`` step (loss, backward, AdamW in place); prefill
    and decode without autograd."""
    phase = shape.kind
    tables = inputs["tables"]
    if phase == "train":
        step = make_train_step(cfg, AdamWConfig(), TRAIN_TOTAL, rules)
        args = (inputs["params"], inputs["opt"], inputs["batch"], tables)
        return (lambda: step(*args)), args
    if phase == "prefill":
        fn = prefill_fn(cfg, rules)
        args = (inputs["params"], inputs["batch"], tables)
    else:
        fn = decode_fn(cfg, rules)
        args = (inputs["params"], inputs["token"], inputs["cache"],
                inputs["pos"], tables)

    def call():
        with torch.no_grad():
            return fn(*args)

    return call, args


def _storages(tree) -> Dict[int, int]:
    return {t.untyped_storage()._cdata: t.untyped_storage().nbytes()
            for t in leaves(tree) if isinstance(t, torch.Tensor)}


def measure(cfg: ArchConfig, shape: ShapeSpec, grid_shape: Sequence[int],
            rank: int = 0, moe_impl: str = "ragged") -> Dict[str, Any]:
    """Rank ``rank``'s step of ``shape`` on ``grid_shape`` from
    ``make_rules`` (its MoE layers on ``moe_impl``), traced on ``meta`` in
    a fake group of the grid's size under ``count_costs``: ``{"costs",
    "memory", "trace_s"}``."""
    t0 = time.perf_counter()
    grid = _grid(grid_shape, rank)
    rules = make_rules(cfg, grid, shape.kind, moe_impl)
    inputs = rank_inputs(cfg, shape, rules)
    call, args = step_call(cfg, shape, rules, inputs)
    with count_costs(args) as costs:
        result = call()
    arg_st = _storages(args)
    out_st = _storages(result)
    out_b = sum(out_st.values())
    alias = sum(n for k, n in out_st.items() if k in arg_st)
    new = out_b - alias
    memory = {"argument_size_in_bytes": costs.argument_bytes,
              "output_size_in_bytes": out_b,
              "temp_size_in_bytes": max(costs.peak_bytes - new, 0),
              "alias_size_in_bytes": alias}
    memory["per_device_total_bytes"] = (
        memory["argument_size_in_bytes"] + memory["temp_size_in_bytes"]
        + max(out_b - alias, 0))
    return {"costs": costs, "memory": memory,
            "trace_s": time.perf_counter() - t0}


def _mesh_shape(multi_pod: bool):
    return (2, 16, 16) if multi_pod else (16, 16)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             analyze: bool = True, rank: int = 0) -> Dict[str, Any]:
    """Trace one cell on one rank of the production grid; the reference's
    record, with ``rank`` (a rank at the end of an uneven split may
    differ from rank 0), the counts under ``costs`` (left out with
    ``analyze=False``) and ``trace_s``."""
    cfg = get(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16", "rank": rank,
        "n_params": cfg.n_params(), "n_active_params": cfg.n_active_params(),
    }
    if not ok:
        rec.update(status="skipped", reason=reason)
        return rec
    t0 = time.time()
    try:
        m = measure(cfg, shape, _mesh_shape(multi_pod), rank)
    except Exception as e:                # the sweep records and goes on
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:],
                   elapsed_s=round(time.time() - t0, 1))
        return rec
    c = m["costs"]
    rec.update(status="ok", trace_s=round(m["trace_s"], 2),
               memory=m["memory"])
    if analyze:
        rec["costs"] = {
            "flops_per_device": c.flops,
            "bytes_per_device": c.bytes_accessed,
            "collective_bytes_per_device": c.collective_bytes,
            "collective_by_kind": c.collective_by_kind,
            "collective_calls": c.collective_calls,
            "kernel_calls": c.kernel_calls,
            "kernel_flops": c.kernel_flops,
            "peak_bytes": c.peak_bytes,
            "peak_live": c.peak_live,
        }
    return rec


def _tag(multi: bool, arch: str, shape: str, rank: int) -> str:
    tag = f"{'multi' if multi else 'single'}__{arch}__{shape}"
    return tag if rank == 0 else f"{tag}__rank{rank}"


def _run_mesh(multi: bool, archs, shapes, out: str, analyze: bool,
              rank: int) -> int:
    """Every cell of one grid in this process (its fake group); returns
    the number of errors. Records already ``ok`` or ``skipped`` in
    ``out`` are kept."""
    n_fail = 0
    for arch in archs:
        for shape in shapes:
            tag = _tag(multi, arch, shape, rank)
            path = os.path.join(out, tag + ".json")
            if os.path.exists(path):
                with open(path) as f:
                    prev = json.load(f)
                if prev.get("status") in ("ok", "skipped"):
                    print(f"[cached] {tag}: {prev['status']}", flush=True)
                    continue
            rec = run_cell(arch, shape, multi, analyze=analyze, rank=rank)
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            msg = rec["status"]
            if rec["status"] == "ok":
                mem = rec["memory"]["per_device_total_bytes"]
                costs = rec.get("costs", {})
                top = "; ".join(f"{n / 2 ** 30:.2f}GiB {op} {list(shape)}"
                                for n, op, shape in
                                costs.get("peak_live", [])[:4])
                msg += (f" trace={rec['trace_s']}s "
                        f"mem/dev={mem / 2 ** 30:.2f}GiB flops/dev="
                        f"{costs.get('flops_per_device', 0):.3g}"
                        + (f" peak: {top}" if top else ""))
            elif rec["status"] == "error":
                n_fail += 1
                msg += " " + rec["error"][:160]
            print(f"[{tag}] {msg}", flush=True)
    return n_fail


def _mesh_main(*args) -> None:
    raise SystemExit(1 if _run_mesh(*args) else 0)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--include-extra", action="store_true",
                    help="also run the paper's own deepseek-v3 config")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--no-analyze", action="store_true")
    ap.add_argument("--rank", type=int, default=0,
                    help="the grid's rank to trace (default 0)")
    args = ap.parse_args(argv)

    archs = ([args.arch] if args.arch else
             ALL_ARCHS + (EXTRA_ARCHS if args.include_extra else []))
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    ctx = mp.get_context("spawn")
    n_fail = 0
    for multi in meshes:
        # one default group a process: each grid in a process of its own
        proc = ctx.Process(target=_mesh_main, args=(
            multi, archs, shapes, args.out, not args.no_analyze, args.rank))
        proc.start()
        proc.join()
        n_fail += proc.exitcode != 0
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
