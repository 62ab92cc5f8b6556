#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Run from the repository root on a machine with one NVIDIA H100. It

1. prints the torch and CUDA versions, the card's name and power limit
   and its memory (``total_memory``); fails if this torch lacks the fake
   process group the dry run needs;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together) and times the build;
3. holds each kernel against its plain PyTorch version on the card at the
   paths' shapes — the ragged grouped FFN for a 512-token prefill plan and
   an 8-lane decode plan (Zipf-skewed routing, some experts empty), with
   the plan's row offsets and sizes (each tile's real rows) and row hint
   as the path passes them,
   padding and sentinel rows exactly zero; the capacity FFN for the
   512-token prefill buckets (40, 128, 1536), the 8-lane decode buckets
   (40, 4, 1536), an off-grid shape and a shape only the general (WMMA)
   route takes, empty bucket rows exactly zero; the fused routing stage
   (router product, softmax, top-k, replica choice, tally, mean
   probabilities, aux loss in one launch) at the paths' T=8, 128 (a chunk,
   rows masked) and 512 and at T=4096, with the served tables (one slot an
   expert) and with three-copy replica tables, indices, slots and tally
   exactly equal outside near-tie rows (counted), two calls bit-identical;
   the logits-in router (the TPU kernel's function) at T=8, 512 and 4096
   (E=40, K=8); the attention kernels of ``csrc/flash_attention.cu``
   (``attention_cases``): the prefill kernel at granite's 4 x 512, a
   128-token chunk against a lane of the 1024-row cache under
   ``kv_valid``, context mode's rows of 4 ranks, gemma3's hd 256 under a
   1024 window and a global layer of 1 x 8192, hubert's f32 encoder at
   hd 80, a 1 x 32768 prefill and a chunk against a lane of 140000 rows
   (more than 1024 key tiles), chunks past 1024 key tiles at hd 256 and
   in f32, the serve CLI's default prefill (hd 32, 4 x 96), hd 32 at
   1 x 32768, hubert's layout in bf16 and f32 at hd 128 and 256, each on
   the route ``route_of`` names (printed; its launches counted on that
   route's own count); the decode kernel (one device operation
   a call, counted by the profiler) at granite's 8 lanes of a 1024-row
   cache, a context shard's stats (lanes with no row in it) and 8 lanes
   of 32768 rows, each row within ``ATTN_REL`` (relative L2;
   ``ATTN_REL_F32`` in f32) of the plain version, where a kernel that
   dropped half the keys reads far above it, two calls bit for bit,
   beside ``scaled_dot_product_attention``
   with ``enable_gqa`` on the same mask (timed only); the training
   gradient (``attention_grad_case``: the forward kernel, then the
   backward's ``flash_attn_bwd_dq`` and ``flash_attn_bwd_dkdv``) at
   granite's 4 x 512 and its training steps' 16 x 256, gemma3's hd 256
   window, hubert's f32 hd 80 and
   pixtral's hd 128, against f32 autograd of the plain version and
   against ``flash_attention_bwd`` on the same forward outputs, timed
   beside their bounds, the plain backward and SDPA's backward — and
   times each
   (the attention cases that ``scripts/attn_compare.py`` times are checked
   only, but granite's 4 x 512 prefill and 8-lane decode):
   the kernel's call (single-call CUDA
   events, ``ms``), the same with the card held so that the host issues
   ahead of it (``device_ms``), the host's time to issue one call
   (``host_us``), the FFNs' general (WMMA) route on the same inputs, the
   unfused routing stage (f32 product, Triton router, eager ops)
   and the Triton router on the same inputs, the plain version and the
   bound, printing each FFN kernel's route and share of its bound;
4. runs one full-width granite MoE layer through the ragged dispatch and
   through the capacity bodies, each with the kernel and with the plain
   version, and the capacity layer at capacity factor 8 against the
   ragged layer;
5. serves 8 sharegpt requests, each cut to 64 output tokens, with the
   published ``granite-moe-3b-a800m`` config (32 layers, full widths,
   seeded random weights) through the
   port's serve construction under ``vibe`` (the ragged path), checks that
   every request finishes, the logits are finite, and the ragged FFN and
   the fused routing stage launched exactly 32 times per model call (the
   logits-in router never), every FFN launch on the TMA route (the
   per-route counter equal to the total), the attention kernels 32 times
   a prefill (``flash_attn_fwd``) and a decode call (``flash_decode``);
   every served path (5, 7-9, 11, 16 (h)-(j), 18) asserts these
   attention counts and that no served weight requires a gradient; every
   path that counts launches (the grids' ranks and the dry run's too)
   finds each ``flash_attn_fwd`` launch on the tma or the tf32x3 route;
6. admits a second batch into the same engine and traces 4 decode steps
   with ``torch.profiler``: the device's busy and idle share of a step,
   its device operations, its largest kernels with the operation that
   launched each, and the FFN and routing kernels' device time a launch;
7. path (A): serves the same 8 requests, each cut to 64 output tokens,
   with ``moe_impl="capacity"`` (capacity buckets on a one-rank
   expert-parallel group), the capacity
   FFN (all on the TMA route) and the routing stage launched 32 times per
   model call, the ragged FFN never; prints the drops; then runs the
   inputs of every routing call of the run, captured, through the fused
   kernel and the unfused sequence it replaced and checks that every
   assignment on which they differ lies on a near-tie row;
8. path (B): serves 4 requests (outputs capped at 64 tokens) with chunked
   prefill in 128-token chunks on the ragged path, the ragged FFN (all on
   the TMA route) and the routing stage launched 32 times per chunk and
   decode call, the capacity FFN never; prints the largest |logit difference|
   between a chunked and a whole prefill of one 512-token prompt;
9. the serve driver's drills on the same config at full width (8 sharegpt
   requests, outputs capped at 64 tokens, ``vibe_h`` on a 2 x 4 topology,
   an engine each): a healthy run; the elasticity drill (rank 3 dies after
   5 steps), every request finished, no KV block held, the
   ``FailureReport``, the wall time and peak memory of ``fail_rank`` (the
   expert migration on the card), TTFT against the healthy run's; the
   chaos drill under ``FaultSchedule.default(8, seed=0)``, no invariant
   violated; each run launching the ragged FFN and the routing stage 32
   times a model call;
10. xlstm-350m at full width (24 layers: 21 mLSTM, 3 sLSTM; no kernel of
   the port on its path): 4 training steps of 4 x 256 tokens through
   ``launch/train.py`` (finite losses, two seeded 2-step runs bit for
   bit), a step's profile with each mixer's forward and backward timed,
   8 prompts of 256 tokens prefilled and 64 greedy decode steps of the 8
   lanes, and a 64-token prompt's chunkwise prefill against the same
   prompt stepped token by token (logits and every state leaf);
11. jamba-1.5-large at its smoke size through the serve driver (one
   attention and seven Mamba layers, four MoE layers at E 4, K 2, D 128,
   F 256): every request finished, finite logits, the routing stage and
   the ragged FFN launched once a MoE layer and model call on the TMA
   route, the attention kernels once an attention layer and call, the
   first prefill's logits against the same call through the MoE kernels'
   plain versions and its attention calls against the plain attention;
   then the serve CLI as it runs by default (qwen3-moe-235b-a22b's smoke
   config, hd 32), its launches counted the same way;
12. training (after the serving engines are freed): the backward kernels
   against their plain versions at the training shape (1024 tokens x top-8
   = 8192 assignments, Zipf-skewed, some experts empty, row block 128) —
   the ragged FFN's dgrad (K1) and wgrad (K2), on the TMA route, against
   ``ragged_moe_ffn_bwd_ref`` (padding rows and empty experts exactly zero,
   two calls bit-identical, two faulty controls above the bound), the
   routing backward (K3) against ``route_select_dlogits_ref`` (and an empty
   launch timed beside it: K3's floor) — each timed as the forward kernels
   are, K1 and K2 on both routes (and the TMA
   route's row blocks and output tiles) at 1024 and at 4096 tokens; the
   capacity FFN's gradient (``csrc/moe_ffn_bwd.cu``: the bucket K1
   ``moe_ffn_dgrad`` and K2 ``moe_ffn_wgrad``) against ``moe_ffn_bwd_ref``
   at granite's training buckets (40, 1024, 1536), a rank's a2a buckets
   of phase 13's backward (10, 4 x 412, 1536) and buckets of 36 rows
   (relative L2 within ``BWD_TOL``, empty rows exactly zero, the TMA
   route, two calls bit for bit), each timed beside its bound;
   then ``repro_torch.launch.train.train`` on the published config at full
   width, 4 steps of batch 4 x 256 tokens on the card: finite losses (the
   first near ln 49155), per step 32 launches of the routing stage, the
   ragged FFN and each backward kernel (the FFN's forward and backward on
   the TMA route), 32 of the attention's forward kernel and of each of its
   backward's two (``csrc/flash_attention_bwd.cu``) and none of the
   capacity FFN or of the decode kernel, the median step time, tokens/s and peak memory; two
   2-step runs from seed 0 with bit-identical losses and parameters; the
   capacity path's training step (``make_train_step`` with
   ``ShardingRules(moe_impl="capacity", ep_ranks=1)``) at 16 x 256: each
   step's launches exact (the routing stage, the capacity FFN, the bucket
   K1 and K2 on the TMA route, K3 and the attention's forward, 32 each),
   finite losses, step time, peak memory, and its first two steps again
   from seed 0 bit for bit; one
   step of a 2-layer full-width model through the kernels against one
   through the plain versions (autograd of the plain forward), the loss
   and every gradient within a relative L2 bound; and a checkpoint restart
   at smoke size (2 steps, restore, 2 steps) equal to 4 straight steps,
   bit for bit; and where a full-width step's time goes (forward, backward
   and AdamW on the host clock, one step traced with ``torch.profiler``);
13. expert-parallel dispatch (``ep_phase``): the same config at full
   width on 4 ranks sharing the card, joined by gloo on CUDA tensors
   (``launch.mesh.run_ranks``; the parent builds the kernels first and
   hands the ranks its seed-0 weights and results through CUDA IPC), each
   rank on its slice of the experts: at ep 4 prefills of 2 x 256 and 4 x
   256 tokens through the ragged a2a body and of 2 x 256 through the
   capacity a2a body (factor 8, dropless), 4 decode steps of 8 lanes
   through
   the replicated ragged body on ``expand_experts``' weights, and one loss
   and backward at 4 x 256 through the ragged a2a body and one through
   the capacity a2a body (factor 8; the bucket K1 and K2 on each rank's
   buckets); and (l), at 2 layers on a (2, 2, 1) grid over ("pod",
   "data", "model") with the batch over "data" and FSDP over ("pod",
   "data"), a loss at 4 x 256, its backward and one AdamW step, against
   the same ranks with FSDP over "data" alone (the loss, the tallies and
   every gradient leaf bit for bit, the step under the narrow norm's clip
   bit for bit, as it runs within ``GRID_FSDP_*``) and one device (the
   experts' gradient norm ratio 1, not 2). Each is held
   against the single-rank port on the same weights in the same run: at 2
   x 256 no assignment moves and the logits lie within 5e-2; the 4 x 256
   runs, whose routing sums in another order (see ``ep_phase``), against
   one device under the rank's routing split the same way (the gradient
   leaves within 2e-2 relative L2, the loss within 1e-3) and against one
   device as it runs within bounds set from recorded readings (the
   capacity backward against one device's capacity path under the split,
   and as it runs against one device's ragged path: at factor 8 the same
   function); decode
   under the exact (t, K, D) psum witness bit for bit, and as the port
   runs it (the reference's (t, D) psum) within a bound set so. On the
   ranks, at a 2-layer model's same shapes, every kernel call, forward
   and backward, is held against its plain version on the same inputs
   (``hold_calls``). Each rank's
   launches are exact against the layer count; each path's host wall
   time, the exchanges' share of a second run of the 2 x 256 prefill and
   of a decode step with each collective timed, and each rank's peak
   memory;
14. remat (``remat_phase``): one loss and backward at 8 x 512 with and
   without ``ShardingRules(remat=True)``, loss and gradients bit for bit
   equal; the step profile with remat at 8 x 512 and at 4 x 1024;
15. tensor parallelism of the dense layers (``tp_phase``) on 4 ranks
   sharing the card: granite at full width on (1, 4) from ``make_rules``
   (attention by heads, 6 heads and 2 KV heads a rank; EP 4; the
   residual's positions over the ranks) — a prefill of 2 x 256, 2 decode
   steps of 8 lanes (the cache's KV heads over the ranks), one loss and
   backward with remat; the same prefill and decode in context mode (query
   rows, and 1024 cache rows, over the ranks; the decode's softmax stats
   merged); smollm-360m at full width on (1, 4) (context mode, the tied
   vocabulary and the MLP's F split; no kernel of the port on its path);
   and (k), granite at 2 layers on (2, 2) with the batch and the dense
   weights' FSDP slices over "data" and ``moe_dispatch="dense"``, at 4 x
   256 (every rank runs the MoE oracle on the whole batch and the whole
   expert weights: the ragged FFN, the routing stage and K1-K3).
   Each is held against one device on the same
   weights: bit for bit under a witness that computes the attention and
   the row-wise steps as the ranks split them and adds their partials in
   rank order (the gradients within 2e-2), and as the port runs within
   bounds set from recorded readings; every rank's launches exact against
   the layer count; each run's host wall time a rank, the exchanges' share
   of a clocked run, their calls and bytes, peak memory and the dense
   weight bytes a rank;
16. the batch over ``dp`` and the sequence-sharded residual (``sp_phase``)
   on 4 ranks sharing the card, each rank holding and computing only its
   rows: granite at full width on (2, 2) from ``make_rules`` (the batch
   over "data", heads and positions over "model", dense and expert FSDP
   over "data") — a prefill of 4 x 256, 2 decode steps of 8 lanes (4 a
   rank), one loss and backward with remat, each bit for bit against the
   witness and within recorded bounds against one device as it runs, with
   the peak memory and the bytes of the block inputs remat keeps a rank;
   jamba at its smoke size on (2, 2) (the Mamba mixers split by channels
   over "model", the MoE layer through the port's kernels) against one
   device; every kernel call on the ranks, at jamba's shapes and at
   granite's (2 layers), against its plain version; every rank's launches
   exact; the training step on the grid: granite at 2 layers on (2, 2)
   with FSDP over "data", two steps of ``make_train_step`` (AdamW on each
   rank's slices, clipped by the grid's global norm) each bit for bit
   against a one-device witness on the gathered gradients and within a
   recorded bound as it runs, the train state saved from the grid and
   restored onto (1, 4) and onto one device, bit for bit; and xlstm-350m
   at full width and depth on (2, 2) from ``make_rules`` (mLSTM and sLSTM
   split by heads over "model", 2 of 4 a rank) — a prefill of 4 x 256, 2
   decode steps of 8 lanes and one loss and backward with remat, each bit
   for bit against a witness that computes each mixer as the ranks split
   it and within recorded bounds against one device, with the mixer
   weight and state bytes a rank (on phase 15's ranks: one start of them);
   and (h), on phase 15's ranks too, the serving engine on the grid:
   granite at full width and depth on (2, 2) from ``make_rules(cfg, grid,
   "prefill")`` serving 4 sharegpt requests (8 output tokens each) under
   ``vibe`` with recalibrations that move expert slots between ranks;
   the step, token and KV counts against the one-device engine, the first
   prefill and decode step bit for bit against a one-device witness, each
   rank's expert slices of both trees after each migration against the
   whole tree migrated on one device (by digest), every rank's tokens the
   same, the tokens and TTFT within recorded bounds of the one-device
   engine, each kernel call of the witness steps against its plain
   version; a rank's prefill and decode walls, the exchanges' share, each
   migration's wall and the bytes that crossed ranks, the peak a rank;
   (i), on the same ranks, the chaos drill on the grid engine (``vibe_h``
   on 2 x 4 at its default slot budget, 48 slots; a virtual rank fails, a
   stall, a DCN brownout, the rank recovers) with every step under the
   witness, beside the same drill on one device: the chaos report, the
   counts, every step's tokens and tallies exactly, each rank's slices of
   both trees after each migration, no KV block left; each rank's
   ``fail_rank`` and ``recover_rank`` wall, bytes sent and peak; and (j)
   the capacity path on the grid engine (the replicated body in every
   call): every rank's tokens, tallies and drops the same at every step,
   each call's drops a recount from its routing, ``dropped_assignments``
   their sum counted once, the first steps' kernel calls against their
   plain versions; the drops, the walls, the exchanges' share;
17. the dry run against the card, on phase 15's ranks too: granite on
   (2, 2) from ``make_rules`` — a prefill of 4 x 256 at full width and
   depth, one decode step of 4 lanes on a 512-row cache, one training step
   (``make_train_step``) at 2 layers — each run once on every rank inside
   ``count_costs`` and traced on the ``meta`` device for every rank in a
   spawned process with a fake group of 4 (``launch.dryrun.measure``):
   the kernel calls by name equal to the launches counted, the collective
   calls and operand bytes by kind equal to ``collectives.clock``'s, the
   FLOPs and the memory traffic equal between trace and card, the traced
   peak above the arguments within ``DRYRUN_PEAK_REL`` of the card's
   ``max_memory_allocated()``; each call's roofline terms (H100 data
   sheet) beside its measured wall;
18. the modality frontends (``frontend_phase``, after phase 16): (a) on
   one device, hubert-xlarge's published config (48 layers, nothing cut)
   through ``launch/train.py``, 3 steps of 4 x 256 f32 frames, then the
   same 3 steps again bit for bit, and a prefill of 2 x 512 frames;
   pixtral-12b's published config (40 layers, 12.25 B parameters) a
   prefill of 2 x (256 patches + 256 tokens), its cache of 512 rows, the
   patches drawn again moving the logits, 4 greedy text-only decode
   steps, and one ``make_train_step`` step with the depth cut to 4 layers
   (AdamW's state of 40 layers does not fit one card); every logit and
   loss finite, every kernel's launch count 0 but the attention's (once
   a layer and prefill, decode call or training step), each wall,
   tokens/s and peak; (b) on 4 ranks of its own
   (``frontend_grid_phase``), hubert-xlarge and pixtral-12b at full width
   with 2 layers on (2, 2) from ``make_rules`` (pixtral's 384 positions
   split over "model" inside its 256 patches), a prefill and a loss and
   backward each against one device within ``FRONTEND_BOUNDS``, each
   rank's residual shape recorded.

Each path's counts are set to 0 just before it is served (or trained) and
read just after. Every check raises, so any failure exits non-zero. The last three
lines of standard output are the kernels' JSON record, the ``nvidia-smi``
name and power-limit line, and ``{"ok": true, "device": {...}}``. Without a
CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import collections
import json
import math
import pathlib
import shutil
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and bf16
# tensor-core FLOP/s from the roofline, f32 FLOP/s outside the tensor
# cores
from repro_torch.launch.roofline import HBM_BW as HBM_BPS  # noqa: E402
from repro_torch.launch.roofline import PEAK_FLOPS as BF16_FLOPS  # noqa: E402
F32_FLOPS = 67e12
TF32_FLOPS = 495e12   # the tensor cores' dense TF32 rate
# ex2 (the MUFU unit's exponentials): 16 a clock on each of 132 SMs at the
# 1.98 GHz boost clock (the CUDA guide's throughput table, compute 9.0)
EX2_PER_S = 16 * 132 * 1.98e9

BF16_TOL = 5e-2       # the repo's bf16 tolerance (tests/test_kernels.py)
# K1 and K2 against the plain backward, relative L2 of each output: both
# round da, db and the outputs to bf16 at the same points, so only f32
# sums in another order differ (3.3e-4 to 4.3e-4 read on an H100). A
# backward that rounds its f32 sums to bf16 every 16 terms, or that skips
# one row an expert, reads several times more (checked in the run)
BWD_TOL = 1e-3
# kernel step vs plain step, relative L2 of every gradient leaf and
# relative error of the loss: the kernels round da and db to bf16 where
# autograd of the plain forward keeps them in f32 (1.16e-2 read on an
# H100 for the largest leaf; the plain backward against autograd of the
# plain forward reads 8.6e-3 on the CPU at smoke size)
STEP_TOL = 2e-2
STEP_LOSS_TOL = 1e-3
ROUTER_W_TOL = 1e-5   # f32 weights; indices must be exactly equal
# a recurrent model's chunkwise prefill against stepping it token by token,
# relative L2 of the logits and of each state leaf: the reference's own
# bf16 bound for the same property (tests/test_models.py)
STATE_TOL = 2e-2
NEAR_TIE = 1e-5       # adjacent top-(K+1) probabilities closer than this
# the attention kernels against their plain versions, each output row (hd
# values) by its relative L2 error, the largest over rows (``row_rel``):
# bf16 rounds p and the output on both sides, from running maxima over
# other tiles (PR 27's readings, max |difference| 1.6e-2 on rows of unit
# scale, are ~4e-3 of a row); the f32 kernels (three TF32 products on the
# tensor cores, ~2e-6 a row in a CPU emulation; or FMA) against the plain
# version's f32 einsums (TF32 off) sum in another order only. A zeroed
# row reads 1, a row that lost half its keys far above the bound
# (``attention_case`` and ``decode_case`` print that reading)
ATTN_REL = 2e-2
ATTN_REL_F32 = 1e-4


def check(ok, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip smoke check failed: {what}")


ATTN_SOURCES = ("flash_attention", "flash_attention_bwd")


def build_kernels():
    """Every kernel source built, the attention's two sources (forward,
    backward) beside the rest (one ``nvcc`` each, all at once): the
    libraries, and the attention sources' seconds to build each (0 where
    it was built before)."""
    import concurrent.futures
    from repro_torch.kernels import build
    rest = [n for n in build.sources() if n not in ATTN_SOURCES]

    def attention(name):
        t0 = time.perf_counter()
        build.build_all([name])
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(len(ATTN_SOURCES)) as pool:
        attn = [pool.submit(attention, n) for n in ATTN_SOURCES]
        build.build_all(rest)
        attn_s = dict(zip(ATTN_SOURCES, (f.result() for f in attn)))
    return {n: build.library_path(n) for n in build.sources()}, attn_s


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


def held_times(fn, reps: int, warmup: int = 2):
    """``(device_ms, host_us)`` of ``fn``: the median of ``reps``
    single-call CUDA-event times taken while a spin kernel holds the
    card, so that each event pair spans the card's work only, not the
    host's time to issue the call (which ``median_ms`` includes whenever
    the host is the slower of the two); and the host's time to issue one
    call (wrapper and launches), measured on the host clock over ``reps``
    calls issued while the card is held. The spin lasts ~50 ms or, for a
    call slow to issue, three times the host's time for ``reps`` warm
    calls. Fails if the host had not issued every call before the spin
    ended."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    per_call_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # the spin counts cycles: ~2e9 a second at the H100's boost clock
    cycles = int(max(1e8, 3 * reps * per_call_s * 2e9))
    out = []
    for timed in (True, False):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(cycles)
        b.record()
        evs = []
        t0 = time.perf_counter()
        for _ in range(reps):
            if timed:
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                fn()
                e.record()
                evs.append((s, e))
            else:
                fn()
        issue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        check(issue_ms < a.elapsed_time(b), "held timing: the host took "
              f"{issue_ms:.2f} ms to issue {reps} calls, longer than the "
              f"card was held ({a.elapsed_time(b):.2f} ms)")
        out.append(statistics.median(s.elapsed_time(e) for s, e in evs)
                   if timed else issue_ms * 1e3 / reps)
    return out[0], out[1]


def timings(fn, reps: int = 25) -> dict:
    """``ms`` (:func:`median_ms`), ``device_ms`` and ``host_us``
    (:func:`held_times`) of ``fn``."""
    device_ms, host_us = held_times(fn, reps)
    return {"ms": median_ms(fn, reps), "device_ms": device_ms,
            "host_us": host_us}


def device_ops(fn, tries: int = 3) -> int:
    """Device kernels and copies of one warm call of ``fn``, counted by
    ``torch.profiler``. The traced window holds ``fn`` between two control
    kernels (a one-element ``fill_``, ``FillFunctor`` by name); the profiler
    can hand back a window without device events (it did once on the H100,
    in a process's first trace), so a window in which both controls do
    not show is traced again, up to ``tries`` times, and then fails. The
    count is the window's device operations less the two controls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    ctl = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    seen, keys = [], set()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            ctl.fill_(1.0)
            fn()
            ctl.fill_(2.0)
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
        controls = sum(e.count for e in evs if "FillFunctor" in e.key)
        seen.append(sum(e.count for e in evs))
        keys |= {e.key[:120] for e in evs}
        if controls >= 2:
            return seen[-1] - 2
    check(False, f"the profiler saw {seen} device operations in {tries} "
          f"traced windows, without both control kernels in any (kernels "
          f"seen: {sorted(keys)})")
    return -1


def row_rel(got, want) -> float:
    """The largest relative L2 error of a row (the last dimension)."""
    d = (got.float() - want.float()).flatten(0, -2).norm(dim=-1)
    return (d / want.float().flatten(0, -2).norm(dim=-1).clamp(min=1e-30)
            ).max().item()


def bound(n_bytes: float, n_ops: float, peak_ops: float):
    t_b, t_o = n_bytes / HBM_BPS * 1e3, n_ops / peak_ops * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def attn_layers(cfg) -> int:
    """Attention layers of ``cfg``: each launches one attention kernel a
    model call (``flash_attn_fwd`` at prefill, for a chunk and in a
    training step's forward, ``flash_decode`` at decode), and each of the
    backward's two (``flash_attn_bwd_dq``, ``flash_attn_bwd_dkdv``) a
    training step's backward."""
    from repro_torch.models.model import block_layout
    nb, specs = block_layout(cfg)
    return nb * sum(s.mixer == "attn" for s in specs)


ATTN_ROUTED = ("flash_attn_fwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkdv")


def attn_routed(counts: dict, where: str) -> dict:
    """``counts`` (``ops.launch_counts()``) without the attention's
    per-route counts, once every launch of the prefill's kernels
    (:data:`ATTN_ROUTED`, forward and backward) among them is found on a
    named route (``<kernel>.tma`` and ``<kernel>.tf32x3`` add up to
    ``<kernel>``)."""
    out = dict(counts)
    for name in ATTN_ROUTED:
        routed = out.pop(f"{name}.tma", 0) + out.pop(f"{name}.tf32x3", 0)
        check(routed == out.get(name, 0),
              f"{where}: {routed} of {out.get(name, 0)} {name} launches on "
              "the tma and tf32x3 routes")
    return out


def attn_want(cfg, prefill=0, decode=0, backward=0) -> dict:
    """The attention kernels' launches of ``prefill`` prefill (or chunk)
    calls, ``decode`` decode calls and ``backward`` training backwards of
    ``cfg`` (under remat a step's forward runs twice: ``prefill`` 2,
    ``backward`` 1)."""
    n = attn_layers(cfg)
    return {"flash_attn_fwd": n * prefill, "flash_decode": n * decode,
            "flash_attn_bwd_dq": n * backward,
            "flash_attn_bwd_dkdv": n * backward}


def no_grad_weights(params, label: str) -> None:
    """Serving runs without ``no_grad``: a weight that required a gradient
    would put autograd's bookkeeping on every served call."""
    check(not any(t.requires_grad for t in _leaves(params)),
          f"{label}: a served weight requires a gradient")


def zipf_slots(gen, n: int, n_slots: int, empty):
    import torch
    p = 1.0 / torch.arange(1, n_slots + 1, dtype=torch.float64) ** 1.2
    p[[e for e in empty if e < n_slots]] = 0.0
    return torch.multinomial(p / p.sum(), n, replacement=True,
                             generator=gen).to(torch.int32)


def ragged_case(name, tokens, cfg, gen, cgen, dev):
    """A dispatch plan at the slice's shapes → kernel vs plain version,
    with the plan's row offsets and sizes (each tile's real rows) and its
    row hint, as the path passes them."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import ragged_moe_ffn as t_ragged
    from repro_torch.models.moe import _ragged_plan
    from repro_torch.models.sharding import ShardingRules
    E, D, F, K = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    bm = ShardingRules().moe_block_m
    A = tokens * K
    slot_flat = zipf_slots(gen, A, E, empty=(5, 17, 33)).to(dev)
    order, rows, tile_group, n_rows, row_off, sizes = _ragged_plan(
        slot_flat, E, bm)
    tile_rows = t_ragged.ragged_tile_rows(row_off, sizes, tile_group, bm)
    x = torch.randn((tokens, D), generator=cgen,
                    device=dev).to(torch.bfloat16)
    buf = x.new_zeros((n_rows + 1, D))
    buf[rows.long()] = x[torch.div(order, K, rounding_mode="floor")]
    buf = buf[:n_rows]
    w = [(torch.randn(s, generator=cgen, device=dev) / math.sqrt(s[1])).to(
        torch.bfloat16) for s in ((E, D, F), (E, D, F), (E, F, D))]

    def kernel(route=None):
        return t_ragged.ragged_moe_ffn(w[0], w[1], w[2], buf, tile_group,
                                       row_offsets=row_off, sizes=sizes,
                                       max_rows=tokens, route=route)

    y = ops.ragged_moe_ffn(w[0], w[1], w[2], buf, tile_group,
                           row_offsets=row_off, sizes=sizes, max_rows=tokens)
    y_ref = ref.ragged_moe_ffn_ref(w[0], w[1], w[2], buf, tile_group)
    torch.cuda.synchronize()
    route = t_ragged.ragged_moe_ffn.last_route
    check(route.startswith("tma"), f"{name}: took the {route} route")
    err = (y.float() - y_ref.float()).abs().max().item()
    real = (torch.arange(n_rows, device=dev) % bm
            < tile_rows.repeat_interleave(bm))
    check(bool(torch.isfinite(y).all()), f"{name}: non-finite output")
    check(err <= BF16_TOL, f"{name}: max |kernel - plain| {err} > {BF16_TOL}")
    check(bool((y[~real] == 0).all()),
          f"{name}: padding or sentinel rows not zero")
    res = timings(kernel)
    general = timings(lambda: kernel("general"))
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
          f" experts={n_exp} largest real rows a tile="
          f"{int(tile_rows.max())}: route {route}, max_abs_err={err:.3e} "
          f"(tol {BF16_TOL}), padding and sentinel rows exactly 0; "
          f"{ffn_times(res, general, plain_ms, bound_ms, by, n_bytes)}",
          flush=True)
    return {"max_abs_err": err, **res, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "route": route,
            "general_ms": general["ms"],
            "general_device_ms": general["device_ms"]}


def ffn_times(res, general, plain_ms, bound_ms, by, n_bytes) -> str:
    """One FFN case's times, each with its share of the bound."""
    return (f"kernel {res['ms']:.4f} ms ({100 * bound_ms / res['ms']:.1f}% "
            f"of bound), {res['device_ms']:.4f} ms with the host ahead "
            f"({100 * bound_ms / res['device_ms']:.1f}%), host "
            f"{res['host_us']:.1f} us a call; general route "
            f"{general['ms']:.4f} ms ({general['device_ms']:.4f} with the "
            f"host ahead, host {general['host_us']:.1f} us a call); plain "
            f"{plain_ms:.4f} ms; bound {bound_ms:.4f} ms ({by}, "
            f"{n_bytes / 1e6:.1f} MB)")


def capacity_case(name, E, C, D, F, cgen, dev, empty_rows, want="tma"):
    """Capacity buckets (E, C, D), the last ``empty_rows`` rows of each
    bucket zero as the dispatch leaves them → kernel vs plain version, on
    the route ``want``."""
    import torch
    from repro_torch.kernels import moe_ffn as t_capacity
    from repro_torch.kernels import ops, ref
    toks = torch.randn((E, C, D), generator=cgen, device=dev)
    toks[:, C - empty_rows:] = 0.0
    toks = toks.to(torch.bfloat16)
    w = [(torch.randn(s, generator=cgen, device=dev) / math.sqrt(s[1])).to(
        torch.bfloat16) for s in ((E, D, F), (E, D, F), (E, F, D))]
    y = ops.fused_moe_ffn(w[0], w[1], w[2], toks)
    y_ref = ref.moe_ffn_ref(w[0], w[1], w[2], toks)
    torch.cuda.synchronize()
    route = t_capacity.fused_moe_ffn.last_route
    check(route.startswith(want), f"{name}: took the {route} route")
    err = (y.float() - y_ref.float()).abs().max().item()
    check(tuple(y.shape) == (E, C, D) and bool(torch.isfinite(y).all()),
          f"{name}: output shape or finiteness")
    check(err <= BF16_TOL, f"{name}: max |kernel - plain| {err} > {BF16_TOL}")
    check(bool((y[:, C - empty_rows:] == 0).all()),
          f"{name}: empty bucket rows not exactly zero")
    res = timings(lambda: t_capacity.fused_moe_ffn(w[0], w[1], w[2], toks))
    general = timings(lambda: t_capacity.fused_moe_ffn(w[0], w[1], w[2], toks,
                                                       route="general"))
    plain_ms = median_ms(lambda: ref.moe_ffn_ref(w[0], w[1], w[2], toks),
                         reps=5)
    # every bucket is computed, occupied or not: all E experts' weights,
    # the buckets in and out
    n_bytes = E * 3 * D * F * 2 + 2 * E * C * D * 2
    bound_ms, by = bound(n_bytes, 2 * 3 * E * C * D * F, BF16_FLOPS)
    print(f"[kernel] fused_moe_ffn {name}: (E, C, D, F)=({E}, {C}, {D}, {F})"
          f", {empty_rows} empty rows a bucket: route {route}, max_abs_err="
          f"{err:.3e} (tol {BF16_TOL}), empty rows exactly 0; "
          f"{ffn_times(res, general, plain_ms, bound_ms, by, n_bytes)}",
          flush=True)
    return {"max_abs_err": err, **res, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by, "route": route,
            "general_ms": general["ms"],
            "general_device_ms": general["device_ms"]}


def _valid_pairs(qpos, kpos, kval, causal, window, chunk=1024) -> int:
    """(query position, key) pairs the masks let through: the work this
    call's data needs (a causal or windowed call skips the rest)."""
    import torch
    n = 0
    for i in range(0, qpos.numel(), chunk):
        qp = qpos[i:i + chunk, None]
        ok = torch.ones((qp.shape[0], kpos.numel()), dtype=torch.bool,
                        device=qp.device)
        if kval is not None:
            ok &= kval[None, :]
        if causal:
            ok &= kpos[None, :] <= qp
        if window:
            ok &= (qp - kpos[None, :]) < window
        n += int(ok.sum())
    return n


def _sdpa(q, k, v, mask=None, causal=False, heads=False):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    with ``enable_gqa=True`` on the same values (heads-major copies made
    beforehand, or with ``heads`` q, k, v heads-major already), the same
    mask; timed only, never on a path of the port. A causal call without a
    mask takes PyTorch's flash backend (GQA runs there and in the math
    backend only; the math backend would hold the 32768 x 32768
    scores)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel
    if heads:
        qh, kh, vh = q, k, v
    else:
        B, Sq = q.shape[:2]
        qh = q.reshape(B, Sq, -1, q.shape[-1]).transpose(1, 2).contiguous()
        kh, vh = (t.transpose(1, 2).contiguous() for t in (k, v))
    if causal:
        def call():
            with sdpa_kernel([SDPBackend.FLASH_ATTENTION]):
                return F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=True)
    else:
        def call():
            return F.scaled_dot_product_attention(
                qh, kh, vh, attn_mask=mask, enable_gqa=True)
    return call


def attention_case(name, cgen, dev, B, Sq, Skv, KV, G, hd, *, dtype=None,
                   causal=True, window=0, rows=None, n_valid=None,
                   plain_reps=5, cut=False, timed=True):
    """Kernel A (``flash_attn_fwd``) at one call site's shape against the
    plain version on the same inputs (``row_rel`` within ATTN_REL, or
    ATTN_REL_F32 in f32; two calls bit for bit) on the route ``route_of``
    names (its own launch count, so that the two routes' counts add up to
    the kernel's), then timed as the FFNs are, beside the plain version
    and the library yardstick. The bound of the tf32x3 route is its three
    TF32 products' (the FMA bound beside it); in bf16 the exponentials'
    time (an ex2 a valid pair at the SMs' ex2 rate) stands beside the
    bound. With ``cut`` also what the check reads for a kernel that
    dropped the second half of the keys (the plain version with them
    masked): it must fail. With ``timed`` False the checks only: the case
    is one that ``scripts/attn_compare.py`` times (``ms``, ``plain_ms``
    and ``library_ms`` None)."""
    import torch
    from repro_torch.kernels import flash as t_flash
    from repro_torch.kernels import ops
    from repro_torch.models import flash as plain
    dtype = dtype or torch.bfloat16
    q = torch.randn((B, Sq, KV, G, hd), generator=cgen, device=dev).to(dtype)
    k = torch.randn((B, Skv, KV, hd), generator=cgen, device=dev).to(dtype)
    v = torch.randn((B, Skv, KV, hd), generator=cgen, device=dev).to(dtype)
    qpos = torch.arange(*(rows or (Sq,)), device=dev)
    kpos = torch.arange(Skv, device=dev)
    kval = None if n_valid is None else kpos < n_valid
    kw = dict(causal=causal, window=window, q_positions=qpos,
              kv_positions=kpos, kv_valid=kval)
    route = t_flash.route_of(dtype, hd)
    before = t_flash.flash_attn_fwd.launches
    on_route = f"{route}_launches"
    before_route = getattr(t_flash.flash_attn_fwd, on_route)
    y = ops.flash_attention(q, k, v, **kw)
    y_ref = plain.flash_attention(q, k, v, **kw)
    y2 = ops.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    check(t_flash.flash_attn_fwd.launches == before + 2,
          f"attention {name}: the dispatch did not launch the kernel")
    check(getattr(t_flash.flash_attn_fwd, on_route) - before_route == 2,
          f"attention {name}: not on the {route} route")
    tol = ATTN_REL if dtype == torch.bfloat16 else ATTN_REL_F32
    err = row_rel(y, y_ref)
    check(bool(torch.isfinite(y).all()) and y.shape == q.shape,
          f"attention {name}: output shape or finiteness")
    check(err <= tol, f"attention {name}: row relative L2 of kernel - "
          f"plain {err} > {tol}")
    check(torch.equal(y, y2), f"attention {name}: two calls differ")
    cut_err = None
    if cut:
        half = kpos < Skv // 2 if kval is None else kval & (kpos < Skv // 2)
        cut_err = row_rel(plain.flash_attention(
            q, k, v, **(kw | {"kv_valid": half})), y_ref)
        check(cut_err > tol, f"attention {name}: half the keys dropped "
              f"reads {cut_err}, inside the bound {tol}")
    del y, y2, y_ref
    res = {"ms": None, "device_ms": None, "host_us": None}
    plain_ms = library_ms = None
    if timed:
        res = timings(lambda: t_flash.flash_attn_fwd(q, k, v, **kw))
        plain_ms = median_ms(lambda: plain.flash_attention(q, k, v, **kw),
                             reps=plain_reps, warmup=1)
        # PyTorch's flash backend takes 16-bit inputs only: f32 gets the
        # mask
        plain_full = (causal and rows is None and n_valid is None
                      and not window and dtype == torch.bfloat16)
        mask = None
        if not plain_full:
            mask = torch.ones((Sq, Skv), dtype=torch.bool, device=dev)
            if kval is not None:
                mask &= kval[None, :]
            if causal:
                mask &= kpos[None, :] <= qpos[:, None]
            if window:
                mask &= (qpos[:, None] - kpos[None, :]) < window
        library_ms = median_ms(_sdpa(q, k, v, mask, causal=plain_full),
                               reps=5)
        del mask
    pairs = _valid_pairs(qpos, kpos, kval, causal, window) * B * KV * G
    n_bytes = (2 * q.numel() * q.element_size() + 2 * k.numel()
               * k.element_size() + (Sq + Skv) * 8
               + (0 if kval is None else Skv))
    flops = 4 * hd * pairs
    fma_ms = ex2_ms = None
    if dtype == torch.bfloat16:
        bound_ms, by = bound(n_bytes, flops, BF16_FLOPS)
        ex2_ms = pairs / EX2_PER_S * 1e3
    else:
        fma_ms = bound(n_bytes, flops, F32_FLOPS)[0]
        bound_ms, by = bound(n_bytes, 3 * flops, TF32_FLOPS)
    print(f"[kernel] flash_attn_fwd {name}: q {tuple(q.shape)} k "
          f"{tuple(k.shape)} {str(dtype)[6:]}, causal {causal}, window "
          f"{window}, rows {rows or 'all'}, valid keys "
          f"{n_valid or 'all'}, {route} route (2 launches on it): row "
          f"relative L2 {err:.3e} (tol {tol}"
          + ("" if cut_err is None else
             f"; half the keys dropped would read {cut_err:.3e}")
          + "), two calls bit for bit; "
          + (f"kernel {res['ms']:.4f} ms ({100 * bound_ms / res['ms']:.1f}% "
             f"of bound), {res['device_ms']:.4f} ms with the host ahead, "
             f"host {res['host_us']:.1f} us a call; plain {plain_ms:.4f} ms;"
             f" SDPA {library_ms:.4f} ms; " if timed else
             "timed by scripts/attn_compare.py; ")
          + f"bound {bound_ms:.4f} ms ({by}, "
          f"{flops / 1e9:.2f} GFLOP of valid pairs"
          + ("" if route != "tf32x3" else
             f", three TF32 products at {TF32_FLOPS / 1e12:.0f} TFLOP/s")
          + ("" if fma_ms is None else
             f"; the FMA bound {fma_ms:.4f} ms")
          + f", {n_bytes / 1e6:.1f} MB"
          + ("" if ex2_ms is None else
             f"; the exponentials {ex2_ms:.4f} ms, an ex2 a valid pair at "
             f"{EX2_PER_S / 1e12:.2f} T/s")
          + ")", flush=True)
    return {"max_abs_err": err, "cut_err": cut_err, **res,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "fma_bound_ms": fma_ms, "ex2_ms": ex2_ms,
            "library_ms": library_ms, "kernel_route": route,
            "shape": {"q": list(q.shape), "k": list(k.shape),
                      "dtype": str(dtype)[6:], "causal": causal,
                      "window": window, "rows": rows, "n_valid": n_valid}}


def decode_case(name, cgen, dev, B, S_max, KV, G, hd, pos, *, window=0,
                kpos_offset=0, stats=False, plain_reps=5, cut=False,
                timed=True):
    """Kernel B (``flash_decode``) against the plain version: the output
    by ``row_rel`` within ATTN_REL; with ``stats`` acc's rows the same, m
    within ATTN_REL of its largest |m| and l of each l, and a lane with no
    valid row of this cache exactly (m, l, acc) = (_NEG, 0, 0) in both;
    two calls bit for bit; one device operation a call; timed with the
    plain version and the library yardstick (with ``timed`` False not: a
    case that ``scripts/attn_compare.py`` times). With ``cut`` also what
    the check reads for a kernel that dropped the second half of each
    lane's rows: it must fail."""
    import torch
    from repro_torch.kernels import flash as t_flash
    from repro_torch.kernels import ops
    from repro_torch.models import flash as plain
    q = torch.randn((B, KV, G, hd), generator=cgen,
                    device=dev).to(torch.bfloat16)
    kc = torch.randn((B, S_max, KV, hd), generator=cgen,
                     device=dev).to(torch.bfloat16)
    vc = torch.randn((B, S_max, KV, hd), generator=cgen,
                     device=dev).to(torch.bfloat16)
    pos = torch.tensor(pos, device=dev)
    kw = dict(window=window, kpos_offset=kpos_offset, return_stats=stats)
    before = t_flash.flash_decode.launches
    got = ops.flash_decode(q, kc, vc, pos, **kw)
    want = plain.flash_decode(q, kc, vc, pos, **kw)
    again = ops.flash_decode(q, kc, vc, pos, **kw)
    torch.cuda.synchronize()
    check(t_flash.flash_decode.launches == before + 2,
          f"decode {name}: the dispatch did not launch the kernel")
    got, want, again = ((t,) if not stats else t for t in (got, want, again))
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"decode {name}: two calls differ")
    kp = kpos_offset + torch.arange(S_max, device=dev)
    valid = kp[None, :] <= pos[:, None]
    if window:
        valid &= (pos[:, None] - kp[None, :]) < window
    rows = valid.sum(1)
    if stats:
        (acc, m, l), (acc_p, m_p, l_p) = got, want
        empty = rows == 0
        check(bool(empty.any()) and bool((m[empty] == m_p[empty]).all())
              and bool((l[empty] == 0).all() and (acc[empty] == 0).all()),
              f"decode {name}: a lane with no valid row is not (_NEG, 0, 0)")
        err = max(row_rel(acc[~empty], acc_p[~empty]),
                  ((m[~empty] - m_p[~empty]).abs().max()
                   / m_p[~empty].abs().max()).item(),
                  ((l[~empty] - l_p[~empty]).abs() / l_p[~empty]).max()
                  .item())
    else:
        err = row_rel(got[0], want[0])
    check(all(bool(torch.isfinite(t).all()) for t in got),
          f"decode {name}: non-finite output")
    check(err <= ATTN_REL, f"decode {name}: relative error of kernel - "
          f"plain {err} > {ATTN_REL}")
    cut_err = None
    if cut:
        cut_err = row_rel(plain.flash_decode(q, kc, vc, pos // 2, **kw),
                          want[0])
        check(cut_err > ATTN_REL, f"decode {name}: half the rows dropped "
              f"reads {cut_err}, inside the bound {ATTN_REL}")
    ops_a_call = device_ops(lambda: t_flash.flash_decode(q, kc, vc, pos,
                                                         **kw))
    check(ops_a_call == 1, f"decode {name}: {ops_a_call} device "
          "operations a call, expected one launch")
    res = {"ms": None, "device_ms": None, "host_us": None}
    plain_ms = library_ms = None
    if timed:
        res = timings(lambda: t_flash.flash_decode(q, kc, vc, pos, **kw))
        plain_ms = median_ms(lambda: plain.flash_decode(q, kc, vc, pos,
                                                        **kw),
                             reps=plain_reps, warmup=1)
        library_ms = median_ms(_sdpa(q[:, None], kc, vc,
                                     valid[:, None, None, :]), reps=5)
    n_rows = int(rows.sum())
    out_bytes = (B * KV * G * hd * 4 + 2 * B * KV * G * 4 if stats
                 else B * KV * G * hd * 2)
    n_bytes = (q.numel() * 2 + 2 * n_rows * KV * hd * 2 + B * 8
               + out_bytes)
    bound_ms, by = bound(n_bytes, 4 * hd * G * KV * n_rows, BF16_FLOPS)
    splits = t_flash.decode_splits(S_max)
    print(f"[kernel] flash_decode {name}: q {tuple(q.shape)} cache "
          f"{tuple(kc.shape)}, pos {pos.tolist()}, window {window}, row "
          f"offset {kpos_offset}, stats {stats}: {splits} split(s) of "
          f"{t_flash.decode_split_rows(S_max)} rows, {ops_a_call} device "
          f"operation(s) a call (the profiler); valid rows {n_rows}; "
          f"relative error {err:.3e} (tol {ATTN_REL}"
          + ("" if cut_err is None else
             f"; half the rows dropped would read {cut_err:.3e}")
          + "), two calls bit for bit; "
          + (f"kernel {res['ms']:.4f} ms ({100 * bound_ms / res['ms']:.1f}% "
             f"of bound), {res['device_ms']:.4f} ms with the host ahead, "
             f"host {res['host_us']:.1f} us a call; plain {plain_ms:.4f} ms;"
             f" SDPA (normalised output) {library_ms:.4f} ms; " if timed
             else "timed by scripts/attn_compare.py; ")
          + f"bound {bound_ms:.4f} ms ({by}, {n_bytes / 1e6:.1f} MB)",
          flush=True)
    return {"max_abs_err": err, "cut_err": cut_err, **res,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": by,
            "library_ms": library_ms, "device_ops_a_call": ops_a_call,
            "shape": {"q": list(q.shape), "cache": list(kc.shape),
                      "pos": pos.tolist(), "window": window,
                      "kpos_offset": kpos_offset, "stats": stats,
                      "splits": splits}}


def _sdpa_grad(q, k, v, dout, mask=None, causal=False):
    """The library yardstick of the backward: ``scaled_dot_product_attention``
    as :func:`_sdpa` calls it, on heads-major copies that require a
    gradient, its output's gradient ``dout`` (heads-major): ``(both,
    backward)``, one call of the forward and backward, and one of the
    backward alone (``autograd.grad`` on a kept graph). Timed only, never
    on a path of the port."""
    import torch
    B, Sq = q.shape[:2]
    hd = q.shape[-1]
    ins = [t.detach().requires_grad_(True) for t in (
        q.reshape(B, Sq, -1, hd).transpose(1, 2).contiguous(),
        k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())]
    g = dout.reshape(B, Sq, -1, hd).transpose(1, 2).contiguous()
    fwd = _sdpa(*ins, mask=mask, causal=causal, heads=True)
    out = fwd()

    def both():
        torch.autograd.grad(fwd(), ins, g)

    def backward():
        torch.autograd.grad(out, ins, g, retain_graph=True)
    return both, backward


def _bwd_split_ms(fn, reps: int = 10) -> dict:
    """Device ms a call of each backward kernel (``attn_bwd_dq``,
    ``attn_bwd_dkdv``) over ``reps`` calls of ``fn`` under
    ``torch.profiler`` (None where the profiler saw none)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in ("attn_bwd_dq", "attn_bwd_dkdv"):
        ev = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and name in e.key]
        n = sum(e.count for e in ev)
        out[name] = (sum(e.self_device_time_total for e in ev) / n / 1e3
                     if n else None)
    return out


def attention_grad_case(name, cgen, dev, B, S, KV, G, hd, *, window=0,
                        dtype=None, causal=True):
    """The training path's attention (``ops.FlashAttention``: kernel A's
    forward, then the backward's kernels ``flash_attn_bwd_dq`` and
    ``flash_attn_bwd_dkdv`` from its rows' m and l): one launch of each;
    its gradients of q, k and v against autograd of the plain version in
    f32 on the same inputs (relative L2 of each; bf16 within ATTN_REL, the
    plain version's bf16 autograd printed beside it; f32 within
    ATTN_REL_F32); the backward kernels against the plain backward
    (``flash_attention_bwd``) on the same forward outputs, within the same
    bounds, two calls bit for bit. Timed: the two kernels (CUDA events
    over the pair, each one's device time from the profiler), beside their
    bounds (each kernel's own function: dQ from S, dP; dK and dV from S,
    dP; the pair's five products a valid pair), the plain backward, the
    forward and backward through ``ops``, and SDPA's backward (and its
    forward and backward) as the library yardstick."""
    import torch
    from repro_torch.kernels import flash as t_flash
    from repro_torch.kernels import ops
    from repro_torch.models import flash as plain
    dtype = dtype or torch.bfloat16
    base = [torch.randn(shape, generator=cgen, device=dev).to(dtype)
            for shape in ((B, S, KV, G, hd), (B, S, KV, hd), (B, S, KV, hd))]
    w = torch.randn((B, S, KV, G, hd), generator=cgen, device=dev)
    pos = torch.arange(S, device=dev)
    kw = dict(causal=causal, window=window, q_positions=pos,
              kv_positions=pos)

    def grads(fn, dt):
        ts = [t.to(dt, copy=True).requires_grad_(True) for t in base]
        (fn(*ts, **kw).float() * w).sum().backward()
        return [t.grad.float() for t in ts]

    ops.reset_launch_counts()
    got = grads(ops.flash_attention, dtype)
    torch.cuda.synchronize()
    launched = attn_routed(ops.launch_counts(), f"attention grad {name}")
    route = t_flash.route_of(dtype, hd)
    on_route = {k: ops.launch_counts()[f"{k}.{route}"] for k in ATTN_ROUTED}
    want = grads(plain.flash_attention, torch.float32)
    k_err = [_rel_l2(a, b) for a, b in zip(got, want)]
    p_err = None
    if dtype == torch.bfloat16:
        p_err = [_rel_l2(a, b) for a, b in zip(
            grads(plain.flash_attention, dtype), want)]
    del got, want
    tol = ATTN_REL if dtype == torch.bfloat16 else ATTN_REL_F32
    check(all(launched[k] == on_route[k] == 1 for k in ATTN_ROUTED),
          f"attention grad {name}: launches {launched}, on the {route} "
          f"route {on_route}")
    check(max(k_err) <= tol,
          f"attention grad {name}: dq, dk, dv against f32 {k_err} (bound "
          f"{tol}), the plain bf16 autograd's {p_err}")
    # the backward's kernels against the plain backward on the same
    # forward outputs
    q, k, v = base
    out, m, l = t_flash.flash_attn_fwd(q, k, v, return_stats=True, **kw)
    dout = w.to(dtype)

    def kernels():
        return t_flash.flash_attn_bwd(q, k, v, out, dout, m, l, **kw)

    def plain_bwd():
        return plain.flash_attention_bwd(q, k, v, out, dout, m, l, **kw)

    kg, again, pg = kernels(), kernels(), plain_bwd()
    torch.cuda.synchronize()
    b_err = [_rel_l2(a, b) for a, b in zip(kg, pg)]
    abs_err = max(float((a.float() - b.float()).abs().max())
                  for a, b in zip(kg, pg))
    check(max(b_err) <= tol and all(bool(torch.isfinite(a).all())
                                    for a in kg),
          f"attention grad {name}: the backward kernels against the plain "
          f"backward on the same outputs {b_err} (bound {tol})")
    check(all(torch.equal(a, b) for a, b in zip(kg, again)),
          f"attention grad {name}: two backward calls differ")
    del kg, again, pg
    res = timings(kernels)
    split = _bwd_split_ms(kernels)
    plain_ms = median_ms(plain_bwd, reps=3, warmup=1)
    fwd_bwd_ms = median_ms(lambda: grads(ops.flash_attention, dtype),
                           reps=5, warmup=1)
    mask = None
    if window or not causal or dtype != torch.bfloat16:
        mask = torch.ones((S, S), dtype=torch.bool, device=dev)
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        if window:
            mask &= (pos[:, None] - pos[None, :]) < window
    lib_both, lib_bwd = _sdpa_grad(q, k, v, dout, mask,
                                   causal=mask is None)
    library_ms = median_ms(lib_bwd, reps=5)
    library_both_ms = median_ms(lib_both, reps=5)
    del lib_both, lib_bwd, mask
    # the bounds: valid pairs; each input read once, each output written
    pairs = _valid_pairs(pos, pos, None, causal, window) * B * KV * G
    size = q.element_size()
    rows_b = q.numel() * size                     # q, out, dout, dq: each
    kv_b = k.numel() * size                       # k, v, dk, dv: each
    stats_b = 2 * m.numel() * 4 + 2 * S * 8       # m, l; the positions
    peak, mult = ((BF16_FLOPS, 1) if dtype == torch.bfloat16
                  else (TF32_FLOPS, 3))
    bounds = {
        "attn_bwd_dq": bound(4 * rows_b + 2 * kv_b + stats_b,
                             mult * 6 * hd * pairs, peak),
        "attn_bwd_dkdv": bound(2 * rows_b + 4 * kv_b + stats_b,
                               mult * 8 * hd * pairs, peak),
        "pair": bound(4 * rows_b + 4 * kv_b + stats_b,
                      mult * 10 * hd * pairs, peak)}
    print(f"[kernel] flash_attn_bwd {name}: q ({B}, {S}, {KV}, {G}, {hd}) "
          f"{str(dtype)[6:]}, causal {causal}, window {window}, {route} "
          f"route, one launch each of {', '.join(ATTN_ROUTED)}: dq, dk, dv "
          f"against f32 autograd, relative L2 "
          f"{', '.join(f'{e:.3e}' for e in k_err)} (tol {tol})"
          + ("" if p_err is None else
             f"; the plain version's bf16 autograd "
             f"{', '.join(f'{e:.3e}' for e in p_err)}")
          + f"; the kernels against the plain backward on the same outputs "
          f"{', '.join(f'{e:.3e}' for e in b_err)}, two calls bit for bit; "
          f"the pair {res['ms']:.4f} ms ({100 * bounds['pair'][0] / res['ms']:.1f}"
          f"% of its bound {bounds['pair'][0]:.4f} ms, {bounds['pair'][1]}), "
          f"{res['device_ms']:.4f} ms with the host ahead, host "
          f"{res['host_us']:.1f} us; dq "
          + ", dkdv ".join(
              "not measured" if split[k] is None else
              f"{split[k]:.4f} ms device ({100 * bounds[k][0] / split[k]:.1f}"
              f"% of its bound {bounds[k][0]:.4f} ms)"
              for k in ("attn_bwd_dq", "attn_bwd_dkdv"))
          + f"; the plain backward {plain_ms:.4f} ms; forward and backward "
          f"through ops {fwd_bwd_ms:.4f} ms; SDPA backward {library_ms:.4f}"
          f" ms, forward and backward {library_both_ms:.4f} ms "
          f"({pairs * 10 * hd / 1e9:.2f} GFLOP of valid pairs)", flush=True)
    return {"rel_l2": k_err, "plain_rel_l2": p_err, "bwd_rel_l2": b_err,
            "max_abs_err": abs_err, **res, "split_ms": split, "plain_ms": plain_ms,
            "fwd_bwd_ms": fwd_bwd_ms, "library_ms": library_ms,
            "library_fwd_bwd_ms": library_both_ms,
            "bounds": {k: {"bound_ms": b[0], "bound_by": b[1]}
                       for k, b in bounds.items()},
            "kernel_route": route,
            "shape": {"q": [B, S, KV, G, hd], "dtype": str(dtype)[6:],
                      "causal": causal, "window": window}}


def attention_cases(cfg, cgen, dev) -> dict:
    """Phase 3's attention: kernels A and B at the paths' shapes (granite
    unless named) and at long context."""
    import torch
    KV, G, hd = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.hd
    t0 = time.perf_counter()
    out = {"fwd": {}, "decode": {}, "grad": {}}
    a, d = out["fwd"], out["decode"]
    a["prefill-4x512"] = attention_case("prefill-4x512", cgen, dev, 4, 512,
                                        512, KV, G, hd, cut=True)
    # a 128-token chunk (rows 384-511) against a lane of the 1024-row cache
    # the cases below that scripts/attn_compare.py times are checked only
    # (``timed=False``)
    a["chunk-vs-lane"] = attention_case(
        "chunk-vs-lane", cgen, dev, 1, 128, 1024, KV, G, hd,
        rows=(384, 512), n_valid=512, timed=False)
    # context mode on 4 ranks: rank 1's 64 query rows of 2 x 256
    a["context-rows"] = attention_case("context-rows", cgen, dev, 2, 64, 256,
                                       KV, G, hd, rows=(64, 128))
    # gemma3-4b's local layers: hd 256, window 1024, 4 KV heads x 2
    a["gemma3-hd256-window"] = attention_case(
        "gemma3-hd256-window", cgen, dev, 1, 2048, 2048, 4, 2, 256,
        window=1024, timed=False)
    # hubert-xlarge: f32 q/k/v, an encoder (no causal mask), hd 80
    a["hubert-f32"] = attention_case("hubert-f32", cgen, dev, 2, 512, 512,
                                     16, 1, 80, dtype=torch.float32,
                                     causal=False, timed=False)
    # gemma3-4b's global layers: hd 256, causal, no window, at 8192
    a["gemma3-hd256-8192"] = attention_case(
        "gemma3-hd256-8192", cgen, dev, 1, 8192, 8192, 4, 2, 256,
        timed=False)
    a["prefill-1x32768"] = attention_case("prefill-1x32768", cgen, dev, 1,
                                          32768, 32768, KV, G, hd,
                                          timed=False)
    # a 128-token chunk against a lane of 140000 rows: 1094 key tiles of
    # 128 on the Hopper route, past the 1024 whose states the kernels take
    # a window at a time
    a["chunk-vs-140000"] = attention_case(
        "chunk-vs-140000", cgen, dev, 1, 128, 140000, KV, G, hd,
        rows=(138000, 138128), n_valid=138128, timed=False)
    # the same past 1024 key tiles of 64 on the hd 256 Hopper route and
    # the tf32x3 route (1065 live tiles of 1094), whose states each judges
    # a window of 1024 at a time; in f32 the last 1128 keys cut by kv_valid
    for name, long_hd, dtype, n_valid in (
            ("chunk-vs-70000-hd256", 256, torch.bfloat16, 68128),
            ("chunk-vs-70000-f32", 80, torch.float32, 67000)):
        a[name] = attention_case(
            name, cgen, dev, 1, 128, 70000, 2, 2, long_hd, dtype=dtype,
            rows=(68000, 68128), n_valid=n_valid, plain_reps=2)
    # the serve CLI's default prefill: its arch's smoke config (hd 32, KV 2
    # x G 2) at --max-batch 4 --max-seq 96
    a["serve-smoke-hd32"] = attention_case("serve-smoke-hd32", cgen, dev, 4,
                                           96, 96, 2, 2, 32, timed=False)
    a["hd32-1x32768"] = attention_case("hd32-1x32768", cgen, dev, 1, 32768,
                                       32768, 2, 2, 32, timed=False)
    # hubert's head layout (16 KV heads of one, hd 80, no mask) in bf16
    a["bf16-hd80-2x2048"] = attention_case("bf16-hd80-2x2048", cgen, dev, 2,
                                           2048, 2048, 16, 1, 80,
                                           causal=False, timed=False)
    # f32 at hd 128 and 256 (the wide tf32x3 kernel)
    a["f32-hd128-1x4096"] = attention_case(
        "f32-hd128-1x4096", cgen, dev, 1, 4096, 4096, 8, 3, 128,
        dtype=torch.float32, timed=False)
    a["f32-hd256-1x4096"] = attention_case(
        "f32-hd256-1x4096", cgen, dev, 1, 4096, 4096, 4, 2, 256,
        dtype=torch.float32, timed=False)
    # the training path: granite's 4 x 512 and its training steps' 16 x
    # 256 (phase 12's profile and capacity step; train_phase and the
    # 2-layer kernel-vs-plain step take 4 x 256, the same blocks over
    # fewer lanes), gemma3's hd 256 window, hubert's f32 encoder (hd 80,
    # no mask) and pixtral's hd 128 (8 KV heads x 4) at phase 18's 2 x
    # (256 + 256)
    g = out["grad"]
    g["train-4x512"] = attention_grad_case(
        "train-4x512", cgen, dev, 4, 512, KV, G, hd)
    g["train-16x256"] = attention_grad_case(
        "train-16x256", cgen, dev, 16, 256, KV, G, hd)
    g["gemma3-hd256-window"] = attention_grad_case(
        "gemma3-hd256-window", cgen, dev, 1, 2048, 4, 2, 256, window=1024)
    g["hubert-f32"] = attention_grad_case(
        "hubert-f32", cgen, dev, 2, 512, 16, 1, 80, dtype=torch.float32,
        causal=False)
    g["pixtral-hd128"] = attention_grad_case(
        "pixtral-hd128", cgen, dev, 2, 512, 8, 4, 128)
    torch.cuda.empty_cache()
    lanes = [37, 100, 250, 511, 600, 800, 1000, 1023]
    d["decode-8"] = decode_case("decode-8", cgen, dev, 8, 1024, KV, G, hd,
                                lanes, cut=True)
    # context mode's shard: rank 1's 256 rows of 1024 (two lanes before)
    d["decode-8-stats"] = decode_case("decode-8-stats", cgen, dev, 8, 256, KV,
                                      G, hd, lanes, kpos_offset=256,
                                      stats=True, timed=False)
    d["decode-8x32768"] = decode_case(
        "decode-8x32768", cgen, dev, 8, 32768, KV, G, hd,
        [32767 - 3 * i for i in range(8)], timed=False)
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t0
    print(f"[time] phase 3 attention cases: {out['wall_s']:.1f} s",
          flush=True)
    return out


def router_case(cgen, dev, T, E=40, K=8):
    """The logits-in router (the TPU kernel's function) against its plain
    version, timed beside the earlier Triton kernel on the same logits."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import route_select as t_route
    from repro_torch.kernels import router as t_router
    logits = torch.randn((T, E), generator=cgen, device=dev)
    w, idx = ops.router_topk(logits, K)
    w_ref, idx_ref = ref.router_topk_ref(logits, K)
    w_tr, idx_tr = t_router.router_topk(logits, K)
    torch.cuda.synchronize()
    check(bool(torch.equal(idx, idx_ref)), "router: indices differ")
    check(bool(torch.equal(idx_tr, idx_ref)), "Triton router: indices differ")
    err = (w - w_ref).abs().max().item()
    check(err <= ROUTER_W_TOL, f"router: weights differ by {err}")
    res = timings(lambda: t_route.router_topk(logits, K), reps=50)
    triton = timings(lambda: t_router.router_topk(logits, K), reps=50)
    plain_ms = median_ms(lambda: ref.router_topk_ref(logits, K), reps=10)
    n_bytes = T * E * 4 + T * K * 8
    # softmax ~5 ops/element, each of the K sweeps ~6 ops/element
    bound_ms, by = bound(n_bytes, T * E * (5 + 6 * K), F32_FLOPS)
    print(f"[kernel] router_topk T={T} E={E} K={K}: indices exactly equal "
          f"(the Triton kernel's too), max_abs_err(weights)={err:.3e} (tol "
          f"{ROUTER_W_TOL}), kernel {res['ms']:.4f} ms ({res['device_ms']:.4f}"
          f" ms with the host ahead, host {res['host_us']:.1f} us a call), "
          f"Triton {triton['ms']:.4f} ms ({triton['device_ms']:.4f}, host "
          f"{triton['host_us']:.1f} us), plain {plain_ms:.4f} ms, bound "
          f"{bound_ms:.6f} ms ({by})", flush=True)
    return {"max_abs_err": err, **res, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "triton_ms": triton["ms"], "triton_device_ms": triton["device_ms"],
            "triton_host_us": triton["host_us"]}


def route_tables(E, R, gen, dev):
    """The served tables (R = 1: one slot an expert, the identity), or
    replica tables with R copy columns: each expert 1..R copies on distinct
    slots, a non-uniform cumulative share, padding entries at 1.0."""
    import torch
    if R == 1:
        return (torch.arange(E, dtype=torch.int32, device=dev)[:, None],
                torch.ones(E, dtype=torch.int32, device=dev),
                torch.ones((E, 1), device=dev))
    so = torch.randperm(E * R, generator=gen).reshape(E, R)
    nc = torch.randint(1, R + 1, (E,), generator=gen)
    nc[0] = R
    used = torch.arange(R)[None, :] < nc[:, None]
    share = (torch.rand((E, R), generator=gen) + 0.1) * used
    cdf = torch.where(used, torch.cumsum(share / share.sum(-1, keepdim=True),
                                         -1), 1.0)
    return (so.to(dev, torch.int32), nc.to(dev, torch.int32),
            cdf.to(dev, torch.float32))


def unfused_route(x, w, tables, seed, K, row_valid=None):
    """The unfused routing stage the fused kernel replaces: the f32
    product, the Triton router, a second softmax for the mean
    probabilities, then the eager replica choice, tally, aux loss and the
    tally's zero drop column."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import router as t_router
    E = w.shape[1]
    logits = x.float() @ w
    weights, idx = t_router.router_topk(logits, K)
    mean_prob = torch.softmax(logits, dim=-1).mean(dim=0)
    if row_valid is not None:
        weights = weights * row_valid[:, None].to(weights.dtype)
    slots = ref.select_slots(idx, *tables, seed)
    tally = ref.masked_tally(idx, E, row_valid)
    aux = ref.aux_loss(tally, mean_prob, E)
    return (weights, idx, slots, torch.cat([tally, tally.new_zeros((1,))]),
            mean_prob, aux)


def route_case(cfg, gen, cgen, dev, T, R, masked=False):
    """The fused routing stage at granite's widths against its plain
    version: indices, slots and tally exactly equal outside near-tie rows
    (rows whose adjacent top-(K+1) probabilities are closer than
    ``NEAR_TIE``, where another summation order may pick another column;
    counted, and their counts taken out of both tallies), weights, mean
    probabilities and aux within ``ROUTER_W_TOL``, two calls bit-identical;
    timed beside the unfused sequence and the Triton router on the same
    inputs."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels import route_select as t_route
    from repro_torch.kernels import router as t_router
    D, E, K = cfg.d_model, cfg.n_experts, cfg.top_k
    x = torch.randn((T, D), generator=cgen, device=dev).to(torch.bfloat16)
    w = torch.randn((D, E), generator=cgen, device=dev) / math.sqrt(D)
    tables = route_tables(E, R, gen, dev)
    seed = torch.tensor(T * 31 + R, dtype=torch.int32, device=dev)
    rv = (torch.rand(T, generator=cgen, device=dev) < 0.75) if masked \
        else None
    args = (x, w, *tables, seed, K, rv)
    got = ops.route_select(*args)
    again = ops.route_select(*args)
    want = ref.route_select_ref(*args)
    old = unfused_route(x, w, tables, seed, K, rv)
    torch.cuda.synchronize()
    name = f"T={T} R={R}{' masked' if masked else ''}"
    check(all(bool(torch.equal(a, b)) for a, b in zip(got, again)),
          f"route_select {name}: two calls differ")
    check(bool(torch.equal(old[1], want[1])),
          f"route_select {name}: the unfused sequence's indices differ")
    w_k, i_k, s_k, t_k, mp_k, aux_k = [t.clone() for t in got]
    w_r, i_r, s_r, t_r, mp_r, aux_r = want
    p = torch.softmax(x.float() @ w, dim=-1)
    top = torch.topk(p, K + 1, dim=-1).values
    near = ((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(-1)
    ok = ~near
    differ = int(((i_k != i_r).any(-1) | (s_k != s_r).any(-1)).sum())
    check(bool(torch.equal(i_k[ok], i_r[ok])) and
          bool(torch.equal(s_k[ok], s_r[ok])),
          f"route_select {name}: indices or slots differ outside near ties")
    counted = near if rv is None else near & rv
    for t, i in ((t_k, i_k), (t_r, i_r)):
        t[:E] -= torch.bincount(i[counted].reshape(-1).long(),
                                minlength=E).float()
    check(bool(torch.equal(t_k, t_r)),
          f"route_select {name}: tallies differ outside near ties")
    err = max((w_k[ok] - w_r[ok]).abs().max().item(),
              (mp_k - mp_r).abs().max().item(),
              abs(aux_k.item() - aux_r.item()) / max(abs(aux_r.item()), 1.0))
    check(err <= ROUTER_W_TOL, f"route_select {name}: weights, mean "
          f"probabilities or aux differ by {err}")
    if rv is not None:
        check(bool((w_k[~rv] == 0).all()), f"route_select {name}: masked "
              "rows have gate weight")
    res = timings(lambda: t_route.route_select(*args), reps=50)
    # 10 calls of 22-45 launches stay inside the card's launch queue while
    # it is held (a full queue blocks the host)
    unfused = timings(lambda: unfused_route(x, w, tables, seed, K, rv),
                      reps=10)
    logits = x.float() @ w
    triton = timings(lambda: t_router.router_topk(logits, K), reps=50)
    plain_ms = median_ms(lambda: ref.route_select_ref(*args), reps=10)
    n_bytes = (T * D * 2 + D * E * 4 + E * R * 8 + E * 4 + 4
               + (T if masked else 0) + T * K * 12 + (2 * E + 2) * 4)
    # the f32 product, then softmax ~5 ops/element and K sweeps ~6 each
    bound_ms, by = bound(n_bytes, 2 * T * D * E + T * E * (5 + 6 * K),
                         F32_FLOPS)
    print(f"[kernel] route_select {name} (D={D} E={E} K={K}): near-tie rows "
          f"{int(near.sum())}, rows that differ {differ} (all near ties); "
          f"indices, slots, tally exact elsewhere, max_abs_err={err:.3e} "
          f"(tol {ROUTER_W_TOL}), two calls bit-identical; kernel "
          f"{res['ms']:.4f} ms ({res['device_ms']:.4f} ms with the host "
          f"ahead, host {res['host_us']:.1f} us a call); unfused sequence "
          f"{unfused['ms']:.4f} ms ({unfused['device_ms']:.4f}, host "
          f"{unfused['host_us']:.1f} us); Triton router alone "
          f"{triton['ms']:.4f} ms ({triton['device_ms']:.4f}); plain "
          f"{plain_ms:.4f} ms; bound {bound_ms:.6f} ms ({by}, "
          f"{n_bytes / 1e3:.1f} KB)", flush=True)
    return {"max_abs_err": err, **res, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "unfused_ms": unfused["ms"],
            "unfused_device_ms": unfused["device_ms"],
            "unfused_host_us": unfused["host_us"],
            "triton_ms": triton["ms"], "triton_device_ms": triton["device_ms"],
            "near_tie_rows": int(near.sum()), "rows_that_differ": differ}


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


def capacity_layer_case(cfg, cgen, dev, tokens=512, lanes=8):
    """One full-width MoE layer through the capacity bodies on a one-rank
    group, ffn=kernel vs ffn=plain: the a2a body at a ``tokens`` prompt,
    the replicated body at ``lanes`` decode rows; then the layer at
    capacity factor 8, where nothing drops, against the ragged layer."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.models import moe as tmoe
    from repro_torch.models.sharding import ShardingRules
    E, K = cfg.n_experts, cfg.top_k
    p = tmoe.moe_init(cgen, d=cfg.d_model, f=cfg.moe_d_ff, n_experts=E,
                      n_slots=E, device=dev)
    tables = (torch.arange(E, dtype=torch.int32, device=dev)[:, None],
              torch.ones(E, dtype=torch.int32, device=dev),
              torch.ones((E, 1), device=dev))
    seed = torch.tensor(7, dtype=torch.int32, device=dev)
    cf = ShardingRules().capacity_factor
    for body, t, cap in (
            ("a2a", tokens, tmoe._round_up(
                max(math.ceil(tokens * K / E * cf), 1), 4)),
            ("replicated", lanes, tmoe._round_up(
                max(math.ceil(lanes * K / E * max(cf, 2.0)), 4), 4))):
        x = torch.randn((1, t, cfg.d_model), generator=cgen,
                        device=dev).to(torch.bfloat16)
        args = (x, p["router"], p["w1"], p["w3"], p["w2"], *tables, seed)
        out = {}
        for name, ffn in (("kernel", ops.fused_moe_ffn),
                          ("plain", ref.moe_ffn_ref)):
            if body == "a2a":
                out[name] = tmoe._a2a_body(*args, top_k=K, n_experts=E,
                                           n_slots=E, capacity=cap, ep=1,
                                           ffn=ffn)
            else:
                out[name] = tmoe._replicated_body(*args, top_k=K,
                                                  n_experts=E, capacity=cap,
                                                  ffn=ffn)
        torch.cuda.synchronize()
        (y_k, t_k, _), (y_p, t_p, _) = out["kernel"], out["plain"]
        check(bool(torch.equal(t_k, t_p)),
              f"capacity {body}: tallies (drop column included) differ")
        check(float(t_k[:E].sum()) == t * K, f"capacity {body}: tally total")
        err = (y_k.float() - y_p.float()).abs().max().item()
        check(bool(torch.isfinite(y_k).all()) and err <= BF16_TOL,
              f"capacity {body}: max |kernel - plain| {err} > {BF16_TOL}")
        print(f"[layer] granite MoE layer, capacity {body} body, {t} tokens,"
              f" capacity {cap}: ffn=kernel vs ffn=plain tallies equal, "
              f"dropped {float(t_k[E]):.0f} of {t * K}, max_abs_err="
              f"{err:.3e} (tol {BF16_TOL})")
    x = torch.randn((1, tokens, cfg.d_model), generator=cgen,
                    device=dev).to(torch.bfloat16)
    kw = dict(top_k=K, n_experts=E, route_seed=7, phase="prefill")
    y_c, t_c, _ = tmoe.moe_layer(
        p, x, rules=ShardingRules(moe_impl="capacity", ep_ranks=1,
                                  capacity_factor=8.0), **kw)
    y_r, t_r, _ = tmoe.moe_layer(p, x, rules=ShardingRules(), **kw)
    torch.cuda.synchronize()
    err = (y_c.float() - y_r.float()).abs().max().item()
    check(bool(torch.equal(t_c, t_r)) and float(t_c[E]) == 0,
          "capacity (factor 8) vs ragged layer: tallies differ or drops")
    check(err <= BF16_TOL, f"capacity (factor 8) vs ragged layer: max "
          f"|difference| {err} > {BF16_TOL}")
    print(f"[layer] granite MoE layer, {tokens} tokens, capacity factor 8 "
          f"vs ragged: tallies equal, 0 dropped, max_abs_err={err:.3e} "
          f"(tol {BF16_TOL})")


def serve_path(cfg, dev, label, *, n_requests=8, output_cap=None,
               policy="vibe", drill=None, **build_kw):
    """Serve the published config through the port's engine on one path.
    The launch counts are set to 0 just before the requests are served and
    read just after. ``drill(engine, requests)``, when given, serves them
    (a drill of ``repro_torch.serving``) in place of the engine's step
    loop and returns its report. Returns (engine, counts, report)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, make_requests
    from repro_torch.serving import summarize
    max_seq = 1024
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine = build_engine(cfg, policy=policy, regime="mi325x", max_batch=8,
                          max_seq=max_seq, seed=0, device=dev, **build_kw)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(engine.params))
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_experts} experts top-{cfg.top_k}, "
          f"{engine.n_slots} slots, {n_params / 1e9:.3f} B params in bf16, "
          f"{policy}, {build_kw or 'ragged'}, built in "
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
    if engine._prefill_chunk is not None:
        engine._prefill_chunk = watch(engine._prefill_chunk)
    reqs = make_requests("sharegpt", n_requests, qps=50.0, max_seq=max_seq,
                         seed=0)
    if output_cap is not None:
        reqs = [dataclasses.replace(r, output_len=min(r.output_len,
                                                      output_cap))
                for r in reqs]
    st = engine.stats
    t_prefill, t_decode = [], []
    report = None
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if drill is not None:
        report = drill(engine, reqs)
        torch.cuda.synchronize()
    else:
        engine.submit(reqs)
        while True:
            d0 = st.decode_steps
            ts = time.perf_counter()
            if not engine.step():
                break
            torch.cuda.synchronize()
            (t_decode if st.decode_steps > d0 else t_prefill).append(
                time.perf_counter() - ts)
    wall = time.perf_counter() - t0
    counts = attn_routed(ops.launch_counts(), label)
    records = list(engine.records.values())
    calls = (st.chunk_steps or st.prefill_steps) + st.decode_steps
    check(all(np.isfinite(r.finished_at) for r in records) and
          len(records) == n_requests, f"{label}: not every request finished")
    check(all(bool(f) for f in finite) and len(finite) == calls,
          f"{label}: non-finite logits")
    ffn = ("fused_moe_ffn" if build_kw.get("moe_impl") == "capacity"
           else "ragged_moe_ffn")
    no_grad_weights(engine.params, label)
    # every FFN launch of the path on the TMA route: <ffn>.tma == <ffn>;
    # one attention launch a layer and model call
    attn = attn_want(cfg, st.chunk_steps or st.prefill_steps,
                     st.decode_steps)
    for name, n in counts.items():
        want = (cfg.n_layers * calls
                if name in (ffn, f"{ffn}.tma", "route_select")
                else attn.get(name, 0))
        check(n == want, f"{label}: {name} launched {n} times, expected "
              f"{want} ({cfg.n_layers} x {calls} model calls)")
    s = summarize(records)
    kind = (f"{st.chunk_steps} chunk" if st.chunk_steps
            else f"{st.prefill_steps} prefill")
    medians = ("" if drill is not None else
               f", median prefill step "
               f"{statistics.median(t_prefill) * 1e3:.2f} ms, median decode "
               f"step {statistics.median(t_decode) * 1e3:.2f} ms")
    print(f"[{label}] {st.steps} steps ({kind} / {st.decode_steps} decode), "
          f"{st.prefill_tokens} prefill + {st.decode_tokens} decode tokens, "
          f"wall {wall:.2f} s{medians}, dropped assignments "
          f"{st.dropped_assignments:.0f}")
    print(f"[{label}] virtual clock: TTFT p50/p90 = {s['ttft_p50']:.4f}/"
          f"{s['ttft_p90']:.4f} s, TPOT p50 = {s['tpot_p50']:.5f} s; "
          f"recalibrations {st.migrations} (migrated slots "
          f"{st.migrated_slots})")
    print(f"[{label}] launches: {json.dumps(counts)}, {ffn} (all on the "
          f"TMA route) and route_select = {cfg.n_layers} x {calls} model "
          f"calls, flash_attn_fwd and flash_decode {cfg.n_layers} x the "
          f"prefill (chunk) and the decode calls, router_topk 0; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return engine, counts, report


def chunk_vs_whole(engine, prompt_len=512):
    """Largest |logit difference| between a chunked and a whole prefill of
    one seeded prompt on the served engine's weights and tables."""
    import numpy as np
    import torch
    from repro_torch.models import init_cache, prefill_fn
    C = engine._chunk
    prompt = torch.as_tensor(np.random.default_rng(3).integers(
        0, engine.cfg.vocab, size=(1, prompt_len)), dtype=torch.int32,
        device=engine.device)
    lg_w, _, _ = prefill_fn(engine.cfg, engine.rules)(
        engine.params, {"tokens": prompt}, engine.moe_tables)
    cache = init_cache(engine.cfg, 1, prompt_len,
                       dtype=engine.params["embed"].dtype,
                       device=engine.device)
    for off in range(0, prompt_len, C):
        lg_c, cache, _ = engine._prefill_chunk(
            engine.params, prompt[:, off:off + C], cache, 0, off, C,
            engine.moe_tables)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(lg_c).all()), "chunked prefill: logits")
    diff = (lg_c - lg_w).abs().max().item()
    same = bool(torch.equal(lg_c.argmax(-1), lg_w.argmax(-1)))
    print(f"[chunk] {prompt_len}-token prompt in {C}-token chunks vs whole: "
          f"max |logit difference| {diff:.4e} (logits span "
          f"{(lg_w.max() - lg_w.min()).item():.3f}), greedy token "
          f"{'equal' if same else 'differs'}")


class timed_faults:
    """Within the block, each ``fail_rank`` and ``recover_rank`` of the
    drills runs with the card synchronised before and after: ``calls``
    holds (name, rank, wall s, bytes allocated before, peak bytes during,
    expert bytes the rank sent: 0 on one device).
    The peak counter is reset at each call, so a later read of
    ``max_memory_allocated`` covers the time since the last fault."""

    def __enter__(self):
        from repro_torch.serving import elastic
        self.saved = (elastic.fail_rank, elastic.recover_rank)
        self.calls = []
        elastic.fail_rank, elastic.recover_rank = (
            self._timed(fn) for fn in self.saved)
        return self

    def _timed(self, fn):
        import torch

        def call(engine, rank):
            cuda = engine.device.type == "cuda"
            _sync()
            before = torch.cuda.memory_allocated() if cuda else 0
            if cuda:
                torch.cuda.reset_peak_memory_stats()
            sent = engine.stats.migration_rank_bytes
            t0 = time.perf_counter()
            report = fn(engine, rank)
            _sync()
            self.calls.append((fn.__name__, rank, time.perf_counter() - t0,
                               before, torch.cuda.max_memory_allocated()
                               if cuda else 0,
                               engine.stats.migration_rank_bytes - sent))
            return report
        return call

    def __exit__(self, *exc):
        from repro_torch.serving import elastic
        elastic.fail_rank, elastic.recover_rank = self.saved


def _fault_lines(calls):
    return "; ".join(f"{name}({rank}) {secs * 1e3:.1f} ms, memory "
                     f"{before / 2**30:.2f} GiB before, peak "
                     f"{peak / 2**30:.2f} GiB" for name, rank, secs, before,
                     peak, _ in calls)


def drill_phase(cfg, dev):
    """The serve driver's drills at full width on the card: a healthy run,
    the elasticity drill (rank 3 dies after 5 steps) and the chaos drill
    (the default schedule, seed 0) on the same 8 requests, outputs capped
    at 64 tokens, each on an engine of its own, under ``vibe_h`` on a 2 x
    4 topology at the policy's default slot budget (``vibe`` places one
    expert a slot and cannot spread 40 experts over 7 survivors)."""
    import dataclasses
    import torch
    from repro_torch.serving import (FaultSchedule, run_chaos,
                                     run_with_failure, summarize)
    kw = dict(n_requests=8, output_cap=64, policy="vibe_h", topology="2x4",
              slots_per_rank="default")
    t0 = time.perf_counter()
    engine, _, _ = serve_path(cfg, dev, "drill healthy", **kw)
    healthy = summarize(list(engine.records.values()))
    del engine
    torch.cuda.empty_cache()
    with timed_faults() as faults:
        engine, _, (records, rep) = serve_path(
            cfg, dev, "drill fail", **kw,
            drill=lambda e, r: run_with_failure(e, r, rank=3, at_step=5))
    check(rep is not None and rep.rank == 3 and len(faults.calls) == 1,
          f"failure drill: report {rep}, faults {faults.calls}")
    fail_call = faults.calls[0]
    check(engine.kv.used_blocks == 0 and engine.kv.n_seqs == 0,
          f"failure drill: {engine.kv.used_blocks} KV blocks leaked")
    s = summarize(records)
    expert_bytes = (engine.n_slots * engine.n_moe * 3 * cfg.d_model
                    * cfg.moe_d_ff * 2)
    print(f"[drill] FailureReport {json.dumps(dataclasses.asdict(rep))}; "
          f"requeues {sum(r.requeues for r in records)}; "
          f"{_fault_lines(faults.calls)} ({engine.n_slots} slots x "
          f"{engine.n_moe} layers = {expert_bytes / 1e9:.2f} GB of expert "
          f"weights on the card); virtual clock TTFT p50/p90 "
          f"{s['ttft_p50']:.4f}/{s['ttft_p90']:.4f} s against "
          f"{healthy['ttft_p50']:.4f}/{healthy['ttft_p90']:.4f} s healthy",
          flush=True)
    del engine, records
    torch.cuda.empty_cache()
    schedule = FaultSchedule.default(8, seed=0)
    with timed_faults() as faults:
        engine, _, chaos = serve_path(
            cfg, dev, "drill chaos", **kw,
            drill=lambda e, r: run_chaos(e, r, schedule))
    check(chaos.ok and chaos.violations == [],
          f"chaos drill: violations {chaos.violations}")
    print(f"[drill] {chaos.summary()}: applied "
          f"{[f'{sp.kind}@{sp.at_step}' for sp, _ in chaos.applied]}, "
          f"skipped {[(f'{sp.kind}@{sp.at_step}', why) for sp, why in chaos.skipped]}"
          f", {chaos.steps} steps; {_fault_lines(faults.calls)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    print(f"[drill] phase wall {time.perf_counter() - t0:.1f} s", flush=True)
    return {"failure": dataclasses.asdict(rep), "fail_rank": fail_call,
            "chaos_faults": faults.calls, "chaos_steps": chaos.steps}


def xlstm_serve(cfg, dev, prompt_len=256, lanes=8, steps=64):
    """xlstm-350m through the model functions on the card: one prefill of
    ``lanes`` prompts of ``prompt_len`` tokens, then ``steps`` greedy
    decode steps of all lanes; then the recurrence on one 64-token prompt,
    its chunkwise prefill against the same prompt stepped token by token
    (the first token prefilled, so both start from the empty state),
    logits and every state leaf: held within ``STATE_TOL`` with the
    weights in f32, and read, not held, in bf16, where the two forms'
    rounding drifts apart with depth (the reference's forms alike)."""
    import numpy as np
    import torch
    from repro_torch.models import decode_fn, init_params, prefill_fn
    from repro_torch.tree import leaves
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    prompts = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab, size=(lanes, prompt_len)), dtype=torch.int32,
        device=dev)
    prefill, decode = prefill_fn(cfg), decode_fn(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    logits, cache, _ = prefill(params, {"tokens": prompts})
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    finite = [torch.isfinite(logits).all()]
    times = []
    for i in range(steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        pos = torch.full((lanes,), prompt_len + i, dtype=torch.int32,
                         device=dev)
        t0 = time.perf_counter()
        logits, cache, _ = decode(params, tok, cache, pos)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        finite.append(torch.isfinite(logits).all())
    check(all(bool(f) for f in finite), "xlstm serving: non-finite logits")
    state_mb = sum(t.numel() * t.element_size() for t in leaves(cache)) / 1e6
    print(f"[xlstm] {lanes} prompts of {prompt_len} tokens through "
          f"prefill_fn: {t_prefill * 1e3:.1f} ms; {steps} greedy decode "
          f"steps of {lanes} lanes: median {statistics.median(times) * 1e3:.2f}"
          f" ms a step, {lanes / statistics.median(times):.0f} tokens/s; "
          f"recurrent state {state_mb:.1f} MB; logits finite; "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    p64 = prompts[:1, :64]

    def recurrence(params):
        lg_c, c_c, _ = prefill(params, {"tokens": p64})
        lg_s, c_s, _ = prefill(params, {"tokens": p64[:, :1]})
        for t in range(1, 64):
            lg_s, c_s, _ = decode(params, p64[:, t:t + 1], c_s,
                                  torch.tensor([t], device=dev))
        torch.cuda.synchronize()
        return [_rel_l2(lg_s, lg_c)] + [_rel_l2(a, b) for a, b in
                                        zip(leaves(c_s), leaves(c_c))]

    bf16 = recurrence(params)
    del params, cache
    gen.manual_seed(0)
    f32 = recurrence(init_params(cfg, gen, device=dev, dtype=torch.float32))
    check(max(f32) <= STATE_TOL, f"xlstm recurrence (f32): chunkwise "
          f"prefill vs token by token, relative L2 "
          f"{['%.2e' % e for e in f32]} > {STATE_TOL}")
    print(f"[xlstm] a 64-token prompt, chunkwise prefill vs token by token, "
          f"relative L2: f32 weights logits {f32[0]:.3e}, state leaves max "
          f"{max(f32[1:]):.3e} (tol {STATE_TOL}); bf16 weights logits "
          f"{bf16[0]:.3e}, state leaves max {max(bf16[1:]):.3e} (read, not "
          f"held)", flush=True)
    return {"prefill_ms": t_prefill * 1e3,
            "decode_ms": statistics.median(times) * 1e3,
            "recurrence_rel_l2_f32": max(f32),
            "recurrence_rel_l2_bf16": max(bf16)}


def xlstm_phase(dev):
    """xlstm-350m at full width (24 layers: 21 mLSTM, 3 sLSTM): the
    training driver, a step's profile with the mixers timed, and serving
    through the model functions."""
    import torch
    from repro_torch.configs import get as get_config
    cfg = get_config("xlstm-350m")
    t0 = time.perf_counter()
    res = train_phase(cfg, dev)
    check(not any(res["launches"].values()),
          f"xlstm: kernels launched {res['launches']}")
    walls = [time.perf_counter() - t0]
    res["profile"] = train_step_profile(cfg, dev, steps=1)
    walls.append(time.perf_counter() - t0 - sum(walls))
    res["serve"] = xlstm_serve(cfg, dev)
    walls.append(time.perf_counter() - t0 - sum(walls))
    torch.cuda.empty_cache()
    print(f"[xlstm] phase wall {sum(walls):.1f} s (training "
          f"{walls[0]:.1f}, profile {walls[1]:.1f}, serving {walls[2]:.1f})",
          flush=True)
    return res


class watch_model_calls:
    """Within the block, the serving engine's prefill and decode functions
    (the names ``repro_torch.serving.engine`` binds) note whether each
    call's logits are finite, and keep the first prefill's inputs (the
    containers of the params tree copied, so that a later migration does
    not change them) and logits."""

    def __enter__(self):
        from repro_torch.serving import engine as engine_mod
        self.saved = (engine_mod.prefill_fn, engine_mod.decode_fn)
        self.finite = []
        self.first = None
        engine_mod.prefill_fn = self._wrap(self.saved[0], keep=True)
        engine_mod.decode_fn = self._wrap(self.saved[1], keep=False)
        return self

    def _wrap(self, make, keep):
        import torch
        from repro_torch.tree import tree_map

        def factory(cfg, rules=None):
            fn = make(cfg, rules)

            def call(params, *args):
                out = fn(params, *args)
                self.finite.append(bool(torch.isfinite(out[0]).all()))
                if keep and self.first is None:
                    self.first = (cfg, rules, tree_map(lambda t: t, params),
                                  args, out[0].clone())
                return out
            return call
        return factory

    def __exit__(self, *exc):
        from repro_torch.serving import engine as engine_mod
        engine_mod.prefill_fn, engine_mod.decode_fn = self.saved


def jamba_phase(dev):
    """jamba-1.5-large at its smoke size through the serve driver on the
    card (the full config's smallest legal depth, one 8-layer block, holds
    77.3 GB of experts): Mamba beside the hand-written MoE kernels at E 4,
    K 2, D 128, F 256. Every request finishes, every logit is finite, the
    routing stage and the ragged FFN launch once a MoE layer and model
    call, and the first prefill's logits match the same call through the
    kernels' plain versions."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels import ragged_moe_ffn as t_ragged
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import block_layout
    from repro_torch.serving import summarize
    arch = "jamba-1.5-large-398b"
    t0 = time.perf_counter()
    with watch_model_calls() as watch:
        ops.reset_launch_counts()
        engine, records, _ = serve(arch, n_requests=8, device=dev)
        torch.cuda.synchronize()
        counts = attn_routed(ops.launch_counts(), "jamba")
    wall = time.perf_counter() - t0
    cfg, st = engine.cfg, engine.stats
    nb, specs = block_layout(cfg)
    n_moe = nb * sum(s.ffn == "moe" for s in specs)
    calls = st.prefill_steps + st.decode_steps
    check(len(records) == 8 and all(np.isfinite(r.finished_at)
                                    for r in records),
          "jamba: not every request finished")
    check(all(watch.finite) and len(watch.finite) == calls,
          "jamba: non-finite logits")
    no_grad_weights(engine.params, "jamba")
    attn = attn_want(cfg, st.prefill_steps, st.decode_steps)
    for name, n in counts.items():
        want = (n_moe * calls if name in ("route_select", "ragged_moe_ffn",
                                          "ragged_moe_ffn.tma")
                else attn.get(name, 0))
        check(n == want, f"jamba: {name} launched {n} times, expected "
              f"{want} ({n_moe} MoE layers x {calls} model calls, "
              f"{attn_layers(cfg)} attention layers)")
    s = summarize(records)
    print(f"[jamba] {cfg.name}: {cfg.n_layers} layers ("
          f"{''.join(sp.mixer[0] for sp in specs)}), d_model {cfg.d_model}, "
          f"{cfg.n_experts} experts top-{cfg.top_k}, moe_d_ff "
          f"{cfg.moe_d_ff}; {st.steps} steps ({st.prefill_steps} prefill / "
          f"{st.decode_steps} decode), wall {wall:.2f} s; virtual clock TTFT "
          f"p50/p90 {s['ttft_p50']:.4f}/{s['ttft_p90']:.4f} s; launches "
          f"{json.dumps(counts)}: route_select and ragged_moe_ffn "
          f"{n_moe} x {calls} model calls, all on the TMA route (last "
          f"{t_ragged.ragged_moe_ffn.last_route})", flush=True)
    cfg0, rules0, params0, args0, logits_k = watch.first
    # the MoE kernels against their plain versions on the logits, the
    # attention kernel call by call: its rounding (f32 accumulation where
    # the plain version rounds each chunk's PV to bf16) moves a near-tie
    # routing choice of this smoke model (4 tally entries, 0.107 in the
    # logits, read on an H100), which a logit bound does not separate
    with torch.no_grad():
        with plain_kernels(attention=False):
            logits_p = watch.saved[0](cfg0, rules0)(params0, *args0)[0]
        with hold_attention() as held:
            watch.saved[0](cfg0, rules0)(params0, *args0)
    torch.cuda.synchronize()
    err = (logits_k - logits_p).abs().max().item()
    check(err <= BF16_TOL, f"jamba: first prefill, MoE kernels vs plain "
          f"versions, max |logit difference| {err} > {BF16_TOL}")
    check(held.calls == attn_layers(cfg0) and held.err <= ATTN_REL,
          f"jamba: first prefill's attention calls ({held.calls}) against "
          f"the plain version, row relative L2 {held.err} > {ATTN_REL}")
    print(f"[jamba] first prefill ({args0[0]['tokens'].shape[1]} tokens), "
          f"MoE kernels vs plain versions: max |logit difference| "
          f"{err:.3e}; the attention kernel's {held.calls} call(s) vs the "
          f"plain version: row relative L2 {held.err:.3e} (tol "
          f"{ATTN_REL}); phase wall {time.perf_counter() - t0:.1f} s",
          flush=True)
    cli = serve_cli_default(dev)
    return {"launches": counts, "first_prefill_max_abs_err": err,
            "first_prefill_attention_row_rel": held.err, "serve_cli": cli}


def serve_cli_default(dev, arch: str = "qwen3-moe-235b-a22b") -> dict:
    """The serve CLI as it runs by default (``python -m
    repro_torch.launch.serve``: its default arch's smoke config, 12
    requests, ``--max-batch 4 --max-seq 96``) on the card: every request
    finishes, the routing stage and the ragged FFN launch once a MoE layer
    and model call on the TMA route, the attention kernels once an
    attention layer and call, every prefill launch on a named route."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import serve
    from repro_torch.models.model import block_layout
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    engine, records, _ = serve(arch, device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    raw = ops.launch_counts()
    counts = attn_routed(raw, "serve CLI")
    cfg, st = engine.cfg, engine.stats
    nb, specs = block_layout(cfg)
    n_moe = nb * sum(sp.ffn == "moe" for sp in specs)
    calls = st.prefill_steps + st.decode_steps
    check(len(records) == 12 and all(np.isfinite(r.finished_at)
                                     for r in records),
          "serve CLI: not every request finished")
    attn = attn_want(cfg, st.prefill_steps, st.decode_steps)
    for name, n in counts.items():
        want = (n_moe * calls if name in ("route_select", "ragged_moe_ffn",
                                          "ragged_moe_ffn.tma")
                else attn.get(name, 0))
        check(n == want, f"serve CLI: {name} launched {n} times, expected "
              f"{want} ({n_moe} MoE layers x {calls} model calls)")
    check(counts["flash_attn_fwd"] > 0, "serve CLI: no prefill attention")
    print(f"[serve-cli] {cfg.name} smoke (hd {cfg.hd}): {len(records)} "
          f"requests finished in {st.steps} steps ({st.prefill_steps} "
          f"prefill / {st.decode_steps} decode), wall {wall:.2f} s; "
          f"flash_attn_fwd {raw['flash_attn_fwd']} launches, "
          f"{raw['flash_attn_fwd.tma']} on the tma route, "
          f"{raw['flash_attn_fwd.tf32x3']} on the tf32x3 route; launches "
          f"{json.dumps(counts)}", flush=True)
    del engine
    torch.cuda.empty_cache()
    return {"launches": raw, "wall_s": wall, "steps": st.steps}


def trace_decode(engine, n_steps: int = 4) -> None:
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
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
    ours = ("ffn_tma_kernel", "gate_up_kernel", "down_kernel",
            "route_select_kernel", "router_topk", "decode_attn", "attn_fwd")
    top += [e for e in dev_events
            if e not in top and any(k in e.key for k in ours)]
    launched_by = _launchers(prof)
    for e in top:
        by = launched_by.get(e.key)
        if by:
            (first, t), = by.most_common(1)
            share = 100 * t / sum(by.values())
            who = f" <- {first} ({share:.0f}% of its time)"
        else:
            who = " <- a kernel of this repo (no PyTorch operation)"
        print(f"[trace]   {e.self_device_time_total / 1e3 / n_steps:8.3f} "
              f"ms/step  {e.count / n_steps:6.1f} x/step  {e.key[:90]}{who}")
    # the FFN kernels: device time a launch, by name (ffn_tma_kernel<op,
    # rows, swap, capacity>: op 0 is gate/up, 1 is down)
    ffn_ms = 0.0
    for e in dev_events:
        if any(k in e.key for k in ours[:3]):
            ffn_ms += e.self_device_time_total / 1e3
            print(f"[trace]   FFN {e.key[:70]}: "
                  f"{e.self_device_time_total / e.count:.1f} us a launch, "
                  f"{e.count / n_steps:.1f} launches a step")
    print(f"[trace]   FFN kernels: {ffn_ms / n_steps:.3f} ms/step of "
          f"{busy_ms / n_steps:.2f} ms/step device busy")
    for e in dev_events:
        if any(k in e.key for k in ours[5:]):
            print(f"[trace]   attention {e.key[:60]}: "
                  f"{e.self_device_time_total / e.count:.1f} us a launch, "
                  f"{e.count / n_steps:.1f} launches a step, "
                  f"{e.self_device_time_total / 1e3 / n_steps:.3f} ms/step")
        if "route_select_kernel" in e.key:
            print(f"[trace]   routing {e.key[:60]}: "
                  f"{e.self_device_time_total / e.count:.1f} us a launch, "
                  f"{e.count / n_steps:.1f} launches a step, "
                  f"{e.self_device_time_total / 1e3 / n_steps:.3f} ms/step")


def _launchers(prof):
    """Device kernel name -> device time (us) by what launched it: the
    outermost PyTorch operation with its input shapes, then the operation
    that issued the launch (the trace records shapes)."""
    from torch.autograd import DeviceType
    out = collections.defaultdict(collections.Counter)
    for ev in prof.events():
        if ev.device_type != DeviceType.CPU or not ev.kernels:
            continue
        outer = ev
        while (outer.cpu_parent is not None
               and outer.cpu_parent.name.startswith("aten::")):
            outer = outer.cpu_parent
        who = f"{outer.name}{list(outer.input_shapes)}"
        if outer is not ev:
            who += f" via {ev.name}"
        for k in ev.kernels:
            out[k.name][who[:160]] += k.duration
    return out


def _rel_l2(a, b) -> float:
    a, b = a.float(), b.float()
    return ((a - b).norm() / b.norm().clamp(min=1e-30)).item()


def backward_ffn_case(cfg, gen, cgen, dev, tokens=1024, controls=True):
    """The ragged FFN's backward kernels K1 (dgrad) and K2 (wgrad) at a
    training shape (``tokens`` x top-8) against ``ragged_moe_ffn_bwd_ref``,
    on the forward kernel's plan and saved ``h``: the TMA route checked
    (and, with ``controls``, two faulty backwards read against the same
    bound), then both routes timed on the same inputs, and the TMA route's
    other row block (K1) and output tiles (K2) by ``device_ms``."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import ragged_moe_ffn as t_ragged
    from repro_torch.models.moe import _ragged_plan
    from repro_torch.models.sharding import ShardingRules
    E, D, F, K = cfg.n_experts, cfg.d_model, cfg.moe_d_ff, cfg.top_k
    bm = ShardingRules().moe_block_m
    A = tokens * K
    empty = (5, 17, 33)
    slot_flat = zipf_slots(gen, A, E, empty=empty).to(dev)
    order, rows, tg, n_rows, ro, sz = _ragged_plan(slot_flat, E, bm)
    x = torch.randn((tokens, D), generator=cgen,
                    device=dev).to(torch.bfloat16)
    buf = x.new_zeros((n_rows + 1, D))
    buf[rows.long()] = x[torch.div(order, K, rounding_mode="floor")]
    buf = buf[:n_rows]
    w = [(torch.randn(s, generator=cgen, device=dev) / math.sqrt(s[1])).to(
        torch.bfloat16) for s in ((E, D, F), (E, D, F), (E, F, D))]
    real = torch.zeros(n_rows, dtype=torch.bool, device=dev)
    real[rows[rows < n_rows].long()] = True
    dy = (torch.randn((n_rows, D), generator=cgen, device=dev)
          * real[:, None]).to(torch.bfloat16)
    _, h = t_ragged.ragged_moe_ffn(w[0], w[1], w[2], buf, tg, row_offsets=ro,
                                   sizes=sz, max_rows=tokens, keep_h=True)

    def k1(route=None):
        return t_ragged.ragged_moe_ffn_dgrad(w[0], w[1], w[2], buf, tg, ro,
                                             sz, dy, route=route)

    dx, da, db = k1()
    k1_route = t_ragged.ragged_moe_ffn_dgrad.last_route

    def k2(route=None):
        return t_ragged.ragged_moe_ffn_wgrad(buf, h, da, db, dy, ro, sz,
                                             route=route)

    dws = k2()
    k2_route = t_ragged.ragged_moe_ffn_wgrad.last_route
    check(k1_route.startswith("tma") and k2_route.startswith("tma"),
          f"ragged FFN backward: took the routes {k1_route}, {k2_route}")
    dx2, da2, db2 = k1()
    again = (dx2, da2[real], db2[real], *k2())
    want = ref.ragged_moe_ffn_bwd_ref(w[0], w[1], w[2], buf, tg, dy)
    torch.cuda.synchronize()
    # da and db are written on the real rows only (all K2 reads)
    check(all(bool(torch.equal(a, b)) for a, b in zip(
        (dx, da[real], db[real], *dws), again)),
          "ragged FFN backward: two calls differ")
    got = (dx, *dws)
    names = ("dx", "dw1", "dw3", "dw2")
    errs = {n: _rel_l2(g, r) for n, g, r in zip(names, got, want)}
    abs_err = {n: (g.float() - r.float()).abs().max().item()
               for n, g, r in zip(names, got, want)}
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          "ragged FFN backward: non-finite gradients")
    check(max(errs.values()) <= BWD_TOL, f"ragged FFN backward: relative "
          f"L2 errors {errs} > {BWD_TOL}")
    ctl = backward_controls(w, buf, tg, dy, h, da, db, ro, sz, real,
                            want) if controls else {}
    for name, c in ctl.items():
        check(max(c.values()) > BWD_TOL, f"ragged FFN backward: the "
              f"control '{name}' reads {c}, within the bound {BWD_TOL}")
    check(not bool(dx[~real].any()), "ragged FFN backward: padding or "
          "sentinel rows of dx not zero")
    check(all(not bool(g[e].any()) for g in dws for e in empty),
          "ragged FFN backward: an empty expert's dW not zero")
    # the general route on the same inputs (K2 on the TMA route's da, db,
    # as K2's timing below): held to the same bound
    gen_errs = {n: _rel_l2(g, r) for n, g, r in zip(
        names, (k1("general")[0], *k2("general")), want)}
    check(max(gen_errs.values()) <= BWD_TOL, f"ragged FFN backward, "
          f"general route: relative L2 errors {gen_errs} > {BWD_TOL}")
    times = {"K1": {"tma": timings(k1), "general": timings(
        lambda: k1("general"))},
             "K2": {"tma": timings(k2), "general": timings(
                 lambda: k2("general"))}}
    plain_ms = median_ms(lambda: ref.ragged_moe_ffn_bwd_ref(
        w[0], w[1], w[2], buf, tg, dy), reps=3)
    n_exp = E - len(empty)
    # K1: x and dy on the real rows, the occupied experts' three weights,
    # da and db on the real rows, dx on every row; five products
    k1_bytes = A * D * 2 * 2 + n_exp * 3 * D * F * 2 + A * F * 2 * 2 \
        + n_rows * D * 2
    k1_bound, k1_by = bound(k1_bytes, 5 * 2 * A * D * F, BF16_FLOPS)
    # K2: x, dy, h, da, db on the real rows, every expert's three dW;
    # three products
    k2_bytes = A * (2 * D + 3 * F) * 2 + E * 3 * D * F * 2
    k2_bound, k2_by = bound(k2_bytes, 3 * 2 * A * D * F, BF16_FLOPS)
    print(f"[kernel] ragged_moe_ffn backward, {tokens} tokens x top-{K} = "
          f"{A} assignments, T={n_rows}, row block {bm}, experts {empty} "
          f"empty, routes {k1_route} / {k2_route}: relative L2 "
          f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())}"
          f" (tol {BWD_TOL}; general route "
          f"{', '.join(f'{k} {v:.2e}' for k, v in gen_errs.items())}); "
          f"max |kernel - plain| "
          f"{', '.join(f'{k} {v:.3e}' for k, v in abs_err.items())}; "
          f"padding rows and empty experts exactly 0, two calls "
          f"bit-identical", flush=True)
    for name, c in ctl.items():
        print(f"[kernel]   control, {name}: relative L2 "
              f"{', '.join(f'{k} {v:.2e}' for k, v in c.items())} "
              f"(above the bound {BWD_TOL}, as it must be)", flush=True)
    out = []
    for kname, label, b, by, nb, route in (
            ("K1", "dgrad", k1_bound, k1_by, k1_bytes, k1_route),
            ("K2", "wgrad", k2_bound, k2_by, k2_bytes, k2_route)):
        t, g = times[kname]["tma"], times[kname]["general"]
        print(f"[kernel]   {label} ({kname}), {route}: {t['ms']:.4f} ms "
              f"({100 * b / t['ms']:.1f}% of bound), {t['device_ms']:.4f} ms"
              f" with the host ahead ({100 * b / t['device_ms']:.1f}%), host "
              f"{t['host_us']:.1f} us a call; general route {g['ms']:.4f} "
              f"ms ({100 * b / g['ms']:.1f}%), {g['device_ms']:.4f} with the "
              f"host ahead, host {g['host_us']:.1f} us; bound {b:.4f} ms "
              f"({by}, {nb / 1e6:.1f} MB, "
              f"{(5 if kname == 'K1' else 3) * 2 * A * D * F / 1e9:.1f} "
              f"GFLOP)", flush=True)
        out.append({"max_abs_err": max(abs_err[n] for n in (
                        ("dx",) if kname == "K1" else ("dw1", "dw3", "dw2"))),
                    **t, "bound_ms": b, "bound_by": by,
                    "bound_share": b / t["ms"],
                    "device_bound_share": b / t["device_ms"],
                    "kernel_route": route, "general": g})
    print(f"[kernel]   plain backward {plain_ms:.4f} ms (K1 and K2 together)",
          flush=True)
    common = {"plain_ms": plain_ms, "relative_l2": errs,
              "general_relative_l2": gen_errs, "controls": ctl,
              "tokens": tokens}
    return out[0] | common, out[1] | common


def backward_controls(w, buf, tg, dy, h, da, db, ro, sz, real, want,
                      chunk=16):
    """Two faulty backwards the bound must catch, read against the plain
    backward ``want`` as K1 and K2 are: "bf16 sums" rounds K1's sum over F
    and K2's sums over each expert's rows to bf16 every ``chunk`` terms
    (from the kernels' own da, db and h); "a row skipped" leaves out the
    last real row of every occupied expert."""
    import torch
    from repro_torch.kernels import ref
    bf = torch.bfloat16
    E, D, F = w[0].shape
    n_rows = buf.shape[0]
    bm = n_rows // tg.shape[0]
    g = torch.clamp(tg.long(), max=E - 1)
    occ = (tg < E)[:, None, None]
    # K1 writes da and db on the real rows only: the rest is not zero
    da_r = torch.where(real[:, None], da, 0).reshape(-1, bm, F)
    db_r = torch.where(real[:, None], db, 0).reshape(-1, bm, F)
    W1, W3 = w[0][g], w[1][g]
    dx = torch.zeros((tg.shape[0], bm, D), dtype=bf, device=buf.device)
    for c in range(0, F, chunk):
        part = torch.bmm(da_r[..., c:c + chunk].float(),
                         W1[..., c:c + chunk].float().transpose(1, 2)) \
            + torch.bmm(db_r[..., c:c + chunk].float(),
                        W3[..., c:c + chunk].float().transpose(1, 2))
        dx = ((dx.float() + part) * occ).to(bf)
    dws = [torch.zeros_like(t) for t in w]
    for e, (r0, n) in enumerate(zip(ro.tolist(), sz.tolist())):
        for r in range(r0, r0 + n, chunk):
            q = slice(r, min(r + chunk, r0 + n))
            x = buf[q].float().t()
            for dw, (left, right) in zip(dws, ((x, da[q]), (x, db[q]),
                                               (h[q].float().t(), dy[q]))):
                dw[e] = (dw[e].float() + left @ right.float()).to(bf)
    names = ("dx", "dw1", "dw3", "dw2")
    acc = dict(zip(names, (_rel_l2(t, r) for t, r in zip(
        (dx.reshape(n_rows, D), *dws), want))))
    last = (ro[:-1] + sz - 1)[sz > 0].long()
    dy_skip = dy.clone()
    dy_skip[last] = 0
    skip = ref.ragged_moe_ffn_bwd_ref(w[0], w[1], w[2], buf, tg, dy_skip)
    return {"bf16 sums": acc,
            "a row skipped": {n: _rel_l2(t, r)
                              for n, t, r in zip(names, skip, want)}}


def capacity_backward_case(name, E, C, D, F, cgen, dev, empty_rows):
    """The capacity FFN's gradient on the card: the bucket K1
    (``moe_ffn_dgrad``) and K2 (``moe_ffn_wgrad``) on the forward kernel's
    saved ``h`` against ``moe_ffn_bwd_ref`` on buckets (E, C, D) whose last
    ``empty_rows`` rows a bucket hold no assignment (x = 0 and dy = 0, as
    the combine leaves them): relative L2 of dx and of each dW within
    ``BWD_TOL``, the empty rows of dx exactly zero, the TMA route, two
    calls bit for bit; then each timed as the forward kernels are, beside
    the plain backward and the bound (every bucket row: K1 five products,
    10 E C D F operations; K2 three, 6 E C D F)."""
    import torch
    from repro_torch.kernels import moe_ffn as t_capacity
    from repro_torch.kernels import ref
    toks = torch.randn((E, C, D), generator=cgen, device=dev)
    toks[:, C - empty_rows:] = 0
    toks = toks.to(torch.bfloat16)
    dy = (torch.randn((E, C, D), generator=cgen, device=dev)
          * (toks != 0).any(-1, keepdim=True)).to(torch.bfloat16)
    w = [(torch.randn(s, generator=cgen, device=dev) / math.sqrt(s[1])).to(
        torch.bfloat16) for s in ((E, D, F), (E, D, F), (E, F, D))]
    _, h = t_capacity.fused_moe_ffn(*w, toks, keep_h=True)

    def k1():
        return t_capacity.moe_ffn_dgrad(*w, toks, dy)

    def k2():
        return t_capacity.moe_ffn_wgrad(toks, h, da, db, dy)

    dx, da, db = k1()
    k1_route = t_capacity.moe_ffn_dgrad.last_route
    dws = k2()
    k2_route = t_capacity.moe_ffn_wgrad.last_route
    again = (*k1(), *k2())
    want = ref.moe_ffn_bwd_ref(*w, toks, dy)
    torch.cuda.synchronize()
    label = f"capacity FFN backward {name}"
    check(k1_route == f"tma rows={t_capacity.bwd_rows(C)}"
          and k2_route == "tma", f"{label}: routes {k1_route}, {k2_route}")
    check(all(bool(torch.equal(a, b)) for a, b in zip(
        (dx, da, db, *dws), again)), f"{label}: two calls differ")
    got = (dx, *dws)
    names = ("dx", "dw1", "dw3", "dw2")
    errs = {n: _rel_l2(g, r) for n, g, r in zip(names, got, want)}
    abs_err = {n: (g.float() - r.float()).abs().max().item()
               for n, g, r in zip(names, got, want)}
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          f"{label}: non-finite gradients")
    check(max(errs.values()) <= BWD_TOL, f"{label}: relative L2 errors "
          f"{errs} > {BWD_TOL}")
    check(not bool(dx[:, C - empty_rows:].any()), f"{label}: the empty "
          "rows of dx are not zero")
    del again, want
    times = {"K1": timings(k1), "K2": timings(k2)}
    plain_ms = median_ms(lambda: ref.moe_ffn_bwd_ref(*w, toks, dy), reps=3)
    rows = E * C
    k1_bytes = 3 * rows * D * 2 + 2 * rows * F * 2 + 3 * E * D * F * 2
    k2_bytes = 2 * rows * D * 2 + 3 * rows * F * 2 + 3 * E * D * F * 2
    out = []
    for kname, kernel, nb, n_ops, route in (
            ("K1", "moe_ffn_dgrad", k1_bytes, 10 * rows * D * F, k1_route),
            ("K2", "moe_ffn_wgrad", k2_bytes, 6 * rows * D * F, k2_route)):
        t = times[kname]
        b, by = bound(nb, n_ops, BF16_FLOPS)
        print(f"[kernel] {kernel} ({kname}) {name}, buckets ({E}, {C}, {D})"
              f", F {F}, {empty_rows} empty rows a bucket, {route}: "
              f"{t['ms']:.4f} ms ({100 * b / t['ms']:.1f}% of bound), "
              f"{t['device_ms']:.4f} ms with the host ahead "
              f"({100 * b / t['device_ms']:.1f}%), host {t['host_us']:.1f} "
              f"us a call; bound {b:.4f} ms ({by}, {nb / 1e6:.1f} MB, "
              f"{n_ops / 1e9:.1f} GFLOP)", flush=True)
        out.append({"max_abs_err": max(abs_err[n] for n in (
                        ("dx",) if kname == "K1" else ("dw1", "dw3", "dw2"))),
                    **t, "bound_ms": b, "bound_by": by,
                    "bound_share": b / t["ms"],
                    "device_bound_share": b / t["device_ms"],
                    "kernel_route": route})
    print(f"[kernel]   {name}: relative L2 "
          f"{', '.join(f'{k} {v:.2e}' for k, v in errs.items())} (tol "
          f"{BWD_TOL}); max |kernel - plain| "
          f"{', '.join(f'{k} {v:.3e}' for k, v in abs_err.items())}; the "
          f"empty rows of dx exactly 0, two calls bit-identical; plain "
          f"backward {plain_ms:.4f} ms (K1 and K2 together)", flush=True)
    common = {"plain_ms": plain_ms, "relative_l2": errs,
              "shape": {"E": E, "C": C, "D": D, "F": F,
                        "empty_rows": empty_rows}}
    return out[0] | common, out[1] | common


def backward_route_case(cfg, cgen, dev, T=1024):
    """The routing backward K3 at the training shape against
    ``route_select_dlogits_ref`` on the forward kernel's outputs."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels import route_select as t_route
    D, E, K = cfg.d_model, cfg.n_experts, cfg.top_k
    x = torch.randn((T, D), generator=cgen, device=dev).to(torch.bfloat16)
    w = torch.randn((D, E), generator=cgen, device=dev) / math.sqrt(D)
    tables = (torch.arange(E, dtype=torch.int32, device=dev)[:, None],
              torch.ones(E, dtype=torch.int32, device=dev),
              torch.ones((E, 1), device=dev))
    seed = torch.tensor(11, dtype=torch.int32, device=dev)
    wts, idx, _, tally, _, _, probs = t_route.route_select(
        x, w, *tables, seed, K, with_probs=True)
    counts = tally[:E].contiguous()
    dw = torch.randn((T, K), generator=cgen, device=dev)
    dm = torch.randn((E,), generator=cgen, device=dev)
    daux = torch.randn((), generator=cgen, device=dev)
    args = (probs, idx, wts, counts, dw, dm, daux)
    got = t_route.route_select_bwd(*args)
    again = t_route.route_select_bwd(*args)
    want = ref.route_select_dlogits_ref(*args)
    torch.cuda.synchronize()
    check(bool(torch.equal(got, again)), "route_select_bwd: two calls differ")
    # the backward takes idx as an input, so a near tie changes nothing it
    # computes: every row is held; near-tie rows are only counted
    top = torch.topk(probs, K + 1, dim=-1).values
    near = ((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(-1)
    err = (got - want).abs().max().item()
    check(err <= ROUTER_W_TOL, f"route_select_bwd: max |kernel - plain| "
          f"{err} > {ROUTER_W_TOL}")
    res = timings(lambda: t_route.route_select_bwd(*args), reps=50)
    # the launch floor beside it: a spin kernel of one cycle, the nearest
    # to an empty launch, timed by the same harness on the same card
    floor_ms, floor_us = held_times(lambda: torch.cuda._sleep(1), reps=50)
    plain_ms = median_ms(lambda: ref.route_select_dlogits_ref(*args), reps=10)
    n_bytes = T * E * 4 * 2 + T * K * 12 + E * 8 + 4
    # per element: dmean, the mask, dp, two products and a sum, ~8 ops
    bound_ms, by = bound(n_bytes, 8 * T * E, F32_FLOPS)
    print(f"[kernel] route_select_bwd T={T} E={E} K={K}: max_abs_err="
          f"{err:.3e} over all rows (tol {ROUTER_W_TOL}; near-tie rows "
          f"{int(near.sum())}), two calls "
          f"bit-identical; kernel {res['ms']:.4f} ms ({res['device_ms']:.4f} "
          f"ms with the host ahead, host {res['host_us']:.1f} us a call), "
          f"plain {plain_ms:.4f} ms, bound {bound_ms:.6f} ms ({by}, "
          f"{n_bytes / 1e3:.1f} KB); an empty launch (one-cycle spin) "
          f"{floor_ms:.4f} ms with the host ahead, host {floor_us:.1f} us",
          flush=True)
    return {"max_abs_err": err, **res, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": by,
            "launch_floor_ms": floor_ms,
            "near_tie_rows": int(near.sum())}


def param_digest(params):
    """Per leaf, an exact integer digest of its bits on the card: the
    16-bit words times fixed odd weights, summed in int64 (exact in any
    order), slice by slice."""
    import torch
    from repro_torch.tree import leaves
    out = []
    for leaf in leaves(params):
        words = leaf.detach().contiguous().view(-1).view(torch.int16)
        total = torch.zeros((), dtype=torch.int64, device=leaf.device)
        for i in range(0, words.numel(), 1 << 25):
            part = words[i:i + (1 << 25)].to(torch.int64)
            wts = (torch.arange(i, i + part.numel(), device=leaf.device)
                   * 2654435761 % 2147483647) | 1
            total += (part * wts).sum()
        out.append(int(total))
    return out


def train_phase(cfg, dev, steps=4, seq_len=256, batch=4):
    """The training path at full width on the card (phase 12; phase 10's
    xlstm, whose model has no MoE layer and so launches no kernel)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import train
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    times = []
    ops.reset_launch_counts()
    params, opt, losses, tallies = train(
        cfg.name, smoke=False, steps=steps, seq_len=seq_len, batch=batch,
        device=dev, step_times=times, log_every=1)
    torch.cuda.synchronize()
    counts = attn_routed(ops.launch_counts(), "training")
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(t.numel() for t in _leaves(params))
    check(all(math.isfinite(v) for v in losses) and len(losses) == steps,
          f"training: losses {losses}")
    # the attention's forward and backward kernels once a layer
    per_step = attn_want(cfg, prefill=1, backward=1) | ({} if not cfg.is_moe
                                                         else {
        "route_select": cfg.n_layers, "ragged_moe_ffn": cfg.n_layers,
        "ragged_moe_ffn.tma": cfg.n_layers,
        "ragged_moe_ffn_dgrad": cfg.n_layers,
        "ragged_moe_ffn_dgrad.tma": cfg.n_layers,
        "ragged_moe_ffn_wgrad": cfg.n_layers,
        "ragged_moe_ffn_wgrad.tma": cfg.n_layers,
        "route_select_bwd": cfg.n_layers})
    for name, n in counts.items():
        want = per_step.get(name, 0) * steps
        check(n == want, f"training: {name} launched {n} times, expected "
              f"{want} ({per_step.get(name, 0)} a step x {steps})")
    med = statistics.median(times)
    label = "train" if cfg.is_moe else "xlstm"
    spread = ("" if tallies is None else "; tally spread max/min "
              f"{tallies.sum(0).max() / max(tallies.sum(0).min(), 1):.2f}")
    print(f"[{label}] {cfg.name}: {cfg.n_layers} layers, "
          f"{n_params / 1e9:.3f} B "
          f"params (bf16, f32 master and moments), {steps} steps of "
          f"{batch} x {seq_len} tokens: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)} (ln {cfg.vocab} = "
          f"{math.log(cfg.vocab):.4f}); step wall times "
          f"{', '.join(f'{t:.3f}' for t in times)} s, median {med:.3f} s, "
          f"{batch * seq_len / med:.0f} tokens/s; max_memory_allocated "
          f"{peak / 2**30:.2f} GiB{spread}", flush=True)
    print(f"[{label}] launches in {steps} steps: {json.dumps(counts)}: "
          + (f"route_select, ragged_moe_ffn, ragged_moe_ffn_dgrad and "
             f"ragged_moe_ffn_wgrad (all three on the TMA route) and "
             f"route_select_bwd {cfg.n_layers} a step, flash_attn_fwd, "
             f"flash_attn_bwd_dq and flash_attn_bwd_dkdv "
             f"{attn_layers(cfg)} a step, fused_moe_ffn, router_topk and "
             f"flash_decode 0"
             if cfg.is_moe else "none (no MoE or attention layer)"),
          flush=True)
    del params, opt
    torch.cuda.empty_cache()
    runs = []
    for _ in range(2):
        p, o, l2, _ = train(cfg.name, smoke=False, steps=2, seq_len=seq_len,
                            batch=batch, device=dev, log_every=100)
        runs.append((l2, param_digest(p)))
        del p, o
        torch.cuda.empty_cache()
    check(runs[0] == runs[1], "training: two seeded 2-step runs differ "
          f"(losses {runs[0][0]} vs {runs[1][0]})")
    check(runs[0][0] == losses[:2], "training: the 2-step runs' losses "
          f"{runs[0][0]} differ from the 4-step run's {losses[:2]}")
    print(f"[{label}] two 2-step runs from seed 0: losses {runs[0][0]} in "
          f"both (and in the 4-step run), parameter digests equal, bit for "
          f"bit", flush=True)
    return {"losses": losses, "step_s": times, "median_step_s": med,
            "tokens_per_s": batch * seq_len / med, "peak_bytes": peak,
            "launches": counts}


def train_step_profile(cfg, dev, seq_len=256, batch=4, steps=3, rules=None):
    """Where a full-width training step's time goes: ``steps`` steps after
    one warm step, each split on the host clock (synchronised) into the
    forward, the backward and AdamW; then one more step traced with
    ``torch.profiler``: the device's busy share and its largest kernels;
    and, for a model with recurrent mixers, one more step with each
    mixer's forward and backward timed (:class:`timed_mixers`). ``rules``
    go to the loss (``ShardingRules(remat=True)``: per-block remat)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import init_params, loss_fn, make_moe_tables
    from repro_torch.training import (AdamWConfig, DataConfig, adamw_init,
                                      adamw_update, cosine_lr,
                                      synthetic_batch)
    from repro_torch.tree import leaves, tree_map
    label = "train" if cfg.is_moe else "xlstm"
    if rules is not None and rules.remat:
        label += ", remat"
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    for p in leaves(params):
        p.requires_grad_(True)
    ocfg = AdamWConfig()
    opt = adamw_init(params, ocfg)
    mt = make_moe_tables(cfg, device=dev)
    lossf = loss_fn(cfg, rules)
    data = DataConfig(seq_len=seq_len, global_batch=batch)

    def step(s):
        """The driver's step (``launch/train.py``), with phase times."""
        nonlocal params, opt
        b = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cfg, data, s).items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, _ = lossf(params, b, mt)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        grads = tree_map(lambda p: p.grad, params)
        params, opt = adamw_update(grads, opt, params, ocfg,
                                   cosine_lr(ocfg, opt.step))
        for p in leaves(params):
            p.grad = None
        del grads
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        return t1 - t0, t2 - t1, t3 - t2

    step(0)
    phases = [step(s) for s in range(1, 1 + steps)]
    fwd, bwd, adam = (statistics.median(p[i] for p in phases)
                      for i in range(3))
    # the device's activity alone: the host's events are not read here,
    # and collecting them doubles the trace's processing (xlstm: 34 s)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(steps + 1)
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev_events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev_events) / 1e3
    total = fwd + bwd + adam
    peak = torch.cuda.max_memory_allocated()
    shape = f"{batch} x {seq_len}"
    print(f"[{label}] a full-width step of {shape} = {batch * seq_len} tokens "
          f"on the host clock (median of {steps}): forward {fwd * 1e3:.1f} "
          f"ms, backward {bwd * 1e3:.1f} ms, AdamW {adam * 1e3:.1f} ms, "
          f"{total * 1e3:.1f} ms in all, {batch * seq_len / total:.0f} "
          f"tokens/s; max_memory_allocated {peak / 2**30:.2f} GiB",
          flush=True)
    res = {"tokens": batch * seq_len, "forward_s": fwd, "backward_s": bwd,
           "adamw_s": adam, "peak_bytes": peak}
    if not cfg.is_moe:
        with timed_mixers() as tm:
            parts = step(steps + 2)
        res["mixer_split_ms"] = split = {
            f"{tm.layers[k]} {k}": v * 1e3 for k, v in tm.seconds.items()}
        split["adamw"] = parts[2] * 1e3
        split["step"] = sum(parts) * 1e3
        split["rest"] = split["step"] - sum(v for k, v in split.items()
                                            if k != "step")
        print(f"[{label}] a step with each mixer's forward and backward "
              f"timed (host clock, synchronised), ms: "
              f"{', '.join(f'{k} {v:.1f}' for k, v in split.items())}",
              flush=True)
    if not dev_events or busy_ms <= 0:
        print(f"[{label}] traced step: device busy time not measured (the "
              "profiler saw no device events)", flush=True)
        return res
    n_ops = sum(e.count for e in dev_events)
    print(f"[{label}] traced {shape} step under the profiler: wall "
          f"{wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms ({100 * busy_ms / wall_ms:.1f}%, "
          f"idle {100 - 100 * busy_ms / wall_ms:.1f}%), {n_ops} device "
          f"kernels and copies", flush=True)
    # names no other of them contains: the backward's TMA route, then its
    # general route (none of which should run), then the rest, the
    # attention's forward and its backward's two kernels last
    ours = ("ffn_tma_kernel", "dgrad_gate_tma_kernel", "dgrad_x_tma_kernel",
            "wgrad_tma_kernel", "dgrad_gate_kernel", "dgrad_x_kernel",
            "wgrad_kernel", "route_select_kernel", "route_select_bwd_kernel",
            "attn_fwd", "attn_bwd_dq", "attn_bwd_dkdv")
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:10]
    top += [e for e in dev_events
            if e not in top and any(k in e.key for k in ours)]
    for e in top:
        print(f"[{label}]   {e.self_device_time_total / 1e3:8.3f} ms "
              f"{e.count:6d} x  {e.key[:100]}", flush=True)
    mine = {k: sum(e.self_device_time_total for e in dev_events
                   if k in e.key) / 1e3 for k in ours}
    print(f"[{label}]   the port's kernels: {sum(mine.values()):.1f} ms of "
          f"{busy_ms:.1f} ms device busy: "
          f"{', '.join(f'{k} {v:.1f}' for k, v in mine.items())}",
          flush=True)
    del params, opt
    torch.cuda.empty_cache()
    return res | {"traced_wall_ms": wall_ms, "device_busy_ms": busy_ms,
                  "device_ops": n_ops,
                  "port_kernels_ms": sum(mine.values()),
                  "port_kernels_by_name_ms": mine}


class timed_mixers:
    """Within the block, each recurrent mixer of the model runs on the host
    clock with the card synchronised before and after its forward, and
    again around its backward (a hook on its output's gradient starts the
    clock, one on its input's gradient stops it): ``seconds`` by mixer
    kind, ``layers`` the count of its calls."""

    def __enter__(self):
        from repro_torch.models import model as tmodel
        self.saved = dict(tmodel._SEQ)
        self.seconds = collections.Counter()
        self.layers = collections.Counter()
        for kind, fn in self.saved.items():
            tmodel._SEQ[kind] = self._timed(kind, fn)
        return self

    def _timed(self, kind, fn):
        import torch

        def clock():
            torch.cuda.synchronize()
            return time.perf_counter()

        def call(p, h, state):
            t0 = clock()
            out, st = fn(p, h, state)
            self.seconds[kind] += clock() - t0
            self.layers[kind] += 1
            if out.requires_grad and h.requires_grad:
                started = []

                def stop(grad):
                    self.seconds[kind] += clock() - started[0]

                out.register_hook(lambda grad: started.append(clock()))
                h.register_hook(stop)
            return out, st
        return call

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        tmodel._SEQ.update(self.saved)


class capture_routes:
    """Within the block, the MoE layer's routing calls go to the kernel as
    before, and the inputs of the first ``limit`` are kept in ``calls``,
    cloned. The
    router weights and placement tables (arguments 1-4), which change only
    at a recalibration, are cloned once per distinct tensor and version;
    the originals are held too, so that no later tensor can take their
    address while the capture lives."""

    def __init__(self, limit):
        self.limit = limit
        self.calls = []
        self._held = {}

    def _keep(self, i, a):
        import torch
        if not torch.is_tensor(a):
            return a
        if not 1 <= i <= 4:
            return a.clone()
        key = (a.data_ptr(), a._version, tuple(a.shape), a.dtype)
        if key not in self._held:
            self._held[key] = (a, a.clone())
        return self._held[key][1]

    def __enter__(self):
        from repro_torch.models import moe as tmoe
        self.saved = real = tmoe.ops
        outer = self

        class Ops:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def route_select(*args, **kw):
                if len(outer.calls) < outer.limit:
                    outer.calls.append(
                        ([outer._keep(i, a) for i, a in enumerate(args)],
                         {k: outer._keep(-1, v) for k, v in kw.items()}))
                return real.route_select(*args, **kw)

        tmoe.ops = Ops()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as tmoe
        tmoe.ops = self.saved
        self._held = {}


def route_near_ties(calls, label):
    """Routing calls captured on a served path, through the fused kernel
    and through the unfused sequence (:func:`unfused_route`) on the
    same inputs: every assignment on which the two differ must lie on a
    near-tie row (adjacent top-(K+1) probabilities closer than
    ``NEAR_TIE``), as :func:`route_case` holds single calls."""
    import torch
    from repro_torch.kernels import route_select as t_route
    n = {"calls": len(calls), "rows": 0, "near_tie_rows": 0,
         "rows_that_differ": 0, "assignments_that_differ": 0,
         "calls_with_other_weights": 0, "weights_max_abs_diff": 0.0}
    for args, kw in calls:
        x, w, so, nc, cdf, seed, k = args[:7]
        rv = args[7] if len(args) > 7 else kw.get("row_valid")
        fused = t_route.route_select(x, w, so, nc, cdf, seed, k, rv)
        old = unfused_route(x, w, (so, nc, cdf), seed, k, rv)
        top = torch.topk(torch.softmax(x.float() @ w, dim=-1), k + 1,
                         dim=-1).values
        near = ((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(-1)
        diff = (fused[1] != old[1]) | (fused[2] != old[2])
        rows = diff.any(-1)
        check(not bool((rows & ~near).any()), f"{label}: the fused routing "
              f"stage and the unfused sequence differ on "
              f"{int((rows & ~near).sum())} rows that are not near ties")
        n["rows"] += x.shape[0]
        n["near_tie_rows"] += int(near.sum())
        n["rows_that_differ"] += int(rows.sum())
        n["assignments_that_differ"] += int(diff.sum())
        # the gate weights of the assignments both pick: f32 sums in
        # another order, the one way two runs can drift on equal picks
        same = ~rows
        dw = (fused[0][same] - old[0][same]).abs()
        n["calls_with_other_weights"] += int(bool((dw > 0).any()))
        n["weights_max_abs_diff"] = max(n["weights_max_abs_diff"],
                                        dw.max().item() if dw.numel()
                                        else 0.0)
    print(f"[{label}] near-tie check on {n['calls']} captured routing calls "
          f"({n['rows']} rows): fused kernel vs the unfused sequence differ "
          f"on {n['assignments_that_differ']} assignments in "
          f"{n['rows_that_differ']} rows, all of them near-tie rows "
          f"({n['near_tie_rows']} near-tie rows in all); on the rows that "
          f"agree, the gate weights differ in "
          f"{n['calls_with_other_weights']} calls, by at most "
          f"{n['weights_max_abs_diff']:.3e}", flush=True)
    return n


class plain_kernels:
    """Within the block the MoE layer and (with ``attention``) the
    attention call the kernels' plain versions (autograd of the plain
    forward on the card), not the kernels."""

    def __init__(self, attention=True):
        self.attention = attention

    def __enter__(self):
        import types
        from repro_torch.kernels import ref
        from repro_torch.models import flash as tflash
        from repro_torch.models import model as tmodel
        from repro_torch.models import moe as tmoe
        self.saved = tmoe.ops, tmodel.ops
        tmoe.ops = types.SimpleNamespace(
            ragged_moe_ffn=ref.ragged_moe_ffn_ref,
            route_select=ref.route_select_ref,
            fused_moe_ffn=ref.moe_ffn_ref)
        if self.attention:
            tmodel.ops = types.SimpleNamespace(
                flash_attention=tflash.flash_attention,
                flash_decode=tflash.flash_decode)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        from repro_torch.models import moe as tmoe
        tmoe.ops, tmodel.ops = self.saved


class hold_attention:
    """Within the block every attention call of the model runs the kernel
    (its result goes on) and the plain version on the same inputs:
    ``calls`` counts them, ``err`` is the largest ``row_rel`` of the
    outputs (with ``return_stats``, of acc / l)."""

    def __enter__(self):
        import types
        from repro_torch.models import flash as tflash
        from repro_torch.models import model as tmodel
        self.saved = real = tmodel.ops
        self.calls, self.err = 0, 0.0

        def held(name):
            def call(*args, **kw):
                got = getattr(real, name)(*args, **kw)
                want = getattr(tflash, name)(*args, **kw)
                a, b = got, want
                if isinstance(got, tuple):
                    a, b = ((t[0] / t[2].clamp(min=1e-30)[..., None])
                            for t in (got, want))
                self.calls += 1
                self.err = max(self.err, row_rel(a, b))
                return got
            return call

        tmodel.ops = types.SimpleNamespace(
            flash_attention=held("flash_attention"),
            flash_decode=held("flash_decode"))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        tmodel.ops = self.saved


def kernel_vs_plain_step(cfg, dev, n_layers=2, seq_len=256, batch=4):
    """One loss and backward of a full-width ``n_layers``-layer model
    through the kernels against the same with the MoE kernels' plain
    versions (the attention through its forward and backward kernels on
    both sides: its gradient is held by :func:`attention_grad_case`
    against an f32 reference); the step through every plain version
    beside it, read only."""
    import contextlib
    import dataclasses
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import init_params, loss_fn, make_moe_tables
    from repro_torch.training import DataConfig, synthetic_batch
    from repro_torch.tree import leaves
    small = dataclasses.replace(cfg, n_layers=n_layers)
    b = {k: torch.as_tensor(v, device=dev) for k, v in synthetic_batch(
        small, DataConfig(seq_len=seq_len, global_batch=batch), 0).items()}
    mt = make_moe_tables(small, device=dev)
    out = {}
    moe = 5 * n_layers
    attn = 3 * attn_layers(small)     # forward, dQ, dK/dV
    for name, plain, want in (
            ("kernel", None, moe + attn),
            ("plain", True, 0),
            ("plain MoE", False, attn)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(small, gen, device=dev)
        for p in leaves(params):
            p.requires_grad_(True)
        ops.reset_launch_counts()
        with (contextlib.nullcontext() if plain is None
              else plain_kernels(attention=plain)):
            loss, _ = loss_fn(small)(params, b, mt)
            loss.backward()
        torch.cuda.synchronize()
        counts = attn_routed(ops.launch_counts(), f"{name} step")
        launched = sum(v for k, v in counts.items() if "." not in k)
        check(launched == want, f"{name} step: kernel launches {counts}")
        out[name] = (loss.detach(), [p.grad for p in leaves(params)])

    def errors(other):
        (lk, gk), (lp, gp) = out["kernel"], out[other]
        return (abs(lk.item() - lp.item()) / abs(lp.item()),
                [_rel_l2(a, b) for a, b in zip(gk, gp)])

    loss_err, errs = errors("plain MoE")
    all_loss, all_errs = errors("plain")
    check(loss_err <= STEP_LOSS_TOL and max(errs) <= STEP_TOL,
          f"kernel vs plain step: loss {loss_err:.3e} (bound "
          f"{STEP_LOSS_TOL}), gradient leaves {['%.3e' % e for e in errs]} "
          f"(bound {STEP_TOL})")
    print(f"[train] {n_layers}-layer full-width step, kernels vs the MoE "
          f"kernels' plain versions: loss {out['kernel'][0].item():.5f} vs "
          f"{out['plain MoE'][0].item():.5f} (relative {loss_err:.2e}, "
          f"bound {STEP_LOSS_TOL}); gradient leaves' relative L2 max "
          f"{max(errs):.3e}, median {statistics.median(errs):.3e} over "
          f"{len(errs)} leaves (bound {STEP_TOL}); against every plain "
          f"version (the attention's bf16 autograd too, read only): loss "
          f"{all_loss:.2e}, leaves max {max(all_errs):.3e}, median "
          f"{statistics.median(all_errs):.3e}", flush=True)
    return {"loss_rel_err": loss_err, "grad_rel_l2_max": max(errs),
            "grad_rel_l2": errs, "vs_all_plain": {
                "loss_rel_err": all_loss, "grad_rel_l2": all_errs}}


def capacity_train_step(cfg, dev, seq_len=256, batch=16, steps=3):
    """The capacity path's training step at full width on the card:
    ``launch/train.py::make_train_step`` with ``models.loss_fn(cfg,
    ShardingRules(moe_impl="capacity", ep_ranks=1))`` (the a2a capacity
    body on a one-rank group: buckets (E, C, D), C = 1024 at 16 x 256 and
    factor 1.25), ``steps`` steps from seed 0: each step's launches exact
    (a layer: the routing stage, the capacity FFN, the bucket K1 and K2,
    all on the TMA route, and the routing backward; the attention's
    forward; nothing else), finite losses, the median step time of the
    steps after the first, tokens/s and the peak memory; then the first
    two steps again from seed 0, their losses and parameters bit for bit
    those of the first run."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import init_params, make_moe_tables
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.training import (AdamWConfig, DataConfig, adamw_init,
                                      synthetic_batch)
    from repro_torch.tree import leaves
    rules = ShardingRules(moe_impl="capacity", ep_ranks=1)
    ocfg = AdamWConfig()
    data = DataConfig(seq_len=seq_len, global_batch=batch)
    mt = make_moe_tables(cfg, rules, device=dev)
    L = cfg.n_layers
    per_step = {"route_select": L, "fused_moe_ffn": L,
                "fused_moe_ffn.tma": L, "moe_ffn_dgrad": L,
                "moe_ffn_dgrad.tma": L, "moe_ffn_wgrad": L,
                "moe_ffn_wgrad.tma": L, "route_select_bwd": L} \
        | attn_want(cfg, prefill=1, backward=1)

    def run(n, timed):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device=dev)
        for p in leaves(params):
            p.requires_grad_(True)
        opt = adamw_init(params, ocfg)
        step = make_train_step(cfg, ocfg, n, rules)
        losses, times, digest = [], [], None
        for i in range(n):
            b = {k: torch.as_tensor(v, device=dev)
                 for k, v in synthetic_batch(cfg, data, i).items()}
            ops.reset_launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss, tallies = step(params, opt, b, mt)
            losses.append(loss.item())
            times.append(time.perf_counter() - t0)
            if timed:
                counts = attn_routed(ops.launch_counts(),
                                     f"capacity training step {i}")
                for name, c in counts.items():
                    check(c == per_step.get(name, 0), f"capacity training "
                          f"step {i}: {name} launched {c} times, expected "
                          f"{per_step.get(name, 0)}")
            if i == 1:
                digest = param_digest(params)
        drops = float(tallies[:, -1].sum())
        del params, opt
        torch.cuda.empty_cache()
        return losses, times, digest, drops

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, times, digest, drops = run(steps, True)
    peak = torch.cuda.max_memory_allocated()
    check(all(math.isfinite(v) for v in losses), f"capacity training: "
          f"losses {losses}")
    again, _, digest2, _ = run(2, False)
    check(again == losses[:2] and digest2 == digest, f"capacity training: "
          f"two seeded runs differ (losses {losses[:2]} vs {again})")
    med = statistics.median(times[1:])
    C = 4 * math.ceil(math.ceil(batch * seq_len * cfg.top_k / cfg.n_experts
                                * rules.capacity_factor) / 4)
    print(f"[train] capacity path (moe_impl='capacity', one-rank group, "
          f"factor {rules.capacity_factor}: buckets ({cfg.n_experts}, {C}, "
          f"{cfg.d_model})), {cfg.name} at full width, {steps} steps of "
          f"{batch} x {seq_len} tokens: losses "
          f"{', '.join(f'{v:.4f}' for v in losses)}; step wall times "
          f"{', '.join(f'{t:.3f}' for t in times)} s, median after the "
          f"first {med:.3f} s, {batch * seq_len / med:.0f} tokens/s; "
          f"max_memory_allocated {peak / 2**30:.2f} GiB; drops in the last "
          f"step {drops:.0f}; each step's launches exact ("
          f"{json.dumps({k: v for k, v in per_step.items()})}, all else 0); "
          f"the first two steps again from seed 0: losses and parameters "
          f"bit for bit", flush=True)
    return {"losses": losses, "step_s": times, "median_step_s": med,
            "tokens_per_s": batch * seq_len / med, "peak_bytes": peak,
            "bucket_rows": C, "drops_last_step": drops,
            "launches_per_step": per_step,
            "launches": {k: v * steps for k, v in per_step.items()}}


def checkpoint_restart(dev):
    """Smoke size on the card: 2 steps, a checkpoint, a restore and 2 more
    steps equal 4 straight steps, bit for bit."""
    import shutil
    import torch
    from repro_torch.launch.train import train
    from repro_torch.tree import leaves
    d = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    kw = dict(seq_len=64, batch=4, device=dev, log_every=100)
    arch = "granite-moe-3b-a800m"
    p4, o4, l4, _ = train(arch, steps=4, **kw)
    _, _, l_a, _ = train(arch, steps=2, ckpt_dir=str(d), **kw)
    p_r, o_r, l_b, _ = train(arch, steps=4, ckpt_dir=str(d), **kw)
    torch.cuda.synchronize()
    same = all(bool(torch.equal(a, b))
               for a, b in zip(leaves((p_r, o_r)), leaves((p4, o4))))
    shutil.rmtree(d, ignore_errors=True)
    check(l_a + l_b == l4 and same, f"checkpoint restart: losses {l_a} + "
          f"{l_b} vs {l4}, params and state equal: {same}")
    print(f"[train] smoke-size checkpoint restart on the card: 2 steps, "
          f"restore, 2 steps = 4 straight steps bit for bit (losses {l4})",
          flush=True)


# ---------------------------------------------------------------------------
# phase 13: expert-parallel dispatch over ranks sharing the card
# ---------------------------------------------------------------------------

EP_AXES = ("data", "model")
EP_DECODE_STEPS = 2
# The 4 x 256 runs held against one device as it routes 1024 rows (D split
# into 8 ranges where a rank's 256 rows take 16; see ``ep_phase``): bounds
# set at about twice the readings on an H100 80GB HBM3 (PERF.md, "Expert
# parallelism"; the runs are deterministic): logits' relative L2 0.0269,
# gradient leaves' 0.0668 at most, loss 3.9e-5 relative
EP_WIDE_LOGIT_REL_L2 = 5e-2
EP_WIDE_GRAD_REL_L2 = 0.15
EP_WIDE_LOSS_REL = 1e-4
# decode against one device: the port's psum adds the ranks' (t, D) f32
# partials, one device a token's assignments in k order (see ``ep_phase``);
# the logits' relative L2 read 0.0144 at most over 16 steps
EP_DECODE_REL_L2 = 3e-2


class rank_split:
    """Within the block the routing kernel splits D for a launch of T rows
    as it does for ``T // ways`` rows (``route_select.plan``), rows a block
    and row blocks kept: one device then sums every row's router logits in
    the order of a rank that routes a ``1/ways`` block of them. A witness
    for the ranks, not a path of the port."""

    def __init__(self, ways):
        self.ways = ways

    def __enter__(self):
        from repro_torch.kernels import route_select as t_route
        self.saved = whole = t_route.plan
        ways = self.ways

        def plan(T, D, E):
            tr, dc, _, _, n_rb = whole(T, D, E)
            _, dc_rank, split, cps, _ = whole(max(T // ways, 1), D, E)
            assert dc_rank == dc
            return tr, dc, split, cps, n_rb

        t_route.plan = plan
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import route_select as t_route
        t_route.plan = self.saved


class _Collectives:
    """The collectives module as one module sees it, with some functions
    replaced: a witness patches one module's calls and no other's."""

    def __init__(self, real, **replaced):
        self._real = real
        self.__dict__.update(replaced)

    def __getattr__(self, name):
        return getattr(self._real, name)


class exact_decode_psum:
    """Within the block the replicated ragged body psums each assignment's
    weighted row (t, K, D) and sums the k rows after it, in k order, where
    the port psums the ranks' (t, D) partials: each row is nonzero on the
    one rank that holds its slot, so the psum adds zeros only and gives one
    device's k-order sum bit for bit, at K times the bytes. A witness for
    the ranks' decode, not a path of the port; the MoE layer's calls only
    (the attention's and the MLP's sums are left as they are)."""

    def __enter__(self):
        from repro_torch.models import moe as tmoe
        self.saved = ksum, real = tmoe._ksum, tmoe.C
        tmoe._ksum = lambda contrib: contrib
        tmoe.C = _Collectives(real, sum_partials=lambda x, group: ksum(
            real.sum_partials(x, group)))
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as tmoe
        tmoe._ksum, tmoe.C = self.saved


def _near_tie_rows(calls):
    """Per captured routing call (one a MoE layer), the rows whose
    adjacent top-(K+1) probabilities lie closer than ``NEAR_TIE``."""
    import torch
    out = []
    for args, _ in calls:
        x, w, k = args[0], args[1], args[6]
        top = torch.topk(torch.softmax(x.float() @ w, dim=-1), k + 1,
                         dim=-1).values
        out.append(int(((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(-1).sum()))
    return out


class capture_picks:
    """Within the block, the MoE layer's routing calls go to the kernel as
    before, and ``picks`` keeps, per call, each row's experts sorted (T,
    K) and, with ``gaps``, each row's smallest gap between adjacent
    top-(K+1) probabilities (T,), below ``NEAR_TIE`` at a near tie."""

    def __init__(self, gaps=False):
        self.gaps = gaps
        self.picks = []

    def __enter__(self):
        import torch
        from repro_torch.models import moe as tmoe
        self.saved = real = tmoe.ops
        outer = self

        class Ops:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def route_select(*args, **kw):
                out = real.route_select(*args, **kw)
                gap = None
                if outer.gaps:
                    x, w, k = args[0], args[1], args[6]
                    top = torch.topk(torch.softmax(x.float() @ w, dim=-1),
                                     k + 1, dim=-1).values
                    gap = (top[:, :-1] - top[:, 1:]).amin(-1)
                outer.picks.append((out[1].sort(-1).values, gap))
                return out

        tmoe.ops = Ops()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as tmoe
        tmoe.ops = self.saved


def ep_reference(cfg, dev, inputs, ways, full=True):
    """The single-rank port on the card (``rules=None``) on seed 0's
    weights: prefill logits and tallies at 2 x 256 (with each layer's
    near-tie rows); with ``full`` also at 4 x 256, that prefill again
    under :class:`rank_split` (``/split``), 4 decode steps (logits,
    tallies, each layer's picks and each row's gap to a tie, the cache
    before each step), and at 4 x 256 the loss, its gradients and the
    forward's tallies, both ways. Returns the whole params and the
    results, to be handed to the ranks."""
    import contextlib
    import torch
    from repro_torch.models import (decode_fn, init_cache, init_params,
                                    loss_fn, make_moe_tables, prefill_fn)
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.tree import leaves, tree_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    tables = make_moe_tables(cfg, device=dev)
    ref = {}
    with torch.no_grad():
        for key in ("tokens", "tokens_wide") if full else ("tokens",):
            with capture_routes(cfg.n_layers) as cap:
                lg, _, tal = prefill_fn(cfg)(params, {"tokens": inputs[key]},
                                             tables)
            ref[f"prefill/{key}"] = (lg, tal)
            ref[f"near_ties/{key}"] = _near_tie_rows(cap.calls)
            del cap
        if not full:
            return params, ref
        with rank_split(ways):
            lg, _, tal = prefill_fn(cfg)(params,
                                         {"tokens": inputs["tokens_wide"]},
                                         tables)
        ref["prefill/tokens_wide/split"] = (lg, tal)
        cache = init_cache(cfg, inputs["dec_tokens"].shape[1],
                           EP_DECODE_STEPS, dtype=params["embed"].dtype,
                           device=dev)
        for k in ("decode", "decode_caches", "decode_picks", "decode_gaps",
                  "decode_near_ties"):
            ref[k] = []
        for i, tok in enumerate(inputs["dec_tokens"]):
            pos = torch.full((tok.shape[0],), i, dtype=torch.int32,
                             device=dev)
            ref["decode_caches"].append(tree_map(torch.clone, cache))
            with capture_picks(gaps=True) as cap:
                lg, cache, tal = decode_fn(cfg)(params, tok, cache, pos,
                                                tables)
            gaps = torch.stack([g for _, g in cap.picks])       # (L, T)
            ref["decode"].append((lg, tal))
            ref["decode_picks"].append(torch.stack([p for p, _ in
                                                    cap.picks]))
            ref["decode_gaps"].append(gaps.tolist())
            ref["decode_near_ties"].append((gaps < NEAR_TIE).sum(-1)
                                           .tolist())
            del cap
        del cache
    batch = {"tokens": inputs["tokens_wide"],
             "labels": inputs["labels_wide"]}
    # the ragged path as it runs and under the rank's split, then the
    # capacity path (factor 8: dropless) under the rank's split
    cap = ShardingRules(moe_impl="capacity", ep_ranks=1,
                        capacity_factor=8.0)
    for way, rules in (("", None), ("/split", None),
                       ("_capacity/split", cap)):
        for p in leaves(params):
            p.requires_grad_(True)
        with rank_split(ways) if way else contextlib.nullcontext():
            loss, (tal, _) = loss_fn(cfg, rules)(params, batch, tables)
            loss.backward()
        ref[f"loss{way}"] = loss.detach()
        ref[f"grads{way}"] = tree_map(lambda p: p.grad, params)
        ref[f"backward_tally{way}"] = tal.detach()
        params = tree_map(lambda p: p.detach(), params)
    return params, ref


def _rel_l2_chunked(a, b, chunk=1 << 24) -> float:
    """:func:`_rel_l2` over ``chunk`` elements at a time, so that a rank
    sharing the card makes f32 copies of one chunk only."""
    a, b = a.reshape(-1), b.reshape(-1)
    num = den = 0.0
    for i in range(0, a.numel(), chunk):
        x, y = a[i:i + chunk].float(), b[i:i + chunk].float()
        num += (x - y).square().sum().item()
        den += y.square().sum().item()
    return math.sqrt(num) / max(math.sqrt(den), 1e-30)


def _moved(tal, ref_tal):
    """Assignments routed to another expert, per layer."""
    return [int(v) // 2 for v in
            (tal[:, :-1] - ref_tal[:, :-1]).abs().sum(-1).tolist()]


class hold_calls:
    """Within the block every kernel the MoE layer launches, forward and
    backward, also runs through its plain version on the same inputs, and
    the two are compared as the kernel checks above compare them: the FFNs
    by their max |difference| (``err["ragged_moe_ffn"]``,
    ``err["fused_moe_ffn"]``); the routing stage by its indices, slots and
    tally outside near-tie rows (``route_mismatch``, entries that differ
    there; the near-tie rows' counts taken out of both tallies) and its
    weights, mean probabilities and aux (``err["route_select"]``; where a
    near-tie row picked another expert, the kernel's aux against the aux
    formula on its own tally and mean probabilities); K1 and
    K2 by the relative L2 of ``dx`` and of the weights' gradients against
    ``ragged_moe_ffn_bwd_ref``, the bucket K1 and K2 against
    ``moe_ffn_bwd_ref``; K3 by its max |difference|. The kernel's
    result goes on; ``calls`` counts the calls held."""

    def __init__(self):
        self.calls = collections.Counter()
        self.err = collections.defaultdict(float)
        self.route_mismatch = self.near_rows = self.rows_that_differ = 0
        self._dws = None

    def _note(self, name, err):
        self.calls[name] += 1
        self.err[name] = max(self.err[name], err)

    def _ffn(self, name, out, want):
        self._note(name, (out.float() - want.float()).abs().max().item())
        return out

    def _route(self, got, want, args, kw):
        import torch
        from repro_torch.kernels import ref
        x, w, k = args[0], args[1], args[6]
        rv = args[7] if len(args) > 7 else kw.get("row_valid")
        E = w.shape[1]
        top = torch.topk(torch.softmax(x.float() @ w, dim=-1), k + 1,
                         dim=-1).values
        near = ((top[:, :-1] - top[:, 1:]) < NEAR_TIE).any(-1)
        ok = ~near
        (w_k, i_k, s_k, t_k, mp_k, aux_k), (w_r, i_r, s_r, t_r, mp_r,
                                            aux_r) = got[:6], want[:6]
        rows = (i_k != i_r).any(-1) | (s_k != s_r).any(-1)
        t_k, t_r = t_k.clone(), t_r.clone()
        counted = near if rv is None else near & rv
        for t, i in ((t_k, i_k), (t_r, i_r)):
            t[:E] -= torch.bincount(i[counted].reshape(-1).long(),
                                    minlength=E).float()
        self.route_mismatch += int((rows & ok).sum()) + int(
            (t_k != t_r).sum())
        self.near_rows += int(near.sum())
        self.rows_that_differ += int(rows.sum())
        aux_k, aux_r = aux_k.item(), aux_r.item()
        if bool(rows.any()):
            # a near-tie row that picked another expert moves the tally and
            # so aux: hold the kernel's aux against the formula on its own
            # tally and mean probabilities (both held above), so that a
            # wrong aux still fails
            aux_r = ref.aux_loss(got[3][:E], mp_k, E).item()
        self._note("route_select", max(
            (w_k[ok] - w_r[ok]).abs().max().item() if bool(ok.any()) else 0,
            (mp_k - mp_r).abs().max().item(),
            abs(aux_k - aux_r) / max(abs(aux_r), 1.0)))
        return got

    def __enter__(self):
        import types
        import torch
        from repro_torch.kernels import ops, ref
        from repro_torch.models import moe as tmoe
        self.saved = real = tmoe.ops
        # the backward kernels, as the autograd Functions of ``ops`` reach
        # them (each wrapper counts its launches on itself, so the modules
        # keep theirs)
        self.saved_bwd = ops._ragged, ops._route, ops._capacity
        cap_dgrad = ops._capacity.moe_ffn_dgrad
        cap_wgrad = ops._capacity.moe_ffn_wgrad
        dgrad = ops._ragged.ragged_moe_ffn_dgrad
        wgrad = ops._ragged.ragged_moe_ffn_wgrad
        route_bwd = ops._route.route_select_bwd
        outer = self

        def plain(fn, *a, **kw):
            with torch.no_grad():
                return fn(*a, **kw)

        class Ops:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def ragged_moe_ffn(*a, **kw):
                return outer._ffn("ragged_moe_ffn", real.ragged_moe_ffn(
                    *a, **kw), plain(ref.ragged_moe_ffn_ref, *a, **kw))

            @staticmethod
            def fused_moe_ffn(*a, **kw):
                return outer._ffn("fused_moe_ffn", real.fused_moe_ffn(
                    *a, **kw), plain(ref.moe_ffn_ref, *a, **kw))

            @staticmethod
            def route_select(*a, **kw):
                return outer._route(real.route_select(*a, **kw),
                                    plain(ref.route_select_ref, *a, **kw),
                                    a, kw)

        def held_dgrad(w1, w3, w2, toks, tile_group, row_offsets, sizes, dy,
                       **kw):
            dx, da, db = dgrad(w1, w3, w2, toks, tile_group, row_offsets,
                               sizes, dy, **kw)
            want = ref.ragged_moe_ffn_bwd_ref(w1, w3, w2, toks, tile_group,
                                              dy)
            outer._note("ragged_moe_ffn_dgrad", _rel_l2(dx, want[0]))
            outer._dws = want[1:]
            return dx, da, db

        def held_wgrad(*a, **kw):
            dws = wgrad(*a, **kw)
            outer._note("ragged_moe_ffn_wgrad", max(
                _rel_l2(g, w) for g, w in zip(dws, outer._dws)))
            return dws

        def held_cap_dgrad(w1, w3, w2, toks, dy):
            dx, da, db = cap_dgrad(w1, w3, w2, toks, dy)
            want = ref.moe_ffn_bwd_ref(w1, w3, w2, toks, dy)
            outer._note("moe_ffn_dgrad", _rel_l2(dx, want[0]))
            outer._dws = want[1:]
            return dx, da, db

        def held_cap_wgrad(*a):
            dws = cap_wgrad(*a)
            outer._note("moe_ffn_wgrad", max(
                _rel_l2(g, w) for g, w in zip(dws, outer._dws)))
            return dws

        def held_route_bwd(*a, **kw):
            dl = route_bwd(*a, **kw)
            want = ref.route_select_dlogits_ref(*a, **kw)
            outer._note("route_select_bwd",
                        (dl - want).abs().max().item())
            return dl

        def module(real_module, **held):
            return types.SimpleNamespace(**{
                k: v for k, v in vars(real_module).items()
                if not k.startswith("__")} | held)

        tmoe.ops = Ops()
        ops._ragged = module(ops._ragged, ragged_moe_ffn_dgrad=held_dgrad,
                             ragged_moe_ffn_wgrad=held_wgrad)
        ops._route = module(ops._route, route_select_bwd=held_route_bwd)
        ops._capacity = module(ops._capacity, moe_ffn_dgrad=held_cap_dgrad,
                               moe_ffn_wgrad=held_cap_wgrad)
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import ops
        from repro_torch.models import moe as tmoe
        tmoe.ops = self.saved
        ops._ragged, ops._route, ops._capacity = self.saved_bwd


def _ep_vs_plain(cfg, rules, params, inputs, dev):
    """On one rank, the ``cfg`` model (2 layers: the rank's shapes are
    those of any depth) on the expert-parallel paths, each kernel call held
    against its plain version on the same inputs (:class:`hold_calls`):
    prefill 2 x 256 and 4 x 256 (ragged a2a), capacity 2 x 256 (factor 8),
    one decode step (replicated ragged), and a loss and backward at 4 x
    256 through the ragged a2a body (K1, K2 and K3 in the backward) and
    through the capacity a2a body (factor 8; the bucket K1 and K2, K3).
    Returns the comparisons' numbers."""
    import dataclasses
    import torch
    from repro_torch.launch.sharding import decode_params, shard_params
    from repro_torch.models import (decode_fn, init_cache, loss_fn,
                                    make_moe_tables, prefill_fn)
    from repro_torch.tree import leaves
    local = shard_params(cfg, params, rules, "prefill")
    tables = make_moe_tables(cfg, rules, phase="prefill", device=dev)
    dparams = shard_params(cfg, decode_params(cfg, params, rules), rules,
                           "decode")
    dtables = make_moe_tables(cfg, rules, phase="decode", device=dev)
    tparams = shard_params(cfg, params, rules, "train")
    for p in leaves(tparams):
        p.requires_grad_(True)
    cap = dataclasses.replace(rules, moe_impl="capacity",
                              capacity_factor=8.0)
    tok = inputs["dec_tokens"][0]
    with hold_calls() as held:
        with torch.no_grad():
            prefill_fn(cfg, rules)(local, {"tokens": inputs["tokens"]},
                                   tables)
            prefill_fn(cfg, rules)(local, {"tokens": inputs["tokens_wide"]},
                                   tables)
            prefill_fn(cfg, cap)(local, {"tokens": inputs["tokens"]}, tables)
            decode_fn(cfg, rules)(
                dparams, tok, init_cache(cfg, tok.shape[0], EP_DECODE_STEPS,
                                         dtype=params["embed"].dtype,
                                         device=dev),
                torch.zeros((tok.shape[0],), dtype=torch.int32, device=dev),
                dtables)
        wide = {"tokens": inputs["tokens_wide"],
                "labels": inputs["labels_wide"]}
        for r in (rules, cap):
            loss, _ = loss_fn(cfg, r)(tparams, wide, tables)
            loss.backward()
    return {"calls": dict(held.calls), "err": dict(held.err),
            "route_mismatch": held.route_mismatch,
            "near_rows": held.near_rows,
            "rows_that_differ": held.rows_that_differ}


def ep_rank(rank, plan, params, ref, inputs, small=None):
    """One rank of ``plan["grid"]`` on the card: the expert-parallel paths
    of ``plan["paths"]`` through the port's entry points, on the rank's
    slice of ``params`` (shared with the parent, read only), each timed on
    the host clock, its launches counted, and held against the parent's
    single-rank results ``ref``; with ``small`` (a 2-layer model's whole
    params) also each kernel against its plain version at the rank's
    shapes (:func:`_ep_vs_plain`, launches not counted). Returns the
    numbers; the parent checks them."""
    import contextlib
    import dataclasses
    import statistics as st
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import decode_params, shard_params
    from repro_torch.models import (decode_fn, loss_fn, make_moe_tables,
                                    prefill_fn)
    from repro_torch.models import collectives
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.tree import leaves, tree_map
    dev = inputs["tokens"].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = plan["cfg"]
    grid = make_mesh(plan["grid"], EP_AXES)
    # the dense layers replicated over "model" (phase 15 splits them)
    rules = ShardingRules(grid=grid, dp=("data",), tp=None, ep=("model",),
                          ep_all=EP_AXES, fsdp=None)
    out = {"rank": rank, "seconds": {}, "launches": {}, "err": {},
           "rel": {}, "moved": {}, "exchange": {}, "section_s": {}}

    def run(name, fn, clocked=False):
        dist.barrier()
        sync()
        ops.reset_launch_counts()
        collectives.clock.reset()
        collectives.clock.enabled = clocked
        t0 = time.perf_counter()
        res = fn()
        sync()
        wall = time.perf_counter() - t0
        collectives.clock.enabled = False
        if clocked:
            out["exchange"][name] = {
                "wall_s": wall, "exchange_s": collectives.clock.seconds,
                "calls": collectives.clock.calls,
                "bytes": collectives.clock.bytes}
        else:
            out["seconds"][name] = wall
            out["launches"][name] = attn_routed(ops.launch_counts(),
                                                f"ep {name}")
        return res

    local = shard_params(cfg, params, rules, "prefill")
    tables = make_moe_tables(cfg, rules, phase="prefill", device=dev)
    with torch.no_grad():               # loads the kernels, warms the group
        run("warm-up", lambda: prefill_fn(cfg, rules)(
            local, {"tokens": inputs["tokens"]}, tables))
    for path in plan["paths"]:
        out["section_s"][path] = -time.perf_counter()
        if path in ("prefill", "capacity", "prefill_wide"):
            capacity = path.startswith("capacity")
            wide = path.endswith("_wide")
            r = rules if not capacity else dataclasses.replace(
                rules, moe_impl="capacity", capacity_factor=8.0)
            key = "tokens_wide" if wide else "tokens"
            fn = prefill_fn(cfg, r)
            with torch.no_grad():
                lg, _, tal = run(path, lambda: fn(
                    local, {"tokens": inputs[key]}, tables))
                for way in ("", "/split") if wide else ("",):
                    want_lg, want_tal = ref[f"prefill/{key}{way}"]
                    out["err"][path + way] = (lg.float() - want_lg.float()
                                              ).abs().max().item()
                    out["rel"][path + way] = _rel_l2(lg, want_lg)
                    out["moved"][path + way] = _moved(tal, want_tal)
                out[f"{path}_drops"] = float(tal[:, -1].sum())
                out[f"{path}_digest"] = lg.double().sum().item()
                # the exchanges' share of 4 x 256 and of the backward (83-
                # 87% in PRs 18-22) are not clocked again: phases 15 and 16
                # clock theirs
                if not capacity and not wide:
                    run(path, lambda: fn(local, {"tokens": inputs[key]},
                                         tables), clocked=True)
        elif path == "decode":
            dparams = shard_params(cfg, decode_params(cfg, params, rules),
                                   rules, "decode")
            dtables = make_moe_tables(cfg, rules, phase="decode", device=dev)
            fn = decode_fn(cfg, rules)
            steps = inputs["dec_tokens"]

            def decode_step(i, tok):
                # each step from the single rank's cache before it: a
                # difference that one step makes stays in that step
                cache = tree_map(torch.clone, ref["decode_caches"][i])
                pos = torch.full((tok.shape[0],), i, dtype=torch.int32,
                                 device=dev)
                return fn(dparams, tok, cache, pos, dtables)

            with torch.no_grad():
                for form, witness in (("decode", contextlib.nullcontext),
                                      ("decode/exact", exact_decode_psum)):
                    firsts, lane_errs, rels, moved = [], [], [], []
                    with witness():
                        for i, tok in enumerate(steps):
                            with capture_picks() as cap:
                                lg, _, tal = decode_step(i, tok)
                            want_lg, want_tal = ref["decode"][i]
                            differ = (torch.stack([p for p, _ in cap.picks])
                                      != ref["decode_picks"][i]).any(-1)
                            firsts.append(torch.where(
                                differ.any(0), differ.int().argmax(0),
                                -1).tolist())                 # per lane
                            lane_errs.append(
                                (lg.float() - want_lg.float()).abs()
                                .reshape(tok.shape[0], -1).amax(-1).tolist())
                            rels.append(_rel_l2(lg, want_lg))
                            moved.append(_moved(tal, want_tal))
                            del cap
                        run(form, lambda: decode_step(len(steps) - 1,
                                                      steps[-1]),
                            clocked=True)
                    out["decode_first_moved_layer" + form[6:]] = firsts
                    out["err"][form] = max(map(max, lane_errs))
                    out["rel"][form] = max(rels)
                    out["moved"][form] = moved
                    out["decode_steps_compared" + form[6:]] = len(rels)
                times = []
                ops.reset_launch_counts()
                for i, tok in enumerate(steps):
                    dist.barrier()
                    sync()
                    t0 = time.perf_counter()
                    decode_step(i, tok)
                    sync()
                    times.append(time.perf_counter() - t0)
                out["launches"]["decode"] = attn_routed(
                    ops.launch_counts(), "ep decode")
                out["seconds"]["decode"] = st.median(times)
                out["seconds"]["decode_all"] = sum(times)
            del dparams
        elif path in ("backward", "capacity_backward"):
            # the capacity path (factor 8: dropless) is held under the
            # split against one device's capacity gradient, and as it runs
            # against one device's ragged gradient: the same function
            capacity = path.startswith("capacity")
            r = rules if not capacity else dataclasses.replace(
                rules, moe_impl="capacity", capacity_factor=8.0)
            pre = "capacity_" if capacity else ""
            tparams = shard_params(cfg, params, rules, "train")
            for p in leaves(tparams):
                p.requires_grad_(True)
            fn = loss_fn(cfg, r)
            batch = {"tokens": inputs["tokens_wide"],
                     "labels": inputs["labels_wide"]}

            def step():
                loss, (tal, _) = fn(tparams, batch, tables)
                loss.backward()
                return loss.detach(), tal

            loss, tal = run(path, step)
            out[pre + "loss"] = loss.item()
            out[path + "_drops"] = float(tal[:, -1].sum())
            for way in ("", "/split"):
                key = ("_capacity" if capacity and way else "") + way
                out["moved"][path + way] = _moved(
                    tal, ref["backward_tally" + key])
                want = leaves(shard_params(cfg, ref["grads" + key], rules,
                                           "train"))
                out[pre + "grad_rel_l2_max" + way] = max(
                    _rel_l2_chunked(p.grad, w)
                    for p, w in zip(leaves(tparams), want))
                del want
            out["grad_leaves"] = len(leaves(tparams))
            for p in leaves(tparams):
                p.grad = None
            del tparams
        elif path == "vs_plain":
            t0 = time.perf_counter()
            out["vs_plain"] = _ep_vs_plain(plan["small_cfg"], rules, small,
                                           inputs, dev)
            out["vs_plain"]["seconds"] = time.perf_counter() - t0
        out["section_s"][path] += time.perf_counter()
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    return out


def _free_shared():
    """Return what the ranks held through CUDA IPC to the card."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.ipc_collect()
        torch.cuda.empty_cache()


def ep_ranks(rank, runs):
    """:func:`ep_rank` (or, for plan (l), :func:`grid_plan_rank`) on this
    rank for each argument tuple of ``runs`` in turn: the plans share one
    start of the ranks. Returns each one's numbers."""
    return [(grid_plan_rank if "label" in args[0] else ep_rank)(rank, *args)
            for args in runs]


#: plan (l)'s grid: FSDP over ("pod", "data"), the batch over "data"
GRID3_AXES = ("pod", "data", "model")
# plan (l)'s AdamW step as it runs against the same step under FSDP over
# "data" alone: the norm's partial sums run over other ranks in another
# order, so the clip's factor may differ in its last bits (the witness,
# the narrow norm's factor on the wide slices, is bit for bit). The
# readings on an H100 80GB HBM3 at 700 W were 0.0 and 0.0 (PERF.md,
# plan (l)): the bounds leave room for the norm's last bits and the few
# parameters whose rounding they would move
GRID_FSDP_NORM_REL = 1e-6
GRID_FSDP_STEP_ABS = 1e-6


def grid_reference(cfg, dev, inputs):
    """Plan (l)'s one device: ``rules=None`` on seed 0's weights of the
    2-layer model, the loss at 4 x 256, its gradients and its tallies.
    Returns the whole params and the results, to be handed to the
    ranks."""
    import torch
    from repro_torch.models import init_params, loss_fn, make_moe_tables
    from repro_torch.tree import leaves, tree_map
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(cfg, gen, device=dev, dtype=torch.bfloat16)
    for p in leaves(params):
        p.requires_grad_(True)
    loss, (tal, _) = loss_fn(cfg)(params, {"tokens": inputs["tokens_wide"],
                                           "labels": inputs["labels_wide"]},
                                  make_moe_tables(cfg, device=dev))
    loss.backward()
    ref = {"loss": loss.detach(), "grads": tree_map(lambda p: p.grad, params),
           "backward_tally": tal.detach()}
    return tree_map(lambda p: p.detach(), params), ref


def _expert_norm(tree) -> float:
    """The f32 norm of the expert matrices of a (rank's) params tree."""
    total = 0.0
    for sub in tree["blocks"]:
        for k in ("w1", "w3", "w2"):
            if k in sub.get("ffn", {}):
                total += sub["ffn"][k].float().square().sum().item()
    return math.sqrt(total)


def grid_plan_rank(rank, plan, params, ref, inputs):
    """Plan (l) on one rank of the (2, 2, 1) grid over
    :data:`GRID3_AXES` on the card: the 2-layer model's ``params`` at 4 x
    256 (``inputs``' wide batch), the batch over "data", a loss, its
    backward and one AdamW step with FSDP over ("pod", "data"), against
    the same with FSDP over "data" alone (the gradients and the stepped
    params gathered whole and cut as the wide rules cut them: the same
    sums over the same ranks) and against one device (``ref``). Each run
    timed on the host clock, its launches counted; the parent checks the
    numbers."""
    import dataclasses
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (cut_tree, gather_params,
                                             param_cuts, shard_params)
    from repro_torch.models import loss_fn, make_moe_tables
    from repro_torch.models.sharding import ShardingRules
    from repro_torch.training import optimizer as topt
    from repro_torch.tree import leaves, tree_map
    dev = inputs["tokens"].device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats()

    def sync():
        if cuda:
            torch.cuda.synchronize()

    cfg = plan["cfg"]
    t_plan = time.perf_counter()
    grid = make_mesh(plan["grid"], GRID3_AXES)
    out = {"rank": rank, "seconds": {}, "launches": {},
           "mesh_s": time.perf_counter() - t_plan}

    def run(name, fn):
        dist.barrier()
        sync()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        sync()
        out["seconds"][name] = time.perf_counter() - t0
        out["launches"][name] = attn_routed(ops.launch_counts(),
                                            f"(l) {name}")
        return res

    batch = {"tokens": inputs["tokens_wide"],
             "labels": inputs["labels_wide"]}

    def backward(rules, name):
        tparams = shard_params(cfg, params, rules, "train")
        for p in leaves(tparams):
            p.requires_grad_(True)
        tables = make_moe_tables(cfg, rules, phase="train", device=dev)

        def step():
            loss, (tal, _) = loss_fn(cfg, rules)(tparams, batch, tables)
            loss.backward()
            return loss.detach(), tal.detach()

        loss, tal = run(name, step)
        return tparams, tree_map(lambda p: p.grad, tparams), loss, tal

    wide = ShardingRules(grid=grid, dp=("data",), tp="model", ep=("model",),
                         ep_all=GRID3_AXES, fsdp=("pod", "data"))
    narrow = dataclasses.replace(wide, fsdp=("data",))
    pw, gw, loss_w, tal_w = backward(wide, "backward")
    one = shard_params(cfg, ref["grads"], wide, "train")
    out["backward"] = {
        "loss": loss_w.item(),
        "loss_rel": abs(loss_w.item() - ref["loss"].item())
        / abs(ref["loss"].item()),
        "moved": _moved(tal_w, ref["backward_tally"]),
        "grad_rel_l2_max": max(_rel_l2_chunked(g, w) for g, w in
                               zip(leaves(gw), leaves(one))),
        "expert_norm_ratio": _expert_norm(gw) / _expert_norm(one)}
    del one
    pn, gn, loss_n, tal_n = backward(narrow, "backward_narrow")
    cuts_w, cuts_n = param_cuts(cfg, wide), param_cuts(cfg, narrow)
    want = cut_tree(gather_params(gn, cuts_n, grid), cuts_w, grid)
    out["narrow"] = {
        "loss_equal": bool(torch.equal(loss_w, loss_n)),
        "tallies_equal": bool(torch.equal(tal_w, tal_n)),
        "grad_leaves_equal": sum(bool(torch.equal(a, b)) for a, b in
                                 zip(leaves(gw), leaves(want))),
        "grad_leaves": len(leaves(gw)),
        "expert_norm_ratio": _expert_norm(gw) / _expert_norm(want)}
    del want
    ocfg = topt.AdamWConfig()
    lr = torch.tensor(ocfg.lr, dtype=torch.float32, device=dev)
    with torch.no_grad():
        norm_w = topt.global_norm(gw, cuts_w, grid)
        norm_n = topt.global_norm(gn, cuts_n, grid)
        # the witness: the wide slices stepped under the narrow norm's
        # clip, from the same state
        pw_wit = tree_map(torch.clone, pw)
        topt.adamw_apply(gw, topt.adamw_init(pw_wit, ocfg), pw_wit, ocfg,
                         lr, topt.clip_scale(norm_n, ocfg))
        st_w = topt.adamw_init(pw, ocfg)
        run("adamw", lambda: topt.adamw_update(gw, st_w, pw, ocfg, lr,
                                               cuts=cuts_w, grid=grid))
        topt.adamw_update(gn, topt.adamw_init(pn, ocfg), pn, ocfg, lr,
                          cuts=cuts_n, grid=grid)
        want = cut_tree(gather_params(pn, cuts_n, grid), cuts_w, grid)
        out["step"] = {
            "norm": norm_w.item(), "norm_narrow": norm_n.item(),
            "norm_rel": abs(norm_w.item() - norm_n.item()) / norm_n.item(),
            "witness_leaves_equal": sum(bool(torch.equal(a, b)) for a, b in
                                        zip(leaves(pw_wit), leaves(want))),
            "max_abs": max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(leaves(pw), leaves(want))),
            "leaves_differing": sum(not torch.equal(a, b) for a, b in
                                    zip(leaves(pw), leaves(want)))}
    del pw_wit, want, pw, pn, gw, gn
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    out["plan_s"] = time.perf_counter() - t_plan
    return out


def ep_phase(cfg, dev):
    """Phase 13: granite at full width on 4 ranks sharing the card (gloo on
    CUDA tensors), ep 4: prefills of 2 x 256 and 4 x 256 through the
    ragged a2a body and of 2 x 256 through the capacity a2a body (factor
    8: dropless; its 4 x 256 forward is the capacity backward's), 4
    decode steps of 8 lanes through the replicated ragged body on
    ``expand_experts``' weights, one loss and backward of 4 x 256 through
    the ragged a2a body and one through the capacity a2a body (factor 8);
    every kernel against its plain version on the
    ranks, at a 2-layer model's same shapes; then (l), FSDP over ("pod",
    "data") with the batch over "data" at 2 layers
    (:func:`grid_plan_rank`; the a2a body at dp 2 x ep 2 with FSDP runs in
    phase 16 (a)). Each is held against the single-rank port on the same
    weights in this run.

    A rank that routes 128 rows splits D in the routing kernel into the
    same 16 ranges as one device routing 512 rows (``route_select.plan``),
    so every logit sums in the same order: at 2 x 256 the routing is the
    single rank's, no assignment may move, and the logits are held within
    ``BF16_TOL``. At 4 x 256 a rank's 256 rows take 16 ranges where one
    device's 1024 take 8: the gate weights differ in their last bits, a
    layer's output rounds otherwise here and there, and near ties in later
    layers flip. So the 4 x 256 runs are held twice: against one device
    under :class:`rank_split` (the rank's D split; no assignment may move,
    logits within ``BF16_TOL``, gradients within ``STEP_TOL``), and
    against one device as it runs (``EP_WIDE_*`` bounds). Decode routes
    the same 8 rows on every rank and on one device, but its psum adds the
    ranks' (t, D) f32 partials in the group's order, where one device sums
    a token's assignments in k order: the outputs differ in their last
    bits, and over 32 random-weight layers that moves routing decisions
    that are not near ties. So each step starts from the single rank's
    cache and is run twice: under :class:`exact_decode_psum` (the witness;
    no assignment may move, logits within ``BF16_TOL``), and as the port
    runs it, against one device within ``EP_DECODE_REL_L2``."""
    import dataclasses
    import torch
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import run_ranks
    t_start = time.perf_counter()
    if dev.type == "cuda":
        build.build_all()             # built once, before any rank loads
    g = torch.Generator().manual_seed(13)
    L, V, ways = cfg.n_layers, cfg.vocab, 4
    inputs = {
        "tokens": torch.randint(0, V, (2, 256), generator=g).to(dev),
        "tokens_wide": torch.randint(0, V, (4, 256), generator=g).to(dev),
        "labels_wide": torch.randint(0, V, (4, 256), generator=g).to(dev),
        "dec_tokens": torch.randint(0, V, (EP_DECODE_STEPS, 8, 1),
                                    generator=g).to(dev)}
    params, ref = ep_reference(cfg, dev, inputs, ways)
    small = dataclasses.replace(cfg, n_layers=2)
    params2, ref2 = grid_reference(small, dev, inputs)
    _free_shared()                    # the references' activations
    parent_gib = (torch.cuda.memory_allocated() / 2 ** 30
                  if dev.type == "cuda" else 0.0)
    t_ref = time.perf_counter() - t_start
    plan = {"cfg": cfg, "grid": (1, ways), "small_cfg": small,
            "paths": ["prefill", "capacity", "prefill_wide", "decode",
                      "backward", "capacity_backward", "vs_plain"]}
    # (l) FSDP over ("pod", "data") with the batch over "data", 2 layers:
    # on the same ranks after ep 4
    plan_l = {"label": "fsdp", "cfg": small, "grid": (2, 2, 1)}
    t0 = time.perf_counter()
    ranks, wide = zip(*run_ranks(ep_ranks, ways, args=([
        (plan, params, ref, inputs, params2),
        (plan_l, params2, ref2, inputs)],), timeout_s=400))
    t_ranks = time.perf_counter() - t0
    print("[ep] ep 4, each rank against the single rank: " + json.dumps(
        [{k: r[k] for k in ("err", "rel", "decode_steps_compared")}
         for r in ranks]), flush=True)
    near, near_wide = ref["near_ties/tokens"], ref["near_ties/tokens_wide"]
    dec_near, dec_gaps = ref["decode_near_ties"], ref["decode_gaps"]
    loss_ref = {w: ref["loss" + w].item()
                for w in ("", "/split", "_capacity/split")}
    del params, ref
    _free_shared()
    # the attention: whole on every rank (the dense layers replicated),
    # one launch a layer and call, the training step's forward too, and
    # the backward's two kernels once a layer in a backward
    attn = attn_want(cfg, prefill=1)
    grad = attn_want(cfg, prefill=1, backward=1)
    per = {"route_select": L, "ragged_moe_ffn": L,
           "ragged_moe_ffn.tma": L} | attn
    want = {
        "warm-up": per, "prefill": per, "prefill_wide": per,
        "capacity": {"route_select": L, "fused_moe_ffn": L,
                     "fused_moe_ffn.tma": L} | attn,
        "decode": {k: v * EP_DECODE_STEPS for k, v in per.items()
                   if k != "flash_attn_fwd"}
        | attn_want(cfg, decode=EP_DECODE_STEPS),
        "backward": per | grad | {k: L for k in (
            "ragged_moe_ffn_dgrad", "ragged_moe_ffn_dgrad.tma",
            "ragged_moe_ffn_wgrad", "ragged_moe_ffn_wgrad.tma",
            "route_select_bwd")},
        "capacity_backward": {k: L for k in (
            "route_select", "fused_moe_ffn", "fused_moe_ffn.tma",
            "moe_ffn_dgrad", "moe_ffn_dgrad.tma", "moe_ffn_wgrad",
            "moe_ffn_wgrad.tma", "route_select_bwd")} | grad}
    on_card = dev.type == "cuda"      # a CPU rehearsal launches nothing

    def hold_same(label, moved, err):
        check(not any(moved) and err <= BF16_TOL,
              f"{label}: {sum(moved)} assignments moved, max |logit - "
              f"single rank| {err} (bound {BF16_TOL})")

    for r in ranks:
        label = f"ep 4 rank {r['rank']}"
        for path, counts in r["launches"].items():
            for k, n in counts.items():
                check(n == want[path].get(k, 0) or not on_card,
                      f"{label} {path}: {k} launched {n} times, expected "
                      f"{want[path].get(k, 0)}")
        for path in ("prefill", "capacity", "prefill_wide/split"):
            hold_same(f"{label} {path}", r["moved"][path], r["err"][path])
        for path in ("prefill_wide",):
            check(r["rel"][path] <= EP_WIDE_LOGIT_REL_L2,
                  f"{label} {path} against one device's own split: logits'"
                  f" relative L2 {r['rel'][path]:.3e} (bound "
                  f"{EP_WIDE_LOGIT_REL_L2})")
        check(r["decode_steps_compared"] == EP_DECODE_STEPS
              and r["decode_steps_compared/exact"] == EP_DECODE_STEPS,
              f"{label} decode: {r['decode_steps_compared']} and "
              f"{r['decode_steps_compared/exact']} steps held")
        exact_first = sum(r["decode_first_moved_layer/exact"], [])
        check(all(f < 0 for f in exact_first), f"{label} decode under "
              f"exact_decode_psum: lanes' first moved layers {exact_first}")
        hold_same(f"{label} decode under exact_decode_psum",
                  sum(r["moved"]["decode/exact"], []),
                  r["err"]["decode/exact"])
        check(r["rel"]["decode"] <= EP_DECODE_REL_L2,
              f"{label} decode against one device: logits' relative L2 "
              f"{r['rel']['decode']:.3e} (bound {EP_DECODE_REL_L2})")
        r["decode_flips"] = [
            (i, j, f, dec_gaps[i][f][j])
            for i, first in enumerate(r["decode_first_moved_layer"])
            for j, f in enumerate(first) if f >= 0]
        check(r["capacity_drops"] == 0, f"ep 4 capacity at factor 8 "
              f"dropped {r['capacity_drops']} assignments")
        loss_err = {w: abs(r["loss"] - v) / abs(v)
                    for w, v in loss_ref.items()}
        check(not any(r["moved"]["backward/split"])
              and loss_err["/split"] <= STEP_LOSS_TOL
              and r["grad_rel_l2_max/split"] <= STEP_TOL,
              f"{label} backward 4 x 256 against one device under the "
              f"rank's split: {sum(r['moved']['backward/split'])} "
              f"assignments moved, loss {loss_err['/split']:.3e} (bound "
              f"{STEP_LOSS_TOL}), gradient leaves max "
              f"{r['grad_rel_l2_max/split']:.3e} (bound {STEP_TOL})")
        check(loss_err[""] <= EP_WIDE_LOSS_REL
              and r["grad_rel_l2_max"] <= EP_WIDE_GRAD_REL_L2,
              f"{label} backward 4 x 256 against one device's own split: "
              f"loss {loss_err['']:.3e} (bound {EP_WIDE_LOSS_REL}), "
              f"gradient leaves max {r['grad_rel_l2_max']:.3e} (bound "
              f"{EP_WIDE_GRAD_REL_L2})")
        # the capacity a2a body's backward (factor 8: dropless) against one
        # device's capacity path under the rank's split, and against one
        # device's ragged path as it runs (the same function)
        cap_err = {w: abs(r["capacity_loss"] - loss_ref[v]) / abs(loss_ref[v])
                   for w, v in (("", ""), ("/split", "_capacity/split"))}
        check(r["capacity_backward_drops"] == 0, f"{label} capacity "
              f"backward at factor 8 dropped "
              f"{r['capacity_backward_drops']} assignments")
        check(not any(r["moved"]["capacity_backward/split"])
              and cap_err["/split"] <= STEP_LOSS_TOL
              and r["capacity_grad_rel_l2_max/split"] <= STEP_TOL,
              f"{label} capacity backward 4 x 256 against one device's "
              f"capacity path under the rank's split: "
              f"{sum(r['moved']['capacity_backward/split'])} assignments "
              f"moved, loss {cap_err['/split']:.3e} (bound "
              f"{STEP_LOSS_TOL}), gradient leaves max "
              f"{r['capacity_grad_rel_l2_max/split']:.3e} (bound "
              f"{STEP_TOL})")
        check(cap_err[""] <= EP_WIDE_LOSS_REL
              and r["capacity_grad_rel_l2_max"] <= EP_WIDE_GRAD_REL_L2,
              f"{label} capacity backward 4 x 256 against one device's "
              f"ragged path as it runs: loss {cap_err['']:.3e} (bound "
              f"{EP_WIDE_LOSS_REL}), gradient leaves max "
              f"{r['capacity_grad_rel_l2_max']:.3e} (bound "
              f"{EP_WIDE_GRAD_REL_L2})")
        r["capacity_loss_rel_err"] = cap_err
        vp, n = r["vs_plain"], small.n_layers
        # the backward kernels run on the card only (the CPU's backward is
        # the plain one)
        check(vp["calls"] == {
            "route_select": 6 * n, "ragged_moe_ffn": 4 * n,
            "fused_moe_ffn": 2 * n} | ({
                "ragged_moe_ffn_dgrad": n, "ragged_moe_ffn_wgrad": n,
                "moe_ffn_dgrad": n, "moe_ffn_wgrad": n,
                "route_select_bwd": 2 * n} if on_card else {}),
              f"{label}: kernel calls held against their plain versions "
              f"{vp['calls']}")
        bounds = {"ragged_moe_ffn": BF16_TOL, "fused_moe_ffn": BF16_TOL,
                  "route_select": ROUTER_W_TOL,
                  "ragged_moe_ffn_dgrad": BWD_TOL,
                  "ragged_moe_ffn_wgrad": BWD_TOL,
                  "moe_ffn_dgrad": BWD_TOL, "moe_ffn_wgrad": BWD_TOL,
                  "route_select_bwd": ROUTER_W_TOL}
        check(vp["route_mismatch"] == 0
              and all(vp["err"].get(k, 0.0) <= b for k, b in bounds.items()),
              f"{label}: kernels vs plain at the ranks' shapes: "
              f"{vp['route_mismatch']} routing entries differ outside near "
              f"ties; errors {vp['err']} (bounds {bounds})")
    for path in ("prefill", "capacity", "prefill_wide"):
        check(len({r[f"{path}_digest"] for r in ranks}) == 1,
              f"ep 4 {path}: the ranks' logits differ")
    del params2, ref2, inputs
    _free_shared()
    grid_fsdp = grid_fsdp_hold(small, wide, on_card)
    gib = 2 ** 30
    vs_plain = ranks[0]["vs_plain"] | {
        "err": {k: max(r["vs_plain"]["err"][k] for r in ranks)
                for k in ranks[0]["vs_plain"]["err"]}}
    summary = {
        "ep4": {
            "wall_s": {p: [r["seconds"][p] for r in ranks]
                       for p in ranks[0]["seconds"]},
            "exchange": {p: [r["exchange"][p] for r in ranks]
                         for p in ranks[0]["exchange"]},
            "peak_gib": [r["peak_bytes"] / gib for r in ranks],
            "parent_gib": parent_gib,
            "max_abs_logit_err": {p: max(r["err"][p] for r in ranks)
                                  for p in ranks[0]["err"]},
            "logit_rel_l2": {p: max(r["rel"][p] for r in ranks)
                             for p in ranks[0]["rel"]},
            "moved": {p: max(sum(r["moved"][p]) for r in ranks)
                      for p in ranks[0]["moved"] if "decode" not in p}
            | {p: max(sum(map(sum, r["moved"][p])) for r in ranks)
               for p in ("decode", "decode/exact")},
            "near_tie_rows": sum(near), "near_tie_rows_wide": sum(near_wide),
            "decode_near_tie_rows": sum(map(sum, dec_near)),
            "decode_flips": ranks[0]["decode_flips"],
            "loss": ranks[0]["loss"], "loss_single_rank": loss_ref[""],
            "loss_single_rank_split": loss_ref["/split"],
            "grad_rel_l2_max": max(r["grad_rel_l2_max"] for r in ranks),
            "grad_rel_l2_max_split": max(r["grad_rel_l2_max/split"]
                                         for r in ranks),
            "grad_leaves": ranks[0]["grad_leaves"],
            "capacity_backward": {
                "loss": ranks[0]["capacity_loss"],
                "loss_single_rank_capacity_split":
                    loss_ref["_capacity/split"],
                "loss_rel_err": {w: max(r["capacity_loss_rel_err"][w]
                                        for r in ranks)
                                 for w in ("", "/split")},
                "grad_rel_l2_max": max(r["capacity_grad_rel_l2_max"]
                                       for r in ranks),
                "grad_rel_l2_max_split": max(
                    r["capacity_grad_rel_l2_max/split"] for r in ranks),
                "drops": [r["capacity_backward_drops"] for r in ranks]},
            "vs_plain_2_layers": vs_plain,
            "launches_rank0": ranks[0]["launches"]},
        "grid_fsdp": grid_fsdp,
        "phase_s": {"single_rank_reference": t_ref, "ranks": t_ranks,
                    "ep4_rank0_sections": ranks[0]["section_s"],
                    "grid_fsdp_rank0_s": wide[0]["plan_s"],
                    "all": time.perf_counter() - t_start}}
    e4 = summary["ep4"]
    for p, walls in e4["wall_s"].items():
        print(f"[ep] ep 4, {p}: host wall per rank "
              f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms", flush=True)
    for p, ex in e4["exchange"].items():
        print(f"[ep] ep 4, {p} with the exchanges timed (each synchronised):"
              f" " + "; ".join(
                  f"rank {i} {x['exchange_s'] * 1e3:.1f} of "
                  f"{x['wall_s'] * 1e3:.1f} ms ({100 * x['exchange_s'] / x['wall_s']:.1f}%), "
                  f"{x['calls']} calls, {x['bytes'] / 2**20:.3f} MiB"
                  for i, x in enumerate(ex)), flush=True)
    print(f"[ep] ep 4 against the single rank: max |logit difference| "
          f"{json.dumps(e4['max_abs_logit_err'])} (bound {BF16_TOL}), "
          f"relative L2 {json.dumps(e4['logit_rel_l2'])}; assignments "
          f"moved {json.dumps(e4['moved'])} ({sum(near)} near-tie rows in "
          f"the single rank's 2 x 256 prefill, {sum(near_wide)} at 4 x 256,"
          f" {e4['decode_near_tie_rows']} in its {EP_DECODE_STEPS} decode "
          f"steps); loss at "
          f"4 x 256 {e4['loss']:.6f} vs {loss_ref['']:.6f} (one device) and "
          f"{loss_ref['/split']:.6f} (one device, the rank's split); "
          f"gradient leaves' relative L2 max {e4['grad_rel_l2_max']:.3e} "
          f"(bound {EP_WIDE_GRAD_REL_L2}) and "
          f"{e4['grad_rel_l2_max_split']:.3e} (bound {STEP_TOL}) over "
          f"{e4['grad_leaves']} leaves; peak memory per rank "
          f"{', '.join(f'{v:.2f}' for v in e4['peak_gib'])} GiB (the "
          f"parent holds {parent_gib:.2f} GiB: weights, results and "
          f"both references' gradients)", flush=True)
    cb = e4["capacity_backward"]
    walls = {p: ", ".join(f"{w * 1e3:.1f}" for w in e4["wall_s"][p])
             for p in ("backward", "capacity_backward")}
    print(f"[ep] ep 4 capacity backward 4 x 256 (the a2a capacity body at "
          f"factor 8, the bucket K1 and K2 on each rank): loss "
          f"{cb['loss']:.6f} vs {cb['loss_single_rank_capacity_split']:.6f} "
          f"(one device's capacity path under the rank's split; relative "
          f"{cb['loss_rel_err']['/split']:.3e}) and {loss_ref['']:.6f} (one "
          f"device's ragged path as it runs; {cb['loss_rel_err']['']:.3e}); "
          f"gradient leaves' relative L2 max {cb['grad_rel_l2_max_split']:.3e}"
          f" (bound {STEP_TOL}) and {cb['grad_rel_l2_max']:.3e} (bound "
          f"{EP_WIDE_GRAD_REL_L2}); drops {cb['drops']}; host wall per rank "
          f"{walls['capacity_backward']} ms (the ragged backward "
          f"{walls['backward']})", flush=True)
    print(f"[ep] ep 4 decode against one device: lanes whose experts "
          f"differ, as (step, lane, first layer, the single rank's gap to a "
          f"tie there): {json.dumps(e4['decode_flips'])}", flush=True)
    print(f"[ep] ep 4, each kernel call against its plain version on the "
          f"same inputs at the ranks' shapes (2 layers; worst rank): "
          f"{json.dumps(vs_plain)}", flush=True)
    print(f"[ep] ep 4 launches per rank (rank 0; every rank the same): "
          f"{json.dumps(e4['launches_rank0'])}", flush=True)
    print(f"[ep] phase wall {summary['phase_s']['all']:.1f} s (single-rank "
          f"references {t_ref:.1f}, the ranks {t_ranks:.1f}: ep 4, rank 0 "
          f"by path {json.dumps(ranks[0]['section_s'])}, then (l) "
          f"{wide[0]['plan_s']:.1f} s with its grid's groups)", flush=True)
    return summary


def grid_fsdp_hold(cfg, wide, on_card):
    """Check plan (l)'s numbers from every rank (``wide``:
    :func:`grid_plan_rank`'s), print them and return their summary."""
    n = cfg.n_layers
    step = {k: n for k in (
        "route_select", "ragged_moe_ffn", "ragged_moe_ffn.tma",
        "flash_attn_fwd", "ragged_moe_ffn_dgrad", "ragged_moe_ffn_dgrad.tma",
        "ragged_moe_ffn_wgrad", "ragged_moe_ffn_wgrad.tma",
        "route_select_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkdv")}
    want = {"backward": step, "backward_narrow": step, "adamw": {}}
    for r in wide:
        label = f"(l) FSDP over (pod, data) on (2, 2, 1) rank {r['rank']}"
        for path, counts in r["launches"].items():
            for k in set(counts) | set(want[path]):
                w = want[path].get(k, 0)
                check(counts.get(k, 0) == w or not on_card,
                      f"{label} {path}: {k} launched {counts.get(k, 0)} "
                      f"times, expected {w}")
        b, nw, st = r["backward"], r["narrow"], r["step"]
        check(nw["loss_equal"] and nw["tallies_equal"]
              and nw["grad_leaves_equal"] == nw["grad_leaves"],
              f"{label} against FSDP over data: loss equal "
              f"{nw['loss_equal']}, tallies equal {nw['tallies_equal']}, "
              f"{nw['grad_leaves_equal']} of {nw['grad_leaves']} gradient "
              f"leaves bit for bit")
        # | |a| / |b| - 1 | <= |a - b| / |b|: the gradients' bound holds
        # the experts' norm ratio too, which a sum over the "pod" ranks'
        # same rows would read as 2
        check(b["loss_rel"] <= EP_WIDE_LOSS_REL
              and b["grad_rel_l2_max"] <= EP_WIDE_GRAD_REL_L2
              and abs(b["expert_norm_ratio"] - 1) <= EP_WIDE_GRAD_REL_L2,
              f"{label} against one device: loss {b['loss_rel']:.3e} (bound "
              f"{EP_WIDE_LOSS_REL}), gradient leaves max "
              f"{b['grad_rel_l2_max']:.3e} (bound {EP_WIDE_GRAD_REL_L2}), "
              f"the experts' gradient norm ratio {b['expert_norm_ratio']}")
        check(st["witness_leaves_equal"] == nw["grad_leaves"],
              f"{label} AdamW under the narrow norm's clip: "
              f"{st['witness_leaves_equal']} of {nw['grad_leaves']} leaves "
              f"bit for bit")
        check(st["norm_rel"] <= GRID_FSDP_NORM_REL
              and st["max_abs"] <= GRID_FSDP_STEP_ABS,
              f"{label} AdamW as it runs against FSDP over data: the norm "
              f"{st['norm_rel']:.3e} relative (bound {GRID_FSDP_NORM_REL}), "
              f"params' max |difference| {st['max_abs']:.3e} (bound "
              f"{GRID_FSDP_STEP_ABS}) in {st['leaves_differing']} leaves")
    gib = 2 ** 30
    w0 = wide[0]
    out = {"wall_s": {p: [r["seconds"][p] for r in wide]
                      for p in w0["seconds"]},
           "peak_gib": [r["peak_bytes"] / gib for r in wide],
           "mesh_s": [r["mesh_s"] for r in wide],
           "launches_rank0": w0["launches"],
           "backward": {k: max(r["backward"][k] for r in wide)
                        for k in ("loss_rel", "grad_rel_l2_max")},
           "moved_vs_one_device": [sum(r["backward"]["moved"])
                                   for r in wide],
           "expert_norm_ratio": [r["backward"]["expert_norm_ratio"]
                                 for r in wide],
           "narrow": w0["narrow"], "step": [r["step"] for r in wide],
           "loss": w0["backward"]["loss"]}
    walls = "; ".join(f"{p} {', '.join(f'{w * 1e3:.1f}' for w in ws)}"
                      for p, ws in out["wall_s"].items())
    print(f"[ep] (l) FSDP over (pod, data) on (2, 2, 1), the batch over "
          f"data, 2 layers at 4 x 256: host wall per rank (ms) {walls}; "
          f"peak {', '.join(f'{v:.2f}' for v in out['peak_gib'])} GiB; the "
          f"grid's groups {max(out['mesh_s']):.1f} s; launches rank 0 "
          f"{json.dumps(out['launches_rank0'])}", flush=True)
    print(f"[ep] (l) against FSDP over data on the same ranks: loss, "
          f"tallies and {out['narrow']['grad_leaves']} gradient leaves bit "
          f"for bit; against one device: loss {out['loss']:.6f} "
          f"({out['backward']['loss_rel']:.3e}), gradient leaves' relative "
          f"L2 max {out['backward']['grad_rel_l2_max']:.3e}, assignments "
          f"moved {out['moved_vs_one_device']}, the experts' gradient norm "
          f"ratio {json.dumps(out['expert_norm_ratio'])}; AdamW: "
          f"{json.dumps(out['step'])}", flush=True)
    return out


def remat_phase(cfg, dev):
    """Phase 14: per-block remat (``ShardingRules(remat=True)``) on the
    full-width training step: the loss and every gradient equal to those
    without remat (one loss and backward each, same weights and batch),
    then the step profile at 8 x 512 (which peaks at 77.06 GiB without
    remat on an H100 80GB HBM3) and at 4 x 1024."""
    import torch
    from repro_torch.models import (init_params, loss_fn, make_moe_tables,
                                    ShardingRules)
    from repro_torch.training import DataConfig, synthetic_batch
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    rules = ShardingRules(remat=True)
    b = {k: torch.as_tensor(v, device=dev) for k, v in synthetic_batch(
        cfg, DataConfig(seq_len=512, global_batch=8), 0).items()}
    mt = make_moe_tables(cfg, device=dev)
    out = {}
    for name, r in (("remat", rules), ("plain", None)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        params = init_params(cfg, gen, device=dev)
        for p in leaves(params):
            p.requires_grad_(True)
        loss, _ = loss_fn(cfg, r)(params, b, mt)
        loss.backward()
        torch.cuda.synchronize()
        out[name] = (loss.detach(), [p.grad for p in leaves(params)],
                     torch.cuda.max_memory_allocated())
        del params, loss
    (l1, g1, pk1), (l0, g0, pk0) = out["remat"], out["plain"]
    same = bool(torch.equal(l1, l0)) and all(
        bool(torch.equal(a, c)) for a, c in zip(g1, g0))
    worst = max(_rel_l2(a, c) for a, c in zip(g1, g0))
    check(same, f"remat: loss {l1.item()} vs {l0.item()}, gradients differ "
          f"(largest relative L2 {worst:.3e})")
    del out, g1, g0
    print(f"[remat] 8 x 512, one loss and backward (no optimizer state): "
          f"loss {l1.item():.6f} and all gradient leaves bit for bit equal "
          f"with and without remat; peak {pk1 / 2**30:.2f} GiB with, "
          f"{pk0 / 2**30:.2f} GiB without", flush=True)
    res = {"bit_equal": same, "grad_peak_gib": {"remat": pk1 / 2**30,
                                                "plain": pk0 / 2**30}}
    res["step_8x512"] = train_step_profile(cfg, dev, seq_len=512, batch=8,
                                           steps=2, rules=rules)
    res["step_4x1024"] = train_step_profile(cfg, dev, seq_len=1024, batch=4,
                                            steps=2, rules=rules)
    res["phase_s"] = time.perf_counter() - t0
    print(f"[remat] phase wall {res['phase_s']:.1f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# phase 15: tensor parallelism of the dense layers over ranks sharing the card
# ---------------------------------------------------------------------------

TP_DECODE_STEPS = 2
TP_LANES = 8
TP_S_MAX = 1024
# lane j decodes from position 120 j: in context mode each rank's quarter
# of the 1024 cache rows holds some lane's rows
TP_LANE_STRIDE = 120
# Against one device as it runs (the witness holds bit for bit): the
# ranks' bf16 sums of wo's and the MLP's partials, and the context merge's
# rescaled f32 stats, round otherwise than one device, and over 32 random-
# weight layers that moves routing. Per run: the logits' relative L2 by
# path, the loss's relative error and the gradient leaves' largest
# relative L2, set at about twice the readings on an H100 80GB HBM3
# (PERF.md, "Tensor parallelism"); the context prefill computes the same
# products on fewer rows and reads bit for bit.
# Readings (prefill, decode, loss, gradients): heads 0.0341, 0.0346,
# 3.95e-5, 8.255e-02; context 0.0, 0.0297; smollm 0.0195, 0.0196, 3.7e-7,
# 3.366e-02; fsdp 0.0140, -, 1.175e-4, 8.245e-02. smollm's loss with the
# attention kernel in the training forward (both sides): 4.32e-6, where
# the attention's rounding alone (kernel against plain, one device) moves
# its loss by 1.04e-5 and neither moves the logits from f32's more than
# the other (1.97e-2 and 2.00e-2; scripts/loss_rounding.py)
TP_BOUNDS = {
    "heads": {"prefill": 7e-2, "decode": 7e-2, "loss": 1e-4, "grads": 0.17},
    "context": {"prefill": 0.0, "decode": 6e-2},
    "smollm": {"prefill": 4e-2, "decode": 4e-2, "loss": 1e-5, "grads": 7e-2},
    # (k), the dense oracle: phase 13's bounds against one device at 4 x 256
    "dense": {"prefill": EP_WIDE_LOGIT_REL_L2, "loss": EP_WIDE_LOSS_REL,
              "grads": EP_WIDE_GRAD_REL_L2},
}


# phase 16: the batch over dp and the sequence-sharded residual
SP_STEPS = 2
# Against one device as it runs, per run (the witness holds bit for bit):
# the logits' relative L2 by path, the loss's relative error and the
# gradient leaves' largest relative L2, set at about twice the readings on
# an H100 80GB HBM3 at 700 W (PERF.md, "Each rank's rows").
# Readings (prefill, decode, loss, gradients): dp_sp 0.0446, 0.0348,
# 5.3e-5, 0.1154; jamba at its smoke size 0.1441, 0.0822, 2.958e-4,
# 0.2802 (14 of 4096 assignments moved: small random-weight logits). With
# the attention kernel in the training forward (both sides): dp_sp 5.95e-5
# and 9.753e-02, jamba 8.146e-4 and 0.3238 (25 assignments moved; the
# attention's rounding alone moves a loss's last digits,
# scripts/loss_rounding.py).
SP_BOUNDS = {
    "dp_sp": {"prefill": 9e-2, "decode": 7e-2, "loss": 1.1e-4,
              "grads": 0.23},
    "jamba": {"prefill": 0.29, "decode": 0.17, "loss": 1.7e-3,
              "grads": 0.56},
    # (g), xlstm-350m at full depth in bf16: its logits and gradients
    # drift far from one device's from the last bits up (as its chunkwise
    # and stepwise forms do, phase 10), so these hold little beyond
    # finiteness; the witness holds the ranks bit for bit. Readings
    # 0.8057, 0.4649, 2.796e-3, 1.559 (PERF.md, "The recurrent mixers on
    # the grid").
    "xlstm": {"prefill": 1.6, "decode": 0.93, "loss": 5.6e-3, "grads": 3.2},
    # (e): the params and state after each AdamW step as the port runs it
    # (gloo's order of the norm's partials) against the witness's
    # (reading 4.41e-6 at the second step, 0.0 at the first)
    "step": {"step": 9e-6},
}


def _in_order(parts):
    """The parts summed left to right, in rank order."""
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    return total


def _ordered_sum():
    """``sum_partials`` as an all_gather summed in rank order: every rank
    and the one-device witness add the same parts in the same order (gloo's
    all_reduce adds in its own). Backward: the gradient passes, as
    ``sum_partials``'s."""
    import torch
    import torch.distributed as dist

    class OrderedSum(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            parts = [torch.empty_like(x)
                     for _ in range(dist.get_world_size(group))]
            dist.all_gather(parts, x.contiguous(), group=group)
            return _in_order(parts)

        @staticmethod
        def backward(ctx, g):
            return g, None

    return lambda x, group: x if group is None else OrderedSum.apply(x,
                                                                     group)


def _ordered_parts(x, group):
    """Every rank's ``x`` of ``group``, in rank order (an all_gather)."""
    import torch
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def _ordered_scatter():
    """``scatter_partials`` as an all_gather summed in rank order, then the
    rank's rows: the sum one device adds in the same order. Backward: the
    all-gather of the gradient, as ``scatter_partials``'s."""
    import torch
    import torch.distributed as dist

    class OrderedScatter(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group, dim):
            ctx.group, ctx.dim = group, dim
            total = _in_order(_ordered_parts(x, group))
            return total.chunk(dist.get_world_size(group), dim)[
                dist.get_rank(group)].contiguous()

        @staticmethod
        def backward(ctx, g):
            return torch.cat(_ordered_parts(g, ctx.group), ctx.dim), None, \
                None

    return lambda x, group, dim=1: (x if group is None else
                                    OrderedScatter.apply(x, group, dim))


def _ordered_mean():
    """``mean_over`` as an all_gather summed in rank order over the group's
    size; backward ``g / n``, as ``mean_over``'s."""
    import torch
    import torch.distributed as dist

    class OrderedMean(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, group):
            ctx.n = dist.get_world_size(group)
            return _in_order(_ordered_parts(x, group)) / ctx.n

        @staticmethod
        def backward(ctx, g):
            return g / ctx.n, None

    return lambda x, group: x if group is None else OrderedMean.apply(x,
                                                                      group)


class ordered_partials:
    """On the ranks, within the block: the model's sums of rank partials
    (wo's in heads mode, reduce-scattered back to the rank's rows under
    sequence parallelism, the context decode's merge) and the mean of the
    loss over the ranks' rows added in rank order (:func:`_ordered_sum`,
    :func:`_ordered_scatter`, :func:`_ordered_mean`), and the MoE layer's
    mean of the ranks' mean probabilities; the MoE layer's other sums are
    left as they are; the recurrent mixers' sums (mLSTM's norm's sums of
    squares, Mamba's ``x_proj`` partials, the out-projections' partials,
    summed or reduce-scattered) in rank order too. With :func:`_witness`
    on one device, the witness of phases 15 and 16."""

    def __enter__(self):
        from repro_torch.models import model as tmodel
        from repro_torch.models import moe as tmoe
        from repro_torch.models import ssm as tssm
        self.saved = real, real_moe, real_ssm = tmodel.C, tmoe.C, tssm.C
        tmodel.C = _Collectives(real, sum_partials=_ordered_sum(),
                                scatter_partials=_ordered_scatter(),
                                mean_over=_ordered_mean())
        tmoe.C = _Collectives(real_moe, mean_over=_ordered_mean())
        tssm.C = _Collectives(real_ssm, sum_partials=_ordered_sum(),
                              scatter_partials=_ordered_scatter())
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        from repro_torch.models import moe as tmoe
        from repro_torch.models import ssm as tssm
        tmodel.C, tmoe.C, tssm.C = self.saved


class split_attention:
    """On one device, within the block: each attention layer computed as
    ``dp`` x ``ways`` ranks compute it, the lanes in ``dp`` blocks (each
    block a call of its own, as a rank of a ``dp`` group runs it) and
    within a block: ``"heads"``: each rank's contiguous block of KV heads
    with their query heads (its columns of wq, wk and wv, rows of wo and
    heads of the cache) on every row, the partial outputs added in rank
    order. ``"context"``: at prefill each rank's ``S/ways`` rows projected
    alone, the keys and values of all of them attended by each rank's
    queries, each rank's rows through wo; at decode the cache in ``ways``
    row shards, each written where it holds the lane's row and attended
    alone, the shards' softmax stats merged in rank order. A witness for
    the ranks (with :class:`ordered_partials` there), not a path of the
    port."""

    def __init__(self, mode, ways, dp=1):
        self.mode, self.ways, self.dp = mode, ways, dp

    def __enter__(self):
        import torch
        from repro_torch.models import model as tmodel
        self.saved = real = tmodel._run_attention
        split = self._heads if self.mode == "heads" else self._context
        dp = self.dp

        def run(p, x, cfg, rules, window, positions, cache=None, pos=None,
                seq=None):
            n = x.shape[0] // dp
            outs, kvs = [], []
            for b in range(dp):
                lanes = slice(b * n, (b + 1) * n)
                cb = None if cache is None else tuple(c[lanes]
                                                      for c in cache)
                out, st = split(real, p, x[lanes], cfg, window, positions,
                                cb, None if pos is None else pos[lanes])
                outs.append(out)
                kvs.append(st)
            if dp == 1:
                return outs[0], kvs[0]
            out = torch.cat(outs, 0)
            if cache is not None:
                return out, cache
            return out, tuple(torch.cat([kv[i] for kv in kvs], 0)
                              for i in range(2))

        tmodel._run_attention = run
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        tmodel._run_attention = self.saved

    def _heads(self, real, p, x, cfg, window, positions, cache, pos):
        import torch
        w = self.ways

        def cut(t, dim, r):
            n = t.shape[dim] // w
            return t.narrow(dim, r * n, n).contiguous()

        parts, ks, vs = [], [], []
        for r in range(w):
            pr = {k: cut(t, 0 if k == "wo" else 1, r) for k, t in p.items()}
            cr = None if cache is None else tuple(cut(c, 2, r)
                                                  for c in cache)
            out, st = real(pr, x, cfg, None, window, positions, cache=cr,
                           pos=pos)
            if cache is None:
                ks.append(st[0])
                vs.append(st[1])
            else:
                for c, new in zip(cache, cr):
                    n = c.shape[2] // w
                    c[:, :, r * n:(r + 1) * n] = new
            parts.append(out)
        total = _in_order(parts)
        if cache is None:
            return total, (torch.cat(ks, 2), torch.cat(vs, 2))
        return total, cache

    def _context(self, real, p, x, cfg, window, positions, cache, pos):
        import torch
        from repro_torch.models import model as tmodel
        from repro_torch.kernels.ops import flash_attention, flash_decode
        w = self.ways
        B, S, _ = x.shape
        if cache is None:
            if S % w:
                return real(p, x, cfg, None, window, positions)
            n = S // w
            qkv = [tmodel._qkv(p, x[:, r * n:(r + 1) * n], cfg,
                               positions[r * n:(r + 1) * n][None, :])
                   for r in range(w)]
            k = torch.cat([t[1] for t in qkv], 1)
            v = torch.cat([t[2] for t in qkv], 1)
            outs = [flash_attention(
                q, k, v, causal=cfg.causal, window=window,
                q_positions=positions[r * n:(r + 1) * n],
                kv_positions=positions).reshape(B, n, -1) @ p["wo"]
                for r, (q, _, _) in enumerate(qkv)]
            return torch.cat(outs, 1), (k, v)
        k_cache, v_cache = cache
        n = k_cache.shape[1] // w
        q, k, v = tmodel._qkv(p, x, cfg, pos[:, None])
        rows = pos.long()
        lanes = torch.arange(B, device=x.device)
        stats = []
        for r in range(w):
            off = r * n
            shard = [c[:, off:off + n].contiguous() for c in cache]
            upd = rows - off
            owned = ((upd >= 0) & (upd < n))[:, None, None]
            safe = upd.clamp(0, n - 1)
            for cbuf, new in zip(shard, (k[:, 0], v[:, 0])):
                cbuf[lanes, safe] = torch.where(owned, new.to(cbuf.dtype),
                                                cbuf[lanes, safe])
            stats.append(flash_decode(q[:, 0], *shard, rows, window=window,
                                      kpos_offset=off, return_stats=True))
            for c, s in zip(cache, shard):
                c[:, off:off + n] = s
        m_g = stats[0][1]
        for _, m, _ in stats[1:]:
            m_g = torch.maximum(m_g, m)
        num = _in_order([acc * torch.exp(m - m_g)[..., None]
                         for acc, m, _ in stats])
        den = _in_order([l * torch.exp(m - m_g) for _, m, l in stats])
        out = (num / torch.clamp(den, min=1e-30)[..., None]).to(q.dtype)
        return out.reshape(B, 1, -1) @ p["wo"], cache


class split_mixers:
    """On one device, within the block: each mLSTM and sLSTM mixer
    computed as ``dp`` x ``tp`` ranks compute it where it splits by heads
    (``rules.mixer_split``): each ``dp`` block of the lanes a call of its
    own, and within it each rank's slices of the mixer's leaves
    (``param_cuts``) and of its state (its heads), mLSTM's norm over the
    ranks' sums of squares added in rank order, the out-projection's
    partials added in rank order, the states put back together. A witness
    for the ranks (with :class:`ordered_partials` there), not a path of
    the port."""

    def __init__(self, cfg, tp, dp):
        from repro_torch.launch.mesh import Grid
        from repro_torch.launch.sharding import make_rules, param_cuts
        from repro_torch.models.model import block_layout
        self.tp, self.dp = tp, dp
        _, specs = block_layout(cfg)
        self.grids = [Grid((dp, tp), EP_AXES, r, {}) for r in range(tp)]
        self.cuts = [dict() for _ in range(tp)]
        for r, grid in enumerate(self.grids):
            rules = make_rules(cfg, grid, "train")
            blocks = param_cuts(cfg, rules)["blocks"]
            for spec, sub in zip(specs, blocks):
                if spec.mixer in ("mlstm", "slstm"):
                    if not rules.mixer_split(cfg, spec.mixer):
                        raise ValueError(f"{cfg.name}: {spec.mixer} does "
                                         f"not split over {tp}")
                    self.cuts[r][spec.mixer] = sub["mixer"]
                elif spec.mixer == "mamba":
                    raise NotImplementedError("split_mixers: Mamba")

    def __enter__(self):
        import functools
        from repro_torch.models import model as tmodel
        self.saved = dict(tmodel._SEQ), dict(tmodel._STEP)
        for kind in self.cuts[0]:
            tmodel._SEQ[kind] = functools.partial(self._run, kind, 128)
            tmodel._STEP[kind] = functools.partial(self._run, kind, 1)
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        tmodel._SEQ.update(self.saved[0])
        tmodel._STEP.update(self.saved[1])

    def _run(self, kind, chunk, p, x, state=None):
        import torch
        import torch.nn.functional as F
        from repro_torch.launch.sharding import cut_tree
        from repro_torch.models import ssm
        n = x.shape[0] // self.dp
        outs, states = [], []
        for b in range(self.dp):
            xb = x[b * n:(b + 1) * n]
            parts, hs, zs, sts = [], [], [], []
            for r, grid in enumerate(self.grids):
                pr = {k: cut_tree(w[None], self.cuts[r][kind][k], grid)[0]
                      for k, w in p.items()}
                sr = None
                if state is not None:
                    sr = {k: v[b * n:(b + 1) * n].chunk(self.tp, 1)[r]
                          .contiguous() for k, v in state.items()}
                if kind == "slstm":
                    part, st = ssm.slstm_seq(pr, xb, sr)
                    parts.append(part)
                else:
                    h, z, st = ssm._mlstm_heads(pr, xb, sr, chunk)
                    hs.append((h, z, pr))
                sts.append(st)
            if kind == "mlstm":
                ss = _in_order([ssm._sq_sum(h) for h, _, _ in hs])
                width = hs[0][0].shape[-1] * self.tp
                parts = [(ssm._norm_with(h, ss, width, pr["ln_scale"])
                          * F.silu(z)) @ pr["down"] for h, z, pr in hs]
            outs.append(_in_order(parts))
            states.append({k: torch.cat([st[k] for st in sts], 1)
                           for k in sts[0]})
        return torch.cat(outs, 0), {k: torch.cat([st[k] for st in states],
                                                 0) for k in states[0]}


def _vocab_xent(hidden, ws, labels, n_chunks):
    """``softmax_xent_chunked`` of one rank's rows as the ranks over which
    the vocabulary splits compute it, their slices ``ws`` of the
    unembedding on one device: each slice's logits, the shift their
    maximum, the sums of exponentials and the gold logits added in rank
    order."""
    import torch
    B, S, _ = hidden.shape
    if S % n_chunks:
        n_chunks = 1
    rows, n = S // n_chunks, ws[0].shape[1]
    total = None
    for i in range(n_chunks):
        hc = hidden[:, i * rows:(i + 1) * rows]
        yc = labels[:, i * rows:(i + 1) * rows].long()
        logits = [(hc @ w).float() for w in ws]
        m = logits[0].detach().amax(dim=-1)
        for lg in logits[1:]:
            m = torch.maximum(m, lg.detach().amax(dim=-1))
        tot = _in_order([torch.exp(lg - m[..., None]).sum(dim=-1)
                         for lg in logits])
        golds = []
        for r, lg in enumerate(logits):
            local = yc - r * n
            mine = (local >= 0) & (local < n)
            g = torch.gather(lg, -1, local.clamp(0, n - 1)[..., None])[..., 0]
            golds.append(torch.where(mine, g, torch.zeros_like(g)))
        part = torch.sum((m + torch.log(tot)) - _in_order(golds))
        total = part if total is None else total + part
    return total / (B * S)


class split_rows:
    """On one device, within the block: the row-wise steps as ranks that
    split the batch over ``dp`` and the sequence over ``tp`` run them:
    every norm and the logits on each of ``dp`` blocks of a ``batch``-lane
    call's rows, and the loss's cross entropy on each rank's (``batch/dp``,
    ``S/tp``) rows (every position where the vocabulary splits over
    ``tp``: ``tp=1``), averaged in rank order; where the vocabulary splits
    over ``vocab_tp`` ranks, the logits and the cross entropy (its
    :func:`_vocab_xent`) of each of their slices. With
    :class:`split_attention` and :class:`split_routing`, the witness of
    phases 15 and 16."""

    def __init__(self, dp, tp, batch, vocab_tp=1):
        self.dp, self.tp, self.piece = dp, tp, max(batch // dp, 1)
        self.vocab_tp = vocab_tp

    def __enter__(self):
        import torch
        from repro_torch.models import model as tmodel
        self.saved = (tmodel.rms_norm, tmodel._logits,
                      tmodel.softmax_xent_chunked)
        norm, logits, xent = self.saved
        piece, dp, tp, vtp = self.piece, self.dp, self.tp, self.vocab_tp

        def rms_norm(x, scale, eps=1e-6):
            if x.shape[0] <= piece:
                return norm(x, scale, eps)
            return torch.cat([norm(t, scale, eps)
                              for t in x.split(piece, 0)], 0)

        def slices(w):
            return [c.contiguous() for c in w.chunk(vtp, 1)]

        def split_logits(cfg, params, x, rules=None, rows=None):
            if vtp == 1:
                return torch.cat([logits(cfg, params, t)
                                  for t in x.split(piece, 0)], 0)
            ws = slices(tmodel._unembed_w(cfg, params))
            return torch.cat([torch.cat(
                [norm(t, params["final_norm"], cfg.norm_eps)[:, -1].float()
                 @ w.float() for w in ws], 1) for t in x.split(piece, 0)], 0)

        def split_xent(hidden, w, labels, n_chunks=8, group=None,
                       vocab_offset=0, denom=None):
            # one device: ``denom`` is the call's count of labels, whose
            # mean the parts' mean is
            if vtp > 1:
                parts = [_vocab_xent(h, slices(w), y, n_chunks)
                         for h, y in zip(hidden.split(piece, 0),
                                         labels.split(piece, 0))]
                return _in_order(parts) / len(parts)
            S = hidden.shape[1]
            n = S // tp
            parts = [xent(h[:, r * n:(r + 1) * n], w,
                          y[:, r * n:(r + 1) * n], n_chunks)
                     for h, y in zip(hidden.split(piece, 0),
                                     labels.split(piece, 0))
                     for r in range(tp)]
            return _in_order(parts) / len(parts)

        tmodel.rms_norm = rms_norm
        tmodel._logits = split_logits
        tmodel.softmax_xent_chunked = split_xent
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        (tmodel.rms_norm, tmodel._logits,
         tmodel.softmax_xent_chunked) = self.saved


def tp_inputs(cfg, dev, seed, batch, params, s_max=TP_S_MAX):
    """Tokens and labels (``batch`` x 256), ``TP_DECODE_STEPS`` decode
    steps of 8 lanes at positions 120 j + i, and the whole decode cache
    they start from: one
    device's prefill of 8 prompts of ``s_max`` tokens (lane j's rows past
    120 j are masked, then overwritten, by its decode; a recurrent
    mixer's state is the prompt's whole)."""
    import torch
    from repro_torch.models import make_moe_tables, prefill_fn
    g = torch.Generator().manual_seed(seed)
    V = cfg.vocab
    prompts = torch.randint(0, V, (TP_LANES, s_max), generator=g)
    with torch.no_grad():
        _, cache, _ = prefill_fn(cfg)(params, {"tokens": prompts.to(dev)},
                                      make_moe_tables(cfg, device=dev))
    return {
        "tokens": torch.randint(0, V, (batch, 256), generator=g).to(dev),
        "labels": torch.randint(0, V, (batch, 256), generator=g).to(dev),
        "dec_tokens": torch.randint(0, V, (TP_DECODE_STEPS, TP_LANES, 1),
                                    generator=g).to(dev),
        "pos": (torch.arange(TP_LANES, dtype=torch.int32)
                * TP_LANE_STRIDE).to(dev),
        "cache": cache}


class split_routing:
    """On one device, within the block: each routing call on a ``(B, S)``
    call's rows made as the ranks make it, on each rank's a2a block
    (``B/dp`` rows, ``S/ep`` positions) alone, the blocks' tallies summed
    and their mean probabilities averaged in rank order, and the aux loss
    from those, as the a2a bodies compute it. A witness for the ranks
    (with :class:`ordered_partials` there), not a path of the port."""

    def __init__(self, dp, ep, B, S):
        self.dp, self.ep, self.B, self.S = dp, ep, B, S

    def __enter__(self):
        import torch
        from repro_torch.kernels import ref
        from repro_torch.models import moe as tmoe
        self.saved = real = tmoe.ops
        dp, ep, B, S = self.dp, self.ep, self.B, self.S
        b, s = B // dp, S // ep

        class Ops:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def route_select(xf, w, *args, **kw):
                x = xf.reshape(B, S, -1)
                outs = [[real.route_select(
                    x[i * b:(i + 1) * b, j * s:(j + 1) * s].reshape(
                        b * s, -1), w, *args, **kw) for j in range(ep)]
                    for i in range(dp)]

                def whole(k):
                    return torch.cat([torch.cat(
                        [o[k].reshape((b, s) + o[k].shape[1:]) for o in row],
                        1) for row in outs], 0).reshape(
                            (B * S,) + outs[0][0][k].shape[1:])

                flat = [o for row in outs for o in row]
                tally = _in_order([o[3] for o in flat])
                mean_prob = _in_order([o[4] for o in flat]) / len(flat)
                E = w.shape[1]
                return (whole(0), whole(1), whole(2), tally, mean_prob,
                        ref.aux_loss(tally[:E], mean_prob, E))

        tmoe.ops = Ops()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as tmoe
        tmoe.ops = self.saved


def _witness(w, path, batch, seq):
    """The one-device witness of a plan whose ranks split attention by
    ``w["mode"]`` over ``w["tp"]``, the batch over ``w["dp"]`` and the
    experts over ``w["ep"]``, for a ``path`` of ``batch`` lanes and
    ``seq`` positions: :class:`split_attention`, :class:`split_rows`,
    :class:`split_mixers` where ``w["mixers"]`` (the config) has mixers
    split over ``tp`` and, outside decode (where every rank routes the
    whole batch) and the dense oracle (``w["dense"]``: every rank routes
    the whole batch too), :class:`split_routing` over the ranks' a2a
    blocks."""
    import contextlib
    stack = contextlib.ExitStack()
    stack.enter_context(split_attention(w["mode"], w["tp"], w["dp"]))
    if w.get("mixers") is not None:
        stack.enter_context(split_mixers(w["mixers"], w["tp"], w["dp"]))
    stack.enter_context(split_rows(w["dp"], w["xent_tp"], batch,
                                   w["vocab_tp"]))
    if path != "decode" and not w.get("dense"):
        stack.enter_context(split_routing(w["dp"], w["ep"], batch, seq))
    return stack


def _plan_batch(inp):
    """A plan's loss batch: its ``batch`` (frames or patches), else its
    tokens and labels."""
    return inp.get("batch") or {"tokens": inp["tokens"],
                                "labels": inp["labels"]}


def _no_labels(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _grad_or_zeros(p):
    import torch
    return torch.zeros_like(p) if p.grad is None else p.grad


def tp_reference(cfg, dev, params, inputs, paths, witness=None, steps=None):
    """One device (``rules=None``) on ``params``: the prefill's logits and
    tallies, the first ``steps`` decode steps' (each from the one before,
    from the inputs' cache) and the loss, its gradients and tallies, as
    the port runs them and, with ``witness`` (:func:`_witness`'s), again
    under the witness (keys ``.../witness``). Returns the params (detached
    again) and the results."""
    import contextlib
    import torch
    from repro_torch.models import (decode_fn, loss_fn, make_moe_tables,
                                    prefill_fn)
    from repro_torch.models.model import _batch_shape
    from repro_torch.tree import leaves, tree_map
    tables = make_moe_tables(cfg, device=dev)
    ref = {}
    ways = [("", lambda path, batch: contextlib.nullcontext())]
    if witness is not None:
        ways.append(("/witness", lambda path, batch: _witness(
            witness, path, batch, seq)))
    dec = inputs["dec_tokens"][:steps] if "decode" in paths else None
    batch = _plan_batch(inputs)
    B, seq = _batch_shape(cfg, batch)
    for way, ctx in ways:
        with torch.no_grad():
            if "prefill" in paths:
                with ctx("prefill", B):
                    lg, _, tal = prefill_fn(cfg)(params, _no_labels(batch),
                                                 tables)
                ref["prefill" + way] = (lg, tal)
            if "decode" in paths:
                cache = tree_map(torch.clone, inputs["cache"])
                ref["decode" + way] = []
                with ctx("decode", dec.shape[1]):
                    for i, tok in enumerate(dec):
                        lg, cache, tal = decode_fn(cfg)(
                            params, tok, cache, inputs["pos"] + i, tables)
                        ref["decode" + way].append((lg, tal))
                del cache
        if "backward" in paths:
            for p in leaves(params):
                p.requires_grad_(True)
            with ctx("backward", B):
                loss, (tal, _) = loss_fn(cfg)(params, batch, tables)
                loss.backward()
            ref["loss" + way] = loss.detach()
            # a leaf the loss never reads (hubert's embedding): zeros
            ref["grads" + way] = tree_map(_grad_or_zeros, params)
            ref["backward_tally" + way] = tal.detach()
            params = tree_map(lambda p: p.detach(), params)
    return params, ref


def _dense_bytes(cfg, tree):
    """Bytes of the attention weights, the recurrent mixers', the dense
    MLPs' and the embedding and head in ``tree``."""
    from repro_torch.models.model import block_layout
    _, specs = block_layout(cfg)
    out = {"attention": 0, "mixers": 0, "mlp": 0, "embed_head": 0}
    for spec, sub in zip(specs, tree["blocks"]):
        out["attention" if spec.mixer == "attn" else "mixers"] += sum(
            t.numel() * t.element_size() for t in sub["mixer"].values())
        if spec.ffn == "dense":
            out["mlp"] += sum(t.numel() * t.element_size()
                              for t in sub["ffn"].values())
    for k in ("embed", "head"):
        if k in tree:
            out["embed_head"] += tree[k].numel() * tree[k].element_size()
    return out


class block_inputs:
    """Within the block, the residual stream entering a train-phase block:
    its shape (the rank's rows), and the bytes of one such input for each
    of the model's blocks, what per-block remat keeps for the backward."""

    def __init__(self, n_blocks):
        self.n_blocks = n_blocks

    def __enter__(self):
        from repro_torch.models import model as tmodel
        self.saved = real = tmodel._block_body
        self.bytes, self.shape = 0, None

        def body(*args, **kw):
            x = args[4]
            if kw.get("phase") == "train":
                self.bytes = self.n_blocks * x.numel() * x.element_size()
                self.shape = list(x.shape)
            return real(*args, **kw)

        tmodel._block_body = body
        return self

    def __exit__(self, *exc):
        from repro_torch.models import model as tmodel
        tmodel._block_body = self.saved


def _tp_vs_plain(cfg, rules_for, params, inp, dev):
    """On one rank, a prefill, one decode step and a loss and backward of
    the plan's model on its rules, each kernel call held against its plain
    version on the same inputs (:class:`hold_calls`; launches not
    counted). Returns the comparisons' numbers."""
    import torch
    from repro_torch.launch.sharding import (decode_params, rank_cache,
                                             shard_params)
    from repro_torch.models import (decode_fn, loss_fn, make_moe_tables,
                                    prefill_fn)
    from repro_torch.tree import leaves, tree_map
    pr, dr, tr = rules_for("prefill"), rules_for("decode"), rules_for("train")
    with hold_calls() as held:
        with torch.no_grad():
            prefill_fn(cfg, pr)(shard_params(cfg, params, pr, "prefill"),
                                {"tokens": inp["tokens"]},
                                make_moe_tables(cfg, pr, phase="prefill",
                                                device=dev))
            cache = rank_cache(cfg, tree_map(torch.clone, inp["cache"]), dr)
            decode_fn(cfg, dr)(
                shard_params(cfg, decode_params(cfg, params, dr), dr,
                             "decode"), inp["dec_tokens"][0], cache,
                inp["pos"], make_moe_tables(cfg, dr, phase="decode",
                                            device=dev))
            del cache
        tparams = shard_params(cfg, params, tr, "train")
        for p in leaves(tparams):
            p.requires_grad_(True)
        loss, _ = loss_fn(cfg, tr)(tparams, {"tokens": inp["tokens"],
                                             "labels": inp["labels"]},
                                   make_moe_tables(cfg, tr, phase="train",
                                                   device=dev))
        loss.backward()
    return {"calls": dict(held.calls), "err": dict(held.err),
            "route_mismatch": held.route_mismatch,
            "near_rows": held.near_rows,
            "rows_that_differ": held.rows_that_differ}


#: phase 16 (e): the optimizer's step before the two steps, past
#: cosine_lr's warmup of 100 (at step 0 the learning rate is 0), and the
#: schedule's length
GRID_STEP0 = 100
GRID_TOTAL = 10_000
#: where (e) saves the train state from its grid and (f) restores it
#: (git-ignored; removed by the parent after its own restore)
GRID_CKPT = ROOT / "build" / "chip_smoke_grid_ckpt"


def _ordered_all_reduce(t, group):
    """``all_reduce_`` as an all_gather summed in rank order, in place."""
    if group is not None:
        t.copy_(_in_order(_ordered_parts(t, group)))
    return t


def _witness_norm(whole_g, cuts, grid):
    """The one-device witness of the grid's global norm of the gradients
    ``whole_g`` (gathered whole): every rank's partial sums of squares of
    its slices (``norm_partials``), each set of axes' partials added in
    the rank order of this rank's group over them, the sets' totals in
    the order the ranks add them."""
    import numpy as np
    import torch
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.sharding import cut_tree
    from repro_torch.training import optimizer as topt
    parts = []
    for r in range(math.prod(grid.shape)):
        at = Grid(grid.shape, grid.axes, r, {})
        parts.append(topt.norm_partials(cut_tree(whole_g, cuts, at), cuts,
                                        at))
    total = None
    for key in parts[grid.rank]:
        if key:
            ranks = [int(np.ravel_multi_index(tuple(c[a] for a in grid.axes),
                                              grid.shape))
                     for c in grid.members(key)]
            part = _in_order([parts[r][key] for r in ranks])
        else:
            part = parts[grid.rank][key]
        total = part if total is None else total + part
    return torch.sqrt(total)


def _sync():
    """Wait for the card, where there is one in use."""
    import torch
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _bits_digest(tree):
    """Per leaf, two 64-bit sums of its bits as integers (plain and
    weighted by position; integer sums, so in any order the same): a
    digest that tells two trees apart unless they agree bit for bit."""
    import torch
    from repro_torch.tree import leaves
    out = []
    for t in leaves(tree):
        words = t.detach().contiguous().view(-1)
        words = words.view({2: torch.int16, 4: torch.int32}[
            t.element_size()]).to(torch.int64)
        pos = torch.arange(1, words.numel() + 1, dtype=torch.int64,
                           device=words.device)
        out.append([int(words.sum()), int((words * pos).sum())])
        del words, pos
    return out


class step_witness:
    """Within the block, ``make_train_step``'s AdamW (``launch.train.
    adamw_update``) on each rank runs twice on the same gradients and
    state: first as the port runs it (gloo's all_reduce of the norm's
    partials; timed, with the exchanges clocked, and held against the
    witness as it runs), then, from the same state again, with the
    partials summed in rank order (``_ordered_all_reduce``), held bit for
    bit. The witness: the rank gathers the whole gradients and runs the
    one-device ``adamw_apply`` on its own whole copy of the params and
    state (``self.whole``), clipped by :func:`_witness_norm`; the rank's
    slices of it must be its state. The ranks go on from the ordered
    run's state, so that the next step's witness starts where they do."""

    def __init__(self, whole, cuts, grid):
        self.whole, self.cuts, self.grid = whole, cuts, grid
        self.steps = []

    def update(self, grads, opt, params, ocfg, lr, cuts, grid):
        import torch
        with torch.no_grad():
            return self._update(grads, opt, params, ocfg, lr, cuts, grid)

    def _update(self, grads, opt, params, ocfg, lr, cuts, grid):
        import torch
        from repro_torch.launch.sharding import cut_tree, gather_params
        from repro_torch.models import collectives
        from repro_torch.training import optimizer as topt
        from repro_torch.tree import leaves
        _sync()
        rec = {"backward_s": time.perf_counter() - self.t0}
        whole_g = gather_params(grads, cuts, grid)
        gnorm = _witness_norm(whole_g, cuts, grid)
        wp, wo = topt.adamw_apply(whole_g, self.whole["opt"],
                                  self.whole["params"], ocfg, lr,
                                  topt.clip_scale(gnorm, ocfg))
        self.whole = {"params": wp, "opt": wo}
        del whole_g
        want = leaves(cut_tree(self.whole, self.cuts, grid))
        before = [t.clone() for t in leaves({"params": params, "opt": opt})]

        collectives.clock.reset()
        collectives.clock.enabled = True
        _sync()
        t0 = time.perf_counter()
        p_run, o_run = self.real(grads, opt, params, ocfg, lr, cuts=cuts,
                                 grid=grid)
        _sync()
        rec["update_s"] = time.perf_counter() - t0
        collectives.clock.enabled = False
        rec["norm_exchange"] = {"seconds": collectives.clock.seconds,
                                "calls": collectives.clock.calls,
                                "bytes": collectives.clock.bytes}
        got = leaves({"params": p_run, "opt": o_run})
        rec["rel"] = max(_rel_l2(a, b) for a, b in zip(got, want))
        rec["err"] = max((a.float() - b.float()).abs().max().item()
                         for a, b in zip(got, want))
        for t, b in zip(leaves({"params": params, "opt": opt}), before):
            t.copy_(b)
        del before
        saved, topt.C = topt.C, _Collectives(
            topt.C, all_reduce_=_ordered_all_reduce)
        try:
            p_out, o_out = self.real(grads, opt, params, ocfg, lr,
                                     cuts=cuts, grid=grid)
        finally:
            topt.C = saved
        rec["bits"] = all(bool(torch.equal(a, b)) for a, b in zip(
            leaves({"params": p_out, "opt": o_out}), want))
        rec["gnorm"] = gnorm.item()
        self.steps.append(rec)
        return p_out, o_out

    def __enter__(self):
        from repro_torch.launch import train as ttrain
        self.real = ttrain.adamw_update
        ttrain.adamw_update = self.update
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train as ttrain
        ttrain.adamw_update = self.real


def _step_plan(cfg, rules, params, inp, grid, run, kept):
    """Phase 16 (e) on one rank: two training steps of ``make_train_step``
    at 4 x 256 on the rank's slices of ``params`` (shared, read only: the
    rank's params are copies), from a state at step ``GRID_STEP0``, under
    :class:`step_witness`, the first with every kernel call held against
    its plain version (:class:`hold_calls`); then the train state saved
    from the grid into ``GRID_CKPT``. Keeps the witness's whole state in
    ``kept`` for the restore of (f). Returns the numbers."""
    import torch
    from repro_torch.launch.sharding import (opt_cuts, param_cuts,
                                             shard_params)
    from repro_torch.launch.train import make_train_step
    from repro_torch.models import make_moe_tables
    from repro_torch.training import checkpoint as tckpt
    from repro_torch.training import optimizer as topt
    from repro_torch.tree import leaves, tree_map
    ocfg = topt.AdamWConfig()
    step0 = torch.tensor(GRID_STEP0, dtype=torch.int32,
                         device=params["embed"].device)
    cuts = param_cuts(cfg, rules, "train")
    scuts = {"params": cuts, "opt": opt_cuts(cuts)}
    local = tree_map(torch.clone, shard_params(cfg, params, rules, "train"))
    for p in leaves(local):
        p.requires_grad_(True)
    opt = topt.adamw_init(local, ocfg)._replace(step=step0)
    whole = tree_map(torch.clone, params)
    witness = step_witness({"params": whole, "opt": topt.adamw_init(
        whole, ocfg)._replace(step=step0.clone())}, scuts, grid)
    step = make_train_step(cfg, ocfg, GRID_TOTAL, rules)
    tables = make_moe_tables(cfg, rules, phase="train",
                             device=local["embed"].device)
    batch = {"tokens": inp["tokens"], "labels": inp["labels"]}
    out = {"opt_bytes": sum(t.numel() * t.element_size() for t in leaves(
        (opt.mu, opt.nu, opt.master)))}

    def two_steps():
        nonlocal local, opt
        with witness:
            with hold_calls() as held:
                witness.t0 = time.perf_counter()
                local, opt, _, _ = step(local, opt, batch, tables)
            _sync()
            witness.t0 = time.perf_counter()
            local, opt, _, _ = step(local, opt, batch, tables)
        return held

    held = run("steps+witness", two_steps)
    out["vs_plain"] = {"calls": dict(held.calls), "err": dict(held.err),
                       "route_mismatch": held.route_mismatch,
                       "near_rows": held.near_rows,
                       "rows_that_differ": held.rows_that_differ}
    out["steps"] = witness.steps
    t0 = time.perf_counter()
    tckpt.save_checkpoint(str(GRID_CKPT), GRID_STEP0 + 2,
                          {"params": local, "opt": opt}, cuts=scuts,
                          grid=grid)
    out["save_s"] = time.perf_counter() - t0
    kept["saved"] = witness.whole
    if grid.rank == 0:
        out["saved_digest"] = _bits_digest(witness.whole)
    return out


def _restore_plan(cfg, rules, params, grid, kept):
    """Phase 16 (f) on one rank: (e)'s checkpoint restored onto this grid
    (``load_checkpoint`` with the params' and ``opt_cuts``' cuts), each
    leaf held bit for bit against the rank's slice of the state (e) saved
    (its witness's, equal to the ranks' bit for bit). Returns the
    numbers."""
    import torch
    from repro_torch.launch.sharding import (cut_tree, opt_cuts,
                                             param_cuts, shard_params)
    from repro_torch.training import checkpoint as tckpt
    from repro_torch.training import optimizer as topt
    from repro_torch.tree import leaves
    cuts = param_cuts(cfg, rules, "train")
    scuts = {"params": cuts, "opt": opt_cuts(cuts)}
    like_p = shard_params(cfg, params, rules, "train")
    like = {"params": like_p, "opt": topt.adamw_init(like_p)}
    _sync()
    t0 = time.perf_counter()
    state, _ = tckpt.load_checkpoint(str(GRID_CKPT), GRID_STEP0 + 2, like,
                                     cuts=scuts, grid=grid)
    _sync()
    out = {"restore_s": time.perf_counter() - t0}
    del like
    want = leaves(cut_tree(kept.pop("saved"), scuts, grid))
    out["restore_bits"] = all(bool(torch.equal(a, b)) for a, b in zip(
        leaves(state), want))
    out["restore_leaves"] = len(want)
    return out


def tp_rank(rank, plans, weights, refs, inputs):
    """One rank on the card for each plan of ``plans`` (every rank runs
    every plan, in order): its grid, the rules of ``make_rules`` with the
    plan's overrides, the rank's slice of ``weights[plan["model"]]``
    (shared with the parent, read only) for each phase, and the plan's
    paths — the prefill, the plan's decode steps (from the rank's slice of
    the inputs' cache), the loss and backward — each run under the witness
    (:class:`ordered_partials`, and :class:`exact_decode_psum` at decode)
    where the plan has one, as the port runs it (timed on the host clock,
    launches counted) and again with the exchanges clocked. Returns the
    numbers; the parent checks them."""
    import contextlib
    import dataclasses
    import gc
    import statistics as st
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.sharding import (decode_params, make_rules,
                                             rank_cache, shard_params)
    from repro_torch.models import (decode_fn, loss_fn, make_moe_tables,
                                    prefill_fn)
    from repro_torch.models import collectives
    from repro_torch.models.model import _batch_shape, block_layout
    from repro_torch.tree import leaves, tree_map
    dev = next(iter(_plan_batch(next(iter(inputs.values()))).values())) \
        .device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.set_device(dev)

    def sync():
        if cuda:
            torch.cuda.synchronize()

    results = {}
    kept = {}                 # (e)'s saved state, for (f)'s restore
    for plan in plans:
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        label, cfg = plan["label"], plan["cfg"]
        params, ref, inp = (weights[plan["model"]], refs[label],
                            inputs[plan["model"]])
        grid = make_mesh(plan["grid"], EP_AXES)

        def rules_for(phase):
            return dataclasses.replace(make_rules(cfg, grid, phase),
                                       **plan["rules"])

        if plan["paths"] == ["dryrun"]:
            results[label] = _dryrun_rank(cfg, grid, weights, dev)
            del params, ref, inp
            continue
        if _served(plan):
            results[label] = {"rank": rank} | _engine_rank(
                cfg, rules_for("prefill"), params, ref, dev, _served(plan))
            del params, ref, inp
            gc.collect()
            if cuda:
                torch.cuda.empty_cache()
            continue
        out = {"rank": rank, "seconds": {}, "launches": {}, "exchange": {},
               "rel": {}, "err": {}, "moved": {}, "bits": {}, "digest": {}}
        wit = plan["witness"]

        def run(name, fn, clocked=False):
            dist.barrier()
            sync()
            ops.reset_launch_counts()
            collectives.clock.reset()
            collectives.clock.enabled = clocked
            t0 = time.perf_counter()
            res = fn()
            sync()
            wall = time.perf_counter() - t0
            collectives.clock.enabled = False
            if clocked:
                out["exchange"][name] = {
                    "wall_s": wall, "exchange_s": collectives.clock.seconds,
                    "calls": collectives.clock.calls,
                    "bytes": collectives.clock.bytes}
            else:
                out["seconds"][name] = wall
                out["launches"][name] = attn_routed(ops.launch_counts(),
                                                    f"grid {name}")
            return res

        def hold(name, lg, tal, want):
            out["err"][name] = (lg.float() - want[0].float()).abs().max() \
                .item()
            out["rel"][name] = _rel_l2(lg, want[0])
            if tal.shape[0]:
                out["moved"][name] = sum(_moved(tal, want[1]))

        rules = rules_for("prefill")
        local = shard_params(cfg, params, rules, "prefill")
        out["dense_bytes"] = _dense_bytes(cfg, local)
        out["dense_bytes_whole"] = _dense_bytes(cfg, params)
        tables = make_moe_tables(cfg, rules, phase="prefill", device=dev)
        batch = _plan_batch(inp)
        if "prefill" in plan["paths"]:
            fn = prefill_fn(cfg, rules)
            call = lambda: fn(local, _no_labels(batch), tables)  # noqa: E731
            with torch.no_grad():
                if not wit:           # else the witness's run warms up
                    run("warm-up", call)
                if wit:
                    with ordered_partials():
                        lg, _, tal = call()
                    want = ref["prefill/witness"]
                    out["bits"]["prefill"] = bool(
                        torch.equal(lg, want[0]) and torch.equal(tal,
                                                                 want[1]))
                lg, _, tal = run("prefill", call)
                hold("prefill", lg, tal, ref["prefill"])
                out["digest"]["prefill"] = lg.double().sum().item()
                if "prefill" in plan.get("clocked", plan["paths"]):
                    run("prefill", call, clocked=True)
        del local
        if "decode" in plan["paths"]:
            drules = rules_for("decode")
            dparams = params
            if cfg.is_moe:
                dparams = decode_params(cfg, params, drules)
            dparams = shard_params(cfg, dparams, drules, "decode")
            dtables = make_moe_tables(cfg, drules, phase="decode",
                                      device=dev)
            fn = decode_fn(cfg, drules)
            steps = inp["dec_tokens"][:plan["steps"]]
            base = rank_cache(cfg, inp["cache"], drules)
            first = leaves(base[0])[0]
            out["cache_shape"] = list(first.shape)
            out["cache_bytes"] = sum(t.numel() * t.element_size()
                                     for t in leaves(base))
            out["cache_bytes_whole"] = sum(t.numel() * t.element_size()
                                           for t in leaves(inp["cache"]))

            def decode(ctx):
                cache = tree_map(torch.clone, base)
                res, times = [], []
                for i, tok in enumerate(steps):
                    dist.barrier()
                    sync()
                    t0 = time.perf_counter()
                    with ctx():
                        lg, cache, tal = fn(dparams, tok, cache,
                                            inp["pos"] + i, dtables)
                    sync()
                    times.append(time.perf_counter() - t0)
                    res.append((lg, tal))
                return res, times, cache

            def witness():
                stack = contextlib.ExitStack()
                stack.enter_context(ordered_partials())
                stack.enter_context(exact_decode_psum())
                return stack

            with torch.no_grad():
                if wit:
                    res, _, _ = decode(witness)
                    out["bits"]["decode"] = [
                        bool(torch.equal(lg, w[0]) and torch.equal(t, w[1]))
                        for (lg, t), w in zip(res, ref["decode/witness"])]
                ops.reset_launch_counts()
                res, times, cache = decode(contextlib.nullcontext)
                out["launches"]["decode"] = attn_routed(
                    ops.launch_counts(), "grid decode")
                out["seconds"]["decode"] = st.median(times)
                out["seconds"]["decode_all"] = sum(times)
                rels, errs, moved = [], [], []
                for (lg, tal), w in zip(res, ref["decode"]):
                    rels.append(_rel_l2(lg, w[0]))
                    errs.append((lg.float() - w[0].float()).abs().max()
                                .item())
                    if tal.shape[0]:
                        moved.append(sum(_moved(tal, w[1])))
                out["rel"]["decode"] = max(rels)
                out["err"]["decode"] = max(errs)
                out["moved"]["decode"] = moved
                out["digest"]["decode"] = res[-1][0].double().sum().item()
                n = len(steps)
                if "decode" in plan.get("clocked", plan["paths"]):
                    run("decode", lambda: fn(dparams, steps[-1], cache,
                                             inp["pos"] + n, dtables),
                        clocked=True)
            del dparams, cache, res, base
        if "backward" in plan["paths"]:
            trules = rules_for("train")
            tparams = shard_params(cfg, params, trules, "train")
            for p in leaves(tparams):
                p.requires_grad_(True)
            ttables = make_moe_tables(cfg, trules, phase="train",
                                      device=dev)
            fn = loss_fn(cfg, trules)

            def step():
                loss, (tal, _) = fn(tparams, batch, ttables)
                loss.backward()
                return loss.detach(), tal.detach()

            def grad_rel(key):
                want = leaves(shard_params(cfg, ref[key], trules, "train"))
                rel = max(_rel_l2_chunked(_grad_or_zeros(p), w)
                          for p, w in zip(leaves(tparams), want))
                for p in leaves(tparams):
                    p.grad = None
                return rel

            if wit:
                with ordered_partials():
                    loss, tal = step()
                out["bits"]["loss"] = bool(
                    torch.equal(loss, ref["loss/witness"])
                    and torch.equal(tal, ref["backward_tally/witness"]))
                out["grad_rel_l2_max/witness"] = grad_rel("grads/witness")
            with block_inputs(block_layout(cfg)[0]) as seen:
                loss, tal = run("backward", step)
            # what remat keeps of a block: its input, the rank's rows;
            # beside it the whole batch's, each block's input replicated
            out["block_input_bytes"] = seen.bytes
            out["block_input_shape"] = seen.shape
            out["block_input_bytes_whole"] = (
                seen.bytes // math.prod(seen.shape)
                * math.prod(_batch_shape(cfg, batch)) * cfg.d_model)
            out["loss"] = loss.item()
            out["loss_rel"] = abs(loss.item() - ref["loss"].item()) / abs(
                ref["loss"].item())
            if tal.shape[0]:
                out["moved"]["backward"] = sum(_moved(tal,
                                                      ref["backward_tally"]))
            out["grad_rel_l2_max"] = grad_rel("grads")
            out["grad_leaves"] = len(leaves(tparams))
            if "backward" in plan.get("clocked", plan["paths"]):
                run("backward", step, clocked=True)
            del tparams
        if "vs_plain" in plan["paths"]:
            out["vs_plain"] = _tp_vs_plain(cfg, rules_for, params, inp, dev)
        if "step" in plan["paths"]:
            out |= _step_plan(cfg, rules_for("train"), params, inp, grid,
                              run, kept)
        if "restore" in plan["paths"]:
            out |= _restore_plan(cfg, rules_for("train"), params, grid, kept)
        out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
        results[label] = out
        del params, ref, inp
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return results


def _grid_run(tag, plans, weights, inputs, dev, bounds, what, t_start,
              beside=None):
    """The one-device references of ``plans`` (each against its witness
    where the plan has one), then every plan on 4 ranks sharing the card
    in one ``run_ranks`` (:func:`tp_rank`), each rank's launches checked
    exact against the layer count and its results held: bit for bit
    against the witness (gradients within ``STEP_TOL``), within
    ``bounds[label]`` against one device as it runs, every kernel call on
    the ranks within its bound of its plain version. Prints ``[tag]`` lines
    (``beside[label]``, where given, after a plan's peak) and returns the
    summary."""
    import concurrent.futures
    import dataclasses
    import multiprocessing
    import torch
    from repro_torch.launch.mesh import Grid, run_ranks
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import moe_perm_shape
    from repro_torch.models.model import block_layout
    from repro_torch.training import AdamWConfig
    refs = {}
    # phase 17's traces run beside the references and the ranks, in a
    # process of their own (a fake default group; no card)
    dry = next((p for p in plans if p["paths"] == ["dryrun"]), None)
    traces = None
    if dry is not None:
        pool = concurrent.futures.ProcessPoolExecutor(
            1, mp_context=multiprocessing.get_context("spawn"))
        traces = pool.submit(dryrun_meta, dry["cfg"])
        pool.shutdown(wait=False)
    for plan in plans:
        if plan is dry:
            refs[plan["label"]] = {}
            continue
        # the attention's split as the plan's rules make it, for the witness
        rules = dataclasses.replace(make_rules(
            plan["cfg"], Grid(plan["grid"], EP_AXES, 0, {}), "prefill"),
            **plan["rules"])
        witness = None
        kind = _served(plan)
        if plan["witness"] or kind:
            _, specs = block_layout(plan["cfg"])
            split = any(rules.mixer_split(plan["cfg"], sp.mixer)
                        for sp in specs)
            witness = {"mode": ("heads" if rules.heads_split(plan["cfg"])
                                else "context"),
                       "tp": rules.tp_size, "dp": rules.dp_size,
                       "ep": rules.ep_size,
                       "dense": rules.moe_dispatch == "dense",
                       "mixers": plan["cfg"] if split else None,
                       # a split vocabulary's xent runs on every position
                       "xent_tp": (1 if rules.splits(plan["cfg"].vocab)
                                   else rules.tp_size),
                       "vocab_tp": (rules.tp_size
                                    if rules.splits(plan["cfg"].vocab)
                                    else 1)}
        if kind:
            refs[plan["label"]] = ({} if kind == "capacity" else
                                   engine_reference(plan["cfg"], dev,
                                                    weights[plan["model"]],
                                                    witness, kind))
            continue
        weights[plan["model"]], refs[plan["label"]] = tp_reference(
            plan["cfg"], dev, weights[plan["model"]], inputs[plan["model"]],
            [p for p in plan["paths"] if p != "vs_plain"], witness,
            plan["steps"])
    _free_shared()
    parent_gib = (torch.cuda.memory_allocated() / 2 ** 30
                  if dev.type == "cuda" else 0.0)
    t_ref = time.perf_counter() - t_start
    t0 = time.perf_counter()
    ranks = run_ranks(tp_rank, 4, args=(plans, weights, refs, inputs),
                      timeout_s=600)
    t_ranks = time.perf_counter() - t0
    loss_ref = {k: r["loss"].item() for k, r in refs.items() if "loss" in r}
    refs_small = {p["label"]: {k: v for k, v in refs[p["label"]].items()
                               if k != "witness"}
                  for p in plans if _served(p)}
    del weights, refs, inputs
    _free_shared()
    on_card = dev.type == "cuda"

    def per(n, fwd=1):
        return {"route_select": fwd * n, "ragged_moe_ffn": fwd * n,
                "ragged_moe_ffn.tma": fwd * n}

    def bwd(n):          # remat: the forward again in the backward
        return per(n, 2) | {k: n for k in (
            "ragged_moe_ffn_dgrad", "ragged_moe_ffn_dgrad.tma",
            "ragged_moe_ffn_wgrad", "ragged_moe_ffn_wgrad.tma",
            "route_select_bwd")}

    grad_clip = AdamWConfig().grad_clip
    kernel_bounds = {"ragged_moe_ffn": BF16_TOL, "fused_moe_ffn": BF16_TOL,
                     "route_select": ROUTER_W_TOL,
                     "ragged_moe_ffn_dgrad": BWD_TOL,
                     "ragged_moe_ffn_wgrad": BWD_TOL,
                     "route_select_bwd": ROUTER_W_TOL}
    beside = beside or {}
    summary = {}
    for plan in plans:
        label = plan["label"]
        if plan is dry:
            summary[label] = _dryrun_report([r[label] for r in ranks],
                                            traces.result(), on_card)
            continue
        if _served(plan):
            summary[label] = _engine_report(
                tag, label, plan["cfg"], [r[label] for r in ranks],
                refs_small[label], kernel_bounds, on_card, _served(plan))
            continue
        n = moe_perm_shape(plan["cfg"])[0] if plan["cfg"].is_moe else 0
        # one attention launch a layer and prefill or decode call, and in
        # a training step the forward's and remat's again, then the
        # backward's two kernels once
        fwd = attn_want(plan["cfg"], prefill=1)
        step = bwd(n) | attn_want(plan["cfg"], prefill=2, backward=1)
        want = {"warm-up": per(n) | fwd, "prefill": per(n) | fwd,
                "decode": per(n, plan["steps"])
                | attn_want(plan["cfg"], decode=plan["steps"]),
                "backward": step,
                "steps+witness": {k: 2 * v for k, v in step.items()}}
        rs = [r[label] for r in ranks]
        print(f"[{tag}] {label} launches per rank (rank 0): "
              f"{json.dumps(rs[0]['launches'])}", flush=True)
        for r in rs:
            name = f"{tag} {label} rank {r['rank']}"
            for path, counts in r["launches"].items():
                for k, c in counts.items():
                    w = want.get(path, {}).get(k, 0)
                    check(c == w or not on_card, f"{name} {path}: {k} "
                          f"launched {c} times, expected {w}")
            if plan["witness"]:
                check(all(r["bits"].get("decode", [True])) and all(
                    r["bits"].get(p, True) for p in ("prefill", "loss")),
                      f"{name} against the witness: bit for bit "
                      f"{json.dumps(r['bits'])}")
                if "grad_rel_l2_max/witness" in r:
                    check(r["grad_rel_l2_max/witness"] <= STEP_TOL,
                          f"{name} gradients against the witness: "
                          f"{r['grad_rel_l2_max/witness']:.3e} (bound "
                          f"{STEP_TOL})")
            b = bounds.get(label, {})
            check(all(v <= b[p] for p, v in r["rel"].items()),
                  f"{name} against one device: logits' relative L2 "
                  f"{json.dumps(r['rel'])} (bounds {json.dumps(b)})")
            if "loss" in r:
                check(r["loss_rel"] <= b["loss"]
                      and r["grad_rel_l2_max"] <= b["grads"],
                      f"{name} backward against one device: loss "
                      f"{r['loss_rel']:.3e} (bound {b['loss']}), gradient "
                      f"leaves {r['grad_rel_l2_max']:.3e} (bound "
                      f"{b['grads']})")
            if "steps" in r:
                st = r["steps"]
                check(all(x["bits"] for x in st)
                      and all(x["gnorm"] > grad_clip for x in st),
                      f"{name} AdamW against the witness: bit for bit "
                      f"{[x['bits'] for x in st]}, global norms "
                      f"{[x['gnorm'] for x in st]} (the clip active above "
                      f"{grad_clip})")
                check(all(x["rel"] <= b["step"] for x in st),
                      f"{name} AdamW as it runs against the witness: "
                      f"relative L2 {[x['rel'] for x in st]} (bound "
                      f"{b['step']})")
            if "restore_bits" in r:
                check(r["restore_bits"], f"{name}: the restored state "
                      f"against the saved one, bit for bit")
            if "vs_plain" in r:
                vp = r["vs_plain"]
                # a prefill, a decode step, the loss's forward (one
                # training step's) and, with remat, its forward again in
                # the backward
                fwd = (3 if "vs_plain" in plan["paths"] else 1) + \
                    dataclasses.replace(make_rules(
                        plan["cfg"], Grid(plan["grid"], EP_AXES, 0, {}),
                        "train"), **plan["rules"]).remat
                calls = {"route_select": fwd * n, "ragged_moe_ffn": fwd * n}
                if on_card:   # the CPU's backward is the plain one
                    calls |= {"ragged_moe_ffn_dgrad": n,
                              "ragged_moe_ffn_wgrad": n,
                              "route_select_bwd": n}
                check(vp["calls"] == calls, f"{name}: kernel calls held "
                      f"against their plain versions {vp['calls']} "
                      f"(expected {calls})")
                check(vp["route_mismatch"] == 0 and all(
                    vp["err"].get(k, 0.0) <= v
                    for k, v in kernel_bounds.items()),
                      f"{name}: kernels vs plain at the ranks' shapes: "
                      f"{vp['route_mismatch']} routing entries differ "
                      f"outside near ties; errors {vp['err']} (bounds "
                      f"{kernel_bounds})")
        for path in rs[0]["digest"]:
            check(len({r["digest"][path] for r in rs}) == 1,
                  f"{tag} {label} {path}: the ranks' logits differ")
        gib = 2 ** 30
        s = {"wall_s": {p: [r["seconds"][p] for r in rs]
                        for p in rs[0]["seconds"]},
             "exchange": {p: [r["exchange"][p] for r in rs]
                          for p in rs[0]["exchange"]},
             "peak_gib": [r["peak_bytes"] / gib for r in rs],
             "dense_bytes_rank0": rs[0]["dense_bytes"],
             "dense_bytes_whole": rs[0]["dense_bytes_whole"],
             "cache_shape": rs[0].get("cache_shape"),
             "cache_bytes_rank0": rs[0].get("cache_bytes"),
             "cache_bytes_whole": rs[0].get("cache_bytes_whole"),
             "logit_rel_l2": {p: max(r["rel"][p] for r in rs)
                              for p in rs[0]["rel"]},
             "max_abs_logit_err": {p: max(r["err"][p] for r in rs)
                                   for p in rs[0]["err"]},
             "moved": rs[0]["moved"], "bits": rs[0]["bits"],
             "launches_rank0": rs[0]["launches"]}
        if "loss" in rs[0]:
            s |= {"loss": rs[0]["loss"], "loss_one_device": loss_ref[label],
                  "loss_rel": rs[0]["loss_rel"],
                  "grad_rel_l2_max": max(r["grad_rel_l2_max"] for r in rs),
                  "grad_leaves": rs[0]["grad_leaves"],
                  "block_input_bytes": rs[0]["block_input_bytes"],
                  "block_input_bytes_whole":
                      rs[0]["block_input_bytes_whole"],
                  "block_input_shape": rs[0]["block_input_shape"]}
            if "grad_rel_l2_max/witness" in rs[0]:
                s["grad_rel_l2_max_witness"] = max(
                    r["grad_rel_l2_max/witness"] for r in rs)
        if "steps" in rs[0]:
            last = [r["steps"][-1] for r in rs]
            s["step"] = {
                "backward_s": [x["backward_s"] for x in last],
                "update_s": [x["update_s"] for x in last],
                "norm_exchange_rank0": last[0]["norm_exchange"],
                "rel_l2_as_it_runs": max(x["rel"] for r in rs
                                         for x in r["steps"]),
                "max_abs_err_as_it_runs": max(x["err"] for r in rs
                                              for x in r["steps"]),
                "bits": [x["bits"] for x in rs[0]["steps"]],
                "gnorm": [x["gnorm"] for x in rs[0]["steps"]],
                "opt_bytes": [r["opt_bytes"] for r in rs],
                "save_s": [r["save_s"] for r in rs],
                "saved_digest": rs[0]["saved_digest"]}
        if "restore_s" in rs[0]:
            s["restore"] = {"restore_s": [r["restore_s"] for r in rs],
                            "bits": [r["restore_bits"] for r in rs],
                            "leaves": rs[0]["restore_leaves"]}
        if "vs_plain" in rs[0]:
            s["vs_plain"] = rs[0]["vs_plain"] | {
                "err": {k: max(r["vs_plain"]["err"].get(k, 0.0) for r in rs)
                        for k in rs[0]["vs_plain"]["err"]},
                "route_mismatch": max(r["vs_plain"]["route_mismatch"]
                                      for r in rs)}
        summary[label] = s
    summary["phase_s"] = {"one_device_references": t_ref, "ranks": t_ranks,
                          "all": time.perf_counter() - t_start,
                          "parent_gib": parent_gib}
    for plan in plans:
        label = plan["label"]
        if _served(plan) or plan is dry:
            continue
        s = summary[label]
        walls = "; ".join(f"{p} " + ", ".join(f"{w * 1e3:.1f}" for w in ws)
                          for p, ws in s["wall_s"].items())
        ex = "; ".join(
            f"{p}: " + ", ".join(
                f"{100 * x['exchange_s'] / x['wall_s']:.1f}%" for x in xs)
            + f" of {xs[0]['wall_s'] * 1e3:.1f} ms, {xs[0]['calls']} calls, "
              f"{xs[0]['bytes'] / 2 ** 20:.3f} MiB"
            for p, xs in s["exchange"].items())
        remat = ""
        if "block_input_bytes" in s:
            remat = (f"; block inputs remat keeps a rank "
                     f"{s['block_input_bytes'] / 2 ** 20:.1f} MiB (a block "
                     f"{s['block_input_shape']}; "
                     f"{s['block_input_bytes_whole'] / 2 ** 20:.1f} MiB "
                     f"with every block's input the whole batch's)")
        if label in beside:
            remat += f" ({beside[label]})"
        print(f"[{tag}] {what[label]}: host wall per rank (ms) {walls}; "
              f"exchanges (each synchronised; rank 0's calls and bytes) "
              f"{ex}; peak per rank "
              f"{', '.join(f'{v:.2f}' for v in s['peak_gib'])} GiB{remat}; "
              f"dense weight bytes a rank "
              f"{json.dumps(s['dense_bytes_rank0'])} of "
              f"{json.dumps(s['dense_bytes_whole'])}; decode cache a rank "
              f"{s['cache_shape']}"
              + (f", {s['cache_bytes_rank0']} bytes of "
                 f"{s['cache_bytes_whole']} whole"
                 if s["cache_bytes_rank0"] is not None else ""), flush=True)
        print(f"[{tag}] {what[label]} against one device: logits' relative "
              f"L2 {json.dumps(s['logit_rel_l2'])}, max |difference| "
              f"{json.dumps(s['max_abs_logit_err'])}, assignments moved "
              f"{json.dumps(s['moved'])}"
              + (f"; loss {s['loss']:.6f} vs {s['loss_one_device']:.6f}, "
                 f"gradient leaves' relative L2 max "
                 f"{s['grad_rel_l2_max']:.3e} over {s['grad_leaves']} "
                 f"leaves" if "loss" in s else "")
              + (f"; against the witness: bit for bit "
                 f"{json.dumps(s['bits'])}"
                 + (f", gradients {s['grad_rel_l2_max_witness']:.3e}"
                    if "grad_rel_l2_max_witness" in s else "")
                 if s["bits"] else ""), flush=True)
        if "step" in s:
            st = s["step"]
            ex = st["norm_exchange_rank0"]
            wall = [a + u for a, u in zip(st["backward_s"], st["update_s"])]
            print(f"[{tag}] {what[label]}: the second step's host wall per "
                  f"rank (ms) {', '.join(f'{w * 1e3:.1f}' for w in wall)} "
                  f"(loss and backward "
                  f"{', '.join(f'{w * 1e3:.1f}' for w in st['backward_s'])};"
                  f" AdamW "
                  f"{', '.join(f'{w * 1e3:.1f}' for w in st['update_s'])}); "
                  f"the norm's exchanges (rank 0, synchronised) "
                  f"{ex['calls']} calls, {ex['bytes']} bytes, "
                  f"{ex['seconds'] * 1e3:.2f} ms, "
                  f"{100 * ex['seconds'] / st['update_s'][0]:.1f}% of its "
                  f"AdamW; optimizer state a rank (f32 mu, nu, master) "
                  f"{', '.join(f'{b / 2 ** 30:.3f}' for b in st['opt_bytes'])}"
                  f" GiB; save from the grid (s) "
                  f"{', '.join(f'{w:.2f}' for w in st['save_s'])}; "
                  f"against the witness bit for bit {st['bits']} (global "
                  f"norms {st['gnorm']}), as it runs relative L2 "
                  f"{st['rel_l2_as_it_runs']:.3e}, max |difference| "
                  f"{st['max_abs_err_as_it_runs']:.3e}", flush=True)
        if "restore" in s:
            rs_ = s["restore"]
            print(f"[{tag}] {what[label]}: restore onto the grid (s) "
                  f"{', '.join(f'{w:.2f}' for w in rs_['restore_s'])}, "
                  f"{rs_['leaves']} leaves a rank bit for bit "
                  f"{rs_['bits']}", flush=True)
        if "vs_plain" in s:
            print(f"[{tag}] {what[label]}, each kernel call against its "
                  f"plain version on the ranks (worst rank): "
                  f"{json.dumps(s['vs_plain'])}", flush=True)
    print(f"[{tag}] phase wall {summary['phase_s']['all']:.1f} s (one-device"
          f" references {t_ref:.1f}, ranks {t_ranks:.1f}); gloo on one "
          f"shared card: not a fleet's links", flush=True)
    return summary


# ---------------------------------------------------------------------------
# phase 17: the dry run against the card
# ---------------------------------------------------------------------------

#: granite's cells on (2, 2): (label, model, layers or None for all,
#: kind, seq_len, global batch); the decode step runs on a 512-row cache
DRYRUN_CELLS = (("prefill", "granite", None, "prefill", 256, 4),
                ("decode", "granite", None, "decode", 512, 4),
                ("train", "small", 2, "train", 256, 4))
DRYRUN_GRID = (2, 2)
#: the traced peak above the arguments against the card's
#: ``max_memory_allocated()`` less ``memory_allocated()`` at the call's
#: start, relative to the card's: in this script the gaps read on an H100
#: 80GB HBM3 at 700 W were +0.00% to +0.21% (PERF.md, phase 17); about twice
#: the largest. Phase 17 run alone reads more (+5.26%, +2.20%): its calls
#: grow the routing stage's cached scratch, which earlier phases grew here
DRYRUN_PEAK_REL = 0.005
#: the one operation whose traffic and calls may differ between trace and
#: card: the routing stage's cached scratch (``route_select._SCRATCH``,
#: ``_TICKETS``), zeroed where the card grows it inside a call and never
#: allocated by a traced call
DRYRUN_CACHE_OP = "aten::zeros"


def _dryrun_cells(cfg):
    import dataclasses
    from repro_torch.configs import ShapeSpec
    for label, model, layers, kind, seq, batch in DRYRUN_CELLS:
        c = cfg if layers is None else dataclasses.replace(cfg,
                                                           n_layers=layers)
        yield label, model, c, ShapeSpec(label, seq, batch, kind)


def _costs_small(costs):
    """A ``Costs`` dict without its per-operation tables."""
    return {k: v for k, v in costs.items()
            if k not in ("bytes_by_op", "calls_by_op")}


def dryrun_meta(cfg):
    """Phase 17's traces, in a spawned process (a fake default group of
    4 a rank at a time; no card): each cell of :data:`DRYRUN_CELLS` on
    ``meta`` for every rank of :data:`DRYRUN_GRID`."""
    import math
    from repro_torch.launch import dryrun
    out = {}
    for label, _, c, shape in _dryrun_cells(cfg):
        out[label] = []
        for rank in range(math.prod(DRYRUN_GRID)):
            m = dryrun.measure(c, shape, DRYRUN_GRID, rank)
            out[label].append({"costs": m["costs"].as_dict(),
                               "memory": m["memory"],
                               "trace_s": m["trace_s"]})
    return out


def _dryrun_rank(cfg, grid, weights, dev):
    """Phase 17 on a rank: each cell of :data:`DRYRUN_CELLS` run once on
    the rank's slices of the parent's weights (``dryrun.rank_inputs``,
    the function the trace calls), inside ``count_costs``, the launches
    and the exchange clock counted and the card's peak read; returns the
    readings."""
    import gc
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.cost_analysis import count_costs
    from repro_torch.launch.sharding import decode_params, make_rules
    from repro_torch.models import collectives
    cuda = dev.type == "cuda"
    out = {}
    for label, model, c, shape in _dryrun_cells(cfg):
        rules = make_rules(c, grid, shape.kind)
        whole = weights[model]
        if shape.kind == "decode":
            whole = decode_params(c, whole, rules)
        inputs = dryrun.rank_inputs(c, shape, rules, whole=whole, device=dev)
        del whole
        call, args = dryrun.step_call(c, shape, rules, inputs)
        dist.barrier()
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated() if cuda else 0
        ops.reset_launch_counts()
        collectives.clock.reset()
        collectives.clock.enabled = True
        t0 = time.perf_counter()
        with count_costs(args) as costs:
            res = call()
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        collectives.clock.enabled = False
        out[label] = {
            "costs": costs.as_dict(),
            "launches": attn_routed(ops.launch_counts(), f"dry run {label}"),
            "clock": dict(collectives.clock.by_kind), "wall_s": wall,
            "peak": (torch.cuda.max_memory_allocated() - start
                     if cuda else 0)}
        del res, inputs, call, args
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
    return out


def _smi_line():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi"


def _dryrun_report(ranks, metas, on_card):
    """Phase 17's checks and lines: each rank's card run against its
    trace (see :data:`DRYRUN_CELLS`)."""
    from repro_torch.launch import roofline
    smi = _smi_line()
    summary = {}
    for label, *_ in DRYRUN_CELLS:
        rows = []
        for r, (rank, meta) in enumerate(zip(ranks, metas[label])):
            card, m = rank[label], meta["costs"]
            cc = card["costs"]
            name = f"phase 17 {label} rank {r}"
            launched = {k: v for k, v in card["launches"].items()
                        if "." not in k and v}
            # the CPU's plain versions are counted as tensor operations:
            # there only the collectives and the peak's tracker agree
            check(cc["kernel_calls"] == m["kernel_calls"] == launched
                  or not on_card,
                  f"{name}: kernel calls traced {m['kernel_calls']}, on the "
                  f"card {cc['kernel_calls']}, launched {launched}")
            clock = {k: v[1] for k, v in card["clock"].items()}
            clock_calls = {k: v[0] for k, v in card["clock"].items()}
            check(cc["collective_by_kind"] == m["collective_by_kind"] == clock
                  and cc["collective_calls"] == m["collective_calls"]
                  == clock_calls,
                  f"{name}: collectives traced {m['collective_calls']} "
                  f"{m['collective_by_kind']}, on the card "
                  f"{cc['collective_calls']} {cc['collective_by_kind']}, "
                  f"clocked {card['clock']}")
            check(cc["flops"] == m["flops"] or not on_card,
                  f"{name}: FLOPs traced "
                  f"{m['flops']}, on the card {cc['flops']}")
            ops_ = set(cc["bytes_by_op"]) | set(m["bytes_by_op"])
            diff = {op: (cc["bytes_by_op"].get(op, 0)
                         - m["bytes_by_op"].get(op, 0),
                         cc["calls_by_op"].get(op, 0)
                         - m["calls_by_op"].get(op, 0)) for op in ops_}
            diff = {op: d for op, d in diff.items() if d != (0, 0)}
            check(all(op == DRYRUN_CACHE_OP and d[0] > 0
                      for op, d in diff.items()) or not on_card,
                  f"{name}: memory traffic traced {m['bytes_accessed']}, on "
                  f"the card {cc['bytes_accessed']}; by operation (bytes, "
                  f"calls) {diff}")
            gap = (card["peak"] - m["peak_bytes"]) / max(card["peak"], 1)
            check(abs(gap) <= DRYRUN_PEAK_REL or not on_card,
                  f"{name}: peak above the arguments traced "
                  f"{m['peak_bytes']}, on the card {card['peak']} "
                  f"({100 * gap:.2f}%, bound {100 * DRYRUN_PEAK_REL}%)")
            terms = {"compute_ms": m["flops"] / roofline.PEAK_FLOPS * 1e3,
                     "memory_ms": m["bytes_accessed"] / roofline.HBM_BW
                     * 1e3,
                     "collective_ms": m["collective_bytes"]
                     / roofline.LINK_BW * 1e3}
            rows.append({"rank": r, "card": _costs_small(cc),
                         "traced": _costs_small(m),
                         "memory": meta["memory"], "trace_s":
                         meta["trace_s"], "peak": card["peak"],
                         "peak_gap": gap, "traffic_diff": diff,
                         "wall_ms": card["wall_s"] * 1e3, **terms})
            print(f"[dryrun] phase 17 {label} rank {r}: peak above the "
                  f"arguments traced {m['peak_bytes'] / 2 ** 30:.4f} GiB, "
                  f"on the card {card['peak'] / 2 ** 30:.4f} GiB "
                  f"({100 * gap:+.2f}%); arguments "
                  f"{m['argument_bytes'] / 2 ** 30:.4f} GiB; kernel calls "
                  f"{json.dumps(m['kernel_calls'])}; collectives "
                  f"{json.dumps(m['collective_calls'])} "
                  f"{json.dumps(m['collective_by_kind'])} bytes; FLOPs "
                  f"{m['flops']:.6g}, bytes {m['bytes_accessed']:.6g} "
                  f"(card {cc['bytes_accessed']:.6g}); roofline (H100 data "
                  f"sheet) compute {terms['compute_ms']:.3f} ms, memory "
                  f"{terms['memory_ms']:.3f} ms, collective "
                  f"{terms['collective_ms']:.3f} ms at 50 GB/s, beside a "
                  f"measured wall of {card['wall_s'] * 1e3:.1f} ms (4 ranks "
                  f"on one card through gloo, each exchange synchronised; "
                  f"trace {meta['trace_s']:.2f} s) on {smi}", flush=True)
        summary[label] = rows
    return summary


def tp_phase(cfg, dev, smollm=None, xlstm=None):
    """Phase 15: tensor parallelism of the dense layers on 4 ranks sharing
    the card (gloo on CUDA tensors), each run held against one device on
    the same weights in this run:

    (a) granite at full width and depth on (1, 4) from ``make_rules``:
        attention by heads (6 heads and 2 KV heads a rank), EP 4 through
        the ragged a2a body, the vocabulary (49155) replicated, the
        residual's 256 positions split over the ranks (64 each); a prefill
        of 2 x 256, 2 decode steps of 8 lanes (the replicated body on
        ``decode_params``' weights, the cache's KV heads over the ranks)
        and one loss and backward at 2 x 256 (remat, as ``make_rules``
        trains);
    (b) the same with ``attn_mode="context"``: the prefill's query rows
        (the rank's positions) and the 1024 cache rows over the 4 ranks,
        the decode's softmax stats merged;
    (c) smollm-360m at full width and depth on (1, 4): 15 heads and 5 KV
        heads force context mode, the tied vocabulary (49152) split, the
        dense MLP's 2560 over 4; a prefill of 4 x 256, 2 decode steps, a
        loss and backward; no kernel of the port runs;
    (k) granite at 2 layers on (2, 2) from ``make_rules`` with
        ``moe_dispatch="dense"``: heads over "model", the batch and the
        dense weights' FSDP slices over "data", and every rank gathers the
        whole batch and the whole expert weights and runs the
        single-device ragged dispatch through the kernels (the reference's
        oracle under GSPMD); a prefill and a loss and backward at 4 x 256,
        against one device's ``rules=None`` (the witness routes the whole
        batch at once, as the ranks do). It took the place of (d), the
        same rules through the a2a body, which 16 (a) runs at full depth;

    and phase 16 (g) (:func:`sp_phase`), xlstm-350m on (2, 2), phase
    16 (h)-(j), the serving engine on (2, 2), its drills and its capacity
    path, and phase 17, the dry run against the card (:func:`_dryrun_rank`,
    :func:`dryrun_meta`), on the same ranks: one start of them for all (it
    takes ~30 s).

    (h): granite at full width and depth on (2, 2) from ``make_rules(cfg,
    grid, "prefill")`` (EP 2 over "model" at prefill, EP 4 over both axes
    at decode, FSDP over "data", heads over "model", 2 lanes a rank) serves
    the slice's 4 sharegpt requests, each cut to 8 output tokens,
    ``max_batch`` 4, under the ``vibe`` controller (``mi325x``, drift
    window :data:`ENGINE_DRIFT`), on the seed-0 weights. Held: every
    request finished, every logit finite; the step, token and KV counts
    the one-device engine's on the same requests (:func:`engine_reference`);
    the tallies global at every step (the engine's own assert) and every
    rank's tokens and tallies the same; after each placement change each
    rank's expert slices of both trees, by digest, the slices of the whole
    tree migrated on one device (:func:`_slices_hold`); a recalibration
    moved slots between ranks; the first prefill and decode step bit for
    bit against the one-device witness (:func:`_engine_witness`), the
    tokens and the TTFT within ``ENGINE_BOUNDS`` against the one-device
    engine as it runs; each rank's launches exact, and in the witness run
    every kernel call against its plain version (:class:`hold_calls`).

    (i): the same engine under ``vibe_h`` on a 2 x 4 topology at the
    policy's default slot budget (48 slots, the decode tree in the decode
    fleet's default 40) runs the chaos drill :data:`DRILL_SCHEDULE` with
    every step under the witness, beside the same drill on one device
    under the witness (a routing flip as it runs would move the masked
    re-solve): the chaos report field for field, the counts and the KV
    peak, every step's tokens and tallies and every TTFT, each rank's
    slices after each migration, no KV block held. (j): ``vibe`` on the
    capacity path (``make_rules(..., moe_impl="capacity")``, factor 1.5:
    the one-request prefill and decode both run the replicated body, its
    buckets sized from 2.0) as it runs: every rank's tokens, tallies and
    drops the same at every step, each call's drops the recount from its
    routing (:func:`_recount_drops`), ``dropped_assignments`` their sum.
    Both hold each kernel call of the steps up to the first decode step
    against its plain version.

    (a), (b), (k) and 16 (g) are held against a witness, one device
    computing the attention, the recurrent mixers and the row-wise steps
    as the ranks split them
    (:func:`_witness`) while the ranks add their partials in rank order
    (:class:`ordered_partials`; at decode also :class:`exact_decode_psum`):
    the prefill, each decode step and the loss bit for bit, the gradients
    within ``STEP_TOL`` (gloo sums the leaves' gradients over the ranks in
    its own order); and each run against one device as it runs, within
    ``TP_BOUNDS`` set from readings, the moved assignments counted."""
    import dataclasses
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    t_start = time.perf_counter()
    if dev.type == "cuda":
        build.build_all()
    smollm = smollm or get_config("smollm-360m")
    xlstm = xlstm or get_config("xlstm-350m")
    small = dataclasses.replace(cfg, n_layers=2)
    weights, inputs = {}, {}
    for name, c in (("granite", cfg), ("smollm", smollm), ("small", small)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        weights[name] = init_params(c, gen, device=dev, dtype=torch.bfloat16)
        if name != "small":
            inputs[name] = tp_inputs(c, dev, 15, 4 if name == "smollm"
                                     else 2, weights[name])
    weights["xlstm"], inputs["xlstm"] = _mixers_inputs(xlstm, dev)
    # (k)'s: a 4 x 256 batch (no decode, so no cache)
    g = torch.Generator().manual_seed(16)
    inputs["small"] = {k: torch.randint(0, small.vocab, (4, 256),
                                        generator=g).to(dev)
                       for k in ("tokens", "labels")}
    paths = ["prefill", "decode", "backward"]
    steps = TP_DECODE_STEPS
    plans = [
        {"label": "heads", "model": "granite", "cfg": cfg, "grid": (1, 4),
         "rules": {}, "witness": True, "paths": paths, "steps": steps},
        {"label": "context", "model": "granite", "cfg": cfg, "grid": (1, 4),
         "rules": {"attn_mode": "context"}, "witness": True,
         "paths": paths[:2], "steps": steps},
        {"label": "smollm", "model": "smollm", "cfg": smollm, "grid": (1, 4),
         "rules": {}, "witness": False, "paths": paths, "steps": steps,
         # its backward's exchange share (89.6-89.9%, PERF.md) is not
         # clocked again
         "clocked": ["prefill", "decode"]},
        # (k), which took the place of (d) (its rules with the a2a body:
        # 16 (a) runs them at full depth); the exchanges' share is not
        # clocked: the oracle's gathers are not a path that serves
        {"label": "dense", "model": "small", "cfg": small, "grid": (2, 2),
         "rules": {"fsdp": ("pod", "data"), "moe_dispatch": "dense"},
         "witness": True, "paths": ["prefill", "backward"], "steps": steps,
         "clocked": []},
        _mixers_plan(xlstm),
        {"label": "engine", "model": "granite", "cfg": cfg, "grid": (2, 2),
         "rules": {}, "witness": False, "paths": ["engine"], "steps": 1},
        {"label": "drills", "model": "granite", "cfg": cfg, "grid": (2, 2),
         "rules": {}, "witness": False, "paths": ["drills"], "steps": 1},
        {"label": "capacity", "model": "granite", "cfg": cfg,
         "grid": (2, 2), "rules": {"moe_impl": "capacity"},
         "witness": False, "paths": ["capacity"], "steps": 1},
        {"label": "dryrun", "model": "granite", "cfg": cfg,
         "grid": DRYRUN_GRID, "rules": {}, "witness": False,
         "paths": ["dryrun"], "steps": 1}]
    what = {"heads": "granite, heads (1, 4)",
            "context": "granite, context (1, 4)",
            "smollm": "smollm-360m, context (1, 4), no port kernel on its "
                      "path",
            "dense": "(k) granite 2 layers, the dense MoE oracle, heads "
                     "over model and dense FSDP over data (2, 2), 4 x 256",
            "xlstm": "phase 16 (g), xlstm-350m, mLSTM and sLSTM by heads "
                     "(2, 2)",
            "engine": "phase 16 (h), the serving engine (2, 2)",
            "drills": "phase 16 (i), the drills on the grid engine (2, 2)",
            "capacity": "phase 16 (j), the capacity path on the grid engine "
                        "(2, 2)",
            "dryrun": "phase 17, the dry run against the card (2, 2)"}
    return _grid_run("tp", plans, weights, inputs, dev,
                     dict(TP_BOUNDS, xlstm=SP_BOUNDS["xlstm"]), what,
                     t_start)


def sp_phase(cfg, dev, jamba=None, tp_peak_gib=None):
    """Phase 16: the batch over ``dp`` and the sequence-sharded residual
    (Megatron-SP) on 4 ranks sharing the card (gloo on CUDA tensors): each
    rank holds and computes only its own rows. Each run held against one
    device on the same weights in this run:

    (a) granite at full width and depth on (2, 2) from ``make_rules``: the
        batch over "data", attention by heads over "model" (12 heads and 4
        KV heads a rank), the residual's positions over "model", dense and
        expert FSDP over "data", EP over "model"; a prefill of 4 x 256, 4
        decode steps of 8 lanes (4 a rank; the cache's lanes and KV heads
        cut by ``rank_cache``) from one device's prefill of 8 x 1024, one
        loss and backward at 4 x 256 with remat;
    (b) granite on (1, 4) in context mode is phase 15 (b)'s run (every
        grid run splits the rows, so the rules, paths and shapes are the
        same) and runs there only;
    (c) jamba at its smoke size on (2, 2) from ``make_rules``: seven Mamba
        mixers split by channels over "model" (128 of 256 a rank), the
        attention by heads, the MoE layer (E 4, K 2) through the port's
        kernels; a prefill of 4 x 256, 4 decode steps, a loss and
        backward; every kernel call on the ranks against its plain
        version;
    (d) granite at 2 layers on (2, 2) as (a): every kernel call on the
        ranks (a prefill, a decode step, a loss and backward) against its
        plain version on the same inputs;
    (e) the same model and grid with dense and expert FSDP over "data"
        (as (a); ``make_rules`` gives it only above 1e9 params), (d)'s
        weights: two training steps of ``make_train_step`` at 4 x 256
        with remat, AdamW on each rank's slices clipped by the grid's
        global norm, from a state at step ``GRID_STEP0``; each step held
        against one device's ``adamw_apply`` on the gathered gradients
        (:class:`step_witness`): bit for bit with the norm's partials
        summed in rank order, within ``SP_BOUNDS`` as it runs; the first
        step's kernel calls against their plain versions; then the train
        state saved from the grid;
    (f) that checkpoint restored onto (1, 4) (``make_rules``' layout:
        no FSDP, the vocabulary whole), bit for bit against the saved
        state; and the parent restores it onto one device, its digest
        against the saved one's;
    (g) xlstm-350m at full width and depth on (2, 2) from ``make_rules``
        (24 layers, d 1024; the batch over "data", the residual's
        positions over "model", the 21 mLSTM and 3 sLSTM mixers split by
        heads over "model", 2 of 4 a rank, their states too; the
        vocabulary over "model"): a prefill of 4 x 256, 2 decode steps of
        8 lanes from one device's prefill of 8 x 256, one loss and
        backward with remat; the mixer weight and state bytes a rank. It
        runs on phase 15's ranks (:func:`_mixers_plan`) and prints with
        them.

    (a) and (g) are held bit for bit against the witness of
    :func:`_witness` (one device computing each ``dp`` block of the rows
    as a rank does, the attention and the recurrent mixers split as the
    ranks split them, the loss's cross entropy on each rank's rows
    averaged in rank order, the routing as a rank's a2a block plans it)
    with the ranks adding partials and the loss in rank order, gradients
    within ``STEP_TOL``; (a), (c) and (g) against one device as it runs
    within ``SP_BOUNDS`` set from readings. ``tp_peak_gib``: phase 15
    (a)'s peak a rank in this run, printed beside (a)'s."""
    import dataclasses
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.kernels import build
    from repro_torch.models import init_params
    t_start = time.perf_counter()
    if dev.type == "cuda":
        build.build_all()
    jamba = jamba or get_smoke("jamba-1.5-large-398b")
    small = dataclasses.replace(cfg, n_layers=2)
    weights, inputs = {}, {}
    for name, c in (("granite", cfg), ("jamba", jamba), ("small", small)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        weights[name] = init_params(c, gen, device=dev, dtype=torch.bfloat16)
        inputs[name] = tp_inputs(c, dev, 16, 4, weights[name])
    plans = [
        {"label": "dp_sp", "model": "granite", "cfg": cfg, "grid": (2, 2),
         "rules": {}, "witness": True,
         "paths": ["prefill", "decode", "backward"], "steps": SP_STEPS,
         # its backward's exchange share (90.7-91.0%, PERF.md) is not
         # clocked again
         "clocked": ["prefill", "decode"]},
        {"label": "jamba", "model": "jamba", "cfg": jamba, "grid": (2, 2),
         "rules": {}, "witness": False,
         "paths": ["prefill", "decode", "backward", "vs_plain"],
         "steps": SP_STEPS},
        {"label": "vs_plain", "model": "small", "cfg": small,
         "grid": (2, 2), "rules": {}, "witness": False,
         "paths": ["vs_plain"], "steps": 1},
        {"label": "step", "model": "small", "cfg": small, "grid": (2, 2),
         "rules": {"fsdp": ("pod", "data")}, "witness": False,
         "paths": ["step"], "steps": 1},
        {"label": "restore", "model": "small", "cfg": small,
         "grid": (1, 4), "rules": {}, "witness": False,
         "paths": ["restore"], "steps": 1}]
    what = {"dp_sp": "granite, dp 2 x (heads + SP) 2 (2, 2)",
            "jamba": "jamba smoke, Mamba by channels (2, 2)",
            "vs_plain": "granite 2 layers (2, 2)",
            "step": "granite 2 layers, the training step (2, 2) with FSDP",
            "restore": "granite 2 layers, (e)'s train state on (1, 4)"}
    beside = {}
    if tp_peak_gib is not None:
        beside["dp_sp"] = (f"phase 15 (a), granite heads on (1, 4) with the "
                           f"batch whole: {tp_peak_gib:.2f} GiB")
    shutil.rmtree(GRID_CKPT, ignore_errors=True)
    summary = _grid_run("sp", plans, weights, inputs, dev, SP_BOUNDS, what,
                        t_start, beside)
    summary["restore"]["one_device"] = _restore_one_device(
        weights["small"], summary["step"]["step"]["saved_digest"])
    shutil.rmtree(GRID_CKPT, ignore_errors=True)

    summary["reckoning"] = _state_reckoning(
        cfg, max(summary["dp_sp"]["peak_gib"]))
    summary["phase_s"]["all"] = time.perf_counter() - t_start
    return summary


def _mixers_inputs(xlstm, dev):
    """Phase 16 (g)'s weights (seed 0, bf16) and inputs: a prefill and a
    loss of 4 x 256, 2 decode steps of 8 lanes from one device's prefill
    of 8 x 256."""
    import torch
    from repro_torch.models import init_params
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = init_params(xlstm, gen, device=dev, dtype=torch.bfloat16)
    return params, tp_inputs(xlstm, dev, 16, 4, params, s_max=256)


def _mixers_plan(xlstm):
    """Phase 16 (g)'s plan (see :func:`sp_phase`): xlstm-350m on (2, 2)
    from ``make_rules``, held bit for bit against its witness. It runs on
    phase 15's ranks (:func:`tp_phase`): beside phase 16 (e)'s states the
    card has no room for its weights and one-device references, and ranks
    of its own would take ~30 s to start."""
    return {"label": "xlstm", "model": "xlstm", "cfg": xlstm,
            "grid": (2, 2), "rules": {}, "witness": True,
            "paths": ["prefill", "decode", "backward"], "steps": 2}


# phase 16 (h)-(j): the serving engine on the grid, its drills, its
# capacity path
ENGINE_REQUESTS = 4
ENGINE_MAX_BATCH = 4
ENGINE_MAX_SEQ = 1024
# the controller's drift window: the slice's (``build_engine``: 20 steps)
# would not fill in the 11 steps of 4 requests of 8 tokens, so nothing
# would recalibrate; a rolling mean of 4 steps, checked every 2 after a
# cooldown of 4, recalibrates once decode steps follow the prefills
ENGINE_DRIFT = dict(window=4, interval=2, cooldown=4)
# The grid engine against the one-device engine as it runs (the witness
# holds the first prefill and decode bit for bit): the share of the
# logged (step, lane) tokens that differ, and the largest relative
# difference of a request's TTFT on the virtual clock; set at about twice
# the readings on an H100 80GB HBM3 at 700 W (PERF.md, PR 23, at 16
# output tokens; the same in two calls): 13 of 76 tokens (a lane's greedy
# token flips at a near tie, and the lane decodes another sequence from
# there), TTFT 1.7e-3.
ENGINE_BOUNDS = {"tokens": 0.35, "ttft": 3.5e-3}
# (i)'s chaos schedule on the 8 virtual ranks: rank 3 (lane 3, which the
# grid puts on dp rank 1) fails once the 4 prompts are in and decoding,
# another rank stalls, the DCN degrades, and rank 3 recovers
DRILL_SCHEDULE = "fail@5:3,stall@6:2x0.4+0.5,dcn@7x0.5+0.8,recover@10:3"
# each served plan's output tokens a request and engine (``_engine``'s
# keywords): (h) the slice's ``vibe`` with the short drift window; (i) the
# drills' ``vibe_h`` on a 2 x 4 topology at the policy's default slot
# budget (``vibe`` cannot re-solve 40 experts over 7 survivors) with the
# serve driver's window; (j) as (h), its rules the capacity path's (the
# plan's). Outputs cut to what each needs (a decode step takes ~1 s a
# rank): (h) recalibrates once decode steps follow the prefills, (i)'s
# faults all fire before the queue drains, (j)'s drops are the prefills'
SERVED = {"engine": {"output": 8, "engine": {"policy": "vibe",
                                             "drift": ENGINE_DRIFT}},
          "drills": {"output": 6, "engine": {
              "policy": "vibe_h", "topology": "2x4",
              "drift": dict(window=20, interval=5, cooldown=5)}},
          "capacity": {"output": 4, "engine": {"policy": "vibe",
                                               "drift": ENGINE_DRIFT}}}


def _served(plan):
    """The served path of ``plan`` (a key of :data:`SERVED`), or None."""
    return next((p for p in plan["paths"] if p in SERVED), None)


def _engine(cfg, rules, params, dev, policy="vibe", topology=None,
            drift=ENGINE_DRIFT):
    """Phase 16 (h)-(j)'s engine: the slice's construction (``build_engine``:
    the controller under ``policy`` at its default slot budget on 8 virtual
    ranks of the ``mi325x`` regime, seed 0, on ``topology`` where given)
    with the drift window ``drift``, on ``rules`` (a grid's, or ``None``:
    one device) and the whole tree ``params``."""
    from repro_torch.core import (DriftConfig, ViBEConfig, ViBEController,
                                  make_cluster, parse_topology)
    from repro_torch.models import moe_perm_shape
    from repro_torch.serving import Engine, EngineConfig
    n_moe, n_slots = moe_perm_shape(cfg, rules)
    ranks = min(8, n_slots)
    cluster = make_cluster(ranks, "mi325x", d_model=cfg.d_model,
                           d_ff=cfg.moe_d_ff,
                           experts_per_rank=max(n_slots // ranks, 1), seed=0)
    topo = (parse_topology(topology, ici_bw=cluster.ici_bw) if topology
            else None)
    ctl = ViBEController(
        n_moe, n_slots, ranks, cluster.fit_models(),
        ViBEConfig(policy=policy, drift=DriftConfig(**drift),
                   expert_bytes=3 * cfg.d_model * cfg.moe_d_ff * 2,
                   topology=topo))
    return Engine(cfg, EngineConfig(max_batch=ENGINE_MAX_BATCH,
                                    max_seq=ENGINE_MAX_SEQ, seed=0,
                                    topology=topo),
                  rules=rules, controller=ctl, cluster=cluster, device=dev,
                  params=params)


def _engine_requests(kind):
    """The slice's 4 sharegpt requests, their outputs cut to the served
    plan ``kind``'s (:data:`SERVED`)."""
    import dataclasses
    from repro_torch.launch.serve import make_requests
    cap = SERVED[kind]["output"]
    return [dataclasses.replace(r, output_len=min(r.output_len, cap))
            for r in make_requests("sharegpt", ENGINE_REQUESTS, qps=50.0,
                                   max_seq=ENGINE_MAX_SEQ, seed=0)]


def _serve(engine, kind):
    """The requests through ``engine``: (i)'s chaos drill (its report), or
    the step loop (None)."""
    from repro_torch.serving import FaultSchedule, run_chaos
    reqs = _engine_requests(kind)
    if kind == "drills":
        return run_chaos(engine, reqs, FaultSchedule.parse(DRILL_SCHEDULE,
                                                           8))
    engine.submit(reqs)
    engine.run()
    return None


def _chaos_fields(rep):
    """A chaos report's faults, comparable across engines: each applied
    spec with its result (a report's fields, a stall's event, a DCN
    window's bandwidth), the skipped, the steps and the violations."""
    import dataclasses
    applied = [(dataclasses.astuple(s),
                {"dcn_bw": res.dcn_bw} if s.kind == "dcn_degrade"
                else dataclasses.asdict(res)) for s, res in rep.applied]
    return {"applied": applied,
            "skipped": [(dataclasses.astuple(s), why)
                        for s, why in rep.skipped],
            "steps": rep.steps, "violations": list(rep.violations)}


def _watch_engine(engine, ctx=None):
    """Wrap ``engine``'s model calls and telemetry. Each prefill and decode
    call runs inside ``ctx(kind)`` where given, synchronised and timed on
    the host; the log keeps each call's wall, whether its logits are
    finite, its tallies' sum and drop column, the first call of each
    kind's logits and tallies, and the lanes' tokens after each step."""
    import contextlib
    import torch
    log = {"walls": {"prefill": [], "decode": []}, "finite": [],
           "tally_sums": [], "drops": [], "first": {}, "tokens": [],
           "kinds": [], "rows": []}

    def wrap(kind, fn):
        def call(*args, **kw):
            _sync()
            t0 = time.perf_counter()
            with (ctx(kind) if ctx else contextlib.nullcontext()):
                res = fn(*args, **kw)
            _sync()
            log["walls"][kind].append(time.perf_counter() - t0)
            log["kinds"].append(kind)
            log["rows"].append(args[1]["tokens"].shape[1] if kind == "prefill"
                               else args[1].shape[0])
            log["finite"].append(bool(torch.isfinite(res[0]).all()))
            log["tally_sums"].append(float(res[2].sum()))
            log["drops"].append(res[2][:, -1].cpu().tolist())
            log["first"].setdefault(kind, (res[0].clone(), res[2].clone()))
            return res
        return call

    engine._prefill = wrap("prefill", engine._prefill)
    engine._decode = wrap("decode", engine._decode)
    observe = engine.observe_step

    def observing(tallies, tokens, latencies=None):
        log["tokens"].append(engine.tokens.cpu().numpy().copy())
        return observe(tallies, tokens, latencies)

    engine.observe_step = observing
    return log


def _engine_witness(w, kind):
    """The one-device witness of the grid engine's prefill (batch 1: every
    rank computes the whole prompt, attention split by heads; the MoE
    layer's replicated body adds the ranks' rows, nonzero on one rank
    each) or decode (the lanes in ``dp`` blocks): :class:`split_attention`
    and :class:`split_rows` (the ranks run under
    :class:`ordered_partials` and :class:`exact_decode_psum`)."""
    import contextlib
    dp, batch = (1, 1) if kind == "prefill" else (w["dp"], ENGINE_MAX_BATCH)
    stack = contextlib.ExitStack()
    stack.enter_context(split_attention(w["mode"], w["tp"], dp))
    stack.enter_context(split_rows(dp, w["xent_tp"], batch, w["vocab_tp"]))
    return stack


def _engine_ranks_witness():
    """The ranks' side of :func:`_engine_witness`: the model's sums of
    rank partials in rank order, the MoE layer's replicated body's rows
    summed over the ranks before the k-order sum."""
    import contextlib
    stack = contextlib.ExitStack()
    stack.enter_context(ordered_partials())
    stack.enter_context(exact_decode_psum())
    return stack


def engine_reference(cfg, dev, params, w, kind="engine"):
    """The one-device runs of a served plan on ``params``. (h): the engine
    as it runs (its counts, tokens, TTFTs, walls and migrations) and,
    under the witness ``w`` (:func:`_engine_witness`), the first prefill's
    and the first decode step's logits and tallies. (i): the chaos drill
    under the witness from its first step to its last (a routing flip as
    it runs would move the masked re-solve), its report, counts, tokens,
    tallies and TTFTs. Each engine is collected before the next (its
    wrapped methods hold it in a cycle)."""
    import gc
    import torch
    from repro_torch.serving import summarize
    ref = {}
    if kind == "engine":
        eng = _engine(cfg, None, params, dev, **SERVED[kind]["engine"])
        log = _watch_engine(eng)
        _serve(eng, kind)
        st = eng.stats
        ref = {"counts": {f: getattr(st, f) for f in (
            "steps", "prefill_steps", "decode_steps", "prefill_tokens",
            "decode_tokens")}, "kv_peak": eng.kv.peak_blocks,
            "tokens": log["tokens"], "walls": log["walls"],
            "ttft": {rid: r.first_token_at - r.arrival
                     for rid, r in eng.records.items()},
            "migrations": st.migrations, "migrated_slots": st.migrated_slots,
            "ttft_p50": summarize(list(eng.records.values()))["ttft_p50"]}
        del eng, log
        gc.collect()
    eng = _engine(cfg, None, params, dev, **SERVED[kind]["engine"])
    log = _watch_engine(eng, lambda k: _engine_witness(w, k))
    with torch.no_grad():
        if kind == "drills":
            rep = _serve(eng, kind)
            st = eng.stats
            ref = {"counts": {f: getattr(st, f) for f in (
                "steps", "prefill_steps", "decode_steps", "prefill_tokens",
                "decode_tokens", "useful_tokens", "lost_tokens",
                "migrations", "migrated_slots", "migration_bytes",
                "virtual_time")}, "kv_peak": eng.kv.peak_blocks,
                "tokens": log["tokens"], "tally_sums": log["tally_sums"],
                "walls": log["walls"], "report": _chaos_fields(rep),
                "ttft": {rid: r.first_token_at - r.arrival
                         for rid, r in eng.records.items()},
                "requeues": [r.requeues for r in eng.records.values()],
                "ttft_p50": summarize(list(eng.records.values()))[
                    "ttft_p50"]}
        else:
            eng.submit(_engine_requests(kind))
            while eng.stats.decode_steps < 1:
                eng.step()
    ref["witness"] = log["first"]
    del eng, log
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return ref


def _slices_hold(engine, whole, gather, rules, dec_gather=None):
    """Whether each of the rank's expert slices of both trees is, block by
    block, by its digest, the slice ``param_cuts`` cuts from the whole tree
    migrated on one device: slot ``p`` of MoE row ``l`` holding the whole
    tree's slot ``gather[l, p]`` (the composition of each placement
    change's ``placement_gather_indices``; what ``apply_placement`` gives
    applied change by change); the decode tree's slot ``q`` the whole
    tree's ``dec_gather[l, q]`` where its layout does not follow the
    placement."""
    import numpy as np
    import torch
    from repro_torch.launch.sharding import cut_tree, param_cuts
    from repro_torch.models.model import block_layout
    cfg = engine.cfg
    nb, specs = block_layout(cfg)
    pos = [i for i, sp in enumerate(specs) if sp.ffn == "moe"]
    ok = True
    for phase, tree, g in (("prefill", engine.params, gather),
                           ("decode", engine.decode_params,
                            gather if dec_gather is None else dec_gather)):
        cuts = param_cuts(cfg, rules, phase)["blocks"]
        for jj, i in enumerate(pos):
            rows = np.arange(nb) * len(pos) + jj
            for k in ("w1", "w3", "w2"):
                src, got = whole["blocks"][i]["ffn"][k], \
                    tree["blocks"][i]["ffn"][k]
                for b in range(nb):
                    idx = torch.as_tensor(g[rows[b]], device=src.device)
                    want = cut_tree(src[b:b + 1, idx],
                                    cuts[i]["ffn"][k], rules.grid)[0]
                    ok &= _bits_digest(want) == _bits_digest(got[b])
    return bool(ok)


class clocked:
    """Within the block the exchanges are clocked (``collectives.clock``,
    each synchronised); on leaving it ``store[key]`` holds the block's
    wall, the exchanges' seconds, calls and bytes, and ``extra``."""

    def __init__(self, store, key, **extra):
        self.store, self.key, self.extra = store, key, extra

    def __enter__(self):
        from repro_torch.models import collectives
        collectives.clock.reset()
        collectives.clock.enabled = True
        _sync()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import collectives
        _sync()
        c = collectives.clock
        c.enabled = False
        self.store[self.key] = {"wall_s": time.perf_counter() - self.t0,
                                "exchange_s": c.seconds, "calls": c.calls,
                                "bytes": c.bytes} | self.extra


class capture_slots:
    """Within the block each routing call's slots (t, top_k) are kept on
    the host, in call order (for a recount of the capacity drops)."""

    def __enter__(self):
        from repro_torch.models import moe as tmoe
        self.saved = real = tmoe.ops
        self.calls = calls = []

        class Ops:
            def __getattr__(self, name):
                return getattr(real, name)

            @staticmethod
            def route_select(*args, **kw):
                res = real.route_select(*args, **kw)
                calls.append(res[2].cpu().numpy())
                return res

        tmoe.ops = Ops()
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe as tmoe
        tmoe.ops = self.saved


def _recount_drops(slots, t, top_k, n_slots, cf):
    """A replicated capacity body's drops in one layer, recounted from its
    routing (every rank routes the call's ``t`` rows whole): each slot
    keeps its first ``C`` assignments, ``C`` sized as ``moe_layer`` sizes
    it from ``max(cf, 2)``. Returns (drops, C)."""
    import numpy as np
    cap = max(math.ceil(t * top_k / n_slots * max(cf, 2.0)), 4)
    cap = -(-cap // 4) * 4
    counts = np.bincount(slots.reshape(-1), minlength=n_slots)
    return int(np.maximum(counts - cap, 0).sum()), cap


def _engine_rank(cfg, rules, params, ref, dev, kind="engine"):
    """Phase 16 (h)-(j) on one rank (see :func:`tp_phase`): the plan's
    engine on the requests (``kind``: the step loop, or (i)'s chaos drill
    with each fault timed), each placement change timed and its slices
    checked (:func:`_slices_hold`). (h): the steps up to the first decode
    step under the witness (:class:`ordered_partials`,
    :class:`exact_decode_psum`), the later ones as it runs; (i): every
    step under the witness; (j): as it runs, each routing call's slots
    kept for the recount of the drops. (h), (i): the steps up to the first
    decode step hold each kernel call against its plain version, (j): its
    first prefill and decode step; (h): its second decode step runs with
    the exchanges clocked, (j): its second prefill and decode step (each
    as it runs). Returns the numbers; the parent checks them."""
    import contextlib
    import gc
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models.model import default_moe_perm
    from repro_torch.models.moe import placement_gather_indices
    cuda = dev.type == "cuda"
    out = {}
    _sync()
    t0 = time.perf_counter()
    eng = _engine(cfg, rules, params, dev, **SERVED[kind]["engine"])
    _sync()
    out["build_s"] = time.perf_counter() - t0
    out["build_peak_bytes"] = (torch.cuda.max_memory_allocated() if cuda
                               else 0)
    n_slots, n_whole = eng.n_slots, params["blocks"][0]["ffn"]["w1"].shape[1]
    # the table at the cut: the whole tree's slots, grown round-robin
    grown = np.tile(np.concatenate([np.arange(n_whole), np.arange(
        n_whole, n_slots) % cfg.n_experts]).astype(np.int32), (eng.n_moe, 1))
    gather = np.take_along_axis(
        grown, placement_gather_indices(grown, eng._perm), axis=1)
    out["follows"], out["n_slots"] = eng._dec_follows, n_slots
    # a decode layout that does not follow holds each expert's whole slot
    dec_gather = (None if eng._dec_follows
                  else default_moe_perm(cfg, rules, "decode"))
    migrations = [{"wall_s": 0.0, "slots": 0, "rank_bytes":
                   eng.stats.migration_rank_bytes, "construction": True,
                   "holds": _slices_hold(eng, params, gather, rules,
                                         dec_gather)}]
    real_apply = eng._apply_perm

    def timed_apply(new_perm, *args, **kw):
        nonlocal gather
        before, sent = eng._perm.copy(), eng.stats.migration_rank_bytes
        _sync()
        t0 = time.perf_counter()
        moved = real_apply(new_perm, *args, **kw)
        _sync()
        wall = time.perf_counter() - t0
        gi = placement_gather_indices(before, eng._perm)
        gather = np.take_along_axis(gather, gi, axis=1)
        migrations.append({"wall_s": wall, "slots": moved,
                           "rank_bytes": eng.stats.migration_rank_bytes
                           - sent, "construction": False,
                           "holds": _slices_hold(eng, params, gather,
                                                 rules, dec_gather)})
        return moved

    eng._apply_perm = timed_apply
    held = hold_calls()

    out["exchange"] = {}

    def witness(k):
        first = not log["walls"]["decode"]        # up to the first decode
        stack = (_engine_ranks_witness() if kind == "drills"
                 or (kind == "engine" and first)
                 else contextlib.ExitStack())
        # (h), (i): the calls up to the first decode step held; (j): the
        # first call of each kind. (h): the second decode step clocked,
        # (j): the second call of each kind (they run as they run)
        n = len(log["walls"][k])
        if (first if kind != "capacity" else n == 0):
            stack.enter_context(held)
        if n == 1 and (kind == "capacity"
                       or (kind == "engine" and k == "decode")):
            stack.enter_context(clocked(out["exchange"], k,
                                        call=len(log["kinds"])))
        return stack

    log = _watch_engine(eng, witness)
    no_grad_weights(eng.params, f"phase 16 {kind}")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad(), contextlib.ExitStack() as stack:
        faults = (stack.enter_context(timed_faults()) if kind == "drills"
                  else None)
        slots = (stack.enter_context(capture_slots()) if kind == "capacity"
                 else None)
        rep = _serve(eng, kind)
    _sync()
    out["run_s"] = time.perf_counter() - t0
    out["launches"] = attn_routed(ops.launch_counts(), "grid engine")
    out["bits"] = {k: bool(torch.equal(log["first"][k][0],
                                       ref["witness"][k][0])
                           and torch.equal(log["first"][k][1],
                                           ref["witness"][k][1]))
                   for k in ("prefill", "decode")} if ref else {}
    out["vs_plain"] = {"calls": dict(held.calls), "err": dict(held.err),
                       "route_mismatch": held.route_mismatch,
                       "near_rows": held.near_rows,
                       "rows_that_differ": held.rows_that_differ}
    st = eng.stats
    out["counts"] = {f: getattr(st, f) for f in (
        "steps", "prefill_steps", "decode_steps", "prefill_tokens",
        "decode_tokens", "useful_tokens", "lost_tokens", "migrations",
        "migrated_slots", "migration_bytes", "virtual_time")}
    out["kv_peak"] = eng.kv.peak_blocks
    out["kv_held"] = (eng.kv.used_blocks, eng.kv.n_seqs)
    out["finished"] = sum(bool(np.isfinite(r.finished_at))
                          for r in eng.records.values())
    out["ttft"] = {rid: r.first_token_at - r.arrival
                   for rid, r in eng.records.items()}
    out["requeues"] = [r.requeues for r in eng.records.values()]
    out["stats"] = {"migrations": st.migrations,
                    "migrated_slots": st.migrated_slots,
                    "migration_bytes": st.migration_bytes,
                    "migration_rank_bytes": st.migration_rank_bytes,
                    "dropped_assignments": st.dropped_assignments}
    out["migrations"] = migrations
    out |= {k: log[k] for k in ("walls", "finite", "tally_sums", "tokens",
                                "drops", "kinds")}
    out["calls"] = len(log["finite"])
    out["held_calls"] = (2 if kind == "capacity"
                         else log["kinds"].index("decode") + 1)
    out["rows"] = log["rows"]
    out["prompts"] = [r.prompt_len for r in _engine_requests(kind)]
    out["peak_bytes"] = torch.cuda.max_memory_allocated() if cuda else 0
    if rep is not None:
        out["report"] = _chaos_fields(rep)
        out["faults"] = faults.calls
    if slots is not None:
        # each call's drops a layer, recounted (the replicated body: every
        # rank routed the call's rows whole)
        L, K = eng.n_moe, cfg.top_k
        out["recount"], out["capacity_rows"], out["routed_whole"] = [], [], []
        for c, (kind_c, t) in enumerate(zip(log["kinds"], log["rows"])):
            n = n_slots if kind_c == "prefill" else eng.n_dec
            got = [_recount_drops(s, t, K, n, rules.capacity_factor)
                   for s in slots.calls[c * L:(c + 1) * L]]
            out["recount"].append([g[0] for g in got])
            out["capacity_rows"].append(got[0][1])
            out["routed_whole"].append(all(
                s.shape[0] == t for s in slots.calls[c * L:(c + 1) * L]))
        out["route_calls"] = len(slots.calls)
    for x in out["exchange"].values():
        x["prompt"] = log["rows"][x.pop("call")]
    del eng, log
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out


def _each(xs, scale=1.0, fmt="{:.1f}"):
    return ", ".join(fmt.format(x * scale) for x in xs)


def _engine_report(tag, label, cfg, rs, ref, kernel_bounds, on_card,
                   kind="engine"):
    """Phase 16 (h)-(j)'s checks on the ranks' results ``rs`` (against the
    one-device runs ``ref`` for (h) and (i)), its printed lines, and its
    summary."""
    import numpy as np
    K, L = cfg.top_k, cfg.n_layers
    name = f"{tag} {label}"
    part = {"engine": "(h)", "drills": "(i)", "capacity": "(j)"}[kind]
    ffn = "fused_moe_ffn" if kind == "capacity" else "ragged_moe_ffn"
    for r in rs:
        who = f"{name} rank {r['rank']}"
        check(r["finished"] == ENGINE_REQUESTS and all(r["finite"]),
              f"{who}: every request finished, every logit finite")
        check(all(m["holds"] for m in r["migrations"]),
              f"{who}: the expert slices of both trees after each placement "
              f"change against the whole tree migrated on one device "
              f"{[m['holds'] for m in r['migrations']]}")
        n = L * r["calls"]
        want = {"route_select": n, ffn: n, f"{ffn}.tma": n} | attn_want(
            cfg, r["counts"]["prefill_steps"], r["counts"]["decode_steps"])
        for k, c in r["launches"].items():
            check(c == want.get(k, 0) or not on_card,
                  f"{who}: {k} launched {c} times, expected "
                  f"{want.get(k, 0)} ({L} x {r['calls']} model calls)")
        vp = r["vs_plain"]
        calls = {"route_select": r["held_calls"] * L,
                 ffn: r["held_calls"] * L}
        check(vp["calls"] == calls and vp["route_mismatch"] == 0 and all(
            vp["err"].get(k, 0.0) <= v for k, v in kernel_bounds.items()),
              f"{who}: kernel calls against their plain versions "
              f"{json.dumps(vp)} (expected {calls}, bounds "
              f"{kernel_bounds})")
        if kind == "capacity":
            continue
        check(r["counts"]["steps"] == ref["counts"]["steps"] and all(
            r["counts"][f] == v for f, v in ref["counts"].items())
              and r["kv_peak"] == ref["kv_peak"],
              f"{who}: counts and KV {r['counts']}, {r['kv_peak']} "
              f"against one device's {ref['counts']}, {ref['kv_peak']}")
        check(all(r["bits"].values()), f"{who}: the first prefill and decode "
              f"step against the witness, bit for bit {r['bits']}")
        if kind == "engine":
            check(r["follows"], f"{who}: the decode layout follows the a2a "
                  "placement (40 slots in both)")
            continue
        check(not r["follows"] and r["n_slots"] > cfg.n_experts,
              f"{who}: {r['n_slots']} slots, the decode tree in the fleet's "
              f"default layout")
        check(r["kv_held"] == (0, 0), f"{who}: KV blocks and sequences "
              f"held after the drill {r['kv_held']}")
        check(r["report"] == ref["report"] and r["report"]["violations"]
              == [] and r["requeues"] == ref["requeues"],
              f"{who}: the chaos report {json.dumps(r['report'])} against "
              f"one device's {json.dumps(ref['report'])}, requeues "
              f"{r['requeues']} / {ref['requeues']}")
        check(len(r["tokens"]) == len(ref["tokens"]) and all(
            np.array_equal(a, b) for a, b in zip(r["tokens"], ref["tokens"]))
              and r["tally_sums"] == ref["tally_sums"]
              and r["ttft"] == ref["ttft"],
              f"{who}: every step's tokens and tallies and every TTFT "
              f"against the one-device drill under the witness")
    first = rs[0]
    for r in rs[1:]:
        check(len(r["tokens"]) == len(first["tokens"]) and all(
            np.array_equal(a, b) for a, b in zip(r["tokens"],
                                                 first["tokens"]))
              and r["tally_sums"] == first["tally_sums"]
              and r["drops"] == first["drops"]
              and r.get("report") == first.get("report"),
              f"{name}: rank {r['rank']}'s tokens, tallies, drops and faults "
              f"against rank 0's, step by step")
    gib = 2 ** 30
    c = first["counts"]
    s = {"launches_rank0": {kind: first["launches"]},
         "calls": first["calls"], "migrations": first["migrations"],
         "stats": first["stats"], "counts": c,
         "peak_gib": [r["peak_bytes"] / gib for r in rs],
         "build_peak_gib": [r["build_peak_bytes"] / gib for r in rs],
         "bits": first["bits"], "vs_plain": first["vs_plain"]}
    walls = {"prefill": [statistics.median(r["walls"]["prefill"])
                         for r in rs],
             "decode": [statistics.median(r["walls"]["decode"][1:])
                        for r in rs]}
    s["walls_s"] = walls
    print(f"[{tag}] phase 16 {part}, {label} on (2, 2): {c['steps']} steps "
          f"({c['prefill_steps']} prefill / {c['decode_steps']} decode), "
          f"{c['prefill_tokens']} prefill + {c['decode_tokens']} decode "
          f"tokens, KV peak {first['kv_peak']} blocks, {first['n_slots']} "
          f"slots; built in {_each([r['build_s'] for r in rs], fmt='{:.2f}')}"
          f" s, served in {_each([r['run_s'] for r in rs], fmt='{:.2f}')} s "
          f"a rank; host wall a rank (median, ms) prefill "
          f"{_each(walls['prefill'], 1e3)} (rank 0, prompts of "
          f"{first['prompts']} tokens in order: "
          f"{_each(first['walls']['prefill'], 1e3)}), decode "
          f"{_each(walls['decode'], 1e3)}"
          + (" (every step under the witness)" if kind == "drills" else ""),
          flush=True)
    print(f"[{tag}] phase 16 {part} placement changes (rank 0; the first is "
          f"the construction's): walls (s) "
          f"{[round(m['wall_s'], 4) for m in first['migrations']]}, slots "
          f"moved {[m['slots'] for m in first['migrations']]} (stats "
          f"{json.dumps(first['stats'])}); expert bytes sent to other ranks "
          f"a rank " + "; ".join(
              f"rank {r['rank']} {[m['rank_bytes'] for m in r['migrations']]}"
              for r in rs)
          + "; slices against the whole tree migrated on one device "
          f"{[m['holds'] for m in first['migrations']]}; peak a rank "
          f"{_each(s['peak_gib'], fmt='{:.2f}')} GiB"
          + (" (since the last fault)" if kind == "drills" else "")
          + f", {_each(s['build_peak_gib'], fmt='{:.2f}')} GiB by the end "
          f"of the construction; launches a rank "
          f"(rank 0) {json.dumps(first['launches'])} for {first['calls']} "
          f"model calls; the first steps' kernel calls against their plain "
          f"versions {json.dumps(first['vs_plain'])}", flush=True)
    if first["exchange"]:
        ex = {k: [r["exchange"][k] for r in rs] for k in first["exchange"]}
        s["exchange"] = ex
        print(f"[{tag}] phase 16 {part} exchanges (each synchronised, rank "
              f"0's calls and bytes): " + "; ".join(
                  f"{k} ({xs[0]['prompt'] if k == 'prefill' else ENGINE_MAX_BATCH}"
                  f" {'tokens' if k == 'prefill' else 'lanes'}): "
                  + ", ".join(f"{100 * x['exchange_s'] / x['wall_s']:.1f}%"
                              for x in xs)
                  + f" of {xs[0]['wall_s'] * 1e3:.1f} ms, {xs[0]['calls']} "
                    f"calls, {xs[0]['bytes'] / 2 ** 20:.3f} MiB"
                  for k, xs in ex.items()), flush=True)
    if kind == "engine":
        steps = len(ref["tokens"])
        differ = sum(int((a != b).sum()) for a, b in zip(first["tokens"],
                                                           ref["tokens"]))
        token_share = differ / (steps * ENGINE_MAX_BATCH)
        ttft = max(abs(first["ttft"][k] - v) / v
                   for k, v in ref["ttft"].items())
        check(token_share <= ENGINE_BOUNDS["tokens"]
              and ttft <= ENGINE_BOUNDS["ttft"],
              f"{name} against one device as it runs: tokens that differ "
              f"{token_share:.4f} of {steps} steps x {ENGINE_MAX_BATCH} "
              f"lanes, TTFT {ttft:.4f} relative (bounds {ENGINE_BOUNDS})")
        moved = [m for m in first["migrations"] if not m["construction"]]
        crossed = max(m["rank_bytes"] for r in rs for m in r["migrations"]
                      if not m["construction"]) if moved else 0
        check(first["stats"]["migrations"] >= 1 and crossed > 0,
              f"{name}: a recalibration moved slots between ranks "
              f"({first['stats']})")
        routed = [t / (K * L) for t in first["tally_sums"]]
        print(f"[{tag}] phase 16 (h): assignments a layer and call "
              f"(tallies' sum / (top-k x layers)) {routed} (top-{K} x rows: "
              f"global); against one device as it runs: tokens that differ "
              f"{differ} of {steps * ENGINE_MAX_BATCH}, largest TTFT "
              f"difference {ttft:.4f} relative (p50 one device "
              f"{ref['ttft_p50']:.4f} s; one device's walls (median, ms) "
              f"prefill {statistics.median(ref['walls']['prefill']) * 1e3:.1f}"
              f", decode {statistics.median(ref['walls']['decode']) * 1e3:.1f}"
              f"; {ref['migrations']} recalibrations, {ref['migrated_slots']} "
              f"slots); the first prefill and decode against the witness "
              f"{first['bits']}", flush=True)
        s |= {"token_share_differ": token_share, "ttft_rel": ttft}
    elif kind == "drills":
        faults = [[{"fault": f, "rank": v, "wall_s": w, "rank_bytes": b,
                    "peak_gib": p / gib} for f, v, w, _, p, b in r["faults"]]
                  for r in rs]
        changes = len(first["migrations"]) - 1
        check(any(m["rank_bytes"] > 0 for r in rs for m in r["migrations"][1:])
              and len(first["faults"]) == 2,
              f"{name}: fail_rank and recover_rank ran and moved slots "
              f"between ranks ({first['faults']})")
        s |= {"report": first["report"], "faults": faults}
        print(f"[{tag}] phase 16 (i) chaos {DRILL_SCHEDULE}: "
              f"{json.dumps(first['report'])} (one device under the witness "
              f"the same: {first['report'] == ref['report']}); requeues "
              f"{first['requeues']}; faults a rank (wall, expert bytes sent,"
              f" peak): " + "; ".join(
                  f"rank {r['rank']} " + ", ".join(
                      f"{x['fault']}({x['rank']}) {x['wall_s'] * 1e3:.1f} ms "
                      f"{x['rank_bytes']} B {x['peak_gib']:.2f} GiB"
                      for x in fs) for r, fs in zip(rs, faults))
              + f"; {changes} placement changes after the construction; "
              f"the first prefill and decode against the witness "
              f"{first['bits']}; TTFT p50 one device {ref['ttft_p50']:.4f} s",
              flush=True)
    else:
        total = sum(sum(d) for d in first["drops"])
        recount = sum(sum(d) for d in first["recount"])
        for r in rs:
            who = f"{name} rank {r['rank']}"
            check(r["stats"]["dropped_assignments"] == sum(
                sum(d) for d in r["drops"]) and all(r["routed_whole"])
                  and r["route_calls"] == L * r["calls"]
                  and [[float(x) for x in d] for d in r["recount"]]
                  == r["drops"],
                  f"{who}: dropped assignments "
                  f"{r['stats']['dropped_assignments']} the calls' drop "
                  f"columns summed once, each call's drops the recount from "
                  f"its routing (the replicated body, every rank routing "
                  f"the call's rows whole: {all(r['routed_whole'])})")
        check(total > 0, f"{name}: no assignment dropped")
        per_call = [sum(d) for d in first["drops"]]
        s |= {"dropped": total, "drops_per_call": per_call,
              "capacity_rows": first["capacity_rows"]}
        print(f"[{tag}] phase 16 (j): dropped assignments {total:.0f} "
              f"(recount {recount}), a call {per_call} (kinds "
              f"{first['kinds']}), bucket rows a slot {first['capacity_rows']}"
              f" (the replicated body: max(1.5, 2) x the mean load, rounded "
              f"up to 4)", flush=True)
    return s


def _restore_one_device(params, digest):
    """(e)'s train state restored onto one device in the parent (the
    checkpoint is whole: no cuts), its leaves' digest held against the
    saved state's. Returns the wall and the result."""
    import torch
    from repro_torch.training import adamw_init, load_checkpoint
    like = {"params": params, "opt": adamw_init(params)}
    _sync()
    t0 = time.perf_counter()
    state, _ = load_checkpoint(str(GRID_CKPT), GRID_STEP0 + 2, like)
    _sync()
    wall = time.perf_counter() - t0
    del like
    same = _bits_digest(state) == digest
    check(same, "sp (e)'s train state restored onto one device: its digest "
                "against the saved state's")
    print(f"[sp] granite 2 layers, (e)'s train state restored onto one "
          f"device: {wall:.2f} s, {len(digest)} leaves, the digest of "
          f"their bits as saved: {same}", flush=True)
    return {"restore_s": wall, "digest_equal": same}


def _state_reckoning(cfg, peak_gib):
    """What (e) would hold at ``cfg``'s full depth on (2, 2) with FSDP
    over "data", from the shapes (meta tensors): the params a rank, its
    f32 mu, nu and master, and beside them phase 16 (a)'s peak a rank in
    this run (``peak_gib``) and the parent's whole bf16 tree. Printed,
    not run: it does not fit on one card."""
    import dataclasses
    from repro_torch.launch.mesh import Grid
    from repro_torch.launch.sharding import make_rules, shard_params
    from repro_torch.models import init_params
    from repro_torch.tree import leaves
    meta = init_params(cfg, None, device="meta")
    rules = dataclasses.replace(make_rules(cfg, Grid((2, 2), EP_AXES, 0, {}),
                                           "train"), fsdp=("pod", "data"))
    n_rank = sum(t.numel() for t in leaves(shard_params(cfg, meta, rules)))
    n_whole = sum(t.numel() for t in leaves(meta))
    gib = 2 ** 30
    out = {"layers": cfg.n_layers, "params_rank": n_rank,
           "state_gib_rank": 12 * n_rank / gib,
           "state_gib_4_ranks": 4 * 12 * n_rank / gib,
           "peak_a_gib_rank": peak_gib, "parent_bf16_gib": 2 * n_whole / gib}
    out["total_gib"] = (out["state_gib_4_ranks"] + 4 * peak_gib
                        + out["parent_bf16_gib"])
    print(f"[sp] (e) at {cfg.n_layers} layers on (2, 2), reckoned from the "
          f"shapes, not run: {n_rank / 1e6:.1f}M params a rank, "
          f"{out['state_gib_rank']:.2f} GiB of f32 mu, nu and master a rank "
          f"({out['state_gib_4_ranks']:.1f} GiB for 4 ranks); with (a)'s "
          f"peak a rank ({peak_gib:.2f} GiB x 4) and the parent's bf16 tree "
          f"({out['parent_bf16_gib']:.2f} GiB) {out['total_gib']:.1f} GiB "
          f"before AdamW's temporaries and four CUDA contexts: more than "
          f"the card's 80 GB", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 18: the modality frontends
# ---------------------------------------------------------------------------

#: (a): hubert's training (the train driver's synthetic batch of f32
#: frames) and prefill; pixtral's prefill and decode, and its training
#: step with the depth cut (AdamW's f32 state of 40 layers, >= 146 GB,
#: does not fit one 80 GB card)
FRONTEND_TRAIN = dict(steps=3, seq_len=256, batch=4)
FRONTEND_PREFILL = (2, 512)              # hubert: lanes x frames
FRONTEND_TEXT = 256                      # pixtral: tokens after 256 patches
FRONTEND_DECODE_STEPS = 4
FRONTEND_STEP_LAYERS = 4
#: (b): the rank grid's batches, (B, S): pixtral's 384 positions over
#: "model" split at 192, inside its 256 patches
FRONTEND_GRID = {"hubert": (4, 256), "pixtral": (2, 384)}
# (b), 2 layers at full width: the ranks' partials (the vocab-parallel
# embedding and loss, heads, FSDP's reduce-scatters) against one device
# as it runs, set at about twice the readings on an H100 80GB HBM3 at
# 700 W (PERF.md, phase 18): hubert (an f32 residual) 8.23e-7, 1.43e-7,
# 5.78e-3 (the bf16 gradients); pixtral 1.05e-2, 6.16e-5, 1.40e-2
FRONTEND_BOUNDS = {
    "hubert": {"prefill": 2e-6, "loss": 4e-7, "grads": 1.2e-2},
    "pixtral": {"prefill": 2.1e-2, "loss": 1.3e-4, "grads": 2.8e-2},
}


def _finite(t) -> bool:
    import torch
    return bool(torch.isfinite(t).all())


def _timed(fn):
    """``fn()``'s result and its host wall (synchronised), seconds."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def frontend_phase(dev):
    """Phase 18 (a): the modality frontends on one device at full width.

    hubert-xlarge, the published config (48 layers, d_model 1280, 16
    heads, d_ff 5120, frames of 512, vocabulary 504; nothing cut): 3 steps
    of ``launch.train.train`` at 4 x 256 frames (f32 frames, so the
    residual stream is f32 through the bf16 blocks, as the reference's
    promotion gives), then the same 3 steps again, bit for bit (losses
    and every parameter's digest); a prefill of 2 x 512 frames on the
    trained weights (non-causal; the cache of all 512 rows).

    pixtral-12b, the published config (40 layers, d_model 5120, 32 heads
    and 8 KV heads, d_ff 14336, vocabulary 131072, 256 patches of 1024;
    12.25 B parameters, seed-0 bf16): a prefill of 2 x (256 patches + 256
    tokens), its cache of 512 rows, the same tokens with the patches
    drawn again giving other logits, then 4 greedy text-only decode steps
    at positions 512-515; one ``make_train_step`` step at full width with
    the depth cut to 4 layers (2.44 B parameters), 2 x (256 + 256).

    Every logit and loss finite; no kernel of the port on these paths
    but the attention's (dense archs); hubert's attention (f32 at hd 80)
    every launch on the tf32x3 route. Prints each wall, tokens/s and
    the peak memory."""
    import dataclasses
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.kernels import flash as t_flash
    from repro_torch.kernels import ops
    from repro_torch.launch.train import make_train_step, train
    from repro_torch.models import (count_params, decode_fn, init_cache,
                                    init_params, prefill_fn)
    from repro_torch.training import (AdamWConfig, DataConfig, adamw_init,
                                      synthetic_batch)
    out = {}
    gib = 2 ** 30

    def reset():
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()

    def launches(what, want=None):
        """No kernel but the attention's: ``want`` of it (dense archs)."""
        counts = attn_routed(ops.launch_counts(), f"phase 18 {what}")
        check(counts == {k: (want or {}).get(k, 0) for k in counts},
              f"phase 18 {what}: kernels launched {counts}, expected "
              f"{want or 0}")
        return counts

    def on_tf32x3(what, counts):
        """Every attention launch of ``counts``, forward and backward, on
        the tf32x3 route."""
        raw = ops.launch_counts()
        for name in ATTN_ROUTED[1:]:
            check(raw[f"{name}.tf32x3"] == counts.get(name, 0),
                  f"phase 18 {what}: {raw[f'{name}.tf32x3']} of "
                  f"{counts.get(name, 0)} {name} launches on the tf32x3 "
                  "route")
        n = t_flash.flash_attn_fwd.tf32x3_launches
        check(n == counts["flash_attn_fwd"] > 0,
              f"phase 18 {what}: {n} of {counts['flash_attn_fwd']} "
              "flash_attn_fwd launches on the tf32x3 route")
        return n

    # hubert-xlarge: the train driver, twice, and a prefill
    hub = get_config("hubert-xlarge")
    tr = FRONTEND_TRAIN
    runs = []
    for i in range(2):
        reset()
        times = []
        params, opt, losses, _ = train(
            "hubert-xlarge", smoke=False, device=dev, step_times=times,
            log_every=100, **tr)
        torch.cuda.synchronize()
        runs.append({"losses": losses, "step_s": times,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "digest": param_digest(params),
                     "launches": launches(
                         f"hubert training run {i}",
                         attn_want(hub, prefill=tr["steps"],
                                   backward=tr["steps"]))})
        runs[-1]["tf32x3_launches"] = on_tf32x3(
            f"hubert training run {i}", runs[-1]["launches"])
        del opt
        if i == 0:
            del params
    check(all(math.isfinite(v) for v in runs[0]["losses"]),
          f"phase 18 hubert: losses {runs[0]['losses']}")
    check(runs[0]["losses"] == runs[1]["losses"]
          and runs[0]["digest"] == runs[1]["digest"],
          f"phase 18 hubert: two seeded runs differ (losses "
          f"{runs[0]['losses']} vs {runs[1]['losses']})")
    med = statistics.median(runs[0]["step_s"])
    tokens = tr["batch"] * tr["seq_len"]
    out["hubert_train"] = {
        "losses": runs[0]["losses"], "step_s": runs[0]["step_s"],
        "median_step_s": med, "tokens_per_s": tokens / med,
        "peak_gib": runs[0]["peak_bytes"] / gib, "bits": True,
        "n_params": count_params(params),
        "tf32x3_launches": runs[0]["tf32x3_launches"]}
    print(f"[frontend] phase 18 (a) hubert-xlarge: {hub.n_layers} layers, "
          f"{count_params(params) / 1e9:.3f} B params, {tr['steps']} steps "
          f"of {tr['batch']} x {tr['seq_len']} f32 frames: losses "
          f"{', '.join(f'{v:.4f}' for v in runs[0]['losses'])} (ln "
          f"{hub.vocab} = {math.log(hub.vocab):.4f}); step walls "
          f"{', '.join(f'{t:.3f}' for t in runs[0]['step_s'])} s, median "
          f"{med:.3f} s, {tokens / med:.0f} frames/s; max_memory_allocated "
          f"{runs[0]['peak_bytes'] / gib:.2f} GiB; a second run bit for "
          f"bit (losses and every parameter); launches "
          f"{json.dumps(runs[0]['launches'])}, every attention launch on "
          f"the tf32x3 route", flush=True)
    B, S = FRONTEND_PREFILL
    reset()
    g = torch.Generator(device=dev)
    g.manual_seed(18)
    feats = torch.randn((B, S, hub.frontend_dim), generator=g, device=dev)
    fn = prefill_fn(hub)
    with torch.no_grad():
        fn(params, {"feats": feats})                         # warm-up
        (lg, cache, _), wall = _timed(lambda: fn(params, {"feats": feats}))
    rows = cache[0][0].shape[2]
    check(_finite(lg) and tuple(lg.shape) == (B, hub.vocab) and rows == S
          and cache[0][0].dtype == torch.float32,
          f"phase 18 hubert prefill: logits {tuple(lg.shape)} finite "
          f"{_finite(lg)}, cache rows {rows} ({cache[0][0].dtype})")
    out["hubert_prefill"] = {
        "wall_s": wall, "frames_per_s": B * S / wall, "cache_rows": rows,
        "peak_gib": torch.cuda.max_memory_allocated() / gib,
        "launches": launches("hubert prefill",
                             attn_want(hub, prefill=2))}
    n_tf32 = out["hubert_prefill"]["tf32x3_launches"] = on_tf32x3(
        "hubert prefill", out["hubert_prefill"]["launches"])
    print(f"[frontend] phase 18 (a) hubert-xlarge prefill of {B} x {S} f32 "
          f"frames: {wall * 1e3:.1f} ms, {B * S / wall:.0f} frames/s; "
          f"logits {tuple(lg.shape)} finite, cache {rows} rows a lane "
          f"(f32, the residual's dtype); {n_tf32} attention launches, all "
          f"on the tf32x3 route; max_memory_allocated "
          f"{out['hubert_prefill']['peak_gib']:.2f} GiB", flush=True)
    del params, cache, lg, feats

    # pixtral-12b: prefill, the patches' effect, decode
    pix = get_config("pixtral-12b")
    P, T = pix.n_patches, FRONTEND_TEXT
    reset()
    g.manual_seed(0)
    (params, wall_init) = _timed(lambda: init_params(pix, g, device=dev))
    torch.cuda.reset_peak_memory_stats()     # the draw's f32 temporaries
    g.manual_seed(18)
    tokens = torch.randint(0, pix.vocab, (B, T), generator=g, device=dev)
    patches = [torch.randn((B, P, pix.frontend_dim), generator=g,
                           device=dev) for _ in range(2)]
    fn = prefill_fn(pix)
    with torch.no_grad():
        fn(params, {"tokens": tokens, "patches": patches[0]})   # warm-up
        (lg, cache, _), wall = _timed(lambda: fn(
            params, {"tokens": tokens, "patches": patches[0]}))
        lg2, _, _ = fn(params, {"tokens": tokens, "patches": patches[1]})
    rows = cache[0][0].shape[2]
    moved = (lg - lg2).abs().max().item()
    check(_finite(lg) and _finite(lg2) and rows == P + T and moved > 0,
          f"phase 18 pixtral prefill: logits finite {_finite(lg)}, "
          f"{_finite(lg2)}; cache rows {rows} (P + T = {P + T}); logits "
          f"with the patches drawn again differ by {moved}")
    n = FRONTEND_DECODE_STEPS
    dcache = init_cache(pix, B, P + T + n, device=dev)
    for (k, v), (k0, v0) in zip(dcache, cache):
        k[:, :, :P + T].copy_(k0)
        v[:, :, :P + T].copy_(v0)
    del cache
    step = decode_fn(pix)
    tok = lg.argmax(-1, keepdim=True).to(torch.int32)
    walls = []
    with torch.no_grad():
        for i in range(n):
            pos = torch.full((B,), P + T + i, dtype=torch.int32, device=dev)
            (dl, dcache, _), w = _timed(lambda: step(params, tok, dcache,
                                                     pos))
            check(_finite(dl), f"phase 18 pixtral decode step {i}: logits "
                  "not finite")
            tok = dl.argmax(-1, keepdim=True).to(torch.int32)
            walls.append(w)
    out["pixtral_serve"] = {
        "n_params": count_params(params), "init_s": wall_init,
        "prefill_s": wall, "prefill_tokens_per_s": B * (P + T) / wall,
        "cache_rows": rows, "patch_logit_change": moved,
        "decode_s": walls, "decode_median_s": statistics.median(walls),
        "peak_gib": torch.cuda.max_memory_allocated() / gib,
        "launches": launches("pixtral prefill and decode",
                             attn_want(pix, prefill=3, decode=n))}
    ps = out["pixtral_serve"]
    print(f"[frontend] phase 18 (a) pixtral-12b: {pix.n_layers} layers, "
          f"{ps['n_params'] / 1e9:.3f} B params (bf16, drawn in "
          f"{wall_init:.2f} s); prefill of {B} x ({P} patches + {T} "
          f"tokens) {wall * 1e3:.1f} ms, {B * (P + T) / wall:.0f} "
          f"positions/s, cache {rows} rows a lane; the patches drawn again "
          f"move the logits by up to {moved:.4f}; {n} greedy decode steps "
          f"{', '.join(f'{w * 1e3:.1f}' for w in walls)} ms (median "
          f"{ps['decode_median_s'] * 1e3:.1f}, {B / ps['decode_median_s']:.1f}"
          f" tokens/s); max_memory_allocated {ps['peak_gib']:.2f} GiB",
          flush=True)
    del params, dcache, lg, lg2, dl, patches, tokens

    # pixtral-12b at full width, 4 layers: one training step
    cut = dataclasses.replace(pix, n_layers=FRONTEND_STEP_LAYERS)
    reset()
    g.manual_seed(0)
    params = init_params(cut, g, device=dev)
    torch.cuda.reset_peak_memory_stats()
    opt = adamw_init(params)
    for p in _leaves(params):
        p.requires_grad_(True)
    data = DataConfig(seq_len=P + T, global_batch=B, seed=0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in synthetic_batch(cut, data, 0).items()}
    stepf = make_train_step(cut, AdamWConfig(), GRID_TOTAL)
    (params, opt, loss, _), wall = _timed(lambda: stepf(params, opt, batch,
                                                        None))
    check(math.isfinite(loss.item()),
          f"phase 18 pixtral 4-layer step: loss {loss.item()}")
    out["pixtral_step"] = {
        "layers": FRONTEND_STEP_LAYERS, "n_params": count_params(params),
        "loss": loss.item(), "step_s": wall,
        "tokens_per_s": B * (P + T) / wall,
        "peak_gib": torch.cuda.max_memory_allocated() / gib,
        "launches": launches("pixtral training step",
                             attn_want(cut, prefill=1, backward=1))}
    st = out["pixtral_step"]
    print(f"[frontend] phase 18 (a) pixtral-12b at full width, depth cut to "
          f"{FRONTEND_STEP_LAYERS} of {pix.n_layers} layers "
          f"({st['n_params'] / 1e9:.3f} B params; AdamW's f32 state of 40 "
          f"layers does not fit one card): one step of {B} x ({P} + {T}): "
          f"loss {st['loss']:.4f} (ln {pix.vocab} = "
          f"{math.log(pix.vocab):.4f}), {wall:.3f} s (the first, with its "
          f"allocations), {st['tokens_per_s']:.0f} positions/s; "
          f"max_memory_allocated {st['peak_gib']:.2f} GiB; launches "
          f"{json.dumps(st['launches'])}", flush=True)
    del params, opt, batch
    torch.cuda.empty_cache()
    return out


def frontend_grid_phase(dev):
    """Phase 18 (b): hubert-xlarge and pixtral-12b at full width with 2
    layers on (2, 2) from ``make_rules`` (hubert: heads, the frontend's
    d_model and the vocabulary over "model"; pixtral: the same with dense
    FSDP over "data", 1.9 B parameters), each a prefill and a loss and
    backward (remat) on :data:`FRONTEND_GRID`'s batch, the train driver's
    synthetic one (f32 frames or patches), held against one device within
    :data:`FRONTEND_BOUNDS`, the residual's shape a rank recorded. On 4
    ranks of its own after phase 16: beside phase 16's states the card
    has no room for pixtral's weights and one-device gradients (~8 GB in
    the parent; a rank of 16 (e) ran out of memory with them there)."""
    t_start = time.perf_counter()
    plans, weights, inputs, what = frontend_plans(dev)
    return _grid_run("frontend", plans, weights, inputs, dev,
                     FRONTEND_BOUNDS, what, t_start)


def frontend_plans(dev):
    """Phase 18 (b)'s plans, weights and inputs
    (:func:`frontend_grid_phase`)."""
    import dataclasses
    import torch
    from repro_torch.configs import get as get_config
    from repro_torch.models import init_params
    from repro_torch.training import DataConfig, synthetic_batch
    plans, weights, inputs, what = [], {}, {}, {}
    for name, arch in (("hubert", "hubert-xlarge"), ("pixtral",
                                                     "pixtral-12b")):
        cfg = dataclasses.replace(get_config(arch), n_layers=2)
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        weights[name] = init_params(cfg, gen, device=dev,
                                    dtype=torch.bfloat16)
        B, S = FRONTEND_GRID[name]
        batch = synthetic_batch(cfg, DataConfig(seq_len=S, global_batch=B,
                                                seed=18), 0)
        inputs[name] = {"batch": {k: torch.as_tensor(v, device=dev)
                                  for k, v in batch.items()}}
        plans.append({"label": name, "model": name, "cfg": cfg,
                      "grid": (2, 2), "rules": {}, "witness": False,
                      "paths": ["prefill", "backward"], "steps": 1,
                      "clocked": []})
        what[name] = (f"phase 18 (b), {arch} 2 layers, {B} x {S}"
                      + (f" ({cfg.n_patches} patches)"
                         if cfg.frontend == "vision" else " frames")
                      + " (2, 2)")
    return plans, weights, inputs, what


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
    t_main = time.perf_counter()

    def stamp(done):
        print(f"[time] {done} done at {time.perf_counter() - t_main:.1f} s",
              flush=True)

    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
          f"({smi}), total_memory "
          f"{torch.cuda.get_device_properties(0).total_memory} bytes",
          flush=True)
    # the dry run's fake process group (phase 17): a private module of
    # torch, so its absence fails here, loudly
    from torch.testing._internal.distributed.fake_pg import \
        FakeStore  # noqa: F401
    t0 = time.perf_counter()
    libs, attn_s = build_kernels()
    print(f"[build] {', '.join(p.name for p in libs.values())} in "
          f"{time.perf_counter() - t0:.1f} s; the attention sources "
          f"{', '.join(f'{k} {v:.1f} s' for k, v in attn_s.items())}",
          flush=True)

    cfg = get_config("granite-moe-3b-a800m")
    gen = torch.Generator().manual_seed(0)             # routing draws
    cgen = torch.Generator(device=dev)                 # tensors on the card
    cgen.manual_seed(0)
    prefill = ragged_case("prefill-512", 512, cfg, gen, cgen, dev)
    decode = ragged_case("decode-8", 8, cfg, gen, cgen, dev)
    D, F, E = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    cap_prefill = capacity_case("prefill-512", E, 128, D, F, cgen, dev,
                                empty_rows=16)
    cap_decode = capacity_case("decode-8", E, 4, D, F, cgen, dev,
                               empty_rows=1)
    capacity_case("off-grid", 3, 5, 200, 136, cgen, dev, empty_rows=2)
    # D, F not multiples of 8: no TMA descriptor, the general route
    capacity_case("general", 2, 9, 100, 70, cgen, dev, empty_rows=2,
                  want="general")
    t0 = time.perf_counter()
    router_big = router_case(cgen, dev, T=4096)
    print(f"[build] router (Triton) compiled and checked in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the paths' shapes: one 512-token prompt, an 8-lane decode batch
    router = router_case(cgen, dev, T=512)
    router_dec = router_case(cgen, dev, T=8)
    # the fused routing stage: the served tables (R = 1) and replica
    # tables (R = 3) at the paths' T (a 128-token chunk with its padding
    # rows masked) and at 4096
    route = {}
    for T, R, masked in ((8, 1, False), (8, 3, False), (128, 1, True),
                         (512, 1, False), (512, 3, False), (4096, 1, False),
                         (4096, 3, False)):
        route[(T, R)] = route_case(cfg, gen, cgen, dev, T, R, masked)
    attn = attention_cases(cfg, cgen, dev)
    stamp("phase 3, the kernels")
    layer_case(cfg, cgen, dev)
    capacity_layer_case(cfg, cgen, dev)
    stamp("phase 4, the MoE layers")
    engine, counts, _ = serve_path(cfg, dev, "slice", output_cap=64)
    # granite's attention (bf16, hd 64): every prefill launch on the
    # Hopper route (the count is reset with the others)
    from repro_torch.kernels import flash as t_flash
    attn_tma = t_flash.flash_attn_fwd.tma_launches
    check(attn_tma == counts["flash_attn_fwd"] > 0,
          f"slice: {attn_tma} of {counts['flash_attn_fwd']} flash_attn_fwd "
          "launches on the Hopper route")
    trace_decode(engine)
    del engine
    stamp("phases 5-6, the ragged slice and its trace")
    torch.cuda.empty_cache()
    # the first routing calls' inputs on path A, for the near-tie check
    with capture_routes(64) as cap:
        engine, counts_a, _ = serve_path(cfg, dev, "path A",
                                         output_cap=64, moe_impl="capacity")
    del engine
    torch.cuda.empty_cache()
    route_near_ties(cap.calls, "path A")
    del cap
    stamp("phase 7, path A")
    engine, _, _ = serve_path(cfg, dev, "path B", n_requests=4,
                              output_cap=64, prefill_chunk=128)
    chunk_vs_whole(engine)
    del engine
    torch.cuda.empty_cache()
    stamp("phase 8, path B")
    drills = drill_phase(cfg, dev)
    stamp("phase 9, the drills")
    xlstm = xlstm_phase(dev)
    stamp("phase 10, xlstm")
    jamba = jamba_phase(dev)
    stamp("phase 11, jamba")
    # phase 12: training
    k1, k2 = backward_ffn_case(cfg, gen, cgen, dev)
    # the 4096-token training shape, where the bound is the tensor cores
    k1_big, k2_big = backward_ffn_case(cfg, gen, cgen, dev, tokens=4096,
                                       controls=False)
    k3 = backward_route_case(cfg, cgen, dev)
    # the capacity FFN's gradient: granite's training buckets (16 x 256 at
    # factor 1.25), a rank's a2a buckets in phase 13's backward (4 x 256
    # on ep 4 at factor 8: 10 slots of 4 x 412 rows), a bucket of 36 rows
    cap_bwd = {name: capacity_backward_case(name, E_, C_, D, F, cgen, dev,
                                            empty)
               for name, E_, C_, empty in (("train-16x256", E, 1024, 205),
                                           ("rank-a2a", E // 4, 4 * 412, 40),
                                           ("c36", 10, 36, 5))}
    trained = train_phase(cfg, dev)
    trained["capacity"] = capacity_train_step(cfg, dev)
    trained["profile"] = train_step_profile(cfg, dev)
    # a micro-batch of 4096 tokens beside 50 GiB of weights and state, 16 x
    # 256 as before (8 x 512 peaked at 77 GiB, scripts/train_phase.py,
    # while the attention kept a layer's whole scores for the backward)
    trained["profile_4096"] = train_step_profile(cfg, dev, seq_len=256,
                                                 batch=16)
    step_cmp = kernel_vs_plain_step(cfg, dev)
    checkpoint_restart(dev)
    tl = trained["launches"]
    stamp("phase 12, training")
    # phase 13: expert-parallel dispatch on 4 ranks; phase 14: remat
    ep = ep_phase(cfg, dev)
    stamp("phase 13, expert parallelism")
    remat = remat_phase(cfg, dev)
    stamp("phase 14, remat")
    t_14 = time.perf_counter()
    # phase 15: tensor parallelism of the dense layers on 4 ranks
    tp = tp_phase(cfg, dev)
    stamp("phase 15, tensor parallelism")
    # phase 16: the batch over dp and the sequence-sharded residual
    sp = sp_phase(cfg, dev, tp_peak_gib=max(tp["heads"]["peak_gib"]))
    stamp("phase 16, each rank's rows and the training step")
    # phase 18: the modality frontends, on one device and on 4 ranks
    t0 = time.perf_counter()
    front = frontend_phase(dev)
    front["wall_s"] = time.perf_counter() - t0
    stamp("phase 18 (a), the modality frontends on one device")
    front["grid"] = frontend_grid_phase(dev)
    stamp("phase 18 (b), the modality frontends on the grid")
    b = front["grid"]["phase_s"]
    print(f"[time] phase 18: (a) {front['wall_s']:.1f} s, (b) "
          f"{b['all']:.1f} s (one-device references "
          f"{b['one_device_references']:.1f} s, ranks {b['ranks']:.1f} s "
          f"with their start); phases 3-14 took {t_14 - t_main:.1f} s (192 "
          f"s on PR 23's machine)", flush=True)

    def ep_launches(name):
        """This kernel's launches on the expert-parallel paths, per rank
        (every rank launched the same; the phase checks each)."""
        return {key: {p: c.get(name, 0) for p, c in
                      ep[key]["launches_rank0"].items()}
                for key in ("ep4", "grid_fsdp")}

    def tp_launches(name):
        """This kernel's launches on the tensor-parallel runs, per rank
        (every rank launched the same; the phase checks each)."""
        return {label: {p: c.get(name, 0) for p, c in
                        tp[label]["launches_rank0"].items()}
                for label in ("heads", "context", "smollm", "dense")}

    def sp_launches(name):
        """This kernel's launches on the batch- and sequence-split runs,
        per rank (every rank launched the same; the phase checks each)."""
        return {label: {p: c.get(name, 0) for p, c in
                        sp[label]["launches_rank0"].items()}
                for label in ("dp_sp", "jamba", "step")}

    def ffn_entry(prefill_res, decode_res):
        """The prefill shape's numbers under the contract's keys, the
        decode shape's beside them, each with its share of its bound by
        ``ms`` and by ``device_ms``."""
        def shares(r):
            return {k: v for k, v in r.items() if k != "route"} | {
                "bound_share": r["bound_ms"] / r["ms"],
                "device_bound_share": r["bound_ms"] / r["device_ms"]}
        return shares(prefill_res) | {
            "decode": shares(decode_res),
            "kernel_route": {"prefill": prefill_res["route"],
                             "decode": decode_res["route"]}}

    def attn_bwd_entry(name):
        """A backward kernel of the attention (its reference: autodiff of
        the plain-jnp forward, a checkpoint a chunk pair) at granite's
        4 x 512, its time by the profiler (the pair's by CUDA events
        beside it), the other gradient cases by shape."""
        key = name.replace("flash_", "")
        grad = attn["grad"]

        def numbers(r):
            ms = r["split_ms"][key]
            return {"ms": r["ms"] if ms is None else ms,
                    "pair_ms": r["ms"], "pair_device_ms": r["device_ms"],
                    "max_abs_err": r["max_abs_err"],
                    "rel_l2": r["bwd_rel_l2"], "plain_ms": r["plain_ms"],
                    **r["bounds"][key],
                    "pair_bound_ms": r["bounds"]["pair"]["bound_ms"],
                    "library_ms": r["library_ms"],
                    "library_fwd_bwd_ms": r["library_fwd_bwd_ms"],
                    "kernel_route": r["kernel_route"], "shape": r["shape"]}
        return {"name": name, "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/"
                          "flash_attention_bwd.cu",
                "replaces": "src/repro/models/flash.py:94",
                "launches": tl[name], **numbers(grad["train-4x512"]),
                "by_shape": {k: numbers(r) for k, r in grad.items()},
                "ep_launches": ep_launches(name),
                "tp_launches": tp_launches(name),
                "sp_launches": sp_launches(name)}

    # the attention's prefill routes, as route_of picks them from (dtype,
    # hd): "tma" (bf16), "tf32x3" (f32)
    attn_routes = {}
    for dt in (torch.bfloat16, torch.float32):
        for hd in t_flash.HEAD_DIMS:
            attn_routes.setdefault(t_flash.route_of(dt, hd), []).append(
                f"{str(dt)[6:]} hd {hd}")

    kernels = [
        {"name": "ragged_moe_ffn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ragged_moe_ffn.cu",
         "replaces": "src/repro/kernels/ragged_moe_ffn.py:102",
         "launches": counts["ragged_moe_ffn"], **ffn_entry(prefill, decode),
         "ep_launches": ep_launches("ragged_moe_ffn"),
         "tp_launches": tp_launches("ragged_moe_ffn"),
         "sp_launches": sp_launches("ragged_moe_ffn"), "library_ms": None},
        {"name": "route_select", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/route_select.cu",
         "replaces": "src/repro/kernels/router.py:47",
         "launches": counts["route_select"], **route[(512, 1)],
         "by_shape": {f"T={T} R={R}": r for (T, R), r in route.items()},
         "ep_launches": ep_launches("route_select"),
         "tp_launches": tp_launches("route_select"),
         "sp_launches": sp_launches("route_select"), "library_ms": None},
        {"name": "router_topk", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/route_select.cu",
         "replaces": "src/repro/kernels/router.py:47",
         "launches": counts["router_topk"], **router,
         "by_shape": {"T=8": router_dec, "T=4096": router_big},
         "earlier_design": {"route": "triton",
                            "source": "src/repro_torch/kernels/router.py"},
         "ep_launches": ep_launches("router_topk"),
         "tp_launches": tp_launches("router_topk"),
         "sp_launches": sp_launches("router_topk"), "library_ms": None},
        {"name": "fused_moe_ffn", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_ffn.cu",
         "replaces": "src/repro/kernels/moe_ffn.py:58",
         "launches": counts_a["fused_moe_ffn"],
         **ffn_entry(cap_prefill, cap_decode),
         "ep_launches": ep_launches("fused_moe_ffn"),
         "tp_launches": tp_launches("fused_moe_ffn"),
         "sp_launches": sp_launches("fused_moe_ffn"), "library_ms": None},
        {"name": "ragged_moe_ffn_dgrad", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ragged_moe_ffn_bwd.cu",
         "replaces": "src/repro/kernels/ragged_moe_ffn.py:102",
         "launches": tl["ragged_moe_ffn_dgrad"],
         "tma_launches": tl["ragged_moe_ffn_dgrad.tma"], **k1,
         "tokens_4096": k1_big,
         "ep_launches": ep_launches("ragged_moe_ffn_dgrad"),
         "tp_launches": tp_launches("ragged_moe_ffn_dgrad"),
         "sp_launches": sp_launches("ragged_moe_ffn_dgrad"),
         "library_ms": None},
        {"name": "ragged_moe_ffn_wgrad", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ragged_moe_ffn_bwd.cu",
         "replaces": "src/repro/kernels/ragged_moe_ffn.py:102",
         "launches": tl["ragged_moe_ffn_wgrad"],
         "tma_launches": tl["ragged_moe_ffn_wgrad.tma"], **k2,
         "tokens_4096": k2_big,
         "ep_launches": ep_launches("ragged_moe_ffn_wgrad"),
         "tp_launches": tp_launches("ragged_moe_ffn_wgrad"),
         "sp_launches": sp_launches("ragged_moe_ffn_wgrad"),
         "library_ms": None},
        {"name": "moe_ffn_dgrad", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_ffn_bwd.cu",
         "replaces": "src/repro/kernels/moe_ffn.py:58",
         "launches": trained["capacity"]["launches"]["moe_ffn_dgrad"],
         "tma_launches":
             trained["capacity"]["launches"]["moe_ffn_dgrad.tma"],
         **cap_bwd["train-16x256"][0],
         "by_shape": {k: v[0] for k, v in cap_bwd.items()},
         "ep_launches": ep_launches("moe_ffn_dgrad"),
         "tp_launches": tp_launches("moe_ffn_dgrad"),
         "sp_launches": sp_launches("moe_ffn_dgrad"), "library_ms": None},
        {"name": "moe_ffn_wgrad", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/moe_ffn_bwd.cu",
         "replaces": "src/repro/kernels/moe_ffn.py:58",
         "launches": trained["capacity"]["launches"]["moe_ffn_wgrad"],
         "tma_launches":
             trained["capacity"]["launches"]["moe_ffn_wgrad.tma"],
         **cap_bwd["train-16x256"][1],
         "by_shape": {k: v[1] for k, v in cap_bwd.items()},
         "ep_launches": ep_launches("moe_ffn_wgrad"),
         "tp_launches": tp_launches("moe_ffn_wgrad"),
         "sp_launches": sp_launches("moe_ffn_wgrad"), "library_ms": None},
        {"name": "route_select_bwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/route_select.cu",
         "replaces": "src/repro/kernels/router.py:47",
         "launches": tl["route_select_bwd"], **k3,
         "ep_launches": ep_launches("route_select_bwd"),
         "tp_launches": tp_launches("route_select_bwd"),
         "sp_launches": sp_launches("route_select_bwd"), "library_ms": None},
        # the reference's attention is plain jnp, not a Pallas kernel
        {"name": "flash_attn_fwd", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/models/flash.py:45",
         "launches": counts["flash_attn_fwd"], "tma_launches": attn_tma,
         "prefill_routes": attn_routes,
         "tf32x3_launches": {
             k: front[k]["tf32x3_launches"]
             for k in ("hubert_train", "hubert_prefill")},
         **{k: v for k, v in attn["fwd"]["prefill-4x512"].items()
            if k != "shape"},
         "by_shape": attn["fwd"], "gradient": attn["grad"],
         "training_launches": tl["flash_attn_fwd"],
         "ep_launches": ep_launches("flash_attn_fwd"),
         "tp_launches": tp_launches("flash_attn_fwd"),
         "sp_launches": sp_launches("flash_attn_fwd")},
        *(attn_bwd_entry(k) for k in ATTN_ROUTED[1:]),
        {"name": "flash_decode", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
         "replaces": "src/repro/models/flash.py:133",
         "launches": counts["flash_decode"],
         **{k: v for k, v in attn["decode"]["decode-8"].items()
            if k != "shape"},
         "by_shape": attn["decode"], "training_launches": tl["flash_decode"],
         "ep_launches": ep_launches("flash_decode"),
         "tp_launches": tp_launches("flash_decode"),
         "sp_launches": sp_launches("flash_decode")},
    ]
    # phase 16 (h)-(j)'s launches a rank: the serving engine on the grid,
    # its drills and its capacity path
    for entry in kernels:
        entry["engine_launches"] = {
            k: tp[k]["launches_rank0"][k].get(entry["name"], 0)
            for k in ("engine", "drills", "capacity")}
        # phase 17's counted calls a rank (rank 0; every rank's checked)
        entry["dryrun_launches"] = {
            label: tp["dryrun"][label][0]["card"]["kernel_calls"].get(
                entry["name"], 0) for label, *_ in DRYRUN_CELLS}
    print(f"[train] summary: {json.dumps({k: v for k, v in trained.items() if k != 'launches'} | {'kernel_vs_plain': step_cmp})}")
    print(f"[slices] summary: {json.dumps({'drills': drills, 'xlstm': xlstm, 'jamba': jamba})}")
    print(f"[ep] summary: {json.dumps(ep)}")
    print(f"[remat] summary: {json.dumps(remat)}")
    print(f"[tp] summary: {json.dumps(tp)}")
    print(f"[sp] summary: {json.dumps(sp)}")
    print(f"[frontend] summary: {json.dumps(front)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
