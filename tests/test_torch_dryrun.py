"""The dry run, its cost count and the roofline (``repro_torch.launch.
{cost_analysis,dryrun,roofline}``) against the reference's ``parse_hlo``,
``memory_analysis()`` and closed forms, on the CPU.

The reference's numbers come from one subprocess on 8 fake devices
(``tests/_torch_dryrun_ref.py``), started first; the port's from its
dry run on the ``meta`` device in a ``fake`` process group of the grid's
size, in this process (the group is destroyed after the module). Held:

* a Python loop of L products counts what ``parse_hlo`` reconstructs of a
  ``lax.scan`` of L, exactly;
* each of the port's collectives is counted by kind and operand bytes,
  as ``collectives.clock`` counts it and as ``parse_hlo`` counts the
  reference's ``shard_map`` collective;
* each kernel's meta branch, forward and backward, gives the plain
  version's shapes and dtypes, reports its closed-form entry and
  launches nothing;
* the peak tracker's hand-computed peak, through a backward;
* smollm-360m, granite, hubert-xlarge (no decode step) and pixtral-12b
  at smoke size on (2, 2) from ``make_rules``, train / prefill / decode:
  per-rank FLOPs within 1% of ``parse_hlo`` of the reference's step
  (granite's named term: the port's K1 computes gate and up again, 4 T D
  F of its 10 T D F, where the oracle's backward keeps them; pixtral's
  two ranks of "model" averaged, since the one whose positions hold the
  patches projects them), per-rank argument bytes equal but for the
  named departures, two ranks equal (pixtral's but for the patches'
  product);
* the training cut of a whole tree that requires gradients gives each
  rank leaf its own;
* ``run_cell`` of a production cell and of a skipped one, and
  ``roofline_terms`` against the arithmetic with the H100 constants.
"""

import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

import _torch_dryrun_ref as h  # noqa: E402
import _torch_ep_ranks as ep  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ragged_moe_ffn as t_ragged  # noqa: E402
from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch.cost_analysis import count_costs  # noqa: E402
from repro_torch.launch.mesh import fake_group, make_mesh  # noqa: E402
from repro_torch.models import collectives as C  # noqa: E402
from repro_torch.launch.sharding import (make_rules,  # noqa: E402
                                         shard_params)
from repro_torch.models import (init_params, loss_fn,  # noqa: E402
                                make_moe_tables, moe_perm_shape)
from repro_torch.tree import leaves  # noqa: E402

torch.set_num_threads(1)

REL = 0.01          # per-rank FLOPs against parse_hlo at smoke size


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's numbers (``_torch_dryrun_ref.run``), in one
    subprocess started before the port's side runs."""
    path = str(tmp_path_factory.mktemp("dryrun_ref") / "ref.json")
    proc = ep.start_reference("_torch_dryrun_ref.run", path, 8)
    yield proc, path
    if proc.poll() is None:
        proc.kill()


@pytest.fixture(scope="module")
def ref(reference):
    proc, path = reference
    out, err = proc.communicate(timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"reference run failed ({proc.returncode}):\n"
                           f"{out[-2000:]}\n{err[-4000:]}")
    with open(path) as f:
        return json.load(f)


@pytest.fixture(scope="module", autouse=True)
def no_group_after():
    """Every test of the module may start a fake default group; none is
    left for the next module."""
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# loops, collectives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("L", h.LOOP_LENGTHS)
def test_loop_counts_every_iteration_as_parse_hlo(ref, L):
    """A Python loop is counted as it runs: L products, as parse_hlo's
    trip-count correction reconstructs from the scan's condition."""
    w = torch.zeros((L, 128, 128), device="meta")
    x = torch.zeros((32, 128), device="meta")
    with count_costs(w, x) as c:
        for i in range(L):
            x = torch.tanh(x @ w[i])
        x.sum()
    assert c.flops == 2 * 32 * 128 * 128 * L == ref["loop"][str(L)]


def test_backward_counts_twice_the_forward():
    """A Linear's backward (its input's and its weight's gradients), run
    by autograd's engine, is counted: twice the forward's FLOPs."""
    lin = torch.nn.Linear(128, 256, bias=False, device="meta")
    x = torch.zeros((32, 128), device="meta", requires_grad=True)
    with count_costs(x, lin.weight) as fwd:
        lin(x)
    with count_costs(x, lin.weight) as both:
        lin(x).sum().backward()
    assert fwd.flops == 2 * 32 * 128 * 256
    assert both.flops == 3 * fwd.flops


def _coll_grid():
    fake_group(math.prod(h.COLL_GRID), 0)
    return make_mesh(h.COLL_GRID, h.COLL_AXES)


ROW_BYTES = h.COLL_ROWS * h.COLL_COLS * 4        # each rank's operand


@pytest.mark.parametrize("name,kind,ref_name", [
    ("sum_partials", "all-reduce", "psum"),
    ("mean_over", "all-reduce", "psum"),
    ("max_over", "all-reduce", "psum"),
    ("gather_shards", "all-gather", "all_gather"),
    ("scatter_partials", "reduce-scatter", "psum_scatter"),
    ("all_to_all", "all-to-all", "all_to_all"),
    ("exchange", "all-to-all", "all_to_all"),
    ("gather_to", "gather", None),
])
def test_collectives_counted_by_kind(ref, name, kind, ref_name):
    """One call over the "model" axis of a fake (2, 4) grid, each rank's
    operand (8, 16) f32: one call of its kind, its operand's bytes, as the
    exchange clock counts it and as parse_hlo counts the reference's
    shard_map collective of the same operand."""
    grid = _coll_grid()
    group = grid.group("model")
    x = torch.zeros((h.COLL_ROWS, h.COLL_COLS), device="meta")
    n = h.COLL_GRID[1]
    calls = {
        "sum_partials": lambda: C.sum_partials(x, group),
        "mean_over": lambda: C.mean_over(x, group),
        "max_over": lambda: C.max_over(x, group),
        "gather_shards": lambda: C.gather_shards(x, group, 0),
        "scatter_partials": lambda: C.scatter_partials(x, group, 0),
        "all_to_all": lambda: C.all_to_all(x, group),
        "exchange": lambda: C.exchange(x, group, [h.COLL_ROWS // n] * n,
                                       [h.COLL_ROWS // n] * n),
        "gather_to": lambda: C.gather_to(x, group, 0),
    }
    C.clock.reset()
    C.clock.enabled = True
    try:
        with count_costs(x) as c:
            calls[name]()
    finally:
        C.clock.enabled = False
    assert c.collective_calls == {kind: 1}
    assert c.collective_by_kind == {kind: ROW_BYTES}
    assert C.clock.by_kind == {kind: [1, ROW_BYTES]}
    if ref_name is not None:
        assert ref["collectives"][ref_name] == {kind: ROW_BYTES}


def test_backward_collective_is_counted():
    """The gather's backward, run by autograd's engine, is counted: the
    reduce-scatter of the whole gradient (4 x the operand)."""
    grid = _coll_grid()
    x = torch.zeros((h.COLL_ROWS, h.COLL_COLS), device="meta",
                    requires_grad=True)
    with count_costs(x) as c:
        C.gather_shards(x, grid.group("model"), 0).sum().backward()
    assert c.collective_calls == {"all-gather": 1, "reduce-scatter": 1}
    assert c.collective_by_kind == {"all-gather": ROW_BYTES,
                                    "reduce-scatter": 4 * ROW_BYTES}


# ---------------------------------------------------------------------------
# the kernels' meta branches
# ---------------------------------------------------------------------------

E, D, F, BM, K, T_ROUTE = 4, 64, 128, 64, 2, 24
SIZES = [70, 0, 5, 33]


def _ragged_case(dev, grad):
    """A group-sorted buffer and its plan (``ragged_tile_metadata``) on
    ``dev``, from seed 0; the weights (and ``toks``) require gradients
    with ``grad``."""
    g = torch.Generator().manual_seed(0)
    sizes = torch.tensor(SIZES, dtype=torch.int32)
    n_tiles = t_ragged.ragged_n_tiles(int(sizes.sum()), E, BM)
    ro, tg = t_ragged.ragged_tile_metadata(sizes, BM, n_tiles)
    T = n_tiles * BM
    ws = [torch.randn(s, generator=g).to(torch.bfloat16) for s in
          ((E, D, F), (E, D, F), (E, F, D))]
    toks = torch.randn((T, D), generator=g).to(torch.bfloat16)
    ts = [t.to(dev).requires_grad_(grad) for t in ws + [toks]]
    return ts, tg.to(dev), ro.to(dev), sizes.to(dev)


def _route_case(dev, grad):
    g = torch.Generator().manual_seed(1)
    x = torch.randn((T_ROUTE, D), generator=g).to(torch.bfloat16)
    rw = torch.randn((D, E), generator=g)
    slots_of = torch.arange(E, dtype=torch.int32)[:, None]
    n_copies = torch.ones(E, dtype=torch.int32)
    cdf = torch.ones((E, 1))
    seed = torch.zeros(1, dtype=torch.int32)
    x, rw = (t.to(dev).requires_grad_(grad) for t in (x, rw))
    return (x, rw) + tuple(t.to(dev) for t in (slots_of, n_copies, cdf,
                                               seed))


def _nb(*ts):
    return sum(t.numel() * t.element_size() for t in ts)


def _run(kernel, dev):
    """The kernel's call through ``ops`` on ``dev`` (its backward too for
    the ``*_grad`` cases): the outputs, then the gradients."""
    if kernel.startswith("ragged"):
        grad = kernel == "ragged_grad"
        (w1, w3, w2, toks), tg, ro, sz = _ragged_case(dev, grad)
        y = ops.ragged_moe_ffn(w1, w3, w2, toks, tg, ro, sz)
        if not grad:
            return [y]
        y.float().sum().backward()
        return [y, w1.grad, w3.grad, w2.grad, toks.grad]
    if kernel == "fused":
        (w1, w3, w2, toks), *_ = _ragged_case(dev, False)
        return [ops.fused_moe_ffn(w1, w3, w2,
                                  toks[:E * 8].reshape(E, 8, D))]
    if kernel == "topk":
        x, rw, *_ = _route_case(dev, False)
        return list(ops.router_topk((x @ rw.to(x.dtype)).float(), K))
    grad = kernel == "route_grad"
    args = _route_case(dev, grad)
    out = ops.route_select(*args, K)
    if not grad:
        return list(out)
    w, _, _, _, mean_prob, aux = out
    (w.sum() + mean_prob.sum() + aux).backward()
    return list(out) + [args[0].grad, args[1].grad]


def _entries(kernel, dev):
    """The entries a meta call reports, in closed form."""
    (w1, w3, w2, toks), tg, ro, sz = _ragged_case(dev, False)
    T = toks.shape[0]
    ragged_io = _nb(w1, w3, w2, toks, tg, ro, sz)
    fwd = ("ragged_moe_ffn", 6 * T * D * F,
           ragged_io + 2 * T * D + 2 * 2 * T * F)
    if kernel == "ragged":
        return [fwd]
    if kernel == "ragged_grad":
        # K1 reads dy beside the forward's operands and writes dx, da, db;
        # K2 reads toks, h, da, db, dy and the plan, writes three dW
        return [fwd,
                ("ragged_moe_ffn_dgrad", 10 * T * D * F,
                 ragged_io + 2 * T * D + 2 * T * D + 2 * 2 * T * F),
                ("ragged_moe_ffn_wgrad", 6 * T * D * F,
                 2 * T * D * 2 + 3 * 2 * T * F + _nb(ro, sz)
                 + 3 * 2 * E * D * F)]
    if kernel == "fused":
        n = E * 8
        return [("fused_moe_ffn", 6 * n * D * F,
                 _nb(w1, w3, w2) + 2 * n * D * 2 + 2 * 2 * n * F)]
    if kernel == "topk":
        return [("router_topk", 0, T_ROUTE * E * 4 + 2 * T_ROUTE * K * 4)]
    tables = E * 4 * 3 + 4                 # slots_of, n_copies, cdf, seed
    ins = T_ROUTE * D * 2 + D * E * 4 + tables
    outs = 3 * T_ROUTE * K * 4 + (2 * E + 2) * 4
    if kernel == "route":
        return [("route_select", 2 * T_ROUTE * D * E, ins + outs)]
    probs, w = T_ROUTE * E * 4, T_ROUTE * K * 4
    return [("route_select", 2 * T_ROUTE * D * E, ins + outs + probs + w),
            # probs, idx, weights, dweights, counts, dmean_prob, daux in;
            # dlogits out
            ("route_select_bwd", 0,
             probs + 3 * w + E * 4 + E * 4 + 4 + probs)]


@pytest.mark.parametrize("kernel", ["ragged", "ragged_grad", "fused",
                                    "topk", "route", "route_grad"])
def test_kernel_meta_branch(kernel):
    """On meta each kernel (and its backward) gives the plain version's
    shapes and dtypes, reports its entry and launches nothing."""
    plain = _run(kernel, "cpu")
    ops.reset_launch_counts()
    seen = []
    with count_costs() as c:
        meta = _run(kernel, "meta")
    for name, flops, nbytes in _entries(kernel, "cpu"):
        seen.append((name, c.kernel_calls.get(name), c.kernel_flops[name],
                     c.kernel_bytes[name]))
        assert seen[-1] == (name, 1, flops, nbytes)
    assert sum(c.kernel_calls.values()) == len(seen)
    assert all(v == 0 for v in ops.launch_counts().values())
    assert [(t.shape, t.dtype) for t in meta] == \
        [(t.shape, t.dtype) for t in plain]
    assert all(t.device.type == "meta" for t in meta)


# ---------------------------------------------------------------------------
# the peak tracker
# ---------------------------------------------------------------------------

def test_peak_tracker_hand_computed():
    """Storages from their allocation to their release, in 512-byte
    blocks, views once; through a backward."""
    with count_costs() as c:
        a = torch.empty(1024, device="meta")           # 4096
        b = torch.empty(2048, device="meta")           # 8192
        del a
        d = torch.empty(100, device="meta")            # 400 → 512
        v = b.view(2, 1024)                            # a view: nothing
    assert (c.peak_bytes, c.exit_bytes) == (4096 + 8192, 8192 + 512)
    del b, d, v
    w = torch.zeros((256, 256), device="meta", requires_grad=True)
    x = torch.zeros((64, 256), device="meta")
    with count_costs(w, x) as c:
        y = x @ w                                      # 65536
        loss = y.sum()                                 # 4 → 512
        loss.backward()      # ones_like 512, then w.grad 262144 (kept)
    assert c.argument_bytes == 4 * (256 * 256 + 64 * 256)
    assert c.peak_bytes == 65536 + 512 + 512 + 262144
    assert c.exit_bytes == 65536 + 512 + 262144
    assert c.flops == 2 * (2 * 64 * 256 * 256)     # x @ w, then xᵀ dy


# ---------------------------------------------------------------------------
# the steps on (2, 2) against the reference
# ---------------------------------------------------------------------------

def _departures(cfg, name, kind, seq, batch):
    """Argument bytes the port's step takes beyond the reference's: the
    global batch, where the reference's argument is the rank's ``dp``
    shard (``dp`` 2 divides every batch here), and the replica tables
    ``n_copies`` and ``copy_cdf`` where every expert has one copy: a
    step that never reads them, and ``jax.jit`` drops unread arguments;
    so is an audio arch's embedding (bf16, its vocabulary over "model"),
    which neither the loss nor the prefill reads and AdamW writes from
    its f32 master, and a vision arch's frontend (bf16, its d_model over
    "model") at decode, which is text only. The batch is
    ``batch_specs``': int32 tokens and labels, bf16 frames or patches."""
    dp, tp = h.STEP_GRID
    if kind == "decode":
        extra = batch * 4 - batch * 4 // dp           # the token (B, 1)
        if cfg.frontend == "vision":
            extra += cfg.frontend_dim * cfg.d_model // tp * 2
    else:
        text = seq - cfg.n_patches if cfg.frontend == "vision" else seq
        n = 2 if kind == "train" else 1               # tokens, labels
        if cfg.frontend == "audio":                   # frames, labels
            row = seq * cfg.frontend_dim * 2 + (n - 1) * seq * 4
        else:
            row = n * text * 4 + cfg.n_patches * cfg.frontend_dim * 2
        extra = batch * row - batch * row // dp
        if cfg.frontend == "audio":
            extra += cfg.vocab // tp * cfg.d_model * 2
    if cfg.is_moe:
        extra += moe_perm_shape(cfg)[0] * cfg.n_experts * 4 * 2
    return extra


@pytest.mark.parametrize(
    "arch,name,kind,seq,batch",
    [pytest.param(arch, *shape, id="-".join(map(str, shape + (arch,))))
     for arch, shape in h.step_cells()])
def test_steps_against_parse_hlo(ref, arch, name, kind, seq, batch):
    cfg = get_smoke(arch)
    shape = ShapeSpec(name, seq, batch, kind)
    runs = [dryrun.measure(cfg, shape, h.STEP_GRID, rank) for rank in (0, 1)]
    c0, c1 = (r["costs"] for r in runs)
    flops = c0.flops
    if cfg.frontend == "vision" and kind != "decode":
        # the two ranks of "model" (ranks 0 and 1) split the 32 positions
        # after the patches' projection: rank 0's 16 hold the 8 patches
        # and project them with the gathered frontend, rank 1's hold none
        # (the reference projects every patch on its columns): the same
        # but for that product, whose count they share
        for k in ("collective_by_kind", "collective_calls", "kernel_calls",
                  "argument_bytes"):
            assert getattr(c0, k) == getattr(c1, k), k
        proj = 2 * (batch // 2) * cfg.n_patches * cfg.frontend_dim \
            * cfg.d_model * (2 if kind == "train" else 1)
        assert c0.flops - c1.flops == proj
        flops = (c0.flops + c1.flops) / 2
    else:
        assert c0.as_dict() == c1.as_dict()      # two ranks of an even grid
    want = ref["steps"][f"{arch}/{name}"]
    # the port's K1 computes gate and up again (4 T D F of its 10 T D F)
    k1_again = 0.4 * c0.kernel_flops.get("ragged_moe_ffn_dgrad", 0.0)
    assert (flops - k1_again) == pytest.approx(want["flops"], rel=REL)
    assert c0.argument_bytes - want["argument_bytes"] == _departures(
        cfg, name, kind, seq, batch)
    if cfg.is_moe:      # remat runs the forward again in the backward
        assert c0.kernel_calls["route_select"] == moe_perm_shape(cfg)[0] * (
            2 if kind == "train" else 1)


def test_train_inputs_are_the_ranks_own_leaves():
    """A training step on ``rank_inputs`` of a whole tree that requires
    gradients, and holds some, leaves that tree alone: each of the rank's
    params is a leaf of its own (phase 17 runs on shared weights that
    earlier plans trained)."""
    cfg = get_smoke("granite-moe-3b-a800m")
    fake_group(4, 0)
    grid = make_mesh((2, 2), h.COLL_AXES)
    shape = ShapeSpec("t", 8, 4, "train")
    rules = make_rules(cfg, grid, "train")
    whole = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        rules=rules, phase="train")
    for w in leaves(whole):
        w.requires_grad_(True)
        w.grad = torch.ones_like(w)
    inputs = dryrun.rank_inputs(cfg, shape, rules, whole=whole,
                                device="cpu")
    assert all(p.is_leaf and p.requires_grad
               for p in leaves(inputs["params"]))
    call, _ = dryrun.step_call(cfg, shape, rules, inputs)
    call()
    assert all(torch.equal(w.grad, torch.ones_like(w))
               for w in leaves(whole))


def test_train_cut_gives_each_rank_leaf_its_own_gradient():
    """``shard_params(..., "train")`` of a whole tree that requires
    gradients and holds some: every leaf of the rank's tree is a leaf of
    its own that requires its gradient, a leaf the cut leaves whole
    included (the norms, the router); after the rank's loss and backward
    the whole tree's ``.grad`` is as it was and every rank leaf holds its
    gradient. Serving's cut keeps the whole tree's tensors."""
    cfg = get_smoke("granite-moe-3b-a800m")
    fake_group(4, 0)
    grid = make_mesh((2, 2), h.COLL_AXES)
    rules = make_rules(cfg, grid, "train")
    whole = init_params(cfg, torch.Generator().manual_seed(0), device="cpu",
                        rules=rules, phase="train")
    for w in leaves(whole):
        w.requires_grad_(True)
        w.grad = torch.ones_like(w)
    params = shard_params(cfg, whole, rules, "train")
    pairs = list(zip(leaves(params), leaves(whole)))
    assert any(p.shape == w.shape for p, w in pairs)      # whole leaves
    assert all(p.is_leaf and p.requires_grad and p is not w
               and p.data_ptr() != w.data_ptr() for p, w in pairs)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab, (4, 8), generator=gen)
    loss, _ = loss_fn(cfg, rules)(
        params, {"tokens": tokens, "labels": tokens.roll(-1, 1)},
        make_moe_tables(cfg, rules, phase="train"))
    loss.backward()
    assert all(torch.equal(w.grad, torch.ones_like(w))
               for w in leaves(whole))
    assert all(p.grad is not None and p.grad.shape == p.shape
               for p in leaves(params))
    served = shard_params(cfg, whole, rules, "prefill")
    assert any(p is w for p, w in zip(leaves(served), leaves(whole)))


# ---------------------------------------------------------------------------
# run_cell, the roofline
# ---------------------------------------------------------------------------

def test_run_cell_production_and_skipped():
    """qwen3-moe-235b prefill_32k on one rank of 16 x 16 is ``ok`` with
    every field, its kernels reported and none launched; hubert has no
    decode step."""
    ops.reset_launch_counts()
    rec = dryrun.run_cell("qwen3-moe-235b-a22b", "prefill_32k", False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert {"arch", "shape", "mesh", "rank", "n_params", "n_active_params",
            "status", "memory", "costs", "trace_s"} <= set(rec)
    mem = rec["memory"]
    assert mem["per_device_total_bytes"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    costs = rec["costs"]
    assert costs["kernel_calls"] == {"route_select": 94,
                                     "ragged_moe_ffn": 94,
                                     "flash_attn_fwd": 94}
    assert costs["collective_by_kind"]["all-to-all"] > 0
    assert costs["flops_per_device"] > costs["kernel_flops"][
        "ragged_moe_ffn"] > 0
    assert all(v == 0 for v in ops.launch_counts().values())
    # the rank's inputs of a cell by name, on meta
    spec = dryrun.input_specs("granite-moe-3b-a800m", "decode_32k",
                              make_mesh((16, 16), ("data", "model")))
    assert spec["rules"].ep_all_size == 256 and spec["phase"] == "decode"
    assert {t.device.type for t in leaves(
        [spec[k] for k in ("params", "tables", "cache", "token", "pos")])} \
        == {"meta"}
    skipped = dryrun.run_cell("hubert-xlarge", "decode_32k", False)
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == "encoder-only arch has no decode step"


def test_roofline_terms_h100_arithmetic():
    rec = {"arch": "smollm-360m", "shape": "train_4k", "mesh": "16x16",
           "status": "ok", "memory": {"per_device_total_bytes": 3 * 2 ** 30},
           "costs": {"flops_per_device": 2.0e15, "bytes_per_device": 1.0e12,
                     "collective_bytes_per_device": 5.0e10}}
    t = roofline.roofline_terms(rec)
    assert t["compute_s"] == 2.0e15 / 989e12
    assert t["memory_s"] == 1.0e12 / 3.35e12
    assert t["collective_s"] == 5.0e10 / 50e9
    assert t["dominant"] == "compute"
    from repro_torch.configs import get
    mf = 6.0 * get("smollm-360m").n_active_params() * 256 * 4096 / 256
    assert t["model_flops_per_device"] == mf
    assert t["useful_ratio"] == mf / 2.0e15
    assert t["roofline_fraction"] == (mf / 989e12) / (2.0e15 / 989e12)
    assert t["mem_gib"] == 3.0
    assert np.isfinite(list(t.values())[:3]).all()
