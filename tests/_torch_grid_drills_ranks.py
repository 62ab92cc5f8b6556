"""Shared by the tests of the drills and the capacity path on the grid
engine (tests/test_torch_grid_drills.py).

granite smoke on 4 gloo ranks, f32, on the reference's weights:

* the drills (:data:`DRILLS`) on (2, 2) from ``make_rules(cfg, grid,
  "prefill")``, each on an engine of its own built as
  ``tests/test_torch_drills.py`` builds its engines (:func:`drill_engine`:
  ``vibe_h`` on a 2 x 4 topology of 8 virtual ranks, which grows the 8
  experts to 16 slots before the cut, so the decode tree keeps the decode
  fleet's default 8): the elasticity drill (virtual rank 1 fails at step
  4, its lane 1 drained on ``dp`` rank 0; after it a shorter prompt is
  prefilled into that lane), the chaos drill under the default schedule
  and under :data:`DSL`; a fail and a recover of virtual rank 3 with no
  traffic between (:func:`roundtrip`); the slot table widened after the
  cut (:data:`EXPAND`: a fresh ``vibe`` engine from 8 slots, whose decode
  tree follows the placement, to 12, where it no longer does; and the
  default chaos drill's engine from 16 to 20);
* the capacity path (:data:`CAPACITY`): a ``vibe`` engine from
  ``make_rules(..., moe_impl="capacity")`` on (2, 2), where every call
  runs the replicated body (a one-request prefill, which ``dp`` 2 does not
  divide, and decode over the decode fleet), and on (1, 4), where a
  prefill whose length 4 divides runs the a2a body; each engine's
  prefills of :data:`CAPACITY`'s prompts and one decode step on seeded
  inputs (:func:`decode_inputs`) before it serves the requests of
  ``_torch_grid_engine_ranks``, every routing call's slots captured for a
  recount of the drops (:func:`recount_drops`).

:func:`grid_drills_rank` runs all of it on one rank; the test holds what
it returns against the JAX engine and the port's one-rank engine (the
drills) and against :func:`jax_capacity`, the reference's own calls on
meshes of the same shapes of 4 fake devices (the capacity path).

This module imports neither torch nor jax at its top: the rank processes
import it without jax, the reference's process without torch.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np

import _torch_grid_engine_ranks as h

AXES, SHAPE, ARCH = h.AXES, h.SHAPE, h.ARCH
MAX_BATCH, MAX_SEQ = h.MAX_BATCH, h.MAX_SEQ
N_DRILL_REQUESTS = 6
DSL = "fail@4:1,stall@6:2x0.4+0.5,recover@9:1"
#: drill → (kind, its argument): the elasticity drill's (virtual rank, step)
#: or the chaos drill's schedule
DRILLS = {"failure": ("failure", (1, 4)),
          "chaos_default": ("chaos", "default"),
          "chaos_dsl": ("chaos", DSL)}
#: the virtual rank of the fail → recover round trip
ROUNDTRIP_RANK = 3
#: after the elasticity drill, a prompt shorter than any before it into the
#: lane the failure drained
DRAINED_LANE, SHORT_PROMPT = 1, 9
#: ``_expand_slots`` after the cut: case → (its engine, the width)
EXPAND = {"fresh": ("vibe", 12), "after_chaos": ("chaos_default", 20)}
#: the capacity engines: case → (grid shape, the prompt lengths of the
#: prefills held against the reference). On (1, 4) a length that 4 divides
#: runs the a2a body, 42 the replicated fallback
CAPACITY = {"cap_2x2": ((2, 2), (48, 9)), "cap_1x4": ((1, 4), (48, 42))}
#: the decode step on seeded inputs: each lane's position
DECODE_POS = (20, 13, 31, 6)
STATS = ("steps", "prefill_steps", "decode_steps", "prefill_tokens",
         "decode_tokens", "useful_tokens", "lost_tokens", "migrations",
         "migrated_slots", "migration_bytes", "virtual_time",
         "dropped_assignments")


def drill_engine(core, serving, cfg, n_moe, n_slots, **kw):
    """An engine of either package under ``vibe_h`` on a 2 x 4 topology of
    8 virtual ranks (``mi325x``), as ``tests/test_torch_drills.py`` builds
    its engines; ``kw`` goes to ``Engine`` (rules, device, params)."""
    ranks = min(8, n_slots)
    cluster = core.make_cluster(ranks, "mi325x", d_model=cfg.d_model,
                                d_ff=cfg.moe_d_ff,
                                experts_per_rank=max(n_slots // ranks, 1),
                                seed=0)
    topo = core.parse_topology("2x4", ici_bw=cluster.ici_bw)
    ctl = core.ViBEController(
        n_moe, n_slots, ranks, cluster.fit_models(),
        core.ViBEConfig(policy="vibe_h",
                        drift=core.DriftConfig(window=20, interval=5,
                                               cooldown=5),
                        expert_bytes=3 * cfg.d_model * cfg.moe_d_ff * 2,
                        topology=topo))
    config = serving.EngineConfig(max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                                  seed=0, topology=topo)
    return serving.Engine(cfg, config, controller=ctl, cluster=cluster, **kw)


def drill_requests(serving):
    """``tests/test_torch_drills.py``'s 6 sharegpt requests, capped."""
    reqs = serving.sample_requests(serving.WORKLOADS["sharegpt"],
                                   N_DRILL_REQUESTS, qps=50.0, seed=0)
    return [dataclasses.replace(r, prompt_len=min(r.prompt_len, MAX_SEQ // 2),
                                output_len=min(r.output_len,
                                               MAX_SEQ // 2 - 1))
            for r in reqs]


def run_drill(serving, engine, name):
    """Drill ``name`` on ``engine`` (either package's); returns what the
    tests compare: the reports (``at_time`` apart), the records' requeues,
    the stats, the KV pool, the cluster's events."""
    kind, arg = DRILLS[name]
    reqs = drill_requests(serving)
    if kind == "failure":
        rank, at = arg
        records, rep = serving.run_with_failure(engine, reqs, rank=rank,
                                                at_step=at)
        out = {"reports": [("rank_fail", dataclasses.asdict(rep))],
               "skipped": [], "violations": [], "steps": None}
    else:
        chaos = serving.run_chaos(engine, reqs,
                                  serving.FaultSchedule.parse(arg, 8))
        records = chaos.records
        out = {"reports": [(s.kind, _applied(s, res))
                           for s, res in chaos.applied],
               "specs": [dataclasses.astuple(s) for s, _ in chaos.applied],
               "skipped": [(dataclasses.astuple(s), why)
                           for s, why in chaos.skipped],
               "violations": chaos.violations, "steps": chaos.steps}
    st = engine.stats
    out |= {"requeues": [r.requeues for r in records],
            "finished": [bool(np.isfinite(r.finished_at)) for r in records],
            "ttft": [float(r.first_token_at - r.arrival) for r in records],
            "stats": {f: getattr(st, f) for f in STATS},
            "kv": (engine.kv.used_blocks, engine.kv.n_seqs,
                   engine.kv.peak_blocks),
            "dead": tuple(engine.controller.dead_ranks),
            "events": [dataclasses.astuple(e) for e in engine.cluster.events],
            "perm": np.array(engine._perm)}
    return out


def _applied(spec, res):
    """An applied fault's result, comparable across packages: a report's
    fields, a stall's event, a DCN window's degraded bandwidth."""
    if spec.kind == "dcn_degrade":
        return {"dcn_bw": res.dcn_bw}
    return dataclasses.asdict(res)


def capacity_engine(core, serving, cfg, rules, **kw):
    """A ``vibe`` engine (``_torch_grid_engine_ranks.controller``) on
    ``rules``, ``max_batch`` 4."""
    from repro_torch.models import moe_perm_shape
    ctl, cluster = h.controller(core, cfg, *moe_perm_shape(cfg, rules),
                                "vibe")
    return serving.Engine(cfg, serving.EngineConfig(
        max_batch=MAX_BATCH, max_seq=MAX_SEQ, seed=0), rules=rules,
        controller=ctl, cluster=cluster, **kw)


def prompt(cfg, n):
    return np.random.default_rng(300 + n).integers(0, cfg.vocab,
                                                   size=(1, n))


def decode_inputs(vocab, cache_shapes):
    """The seeded decode step: tokens (B, 1), :data:`DECODE_POS`, and a
    whole cache of ``cache_shapes`` (per position the (k, v) shapes)
    filled with normal values, f32."""
    rng = np.random.default_rng(31)
    tokens = rng.integers(0, vocab, size=(MAX_BATCH, 1)).astype(np.int32)
    cache = [tuple(rng.standard_normal(s).astype(np.float32) for s in kv)
             for kv in cache_shapes]
    return tokens, np.array(DECODE_POS, np.int32), cache


def capacity_rows(t: int, top_k: int, n_slots: int, cf: float,
                  replicated: bool) -> int:
    """A capacity body's bucket rows a slot, as ``moe_layer`` sizes them:
    the replicated body from the call's whole rows and ``max(cf, 2)``, the
    a2a body from the rank's block."""
    if replicated:
        return _round_up(max(math.ceil(t * top_k / n_slots
                                       * max(cf, 2.0)), 4), 4)
    return _round_up(max(math.ceil(t * top_k / n_slots * cf), 1), 4)


def _round_up(x, m):
    return ((x + m - 1) // m) * m


def recount_drops(slots_by_rank, rows, top_k, n_slots, cf):
    """One MoE layer's drops, recounted from its routing: ``slots_by_rank``
    is each rank's (t, top_k) slots of the call. Where every rank routed
    the call's ``rows`` whole, the replicated body: a slot keeps its first
    ``C`` assignments; else each rank's a2a block keeps its first ``C`` a
    slot. Returns (drops, whether the a2a body ran)."""
    a2a = slots_by_rank[0].shape[0] != rows
    groups = slots_by_rank if a2a else slots_by_rank[:1]
    drops = 0
    for s in groups:
        cap = capacity_rows(s.shape[0], top_k, n_slots, cf, not a2a)
        counts = np.bincount(s.reshape(-1), minlength=n_slots)
        drops += int(np.maximum(counts - cap, 0).sum())
    return drops, a2a


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def watched_migrations(serving):
    """Within the block every engine's placement change is logged: (the
    permutation before, after, the rank's expert slices of both trees
    after)."""
    log = []
    apply_perm = serving.Engine._apply_perm

    def watched(self, new_perm, *args, **kw):
        before = self._perm.copy()
        moved = apply_perm(self, new_perm, *args, **kw)
        log.append((before, self._perm.copy(), h._slices(self),
                    self.stats.migration_rank_bytes))
        return moved

    serving.Engine._apply_perm = watched
    try:
        yield log
    finally:
        serving.Engine._apply_perm = apply_perm


@contextlib.contextmanager
def captured_routes():
    """Within the block each routing call's slots (t, top_k) are kept, as
    numpy, in call order."""
    from repro_torch.models import moe as tmoe
    real = tmoe.ops
    calls = []

    class Ops:
        def __getattr__(self, name):
            return getattr(real, name)

        @staticmethod
        def route_select(*args, **kw):
            res = real.route_select(*args, **kw)
            calls.append(res[2].numpy().copy())
            return res

    tmoe.ops = Ops()
    try:
        yield calls
    finally:
        tmoe.ops = real


def _np_cache(cache):
    return [[t.numpy().copy() for t in (c if isinstance(c, tuple)
                                        else c.values())] for c in cache]


def _np_tables(tables):
    return [t.numpy().copy() for t in tables]


def drill_case(name, tree, grid):
    """Drill ``name`` on this rank's grid engine; with the elasticity
    drill, a short prompt into the drained lane after it; the engine is
    returned for :data:`EXPAND`'s second case."""
    import torch
    from repro_torch import core as tcore
    from repro_torch import serving
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import moe_perm_shape
    cfg = get_smoke(ARCH)
    rules = make_rules(cfg, grid, "prefill")
    with watched_migrations(serving) as migs:
        engine = drill_engine(tcore, serving, cfg,
                              *moe_perm_shape(cfg, rules), rules=rules,
                              device="cpu", params=params_from_numpy(tree))
        log = h.record(engine)
        out = run_drill(serving, engine, name)
    if name == "failure":
        with torch.no_grad():
            short = short_prefill(engine)
        out["short_logits"] = short
    out |= {"log": log, "migrations": migs, "cache": _np_cache(engine.cache),
            "follows": engine._dec_follows, "n_slots": engine.n_slots}
    return out, engine


def short_prefill(engine):
    """:data:`SHORT_PROMPT` tokens prefilled into :data:`DRAINED_LANE` and
    inserted there (over the rows the drill left in it); the logits."""
    import torch
    tokens = torch.as_tensor(prompt(engine.cfg, SHORT_PROMPT),
                             dtype=torch.int32, device=engine.device)
    logits, pre, _ = engine._prefill(engine.params, {"tokens": tokens},
                                     engine.moe_tables)
    engine._insert_cache(DRAINED_LANE, pre)
    return logits.numpy().copy()


def _state(engine):
    """What a fail → recover round trip must restore: the placement, both
    trees' tables, the rank's expert slices of both trees."""
    tables = [_np_tables(engine.moe_tables)]
    if engine.decode_tables is not None:
        tables.append(_np_tables(engine.decode_tables))
    return {"perm": np.array(engine._perm), "tables": tables,
            "slices": h._slices(engine)}


def roundtrip(tree, grid):
    """Virtual rank :data:`ROUNDTRIP_RANK` failed and recovered with no
    traffic between, on this rank's grid engine: the reports and the state
    before and after."""
    from repro_torch import core as tcore
    from repro_torch import serving
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import moe_perm_shape
    cfg = get_smoke(ARCH)
    rules = make_rules(cfg, grid, "prefill")
    engine = drill_engine(tcore, serving, cfg, *moe_perm_shape(cfg, rules),
                          rules=rules, device="cpu",
                          params=params_from_numpy(tree))
    before = _state(engine)
    with watched_migrations(serving) as migs:
        f = serving.fail_rank(engine, ROUNDTRIP_RANK)
        r = serving.recover_rank(engine, ROUNDTRIP_RANK)
    return {"fail": dataclasses.asdict(f), "recover": dataclasses.asdict(r),
            "before": before, "after": _state(engine), "migrations": migs}


def expand(engine, n_slots):
    """``engine._expand_slots(n_slots)`` on this rank; its state after."""
    follows = engine._dec_follows
    engine._expand_slots(n_slots)
    return {"follows": (follows, engine._dec_follows),
            "perm": np.array(engine._perm), "n_slots": engine.n_slots,
            "slices": h._slices(engine)}


def fresh_engine(tree, grid):
    """``vibe`` on (2, 2) from ``make_rules``: 8 slots, the decode layout
    following the placement."""
    from repro_torch import core as tcore
    from repro_torch import serving
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules
    cfg = get_smoke(ARCH)
    return capacity_engine(tcore, serving, cfg,
                           make_rules(cfg, grid, "prefill"), device="cpu",
                           params=params_from_numpy(tree))


def capacity_case(name, tree, grid):
    """The capacity engine of ``name`` on this rank: its tables, its
    prefills of the case's prompts and one decode step on the seeded
    inputs, then the served requests with every routing call's slots."""
    import torch
    from repro_torch import core as tcore
    from repro_torch import serving
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules, rank_cache
    from repro_torch.models import init_cache
    cfg = get_smoke(ARCH)
    rules = make_rules(cfg, grid, "prefill", moe_impl="capacity")
    eng = capacity_engine(tcore, serving, cfg, rules, device="cpu",
                          params=params_from_numpy(tree))
    out = {"tables": _np_tables(eng.moe_tables),
           "decode_tables": _np_tables(eng.decode_tables),
           "perm": np.array(eng._perm), "follows": eng._dec_follows,
           "prefills": {}}
    with torch.no_grad(), captured_routes() as routes:
        for n in CAPACITY[name][1]:
            lg, _, tal = eng._prefill(eng.params, {"tokens": torch.as_tensor(
                prompt(cfg, n), dtype=torch.int32)}, eng.moe_tables)
            out["prefills"][n] = (lg.numpy().copy(), tal.numpy().copy(),
                                  list(routes))
            routes.clear()
        whole = init_cache(cfg, MAX_BATCH, MAX_SEQ, dtype=torch.float32)
        tokens, pos, cache = decode_inputs(
            cfg.vocab, [tuple(t.shape for t in kv) for kv in whole])
        cut = rank_cache(cfg, [tuple(torch.as_tensor(t) for t in kv)
                               for kv in cache], rules)
        lg, _, tal = eng._decode(eng.decode_params, torch.as_tensor(tokens),
                                 cut, torch.as_tensor(pos),
                                 eng.decode_tables)
        out["decode"] = (lg.numpy().copy(), tal.numpy().copy(), list(routes))
        routes.clear()
        log = h.record(eng)
        calls = record_calls(eng)
        eng.submit(h.requests(serving))
        eng.run()
        out["routes"] = list(routes)
    out |= {"summary": h.summary(eng, log), "calls": calls}
    return out


def record_calls(engine):
    """Log each model call of ``engine``: (its kind, its rows: the
    prompt's tokens or the lanes, its tallies)."""
    calls = []

    def wrap(kind, fn):
        def call(*args, **kw):
            res = fn(*args, **kw)
            rows = (args[1]["tokens"].shape[1] if kind == "prefill"
                    else args[1].shape[0])
            calls.append((kind, rows, res[2].numpy().copy()))
            return res
        return call

    engine._prefill = wrap("prefill", engine._prefill)
    engine._decode = wrap("decode", engine._decode)
    return calls


def grid_drills_rank(rank, tree):
    """Everything a rank runs (see the module's docstring)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    grid = make_mesh(SHAPE, AXES)
    out = {"rank": rank, "drills": {}, "expand": {}}
    for name in DRILLS:
        out["drills"][name], engine = drill_case(name, tree, grid)
        if name == EXPAND["after_chaos"][0]:
            out["expand"]["after_chaos"] = expand(engine,
                                                  EXPAND["after_chaos"][1])
        del engine
    out["roundtrip"] = roundtrip(tree, grid)
    out["expand"]["fresh"] = expand(fresh_engine(tree, grid),
                                    EXPAND["fresh"][1])
    out["capacity"] = {}
    for name, (shape, _) in CAPACITY.items():
        g = grid if shape == SHAPE else make_mesh(shape, AXES)
        out["capacity"][name] = capacity_case(name, tree, g)
    return out


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------

def jax_capacity(path: str) -> None:
    """:data:`CAPACITY`'s calls through the reference on a mesh of each
    case's shape, on the reference's weights (seed 0, f32) under the
    construction's ``vibe`` placement and tables (built here as the engine
    builds them): the prefills (on a grid whose ``dp`` does not divide the
    batch of 1 its a2a ``shard_map`` cannot run, so ``moe_dispatch=
    "replicated"`` there, what the port's fallback computes) and the
    decode step on :func:`decode_inputs`, through ``prefill_fn`` and
    ``decode_fn`` with ``make_rules(..., moe_impl="capacity")``; the
    logits, tallies and tables, written to ``path`` (.npz). Run in a
    process whose XLA_FLAGS fake 4 devices."""
    import jax
    import jax.numpy as jnp
    from repro import compat
    from repro import core as jcore
    from repro.configs import get_smoke
    from repro.launch.sharding import make_rules
    from repro.models import model as jmodel
    from repro.models import moe as MOE
    cfg = get_smoke(ARCH)
    jp = jmodel.init_params(cfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    nb, specs = jmodel.block_layout(cfg)
    moe_pos = [i for i, s in enumerate(specs) if s.ffn == "moe"]
    res = {}
    for name, (shape, lengths) in CAPACITY.items():
        mesh = compat.make_mesh(shape, AXES, devices=jax.devices()[:4])
        rp = make_rules(cfg, mesh, "prefill", moe_impl="capacity")
        rd = make_rules(cfg, mesh, "decode", moe_impl="capacity")
        n_moe, n_slots = jmodel.moe_perm_shape(cfg, rp, "train")
        ctl, _ = h.controller(jcore, cfg, n_moe, n_slots, "vibe")
        perm = ctl.placement.perm
        share = getattr(ctl, "dispatch_placement", ctl.placement).share
        r_max = min(ctl.G, n_slots - ctl.E + 1)
        identity = np.tile(np.arange(n_slots), (n_moe, 1))
        blocks = list(jp["blocks"])
        for j, i in enumerate(moe_pos):
            rows = np.arange(nb) * len(moe_pos) + j
            # a copy: the reference's migration donates its input
            ffn, _ = MOE.apply_placement(
                jax.tree.map(jnp.array, blocks[i]["ffn"]), identity[rows],
                perm[rows])
            blocks[i] = dict(blocks[i], ffn=ffn)
        placed = dict(jp, blocks=blocks)
        if rp.axis_size(rp.dp_axes) > 1:
            rp_one = dataclasses.replace(rp, moe_dispatch="replicated")
        else:
            rp_one = rp
        key = f"{name}/"
        with compat.use_mesh(mesh):
            tab = jmodel.make_moe_tables(cfg, rp, perm=perm, n_slots=n_slots,
                                         share=share, r_max=r_max)
            for i, t in enumerate(tab):
                res[key + f"tables/{i}"] = np.asarray(t)
            step = jax.jit(jmodel.prefill_fn(cfg, rp_one))
            for n in lengths:
                lg, _, tal = step(placed, {"tokens": jnp.asarray(
                    prompt(cfg, n), jnp.int32)}, tab)
                res[key + f"prefill/{n}/logits"] = np.asarray(lg)
                res[key + f"prefill/{n}/tallies"] = np.asarray(tal)
            n_dec = jmodel.moe_perm_shape(cfg, rd, "decode")[1]
            tab = jmodel.make_moe_tables(cfg, rd, perm=perm, phase="decode",
                                         n_slots=n_dec, share=share,
                                         r_max=r_max)
            for i, t in enumerate(tab):
                res[key + f"decode_tables/{i}"] = np.asarray(t)
            whole = jmodel.init_cache(cfg, MAX_BATCH, MAX_SEQ,
                                      dtype=jnp.float32)
            tokens, pos, cache = decode_inputs(
                cfg.vocab, [tuple(t.shape for t in kv) for kv in whole])
            lg, _, tal = jax.jit(jmodel.decode_fn(cfg, rd))(
                placed, jnp.asarray(tokens),
                [tuple(jnp.asarray(t) for t in kv) for kv in cache],
                jnp.asarray(pos), tab)
            res[key + "decode/logits"] = np.asarray(lg)
            res[key + "decode/tallies"] = np.asarray(tal)
    np.savez(path, **res)
