"""Shared by the tests of the serving engine on the rank grid
(tests/test_torch_grid_engine.py).

granite smoke on 4 gloo ranks, (2, 2) over ("data", "model"), from
``make_rules(cfg, grid, "prefill")``: the lanes and the batch over
"data", attention by heads over "model", EP 2 over "model" at prefill and
EP 4 over both axes at decode. Three cases (:data:`CASES`): ``make_rules``
as it is (no FSDP at smoke size), with the experts and dense weights
FSDP-sliced over "data" (as ``make_rules`` gives the published granite),
and under ``vibe_r``. Each serves :data:`N_REQUESTS` sharegpt requests in
f32 (:func:`controller`'s short drift window recalibrates while they
run), on the reference's weights.

:func:`grid_rank` runs, on every rank: each case's engine, logging each
step's tallies and next tokens and, after each placement change, the
rank's expert slices of both trees; a prefill of one request through
``prefill_fn`` on the rank's tree (batch 1 on dp 2); and
``migrate_experts`` alone on seeded leaves (:data:`MIGRATIONS`). The test
holds what it returns against the JAX engine, the port's one-rank engine
and ``apply_placement`` of the whole tree.

This module imports neither torch nor jax at its top: the rank processes
import it without jax.
"""

from __future__ import annotations

import dataclasses

import numpy as np

AXES = ("data", "model")
SHAPE = (2, 2)
ARCH = "granite-moe-3b-a800m"
MAX_BATCH, MAX_SEQ = 4, 96
N_REQUESTS = 5
#: the controller's drift window: the rolling mean of 4 steps' routing,
#: checked every 2 steps after a cooldown of 4, so the first
#: recalibration comes once decode steps follow the prefills
DRIFT = dict(window=4, interval=2, cooldown=4)
#: case → (the fields replaced in ``make_rules``' rules, the policy).
#: ``vibe_r`` replicates experts into more slots than the decode fleet's
#: default layout has (16 against 8), so the decode tree keeps that layout
#: (``expand_experts``) and does not follow the placement
CASES = {"make_rules": ({}, "vibe"),
         "fsdp": ({"fsdp": ("pod", "data")}, "vibe"),
         "vibe_r": ({}, "vibe_r")}
#: the prompt lengths of the batch-1 prefills (even: the residual's
#: positions split over "model"; odd: they do not)
PREFILL_LENGTHS = (12, 9)
#: ``migrate_experts`` alone: name → (the expert cut's phase and rules
#: fields, layers, slots, replicated placements)
MIGRATIONS = {
    "a2a": ("prefill", {}, 3, 8, False),
    "a2a_fsdp": ("prefill", {"fsdp": ("pod", "data")}, 3, 8, False),
    "decode": ("decode", {}, 2, 8, False),
    "decode_replicas": ("decode", {}, 2, 12, True),
}


def controller(core, cfg, n_moe: int, n_slots: int, policy: str = "vibe"):
    """The controller under ``policy`` and its cluster (``mi325x``, 8
    virtual ranks), as ``tests/test_torch_engine.py`` builds them, with the
    short :data:`DRIFT` window."""
    ranks = min(8, n_slots)
    cluster = core.make_cluster(ranks, "mi325x", d_model=cfg.d_model,
                                d_ff=cfg.moe_d_ff,
                                experts_per_rank=max(n_slots // ranks, 1),
                                seed=0)
    ctl = core.ViBEController(
        n_moe, n_slots, ranks, cluster.fit_models(),
        core.ViBEConfig(policy=policy, drift=core.DriftConfig(**DRIFT),
                        expert_bytes=3 * cfg.d_model * cfg.moe_d_ff * 2))
    return ctl, cluster


def requests(serving):
    """:data:`N_REQUESTS` sharegpt requests, capped as the serve driver
    caps them for :data:`MAX_SEQ` (``serving`` is either package's)."""
    reqs = serving.sample_requests(serving.WORKLOADS["sharegpt"], N_REQUESTS,
                                   qps=50.0, seed=0)
    return [dataclasses.replace(r, prompt_len=min(r.prompt_len, MAX_SEQ // 2),
                                output_len=min(r.output_len,
                                               MAX_SEQ // 2 - 1))
            for r in reqs]


def ttft_tpot(rec):
    ttft = rec.first_token_at - rec.arrival
    tpot = ((rec.finished_at - rec.first_token_at) / (rec.output_len - 1)
            if rec.output_len > 1 else 0.0)
    return ttft, tpot


def record(engine):
    """Log each step's tallies and the lanes' next tokens, as the step
    reports them to the controller (``engine.observe_step``)."""
    log = []
    observe = engine.observe_step

    def recording(tallies, tokens, latencies=None):
        nxt = engine.tokens
        nxt = nxt.numpy() if hasattr(nxt, "numpy") else np.asarray(nxt)
        log.append((np.asarray(tallies, np.float64).copy(), nxt.copy()))
        return observe(tallies, tokens, latencies)

    engine.observe_step = recording
    return log


def summary(engine, log):
    """What the tests compare of a finished engine (either package's)."""
    st = engine.stats
    return {
        "stats": {f: getattr(st, f) for f in (
            "steps", "prefill_steps", "decode_steps", "prefill_tokens",
            "decode_tokens", "migrations", "migrated_slots",
            "migration_bytes", "dropped_assignments")},
        "kv_peak": engine.kv.peak_blocks,
        "log": log,
        "records": {rid: ttft_tpot(r) for rid, r in engine.records.items()},
        "finished": [bool(np.isfinite(r.finished_at))
                     for r in engine.records.values()]}


def _slices(engine):
    """The rank's expert slices of both trees, per MoE position and
    matrix, as numpy."""
    from repro_torch.models.model import block_layout
    _, specs = block_layout(engine.cfg)
    out = {}
    for phase, tree in (("prefill", engine.params),
                        ("decode", engine.decode_params)):
        out[phase] = [{k: tree["blocks"][i]["ffn"][k].numpy().copy()
                       for k in ("w1", "w3", "w2")}
                      for i, sp in enumerate(specs) if sp.ffn == "moe"]
    return out


def hold_migrations(cfg, rules, whole, migrations, follows):
    """Each logged placement change (before, after, the rank's slices, ...;
    the first the construction's, from the identity or the grown
    round-robin table) against ``cut_tree`` of ``apply_placement`` on the
    whole tree ``whole`` (torch) applied change by change: the rank's
    expert slices of both trees bit for bit, the decode tree's, where its
    layout does not follow the placement (``follows``), from
    ``expand_experts`` into the decode fleet's default layout."""
    import torch
    from repro_torch.launch.sharding import cut_tree, param_cuts
    from repro_torch.models.model import default_moe_perm
    from repro_torch.models.moe import apply_placement, expand_experts
    moe = [i for i, b in enumerate(whole["blocks"])
           if "router" in b.get("ffn", {})]
    cuts = {ph: param_cuts(cfg, rules, ph) for ph in ("prefill", "decode")}
    perm = migrations[0][0]
    lidx = torch.arange(perm.shape[0])[:, None]
    ffns = [{k: w[lidx, torch.as_tensor(perm, dtype=torch.int64)]
             for k, w in whole["blocks"][i]["ffn"].items() if k != "router"}
            for i in moe]
    dec_perm = default_moe_perm(cfg, rules, "decode")
    for before, after, slices, _ in migrations:
        np.testing.assert_array_equal(before, perm)
        ffns = [apply_placement(f, before, after)[0] for f in ffns]
        perm = after
        for phase in ("prefill", "decode"):
            for j, i in enumerate(moe):
                ffn = ffns[j]
                if phase == "decode" and not follows:
                    ffn = expand_experts(ffn, perm, dec_perm)
                c = cuts[phase]["blocks"][i]["ffn"]
                for k in ("w1", "w3", "w2"):
                    want = cut_tree(ffn[k], c[k], rules.grid)
                    assert np.array_equal(slices[phase][j][k],
                                          want.numpy()), (phase, k)


def serve_case(name, tree, grid):
    """One case's engine on this rank; returns its summary, the rank's
    final cache, and each placement change's permutations (before, after)
    with the rank's slices after it."""
    import torch
    from repro_torch import core as tcore
    from repro_torch import serving
    from repro_torch.bridge import params_from_numpy
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import make_rules
    from repro_torch.models import moe_perm_shape
    cfg = get_smoke(ARCH)
    over, policy = CASES[name]
    rules = dataclasses.replace(make_rules(cfg, grid, "prefill"), **over)
    ctl, cluster = controller(tcore, cfg, *moe_perm_shape(cfg, rules),
                              policy)
    migrations = []
    apply_perm = serving.Engine._apply_perm

    def watched(self, new_perm, *args, **kw):
        before = self._perm.copy()
        moved = apply_perm(self, new_perm, *args, **kw)
        migrations.append((before, self._perm.copy(), _slices(self),
                           self.stats.migration_rank_bytes))
        return moved

    serving.Engine._apply_perm = watched
    try:
        engine = serving.Engine(
            cfg, serving.EngineConfig(max_batch=MAX_BATCH, max_seq=MAX_SEQ,
                                      seed=0),
            rules=rules, controller=ctl, cluster=cluster, device="cpu",
            params=params_from_numpy(tree))
        log = record(engine)
        engine.submit(requests(serving))
        engine.run()
    finally:
        serving.Engine._apply_perm = apply_perm
    cache = [[t.numpy().copy() for t in (c if isinstance(c, tuple)
                                         else c.values())]
             for c in engine.cache]
    with torch.no_grad():
        prefills = one_request_prefills(cfg, rules, engine)
    return {"summary": summary(engine, log), "cache": cache,
            "migrations": migrations, "prefills": prefills,
            "n_slots": engine.n_slots, "follows": engine._dec_follows}


def prompt(cfg, n):
    return np.random.default_rng(100 + n).integers(0, cfg.vocab, size=(1, n))


def one_request_prefills(cfg, rules, engine):
    """A prefill of one request (batch 1 on dp 2) of each of
    :data:`PREFILL_LENGTHS` through ``prefill_fn`` on the rank's tree and
    the engine's tables: the logits and the tallies."""
    import torch
    from repro_torch.models import prefill_fn
    fn = prefill_fn(cfg, rules)
    out = {}
    for n in PREFILL_LENGTHS:
        lg, _, tal = fn(engine.params, {"tokens": torch.as_tensor(
            prompt(cfg, n), dtype=torch.int32)}, engine.moe_tables)
        out[n] = (lg.numpy(), tal.numpy())
    return out


def migration_leaf(name):
    """:data:`MIGRATIONS`' seeded whole leaf (L, n_slots, 6, 4) and its
    two placements (L, n_slots); the same on every rank."""
    _, _, L, n_slots, replicas = MIGRATIONS[name]
    g = np.random.default_rng(7)
    whole = g.standard_normal((L, n_slots, 6, 4)).astype(np.float32)
    if replicas:                              # 8 experts in 12 slots
        perms = [np.stack([g.permutation(np.arange(n_slots) % 8)
                           for _ in range(L)]) for _ in range(2)]
    else:
        perms = [np.stack([g.permutation(n_slots) for _ in range(L)])
                 for _ in range(2)]
    return whole, perms[0].astype(np.int32), perms[1].astype(np.int32)


def migrate_alone(grid):
    """Each of :data:`MIGRATIONS`: the rank's slice of the seeded whole
    leaf (for w1 and w2), migrated; returns the slices and bytes sent."""
    import torch
    from repro_torch.configs import get_smoke
    from repro_torch.launch.sharding import (cut_tree, make_rules,
                                             migrate_experts, param_cuts)
    cfg = get_smoke(ARCH)
    out = {}
    for name, (phase, over, *_rest) in MIGRATIONS.items():
        rules = dataclasses.replace(make_rules(cfg, grid, "prefill"), **over)
        ffn = param_cuts(cfg, rules, phase)["blocks"][0]["ffn"]
        whole, old, new = migration_leaf(name)
        res = {}
        for k in ("w1", "w2"):
            part = cut_tree(torch.as_tensor(whole), ffn[k], grid)
            got, sent = migrate_experts(part, ffn[k], old, new, grid)
            res[k] = (got.numpy().copy(), sent)
        out[name] = res
    return out


def grid_rank(rank, tree, cases):
    """Everything a rank of the (2, 2) grid runs (see the module's
    docstring)."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    torch.set_num_threads(1)
    grid = make_mesh(SHAPE, AXES)
    out = {"rank": rank, "coords": dict(grid.coords)}
    for name in cases:
        out[name] = serve_case(name, tree, grid)
    out["migrate"] = migrate_alone(grid)
    return out
