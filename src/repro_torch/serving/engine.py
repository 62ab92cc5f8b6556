"""PyTorch serving engine: continuous batching + KV cache + ViBE integration.

The counterpart of ``repro.serving.engine`` with the same surface and stats:
the model runs eagerly (prefill + batched decode with per-lane positions),
the router's tallies feed the ViBE controller, and a placement update
migrates the stacked expert weights (:func:`~repro_torch.models.moe.
apply_placement`) and swaps the slot-lookup tables. The virtual clock, the
scheduler, the paged KV accounting and the controller are the port's copies
of the reference's numpy modules, so they behave identically.

Differences from the reference:

* ``rules=None`` means the port's single-device ``ShardingRules()``: the
  ragged dispatch through the grouped-FFN kernel. The reference's
  ``rules=None`` runs its dense oracle (every expert on every token).
* ``device=None`` is ``cuda`` and raises without a card; pass
  ``device="cpu"`` to run the plain versions on the host.
* Steps are eager calls, not ``jax.jit`` functions.
* ``_insert_cache`` copies a prefilled cache into its lane in place
  (zeroing the rest of the lane, as the reference's padded copy does), and
  decode writes each new KV row in place.
* Routing tallies come to the host once per step.
* Chunked prefill (``prefill_chunk > 0``) is not ported yet.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import (ClusterVariability, ReplicatedPlacement,
                              ViBEController)
from repro_torch.device import resolve_device
from repro_torch.models import (ShardingRules, decode_fn, init_cache,
                                init_params, make_moe_tables, moe_perm_shape,
                                prefill_fn, refresh_moe_share_tables)
from repro_torch.models.model import block_layout
from repro_torch.models.moe import apply_placement
from .config import EngineConfig
from .kvcache import PagedKVCache
from .metrics import RejectReason, RequestRecord
from .scheduler import (RequestView, SchedulerContext, get_scheduler,
                        shed_victims)
from .simulator import (capacity_bucket_rows, rank_latency_matrix,
                        realized_rank_loads)
from .workload import Request

__all__ = ["Engine", "EngineStats", "EngineConfig"]


@dataclasses.dataclass
class EngineStats:
    steps: int = 0
    prefill_steps: int = 0           # requests whose prefill completed
    chunk_steps: int = 0             # individual prefill-chunk model calls
    decode_steps: int = 0
    migrations: int = 0
    migrated_slots: int = 0
    migration_bytes: int = 0
    steal_updates: int = 0           # share-only table refreshes (stealing)
    dropped_assignments: float = 0.0  # capacity-overflow drops (all layers)
    virtual_time: float = 0.0
    # token-conservation ledger: prefill_tokens + decode_tokens ==
    # useful_tokens + lost_tokens when the engine is idle
    prefill_tokens: int = 0
    decode_tokens: int = 0
    useful_tokens: int = 0
    lost_tokens: int = 0
    preemptions: int = 0
    rejected: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class _Prefilling:
    """An admitted request whose prompt is (partially) in the cache."""

    req: Request
    lane: int
    prompt: np.ndarray               # (1, prompt_len) generated tokens
    prefilled: int = 0


class Engine:
    """Continuous-batching engine for one model on one device.

    ``Engine(cfg, EngineConfig(...), controller=..., cluster=...,
    device=None, params=None)``. ``params`` (the port's layout, one slot per
    expert) replaces the seeded draw — the tests pass the reference's
    weights through :func:`repro_torch.bridge.params_from_numpy`.
    """

    config = EngineConfig()

    def __init__(self, cfg: ArchConfig,
                 config: Optional[EngineConfig] = None, *,
                 rules: Optional[ShardingRules] = None,
                 controller: Optional[ViBEController] = None,
                 cluster: Optional[ClusterVariability] = None,
                 device=None, params=None):
        config = EngineConfig() if config is None else config
        if not isinstance(config, EngineConfig):
            raise TypeError("config must be an EngineConfig, "
                            f"got {type(config).__name__}")
        self.config = config = config.resolve()
        if config.scheduler.prefill_chunk > 0:
            raise NotImplementedError(
                "chunked prefill (prefill_chunk > 0) is not ported yet: it "
                "is the next slice after the capacity path")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.rules = ShardingRules() if rules is None else rules
        # the clock's capacity pricing reads the config's factor unless
        # rules were given, as the reference does
        self._capacity_factor = (config.capacity_factor if rules is None
                                 else rules.capacity_factor)
        self.controller = controller
        self.cluster = cluster
        self.max_batch = config.max_batch
        self.max_seq = config.max_seq
        # which grouped-FFN implementation the virtual clock prices
        moe_impl = config.moe_impl
        if moe_impl is None:
            moe_impl = self.rules.moe_impl
        self.moe_impl = moe_impl
        self.weighted_routing = config.weighted_routing
        self.stats = EngineStats()
        if params is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(config.seed)
            params = init_params(cfg, gen, self.device)
        self.params = params
        self.n_moe, self.n_slots = (moe_perm_shape(cfg)
                                    if cfg.is_moe else (0, 0))
        self._perm = (np.tile(np.arange(self.n_slots, dtype=np.int32),
                              (self.n_moe, 1)) if cfg.is_moe else None)
        self._share: Optional[np.ndarray] = None
        self._r_max: Optional[int] = None
        if cfg.is_moe and controller is not None:
            # replication-capable policies: grow the stacked expert tensors
            # to the placement's slot budget
            want = controller.placement.perm.shape[1]
            if want > self.n_slots:
                self._expand_slots(want)
            # pin the copy-axis width so recalibrations keep table shapes
            self._r_max = min(controller.G,
                              self.n_slots - controller.E + 1)
        if controller is not None \
                and getattr(controller, "rescheduler", None) is not None \
                and not self.weighted_routing:
            raise ValueError("controller has work stealing enabled "
                             "(ViBEConfig.steal) but weighted_routing is "
                             "False — stolen shares would never reach "
                             "dispatch")
        if config.topology is not None and controller is not None \
                and config.topology.n_ranks != controller.G:
            raise ValueError(f"topology has {config.topology.n_ranks} ranks "
                             f"but the controller has {controller.G}")
        self._steal_version = 0
        if controller is not None:
            self._apply_perm(self._controller_perm(), charge=False)
        else:
            self.moe_tables = make_moe_tables(
                cfg, perm=self._perm, n_slots=self.n_slots,
                device=self.device) if cfg.is_moe else None
        self._prefill = prefill_fn(cfg, self.rules)
        self._decode = decode_fn(cfg, self.rules)
        self.scheduler = get_scheduler(config.scheduler.name)
        self._sched_cfg = config.scheduler
        self._chunk = config.scheduler.prefill_chunk
        self.kv = PagedKVCache(config.kv)
        self._prefill_streak = 0
        dtype = self.params["embed"].dtype
        self.cache = init_cache(cfg, self.max_batch, self.max_seq,
                                dtype=dtype, device=self.device)
        self.tokens = torch.zeros((self.max_batch, 1), dtype=torch.int32,
                                  device=self.device)
        self.pos = np.zeros(self.max_batch, np.int64)
        self.slot_req: List[Optional[Request]] = [None] * self.max_batch
        self.slot_left = np.zeros(self.max_batch, np.int64)
        self.records: Dict[int, RequestRecord] = {}
        self.waiting: collections.deque = collections.deque()
        self._prefilling: Dict[int, _Prefilling] = {}

    # -- placement plumbing -------------------------------------------------

    def _expand_slots(self, n_slots: int) -> None:
        """Grow stacked expert tensors to ``n_slots`` physical slots; new
        slot p starts holding logical expert p % E."""
        if n_slots < self.n_slots:
            raise ValueError(f"cannot shrink slots {self.n_slots}→{n_slots}")
        if n_slots == self.n_slots:
            return
        E = self.cfg.n_experts
        src = np.concatenate([np.arange(self.n_slots, dtype=np.int32),
                              np.arange(self.n_slots, n_slots,
                                        dtype=np.int32) % E])
        gi = torch.as_tensor(src, dtype=torch.int64, device=self.device)
        _, specs = block_layout(self.cfg)
        for i, spec in enumerate(specs):
            if spec.ffn != "moe":
                continue
            leaf = self.params["blocks"][i]["ffn"]
            grown = {k: leaf[k].index_select(1, gi)
                     for k in ("w1", "w2", "w3") if k in leaf}
            self.params["blocks"][i]["ffn"] = {**leaf, **grown}
        self._perm = np.tile(src, (self.n_moe, 1))
        self.n_slots = n_slots

    def _controller_perm(self) -> np.ndarray:
        perm = self.controller.placement.perm            # (n_moe, n_slots)
        if perm.shape != (self.n_moe, self.n_slots):
            raise ValueError(f"controller placement {perm.shape} != "
                             f"{(self.n_moe, self.n_slots)}")
        return perm

    def _controller_share(self) -> Optional[np.ndarray]:
        """Per-slot traffic shares of the controller's placement, or None
        (uniform split) for singleton placements or uniform routing."""
        if self.controller is None or not self.weighted_routing:
            return None
        pl = getattr(self.controller, "dispatch_placement",
                     self.controller.placement)
        return getattr(pl, "share", None)

    _AUTO_SHARE = object()      # sentinel: derive from the controller

    def _apply_perm(self, new_perm: np.ndarray, share=_AUTO_SHARE,
                    charge: bool = True) -> int:
        """Migrate expert weights + slot/share tables to a new placement;
        returns the number of (layer, slot) tensors that moved."""
        if share is Engine._AUTO_SHARE:
            share = self._controller_share()
        nb, specs = block_layout(self.cfg)
        m = self.n_moe // nb
        moved_total = 0
        moe_positions = [i for i, s in enumerate(specs) if s.ffn == "moe"]
        for jj, i in enumerate(moe_positions):
            old_j = self._perm[jj::m] if m else self._perm
            new_j = new_perm[jj::m]
            leaf = self.params["blocks"][i]["ffn"]
            migrated, moved = apply_placement(leaf, old_j, new_j)
            self.params["blocks"][i]["ffn"] = {**leaf, **migrated}
            moved_total += moved
        self._perm = new_perm.copy()
        self._share = None if share is None else np.array(share)
        self.moe_tables = make_moe_tables(self.cfg, perm=self._perm,
                                          n_slots=self.n_slots,
                                          share=self._share,
                                          r_max=self._r_max,
                                          device=self.device)
        self._sync_steal_version()
        if charge:
            per_slot = 3 * self.cfg.d_model * self.cfg.moe_d_ff * 2
            moved_bytes = moved_total * per_slot
            self.stats.migrations += 1
            self.stats.migrated_slots += moved_total
            self.stats.migration_bytes += moved_bytes
            if self.cluster is not None:
                # the weight transfer stalls serving: charge it to the clock
                topo = self.config.topology
                if topo is not None:
                    self.stats.virtual_time += topo.migration_cost(moved_bytes)
                else:
                    self.stats.virtual_time += \
                        moved_bytes / self.cluster.ici_bw
        return moved_total

    def _observe(self, tallies: np.ndarray, tokens: float) -> None:
        if self.controller is None:
            return
        t = self._controller_tallies(tallies)
        upd = self.controller.observe(t, tokens=tokens)
        if upd is not None:
            self._apply_perm(self._controller_perm())
        elif self._steal_dirty():
            self._apply_share()

    def _steal_dirty(self) -> bool:
        rs = getattr(self.controller, "rescheduler", None)
        return rs is not None and rs.version != self._steal_version

    def _sync_steal_version(self) -> None:
        rs = getattr(self.controller, "rescheduler", None)
        self._steal_version = rs.version if rs is not None else 0

    def _apply_share(self) -> None:
        """Share-only dispatch-table refresh after a steal update."""
        rs = self.controller.rescheduler
        self._share = np.array(rs.placement.share)
        self.moe_tables = refresh_moe_share_tables(
            self.cfg, self.moe_tables, self._perm, self._share)
        self._sync_steal_version()
        self.stats.steal_updates += 1
        if self.cluster is not None:
            topo = self.config.topology
            if topo is not None:
                self.stats.virtual_time += \
                    topo.broadcast_cost(rs.share_table_bytes)
            else:
                self.stats.virtual_time += \
                    rs.share_table_bytes / self.cluster.ici_bw

    def _controller_tallies(self, tallies: np.ndarray) -> np.ndarray:
        """Strip the drop column and pad to the controller's width."""
        t = np.asarray(tallies, dtype=np.float64)[:, :self.cfg.n_experts]
        if t.shape[1] < self.controller.E:
            t = np.pad(t, ((0, 0), (0, self.controller.E - t.shape[1])))
        return t

    # -- virtual clock -------------------------------------------------------

    def _clock_placement(self):
        """The placement whose traffic split the virtual clock prices (a
        uniform-share view of it under ``weighted_routing=False``)."""
        pl = getattr(self.controller, "dispatch_placement",
                     self.controller.placement)
        if self.weighted_routing:
            return pl
        if getattr(self, "_uniform_clock_src", None) is not pl:
            se = pl.slot_expert
            nc_pad = np.concatenate(
                [pl.n_copies(), np.ones((pl.n_layers, 1))], axis=1)
            share = np.where(se < pl.n_experts,
                             1.0 / np.take_along_axis(nc_pad, se, axis=1),
                             0.0)
            self._uniform_clock_pl = ReplicatedPlacement(
                se, share, pl.n_ranks, pl.n_experts)
            self._uniform_clock_src = pl
        return self._uniform_clock_pl

    def _charge(self, tallies: np.ndarray, tokens: int) -> float:
        """Advance virtual time using ground-truth cluster latencies (the
        reference's pricing, unchanged) and feed the per-rank samples to
        the controller's drift telemetry."""
        if self.cluster is None or self.controller is None \
                or not self.cfg.is_moe:
            dt = 1e-3 * max(tokens, 1)
            self.stats.virtual_time += dt
            return dt
        if self.moe_impl == "capacity":
            cap = capacity_bucket_rows(tokens, self.cfg.top_k,
                                       self.n_slots, self._capacity_factor)
            budget = self.controller.placement.rank_slot_budget()
            rank_load = budget.astype(np.float64) * cap
        else:
            rank_load = realized_rank_loads(
                self._clock_placement(), self._controller_tallies(tallies))
        rank_time = rank_latency_matrix(self.cluster, rank_load,
                                        t=self.stats.virtual_time)
        dt = float(rank_time.max(1).sum())
        self.stats.virtual_time += dt
        upd = self.controller.observe_latency(rank_load, rank_time)
        if upd is not None:
            self._apply_perm(self._controller_perm())
        return dt

    def observe_step(self, tallies, tokens: float, latencies=None) -> float:
        """Feed one step's telemetry; returns the step's virtual duration.
        ``latencies`` — optional measured ``(rank_load, rank_time)``."""
        tall = np.asarray(tallies)
        if latencies is None:
            dt = self._charge(tall, tokens)
        else:
            rank_load, rank_time = latencies
            rank_time = np.asarray(rank_time, dtype=np.float64)
            dt = float(rank_time.max(1).sum())
            self.stats.virtual_time += dt
            if self.controller is not None:
                upd = self.controller.observe_latency(rank_load, rank_time)
                if upd is not None:
                    self._apply_perm(self._controller_perm())
        self._observe(tall, float(tokens))
        return dt

    # -- request lifecycle ----------------------------------------------------

    def submit(self, reqs: List[Request]) -> List[RequestRecord]:
        """Submit requests; returns the records of the ones REJECTED
        (typed: too long, or a KV reservation that can never fit)."""
        out = []
        for r in reqs:
            rec = RequestRecord(r.req_id, r.arrival, r.prompt_len,
                                r.output_len, tenant=r.tenant)
            self.records[r.req_id] = rec
            total = min(r.prompt_len + r.output_len, self.max_seq)
            floor = int(self.kv.config.n_blocks * self.kv.config.watermark)
            if r.prompt_len > self.max_seq:
                self._reject(rec, RejectReason.TOO_LONG)
            elif self.kv.config.blocks_for(total) > \
                    self.kv.config.n_blocks - floor:
                self._reject(rec, RejectReason.NEVER_FITS)
            else:
                self.waiting.append(r)
                continue
            out.append(rec)
        return out

    def _reject(self, rec: RequestRecord, reason: RejectReason) -> None:
        rec.reject_reason = reason
        self.stats.rejected[reason.value] = \
            self.stats.rejected.get(reason.value, 0) + 1

    def _lane_free(self, b: int) -> bool:
        if self.slot_req[b] is not None:
            return False
        return all(p.lane != b for p in self._prefilling.values())

    def _free_slot(self) -> Optional[int]:
        for b in range(self.max_batch):
            if self._lane_free(b):
                return b
        return None

    def _insert_cache(self, slot: int, pre_cache) -> None:
        """Copy a prefilled (batch-1) cache into lane ``slot`` in place:
        the prompt rows, then zeros to ``max_seq`` (the reference pads the
        prefill cache and sets the whole lane)."""
        for (ek, ev), (pk, pv) in zip(self.cache, pre_cache):
            for ec, pc in ((ek, pk), (ev, pv)):
                S = pc.shape[2]
                ec[:, slot, :S].copy_(pc[:, 0])
                ec[:, slot, S:].zero_()

    def _release(self, lane: int) -> None:
        r = self.slot_req[lane]
        self.slot_req[lane] = None
        self.kv.free_seq(r.req_id)

    # -- scheduling ----------------------------------------------------------

    def _build_context(self) -> SchedulerContext:
        prefilling = [RequestView(p.req.req_id, p.req.arrival,
                                  p.req.prompt_len, p.req.output_len,
                                  p.prefilled, p.req.ttft_slo)
                      for p in self._prefilling.values()]
        waiting, blocked = [], []
        for r in self.waiting:
            total = min(r.prompt_len + r.output_len, self.max_seq)
            view = RequestView(r.req_id, r.arrival, r.prompt_len,
                               r.output_len, 0, r.ttft_slo)
            (waiting if self.kv.can_admit(total) else blocked).append(view)
        n_free = sum(1 for b in range(self.max_batch) if self._lane_free(b))
        n_running = sum(1 for s in self.slot_req if s is not None)
        return SchedulerContext(
            now=self.stats.virtual_time, config=self._sched_cfg,
            waiting=waiting, prefilling=prefilling, n_running=n_running,
            prefill_streak=self._prefill_streak, can_start=n_free,
            chunk_budget=self._chunk if self._chunk > 0 else self.max_seq,
            blocked=blocked, kv_utilization=self.kv.utilization())

    # -- overload protection -------------------------------------------------

    def _shed_overload(self) -> None:
        """Watermark load shedding (``SchedulerConfig.shed_watermark``)."""
        if self._sched_cfg.shed_watermark <= 0.0 or not self.waiting:
            return
        victims = set(shed_victims(self._build_context()))
        if not victims:
            return
        keep: collections.deque = collections.deque()
        for r in self.waiting:
            if r.req_id in victims:
                self._reject(self.records[r.req_id], RejectReason.SHED)
            else:
                keep.append(r)
        self.waiting = keep

    def _maybe_preempt(self) -> None:
        """Preempt the decode lane with the fewest produced tokens when KV
        pressure starves every waiting request (bounded retries)."""
        cfgp = self._sched_cfg
        if not cfgp.preempt_decodes or not self.waiting:
            return
        if any(self.kv.can_admit(min(r.prompt_len + r.output_len,
                                     self.max_seq))
               for r in self.waiting):
            return
        victims = []
        for b in range(self.max_batch):
            r = self.slot_req[b]
            if r is None:
                continue
            if self.records[r.req_id].preemptions >= cfgp.max_preemptions:
                continue
            decoded = int(r.output_len - 1 - self.slot_left[b])
            victims.append((max(decoded, 0), b))
        if not victims:
            return
        decoded, b = min(victims)
        r = self.slot_req[b]
        self.slot_req[b] = None
        self.slot_left[b] = 0
        self.pos[b] = 0
        self.kv.free_seq(r.req_id)
        rec = self.records[r.req_id]
        rec.preemptions += 1
        rec.requeues += 1
        self.stats.preemptions += 1
        self.stats.lost_tokens += r.prompt_len + decoded
        self.waiting.append(r)

    def step(self) -> bool:
        """One engine step, as the scheduler directs: one whole-prompt
        prefill or one batched decode. Returns False when idle."""
        self._shed_overload()
        self._maybe_preempt()
        action = self.scheduler.schedule(self._build_context())
        if action.kind == "prefill":
            self._exec_prefill(action.chunks[0].req_id)
            self._prefill_streak += 1
            self.stats.steps += 1
            return True
        if action.kind == "decode":
            self._exec_decode()
            self._prefill_streak = 0
            self.stats.steps += 1
            return True
        return False

    def _exec_prefill(self, req_id: int) -> None:
        st = self._prefilling.get(req_id)
        if st is None:
            # admission: reserve a lane + the full worst-case KV block count
            r = next(x for x in self.waiting if x.req_id == req_id)
            self.waiting = collections.deque(
                x for x in self.waiting if x.req_id != req_id)
            lane = self._free_slot()
            self.kv.allocate(r.req_id,
                             min(r.prompt_len + r.output_len, self.max_seq))
            self.stats.virtual_time = max(self.stats.virtual_time, r.arrival)
            prompt = np.random.default_rng(r.req_id).integers(
                0, self.cfg.vocab, size=(1, r.prompt_len))
            st = _Prefilling(r, lane, prompt)
            self._prefilling[req_id] = st
        self._prefill_whole(st)

    def _prefill_whole(self, st: _Prefilling) -> None:
        r = st.req
        tokens = torch.as_tensor(st.prompt, dtype=torch.int32,
                                 device=self.device)
        logits, pre_cache, tallies = self._prefill(
            self.params, {"tokens": tokens}, self.moe_tables)
        self._insert_cache(st.lane, pre_cache)
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        self.tokens[st.lane, 0] = nxt[0]
        st.prefilled = r.prompt_len
        self.kv.advance(r.req_id, min(r.prompt_len, self.max_seq))
        self.stats.prefill_tokens += r.prompt_len
        tall = tallies.cpu().numpy()                  # one host copy a step
        if self.cfg.is_moe and tall.size:
            self.stats.dropped_assignments += float(tall[:, -1].sum())
        self.observe_step(tall, float(r.prompt_len))
        self._finish_prefill(st)
        self.stats.prefill_steps += 1

    def _finish_prefill(self, st: _Prefilling) -> None:
        r = st.req
        del self._prefilling[r.req_id]
        self.pos[st.lane] = r.prompt_len
        self.slot_req[st.lane] = r
        self.slot_left[st.lane] = r.output_len - 1
        rec = self.records[r.req_id]
        if not np.isfinite(rec.first_token_at):
            rec.first_token_at = self.stats.virtual_time
        if r.output_len <= 1:
            rec.finished_at = self.stats.virtual_time
            self.stats.useful_tokens += r.prompt_len
            self._release(st.lane)

    def _exec_decode(self) -> None:
        active = [b for b in range(self.max_batch)
                  if self.slot_req[b] is not None]
        pos = torch.as_tensor(np.minimum(self.pos, self.max_seq - 1),
                              dtype=torch.int32, device=self.device)
        logits, self.cache, tallies = self._decode(
            self.params, self.tokens, self.cache, pos, self.moe_tables)
        self.tokens = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        tall = tallies.cpu().numpy()                  # one host copy a step
        if self.cfg.is_moe and tall.size:
            self.stats.dropped_assignments += float(tall[:, -1].sum())
        self.observe_step(tall, float(len(active)))
        self.stats.decode_tokens += len(active)
        for b in active:
            if self.pos[b] < self.max_seq:
                self.kv.extend(self.slot_req[b].req_id)
            self.pos[b] += 1
            self.slot_left[b] -= 1
            if self.slot_left[b] <= 0 or self.pos[b] >= self.max_seq - 1:
                r = self.slot_req[b]
                rec = self.records[r.req_id]
                rec.finished_at = self.stats.virtual_time
                self.stats.useful_tokens += r.prompt_len + max(
                    int(r.output_len - 1 - self.slot_left[b]), 0)
                self._release(b)
        self.stats.decode_steps += 1

    def run(self, max_steps: int = 10_000) -> List[RequestRecord]:
        for _ in range(max_steps):
            if not self.step():
                break
        return list(self.records.values())
