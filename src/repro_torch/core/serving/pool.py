"""Replica pools: each pool owns the replicas of ONE Table-I variant,
with its own batcher (max_batch / max_batch_items / max_wait), its own
AutoScaler, its own SLOMonitor and (optionally) its own tiered rate
limiter. Pools plug into a shared EventLoop; the router decides which
pool a request enters, the pool decides whether it is admitted, how it
is batched and which replica serves it (via a pluggable replica picker).

Public API
    Request                the unit of traffic; `cost` is work items
                           carried (1 = pointwise, candidate-set size =
                           ranking), `stage` the cascade stage, `home`
                           the request's home cell (federation)
    PoolConfig             batching + scaling knobs
    ReplicaPool.submit     admission (pool-local limiter) + enqueue;
                           `force=True` bypasses admission (cascade
                           advancement, cross-cell spill arrivals)
    ReplicaPool.predicted_latency / predicted_miss_cost / hit_rate /
    recent_p99 / queued_cost
                           read-only router signals
    ReplicaPool.scale_tick autoscaler + limiter adaptation, driven by
                           the engine's per-tick `scale` event
    ReplicaPool.summary    end-of-run per-pool stats

Units: all times are SECONDS on the shared event-loop clock; `cost`,
`max_batch_items` and `queued_cost` are work ITEMS; rates are per-second.

Invariants the tests pin down:
  - conservation: every submitted request is eventually dispatched and
    completed exactly once (sheds happen only in submit, before enqueue);
  - batching: a closed batch holds <= max_batch requests and (when item
    batching is on) <= max_batch_items work items — except a single
    oversized request, which dispatches alone;
  - no request waits more than max_wait_s for a batch to close (a partial
    remainder re-arms its deadline from the OLDEST queued enqueue time);
  - determinism: given the same arrival list and picker, two runs produce
    bit-identical timelines.

Batching is cost-aware (DeepRecSys-style): a batch closes when it holds
`max_batch` requests OR carries `max_batch_items` work items, whichever
first — so one 512-candidate ranking query does not share a count budget
with 64 pointwise queries. Admission is cost-aware too: a pool-local
HybridRateLimiter draws `Request.cost` tokens per admit and sheds tiers
from the pool's OWN SLO signal, so an overloaded heavy pool protects
itself while cheap pools keep absorbing tail traffic (the fleet-global
limiter in engine.py stays as the outer guard).

Caching is per-pool (serving/cache.py): with a CacheConfig the pool owns
a hot-ID EmbeddingCache — each dispatched batch runs its requests' ids
through it in queue order and pays `ReplicaSpec.embed_fetch_s` per missed
row on top of the dense service time — and optionally a request-signature
ResultCache whose fresh repeats complete instantly (no tokens, no batch).
A pool with NO cache fetches every id row its traffic carries: the
memory-bound baseline the cache exists to beat. Hit-rate feeds the trace,
the summary and the routers' predicted miss cost.

With the shard tier (serving/shard.py) the pool cache becomes the L1 of
a real hierarchy: L1 misses probe the cell-shared L2 cache
(`l2_cache`, built by the engine from CacheConfig.l2), and what BOTH
miss is fetched from the sharded table in one batched `shard.fetch`
call — local-shard rows pay `embed_fetch_s`, remote-shard rows
additionally pay one inter-cell RTT per (batch, remote shard). The
decomposition travels as a `replica.MissProfile` through service time,
the batch-done observation and `predicted_miss_cost`, so the
cost-model router sees the same three-way split the clock charges.

The control plane is per-pool too (serving/control.py, opt-in via a
ControlConfig): an OnlineLatencyModel EWMA-corrects the offline-
calibrated curve from each completed batch's (items, miss rows,
measured seconds) — `dense_latency`, `predicted_latency` and the cost-
model router then consult the corrected curve instead of trusting a
possibly drifted calibration — and a BatchSizeController retunes the
pool's EFFECTIVE `max_batch_items` each scale tick from SLO headroom
(breach narrows for latency, headroom widens for throughput), traced
per tick next to replicas/p99. The id-rows-per-item average feeding
`predicted_miss_cost` is a windowed EWMA of per-batch ratios (it was a
never-decaying lifetime counter), so a traffic-mix shift stops
haunting the miss-cost prediction forever.

Scaling is per-pool but capacity is fleet-wide: every grow request goes
through the shared CapacityBudget, so heterogeneous pools compete for
the same accelerators instead of each assuming it owns the cluster. In a
multi-cell federation the budget may itself be a cell-local slice of a
global cap (see autoscaler.py).

Several pools share one EventLoop by namespacing their events with
`event_key` — cells pass "<cell>/<pool>" so two cells can each run a
"baseline" pool on the federation's shared loop without colliding.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.serving.autoscaler import AutoScaler, CapacityBudget, ScalerConfig
from repro_torch.core.serving.cache import CacheConfig, EmbeddingCache, ResultCache
from repro_torch.core.serving.control import (
    BatchSizeController, ControlConfig, Ewma, OnlineLatencyModel,
)
from repro_torch.core.serving.events import EventLoop
from repro_torch.core.serving.metrics import SLOMonitor, TraceBuffer
from repro_torch.core.serving.rate_limiter import HybridRateLimiter, TierPolicy
from repro_torch.core.serving.replica import MissProfile, Replica, ReplicaSpec
from repro_torch.core.serving.shard import EmbeddingShardService
from repro_torch.core.serving.tracing import (
    BreakdownAccumulator, Tracer, service_phases,
)


@dataclasses.dataclass
class Request:
    rid: int
    t_arrive: float
    tier: str
    priority: bool = False
    cost: int = 1  # work items carried (e.g. candidates to score)
    stage: int = 0  # 0 = single-stage; 1, 2, ... = cascade stages
    home: str = ""  # home cell in a multi-cell federation ("" = no affinity)
    ids: Optional[Tuple[int, ...]] = None  # embedding ids touched (cache layer);
    # a tuple so the same value doubles as the ResultCache signature
    t_enqueue: float = 0.0  # when it entered the current pool
    timeline: Dict[str, float] = dataclasses.field(default_factory=dict)

    def stamp(self, event: str, t: float) -> None:
        # stage 0 stamps under its own "s0_" prefix so replaying one
        # arrival list through a baseline run and then a cascade run
        # (which shares the timeline dict, see cascade.admit) keeps both
        # runs' stamps instead of the cascade overwriting stage-1 keys
        self.timeline[f"s{self.stage}_{event}"] = t


@dataclasses.dataclass
class PoolConfig:
    max_batch: int = 64  # batch closes at this many requests...
    max_wait_s: float = 0.005  # ...or when the oldest has waited this long...
    max_batch_items: Optional[int] = None  # ...or at this many work items
    n_replicas: int = 2
    autoscale: bool = True
    priority_bypass: bool = True

    @classmethod
    def for_platform(cls, platform: str, **overrides) -> "PoolConfig":
        """Batching defaults matched to a platform class's curve shape
        (replica.py family constructors), so a heterogeneous fleet gets
        per-class batching out of the box: CPU-class pools close small
        batches fast (a steep per-item slope means wide batches only
        add latency — and a 512-item ranking batch routed there by a
        size-blind policy dispatches ALONE rather than holding
        pointwise traffic hostage); accelerator-class pools batch wide
        and wait longer to amortise their fixed cost. Unknown platforms
        get the generic defaults. Any field can be overridden."""
        defaults = {
            "cpu": dict(max_batch=16, max_batch_items=64, max_wait_s=0.002),
            "accelerator": dict(max_batch=64, max_batch_items=2048,
                                max_wait_s=0.010),
        }.get(platform, {})
        defaults.update(overrides)
        return cls(**defaults)


class ReplicaPool:
    def __init__(
        self,
        name: str,
        spec: ReplicaSpec,
        cfg: PoolConfig,
        loop: EventLoop,
        *,
        scaler_cfg: Optional[ScalerConfig] = None,
        budget: Optional[CapacityBudget] = None,
        on_complete: Optional[Callable[[float, Request, "ReplicaPool"], None]] = None,
        slo_s: Optional[float] = None,
        picker: Optional[Callable[["ReplicaPool", float], Replica]] = None,
        tiers: Optional[Dict[str, TierPolicy]] = None,
        event_key: Optional[str] = None,
        cache_cfg: Optional[CacheConfig] = None,
        control_cfg: Optional[ControlConfig] = None,
        l2_cache: Optional[EmbeddingCache] = None,
        shard: Optional[EmbeddingShardService] = None,
        cell: str = "",
        tracer: Optional[Tracer] = None,
    ):
        self.name = name
        # events are keyed by event_key, not name: a federation runs several
        # cells' same-named pools on one loop ("cell0/baseline" vs name
        # "baseline", which routers and reports keep seeing)
        self.event_key = event_key or name
        self.spec = spec
        self.cfg = cfg
        self.loop = loop
        self.scaler = AutoScaler(scaler_cfg or ScalerConfig(min_replicas=cfg.n_replicas))
        self.budget = budget
        self.on_complete = on_complete or (lambda now, req, pool: None)
        self.monitor = SLOMonitor(slo_s=slo_s)
        self.picker = picker or (lambda pool, now: min(pool.replicas, key=lambda r: r.load(now)))
        # pool-local admission: cost-weighted token draws, shed level driven
        # by THIS pool's SLO signal (scale_tick) — None admits everything
        self.limiter = HybridRateLimiter(tiers) if tiers is not None else None
        self.shed = 0
        # caching layer: a per-pool hot-ID embedding cache (misses pay
        # spec.embed_fetch_s each on top of the dense service time) and an
        # optional request-signature result cache for repeat queries
        self.embed_cache: Optional[EmbeddingCache] = None
        self.result_cache: Optional[ResultCache] = None
        if cache_cfg is not None:
            self.embed_cache = EmbeddingCache(cache_cfg.capacity_rows, cache_cfg.policy)
            if cache_cfg.result_capacity > 0:
                self.result_cache = ResultCache(
                    cache_cfg.result_capacity, cache_cfg.result_ttl_s
                )
        # shard tier: the cell-shared L2 (one EmbeddingCache for all pools
        # in this cell, engine-built) and the fleet's shard service; the
        # pool's own cache becomes the hierarchy's L1 and joins the shard's
        # invalidation fan-out (AFTER the L2 — the engine registers that
        # first, so updates propagate shard -> L2 -> L1)
        self.l2_cache = l2_cache
        self.shard = shard
        self.cell = cell
        if shard is not None and self.embed_cache is not None:
            shard.register_cache(self.embed_cache)
        # control plane (serving/control.py): online-corrected latency
        # curve + SLO-aware effective item cap, both opt-in
        self.control_cfg = control_cfg
        ewma_alpha = control_cfg.ewma_alpha if control_cfg is not None else 0.25
        self.model: Optional[OnlineLatencyModel] = None
        if control_cfg is not None and control_cfg.online_latency:
            self.model = OnlineLatencyModel(
                spec.latency, spec.embed_fetch_s, alpha=ewma_alpha)
        self.controller: Optional[BatchSizeController] = None
        if control_cfg is not None and control_cfg.adapt_batch:
            self.controller = BatchSizeController(
                control_cfg, initial=cfg.max_batch_items)
        # windowed id-rows-per-item average (per-batch ratios, EWMA): the
        # routers' predicted miss cost for a prospective batch, learned
        # from dispatched traffic and able to FORGET an old traffic mix
        self._rows_per_item = Ewma(ewma_alpha)
        # latency attribution (serving/tracing.py): the always-on stage
        # breakdown — every completion decomposes against its enqueue time,
        # so breakdown.count tracks monitor.completed — and the OPTIONAL
        # sampling tracer, which only observes (no summary reads it)
        self.breakdown = BreakdownAccumulator()
        self.tracer = tracer

        if budget is not None and budget.acquire(cfg.n_replicas) < cfg.n_replicas:
            raise ValueError(
                f"capacity budget exhausted bringing up pool {name!r} "
                f"({cfg.n_replicas} initial replicas, {budget.available} left)"
            )
        self.replicas: List[Replica] = [
            Replica(i, spec, ready_at=0.0) for i in range(cfg.n_replicas)
        ]
        self._registry: Dict[int, Replica] = {r.rid: r for r in self.replicas}
        self._rid = itertools.count(len(self.replicas))

        self.queue: List[Request] = []
        self.queued_cost = 0  # running sum of queue costs (O(1) router signal)
        self._batch_deadline: Optional[float] = None
        self.trace = TraceBuffer([
            "t", ("replicas", np.int64), ("queue", np.int64), "p99",
            "hit_rate", "max_batch_items", "latency_corr"
        ])

        loop.on(f"batch_timeout:{self.event_key}", self._handle_timeout)
        loop.on(f"batch_done:{self.event_key}", self._handle_done)

    # ---- routing signals ----
    def dense_latency(self, items: int) -> float:
        """Predicted dense service time at `items` work items: the
        online-corrected curve when the control plane is learning one,
        else the offline calibration — the ONE dense-latency lens every
        predictor (predicted_latency, CostModelRouter.estimate) looks
        through, so a drifted calibration stops misrouting as soon as
        observations arrive."""
        if self.model is not None:
            return self.model.dense(items)
        return self.spec.latency(items)

    def predicted_latency(self, now: float, cost: int = 1) -> float:
        """Router signal: wait for the freest replica + service time of the
        backlog this request would join (dense + predicted miss cost)."""
        ready = [r for r in self.replicas if r.ready_at <= now] or self.replicas
        wait = min(r.load(now) for r in ready)
        items = self.queued_cost + cost
        return wait + self.dense_latency(items) + self.predicted_miss_cost(items)

    def predicted_miss_cost(self, items: int) -> float:
        """Expected embedding-fetch seconds for a batch of `items` work
        items, decomposed the same three ways the service clock charges
        (L1 miss -> L2 hit -> shard local/remote): the pool's learned
        id-rows-per-item average (windowed EWMA of per-batch ratios)
        discounted by the live L1 hit-rate gives the rows reaching the
        L2; discounting by the live L2 hit-rate gives the rows reaching
        the shard tier, each paying the per-row fetch PLUS this cell's
        learned per-row inter-cell transit — so the cost-model router
        prefers cells whose L2 and local shards are warm. No cache =
        every row fetches; no shard = no transit leg. Zero until the
        pool has dispatched id-carrying traffic — cold pools compete on
        dense cost alone. The per-row fetch consults the online-
        corrected model when one is learning."""
        fetch = self.model.fetch_s if self.model is not None else self.spec.embed_fetch_s
        if self._rows_per_item.value is None:
            return 0.0
        rows = self._rows_per_item.value * items
        if self.embed_cache is not None:
            rows *= 1.0 - self.embed_cache.hit_rate
        if self.l2_cache is not None:
            rows *= 1.0 - self.l2_cache.hit_rate
        per_row = max(fetch, 0.0)
        if self.shard is not None:
            per_row += self.shard.predicted_transit_per_row(self.cell)
        return rows * per_row

    def hit_rate(self) -> float:
        return self.embed_cache.hit_rate if self.embed_cache is not None else 0.0

    def recent_p99(self, now: float) -> float:
        return self.monitor.percentiles(now)["p99"]

    # ---- admission / batching ----
    def submit(self, now: float, req: Request, *, force: bool = False) -> bool:
        """Admit (pool-local limiter, cost-weighted) and enqueue. Returns
        False when this pool's limiter sheds the request. `force=True`
        bypasses pool admission — cascade stage advancement uses it so work
        already paid for upstream is never dropped mid-chain."""
        # result-cache fast path: a repeat query whose signature is still
        # fresh completes immediately — no pool-local admission tokens, no
        # batching, no service (the fleet-global front-door limiter has
        # already been paid by this point). Mid-cascade (force) submissions
        # never shortcut: their upstream stage produced fresh scores to
        # rerank.
        if (
            self.result_cache is not None
            and not force
            and req.ids is not None
            # signature = (ids, cost): a pointwise probe and a 512-candidate
            # ranking request over the SAME ids are different computations
            # and must never share a cached result
            and self.result_cache.get(now, (req.ids, req.cost)) is not None
        ):
            req.t_enqueue = now
            req.stamp("enqueue", now)
            req.stamp("start", now)
            req.stamp("done", now)
            self.monitor.record(now, 0.0)
            # a cached repeat is a completion too: all-zero components,
            # so breakdown.count keeps tracking monitor.completed
            self.breakdown.observe(req, now, t_origin=req.t_enqueue,
                                   stages=[req.stage])
            self.on_complete(now, req, self)
            return True
        if (
            self.limiter is not None
            and not force
            and not self.limiter.admit(now, req.tier, cost=req.cost)
        ):
            self.shed += 1
            return False
        req.t_enqueue = now
        req.stamp("enqueue", now)
        if self.cfg.priority_bypass and req.priority:
            self._dispatch(now, [req])
            return True
        self.queue.append(req)
        self.queued_cost += req.cost
        if self._batch_full():
            self._flush(now)
        elif self._batch_deadline is None:
            self._arm(now + self.cfg.max_wait_s)
        return True

    def item_cap(self) -> Optional[int]:
        """The pool's EFFECTIVE max_batch_items: the BatchSizeController's
        live cap when SLO-aware batch sizing is on, else the static
        configured value (None = no item budget)."""
        if self.controller is not None:
            return self.controller.cap
        return self.cfg.max_batch_items

    def _batch_full(self) -> bool:
        cap = self.item_cap()
        return len(self.queue) >= self.cfg.max_batch or (
            cap is not None and self.queued_cost >= cap
        )

    def _arm(self, deadline: float) -> None:
        self._batch_deadline = deadline
        self.loop.push(deadline, f"batch_timeout:{self.event_key}")

    def _next_batch(self) -> List[Request]:
        """Pop the next batch off the queue head: up to max_batch requests
        AND (when item batching is on) max_batch_items work items. A single
        request larger than the item budget still dispatches — alone."""
        cap = self.item_cap()
        k = 0  # split index, then one slice-delete: O(queue) per batch
        items = 0
        while k < len(self.queue) and k < self.cfg.max_batch:
            nxt = self.queue[k]
            if k and cap is not None and items + nxt.cost > cap:
                break
            items += nxt.cost
            k += 1
        take = self.queue[:k]
        del self.queue[:k]
        self.queued_cost -= items
        return take

    def _dispatch(self, now: float, take: List[Request]) -> None:
        rep = self.picker(self, now)
        items = sum(r.cost for r in take)
        # miss hierarchy: each request's embedding ids run through the
        # pool's L1 in queue order (deterministic); L1 misses probe the
        # cell-shared L2; what both miss is fetched from the shard tier in
        # ONE batched call (one RTT per remote shard touched). A pool with
        # no cache sends every row down — the memory-bound baseline. With
        # no L2 and no shard, miss_rows stays the plain int of the
        # single-tier model, bit-identical to pre-shard behaviour.
        id_rows = 0
        below_l1: List = []  # rows the L1 missed, in access order
        for r in take:
            if r.ids:
                id_rows += len(r.ids)
                if self.embed_cache is not None:
                    below_l1.extend(self.embed_cache.lookup_misses(r.ids)[1])
                else:
                    below_l1.extend(r.ids)
        l2_hits = 0
        if self.l2_cache is not None and below_l1:
            l2_hits, below_l1 = self.l2_cache.lookup_misses(below_l1)
        if self.shard is not None:
            prof = self.shard.fetch(self.cell, below_l1)
            miss_rows: "int | MissProfile" = dataclasses.replace(
                prof, l2_hits=l2_hits)
        elif self.l2_cache is not None:
            miss_rows = MissProfile(l2_hits=l2_hits, local_rows=len(below_l1))
        else:
            miss_rows = len(below_l1)
        if items > 0:
            self._rows_per_item.update(id_rows / items)
        start, done = rep.start_batch(now, items, miss_rows)
        # service-phase boundaries for attribution/tracing: cumulative
        # stamps in the order service_time charges the clock (dense ->
        # local fetch -> remote fetch -> shard transit), clamped at the
        # batch's done so float dust from re-deriving the phases never
        # pushes a boundary past the completion stamp. Zero phases stamp
        # nothing (decompose falls back to the previous boundary).
        bounds = []
        t = start
        for key, dur in zip(
            ("compute_done", "fetch_local_done",
             "fetch_remote_done", "service_done"),
            service_phases(self.spec, items, miss_rows),
        ):
            if dur > 0.0:
                t = min(t + dur, done)
                bounds.append((key, t))
        for r in take:
            r.stamp("dispatch", now)
            r.stamp("start", start)
            for key, bt in bounds:
                r.stamp(key, bt)
        if self.tracer is not None and any(
                self.tracer.sampled(r.rid) for r in take):
            self.tracer.record_batch(self.cell, self.name, rep.rid,
                                     start, done, items, len(take))
        # the payload carries the batch observation (items, miss rows,
        # service start) so batch_done can feed the online latency model
        # the MEASURED service time without re-deriving the batch shape
        self.loop.push(done, f"batch_done:{self.event_key}",
                       (rep.rid, take, items, miss_rows, start))

    def _flush(self, now: float) -> None:
        while self.queue:
            self._dispatch(now, self._next_batch())
            if not self._batch_full():
                break
        if self.queue:
            # partial remainder waits for more arrivals, but only until the
            # OLDEST queued request has been waiting max_wait — re-arming
            # from `now` would let it wait up to 2x max_wait across closes
            self._arm(max(now, self.queue[0].t_enqueue + self.cfg.max_wait_s))
        else:
            self._batch_deadline = None

    def _handle_timeout(self, now: float, _payload) -> None:
        if self._batch_deadline is not None and now >= self._batch_deadline and self.queue:
            self._flush(now)

    def _handle_done(self, now: float, payload) -> None:
        rep_id, take, items, miss_rows, started = payload
        self._registry[rep_id].in_flight -= 1
        if self.model is not None:
            # one observation per completed batch: the measured service
            # seconds against the offline prediction for this batch shape
            self.model.observe(items, miss_rows, now - started)
        for r in take:
            r.stamp("done", now)
            self.monitor.record(now, now - r.t_enqueue)
            # stage-local attribution: the same decomposition the engine
            # applies end-to-end, with this stage's enqueue as origin —
            # the component sum reproduces the monitor's latency bit-exactly
            self.breakdown.observe(r, now, t_origin=r.t_enqueue,
                                   stages=[r.stage])
            if self.tracer is not None and self.tracer.sampled(r.rid):
                self.tracer.record_stage(r, self.cell, self.name, now)
            if self.result_cache is not None and r.stage == 0 and r.ids is not None:
                # freshly computed scores become servable repeats
                self.result_cache.put(now, (r.ids, r.cost))
            self.on_complete(now, r, self)

    # ---- scaling ----
    def utilisation(self, now: float, horizon: float) -> float:
        # booting replicas are excluded — counting them as busy makes the
        # scaler chase its own pending capacity (observed 25-replica
        # overshoot under cold starts)
        ready = [r for r in self.replicas if r.ready_at <= now]
        if not ready:
            return 1.0
        busy = sum(min(max(r.busy_until - now, 0.0), horizon) for r in ready)
        return busy / (horizon * len(ready))

    def scale_tick(self, now: float, tick_s: float) -> None:
        stats = self.monitor.percentiles(now)
        if self.limiter is not None and self.monitor.slo_s is not None:
            # pool-local shedding reacts to the pool's OWN stage latency,
            # not the fleet-wide end-to-end signal
            self.limiter.adapt(stats["p99"], self.monitor.slo_s)
        if self.controller is not None and self.monitor.slo_s is not None:
            # SLO-aware batch sizing: same per-pool windowed p99 signal
            # the limiter adapts from — breach narrows the effective item
            # cap (latency), headroom widens it (throughput)
            self.controller.tick(stats["p99"], self.monitor.slo_s)
        if self.cfg.autoscale:
            util = self.utilisation(now, tick_s)
            want = self.scaler.desired(now, len(self.replicas), util)
            grow = want - len(self.replicas)
            if grow > 0:
                if self.budget is not None:
                    grow = self.budget.acquire(grow)
                for _ in range(grow):
                    delay = self.scaler.take_start_delay(
                        self.spec.warm_start_s, self.spec.cold_start_s
                    )
                    rep = Replica(next(self._rid), self.spec, ready_at=now + delay)
                    self.replicas.append(rep)
                    self._registry[rep.rid] = rep
            elif grow < 0:
                # graceful scale-down: retire only drained replicas
                idle = [r for r in self.replicas if r.in_flight == 0 and r.busy_until <= now]
                while want < len(self.replicas) and len(self.replicas) > 1 and idle:
                    victim = idle.pop()
                    self.replicas.remove(victim)
                    self.scaler.replenish()
                    if self.budget is not None:
                        self.budget.release(1)
        self.trace.append(
            now, len(self.replicas), len(self.queue), stats["p99"],
            self.hit_rate(),
            # control-plane visibility: 0.0 = no item cap in force
            float(self.item_cap() or 0),
            self.model.correction if self.model is not None else 1.0,
        )

    # ---- reporting ----
    def cache_summary(self) -> Dict:
        """Cache counters in one flat dict (zeros when no cache is
        configured, so fleet rollups can sum unconditionally)."""
        out = {"policy": None, "hits": 0, "misses": 0, "hit_rate": 0.0,
               "evictions": 0, "result_hits": 0, "staleness": 0,
               "invalidated": 0}
        if self.embed_cache is not None:
            s = self.embed_cache.stats()
            out.update({k: s[k] for k in ("policy", "hits", "misses",
                                          "hit_rate", "evictions",
                                          "staleness", "invalidated")})
        if self.result_cache is not None:
            out["result_hits"] = self.result_cache.hits
        return out

    def control_summary(self) -> Dict:
        """Control-plane counters in one flat dict (identity values when
        no control is configured, so fleet rollups work unconditionally):
        the learned latency correction + sample count and the effective
        item cap (0 = uncapped). Tagged with the pool's platform class:
        corrections are learned PER POOL and a pool serves one platform,
        so the fleet rollup (metrics.fleet_control_rollup) can keep
        per-class means instead of blending a CPU fleet's drift into an
        accelerator fleet's."""
        return {
            "platform": self.spec.platform,
            "online_latency": self.model is not None,
            "latency_correction": (
                self.model.correction if self.model is not None else 1.0),
            "fetch_correction": (
                self.model.fetch_correction if self.model is not None else 1.0),
            "samples": self.model.samples if self.model is not None else 0,
            "adaptive_batch": self.controller is not None,
            "max_batch_items": int(self.item_cap() or 0),
        }

    def summary(self) -> Dict:
        tot = self.monitor.totals()
        return {
            "variant": self.spec.variant,
            "platform": self.spec.platform,
            "completed": self.monitor.completed,
            "shed": self.shed,
            "p50": tot["p50"],
            "p99": tot["p99"],
            "mean": tot["mean"],
            "slo_attainment": tot["attainment"],
            "final_replicas": len(self.replicas),
            "max_replicas": (
                int(self.trace.column("replicas").max())
                if len(self.trace) else len(self.replicas)
            ),
            "served_items": sum(r.served for r in self._registry.values()),
            "cache": self.cache_summary(),
            "control": self.control_summary(),
            "latency_breakdown": self.breakdown.summary(),
            "trace": self.trace.as_dict(),
        }
