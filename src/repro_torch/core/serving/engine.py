"""Heterogeneous multi-pool serving engine (paper §IV.B).

Post-refactor layering — the engine is an orchestrator, not a monolith:

    events.py    EventLoop        the discrete-event kernel
    replica.py   Replica/Spec     calibrated service times, start costs
    pool.py      ReplicaPool      per-variant batcher + AutoScaler + SLOMonitor
    router.py    Router policies  least-loaded / power-of-two / SLO-aware /
                                  cost-model (recommended) / size-aware
                                  (recommended on fleets mixing platform
                                  classes: pointwise -> CPU-class pools,
                                  ranking -> accelerator-class pools)
    cascade.py   CascadeDispatcher  light-filter -> heavy-rerank chaining
    cache.py     EmbeddingCache/ResultCache  per-pool hot-ID caching:
                                  misses pay embed_fetch_s, repeats can
                                  complete straight from the result cache
    shard.py     EmbeddingShardService  the sharded table under the
                                  caches: pool L1 misses probe a cell-
                                  shared L2 (CacheConfig.l2, built here),
                                  the rest fetch from home/remote shards;
                                  versioned updates invalidate downward
    control.py   OnlineLatencyModel/BatchSizeController  adaptive control
                                  plane: EWMA-corrected latency curve +
                                  SLO-aware per-pool batch sizing
    autoscaler.py CapacityBudget  fleet-wide replica cap shared by pools
    this file    ServingSystem    admission (rate limit) -> route -> pools
    federation.py Cell/FederatedSystem  cells (one system each) on one
                                  shared loop, cross-cell spillover

A ServingSystem normally owns its EventLoop and handles "arrive"/"scale"
events; pass `loop`/`event_ns` to embed it as one cell of a federation
instead — events are namespaced ("arrive:<cell>") and the federation
drives admission through try_submit()/inject() and start().

ServingSystem runs any number of Table-I variant pools on one event loop:
ARRIVAL -> admit (fleet-global tiered rate limit, then the target pool's
own cost-weighted limiter if configured) -> router (or cascade) picks the
pool -> pool batches by request count AND work items, picks the replica ->
BATCH_DONE records per-pool stage latency and, for cascades, chains the
next stage -> SCALE_TICK drives every pool's autoscaler against the shared
capacity budget and every pool-local limiter against its own SLO signal.

ElasticEngine remains as the single-pool convenience wrapper: the
constructor/run surface is unchanged for existing callers (launchers,
end-to-end examples), but the summary metrics were deliberately
redefined — p50/p99 are now full-run percentiles (previously the last
10s sliding window) and "throughput" counts only completions inside the
horizon (previously all completions, including post-horizon backlog
drain). Numbers are not comparable with pre-refactor runs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.serving.autoscaler import CapacityBudget, ScalerConfig
from repro_torch.core.serving.cache import CacheConfig, EmbeddingCache
from repro_torch.core.serving.cascade import CascadeConfig, CascadeDispatcher
from repro_torch.core.serving.shard import EmbeddingShardService
from repro_torch.core.serving.control import ControlConfig
from repro_torch.core.serving.events import EventLoop
from repro_torch.core.serving.metrics import (
    SLOMonitor, TraceBuffer, fleet_cache_rollup, fleet_control_rollup,
)
from repro_torch.core.serving.tracing import BreakdownAccumulator, Tracer
from repro_torch.core.serving.pool import PoolConfig, ReplicaPool, Request
from repro_torch.core.serving.rate_limiter import HybridRateLimiter, TierPolicy
from repro_torch.core.serving.replica import ReplicaSpec
from repro_torch.core.serving.router import LeastLoadedRouter, Router


@dataclasses.dataclass
class PoolSpec:
    """Everything needed to bring up one variant pool. `tiers` gives the
    pool its own cost-weighted rate limiter (sheds from the pool's own SLO
    signal); None leaves admission to the fleet-global limiter alone.
    `cache` gives the pool its own hot-ID embedding cache (and optionally
    a result cache) — see serving/cache.py; None means every embedding
    row the pool's traffic carries pays `ReplicaSpec.embed_fetch_s`.
    `control` opts the pool into the adaptive control plane — an online-
    corrected latency curve and/or SLO-aware batch sizing (see
    serving/control.py); None keeps the static pre-control behaviour."""

    spec: ReplicaSpec
    cfg: PoolConfig = dataclasses.field(default_factory=PoolConfig)
    scaler: Optional[ScalerConfig] = None
    tiers: Optional[Dict[str, TierPolicy]] = None
    cache: Optional[CacheConfig] = None
    control: Optional[ControlConfig] = None


@dataclasses.dataclass
class EngineConfig:
    """Single-pool knobs (pre-refactor API, used by ElasticEngine)."""

    max_batch: int = 64
    max_wait_s: float = 0.005
    max_batch_items: Optional[int] = None  # close batches by work items too
    slo_p99_s: float = 0.100
    scale_tick_s: float = 1.0
    n_replicas: int = 2
    autoscale: bool = True
    priority_bypass: bool = True


class ServingSystem:
    def __init__(
        self,
        pools: Dict[str, Union[PoolSpec, ReplicaSpec]],
        router: Optional[Router] = None,
        *,
        tiers: Optional[Dict[str, TierPolicy]] = None,
        slo_p99_s: float = 0.100,
        scale_tick_s: float = 1.0,
        capacity: Optional[Union[int, CapacityBudget]] = None,
        cascade: Optional[CascadeConfig] = None,
        adaptive_shedding: bool = True,
        loop: Optional[EventLoop] = None,
        event_ns: str = "",
        scheduler: str = "calendar",
        strict_events: bool = False,
        shard: Optional[EmbeddingShardService] = None,
        tracer: Optional[Tracer] = None,
    ):
        # `loop`/`event_ns` let a federation embed several systems (cells)
        # on ONE shared clock: each system's events — and its pools' — are
        # suffixed with the namespace so same-named pools never collide.
        # `scheduler` picks the pending-event store ("calendar" fast path
        # or the seed "heap"); `strict_events` makes unhandled event kinds
        # raise instead of being counted (both forwarded to EventLoop and
        # ignored when an existing `loop` is passed in).
        self.loop = (
            loop if loop is not None
            else EventLoop(scheduler=scheduler, strict=strict_events)
        )
        self.event_ns = event_ns
        self.router = router or LeastLoadedRouter()
        self.slo_p99_s = slo_p99_s
        self.scale_tick_s = scale_tick_s
        self.adaptive_shedding = adaptive_shedding
        self.limiter = HybridRateLimiter(
            tiers or {"tier0": TierPolicy(1e9, 1e9), "tier1": TierPolicy(1e9, 1e9)}
        )
        if isinstance(capacity, CapacityBudget):
            self.budget: Optional[CapacityBudget] = capacity
        else:
            self.budget = CapacityBudget(capacity) if capacity is not None else None
        self.monitor = SLOMonitor(slo_s=slo_p99_s)  # end-to-end latencies
        self.shard = shard
        # latency attribution (serving/tracing.py): always-on end-to-end
        # breakdown; the tracer is optional, shared with every pool, and
        # observes only — no simulation decision or summary reads it
        self.breakdown = BreakdownAccumulator()
        self.tracer = tracer
        specs = {
            name: ps if isinstance(ps, PoolSpec) else PoolSpec(ps)
            for name, ps in pools.items()
        }
        # cell-shared L2: ONE EmbeddingCache for the whole system (cell),
        # described by the pools' CacheConfig.l2 — every pool that sets it
        # must agree, because they are describing the same shared cache.
        # Registered with the shard service BEFORE any pool L1 so
        # invalidations propagate shard -> L2 -> L1.
        l2_cfgs = {
            (ps.cache.l2.capacity_rows, ps.cache.l2.policy)
            for ps in specs.values()
            if ps.cache is not None and ps.cache.l2 is not None
        }
        if len(l2_cfgs) > 1:
            raise ValueError(
                f"pools disagree on the shared L2 cache config: {sorted(l2_cfgs)}"
            )
        self.l2_cache: Optional[EmbeddingCache] = None
        if l2_cfgs:
            cap, policy = min(l2_cfgs)  # singleton; min() is order-free
            self.l2_cache = EmbeddingCache(cap, policy)
            if shard is not None:
                shard.register_cache(self.l2_cache)
        self.pools: Dict[str, ReplicaPool] = {}
        for name, ps in specs.items():
            has_l2 = ps.cache is not None and ps.cache.l2 is not None
            self.pools[name] = ReplicaPool(
                name, ps.spec, ps.cfg, self.loop,
                scaler_cfg=ps.scaler, budget=self.budget,
                on_complete=self._stage_complete, slo_s=slo_p99_s,
                picker=self.router.select_replica, tiers=ps.tiers,
                event_key=f"{event_ns}/{name}" if event_ns else name,
                cache_cfg=ps.cache, control_cfg=ps.control,
                l2_cache=self.l2_cache if has_l2 else None,
                shard=shard, cell=event_ns, tracer=tracer,
            )
        self.cascade = CascadeDispatcher(cascade) if cascade is not None else None
        if self.cascade is not None:
            for stage in (cascade.stage1, cascade.stage2):
                if stage not in self.pools:
                    raise KeyError(f"cascade stage pool {stage!r} not configured")
        # federation hooks: on_complete fires after a request fully finishes
        # here; spill_stage may claim a cascade's next stage for a remote
        # cell (returns True when it took the request)
        self.on_complete: Optional[Callable[[float, Request], None]] = None
        self.spill_stage: Optional[Callable[[float, Request, str], bool]] = None
        self._horizon = float("inf")
        self._completed_in_horizon = 0
        self._ran = False
        self.trace = TraceBuffer([
            "t", "p99", "qps", ("replicas", np.int64), ("queue", np.int64)
        ])
        self.loop.on(self._event("arrive"), self._handle_arrive)
        self.loop.on(self._event("scale"), self._handle_scale)
        if shard is not None:
            # online table updates for standalone systems: push/stream
            # ("shard_update", ids) events (namespaced when embedded; a
            # federation additionally handles the global "shard_update")
            self.loop.on(self._event("shard_update"), self._handle_shard_update)

    def _event(self, kind: str) -> str:
        return f"{kind}:{self.event_ns}" if self.event_ns else kind

    def _handle_shard_update(self, now: float, ids) -> None:
        self.shard.publish(ids)

    # ---- admission path (reusable: the arrive handler and federation
    # cells both go through it) ----
    def try_submit(self, now: float, req: Request) -> bool:
        """Admission WITHOUT arrival/rejection accounting: fleet limiter ->
        cascade redirect or router -> pool-local (cost-weighted) admission.
        Returns False when any admission layer sheds the request — the
        caller decides whether that is a rejection or a cross-cell spill."""
        if not self.limiter.admit(now, req.tier):
            return False
        if self.cascade is not None:
            req, pool = self.cascade.admit(req, self.pools)
        else:
            pool = self.router.select_pool(req, list(self.pools.values()), now)
        return pool.submit(now, req)

    def inject(self, now: float, req: Request) -> bool:
        """Full admission path with accounting: one arrival, admitted or
        rejected. Standalone systems run every request through this."""
        self.monitor.arrived += 1
        if self.try_submit(now, req):
            return True
        self.monitor.rejected += 1
        return False

    # ---- event handlers ----
    def _handle_arrive(self, now: float, req: Request) -> None:
        self.inject(now, req)

    def _stage_complete(self, now: float, req: Request, pool: ReplicaPool) -> None:
        if self.cascade is not None:
            nxt = self.cascade.advance(req, self.pools)
            if nxt is not None:
                # a cascade stays within its home cell unless the federation
                # claims the next stage for a remote cell (rerank spillover)
                if self.spill_stage is not None and self.spill_stage(now, req, nxt.name):
                    return
                # stage advancement bypasses pool admission: the cascade has
                # already spent stage-1 work on this request
                nxt.submit(now, req, force=True)
                return
        self.monitor.record(now, now - req.t_arrive)
        # end-to-end attribution at the same instant and from the same
        # floats the monitor records — the decomposition's total IS the
        # recorded latency, bit for bit
        self.breakdown.observe(req, now)
        if self.tracer is not None and self.tracer.sampled(req.rid):
            self.tracer.record_request(req, now,
                                       track=self.event_ns or "system")
        if now <= self._horizon:
            self._completed_in_horizon += 1
        if self.on_complete is not None:
            self.on_complete(now, req)

    def _handle_scale(self, now: float, _payload) -> None:
        if now > self._horizon:
            return
        stats = self.monitor.percentiles(now)
        if self.adaptive_shedding:
            self.limiter.adapt(stats["p99"], self.slo_p99_s)
        for pool in self.pools.values():
            pool.scale_tick(now, self.scale_tick_s)
        self.trace.append(
            now, stats["p99"], stats["qps"],
            sum(len(p.replicas) for p in self.pools.values()),
            sum(len(p.queue) for p in self.pools.values()),
        )
        if now + self.scale_tick_s <= self._horizon:
            self.loop.push(now + self.scale_tick_s, self._event("scale"))

    # ---- simulation ----
    def start(self, horizon: float) -> None:
        """Set the reporting horizon and arm the scale tick — marking the
        system as started, so a later run() raises. run() calls this; a
        federation embedding this system on a shared loop calls it
        directly (and later drains the loop itself)."""
        self._ran = True
        self._horizon = horizon
        # clamp the FIRST tick into the horizon: with horizon <
        # scale_tick_s the old `push(scale_tick_s)` fired past it, so
        # short runs got empty traces and the limiter/scaler/controller
        # loops never ran at all
        self.loop.push(min(self.scale_tick_s, horizon), self._event("scale"))

    def run(self, arrivals: List[Request], until: Optional[float] = None) -> Dict:
        if self._ran:
            raise RuntimeError(
                "this ServingSystem has already run once; monitors, queues and "
                "replica state accumulate across runs — build a fresh system"
            )
        if arrivals:
            # lazily merged stream instead of one heap tuple per arrival:
            # pending memory is O(1) per stream. The stable sort by
            # t_arrive reproduces the seed's (t, push-order) fire order
            # exactly, even for unsorted arrival lists, and stream events
            # beat queued events at equal timestamps just as the
            # arrival pushes (lowest sequence numbers) used to.
            ordered = sorted(arrivals, key=lambda r: r.t_arrive)
            self.loop.add_stream(
                self._event("arrive"), ((r.t_arrive, r) for r in ordered)
            )
        # `until is not None` (not truthiness): until=0.0 is a valid horizon
        self.start(until if until is not None else default_horizon(arrivals))
        self.loop.run()
        return self.summary()

    def summary(self) -> Dict:
        totals = self.monitor.totals()
        in_queue = sum(len(p.queue) for p in self.pools.values())
        cache = fleet_cache_rollup(p.cache_summary() for p in self.pools.values())
        if self.l2_cache is not None:
            # the shared L2 is cell-level state, not any one pool's: fold
            # its counters into the cell cache block under their own keys
            # (fleet_cache_rollup sums them upward through federated_rollup)
            s = self.l2_cache.stats()
            cache["l2_hits"] = s["hits"]
            cache["l2_misses"] = s["misses"]
            cache["l2_hit_rate"] = s["hit_rate"]
            cache["staleness"] += s["staleness"]
            cache["invalidated"] += s["invalidated"]
        if self.shard is not None:
            cache.update(self.shard.cell_stats(self.event_ns))
        return {
            "p50": totals["p50"],
            "p99": totals["p99"],
            "mean_latency": totals["mean"],
            "slo_attainment": totals["attainment"],
            "arrived": self.monitor.arrived,
            "completed": self.monitor.completed,
            "rejected": self.monitor.rejected,
            "in_queue": in_queue,
            # sustained rate: completions INSIDE the horizon — backlog that
            # only drains after traffic stops is not throughput the system
            # sustained (total completions stay in "completed")
            "completed_in_horizon": self._completed_in_horizon,
            "throughput": (
                self._completed_in_horizon / self._horizon if self._horizon > 0 else 0.0
            ),
            "final_replicas": sum(len(p.replicas) for p in self.pools.values()),
            "cache": cache,
            "control": fleet_control_rollup(
                p.control_summary() for p in self.pools.values()
            ),
            # this cell's OWN shard traffic (fleet-global shard state lives
            # in FederatedSystem.summary()["shard"])
            "shard": (
                self.shard.cell_stats(self.event_ns)
                if self.shard is not None else None
            ),
            # events that fired with no registered handler on this system's
            # loop (shared with every cell when federated); the seed kernel
            # dropped these silently
            "dropped_events": self.loop.dropped_events,
            "dropped_kinds": dict(self.loop.dropped_kinds),
            # end-to-end latency attribution (serving/tracing.py): per-
            # component seconds whose per-request sums equal the recorded
            # latencies exactly
            "latency_breakdown": self.breakdown.summary(),
            "trace": self.trace.as_dict(),
            "pools": {name: p.summary() for name, p in self.pools.items()},
        }


class ElasticEngine(ServingSystem):
    """Single-pool convenience wrapper: one variant, least-loaded routing —
    the pre-refactor surface, now a 10-line shim over ServingSystem.
    Simulation behavior matches the old engine; reported metrics follow
    the new full-run/in-horizon definitions (see module docstring)."""

    def __init__(
        self,
        spec: ReplicaSpec,
        cfg: Optional[EngineConfig] = None,
        tiers: Optional[Dict[str, TierPolicy]] = None,
        scaler_cfg: Optional[ScalerConfig] = None,
    ):
        cfg = cfg or EngineConfig()
        self.spec = spec
        self.cfg = cfg
        pool_cfg = PoolConfig(
            max_batch=cfg.max_batch, max_wait_s=cfg.max_wait_s,
            max_batch_items=cfg.max_batch_items,
            n_replicas=cfg.n_replicas, autoscale=cfg.autoscale,
            priority_bypass=cfg.priority_bypass,
        )
        super().__init__(
            {spec.variant: PoolSpec(spec, pool_cfg, scaler_cfg)},
            LeastLoadedRouter(),
            tiers=tiers, slo_p99_s=cfg.slo_p99_s, scale_tick_s=cfg.scale_tick_s,
            # the pre-refactor engine only ran limiter adaptation from the
            # scale tick, which existed only when autoscaling — mirror that
            adaptive_shedding=cfg.autoscale,
        )

    @property
    def replicas(self):
        (pool,) = self.pools.values()
        return pool.replicas


def default_horizon(arrivals: List[Request]) -> float:
    """Reporting horizon when the caller gives none: LATEST arrival plus
    a drain margin. Shared by ServingSystem.run and FederatedSystem.run
    so standalone and federated runs stay comparable. (This used to read
    `arrivals[-1]`, which silently under-reported the horizon for
    unsorted arrival lists.)"""
    if not arrivals:
        return 5.0
    return max(r.t_arrive for r in arrivals) + 5.0


def attach_zipf_ids(
    arrivals: List[Request],
    vocab: int,
    ids_per_request: int,
    *,
    alpha: float = 1.1,
    seed: int = 0,
    offset: int = 0,
    n_distinct: Optional[int] = None,
) -> List[Request]:
    """Give each arrival the embedding ids its lookups touch, drawn from
    `zipf_id_stream` (data/synthetic.py) — the workload the caching layer
    (serving/cache.py) exists for.

    Default: one long stream chopped into per-request tuples (every
    query distinct — exercises the EmbeddingCache alone). With
    `n_distinct`, arrivals instead draw (Zipf again, hot queries repeat
    often) from a pool of that many distinct query signatures, which is
    what makes the ResultCache earn its keep. `offset` shifts the id
    range so different cells can model DISJOINT hot sets (cell-resident
    users): a request spilled to a remote cell then misses that cell's
    cache cold. Idempotent on replay (same args reassign the same ids);
    mutates and returns `arrivals`."""
    from repro_torch.data.synthetic import zipf_id_stream

    n = ids_per_request * (n_distinct if n_distinct is not None else len(arrivals))
    stream = zipf_id_stream(n, vocab, alpha, seed=seed) + offset
    sigs = [
        tuple(stream[i * ids_per_request:(i + 1) * ids_per_request])
        for i in range(n // ids_per_request)
    ]
    if n_distinct is None:
        for req, sig in zip(arrivals, sigs):
            req.ids = sig
    else:
        pick = zipf_id_stream(len(arrivals), n_distinct, alpha, seed=seed + 1)
        for req, k in zip(arrivals, pick):
            req.ids = sigs[int(k)]
    return arrivals


def poisson_arrivals(
    rate_fn: Callable[[float], float],
    horizon: float,
    *,
    seed: int = 0,
    tiers: Tuple[str, ...] = ("tier0", "tier1"),
    priority_frac: float = 0.02,
    cost: int = 1,
    cost_mix: Optional[Sequence[Tuple[int, float]]] = None,
) -> List[Request]:
    """Inhomogeneous Poisson traffic via thinning; rate_fn(t) in QPS.
    `cost` is the per-request work size (candidates to score) — 1 for
    pointwise traffic, the candidate-set size for ranking traffic.
    `cost_mix` overrides `cost` with a weighted distribution of sizes,
    e.g. ((1, 0.9), (512, 0.1)) for 90% pointwise / 10% ranking traffic —
    deterministic under the same seed."""
    rng = np.random.default_rng(seed)
    if cost_mix is not None:
        mix_costs = np.asarray([c for c, _ in cost_mix], dtype=np.int64)
        mix_w = np.asarray([w for _, w in cost_mix], dtype=np.float64)
        mix_w = mix_w / mix_w.sum()
    peak = max(rate_fn(t) for t in np.linspace(0, horizon, 200)) + 1e-9
    out, t, rid = [], 0.0, 0
    while True:
        t += rng.exponential(1.0 / peak)
        if t >= horizon:
            break
        if rng.random() < rate_fn(t) / peak:
            out.append(
                Request(
                    rid, t,
                    tier=str(rng.choice(tiers)),
                    priority=bool(rng.random() < priority_frac),
                    cost=int(rng.choice(mix_costs, p=mix_w)) if cost_mix is not None else cost,
                )
            )
            rid += 1
    return out
