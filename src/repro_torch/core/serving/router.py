"""Pluggable routing policies: a Router picks the pool a request enters
(at admission) and the replica a closed batch lands on (at dispatch).

Public API
    Router              base class: select_pool(req, pools, now) at
                        admission, select_replica(pool, now) at dispatch
    ROUTERS             name -> class registry (pool-level policies)
    make_router         instantiate by name; accepts an alternate
                        `registry` so higher routing layers (the
                        cell-level policies in federation.py) reuse the
                        same construction/error path

Invariants: all policies are deterministic given their constructor
arguments — the power-of-two sampler draws from its own seeded generator,
so two runs of the same trace through the same policy are bit-identical.
Policies only READ pool signals (`predicted_latency`, `dense_latency`,
`recent_p99`, `queue`, `queued_cost`, `replicas`, `predicted_miss_cost`,
`hit_rate`) — they never mutate pool state. All latency signals are in
seconds; `cost` is in work items. Dense-latency signals go through
`pool.dense_latency`, which serves the ONLINE-corrected curve when the
pool runs a control plane (serving/control.py) — routing decisions track
observed service times, not just the offline calibration.

DeepRecSys (arXiv 2001.02772) motivates the pool-level decision: with
heterogeneous variants live at once, WHERE a query lands matters as much
as how it is batched. CostModelRouter makes that decision from the
calibrated LatencyModels plus live queue state and is the recommended
policy; SLOAwareRouter's p99-threshold heuristic is kept for quality-
tiered head/tail splits. On fleets mixing PLATFORM classes
(`ReplicaSpec.cpu_like` / `.accelerator_like`), SizeAwareRouter is the
recommended policy: it first picks the platform class by QUERY SIZE
(small pointwise -> CPU-class, large ranking -> accelerator-class) and
only then load-balances by the cost-model estimate WITHIN that class —
transient backlog can no longer push a 512-candidate batch onto a
steep CPU curve or flood an accelerator's fixed cost with pointwise
probes. To add a policy: subclass Router, implement
select_pool (and optionally select_replica), and register it in ROUTERS.
The same Router/registry shape repeats one level up: federation.py's
CellPolicy picks the CELL a request enters, through this module's
make_router against its own CELL_POLICIES registry.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.serving.pool import ReplicaPool, Request
from repro_torch.core.serving.replica import Replica


class Router:
    name = "base"

    def select_pool(self, req: Request, pools: Sequence[ReplicaPool], now: float) -> ReplicaPool:
        raise NotImplementedError

    def select_replica(self, pool: ReplicaPool, now: float) -> Replica:
        return min(pool.replicas, key=lambda r: r.load(now))


class LeastLoadedRouter(Router):
    """Global shortest-expected-delay: scan every pool/replica."""

    name = "least_loaded"

    def select_pool(self, req, pools, now):
        return min(pools, key=lambda p: p.predicted_latency(now, req.cost))


class PowerOfTwoRouter(Router):
    """Power-of-two-choices: sample two candidates, take the less loaded.
    O(1) per decision instead of a full scan, with near-best balance
    (Mitzenmacher); the sampler is seeded so simulations stay reproducible."""

    name = "power_of_two"

    def __init__(self, seed: int = 0):
        self._rng = np.random.default_rng(seed)

    def _two(self, n: int) -> Tuple[int, int]:
        i, j = self._rng.choice(n, size=2, replace=False)
        return int(i), int(j)

    def select_pool(self, req, pools, now):
        if len(pools) == 1:
            return pools[0]
        i, j = self._two(len(pools))
        a, b = pools[i], pools[j]
        return a if a.predicted_latency(now, req.cost) <= b.predicted_latency(now, req.cost) else b

    def select_replica(self, pool, now):
        reps = pool.replicas
        if len(reps) == 1:
            return reps[0]
        i, j = self._two(len(reps))
        return reps[i] if reps[i].load(now) <= reps[j].load(now) else reps[j]


class CostModelRouter(Router):
    """Cost-model policy (the recommended default for heterogeneous
    fleets): estimate each pool's completion time for THIS request from
    its calibrated LatencyModel plus live queue state, take the cheapest.

    The estimate charges two terms: (1) residual work already executing,
    amortised over the pool's ready replicas — the whole pool drains its
    committed work in parallel, so total backlog / n is the expected slot
    wait; (2) the service time of the batch this request would join
    (queued-but-unbatched items + its own cost) at the pool's calibrated
    rate. Unlike SLOAwareRouter's p99-threshold heuristic this is
    threshold-free and cost-sensitive: a 512-candidate ranking query
    naturally prefers the pool whose latency curve is flattest at large
    batch, while pointwise traffic spreads by live load. Deterministic —
    no RNG, no thresholds to tune."""

    name = "cost_model"

    def select_pool(self, req, pools, now):
        return min(pools, key=lambda p: self.estimate(p, req.cost, now))

    @staticmethod
    def estimate(pool: ReplicaPool, cost: int, now: float) -> float:
        """slot wait + dense service of the joined batch + predicted
        embedding-miss cost at the pool's LIVE hit-rates — a warm cache
        makes a pool genuinely cheaper than an identical cold one, and
        the router sees it (caching layer, serving/cache.py). With the
        shard tier the miss term carries the same three-way split the
        service clock charges (L1 miss -> shared-L2 hit -> local/remote
        shard fetch with learned per-row transit; see
        `ReplicaPool.predicted_miss_cost`), so routing prefers cells
        whose L2 and local shards are warm. The dense term goes through
        `pool.dense_latency`: with a control plane (serving/control.py)
        that is the ONLINE-corrected curve, so a mis-calibrated or
        drifted spec stops misrouting as soon as observed service times
        disagree with it — and the per-row fetch consults the fetch
        correction the same way."""
        ready = [r for r in pool.replicas if r.ready_at <= now] or pool.replicas
        slot_wait = sum(r.residual(now) for r in ready) / len(ready)
        items = pool.queued_cost + cost
        return slot_wait + pool.dense_latency(items) + pool.predicted_miss_cost(items)


class SizeAwareRouter(CostModelRouter):
    """Query-size-aware routing over heterogeneous platform classes
    (DeepRecSys): decide WHICH class serves this query size, then
    load-balance within the class by the cost-model estimate.

    The plain cost-model estimate is size-sensitive but backlog-coupled:
    under load, a momentarily shorter accelerator queue pulls pointwise
    traffic onto the accelerator's high fixed cost, and an accelerator
    backlog pushes ranking batches onto the steep CPU curve — one
    512-item batch on a CPU-class pool then eats hundreds of
    milliseconds of capacity, the CPU queue explodes, pointwise floods
    the accelerators, and the specialisation collapses in both
    directions. Enforcing class affinity first is DeepRecSys's fix, and
    is what the asserted bench_serving experiment-9 win measures.

    The class decision per query: with an explicit `size_threshold`,
    cost >= threshold prefers accelerator-class pools. Without one (the
    default), the query prefers whichever class serves a batch of ITS
    size cheaper on an idle replica — `pool.dense_latency`, i.e. the
    ONLINE-corrected curve when a control plane is learning one, so the
    split point tracks drift. Pools of other platforms ("generic")
    never join a preferred class; fleets missing either class fall back
    to plain cost-model routing over all pools. Deterministic — no RNG,
    and threshold-free by default."""

    name = "size_aware"

    def __init__(self, size_threshold: Optional[int] = None):
        self.size_threshold = size_threshold

    def select_pool(self, req, pools, now):
        cpu = [p for p in pools if p.spec.platform == "cpu"]
        acc = [p for p in pools if p.spec.platform == "accelerator"]
        if not cpu or not acc:
            return super().select_pool(req, pools, now)
        if self.size_threshold is not None:
            preferred = acc if req.cost >= self.size_threshold else cpu
        else:
            idle_cpu = min(p.dense_latency(req.cost) for p in cpu)
            idle_acc = min(p.dense_latency(req.cost) for p in acc)
            preferred = acc if idle_acc <= idle_cpu else cpu
        return min(preferred, key=lambda p: self.estimate(p, req.cost, now))


class SizeBlindCostModelRouter(CostModelRouter):
    """The DeepRecSys ablation SizeAwareRouter is measured against:
    identical cost-model machinery, but the router does NOT see
    per-query size at admission — every arrival is priced at the
    pointwise unit (cost 1), the way a front door that learns the
    candidate count only after retrieval has to route. On a
    heterogeneous fleet this sends ranking batches to whichever pool
    quotes the cheapest POINTWISE estimate — usually the low-fixed-cost
    CPU class, where one 512-item batch then burns hundreds of
    milliseconds of steep-curve capacity — which is precisely the
    failure query-size awareness exists to prevent (bench_serving
    experiment 9 measures the gap). Dispatch-side batching still sees
    true costs; only the ADMISSION decision is size-oblivious."""

    name = "cost_model_blind"

    def select_pool(self, req, pools, now):
        return min(pools, key=lambda p: self.estimate(p, 1, now))


class SLOAwareRouter(Router):
    """Latency-aware policy for heterogeneous pools: among pools predicted
    to meet the SLO (and not currently breaching it), send head traffic
    (priority requests) to the highest-quality variant and everything else
    to the cheapest; when no pool can meet the SLO, fall back to the global
    shortest expected delay to limit the damage."""

    name = "slo_aware"

    def __init__(self, slo_p99_s: float = 0.1, quality_order: Sequence[str] = ()):
        self.slo_p99_s = slo_p99_s
        self.quality_order = tuple(quality_order)  # pool names, best model first

    def select_pool(self, req, pools, now):
        meeting = [
            p for p in pools
            if p.predicted_latency(now, req.cost) <= self.slo_p99_s
            and p.recent_p99(now) <= self.slo_p99_s
        ]
        if not meeting:
            return min(pools, key=lambda p: p.predicted_latency(now, req.cost))
        if req.priority and self.quality_order:
            by_name = {p.name: p for p in meeting}
            for name in self.quality_order:
                if name in by_name:
                    return by_name[name]
        return min(meeting, key=lambda p: p.dense_latency(req.cost))


ROUTERS: Dict[str, type] = {
    LeastLoadedRouter.name: LeastLoadedRouter,
    PowerOfTwoRouter.name: PowerOfTwoRouter,
    SLOAwareRouter.name: SLOAwareRouter,
    CostModelRouter.name: CostModelRouter,
    SizeAwareRouter.name: SizeAwareRouter,
    SizeBlindCostModelRouter.name: SizeBlindCostModelRouter,
}


def make_router(name: str, registry: Optional[Dict[str, type]] = None, **kwargs):
    """Instantiate a policy by registry name. The default registry is the
    pool-level ROUTERS; federation.py passes its CELL_POLICIES so cell-level
    policies share the same construction and error path."""
    registry = ROUTERS if registry is None else registry
    try:
        return registry[name](**kwargs)
    except KeyError:
        raise KeyError(f"unknown router policy {name!r}; have {sorted(registry)}") from None
