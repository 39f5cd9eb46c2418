"""Multi-cell serving federation: cross-cell routing + spillover.

One level above engine.py's ServingSystem (paper §IV.B taken to
datacenter scale, DeepRecSys arXiv 2001.02772): a `Cell` wraps ONE
ServingSystem — its own pools, router, cell-local CapacityBudget and
cell-local SLOMonitor — and a `FederatedSystem` routes arrivals across
cells over one shared EventLoop. The layering mirrors the pool layer
exactly one level up:

    Router picks the pool a request enters      (router.py,   intra-cell)
    CellPolicy picks the CELL a request enters  (this module, inter-cell)

Public API
    CellSpec          everything needed to bring up one cell
    Cell              the running cell: embedded ServingSystem + spill
                      accounting + read-only load signals for policies
    CellPolicy        base class; shipped policies in CELL_POLICIES:
                      sticky (home-cell), least_loaded, cost_model
    FederatedSystem   arrivals -> cell policy -> cell admission, with
                      cross-cell spillover; run() returns fleet metrics
    assign_homes      deterministic weighted home-cell assignment for an
                      arrival list (skewed per-cell traffic)

Spillover semantics: a request is offered to the cell its policy picked
(a policy that routes a homed request OFF its home cell pays the same
`rtt_s` hop in transit that its decision rule charged — homeless
requests originate at a global front door and hop free). When the entry
cell is past its SLO headroom (predicted latency above `spill_headroom *
slo`) or its admission sheds the request, the federation spills it to
the best remote cell with headroom — ONE hop, paying `rtt_s` seconds of
inter-cell transit before remote admission. A
cascade stays within its home cell, except the rerank stage: when the
home rerank pool is past headroom and a remote cell runs a same-named
pool that is predicted cheaper even after the RTT, the stage spills
(`submit(force=True)` — stage-1 work is never dropped) and the request's
stage timeline stamps survive the hop (`s1_*` from home, `s2_*` remote).

Accounting invariants (tests/test_serving.py pins these down):
  - fleet-wide conservation: injected == completed + rejected +
    in_flight, where in_flight counts cell queues AND inter-cell transit;
    after the loop drains, in_flight == 0;
  - spill attribution is separate from rejection: per cell, arrived ==
    completed + rejected + spilled_out once drained, and the fleet's
    spilled_out total equals its spilled_in total;
  - per-cell budgets are independent: one cell scaling up never spends
    another cell's CapacityBudget — unless an optional GLOBAL cap is set,
    which bounds the sum (autoscaler.py hierarchical budgets);
  - determinism: given one arrival list (homes assigned by seed), any
    cell topology replays bit-identically.

Units: all times in seconds on the shared loop clock; `rtt_s` is the
one-way inter-cell transfer penalty per hop — or pass `rtt`, a dict
keyed by (src, dst) cell-name pairs (RttMatrix: symmetric fallback, then
the scalar), and every hop — policy charge, spill transit, cascade-stage
spill — consults the pair's own value.

Cells may own DIFFERENT platform-class mixes (replica.py family
constructors): a CPU-only edge cell next to an accelerator-heavy core
cell is a normal topology, and the cell policies see that heterogeneous
capacity without any special casing — `Cell.predicted_latency` is the
cost-model estimate AT THE REQUEST'S COST, so an accelerator-only cell
quotes its high fixed cost to a pointwise probe and its flat curve to a
512-candidate ranking query, and spillover targets rank the same way.
A ranking query homed on a CPU-only cell therefore spills to
accelerator capacity as soon as its home quote exceeds the remote
quote plus the RTT. `Cell.platforms` (and the "platforms" summary key)
reports each cell's mix; per-class control corrections roll up
un-blended through `metrics.fleet_control_rollup`.

Control is cell-local too (serving/control.py via each pool's
PoolSpec.control): every cell's pools learn their own latency
corrections and adapt their own batch caps from their own SLO signals —
there is no fleet-wide controller to fight cell-local drift — and the
per-cell control summaries roll up through `federated_rollup` next to
the cache tallies.

Caches are cell-local (serving/cache.py via each pool's PoolSpec.cache):
a request spilled to a remote cell runs its ids through THAT cell's
caches, so with per-cell hot sets a spill pays cold misses remotely —
spillover trades queueing delay against cache locality, and the summary
shows both sides (per-cell hit rates + fleet cache rollup).

The embedding TABLE, by contrast, is fleet-global: pass
`shard=EmbeddingShardService(...)` (serving/shard.py) and every cell's
pools fetch their cache misses from the same sharded table — shards
homed in the serving cell are local, remote shards pay this
federation's per-pair RTT matrix (bound onto the shard service when it
was built without one). Online table updates arrive as
("shard_update", ids) events on the shared loop and propagate
invalidations shard -> cell L2 -> pool L1.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.serving.autoscaler import CapacityBudget
from repro_torch.core.serving.cascade import CascadeConfig
from repro_torch.core.serving.engine import PoolSpec, ServingSystem, default_horizon
from repro_torch.core.serving.events import EventLoop
from repro_torch.core.serving.metrics import (
    SLOMonitor, SpillStats, TraceBuffer, federated_rollup,
)
from repro_torch.core.serving.pool import Request
from repro_torch.core.serving.rate_limiter import TierPolicy
from repro_torch.core.serving.replica import ReplicaSpec
from repro_torch.core.serving.router import CostModelRouter, Router, make_router
# RttMatrix moved down to shard.py (the shard tier charges hops from the
# same matrix and sits below the federation); re-exported here so existing
# `from ...federation import RttMatrix` imports keep working
from repro_torch.core.serving.shard import EmbeddingShardService, RttMatrix


@dataclasses.dataclass
class CellSpec:
    """Everything needed to bring up one cell: its pools (same shapes
    engine.py takes), an intra-cell router, optional fleet tiers, an
    optional cell-local replica budget (`capacity`; parented to the
    federation's global cap when one is set) and an optional cascade."""

    pools: Dict[str, Union[PoolSpec, ReplicaSpec]]
    router: Optional[Router] = None
    tiers: Optional[Dict[str, TierPolicy]] = None
    capacity: Optional[int] = None
    cascade: Optional[CascadeConfig] = None
    slo_p99_s: float = 0.100
    adaptive_shedding: bool = True


class Cell:
    """One cell of the federation: a ServingSystem embedded on the shared
    loop (event namespace = cell name), plus spill accounting and the
    read-only load signals cell policies and the spillover logic use."""

    def __init__(self, name: str, spec: CellSpec, loop: EventLoop,
                 budget: Optional[CapacityBudget], scale_tick_s: float,
                 rtt: Optional[RttMatrix] = None,
                 shard: Optional[EmbeddingShardService] = None,
                 tracer=None):
        self.name = name
        # per-pair transfer time INTO this cell; policies charge it for
        # off-home candidates so the decision rule and the physical hop
        # (FederatedSystem._transit) always agree
        self._rtt = rtt if rtt is not None else RttMatrix(0.0)
        self.system = ServingSystem(
            spec.pools, spec.router, tiers=spec.tiers,
            slo_p99_s=spec.slo_p99_s, scale_tick_s=scale_tick_s,
            capacity=budget, cascade=spec.cascade,
            adaptive_shedding=spec.adaptive_shedding,
            loop=loop, event_ns=name, shard=shard, tracer=tracer,
        )
        self.spill = SpillStats()

    def rtt_from(self, src: str) -> float:
        """One-way transfer seconds from cell `src` into this cell (0 for
        itself and for homeless front-door arrivals)."""
        return self._rtt(src, self.name)

    @property
    def platforms(self) -> Tuple[str, ...]:
        """The platform classes this cell's pools draw from, sorted —
        cells may own different mixes (a CPU-only edge cell, an
        accelerator core cell), and policies price that heterogeneity
        through `predicted_latency` at the request's cost."""
        return tuple(sorted({p.spec.platform for p in self.system.pools.values()}))

    # ---- read-only signals for cell policies / spillover ----
    def predicted_latency(self, now: float, cost: int = 1) -> float:
        """Completion-time estimate for an arrival entering this cell
        (calibrated LatencyModel + live queue residuals — the same
        cost-model estimate the intra-cell router uses). For a plain cell
        the estimate is minimised over pools, because the router will pick
        the best one on admission; for a cascade cell the entry pool is
        FIXED (stage 1, at the full candidate cost), so an idle rerank
        pool must not make a saturated filter pool look like headroom."""
        if self.system.cascade is not None:
            cfg = self.system.cascade.cfg
            entry = self.system.pools[cfg.stage1]
            return CostModelRouter.estimate(entry, cfg.candidates, now)
        return min(
            CostModelRouter.estimate(p, cost, now)
            for p in self.system.pools.values()
        )

    def has_headroom(self, now: float, cost: int, headroom_s: float) -> bool:
        return self.predicted_latency(now, cost) <= headroom_s

    def summary(self) -> Dict:
        return {**self.system.summary(), "spill": self.spill.as_dict(),
                "platforms": list(self.platforms)}


# ---------------------------------------------------------------------------
# cell-level policies (the Router registry pattern, one level up)
# ---------------------------------------------------------------------------


class CellPolicy:
    name = "base"

    def select_cell(self, req: Request, cells: Sequence[Cell], now: float) -> Cell:
        raise NotImplementedError

    @staticmethod
    def _home_or_first(req: Request, cells: Sequence[Cell]) -> Cell:
        for c in cells:
            if c.name == req.home:
                return c
        # no affinity: deterministic round-robin by request id
        return cells[req.rid % len(cells)]


class StickyCellPolicy(CellPolicy):
    """Home-cell affinity: every request enters its home cell (user state,
    embedding caches live there); requests without a home round-robin by
    id. Load balance across cells comes only from spillover."""

    name = "sticky"

    def select_cell(self, req, cells, now):
        return self._home_or_first(req, cells)


class LeastLoadedCellPolicy(CellPolicy):
    """Global shortest-expected-delay across cells: the home cell competes
    at par, remote cells are charged the inter-cell RTT from the request's
    home (per-pair when the federation has an RTT matrix) — so traffic
    stays home until a remote cell is genuinely cheaper despite the hop."""

    name = "least_loaded"

    def select_cell(self, req, cells, now):
        home = req.home
        return min(
            cells,
            key=lambda c: c.predicted_latency(now, req.cost) + c.rtt_from(home),
        )


class CostModelCellPolicy(LeastLoadedCellPolicy):
    """Cost-model routing at cell level: per-cell calibrated latency +
    queue residuals (Cell.predicted_latency) + RTT for non-home cells.
    Inherits LeastLoadedCellPolicy's decision rule verbatim — registered
    under its own name so the estimate can grow cell-specific terms
    (egress bandwidth, per-cell power caps) without renaming policies."""

    name = "cost_model"


CELL_POLICIES: Dict[str, type] = {
    StickyCellPolicy.name: StickyCellPolicy,
    LeastLoadedCellPolicy.name: LeastLoadedCellPolicy,
    CostModelCellPolicy.name: CostModelCellPolicy,
}


def make_cell_policy(name: str, **kwargs) -> CellPolicy:
    return make_router(name, registry=CELL_POLICIES, **kwargs)


# ---------------------------------------------------------------------------
# the federation
# ---------------------------------------------------------------------------


class FederatedSystem:
    """Routes arrivals across cells on one shared EventLoop.

    `policy` picks the entry cell (name from CELL_POLICIES or a CellPolicy
    instance). With `spillover=True`, a request whose entry cell is past
    its SLO headroom — or whose admission sheds it — takes ONE hop to the
    best remote cell with headroom, paying `rtt_s` in transit. `capacity`
    is an optional GLOBAL replica cap: each cell's own budget becomes a
    child of it, so cells stay independent until the global cap binds."""

    def __init__(
        self,
        cells: Dict[str, CellSpec],
        policy: Union[str, CellPolicy] = "sticky",
        *,
        rtt_s: float = 0.005,
        rtt: Optional[Dict[Tuple[str, str], float]] = None,
        spillover: bool = True,
        spill_headroom: float = 0.8,
        capacity: Optional[int] = None,
        slo_p99_s: float = 0.100,
        scale_tick_s: float = 1.0,
        scheduler: str = "calendar",
        strict_events: bool = False,
        shard: Optional[EmbeddingShardService] = None,
        tracer=None,
    ):
        if not cells:
            raise ValueError("a federation needs at least one cell")
        # every cell shares this one loop, so the scheduler choice and
        # strict-mode policy are fleet-wide
        self.loop = EventLoop(scheduler=scheduler, strict=strict_events)
        self.policy = make_cell_policy(policy) if isinstance(policy, str) else policy
        self.tracer = tracer
        self.rtt_s = rtt_s
        self.rtt = RttMatrix(rtt_s, rtt)  # per-(src, dst) with scalar fallback
        self.shard = shard
        if shard is not None and shard.rtt is None:
            # shard fetches and spill hops charge the SAME per-pair matrix
            shard.rtt = self.rtt
        self.spillover = spillover
        self.spill_headroom = spill_headroom
        self.slo_p99_s = slo_p99_s
        self.scale_tick_s = scale_tick_s
        self.global_budget = CapacityBudget(capacity) if capacity is not None else None
        self.cells: Dict[str, Cell] = {}
        for name, spec in cells.items():
            if spec.capacity is not None:
                budget = CapacityBudget(spec.capacity, parent=self.global_budget)
            else:
                budget = self.global_budget  # share the global cap directly
            cell = Cell(name, spec, self.loop, budget, scale_tick_s,
                        rtt=self.rtt, shard=shard, tracer=tracer)
            cell.system.on_complete = self._request_done
            cell.system.spill_stage = (
                lambda now, req, pool_name, _cell=cell:
                self._maybe_spill_stage(now, req, _cell, pool_name)
            )
            self.cells[name] = cell
        self.monitor = SLOMonitor(slo_s=slo_p99_s)  # fleet end-to-end
        self.in_transit = 0
        self._horizon = float("inf")
        self._completed_in_horizon = 0
        self._ran = False
        self.trace = TraceBuffer([
            "t", "p99", "qps", ("spilled", np.int64), ("in_transit", np.int64)
        ])
        self.loop.on("arrive", self._handle_arrive)
        self.loop.on("route", self._handle_route)
        self.loop.on("spill", self._handle_spill)
        self.loop.on("spill_stage", self._handle_spill_stage)
        self.loop.on("scale", self._handle_scale)
        if shard is not None:
            # online table updates: push/stream ("shard_update", ids) onto
            # the shared loop; the publish propagates shard -> L2 -> L1
            self.loop.on("shard_update", self._handle_shard_update)

    def _handle_shard_update(self, now: float, ids) -> None:
        self.shard.publish(ids)

    # ---- spill decisions ----
    def _headroom_s(self, cell: Cell) -> float:
        return self.spill_headroom * cell.system.slo_p99_s

    def _transit(self, now: float, kind: str, payload, delay_s: float) -> None:
        """One inter-cell hop: the request is in flight for the pair's RTT
        before the delivery handler (which decrements in_transit) runs."""
        self.in_transit += 1
        self.loop.push(now + delay_s, kind, payload)

    def _spill_target(self, now: float, req: Request, from_cell: Cell) -> Optional[Cell]:
        """Best remote cell with SLO headroom, ranked by predicted latency
        plus the (src, dst) transit it would pay — with a per-pair RTT
        matrix a nearby cell beats an equally loaded far one. None keeps
        the request (and its fate) at `from_cell`. Deterministic: min over
        insertion order; the headroom filter looks at the cell's own
        predicted latency (the hop happens regardless of who pays it)."""
        scored = [
            (c, c.predicted_latency(now, req.cost))
            for c in self.cells.values() if c is not from_cell
        ]
        cands = [(c, pred + self.rtt(from_cell.name, c.name))
                 for c, pred in scored if pred <= self._headroom_s(c)]
        if not cands:
            return None
        return min(cands, key=lambda cp: cp[1])[0]

    def _spill(self, now: float, req: Request, from_cell: Cell, to_cell: Cell) -> None:
        from_cell.spill.spilled_out += 1
        self._transit(now, "spill", (req, to_cell.name),
                      self.rtt(from_cell.name, to_cell.name))

    def _offer(self, now: float, req: Request, cell: Cell, *, can_spill: bool) -> None:
        """One cell's shot at a request: proactive spill when the cell is
        past its headroom, else admission, else reactive spill, else a
        rejection (counted at the cell AND fleet-wide). Spilled requests
        arrive with can_spill=False — one hop, no ping-pong."""
        cell.system.monitor.arrived += 1
        if can_spill and self.spillover and not cell.has_headroom(
                now, req.cost, self._headroom_s(cell)):
            target = self._spill_target(now, req, cell)
            if target is not None:
                self._spill(now, req, cell, target)
                return
        if cell.system.try_submit(now, req):
            return
        if can_spill and self.spillover:
            target = self._spill_target(now, req, cell)
            if target is not None:
                self._spill(now, req, cell, target)
                return
        cell.system.monitor.rejected += 1
        self.monitor.rejected += 1

    def _maybe_spill_stage(self, now: float, req: Request, home: Cell,
                           pool_name: str) -> bool:
        """Cascade rerank spillover: claim the next stage for a remote cell
        when the home pool is past headroom and a remote same-named pool is
        predicted cheaper even after the RTT. Called by the home cell's
        engine; returning False keeps the stage home."""
        if not self.spillover:
            return False
        home_pool = home.system.pools[pool_name]
        home_pred = home_pool.predicted_latency(now, req.cost)
        if home_pred <= self._headroom_s(home):
            return False
        best, best_pred = None, home_pred
        for cell in self.cells.values():
            if cell is home or pool_name not in cell.system.pools:
                continue
            hop = self.rtt(home.name, cell.name)
            pred = cell.system.pools[pool_name].predicted_latency(now, req.cost)
            if pred + hop < best_pred:
                best, best_pred = cell, pred + hop
        if best is None:
            return False
        home.spill.spilled_out += 1
        home.spill.cascade_out += 1
        self._transit(now, "spill_stage", (req, best.name, pool_name),
                      self.rtt(home.name, best.name))
        return True

    # ---- event handlers ----
    def _handle_arrive(self, now: float, req: Request) -> None:
        self.monitor.arrived += 1
        cell = self.policy.select_cell(req, list(self.cells.values()), now)
        if req.home and cell.name != req.home:
            # the policy routed this arrival off its home cell: the hop is
            # physical, so it pays the same (home, dst) RTT the decision
            # rule charged (requests without a home originate at a global
            # front door — no hop to pay, matching the zero charge)
            self._transit(now, "route", (req, cell.name),
                          self.rtt(req.home, cell.name))
            return
        self._offer(now, req, cell, can_spill=True)

    def _handle_route(self, now: float, payload) -> None:
        req, target_name = payload
        self.in_transit -= 1
        self._offer(now, req, self.cells[target_name], can_spill=True)

    def _handle_spill(self, now: float, payload) -> None:
        req, target_name = payload
        self.in_transit -= 1
        cell = self.cells[target_name]
        cell.spill.spilled_in += 1
        self._offer(now, req, cell, can_spill=False)

    def _handle_spill_stage(self, now: float, payload) -> None:
        req, target_name, pool_name = payload
        self.in_transit -= 1
        cell = self.cells[target_name]
        cell.system.monitor.arrived += 1
        cell.spill.spilled_in += 1
        cell.spill.cascade_in += 1
        # force: stage-1 work is already spent; remote admission never
        # sheds a mid-cascade request
        cell.system.pools[pool_name].submit(now, req, force=True)

    def _request_done(self, now: float, req: Request) -> None:
        """Cell on_complete hook: fleet-wide end-to-end latency (includes
        any inter-cell RTT the request paid — latency is done - t_arrive)."""
        self.monitor.record(now, now - req.t_arrive)
        if now <= self._horizon:
            self._completed_in_horizon += 1

    def _handle_scale(self, now: float, _payload) -> None:
        if now > self._horizon:
            return
        stats = self.monitor.percentiles(now)
        self.trace.append(
            now, stats["p99"], stats["qps"],
            sum(c.spill.spilled_out for c in self.cells.values()),
            self.in_transit,
        )
        if now + self.scale_tick_s <= self._horizon:
            self.loop.push(now + self.scale_tick_s, "scale")

    # ---- simulation ----
    def run(self, arrivals: List[Request], until: Optional[float] = None) -> Dict:
        if self._ran:
            raise RuntimeError(
                "this FederatedSystem has already run once; cell monitors, "
                "queues and replica state accumulate — build a fresh one"
            )
        self._ran = True
        if arrivals:
            # lazy stream instead of one heap tuple per arrival (see
            # ServingSystem.run): the stable sort keeps the seed's
            # (t, push-order) fire order bit-exact
            ordered = sorted(arrivals, key=lambda r: r.t_arrive)
            self.loop.add_stream("arrive", ((r.t_arrive, r) for r in ordered))
        self._horizon = until if until is not None else default_horizon(arrivals)
        for cell in self.cells.values():
            # start() marks each embedded system as started, so calling
            # run() directly on a federation cell raises
            cell.system.start(self._horizon)
        # first fleet tick clamped into the horizon (engine.start does the
        # same for each cell): short runs still trace and adapt
        self.loop.push(min(self.scale_tick_s, self._horizon), "scale")
        self.loop.run()
        return self.summary()

    def summary(self) -> Dict:
        totals = self.monitor.totals()
        cells = {name: cell.summary() for name, cell in self.cells.items()}
        rollup = federated_rollup(cells)
        in_flight = rollup["in_queue"] + self.in_transit
        return {
            "p50": totals["p50"],
            "p99": totals["p99"],
            "mean_latency": totals["mean"],
            "slo_attainment": totals["attainment"],
            # conservation: injected == completed + rejected + in_flight,
            # fleet-wide, with spill transit counted as in-flight
            "injected": self.monitor.arrived,
            "completed": self.monitor.completed,
            "rejected": self.monitor.rejected,
            "in_flight": in_flight,
            "in_transit": self.in_transit,
            "spilled": rollup["spilled_out"],
            "spilled_in": rollup["spilled_in"],
            "cascade_spilled": rollup["cascade_out"],
            "completed_in_horizon": self._completed_in_horizon,
            "throughput": (
                self._completed_in_horizon / self._horizon
                if self._horizon > 0 else 0.0
            ),
            "final_replicas": rollup["final_replicas"],
            "dropped_events": self.loop.dropped_events,
            "dropped_kinds": dict(self.loop.dropped_kinds),
            # fleet-wide cache/shard tallies (summed across cells) so the
            # fleet scope exposes staleness the same way each cell does
            "cache": rollup["cache"],
            # fleet latency attribution: the cells' always-on breakdown
            # blocks rolled up (metrics.fleet_breakdown_rollup) — transit
            # here includes every inter-cell RTT spill hops paid
            "latency_breakdown": rollup["latency_breakdown"],
            "trace": self.trace.as_dict(),
            # fleet-global shard view (per-cell fetch splits live in each
            # cell's own summary["shard"] and in summary["cache"] rollups)
            "shard": self.shard.summary() if self.shard is not None else None,
            "cells": cells,
        }


def assign_homes(arrivals: Sequence[Request], weights: Dict[str, float],
                 *, seed: int = 0) -> List[Request]:
    """Assign each arrival a home cell by weighted draw — deterministic
    under the seed, and idempotent on replay (re-running over the same
    list reassigns the same homes). Skew the weights to model a hot cell:
    assign_homes(arr, {"us": 0.7, "eu": 0.2, "ap": 0.1})."""
    names = list(weights)
    w = np.asarray([weights[n] for n in names], dtype=np.float64)
    w = w / w.sum()
    rng = np.random.default_rng(seed)
    draws = rng.choice(len(names), size=len(arrivals), p=w)
    for req, idx in zip(arrivals, draws):
        req.home = names[int(idx)]
    return list(arrivals)
