"""Request-level tracing + latency attribution for the serving stack.

Two independent mechanisms live here, deliberately decoupled:

1.  **Attribution (always on, O(1) memory).** Every completed request
    decomposes into named latency components whose left-to-right float
    sum equals its end-to-end latency BIT-EXACTLY — an invariant, not an
    estimate (`decompose`, property-tested in
    tests/test_serving_properties.py). `BreakdownAccumulator` aggregates
    the components into the `latency_breakdown` blocks that pool, cell
    and fleet summaries expose (fleet level via
    `metrics.fleet_breakdown_rollup`).

2.  **Tracing (opt-in, sampled, bounded).** A `Tracer` records a span
    tree for a deterministic 1-in-N sample of requests — queue wait,
    replica wait, service sub-phases, inter-cell transit, per-batch
    replica occupancy — in columnar `TraceBuffer` storage, exported as
    Chrome trace-event JSON (`Tracer.to_chrome_trace()`, loadable in
    Perfetto / chrome://tracing). The tracer only ever OBSERVES: it owns
    no RNG, mutates no request, and feeds no summary, so enabling it
    leaves every summary bit-identical to an untraced run (also
    property-tested).

Component taxonomy (docs/observability.md; summed across cascade stages):

    queue_wait        enqueue -> batch close (waiting for the batch to fill
                      or its deadline to fire)
    replica_wait      batch close -> service start (target replica busy /
                      still booting)
    dense_compute     the batch's dense forward pass (calibrated curve at
                      the batch's work items; the drifted curve when the
                      control plane models drift)
    embed_fetch_local rows fetched from shards homed in the serving cell
                      (and, pre-shard, every modelled row fetch)
    embed_fetch_remote rows fetched from remote-cell shards
    shard_transit     the batched inter-cell RTT those remote fetches paid
    transit           everything between stages: front-door routing hops,
                      cross-cell spill RTT, cascade hand-offs — computed
                      as the residual `total - sum(above)`, which is what
                      those gaps are mathematically
    closure           sub-ULP rounding closure (see below), ~1e-16 of the
                      total; kept separate so `transit` stays physically
                      meaningful

Exactness: stamp differences do not telescope bit-exactly in IEEE-754,
and a single residual term provably cannot always close the sum (with
round-ties-to-even an odd-mantissa total can be unreachable from
`fl(acc + r)` for EVERY float r). The two-term closure always can:
`transit = fl(total - acc)` leaves `acc2 = fl(acc + transit)` within a
few ULPs of `total`, so Sterbenz's lemma makes `closure = total - acc2`
EXACT and `fl(acc2 + closure) == total` unconditionally.

Span model (Chrome trace-event JSON): one *process* per cell (pid), one
*thread* per pool plus one per replica (tid). Per-batch replica
occupancy is emitted as synchronous B/E pairs on the replica's thread
(replicas serialize batches, so the pairs nest trivially); per-request
spans — root, per-stage wait/service phases, inter-stage transit — are
async "b"/"e" pairs keyed by the request id, which Perfetto renders as
a per-request waterfall without requiring non-overlapping tracks.
"""
from __future__ import annotations

import bisect
import dataclasses
from typing import TYPE_CHECKING, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.serving.metrics import TraceBuffer

if TYPE_CHECKING:  # pool imports tracing at runtime; type-only here
    from repro_torch.core.serving.pool import Request
    from repro_torch.core.serving.replica import MissRows, ReplicaSpec

# The ordered taxonomy. `transit` and `closure` MUST stay last (in this
# order): they are the residual and the sub-ULP closure term that make
# the left-to-right sum land exactly on the end-to-end latency.
COMPONENTS: Tuple[str, ...] = (
    "queue_wait",
    "replica_wait",
    "dense_compute",
    "embed_fetch_local",
    "embed_fetch_remote",
    "shard_transit",
    "transit",
    "closure",
)

# log-spaced histogram edges (seconds) shared by every breakdown
# histogram — fixed so Prometheus series from different runs line up
HISTOGRAM_BUCKETS_S: Tuple[float, ...] = (
    1e-4, 2.5e-4, 5e-4, 1e-3, 2.5e-3, 5e-3, 1e-2, 2.5e-2, 5e-2,
    1e-1, 2.5e-1, 5e-1, 1.0, 2.5, 5.0, 10.0,
)


def service_phases(spec: "ReplicaSpec", items: int,
                   miss_rows: "MissRows") -> Tuple[float, float, float, float]:
    """Decompose one batch's service duration into its modelled phases
    (dense_s, fetch_local_s, fetch_remote_s, transit_s) using the same
    curves `ReplicaSpec.service_time` charges the clock with — the TRUE
    (drifted) curve when one is set, so attribution explains the latency
    that actually happened, not the calibration's opinion of it. Pure:
    reads the spec, touches nothing. The phase sum may differ from
    `service_time` by float dust; `decompose`'s residual absorbs it."""
    dense = spec.true_latency if spec.true_latency is not None else spec.latency
    fetch = (
        spec.true_embed_fetch_s
        if spec.true_embed_fetch_s is not None
        else spec.embed_fetch_s
    )
    from repro_torch.core.serving.replica import MissProfile  # local: avoid cycle

    if isinstance(miss_rows, MissProfile):
        return (
            dense(items),
            miss_rows.local_rows * fetch,
            miss_rows.remote_rows * fetch,
            miss_rows.transit_s,
        )
    return dense(items), miss_rows * fetch, 0.0, 0.0


def _stage_path(req: "Request") -> List[int]:
    """The cascade stages THIS run's request actually traversed. Timeline
    dicts are shared across replayed runs (cascade.admit clones but keeps
    the dict), so stale stamps from a previous baseline run may coexist —
    the request's final stage, not the union of keys, names the path."""
    if req.stage <= 0:
        return [0]
    return [k for k in range(1, req.stage + 1)
            if f"s{k}_enqueue" in req.timeline]


def stage_components(timeline: Dict[str, float], stage: int,
                     done: float) -> Dict[str, float]:
    """The in-pool components of ONE stage, each a difference of
    consecutive timeline stamps (pool.py writes them in `_dispatch`).
    Missing boundary stamps fall back to the previous boundary — a
    result-cache fast path stamps only enqueue/start/done and correctly
    contributes zeros everywhere."""
    enq = timeline[f"s{stage}_enqueue"]
    start = timeline.get(f"s{stage}_start", enq)
    dispatch = timeline.get(f"s{stage}_dispatch", start)
    b_dense = timeline.get(f"s{stage}_compute_done", start)
    b_local = timeline.get(f"s{stage}_fetch_local_done", b_dense)
    b_remote = timeline.get(f"s{stage}_fetch_remote_done", b_local)
    b_service = timeline.get(f"s{stage}_service_done", b_remote)
    del done  # the stage's own `done` stamp is absorbed by the residual
    return {
        "queue_wait": dispatch - enq,
        "replica_wait": start - dispatch,
        "dense_compute": b_dense - start,
        "embed_fetch_local": b_local - b_dense,
        "embed_fetch_remote": b_remote - b_local,
        "shard_transit": b_service - b_remote,
    }


def decompose(req: "Request", done: float, *,
              t_origin: Optional[float] = None,
              stages: Optional[Sequence[int]] = None) -> Dict[str, float]:
    """Attribute one completed request's latency to the component
    taxonomy. `done` is the completion time (the event-loop `now` the
    final `done` stamp carries); `t_origin` overrides the latency origin
    (default `req.t_arrive` for end-to-end; a pool passes the stage's
    `t_enqueue` for its stage-local view) and `stages` restricts which
    cascade stages contribute (default: the full path this run took —
    a pool passes `[req.stage]` so its stage view never double-counts an
    upstream stage against a stage-local total).

    INVARIANT (property-tested): summing the returned values in
    `COMPONENTS` order with plain float additions reproduces
    `done - t_origin` — the exact float the SLO monitors recorded —
    bit-exactly. All components are non-negative except `transit`
    (>= 0 up to float dust) and `closure` (always within a few ULPs of
    the total)."""
    origin = req.t_arrive if t_origin is None else t_origin
    total = done - origin
    comps = {name: 0.0 for name in COMPONENTS}
    for stage in (_stage_path(req) if stages is None else stages):
        if f"s{stage}_enqueue" not in req.timeline:
            continue
        for name, val in stage_components(req.timeline, stage, done).items():
            # max(): a stamp fallback chain can produce a -0.0-style
            # artifact but never a real negative (stamps are monotone)
            comps[name] += max(val, 0.0)
    acc = 0.0
    for name in COMPONENTS[:-2]:
        acc += comps[name]
    # two-term closure (module docstring): residual transit, then the
    # Sterbenz-exact sub-ULP term
    comps["transit"] = total - acc
    acc2 = acc + comps["transit"]
    comps["closure"] = total - acc2
    return comps


class BreakdownAccumulator:
    """O(1)-memory aggregate of per-request decompositions: per-component
    sums, per-component log-bucket histograms (Prometheus-ready), request
    count and the summed end-to-end latency. Deterministic: state is a
    pure fold over completion order, so replays produce bit-identical
    blocks whether or not a Tracer is attached."""

    __slots__ = ("count", "end_to_end_s", "sums", "_hist")

    def __init__(self) -> None:
        self.count = 0
        self.end_to_end_s = 0.0
        self.sums = {name: 0.0 for name in COMPONENTS}
        # one (len(buckets)+1)-cell counter row per component; the last
        # cell is the +Inf overflow bucket
        self._hist = {
            name: [0] * (len(HISTOGRAM_BUCKETS_S) + 1) for name in COMPONENTS
        }

    def add(self, comps: Dict[str, float], total: float) -> None:
        self.count += 1
        self.end_to_end_s += total
        for name in COMPONENTS:
            v = comps[name]
            self.sums[name] += v
            self._hist[name][bisect.bisect_left(HISTOGRAM_BUCKETS_S, v)] += 1

    def observe(self, req: "Request", done: float, *,
                t_origin: Optional[float] = None,
                stages: Optional[Sequence[int]] = None) -> None:
        """Decompose + add in one call (the pool/engine completion hook)."""
        origin = req.t_arrive if t_origin is None else t_origin
        self.add(decompose(req, done, t_origin=origin, stages=stages),
                 done - origin)

    def summary(self) -> Dict:
        """The `latency_breakdown` block summaries embed: per-component
        seconds + share of the summed end-to-end latency, cumulative
        histogram counts (le-style, Prometheus semantics), and the
        invariant's aggregate echo (`component_sum_s` tracks
        `end_to_end_s` up to float-reassociation dust — the bit-exact
        claim is per-request, which the property suite asserts)."""
        comp_sum = sum(self.sums.values())
        denom = self.end_to_end_s if self.end_to_end_s > 0 else 1.0
        cumulative = {}
        for name in COMPONENTS:
            counts = self._hist[name]
            cum, out = 0, []
            for c in counts:
                cum += c
                out.append(cum)
            cumulative[name] = out
        return {
            "count": self.count,
            "end_to_end_s": self.end_to_end_s,
            "component_sum_s": comp_sum,
            "components": dict(self.sums),
            "shares": {n: self.sums[n] / denom for n in COMPONENTS},
            "histogram_buckets_s": list(HISTOGRAM_BUCKETS_S),
            "histograms": cumulative,
        }


# ---------------------------------------------------------------------------
# the sampling tracer
# ---------------------------------------------------------------------------

# span kinds (interned as ints in the columnar store)
_SPAN_KINDS: Tuple[str, ...] = (
    "request", "queue_wait", "replica_wait", "service", "dense_compute",
    "embed_fetch_local", "embed_fetch_remote", "shard_transit", "transit",
    "batch",
)
_KIND_ID = {name: i for i, name in enumerate(_SPAN_KINDS)}
# which kinds export as synchronous B/E pairs on their own thread track
# (everything else is an async per-request "b"/"e" pair keyed by rid)
_SYNC_KINDS = frozenset({"batch"})


class Tracer:
    """Deterministic sampling span recorder.

    Sampling is a pure hash of the request id (`sample_every=1` keeps
    every request): no RNG is consumed, no request is mutated, and no
    simulation decision ever consults the tracer — the property suite
    asserts summaries are bit-identical with the tracer on or off.
    Storage is bounded: past `max_spans` recorded spans, new spans are
    counted in `dropped_spans` and discarded (the trace stays loadable,
    the accounting stays honest)."""

    def __init__(self, *, sample_every: int = 16, seed: int = 0,
                 max_spans: int = 200_000) -> None:
        if sample_every < 1:
            raise ValueError(f"sample_every must be >= 1, got {sample_every}")
        self.sample_every = sample_every
        self.seed = seed
        self.max_spans = max_spans
        self.dropped_spans = 0
        self._tracks: Dict[str, int] = {}
        self._spans = TraceBuffer([
            ("kind", np.int64), ("track", np.int64), ("rid", np.int64),
            ("stage", np.int64), "t0", "t1", ("items", np.int64),
        ])

    # ---- sampling ----
    def sampled(self, rid: int) -> bool:
        """Pure decision: Fibonacci-style integer hash of (rid, seed).
        The same rid samples identically in every run with the same
        tracer config — sampled replays are themselves replayable."""
        if self.sample_every == 1:
            return True
        h = (rid * 0x9E3779B1 + self.seed * 0x85EBCA6B) & 0xFFFFFFFF
        return h % self.sample_every == 0

    # ---- recording ----
    def _track_id(self, track: str) -> int:
        tid = self._tracks.get(track)
        if tid is None:
            tid = len(self._tracks)
            self._tracks[track] = tid
        return tid

    def _push(self, kind: str, track: str, rid: int, stage: int,
              t0: float, t1: float, items: int = 0) -> None:
        if len(self._spans) >= self.max_spans:
            self.dropped_spans += 1
            return
        self._spans.append(_KIND_ID[kind], self._track_id(track),
                           rid, stage, t0, t1, items)

    def record_batch(self, cell: str, pool: str, replica: int,
                     t0: float, t1: float, items: int, n_requests: int) -> None:
        """One batch's replica occupancy [service start, done) — the
        pool calls this from `_dispatch` when the batch carries at least
        one sampled request. Exported as a B/E pair on the replica's own
        thread (replicas serialize batches, so pairs nest trivially)."""
        track = f"{cell or 'system'}/{pool}/replica{replica}"
        self._push("batch", track, n_requests, 0, t0, t1, items)

    def record_stage(self, req: "Request", cell: str, pool: str,
                     done: float) -> None:
        """One sampled request's in-pool stage spans: queue wait, replica
        wait, and the service sub-phases, read off the timeline stamps
        `ReplicaPool._dispatch` wrote. Called from the pool's batch-done
        handler (the fast-path result-cache completion records nothing:
        its stage is a point, not a span)."""
        track = f"{cell or 'system'}/{pool}"
        stage = req.stage
        tl = req.timeline
        enq = tl.get(f"s{stage}_enqueue")
        if enq is None:
            return
        start = tl.get(f"s{stage}_start", enq)
        dispatch = tl.get(f"s{stage}_dispatch", start)
        self._push("queue_wait", track, req.rid, stage, enq, dispatch)
        self._push("replica_wait", track, req.rid, stage, dispatch, start)
        self._push("service", track, req.rid, stage, start, done)
        prev = start
        for kind, key in (("dense_compute", "compute_done"),
                          ("embed_fetch_local", "fetch_local_done"),
                          ("embed_fetch_remote", "fetch_remote_done"),
                          ("shard_transit", "service_done")):
            nxt = tl.get(f"s{stage}_{key}", prev)
            if nxt > prev:
                self._push(kind, track, req.rid, stage, prev, nxt)
            prev = nxt

    def record_request(self, req: "Request", done: float,
                       track: str = "fleet") -> None:
        """A sampled request's root span [t_arrive, done) plus the
        inter-stage transit gaps (front-door routing hop, cross-cell
        spill RTT, cascade hand-offs) — called once, at final
        completion, by the engine/federation completion path."""
        self._push("request", track, req.rid, req.stage, req.t_arrive, done)
        prev_done = req.t_arrive
        for stage in _stage_path(req):
            enq = req.timeline.get(f"s{stage}_enqueue")
            if enq is None:
                continue
            if enq > prev_done:
                self._push("transit", track, req.rid, stage, prev_done, enq)
            prev_done = req.timeline.get(f"s{stage}_done", enq)

    # ---- export ----
    def __len__(self) -> int:
        return len(self._spans)

    def summary(self) -> Dict:
        """Tracer-side stats (NOT embedded in any system summary — the
        tracer must never change what an untraced run reports)."""
        return {
            "spans": len(self._spans),
            "dropped_spans": self.dropped_spans,
            "sample_every": self.sample_every,
            "tracks": len(self._tracks),
        }

    def to_chrome_trace(self) -> Dict:
        """Chrome trace-event JSON (Perfetto / chrome://tracing / the
        `traceEvents` array format). One process per cell, one thread
        per pool / replica track; timestamps in microseconds. Sync
        B/E pairs carry replica batch occupancy; everything per-request
        is an async "b"/"e" pair keyed by the request id so overlapping
        requests on one pool render as a waterfall, not a mangled
        stack. Events are emitted in non-decreasing `ts` order
        (tools/check_trace.py validates this plus B/E pairing and
        pid/tid naming)."""
        # track name "cell/pool[/replicaN]" -> (pid, tid): processes are
        # cells in first-seen order, threads number within their process
        pids: Dict[str, int] = {}
        tids: Dict[int, Tuple[int, int]] = {}
        per_proc_threads: Dict[int, int] = {}
        meta: List[Dict] = []
        for track, track_id in self._tracks.items():
            proc = track.split("/", 1)[0]
            if proc not in pids:
                pids[proc] = len(pids) + 1
                meta.append({
                    "ph": "M", "name": "process_name", "pid": pids[proc],
                    "tid": 0, "ts": 0,
                    "args": {"name": proc},
                })
            pid = pids[proc]
            tid = per_proc_threads.get(pid, 0) + 1
            per_proc_threads[pid] = tid
            tids[track_id] = (pid, tid)
            meta.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "ts": 0, "args": {"name": track},
            })
        cols = self._spans.as_dict()
        opened: List[Tuple[float, int, Dict, Dict]] = []  # (ts, seq, b, e)
        for i in range(len(self._spans)):
            kind = _SPAN_KINDS[cols["kind"][i]]
            pid, tid = tids[cols["track"][i]]
            t0_us = cols["t0"][i] * 1e6
            t1_us = cols["t1"][i] * 1e6
            if kind in _SYNC_KINDS:
                begin = {
                    "ph": "B", "name": kind, "cat": "serving",
                    "pid": pid, "tid": tid, "ts": t0_us,
                    "args": {"items": cols["items"][i],
                             "requests": cols["rid"][i]},
                }
                end = {"ph": "E", "name": kind, "cat": "serving",
                       "pid": pid, "tid": tid, "ts": t1_us}
            else:
                rid = cols["rid"][i]
                begin = {
                    "ph": "b", "name": kind, "cat": "request",
                    "id": rid, "pid": pid, "tid": tid, "ts": t0_us,
                    "args": {"stage": cols["stage"][i]},
                }
                end = {"ph": "e", "name": kind, "cat": "request",
                       "id": rid, "pid": pid, "tid": tid, "ts": t1_us}
            opened.append((t0_us, i, begin, end))
        # interleave begins and ends into one globally ts-sorted list; at
        # equal ts, earlier-opened spans order first and a begin precedes
        # its own end — so a replica's E(batch k) lands before B(batch
        # k+1) when the next batch starts the instant the previous ends,
        # and zero-width spans stay B-then-E
        events: List[Tuple[float, int, int, Dict]] = []
        for ts, seq, b, e in opened:
            events.append((ts, seq, 0, b))
            events.append((e["ts"], seq, 1, e))
        events.sort(key=lambda t: (t[0], t[1], t[2]))
        return {
            "traceEvents": meta + [ev for _, _, _, ev in events],
            "displayTimeUnit": "ms",
            "metadata": {
                "sample_every": self.sample_every,
                "dropped_spans": self.dropped_spans,
            },
        }
