"""SLO monitoring: sliding-window percentiles for the control loops
(autoscaler, rate-limiter shedding) plus full-run history for end-of-run
reporting and per-pool SLO attribution.

Each ReplicaPool owns one SLOMonitor (stage latencies, measured from entry
into that pool), the engine owns one for end-to-end latencies, and in a
multi-cell federation each cell keeps its own on top of one fleet-wide
monitor — so an SLO breach is attributable to the pool AND the cell that
caused it, not just observed at the front door.

Spill attribution (federation.py) is kept separate from rejection
accounting: a request handed to a remote cell is `spilled_out` at its
home cell, `spilled_in` at the serving cell, and counted exactly once in
the fleet-wide conservation identity

    injected == completed + rejected + in_flight

where in_flight includes requests in inter-cell transit (paying RTT).
`federated_rollup` sums per-cell summaries into fleet totals and checks
that identity's spill legs (sum of spilled_out == sum of spilled_in once
transit has drained).

The caching layer (serving/cache.py) reports through here too: each
pool's hit/miss/eviction/result-hit counters roll up per system and per
federation via `fleet_cache_rollup`, and every pool traces its live
hit-rate at each scale tick — so a latency regression is attributable to
a cooling cache, not just observed at the front door. The shard tier
(serving/shard.py) extends the same rollup with staleness (serves of a
superseded row version), the cell-shared L2's hits/misses and the
local/remote shard-fetch split — summed pool -> cell -> fleet without
double counting, because L2 and shard counters enter once per cell.

So does the adaptive control plane (serving/control.py):
`fleet_control_rollup` sums per-pool control summaries (learned latency
corrections + observation counts, adaptive-batch participation) per
system and per federation, and every pool traces its effective
`max_batch_items` and latency correction at each scale tick — a p99
recovery is attributable to the controller narrowing batches or the
online model re-learning a drifted calibration.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np


class TraceBuffer:
    """Columnar per-tick trace: one growing numpy buffer per column
    (amortised-doubling appends) instead of one Python list append per
    column per tick. Rows append positionally in the declared column
    order; `as_dict()` converts back to plain Python lists, which is
    what summaries expose (tests compare those by value, and int columns
    round-trip as ints)."""

    __slots__ = ("_names", "_bufs", "_n")

    def __init__(self, columns: Sequence[Union[str, Tuple[str, type]]]) -> None:
        self._names: List[str] = []
        self._bufs: List[np.ndarray] = []
        for col in columns:
            name, dtype = col if isinstance(col, tuple) else (col, np.float64)
            self._names.append(name)
            self._bufs.append(np.empty(16, dtype=dtype))
        self._n = 0

    def __len__(self) -> int:
        return self._n

    def append(self, *values: float) -> None:
        """Append one row, positionally in declared column order."""
        if len(values) != len(self._bufs):
            raise ValueError(
                f"expected {len(self._bufs)} values ({self._names}), "
                f"got {len(values)}"
            )
        n = self._n
        if n == len(self._bufs[0]):
            for i, buf in enumerate(self._bufs):
                grown = np.empty(2 * n, dtype=buf.dtype)
                grown[:n] = buf
                self._bufs[i] = grown
        for buf, value in zip(self._bufs, values):
            buf[n] = value
        self._n = n + 1

    def column(self, name: str) -> np.ndarray:
        """Snapshot COPY of one column (length == rows appended so far).
        This used to hand out a live view, which silently detached from
        the buffer at the next amortised-doubling growth — a caller
        holding the view across appends read frozen, stale data with no
        error. A copy costs O(rows) but makes the contract unambiguous:
        what you got is what the column held when you asked
        (tests/test_events.py pins the growth boundary down)."""
        return self._bufs[self._names.index(name)][: self._n].copy()

    def as_dict(self) -> Dict[str, List]:
        """Plain {column: list} — the summary()-facing representation."""
        return {
            name: buf[: self._n].tolist()
            for name, buf in zip(self._names, self._bufs)
        }


@dataclasses.dataclass
class SpillStats:
    """Per-cell cross-cell traffic accounting (federation.py). Cascade
    stage spills are counted in BOTH the total and the cascade_* legs."""

    spilled_out: int = 0  # requests this cell handed to a remote cell
    spilled_in: int = 0  # requests this cell served for a remote home
    cascade_out: int = 0  # subset of spilled_out that were rerank stages
    cascade_in: int = 0  # subset of spilled_in that were rerank stages

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


# Schema key lists shared by the rollups and the Prometheus registry —
# the single source of truth simlint's SL003 checks consumers against.
# SPILL_KEYS mirrors the SpillStats fields (pinned by a test).
FEDERATED_CONSERVED_KEYS = ("arrived", "completed", "rejected", "in_queue",
                            "completed_in_horizon", "final_replicas")
SPILL_KEYS = ("spilled_out", "spilled_in", "cascade_out", "cascade_in")
CACHE_COUNTER_KEYS = ("hits", "misses", "evictions", "result_hits",
                      "staleness", "invalidated", "l2_hits", "l2_misses",
                      "local_fetches", "remote_fetches")
# (key, help) pairs rendered by MetricsRegistry._add_scope
SCOPE_CONSERVED_KEYS = (
    ("arrived", "requests offered to this scope"),
    ("injected", "requests injected fleet-wide"),
    ("completed", "requests fully served"),
    ("rejected", "requests shed by admission"),
    ("in_queue", "requests still queued at summary time"),
    ("in_flight", "requests queued or in inter-cell transit"),
    ("in_transit", "requests paying an inter-cell RTT"),
    ("completed_in_horizon", "completions inside the horizon"),
    ("spilled", "requests spilled out of their entry cell"),
    ("spilled_in", "spilled requests served for a remote home"),
    ("cascade_spilled", "cascade stages handed to a remote cell"),
    ("dropped_events", "loop events that fired with no handler"),
)
SCOPE_GAUGE_KEYS = (
    ("p50", "full-run median latency (seconds)"),
    ("p99", "full-run p99 latency (seconds)"),
    ("mean_latency", "full-run mean latency (seconds)"),
    ("slo_attainment", "fraction completed inside SLO"),
    ("throughput", "in-horizon completions per second"),
    ("final_replicas", "replicas at summary time"),
)


def fleet_cache_rollup(cache_summaries: Iterable[Dict]) -> Dict:
    """Sum per-pool cache summaries (ReplicaPool.cache_summary() dicts)
    into one tally with the aggregate hit-rates — the caching layer's
    contribution to an engine or federation summary. Pools without a
    cache contribute zeros, so the rollup is meaningful whether zero,
    some, or all pools cache. The shard-tier keys (staleness, l2_*,
    local/remote fetches) are zero below the cell level — per-pool
    summaries don't carry them — and sum when cell cache blocks (which
    the engine extends with L2 + shard-fetch counters) roll up through
    `federated_rollup`. Output keys round-trip as input: feeding rollups
    back through re-sums every counter and recomputes the rates (a
    property the tests pin down)."""
    out: Dict = {key: 0 for key in CACHE_COUNTER_KEYS}
    out["transit_s"] = 0.0
    for s in cache_summaries:
        for key in out:
            out[key] += s.get(key, 0)
    seen = out["hits"] + out["misses"]
    out["hit_rate"] = out["hits"] / seen if seen else 0.0
    l2_seen = out["l2_hits"] + out["l2_misses"]
    out["l2_hit_rate"] = out["l2_hits"] / l2_seen if l2_seen else 0.0
    return out


def fleet_control_rollup(control_summaries: Iterable[Dict]) -> Dict:
    """Sum control summaries into one fleet view of the adaptive
    control plane (serving/control.py): how many pools learn their
    latency online / adapt their batch size, total observation samples,
    and the SAMPLE-WEIGHTED mean learned correction (1.0 when nothing
    observed traffic — an unobserved fleet trusts its calibration).
    Accepts per-pool summaries (ReplicaPool.control_summary()) and,
    because the output keys are themselves accepted as input, per-cell
    rollups — `federated_rollup` feeds cells' "control" blocks straight
    back through, and the sample weighting keeps a one-sample cell from
    diluting a heavily observed drifted one. The dense and fetch
    corrections (control.py learns them separately) are both weighted
    by the pool's total sample count.

    Corrections are learned PER PLATFORM CLASS, never blended across
    classes: `by_platform` keeps a sample-weighted mean per class tag
    (pool summaries carry `platform`; cell rollups carry their own
    `by_platform`, which merges class-wise on the way up) — thermal
    drift on the CPU fleet must not look like a mis-calibrated
    accelerator curve in the fleet view. The TOP-LEVEL means remain the
    all-class blend for backward compatibility."""
    out = {"online_pools": 0, "adaptive_batch_pools": 0, "samples": 0}
    corr_sum = 0.0
    fetch_corr_sum = 0.0
    plat: Dict[str, Dict[str, float]] = {}

    def _per_class(platform: str, n: int, corr: float,
                   fetch: float) -> None:
        d = plat.setdefault(platform, {"samples": 0, "corr": 0.0, "fetch": 0.0})
        d["samples"] += n
        d["corr"] += n * corr
        d["fetch"] += n * fetch

    for s in control_summaries:
        out["online_pools"] += s.get(
            "online_pools", int(bool(s.get("online_latency"))))
        out["adaptive_batch_pools"] += s.get(
            "adaptive_batch_pools", int(bool(s.get("adaptive_batch"))))
        n = s.get("samples", 0)
        out["samples"] += n
        corr = s.get("latency_correction",
                     s.get("mean_latency_correction", 1.0))
        fetch = s.get("fetch_correction",
                      s.get("mean_fetch_correction", 1.0))
        corr_sum += n * corr
        fetch_corr_sum += n * fetch
        nested = s.get("by_platform")
        if nested:
            for p, d in nested.items():
                _per_class(p, d.get("samples", 0),
                           d.get("mean_latency_correction", 1.0),
                           d.get("mean_fetch_correction", 1.0))
        else:
            _per_class(s.get("platform", "generic"), n, corr, fetch)
    out["mean_latency_correction"] = (
        corr_sum / out["samples"] if out["samples"] else 1.0)
    out["mean_fetch_correction"] = (
        fetch_corr_sum / out["samples"] if out["samples"] else 1.0)
    out["by_platform"] = {
        p: {
            "samples": int(d["samples"]),
            "mean_latency_correction": (
                d["corr"] / d["samples"] if d["samples"] else 1.0),
            "mean_fetch_correction": (
                d["fetch"] / d["samples"] if d["samples"] else 1.0),
        }
        for p, d in sorted(plat.items())
    }
    return out


def fleet_breakdown_rollup(breakdowns: Iterable[Optional[Dict]]) -> Dict:
    """Sum per-pool / per-cell `latency_breakdown` blocks
    (tracing.BreakdownAccumulator.summary() dicts) into one aggregate:
    counts, per-component seconds and cumulative histogram rows all sum;
    shares recompute against the summed end-to-end latency. Empty input
    (or blocks from systems with no completions) rolls up to a valid
    all-zero block, and — like the cache/control rollups — output blocks
    feed back in as input, so pool -> cell -> fleet is the same helper
    applied twice."""
    out = {"count": 0, "end_to_end_s": 0.0, "component_sum_s": 0.0,
           "components": {}, "histogram_buckets_s": None, "histograms": {}}
    for block in breakdowns:
        if not block:
            continue
        out["count"] += block.get("count", 0)
        out["end_to_end_s"] += block.get("end_to_end_s", 0.0)
        out["component_sum_s"] += block.get("component_sum_s", 0.0)
        for name, v in block.get("components", {}).items():
            out["components"][name] = out["components"].get(name, 0.0) + v
        buckets = block.get("histogram_buckets_s")
        if buckets is not None:
            if out["histogram_buckets_s"] is None:
                out["histogram_buckets_s"] = list(buckets)
            elif list(buckets) != out["histogram_buckets_s"]:
                raise ValueError(
                    "latency_breakdown blocks disagree on histogram buckets: "
                    f"{buckets} vs {out['histogram_buckets_s']}")
        for name, counts in block.get("histograms", {}).items():
            have = out["histograms"].get(name)
            if have is None:
                out["histograms"][name] = list(counts)
            else:
                for i, c in enumerate(counts):
                    have[i] += c
    denom = out["end_to_end_s"] if out["end_to_end_s"] > 0 else 1.0
    out["shares"] = {n: v / denom for n, v in out["components"].items()}
    return out


def federated_rollup(cells: Dict[str, Dict]) -> Dict[str, int]:
    """Sum per-cell summaries (each a ServingSystem.summary() dict plus a
    "spill" sub-dict) into fleet-wide counters. Latency percentiles do NOT
    roll up from per-cell percentiles — the federation keeps its own
    fleet-wide SLOMonitor for those; this merges the conserved counts
    (plus the cells' cache tallies, via fleet_cache_rollup)."""
    out = {key: 0 for key in FEDERATED_CONSERVED_KEYS + SPILL_KEYS}
    dropped = 0
    dropped_kinds: Dict[str, int] = {}
    for summary in cells.values():
        for key in FEDERATED_CONSERVED_KEYS:
            out[key] += summary[key]
        spill = summary.get("spill", {})
        for key in SPILL_KEYS:
            out[key] += spill.get(key, 0)
        # federated cells share ONE EventLoop, so each cell reports the
        # same loop-global drop counters — merge by max, never sum
        # (summing would multiply the drops by the cell count)
        dropped = max(dropped, summary.get("dropped_events", 0))
        for kind, n in (summary.get("dropped_kinds") or {}).items():
            dropped_kinds[kind] = max(dropped_kinds.get(kind, 0), n)
    out["dropped_events"] = dropped
    out["dropped_kinds"] = dropped_kinds
    out["cache"] = fleet_cache_rollup(
        s.get("cache", {}) for s in cells.values()
    )
    # shard staleness must survive above the cell level even when a
    # consumer drops the cache block: mirror it at the top of the rollup
    out["staleness"] = out["cache"]["staleness"]
    # per-cell control planes roll up through the same helper (cells
    # adapt independently; sample weighting keeps the fleet mean honest)
    out["control"] = fleet_control_rollup(
        s.get("control", {}) for s in cells.values()
    )
    out["latency_breakdown"] = fleet_breakdown_rollup(
        s.get("latency_breakdown") for s in cells.values()
    )
    return out


class SLOMonitor:
    """Latency accounting on growing numpy buffers. Finish times arrive
    in event order (the loop clock never goes backwards), so the
    sliding window is just a [lo:n) slice of the full-run buffers:
    `record` is an O(1) array write, the window trim is a searchsorted
    on the monotone finish-time column instead of a per-event deque
    popleft, and percentile inputs are ready-made float64 slices."""

    def __init__(self, window_s: float = 10.0,
                 slo_s: Optional[float] = None) -> None:
        self.window_s = window_s
        self.slo_s = slo_s
        self._fin = np.empty(1024)  # finish times, monotone non-decreasing
        self._lat = np.empty(1024)  # latencies, same order
        self._n = 0
        self._lo = 0  # sliding-window start: window is lat[_lo:_n]
        self.arrived = 0
        self.rejected = 0
        self.completed = 0
        self.slo_hits = 0

    def record(self, finish: float, latency: float) -> None:
        n = self._n
        if n == len(self._lat):
            for name in ("_fin", "_lat"):
                buf = getattr(self, name)
                grown = np.empty(2 * n)
                grown[:n] = buf
                setattr(self, name, grown)
        self._fin[n] = finish
        self._lat[n] = latency
        self._n = n + 1
        self.completed += 1
        if self.slo_s is not None and latency <= self.slo_s:
            self.slo_hits += 1

    def percentiles(self, now: float) -> Dict[str, float]:
        """Sliding-window stats — the signal the control loops react to."""
        cut = now - self.window_s
        lo, n = self._lo, self._n
        if lo < n and self._fin[lo] < cut:
            lo = int(np.searchsorted(self._fin[:n], cut, side="left"))
            self._lo = lo
        if lo >= n:
            return {"p50": 0.0, "p99": 0.0, "qps": 0.0}
        arr = self._lat[lo:n]
        # before the first window has elapsed the divisor is the time that
        # actually passed — dividing by the full window understates qps and
        # feeds the shed/scale loops a wrong early signal
        elapsed = max(min(now, self.window_s), 1e-9)
        return {
            "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "qps": (n - lo) / elapsed,
        }

    def attainment(self) -> float:
        """Fraction of completed requests inside the SLO (1.0 when none)."""
        if self.slo_s is None or not self.completed:
            return 1.0
        return self.slo_hits / self.completed

    def totals(self) -> Dict[str, float]:
        """Full-run latency stats (not windowed)."""
        if not self._n:
            return {"p50": 0.0, "p99": 0.0, "mean": 0.0,
                    "completed": 0, "attainment": self.attainment()}
        arr = self._lat[: self._n]
        return {
            "p50": float(np.percentile(arr, 50)),
            "p99": float(np.percentile(arr, 99)),
            "mean": float(arr.mean()),
            "completed": self.completed,
            "attainment": self.attainment(),
        }


class MetricsRegistry:
    """Prometheus text exposition over a finished run's summary dict.

    `MetricsRegistry.from_summary(summary)` accepts either a
    `FederatedSystem.summary()` (has "cells") or a
    `ServingSystem.summary()` (has "pools") and registers the conserved
    counters (arrived/completed/rejected/in-flight/spill legs — the same
    numbers `federated_rollup` sums, fleet-wide AND per cell), the
    cache/shard tallies including `staleness`, the control-plane
    corrections per platform class, the event loop's
    `dropped_events`/`dropped_kinds`, and the latency-breakdown
    component sums + histograms from the `latency_breakdown` blocks.
    `to_prometheus_text()` renders the standard `# HELP`/`# TYPE` +
    labeled-sample exposition format. Purely read-only over the summary:
    building a registry never mutates a running system."""

    def __init__(self, namespace: str = "repro_serving") -> None:
        self.namespace = namespace
        # name -> (type, help, [(labels dict, value)]) in insertion order
        self._metrics: Dict[str, Tuple[str, str, List[Tuple[Dict, float]]]] = {}

    def add(self, name: str, kind: str, help_: str, value: float,
            **labels: object) -> None:
        full = f"{self.namespace}_{name}"
        if full not in self._metrics:
            self._metrics[full] = (kind, help_, [])
        self._metrics[full][2].append((labels, value))

    # ---- construction from summaries ----
    @classmethod
    def from_summary(cls, summary: Dict,
                     namespace: str = "repro_serving") -> "MetricsRegistry":
        reg = cls(namespace)
        if "cells" in summary:
            reg._add_scope(summary, scope="fleet")
            for name, cell in summary["cells"].items():
                reg._add_scope(cell, scope="cell", cell=name)
        else:
            reg._add_scope(summary, scope="system")
        return reg

    def _add_scope(self, s: Dict, **labels: object) -> None:
        for key, help_ in SCOPE_CONSERVED_KEYS:
            if key in s:
                self.add(f"{key}_total", "counter", help_, s[key], **labels)
        for kind, n in (s.get("dropped_kinds") or {}).items():
            self.add("dropped_events_by_kind_total", "counter",
                     "unhandled loop events by event kind", n,
                     kind=kind, **labels)
        spill = s.get("spill") or {}
        for key in SPILL_KEYS:
            if key in spill:
                self.add(f"spill_{key}_total", "counter",
                         "per-cell spill attribution", spill[key], **labels)
        for key, help_ in SCOPE_GAUGE_KEYS:
            if key in s:
                self.add(key, "gauge", help_, s[key], **labels)
        cache = s.get("cache") or {}
        for key in CACHE_COUNTER_KEYS:
            if key in cache:
                self.add(f"cache_{key}_total", "counter",
                         "embedding cache / shard tier tallies",
                         cache[key], **labels)
        if "transit_s" in cache:
            self.add("shard_transit_seconds_total", "counter",
                     "inter-cell RTT paid by remote shard fetches",
                     cache["transit_s"], **labels)
        control = s.get("control") or {}
        if "samples" in control:
            self.add("control_samples_total", "counter",
                     "online latency-model observations", control["samples"],
                     **labels)
        for plat, d in (control.get("by_platform") or {}).items():
            self.add("control_latency_correction", "gauge",
                     "learned dense-latency correction (1.0 = calibrated)",
                     d.get("mean_latency_correction", 1.0),
                     platform=plat, **labels)
            self.add("control_fetch_correction", "gauge",
                     "learned embed-fetch correction (1.0 = calibrated)",
                     d.get("mean_fetch_correction", 1.0),
                     platform=plat, **labels)
        self._add_breakdown(s.get("latency_breakdown") or {}, **labels)

    def _add_breakdown(self, block: Dict, **labels: object) -> None:
        if not block:
            return
        self.add("latency_breakdown_requests_total", "counter",
                 "requests decomposed into latency components",
                 block.get("count", 0), **labels)
        self.add("latency_end_to_end_seconds_total", "counter",
                 "summed end-to-end latency of decomposed requests",
                 block.get("end_to_end_s", 0.0), **labels)
        for name, v in (block.get("components") or {}).items():
            self.add("latency_component_seconds_total", "counter",
                     "summed per-component latency attribution",
                     v, component=name, **labels)
        buckets = block.get("histogram_buckets_s")
        for name, cum in (block.get("histograms") or {}).items():
            if buckets is None:
                break
            for edge, c in zip(list(buckets) + ["+Inf"], cum):
                le = edge if isinstance(edge, str) else repr(float(edge))
                self.add("latency_component_seconds_bucket", "histogram",
                         "per-component latency distribution (cumulative)",
                         c, component=name, le=le, **labels)

    # ---- rendering ----
    @staticmethod
    def _fmt_value(v: float) -> str:
        if isinstance(v, bool):
            return str(int(v))
        if isinstance(v, int):
            return str(v)
        f = float(v)
        return str(int(f)) if f.is_integer() and abs(f) < 1e15 else repr(f)

    @staticmethod
    def _fmt_label(v: object) -> str:
        s = str(v).replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")
        return f'"{s}"'

    def to_prometheus_text(self) -> str:
        """The text exposition format scrapers ingest: `# HELP`/`# TYPE`
        headers once per metric, then one labeled sample per line."""
        lines: List[str] = []
        for name, (kind, help_, samples) in self._metrics.items():
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {kind}")
            for labels, value in samples:
                if labels:
                    inner = ",".join(
                        f"{k}={self._fmt_label(v)}" for k, v in labels.items()
                    )
                    lines.append(f"{name}{{{inner}}} {self._fmt_value(value)}")
                else:
                    lines.append(f"{name} {self._fmt_value(value)}")
        return "\n".join(lines) + "\n"
