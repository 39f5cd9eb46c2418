"""Model replicas: served variants + calibrated latency models (a copy of
`repro.core.serving.replica`; only the docstrings differ).

A replica serves batches through a real serve call. For the
discrete-event simulator, per-batch-size service times are CALIBRATED once
by timing that call on the device it runs on (`launch/serve.latency_model`:
the card, synchronised after each call) at a ladder of batch sizes, then
interpolated — so the elastic-scheduling experiments reflect the actual
relative costs of the five Table-I variants, not made-up constants.
Cold/warm start costs model kernel build + weight load.

Service time decomposes into dense compute + sparse memory traffic
(caching layer): `ReplicaSpec.service_time(items, miss_rows)` is the
calibrated dense curve at `items` work items PLUS `embed_fetch_s`
seconds per embedding row the pool's hot-ID cache MISSED — so batch
latency depends on the live hit-rate, not just batch size. Pools with
no cache pay the fetch for every id row their requests carry (the
memory-bound baseline); `embed_fetch_s=0` (the default) reduces to the
pure dense model for traffic that carries no ids.

With the shard tier (serving/shard.py) the miss side splits further:
`miss_rows` may be a `MissProfile` decomposing one batch's L1-missed
rows into shared-L2 hits (free), local-shard fetches (pay
`embed_fetch_s` each) and remote-shard fetches (pay `embed_fetch_s`
each PLUS the batched inter-cell transit in `transit_s`). A plain int
still works everywhere and means "all rows fetched locally" — the
pre-shard behaviour, bit-identical.

Platform classes (DeepRecSys, arXiv 2001.02772; the Facebook
architectural-implications study motivates the curve shapes): a fleet
is rarely one kind of hardware. `ReplicaSpec.platform` names the curve
FAMILY a replica draws from, and the two family constructors capture
the two shapes that matter for query-size-aware scheduling:

    ReplicaSpec.cpu_like(...)          low fixed cost, poor batch
                                       scaling (steep per-item slope) —
                                       cheap for small pointwise
                                       queries, terrible for ranking
    ReplicaSpec.accelerator_like(...)  high fixed cost (kernel launch /
                                       transfer), near-flat batch
                                       scaling — wasteful on tiny
                                       batches, unbeatable at hundreds
                                       of candidates

Plain `ReplicaSpec(...)` keeps `platform="generic"`: every pre-platform
construction behaves exactly as before. The platform tag is what
`router.SizeAwareRouter` keys on to send small queries to CPU-class
capacity and large ranking batches to accelerator-class capacity.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Optional, Sequence, Tuple, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class MissProfile:
    """Where one batch's L1-missed embedding rows were served from:
    `l2_hits` absorbed by the shared per-cell L2 cache (no fetch cost),
    `local_rows` fetched from shards homed in the serving cell,
    `remote_rows` fetched from remote-cell shards, and `transit_s` the
    inter-cell RTT those remote fetches paid (one RTT per (batch,
    remote shard) pair — the shard service batches fetches per shard,
    see EmbeddingShardService.fetch)."""

    l2_hits: int = 0
    local_rows: int = 0
    remote_rows: int = 0
    transit_s: float = 0.0

    @property
    def fetch_rows(self) -> int:
        """Rows that reached the shard tier and pay `embed_fetch_s`."""
        return self.local_rows + self.remote_rows

    @property
    def total_rows(self) -> int:
        """All rows the pool's L1 missed (L2 hits + shard fetches)."""
        return self.l2_hits + self.local_rows + self.remote_rows


MissRows = Union[int, MissProfile]


@dataclasses.dataclass
class LatencyModel:
    """Piecewise-linear service time in seconds vs batch size (work items).
    Beyond the last calibrated size the marginal per-item cost of the final
    segment extrapolates linearly — ranking batches (hundreds of candidates
    per request) routinely exceed the calibration ladder, and np.interp's
    clamp would make arbitrarily large batches free."""

    sizes: np.ndarray
    times: np.ndarray

    def __call__(self, batch: int) -> float:
        b = float(batch)
        if len(self.sizes) >= 2 and b > self.sizes[-1]:
            slope = (self.times[-1] - self.times[-2]) / (self.sizes[-1] - self.sizes[-2])
            # timing noise can leave the calibrated tail non-monotonic; a
            # negative slope would make huge batches (and thus busy_until)
            # go negative and corrupt the event clock
            return float(self.times[-1] + max(slope, 0.0) * (b - self.sizes[-1]))
        return float(np.interp(b, self.sizes, self.times))

    @staticmethod
    def calibrate(
        fn: Callable[[int], None],
        sizes: Sequence[int] = (1, 8, 32, 128, 512),
        reps: int = 3,
    ) -> "LatencyModel":
        """fn(batch) runs one real (blocking) inference at that batch size.

        Wall-clock timing of REAL kernels is calibrate()'s whole job —
        it runs offline, never on the simulated path, so the SL001
        determinism rule is suppressed for exactly these two reads.
        """
        ts = []
        for b in sizes:
            fn(b)  # compile / warm
            t0 = time.perf_counter()  # simlint: disable=SL001
            for _ in range(reps):
                fn(b)
            ts.append((time.perf_counter() - t0) / reps)  # simlint: disable=SL001
        return LatencyModel(np.asarray(sizes, np.float64), np.asarray(ts))

    @staticmethod
    def analytic(base_s: float, per_item_s: float) -> "LatencyModel":
        sizes = np.array([1, 2048], np.float64)
        return LatencyModel(sizes, base_s + per_item_s * sizes)


@dataclasses.dataclass
class ReplicaSpec:
    """`latency` is the OFFLINE-calibrated curve — what routers, pools
    and planning math predict from. `true_latency`, when set, is what
    batches actually take: the drift/interference/mis-calibration model
    the control plane (serving/control.py) exists to learn back. None
    (the default) means the calibration is accurate.

    `platform` tags the hardware class the curve was calibrated on —
    "cpu" / "accelerator" via the family constructors below, "generic"
    for everything else. Routers key on it (SizeAwareRouter); nothing
    in the service-time math does, so a tag alone never changes a
    clock."""

    variant: str  # which Table-I variant this pool serves
    latency: LatencyModel
    cold_start_s: float = 8.0  # load weights + compile
    warm_start_s: float = 0.25  # pre-initialized pool activation
    embed_fetch_s: float = 0.0  # per MISSED embedding row (caching layer)
    true_latency: Optional[LatencyModel] = None  # observed curve if drifted
    true_embed_fetch_s: Optional[float] = None  # observed fetch if drifted
    platform: str = "generic"  # hardware class ("cpu"/"accelerator"/"generic")

    @classmethod
    def cpu_like(cls, variant: str, *, base_s: float = 0.002,
                 per_item_s: float = 8e-4, warm_start_s: float = 0.05,
                 cold_start_s: float = 1.0, **kw) -> "ReplicaSpec":
        """A CPU-class replica: LOW fixed cost, POOR batch scaling (the
        per-item slope dominates past a few items). Defaults model a
        general-purpose server core: ~2ms base, ~0.8ms per extra work
        item, fast warm starts (no kernel compile). Override the curve
        or pass `latency=` through **kw for a calibrated one."""
        kw.setdefault("latency", LatencyModel.analytic(base_s, per_item_s))
        return cls(variant, platform="cpu", warm_start_s=warm_start_s,
                   cold_start_s=cold_start_s, **kw)

    @classmethod
    def accelerator_like(cls, variant: str, *, base_s: float = 0.025,
                         per_item_s: float = 3e-5, warm_start_s: float = 0.25,
                         cold_start_s: float = 8.0, **kw) -> "ReplicaSpec":
        """An accelerator-class replica: HIGH fixed cost (launch +
        transfer), NEAR-FLAT batch scaling — a 512-item ranking batch
        costs barely more than a pointwise probe. Defaults: ~25ms base,
        ~0.03ms per item (the curves cross CPU-class around ~30 items),
        slow cold starts (kernel build + weight load)."""
        kw.setdefault("latency", LatencyModel.analytic(base_s, per_item_s))
        return cls(variant, platform="accelerator", warm_start_s=warm_start_s,
                   cold_start_s=cold_start_s, **kw)

    def service_time(self, items: int, miss_rows: MissRows = 0) -> float:
        """Cache-aware decomposition: ACTUAL dense compute at `items`
        work items (the drifted curve when calibration is off) + the
        embedding-fetch cost of the rows the pool's hot-ID cache missed
        for this batch. A `MissProfile` charges the fetch only for rows
        that reached the shard tier (L2 hits are free) plus the batch's
        inter-cell transit; an int charges every row, with no transit —
        the pre-shard local-table model."""
        dense = self.true_latency if self.true_latency is not None else self.latency
        fetch = (
            self.true_embed_fetch_s
            if self.true_embed_fetch_s is not None
            else self.embed_fetch_s
        )
        if isinstance(miss_rows, MissProfile):
            return dense(items) + miss_rows.fetch_rows * fetch + miss_rows.transit_s
        return dense(items) + miss_rows * fetch


def sustainable_rate(
    spec: ReplicaSpec,
    replicas: int,
    max_wait_s: float,
    ids_per_request: int = 0,
    hit_rate: float = 0.0,
) -> float:
    """Sustainable request rate under timeout batching: batches close
    every `max_wait_s` holding r*max_wait_s requests, and R replicas keep
    up only while b1 + (m + miss_fetch)*r*w <= R*w, i.e.

        r = (R*w - b1) / (w * (m + miss_fetch))

    at the calibrated base b1, marginal per-item cost m (taken over the
    1..32 segment) and miss_fetch = (1 - hit_rate) * ids_per_request *
    embed_fetch_s seconds of embedding traffic per request. This is the
    operating-point model the benchmarks, tests and examples share to
    place offered load relative to a fleet's capacity (cold: hit_rate 0;
    warm: the cache's steady-state hit-rate). Clamped below by 1 rps for
    hosts whose calibrated base exceeds the batching window. A FLAT
    curve with no embedding traffic (marginal + miss_fetch == 0, e.g.
    `LatencyModel.analytic(base, 0.0)` and ids_per_request 0) means
    per-request cost is pure base amortisation: the rate is unbounded
    when the base fits the batching window, else the 1 rps floor —
    never a ZeroDivisionError."""
    b1 = spec.latency(1)
    marginal = (spec.latency(32) - b1) / 31.0
    miss_fetch = (1.0 - hit_rate) * ids_per_request * spec.embed_fetch_s
    denom = max_wait_s * (marginal + miss_fetch)
    if denom <= 0.0:
        return float("inf") if replicas * max_wait_s > b1 else 1.0
    return max((replicas * max_wait_s - b1) / denom, 1.0)


class Replica:
    def __init__(self, rid: int, spec: ReplicaSpec, ready_at: float):
        self.rid = rid
        self.spec = spec
        self.ready_at = ready_at
        self.busy_until = ready_at
        self.in_flight = 0
        self.served = 0

    def residual(self, now: float) -> float:
        """Seconds of already-committed service left on this replica —
        the pure backlog term, no tie-break fudge (cost-model routing)."""
        return max(self.busy_until - now, 0.0)

    def load(self, now: float) -> float:
        """Router signal: time until free (+ small in-flight tie-break)."""
        return self.residual(now) + 0.001 * self.in_flight

    def start_batch(self, now: float, items: int, miss_rows: MissRows = 0) -> Tuple[float, float]:
        """Queue one batch of `items` work units whose embedding lookups
        missed `miss_rows` cache rows (an int, or a MissProfile when the
        shard tier decomposed the misses); returns (start, done)."""
        start = max(now, self.busy_until, self.ready_at)
        dur = self.spec.service_time(items, miss_rows)
        self.busy_until = start + dur
        self.in_flight += 1
        self.served += items
        return start, self.busy_until
