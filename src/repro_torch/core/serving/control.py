"""Adaptive serving control plane: online-learned latency + SLO-aware
batch sizing (paper §IV's elastic-scheduling feedback loop, closed).

The routers and pools predict completion times from OFFLINE-calibrated
LatencyModels (replica.py). Calibration drifts — interference, thermal
throttling, a model pushed with a stale ladder — and a static prediction
then misroutes traffic and missizes batches no matter how good the live
queue signals are. DeepRecSys (arXiv 2001.02772) closes exactly this
loop: per-pool batch sizing driven by live SLO headroom, cost estimates
tracked against observed service times. This module is that feedback
layer for the simulator:

    Ewma                 one exponentially-weighted mean, shared by every
                         windowed estimator in the control plane (the
                         latency correction AND the pool's id-rows-per-
                         item average, which used to be a never-decaying
                         lifetime counter)
    OnlineLatencyModel   wraps the calibrated offline LatencyModel and
                         EWMA-corrects it with SEPARATE multiplicative
                         dense and embedding-fetch corrections learned
                         from observed (batch items, miss rows, measured
                         service seconds) samples at each batch_done —
                         `ReplicaPool.dense_latency`, `predicted_latency`
                         and `CostModelRouter.estimate` consult the
                         corrected curve and corrected per-row fetch
    BatchSizeController  per-pool effective `max_batch_items`, widened
                         under SLO headroom (throughput) and narrowed on
                         breach (latency), driven from `scale_tick`
    ControlConfig        opt-in knobs, carried by `PoolSpec.control`

Signal path (pool.py wires it):

    batch_done ──► OnlineLatencyModel.observe(items, miss_rows, measured)
                        │  fetch-free batch:  dense corr = EWMA(meas/dense)
                        │  fetch-carrying:    fetch corr = EWMA(residual/fetch)
                        ▼
    predicted_latency / CostModelRouter.estimate  (corrected curve)

    scale_tick ──► BatchSizeController.tick(p99, slo)
                        │  breach: cap ×= narrow   headroom: cap ×= widen
                        ▼
    ReplicaPool item cap (batch close + next-batch split), traced per tick

Corrections are learned PER PLATFORM CLASS, never blended: each
OnlineLatencyModel belongs to one pool, a pool serves one
`ReplicaSpec.platform` (CPU-class and accelerator-class capacity live
in sibling pools, see replica.py), and no estimator is shared across
pools — so CPU-fleet thermal drift can never contaminate the
accelerator curve the size-aware router splits on. The reporting side
keeps the separation too: pool control summaries carry the platform
tag and `metrics.fleet_control_rollup` maintains per-class
sample-weighted means (`by_platform`) all the way up the
pool -> cell -> fleet chain.

Invariants: everything here is deterministic — corrections depend only on
the observation sequence, the controller only on the (p99, slo) tick
sequence; two identical runs adapt bit-identically (tests replay them).
The correction never flips the curve's sign (clamped positive), and the
controller never leaves [min_batch_items, max_batch_items]. Times are
seconds, batch caps are work ITEMS on the same scale as `Request.cost`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.serving.replica import LatencyModel, MissProfile


class Ewma:
    """Exponentially-weighted mean: the control plane's one windowed
    estimator. The first sample initialises the mean exactly (no bias
    toward a made-up prior); `value` is None until then. An `alpha` of
    1.0 degenerates to last-sample, 0.0 to first-sample-forever."""

    def __init__(self, alpha: float):
        if not 0.0 <= alpha <= 1.0:
            raise ValueError(f"EWMA alpha must be in [0, 1], got {alpha}")
        self.alpha = alpha
        self.value: Optional[float] = None
        self.samples = 0

    def update(self, x: float) -> float:
        self.value = x if self.value is None else (
            self.value + self.alpha * (x - self.value))
        self.samples += 1
        return self.value


@dataclasses.dataclass
class ControlConfig:
    """Per-pool control-plane knobs (`PoolSpec.control`; None = the
    static pre-control behaviour everywhere).

    `online_latency` turns on the EWMA-corrected latency curve;
    `ewma_alpha` is its smoothing factor (also used for the id-rows-per-
    item estimator the miss-cost prediction reads). `adapt_batch` turns
    on SLO-aware batch sizing: each scale tick the pool's effective item
    cap is multiplied by `narrow` while the windowed p99 breaches the
    SLO and by `widen` while p99 sits below `headroom` of it (the band
    between holds the cap steady), clamped to [min_batch_items,
    max_batch_items]. The controller starts from the pool's configured
    `max_batch_items` (or this config's ceiling when the pool had no
    item cap) and only moves on a real p99 signal — initialisation
    never changes the cap. A pool configured TIGHTER than
    `min_batch_items` keeps its own cap as the narrow floor (the floor
    clamp never lifts it); sustained headroom may still widen any pool
    up to this config's ceiling — that band is what opting in
    declares."""

    online_latency: bool = True
    ewma_alpha: float = 0.25
    adapt_batch: bool = True
    min_batch_items: int = 16
    max_batch_items: int = 4096
    widen: float = 1.25
    narrow: float = 0.6
    headroom: float = 0.6


class OnlineLatencyModel:
    """The calibrated offline curve, EWMA-corrected from observation.

    Service time has two physically separate legs — dense compute and
    per-missed-row embedding fetch — that drift INDEPENDENTLY (thermal
    throttling hits the matmuls; a saturated memory bus or a degraded
    shard link hits the fetches), so the model learns two multiplicative
    corrections instead of one conflated ratio (which shard-fetch-
    dominated batches used to drag onto the dense curve and vice versa):

    - a batch with NO fetched rows is a pure dense sample — its
      measured/offline ratio updates the DENSE correction;
    - a batch that fetched rows updates the FETCH correction from the
      residual after the (currently corrected) dense leg and the
      batch's inter-cell transit are subtracted, per predicted fetch
      second, clamped non-negative.

    Each correction is a single multiplicative factor (not per-size
    residuals): that keeps the estimator sample-efficient at every
    batch size at once, because mis-calibration and interference
    overwhelmingly scale a whole leg. `miss_rows` may be an int or a
    replica.MissProfile — transit seconds are the RTT matrix's, known
    exactly, so they are subtracted rather than corrected."""

    def __init__(self, offline: LatencyModel, embed_fetch_s: float = 0.0,
                 alpha: float = 0.25):
        self.offline = offline
        self.embed_fetch_s = embed_fetch_s
        self._dense_corr = Ewma(alpha)
        self._fetch_corr = Ewma(alpha)

    @property
    def correction(self) -> float:
        """Multiplicative observed/offline factor on the DENSE leg (1.0
        until the first fetch-free sample — an unobserved pool trusts
        its calibration). Kept under the pre-split name: every existing
        consumer (trace column, control summary, rollup) read the dense
        curve's correction."""
        return 1.0 if self._dense_corr.value is None else self._dense_corr.value

    @property
    def fetch_correction(self) -> float:
        """Multiplicative observed/offline factor on the per-row
        embedding-fetch leg (1.0 until the first fetch-carrying
        sample)."""
        return 1.0 if self._fetch_corr.value is None else self._fetch_corr.value

    @property
    def samples(self) -> int:
        return self._dense_corr.samples + self._fetch_corr.samples

    def observe(self, items: int, miss_rows, measured_s: float) -> None:
        """One batch_done sample: measured service seconds for a batch
        of `items` work items whose lookups missed `miss_rows` rows (int,
        or a MissProfile carrying the shard tier's decomposition)."""
        if measured_s < 0.0:
            return
        if isinstance(miss_rows, MissProfile):
            fetch_rows, transit_s = miss_rows.fetch_rows, miss_rows.transit_s
        else:
            fetch_rows, transit_s = miss_rows, 0.0
        dense_pred = self.offline(items)
        fetch_pred = fetch_rows * self.embed_fetch_s
        if fetch_pred <= 0.0:
            # pure dense sample (transit without fetched rows cannot occur:
            # transit is charged per remote shard actually fetched from)
            if dense_pred > 0.0:
                self._dense_corr.update(measured_s / dense_pred)
        else:
            residual = measured_s - self.correction * dense_pred - transit_s
            self._fetch_corr.update(max(residual / fetch_pred, 0.0))

    def dense(self, items: int) -> float:
        """Corrected dense service time at `items` work items."""
        return self.correction * self.offline(items)

    @property
    def fetch_s(self) -> float:
        """Corrected per-missed-row embedding-fetch seconds."""
        return self.fetch_correction * self.embed_fetch_s


class BatchSizeController:
    """SLO-aware effective `max_batch_items` (DeepRecSys-style): widen
    under headroom to amortise the per-batch base cost (throughput),
    narrow on breach to bound per-batch service time (latency). Driven
    once per scale tick from the pool's OWN windowed p99; a tick with no
    signal (p99 == 0, empty window) holds the cap — adapting to silence
    would race the first real traffic to the clamp rails."""

    def __init__(self, cfg: ControlConfig, initial: Optional[int] = None):
        self.cfg = cfg
        start = initial if initial is not None else cfg.max_batch_items
        # a pool configured TIGHTER than the controller's default floor
        # keeps its own cap as the narrow floor: initialisation and the
        # floor clamp never lift a static cap without a headroom signal
        self._min = float(min(cfg.min_batch_items, start))
        self._cap = float(min(start, cfg.max_batch_items))

    @property
    def cap(self) -> int:
        """The pool's current effective item cap, in work items."""
        return int(round(self._cap))

    def tick(self, p99: float, slo_s: float) -> int:
        if p99 > slo_s:
            self._cap = max(self._min, self._cap * self.cfg.narrow)
        elif 0.0 < p99 < self.cfg.headroom * slo_s:
            self._cap = min(float(self.cfg.max_batch_items),
                            self._cap * self.cfg.widen)
        return self.cap
