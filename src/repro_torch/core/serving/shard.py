"""Sharded embedding tier: parameter-server shards under the pools.

At production scale the embedding table dwarfs any single host —
HugeCTR/Merlin's answer is model-parallel tables hashed across devices,
and the cross-stack recsys characterizations show sparse-lookup
locality across exactly this memory hierarchy is the dominant serving
bottleneck. This module is the simulator's version of that hierarchy's
bottom layer; together with cache.py the full miss path is

    request ids -> pool L1 (EmbeddingCache, per pool)
                -> cell L2 (one shared EmbeddingCache per cell,
                            CacheConfig.l2, built by ServingSystem)
                -> EmbeddingShardService.fetch (this module)

Sharding model: ids hash DETERMINISTICALLY to `n_shards` shards
(`shard_of`, a Fibonacci-multiplier hash so the hot low ids of a Zipf
stream spread across shards instead of clustering), and a placement
map assigns each shard a HOME CELL round-robin over the placement
tuple. A fetch from a shard homed in the serving cell (or from any
shard when the placement is empty — the single-host table) is local:
it pays only the replica's per-row `embed_fetch_s`. A fetch from a
remote-cell shard additionally pays inter-cell transit: fetches are
batched per shard, so one dispatched batch pays ONE rtt(serving cell,
home cell) per distinct remote shard it touches, not one per row.
`fetch` returns that decomposition as a `replica.MissProfile`, which
`ReplicaSpec.service_time` prices and `ReplicaPool.predicted_miss_cost`
/ `CostModelRouter.estimate` predict — so routing prefers cells whose
L2 and local shards are warm.

Online table updates: `publish(ids)` bumps each row's version (the
"live model update without service interruption"). With
`invalidation=True` the new versions propagate down the hierarchy
immediately — every registered cache (the cell L2s first, then the
pool L1s, in registration order) marks its resident copies dirty, and
the next access refetches them in place. With invalidation off the
caches keep serving superseded rows and their `staleness` counters
record every such serve; `version_of` is what lets them notice.

Determinism: hashing, placement and versions are pure functions of the
push/fetch sequence — no wall clock, no randomness — so sharded runs
replay bit-identically (`summary()["version_sum"]` is the fingerprint
the replay tests compare). Per-cell fetch counters are kept separately
(`cell_stats`) so per-cell summaries attribute their own traffic and
fleet rollups never double count.

`RttMatrix` lives here (moved from federation.py, which re-exports it):
the shard tier sits BELOW the federation and both charge hops from the
same per-cell-pair matrix — `FederatedSystem` binds its matrix onto a
shard service constructed without one.
"""
from __future__ import annotations

from typing import Dict, Hashable, Iterable, List, Optional, Tuple

from repro_torch.core.serving.cache import EmbeddingCache
from repro_torch.core.serving.replica import MissProfile


class RttMatrix:
    """Per-cell-pair one-way transfer times. Looks up (src, dst), then the
    symmetric (dst, src), then falls back to the scalar default — so a
    federation built with only `rtt_s` behaves exactly as before, and a
    partial matrix only needs the asymmetric / non-default pairs. Same-cell
    and front-door (src == "") hops are free."""

    def __init__(self, default_s: float,
                 pairs: Optional[Dict[Tuple[str, str], float]] = None):
        self.default_s = default_s
        self.pairs = dict(pairs or {})

    def __call__(self, src: str, dst: str) -> float:
        if not src or src == dst:
            return 0.0
        hit = self.pairs.get((src, dst))
        if hit is None:
            hit = self.pairs.get((dst, src))
        return self.default_s if hit is None else hit


# Fibonacci (golden-ratio) multiplicative hash: consecutive ids — the
# HOT ids of a rank-ordered Zipf stream — land on different shards
# instead of clustering, while staying a pure deterministic function
_HASH_MULT = 0x9E3779B1
_HASH_MASK = 0xFFFFFFFF


class EmbeddingShardService:
    """N embedding-table shards with home cells, batched fetch costing,
    versioned rows and hierarchy-wide invalidation. One instance serves
    a whole fleet: pass it to `ServingSystem(shard=...)` (standalone)
    or `FederatedSystem(shard=...)` (which hands it to every cell and
    binds its RTT matrix if none was given)."""

    def __init__(
        self,
        n_shards: int,
        placement: Tuple[str, ...] = (),
        *,
        rtt: Optional[RttMatrix] = None,
        invalidation: bool = True,
    ):
        if n_shards < 1:
            raise ValueError(f"need >= 1 shard, got {n_shards}")
        self.n_shards = n_shards
        self.placement = tuple(placement)
        self.rtt = rtt
        self.invalidation = invalidation
        self._versions: Dict[Hashable, int] = {}  # row -> published version
        self._caches: List[EmbeddingCache] = []  # invalidation fan-out order
        self.publishes = 0  # publish() calls (update events)
        self.updated_rows = 0  # rows whose version was bumped, cumulative
        self.invalidated_rows = 0  # resident rows dirtied across all caches
        # per serving cell: [local rows, remote rows, transit seconds]
        self._by_cell: Dict[str, List[float]] = {}

    # -- placement ---------------------------------------------------------

    def shard_of(self, key: Hashable) -> int:
        return (int(key) * _HASH_MULT & _HASH_MASK) % self.n_shards

    def home(self, shard: int) -> str:
        """The shard's home cell; "" (local everywhere) when no placement."""
        if not self.placement:
            return ""
        return self.placement[shard % len(self.placement)]

    # -- versions + invalidation ------------------------------------------

    def version_of(self, key: Hashable) -> int:
        """Published version of a row; 0 until first published."""
        return self._versions.get(key, 0)

    def register_cache(self, cache: EmbeddingCache) -> None:
        """Join a cache to the hierarchy: it starts versioning rows
        against this table and receives invalidations on publish.
        Registration order IS propagation order — the engine registers
        the cell L2 before the pool L1s, so updates walk shard -> L2 ->
        L1."""
        if cache.version_of is None:
            cache.version_of = self.version_of
        self._caches.append(cache)

    def publish(self, ids: Iterable[Hashable]) -> None:
        """One online table update: bump the published version of every
        row in `ids`. With invalidation on, registered caches mark
        resident copies dirty (next access refetches); with it off they
        keep serving superseded rows — counted in their `staleness`."""
        ids = tuple(ids)
        for i in ids:
            self._versions[i] = self._versions.get(i, 0) + 1
        self.publishes += 1
        self.updated_rows += len(ids)
        if self.invalidation:
            for cache in self._caches:
                self.invalidated_rows += cache.invalidate(ids)

    # -- fetch -------------------------------------------------------------

    def fetch(self, cell: str, ids: Iterable[Hashable]) -> MissProfile:
        """Serve one batch's post-L2 miss rows for a batch dispatched in
        `cell`. Rows from shards homed in `cell` (or unhomed) are local;
        the rest pay one rtt(cell, home) per distinct remote shard
        touched (per-shard fetch batching) in `transit_s`, on top of
        the per-row `embed_fetch_s` the replica charges for every
        fetched row. Returns the decomposition with `l2_hits=0` — the
        pool fills that in from its own L2 probe."""
        local = remote = 0
        remote_rtts: Dict[int, float] = {}
        for i in ids:
            s = self.shard_of(i)
            home = self.home(s)
            if not home or not cell or home == cell:
                local += 1
            else:
                remote += 1
                if s not in remote_rtts:
                    remote_rtts[s] = self.rtt(cell, home) if self.rtt is not None else 0.0
        transit = sum(remote_rtts.values())
        if local or remote:
            tally = self._by_cell.setdefault(cell, [0, 0, 0.0])
            tally[0] += local
            tally[1] += remote
            tally[2] += transit
        return MissProfile(l2_hits=0, local_rows=local, remote_rows=remote,
                           transit_s=transit)

    # -- signals + summaries ----------------------------------------------

    def predicted_transit_per_row(self, cell: str) -> float:
        """Expected inter-cell transit seconds per shard-fetched row for
        batches served in `cell`, learned from that cell's own fetch
        history — the remote leg of the routers' three-way predicted
        miss cost. 0 until the cell has fetched (a cold cell competes
        on dense cost alone, like the rows-per-item EWMA)."""
        local, remote, transit = self._by_cell.get(cell, (0, 0, 0.0))
        rows = local + remote
        return transit / rows if rows else 0.0

    def cell_stats(self, cell: str) -> Dict:
        """This cell's own fetch traffic (fleet rollups sum these
        without double counting)."""
        local, remote, transit = self._by_cell.get(cell, (0, 0, 0.0))
        return {
            "local_fetches": int(local),
            "remote_fetches": int(remote),
            "transit_s": float(transit),
        }

    def summary(self) -> Dict:
        local = sum(int(v[0]) for v in self._by_cell.values())
        remote = sum(int(v[1]) for v in self._by_cell.values())
        return {
            "n_shards": self.n_shards,
            "placement": self.placement,
            "invalidation": self.invalidation,
            "local_fetches": local,
            "remote_fetches": remote,
            "transit_s": float(sum(v[2] for v in self._by_cell.values())),
            "publishes": self.publishes,
            "updated_rows": self.updated_rows,
            "invalidated_rows": self.invalidated_rows,
            "versioned_rows": len(self._versions),
            # replay fingerprint: bit-identical runs publish bit-identical
            # version tables
            "version_sum": sum(self._versions.values()),
            "cells": {c: self.cell_stats(c) for c in sorted(self._by_cell)},
        }
