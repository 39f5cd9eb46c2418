"""Multi-tier hot-ID caching for the serving simulator.

Recommendation inference is dominated by sparse embedding lookups over
heavily Zipf-skewed ID popularity (DeepRecSys arXiv 2001.02772; the
cross-stack characterization in arXiv 2001.02772's companion studies):
a small resident cache of hot rows converts most memory-bound fetches
into near-free hits. This module is the simulator half of that memory
model — deterministic, pure-Python caches the serving stack wires
through replica -> pool -> cell:

    EmbeddingCache   capacity in ROWS; a pluggable eviction policy from
                     CACHE_POLICIES (lru / lfu / s3fifo) decides which
                     hot IDs stay resident. ReplicaPool owns one per
                     pool; each dispatched batch runs its requests' ids
                     through it and pays `ReplicaSpec.embed_fetch_s`
                     seconds per MISSED row on top of the dense service
                     time (replica.py) — so batch latency depends on the
                     live hit-rate, not just batch size.
    ResultCache      request-signature -> score TTL cache: a repeat
                     query whose ids signature is still fresh completes
                     immediately, bypassing batching and service.
    CacheConfig      everything a pool needs to bring both up
                     (PoolSpec.cache in engine.py).

The real-array counterpart (resident-table `embedding_bag` gather,
validated against kernels/embedding_bag/ref.py) lives in
`repro`'s core/caching.py; the port has no copy of it yet.

The shard tier (serving/shard.py) adds a second cache level and row
VERSIONS on top of the same policies: `CacheConfig.l2` describes one
shared per-cell L2 EmbeddingCache probed between a pool's L1 miss and
the shard fetch, and a cache constructed with (or later given) a
`version_of` callable tracks which published row version each resident
key was fetched at. `EmbeddingShardService.publish` bumps versions and
— with invalidation on — calls `invalidate(ids)` down the hierarchy
(shard -> L2 -> L1): an invalidated resident row is served as a MISS on
its next access (refetched in place, version refreshed). With
invalidation off the caches keep serving superseded rows; every such
serve increments the `staleness` counter, the number the staleness-vs-
hit-rate bench experiment sweeps.

Invariants: every policy is deterministic — same access stream, same
capacity => bit-identical hit/miss sequence, eviction order and final
resident set (the tests replay streams and compare `resident_keys()`).
No policy ever holds more than `capacity` keys. Stats counters
(hits/misses/evictions/staleness) are cumulative over the run;
`warm()` touches keys without counting, so a pre-warmed cache starts
at hit_rate 0/0. Invalidation never changes eviction order: the dirty
mark lives beside the policy, not inside it, so the policy sees the
exact same access stream either way. Times are seconds on the
event-loop clock; capacities are rows (ids).
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import OrderedDict, deque
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Set, Tuple


class CachePolicyBase:
    """One eviction policy over a fixed-capacity key set. Subclasses
    implement `access(key) -> bool` (True = hit; a miss ADMITS the key,
    evicting deterministically when full) and `resident_keys()`."""

    name = "base"

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"cache capacity must be >= 1 row, got {capacity}")
        self.capacity = capacity
        self.evictions = 0

    def access(self, key: Hashable) -> bool:
        raise NotImplementedError

    def resident_keys(self) -> Tuple:
        """Resident set in a policy-defined deterministic order."""
        raise NotImplementedError

    def __contains__(self, key: Hashable) -> bool:
        """Residency check with NO side effects (no recency/frequency
        touch, no admission) — what invalidation probes."""
        raise NotImplementedError

    def __len__(self) -> int:
        return len(self.resident_keys())


class LRUCache(CachePolicyBase):
    """Least-recently-used: evict the key untouched for longest."""

    name = "lru"

    def __init__(self, capacity: int) -> None:
        super().__init__(capacity)
        self._od: "OrderedDict[Hashable, None]" = OrderedDict()

    def access(self, key: Hashable) -> bool:
        if key in self._od:
            self._od.move_to_end(key)
            return True
        if len(self._od) >= self.capacity:
            self._od.popitem(last=False)
            self.evictions += 1
        self._od[key] = None
        return False

    def resident_keys(self) -> Tuple:
        return tuple(self._od)  # LRU -> MRU order

    def __contains__(self, key: Hashable) -> bool:
        return key in self._od


class LFUCache(CachePolicyBase):
    """Least-frequently-used with FIFO tie-break (older entry evicted
    first at equal frequency). Lazy heap: stale entries are skipped at
    eviction time, so access stays O(log n)."""

    name = "lfu"

    def __init__(self, capacity: int) -> None:
        super().__init__(capacity)
        self._freq: Dict[Hashable, Tuple[int, int]] = {}  # key -> (freq, seq)
        self._heap: list = []  # (freq, seq, key), lazily invalidated
        self._seq = itertools.count()

    def _compact(self) -> None:
        # hot-heavy streams push a heap entry per HIT and stale ones only
        # leave at eviction time — rebuild before the heap outgrows a few
        # multiples of capacity so memory tracks capacity, not stream length
        if len(self._heap) > 8 * self.capacity:
            self._heap = [(f, s, k) for k, (f, s) in self._freq.items()]
            heapq.heapify(self._heap)

    def access(self, key: Hashable) -> bool:
        if key in self._freq:
            freq, seq = self._freq[key]
            self._freq[key] = (freq + 1, seq)
            heapq.heappush(self._heap, (freq + 1, seq, key))
            self._compact()
            return True
        if len(self._freq) >= self.capacity:
            while True:  # pop until a live (freq, seq) entry surfaces
                freq, seq, victim = heapq.heappop(self._heap)
                if self._freq.get(victim) == (freq, seq):
                    del self._freq[victim]
                    self.evictions += 1
                    break
        entry = (1, next(self._seq))
        self._freq[key] = entry
        heapq.heappush(self._heap, (*entry, key))
        self._compact()
        return False

    def resident_keys(self) -> Tuple:
        # (freq asc, insertion seq asc): eviction order, coldest first
        return tuple(sorted(self._freq, key=self._freq.__getitem__))

    def __contains__(self, key: Hashable) -> bool:
        return key in self._freq


class S3FifoCache(CachePolicyBase):
    """S3-FIFO-style: a small probationary FIFO (~10% of capacity)
    absorbs one-hit wonders, keys re-referenced there graduate to the
    main FIFO, and a ghost FIFO of recently evicted keys fast-tracks
    comebacks straight into main. Main eviction gives one second chance
    to keys touched since insertion (capped frequency counter)."""

    name = "s3fifo"

    def __init__(self, capacity: int) -> None:
        super().__init__(capacity)
        if capacity < 2:
            # one row can't split into probationary + main tiers; letting
            # both tiers default to 1 would hold 2 keys and break the
            # "never more than capacity" invariant
            raise ValueError("s3fifo needs capacity >= 2 rows (small + main tier)")
        self._small_cap = max(1, capacity // 10)
        self._main_cap = capacity - self._small_cap
        self._small: "deque[Hashable]" = deque()
        self._main: "deque[Hashable]" = deque()
        self._where: Dict[Hashable, str] = {}  # key -> "small" | "main"
        self._freq: Dict[Hashable, int] = {}
        # ghost records carry a stamp so a key re-ghosted after a comeback
        # is tracked by its NEWEST record: popping a stale older record
        # must not cancel the live one's comeback eligibility
        self._ghost: "deque[Tuple[Hashable, int]]" = deque()
        self._ghost_live: Dict[Hashable, int] = {}  # key -> live stamp
        self._stamp = itertools.count()

    def _remember_ghost(self, key: Hashable) -> None:
        while len(self._ghost) >= self.capacity:
            gone, stamp = self._ghost.popleft()
            if self._ghost_live.get(gone) == stamp:
                del self._ghost_live[gone]
        stamp = next(self._stamp)
        self._ghost.append((key, stamp))
        self._ghost_live[key] = stamp

    def _evict_main(self) -> None:
        while True:
            victim = self._main.popleft()
            if self._freq.get(victim, 0) > 0:  # second chance
                self._freq[victim] -= 1
                self._main.append(victim)
                continue
            del self._where[victim]
            self._freq.pop(victim, None)
            self.evictions += 1
            return

    def _insert_main(self, key: Hashable) -> None:
        if len(self._main) >= self._main_cap:
            self._evict_main()
        self._main.append(key)
        self._where[key] = "main"
        self._freq[key] = 0

    def _evict_small(self) -> None:
        victim = self._small.popleft()
        del self._where[victim]
        if self._freq.pop(victim, 0) > 0:
            self._insert_main(victim)  # re-referenced: graduate
        else:
            self._remember_ghost(victim)
            self.evictions += 1

    def access(self, key: Hashable) -> bool:
        if key in self._where:
            self._freq[key] = min(self._freq.get(key, 0) + 1, 3)
            return True
        if key in self._ghost_live:  # comeback: straight into main
            del self._ghost_live[key]
            self._insert_main(key)
            return False
        if len(self._small) >= self._small_cap:
            self._evict_small()
        self._small.append(key)
        self._where[key] = "small"
        self._freq[key] = 0
        return False

    def resident_keys(self) -> Tuple:
        return tuple(self._small) + tuple(self._main)  # FIFO order per tier

    def __contains__(self, key: Hashable) -> bool:
        return key in self._where


CACHE_POLICIES: Dict[str, type] = {
    LRUCache.name: LRUCache,
    LFUCache.name: LFUCache,
    S3FifoCache.name: S3FifoCache,
}


def make_cache_policy(name: str, capacity: int) -> CachePolicyBase:
    try:
        return CACHE_POLICIES[name](capacity)
    except KeyError:
        raise KeyError(
            f"unknown cache policy {name!r}; have {sorted(CACHE_POLICIES)}"
        ) from None


@dataclasses.dataclass
class CacheConfig:
    """Per-pool cache knobs (PoolSpec.cache). `capacity_rows` bounds the
    embedding cache in resident ID rows; `result_capacity`/`result_ttl_s`
    bring up the request-signature ResultCache (0 disables it). `l2`
    describes the CELL-level cache: one shared EmbeddingCache built by
    the ServingSystem from this nested config and probed by every pool
    in the cell between its own L1 miss and the shard fetch. All pools
    that set `l2` within one cell must agree on (capacity_rows, policy)
    — there is exactly one L2 per cell (engine.py enforces this)."""

    capacity_rows: int
    policy: str = "lru"
    result_capacity: int = 0
    result_ttl_s: float = 1.0
    l2: Optional["CacheConfig"] = None


class EmbeddingCache:
    """Hot-ID row cache: `lookup(ids)` runs one request's embedding ids
    through the policy and returns (hits, misses); missed rows are
    admitted (fetch-on-miss). Cumulative hit/miss counters feed the
    pool's metrics and the routers' predicted miss cost.

    Versioning (shard tier): with a `version_of` callable bound — the
    shard service binds its own via `register_cache` — each fetch
    (miss) records the row's published version. A later `invalidate`
    marks resident copies dirty: the next access serves them as a MISS
    (refetch in place; the policy still sees a hit, so eviction order
    is untouched and bit-identical with invalidation on or off). A
    clean hit whose recorded version is superseded bumps `staleness` —
    the count of stale serves, i.e. what users see when invalidation
    is off or hasn't reached this tier."""

    def __init__(
        self,
        capacity_rows: int,
        policy: str = "lru",
        *,
        version_of: Optional[Callable[[Hashable], int]] = None,
    ) -> None:
        self.impl = make_cache_policy(policy, capacity_rows)
        self.policy = policy
        self.capacity_rows = capacity_rows
        self.version_of = version_of
        self.hits = 0
        self.misses = 0
        self.staleness = 0  # serves of a superseded row version
        self.invalidated = 0  # resident rows marked dirty, cumulative
        self._ver: Dict[Hashable, int] = {}  # key -> version at fetch
        self._dirty: Set[Hashable] = set()  # resident but superseded

    def access(self, key: Hashable) -> bool:
        """One id through the policy + version layer; True = hit. An
        invalidated resident row reports a miss (the refetch) even
        though the policy keeps it resident; a clean hit on a
        superseded version counts one stale serve."""
        hit = self.impl.access(key)
        if hit and key in self._dirty:
            hit = False  # invalidated: refetch the row in place
        if hit:
            if self.version_of is not None and self._ver.get(key, 0) != self.version_of(key):
                self.staleness += 1
            self.hits += 1
        else:
            self._dirty.discard(key)
            if self.version_of is not None:
                self._ver[key] = self.version_of(key)
                # _ver tracks fetch versions for resident keys only; prune
                # it (deterministically, against the policy's resident set)
                # before it outgrows a few multiples of capacity
                if len(self._ver) > 8 * self.capacity_rows:
                    resident = set(self.impl.resident_keys())
                    self._ver = {k: v for k, v in self._ver.items() if k in resident}
            self.misses += 1
        return hit

    def lookup(self, ids: Iterable[Hashable]) -> Tuple[int, int]:
        hits = misses = 0
        for i in ids:
            if self.access(i):
                hits += 1
            else:
                misses += 1
        return hits, misses

    def lookup_misses(self, ids: Iterable[Hashable]) -> Tuple[int, List[Hashable]]:
        """Like `lookup` but returns the missed ids themselves, in
        access order — the rows the next tier down (cell L2, then the
        shard service) must serve."""
        hits = 0
        missed: List[Hashable] = []
        for i in ids:
            if self.access(i):
                hits += 1
            else:
                missed.append(i)
        return hits, missed

    def invalidate(self, ids: Iterable[Hashable]) -> int:
        """Mark resident copies of `ids` superseded (shard publish with
        invalidation on): their next access refetches in place. Only
        resident rows are marked — non-resident ids would miss anyway —
        so the dirty set stays bounded by capacity. Idempotent; returns
        the rows newly marked."""
        marked = 0
        for i in ids:
            if i in self.impl and i not in self._dirty:
                self._dirty.add(i)
                marked += 1
        self.invalidated += marked
        return marked

    def warm(self, ids: Iterable[Hashable]) -> None:
        """Pre-load ids without touching the hit/miss counters — a warmed
        cache starts the run resident but statistically clean. Warmed
        rows record the current published version."""
        for i in ids:
            if not self.impl.access(i) and self.version_of is not None:
                self._ver[i] = self.version_of(i)

    @property
    def hit_rate(self) -> float:
        seen = self.hits + self.misses
        return self.hits / seen if seen else 0.0

    @property
    def evictions(self) -> int:
        return self.impl.evictions

    def resident_keys(self) -> Tuple:
        return self.impl.resident_keys()

    def stats(self) -> Dict:
        return {
            "policy": self.policy,
            "capacity_rows": self.capacity_rows,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
            "evictions": self.evictions,
            "resident_rows": len(self.impl),
            "staleness": self.staleness,
            "invalidated": self.invalidated,
        }


class ResultCache:
    """Request-signature -> result TTL cache. A repeat query whose
    signature (its ids tuple) was completed within `ttl_s` is served
    from cache — the pool completes it immediately, no batching, no
    service time. LRU over `capacity` signatures; expired entries are
    dropped on get. Deterministic: eviction and expiry depend only on
    the (now, key) call sequence."""

    def __init__(self, capacity: int, ttl_s: float) -> None:
        if capacity < 1:
            raise ValueError(f"result cache capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.ttl_s = ttl_s
        self._od: "OrderedDict[Hashable, Tuple[float, object]]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, now: float, key: Hashable) -> Optional[object]:
        """The cached value, or None on miss/expiry."""
        entry = self._od.get(key)
        if entry is not None and now - entry[0] <= self.ttl_s:
            self._od.move_to_end(key)
            self.hits += 1
            return entry[1]
        if entry is not None:  # expired: drop so capacity isn't held hostage
            del self._od[key]
        self.misses += 1
        return None

    def put(self, now: float, key: Hashable, value: object = True) -> None:
        if key in self._od:
            self._od.move_to_end(key)
        elif len(self._od) >= self.capacity:
            self._od.popitem(last=False)
        self._od[key] = (now, value)

    def __len__(self) -> int:
        return len(self._od)
