"""Discrete-event kernel for the serving simulator — the fast path.

Public API
    EventLoop.on(kind, handler)   register ONE handler per event kind
                                  (a second registration raises)
    EventLoop.push(t, kind, payload=None)   schedule an event
    EventLoop.add_stream(kind, events)      lazily merge a PRE-SORTED
                                  (t, payload) stream into the loop —
                                  O(1) pending memory per stream instead
                                  of one heap entry per arrival
    EventLoop.run()               drain queue + streams in time order
    EventLoop.now                 the clock, in seconds
    EventLoop.processed           events dispatched so far
    EventLoop.dropped_events / dropped_kinds
                                  events whose kind had no handler (the
                                  seed kernel skipped these SILENTLY);
                                  with strict=True the loop raises instead

Two pending-event stores implement one ordering contract:

    HeapScheduler      the seed kernel's single binary heap of
                       (t, seq, kind, payload) — O(log n) in ALL pending
                       events. Kept as the reference implementation for
                       the determinism tests and the bench_engine
                       baseline ("the pre-PR kernel").
    CalendarScheduler  calendar-queue / bucketed scheduler (the default):
                       events inside the CURRENT time window live in a
                       columnar numpy argmin store (_ArgminWindow);
                       later events append O(1) into per-window buckets
                       keyed by integer window index (a lazy min-heap
                       over occupied indices finds the next window).
                       Near-O(1) push/pop for the mostly monotone
                       streams pools generate, because the window holds
                       only the events of one bucket width — not the
                       whole simulation's backlog — and its minimum is
                       one vectorized scan, not per-event tuple sifting.

Ordering invariant (both schedulers, bit-exact): events fire in
(time, push-order) — FIFO within equal timestamps, so replaying the same
pushes yields a bit-identical run (payloads are never compared; the
monotone sequence number breaks ties). Out-of-band pushes — a handler
scheduling work at or before times already buffered — land in the
current window heap and keep exact heap semantics.

Arrival streams: `add_stream` registers a time-sorted iterator that the
run loop merges lazily — only each stream's HEAD event exists in memory,
so a million-arrival trace costs O(1) pending state instead of a
million heap tuples. At equal timestamps a stream event fires before any
queued event, which reproduces the seed semantics of pushing the whole
arrival list before arming periodic events (arrivals held the lowest
sequence numbers). Streams must be non-decreasing in time; a backwards
step raises.

The loop has no horizon of its own: periodic handlers stop rescheduling
themselves past theirs, while in-flight completions always run, so no
admitted work is ever lost at the end of a simulation. All times are in
seconds.
"""
from __future__ import annotations

import heapq
import itertools
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

# one pending event: (time, push-order, kind, payload)
Entry = Tuple[float, int, str, object]


class HeapScheduler:
    """Single binary heap of (t, seq, kind, payload) — the seed kernel's
    store. O(log n) push/pop with n = all pending events; the calendar
    queue replaces it on the hot path, but it stays as the reference
    ordering (determinism tests replay against it) and the bench_engine
    baseline."""

    __slots__ = ("_heap",)

    def __init__(self) -> None:
        self._heap: List[Entry] = []

    def __len__(self) -> int:
        return len(self._heap)

    def push(self, entry: Entry) -> None:
        heapq.heappush(self._heap, entry)

    def peek(self) -> Optional[Entry]:
        return self._heap[0] if self._heap else None

    def pop(self) -> Entry:
        return heapq.heappop(self._heap)


class _ArgminWindow:
    """CalendarScheduler's current-window store: columnar (t, seq) numpy
    arrays aligned with an entry list, served by a vectorized argmin
    instead of heap sifting. A window holds one bucket's worth of events
    (~MAX_BUCKET/4 after a shrink), so the O(n) scan is one contiguous
    float compare over a small array — cheaper in practice than the
    pointer-chasing tuple comparisons heappush/heappop do per event.

    Order contract (bit-exact vs the binary heap): the minimum is the
    entry with the least (t, seq) — np.argmin finds the earliest time,
    and ties on t resolve by the least sequence number (seq is unique,
    so the pair is a total order; kind/payload never participate, same
    as the heap where seq always breaks the tie first).

    The argmin slot is cached: a push keeps the cache valid by comparing
    the new entry against the cached minimum; a pop swap-deletes the
    minimum with the last slot (clearing the popped reference) and
    invalidates the cache, so a peek/pop pair costs one scan."""

    __slots__ = ("_t", "_seq", "_entries", "_n", "_min")

    def __init__(self, entries: Optional[List[Entry]] = None) -> None:
        n = len(entries) if entries else 0
        cap = max(16, n)
        self._t = np.empty(cap, dtype=np.float64)
        self._seq = np.empty(cap, dtype=np.int64)
        self._entries: List[Optional[Entry]] = [None] * cap
        if entries:
            for i, e in enumerate(entries):
                self._t[i] = e[0]
                self._seq[i] = e[1]
                self._entries[i] = e
        self._n = n
        self._min = -1  # cached argmin slot; -1 = unknown

    def __len__(self) -> int:
        return self._n

    def __iter__(self) -> Iterator[Entry]:
        return iter(self._entries[: self._n])

    def push(self, entry: Entry) -> None:
        n = self._n
        if n == len(self._entries):
            grown_t = np.empty(2 * n, dtype=np.float64)
            grown_t[:n] = self._t
            self._t = grown_t
            grown_seq = np.empty(2 * n, dtype=np.int64)
            grown_seq[:n] = self._seq
            self._seq = grown_seq
            self._entries.extend([None] * n)
        self._t[n] = entry[0]
        self._seq[n] = entry[1]
        self._entries[n] = entry
        self._n = n + 1
        m = self._min
        if m >= 0:
            tm = self._t[m]
            if entry[0] < tm or (entry[0] == tm and entry[1] < self._seq[m]):
                self._min = n
        elif n == 0:
            self._min = 0

    def _argmin(self) -> int:
        t = self._t[: self._n]
        i = int(np.argmin(t))
        ties = np.flatnonzero(t == t[i])
        if len(ties) > 1:
            i = int(ties[np.argmin(self._seq[ties])])
        self._min = i
        return i

    def peek(self) -> Entry:
        m = self._min
        if m < 0:
            m = self._argmin()
        return self._entries[m]

    def pop(self) -> Entry:
        m = self._min
        if m < 0:
            m = self._argmin()
        entry = self._entries[m]
        last = self._n - 1
        if m != last:
            self._t[m] = self._t[last]
            self._seq[m] = self._seq[last]
            self._entries[m] = self._entries[last]
        self._entries[last] = None  # drop the popped reference
        self._n = last
        self._min = -1
        return entry


class CalendarScheduler:
    """Calendar-queue scheduler: a small current-window argmin store +
    unsorted future buckets.

    Routing happens entirely in integer bucket-index space: an event's
    index is int(t / width), and the window covers every index up to
    `_win_idx` inclusive. An event at or before the window index joins
    the window's argmin store (exact order kept, including out-of-band
    pushes at or before `now`); a later event APPENDS to its index's
    bucket — O(1) — creating the bucket (and registering its index in a
    min-heap) on first use. Comparing indices, not float boundary times,
    matters: fp division can round t/width UP across a bucket boundary,
    and an equal-time pair split across the boundary by a float
    `t < win_end` test would fire out of push order. int(t/width) is
    monotone in t, so index order is time order and equal times always
    share one container.

    Pop/peek: serve the window's (t, seq) minimum via _ArgminWindow's
    vectorized scan; when the window drains, promote the earliest
    occupied bucket — pop its index, wrap its entries as the new window
    (O(bucket)), and advance `_win_idx` to it.

    Total order is EXACTLY the binary heap's (time, push-order): every
    bucketed event's index exceeds `_win_idx` (so its time is >= every
    window event's), buckets promote in index order, and the window
    serves by least (t, seq).

    Width adapts downward only, deterministically: when a promoted bucket
    exceeds MAX_BUCKET entries the width shrinks (targeting ~MAX_BUCKET/4
    per window) and the remaining buckets are rebuilt under the new width
    — O(pending), amortised by the pops that filled the bucket. Sparse
    streams degrade gracefully without growing the width: singleton
    buckets make the index heap behave like the plain binary heap."""

    __slots__ = ("_width", "_win", "_win_idx", "_buckets", "_indices", "_len")

    MAX_BUCKET = 4096
    MIN_WIDTH = 1e-9

    def __init__(self, width: float = 0.05) -> None:
        self._width = width
        self._win = _ArgminWindow()  # current window (exact order)
        self._win_idx = 0  # window covers every index <= this (past stays exact)
        self._buckets: Dict[int, List[Entry]] = {}
        self._indices: List[int] = []  # min-heap of occupied bucket indices
        self._len = 0

    def __len__(self) -> int:
        return self._len

    def push(self, entry: Entry) -> None:
        self._len += 1
        idx = int(entry[0] / self._width)
        if idx <= self._win_idx:
            self._win.push(entry)
            return
        bucket = self._buckets.get(idx)
        if bucket is None:
            self._buckets[idx] = [entry]
            heapq.heappush(self._indices, idx)
        else:
            bucket.append(entry)

    def _promote(self) -> None:
        """Move the earliest occupied bucket into the (empty) window."""
        idx = heapq.heappop(self._indices)
        bucket = self._buckets.pop(idx)
        self._win = _ArgminWindow(bucket)
        self._win_idx = idx
        if len(bucket) > self.MAX_BUCKET and self._width > self.MIN_WIDTH:
            self._shrink(len(bucket))

    def _shrink(self, occupancy: int) -> None:
        """Events cluster denser than the bucket width: narrow it for the
        still-bucketed future and rebucket. Deterministic — a pure
        function of the push/pop history."""
        self._width = max(
            self._width * (self.MAX_BUCKET / (4.0 * occupancy)), self.MIN_WIDTH
        )
        # the just-promoted window spans several new-width indices; the
        # window threshold becomes the LAST of them, and pending events
        # at or before it must JOIN the window heap — left in a bucket,
        # they (and later equal-time pushes routed by the new width)
        # would fire after window events with greater times
        self._win_idx = max(int(e[0] / self._width) for e in self._win)
        pending = [e for b in self._buckets.values() for e in b]
        self._buckets.clear()
        self._indices.clear()
        for entry in pending:
            idx = int(entry[0] / self._width)
            if idx <= self._win_idx:
                self._win.push(entry)
            elif (bucket := self._buckets.get(idx)) is None:
                self._buckets[idx] = [entry]
                heapq.heappush(self._indices, idx)
            else:
                bucket.append(entry)

    def peek(self) -> Optional[Entry]:
        if not self._win:
            if not self._indices:
                return None
            self._promote()
        return self._win.peek()

    def pop(self) -> Entry:
        if not self._win:
            self._promote()
        self._len -= 1
        return self._win.pop()


SCHEDULERS = {"heap": HeapScheduler, "calendar": CalendarScheduler}


class _Stream:
    """A lazily-consumed, time-sorted (t, payload) event source: only the
    head event is materialised. `t` is +inf once exhausted."""

    __slots__ = ("kind", "t", "payload", "_it")

    def __init__(self, kind: str,
                 events: Iterable[Tuple[float, object]]) -> None:
        self.kind = kind
        self._it: Iterator[Tuple[float, object]] = iter(events)
        self.t = float("-inf")
        self.payload: object = None
        self.advance()

    def advance(self) -> None:
        prev = self.t
        try:
            self.t, self.payload = next(self._it)
        except StopIteration:
            self.t = float("inf")
            self.payload = None
            return
        if self.t < prev:
            raise ValueError(
                f"arrival stream {self.kind!r} is not time-sorted: "
                f"{self.t} after {prev}"
            )


class EventLoop:
    def __init__(self, scheduler: str = "calendar",
                 strict: bool = False) -> None:
        try:
            self._sched = SCHEDULERS[scheduler]()
        except KeyError:
            raise ValueError(
                f"unknown scheduler {scheduler!r}; one of {sorted(SCHEDULERS)}"
            ) from None
        self.scheduler = scheduler
        self._seq = itertools.count()
        self._handlers: Dict[str, Callable[[float, object], None]] = {}
        self._streams: List[_Stream] = []
        self.strict = strict
        self.now = 0.0
        self.processed = 0  # events dispatched (handled or dropped)
        self.dropped_events = 0  # events whose kind had no handler
        self.dropped_kinds: Dict[str, int] = {}
        self._queue_dirty = False  # a push may outrun run()'s cached head

    def on(self, kind: str, handler: Callable[[float, object], None]) -> None:
        """Register the handler for an event kind (one handler per kind)."""
        if kind in self._handlers:
            raise ValueError(f"handler already registered for event kind {kind!r}")
        self._handlers[kind] = handler

    def push(self, t: float, kind: str, payload: object = None) -> None:
        self._sched.push((t, next(self._seq), kind, payload))
        # run() caches the queue head while draining a stream; any push may
        # schedule ahead of the cached head, so flag it for a re-peek
        self._queue_dirty = True

    def add_stream(self, kind: str, events: Iterable[Tuple[float, object]]) -> None:
        """Merge a pre-sorted (t, payload) stream into the loop lazily.
        Only the stream's head event is held in memory; at equal
        timestamps stream events fire before queued events (matching the
        seed semantics of pushing every arrival before any periodic
        event), and earlier-added streams win ties between streams."""
        stream = _Stream(kind, events)
        if stream.t != float("inf"):
            self._streams.append(stream)

    def _drop(self, t: float, kind: str) -> None:
        """An event fired with no registered handler. The seed kernel
        skipped these SILENTLY; now they are counted (dropped_events /
        dropped_kinds feed ServingSystem.summary()) and a strict loop —
        what the tests run — raises instead."""
        if self.strict:
            raise KeyError(
                f"no handler registered for event kind {kind!r} at "
                f"t={t:.6f} (strict event loop)"
            )
        self.dropped_events += 1
        self.dropped_kinds[kind] = self.dropped_kinds.get(kind, 0) + 1

    def run(self) -> float:
        """Drain queued events and arrival streams in (time, push-order);
        returns the time of the last event processed. The loop itself has
        no horizon — periodic handlers (scale ticks) stop rescheduling
        themselves past theirs, while in-flight service completions
        always run so no work is lost."""
        sched = self._sched
        handlers = self._handlers
        streams = self._streams
        inf = float("inf")
        processed = 0
        while streams:  # merge arrival streams with the queue
            s = streams[0]
            if len(streams) > 1:
                for cand in streams:
                    if cand.t < s.t:
                        s = cand
            if s.t == inf:
                # every stream is exhausted: fall to the stream-free loop
                streams.clear()
                break
            # other streams' heads are static while this one drains; the
            # queue head is cached and re-peeked only when a push lands
            # (the _queue_dirty flag) or a queue event is consumed — so
            # the common case costs no peek at all. Ties BETWEEN streams
            # go to the earliest-added one (the seed pushed stream 0's
            # events first, so they hold the lower sequence numbers):
            # s may drain through a tie with t_other only when it was
            # added before the first other stream holding that head time.
            t_other = inf
            stop_at_tie = False
            seen_s = False
            for c in streams:
                if c is s:
                    seen_s = True
                elif c.t < t_other:
                    t_other = c.t
                    stop_at_tie = not seen_s
            kind_s, it = s.kind, s._it
            handler_s = handlers.get(kind_s)  # constant per stream: hoisted
            t_s, payload_s = s.t, s.payload
            head = sched.peek()
            t_q = head[0] if head is not None else inf
            self._queue_dirty = False
            while True:
                if t_s <= t_q:
                    if t_s > t_other or (stop_at_tie and t_s == t_other):
                        break  # another stream's head is due: switch
                    self.now = t_s
                    processed += 1
                    if handler_s is not None:
                        handler_s(t_s, payload_s)
                    else:
                        self._drop(t_s, kind_s)
                    nxt = next(it, None)
                    if nxt is None:
                        t_s, payload_s = inf, None
                        break
                    t_prev = t_s
                    t_s, payload_s = nxt
                    if t_s < t_prev:
                        s.t, s.payload = t_s, payload_s
                        raise ValueError(
                            f"arrival stream {kind_s!r} is not time-sorted: "
                            f"{t_s} after {t_prev}"
                        )
                else:
                    if t_q >= t_other:
                        break  # another stream's head is due first (ties
                        # between a stream and the queue go to the stream)
                    t, _, kind, payload = sched.pop()
                    self.now = t
                    processed += 1
                    handler = handlers.get(kind)
                    if handler is not None:
                        handler(t, payload)
                    else:
                        self._drop(t, kind)
                    self._queue_dirty = True  # pop moved the head: re-peek
                if self._queue_dirty:
                    head = sched.peek()
                    t_q = head[0] if head is not None else inf
                    self._queue_dirty = False
            s.t, s.payload = t_s, payload_s  # sync the head back
        while len(sched):  # stream-free fast path
            t, _, kind, payload = sched.pop()
            self.now = t
            processed += 1
            handler = handlers.get(kind)
            if handler is not None:
                handler(t, payload)
            else:
                self._drop(t, kind)
        self.processed += processed
        return self.now
