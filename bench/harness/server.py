"""The server loop: one thread, no batching window.

Each pass takes every request that is due, whole requests only, in order,
up to `max_rows` candidate rows; builds the batch on the device (a
request's user, history and `hist_len` repeated over its candidates' rows,
the rows of one request contiguous, `req` the index of each row's request
within the call); calls `api.serve`; copies the scores to the host, which
waits for the device; and stamps every request of the call complete.

Times are seconds from the window's start on `time.perf_counter`. Each
call keeps five stamps: the pass began (t0), work was found due (t1),
the batch was built (t2), `serve` returned (t3), the scores were on the
host (t4).
"""
from __future__ import annotations

import time
from typing import List, Optional

import numpy as np

from harness.traffic import Requests

SPIN_S = 0.002  # closer than this to a due time the loop spins instead of sleeping


class Server:
    def __init__(self, api, params, cfg, req: Requests, max_rows: int):
        self.api, self.params, self.cfg, self.req = api, params, cfg, req
        self.max_rows = max_rows
        self.due = np.full(req.count, np.nan)
        self.done = np.full(req.count, np.nan)
        self.scores = np.full(int(req.offsets[-1]), np.nan, np.float32)
        self.calls: List[tuple] = []  # (t0, t1, t2, t3, t4, first request, end request)
        self.t_origin = time.perf_counter()

    def now(self) -> float:
        return time.perf_counter() - self.t_origin

    def wait_until(self, t: float) -> None:
        while True:
            left = t - self.now()
            if left <= 0:
                return
            if left > SPIN_S:
                time.sleep(left - SPIN_S / 2)

    def take(self, i: int, j: int) -> int:
        """The end of the whole requests from i (at most j) that fit in
        `max_rows` rows; at least one."""
        off = self.req.offsets
        k = int(np.searchsorted(off, off[i] + self.max_rows, side="right")) - 1
        return max(i + 1, min(j, k))

    def batch(self, i: int, j: int) -> dict:
        r = self.req
        a, b = int(r.offsets[i]), int(r.offsets[j])
        rows = r.cand_req[a:b]
        return {
            "user": r.user[rows], "item": r.item[a:b], "category": r.category[a:b],
            "hist_item": r.hist_item[rows], "hist_category": r.hist_category[rows],
            "hist_len": r.hist_len[rows], "req": rows - i,
        }

    def call(self, t0: float, t1: float, i: int, j: int) -> None:
        batch = self.batch(i, j)
        t2 = self.now()
        scores = self.api.serve(self.params, batch, self.cfg)
        t3 = self.now()
        host = scores.to("cpu")
        t4 = self.now()
        self.done[i:j] = t4
        self.scores[self.req.offsets[i]:self.req.offsets[j]] = host.numpy()
        self.calls.append((t0, t1, t2, t3, t4, i, j))

    def open_loop(self, arrival: np.ndarray, first: int, seconds: float, drain_s: float) -> int:
        """Serve requests first, first + 1, ... due at `arrival` (seconds
        from the window's start) until every one is served or the drain
        ends `drain_s` after the window; returns the end of those served."""
        end = first + len(arrival)
        self.due[first:end] = arrival
        self.t_origin = time.perf_counter()
        i = first
        while i < end:
            t0 = self.now()
            if t0 > seconds + drain_s:
                break
            if self.due[i] > t0:
                self.wait_until(self.due[i])
            t1 = self.now()
            j = first + int(np.searchsorted(arrival, t1, side="right"))
            j = self.take(i, min(j, end))
            self.call(t0, t1, i, j)
            i = j
        return i

    def closed_loop(self, clients: int, first: int, end: int, seconds: float,
                    drain_s: float) -> int:
        """`clients` callers, each sending its next request the moment its
        last one is answered, from request `first` on, for `seconds`; then
        the requests already sent are served (until `drain_s` after the
        window). Requests complete in order, so the k-th answer sends
        request first + clients + k. Raises if the window needs more
        requests than `end`."""
        self.t_origin = time.perf_counter()
        sent = min(end, first + clients)
        self.due[first:sent] = 0.0
        i = first
        while i < sent:
            t0 = self.now()
            if t0 > seconds + drain_s:
                break
            j = self.take(i, sent)
            self.call(t0, t0, i, j)
            t4 = self.calls[-1][4]
            if t4 < seconds:
                new = min(end, sent + (j - i))
                if new - sent < j - i:
                    raise RuntimeError(f"the window ran out of requests after {end - first}: "
                                       "raise the cell's provision_per_s")
                self.due[sent:new] = t4
                sent = new
            i = j
        return i


def warm_shapes(server: Server, first: int, end: int, top_rows: Optional[int] = None) -> int:
    """One call at each of a ladder of row counts from the mix's smallest
    request to `top_rows` (the most a call of the cell's loop can hold;
    `max_rows` by default), on whole requests from `first`, so that the
    window finds every library kernel its sizes choose already loaded;
    returns the first request left unused."""
    top = min(server.max_rows, top_rows or server.max_rows)
    sizes = sorted({int(round(x)) for x in np.geomspace(1, top, 48)})
    off = server.req.offsets
    i = first
    for rows in sizes:
        k = int(np.searchsorted(off, off[i] + rows, side="right")) - 1
        if k <= i:
            continue
        if k >= end:
            break
        server.call(0.0, 0.0, i, k)
        i = k
    return i
