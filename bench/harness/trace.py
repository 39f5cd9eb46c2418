"""The device's activity in the window, from `torch.profiler`'s trace.

Only device activity is traced (kernels, copies, sets: CUPTI through
Kineto); the harness's own host spans stay on its clock, as the server's
call stamps, so the host is not slowed further. Kineto stamps device
activity in nanoseconds of the wall clock (`time.time_ns`); the server's
stamps are mapped onto it by an offset read at the window's start, and
the copy of each call's scores to the host checks the mapping: it ends
just before the host sees the scores.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


def clock_offset_ns() -> int:
    """time.time_ns() - time.perf_counter_ns(), the narrowest of a few reads."""
    best = None
    for _ in range(9):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w - (a + b) // 2)
    return best[1]


@dataclasses.dataclass
class DeviceTrace:
    """Device intervals in seconds from the window's start."""
    start: np.ndarray
    end: np.ndarray
    names: List[str]
    kinds: List[str]  # "kernel", "memcpy", "memset", ...

    def busy_union(self) -> np.ndarray:
        """The union of every interval: [k, 2] sorted, disjoint."""
        return union(np.stack([self.start, self.end], axis=1))


def union(iv: np.ndarray) -> np.ndarray:
    if len(iv) == 0:
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    run_end = np.maximum.accumulate(iv[:, 1])
    starts = np.ones(len(iv), bool)
    starts[1:] = iv[1:, 0] > run_end[:-1]
    first = np.flatnonzero(starts)
    last = np.r_[first[1:] - 1, len(iv) - 1]
    return np.stack([iv[first, 0], run_end[last]], axis=1)


def overlap(a: np.ndarray, b: np.ndarray) -> float:
    """Total length of the intersection of two disjoint sorted interval sets."""
    if len(a) == 0 or len(b) == 0:
        return 0.0
    pts = np.concatenate([a.ravel(), b.ravel()])
    marks = np.concatenate([np.tile([1, -1], len(a)), np.tile([1, -1], len(b))])
    order = np.lexsort((marks, pts))  # a close sorts before an open at the same time
    pts, depth = pts[order], np.cumsum(marks[order])
    return float(np.sum(np.diff(pts)[depth[:-1] == 2]))


def clip(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    iv = np.clip(iv, lo, hi)
    return iv[iv[:, 1] > iv[:, 0]]


class Profiler:
    """`with Profiler(on):` traces the device's activity when `on`."""

    def __init__(self, on: bool):
        self.on, self.prof = on, None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile
            self.prof = profile(activities=[ProfilerActivity.CUDA])
            self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.prof is not None:
            self.prof.__exit__(*exc)

    def device_trace(self, origin_ns: int) -> Optional[DeviceTrace]:
        """Every device interval, in seconds from `origin_ns` on the wall clock."""
        if self.prof is None:
            return None
        from torch.autograd import DeviceType
        s, e, names, kinds = [], [], [], []
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s.append(ev.start_ns())
            e.append(ev.end_ns())
            names.append(ev.name())
            kinds.append(_kind(ev.name()))
        start = (np.asarray(s, np.int64) - origin_ns) / 1e9
        end = (np.asarray(e, np.int64) - origin_ns) / 1e9
        return DeviceTrace(start, end, names, kinds)


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy") or "memcpy" in low:
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


HOST_SPANS = ("wait_arrivals", "assemble", "serve_enqueue", "copy_wait", "stamp")


def host_spans(calls: List[tuple]) -> Tuple[np.ndarray, np.ndarray]:
    """The server's stamps as labelled host spans: [n, 2] intervals and
    their index into HOST_SPANS."""
    iv, lab = [], []
    for k, (t0, t1, t2, t3, t4, _, _) in enumerate(calls):
        iv += [(t0, t1), (t1, t2), (t2, t3), (t3, t4)]
        lab += [0, 1, 2, 3]
        if k + 1 < len(calls):
            iv.append((t4, calls[k + 1][0]))
            lab.append(4)
    return np.asarray(iv, float).reshape(-1, 2), np.asarray(lab, np.int64)


def idle_gaps(busy: np.ndarray, lo: float, hi: float, calls: List[tuple]) -> Dict[str, float]:
    """Seconds of [lo, hi] with nothing on the device, by what the host was
    doing at each gap's middle (the span that holds it)."""
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = clip(edges, lo, hi)
    spans, labels = host_spans(calls)
    out: Dict[str, float] = {}
    if len(gaps) == 0:
        return out
    mid = gaps.mean(axis=1)
    order = np.argsort(spans[:, 0], kind="stable")
    spans, labels = spans[order], labels[order]
    k = np.searchsorted(spans[:, 0], mid, side="right") - 1
    for (a, b), m, kk in zip(gaps, mid, k):
        name = HOST_SPANS[labels[kk]] if kk >= 0 and spans[kk, 1] >= m else "outside_calls"
        out[name] = out.get(name, 0.0) + float(b - a)
    return out


def copy_lag(trace: DeviceTrace, calls: List[tuple], lo: float, hi: float) -> Optional[float]:
    """Median of (host sees the scores) - (the device-to-host copy ends)
    over the window's calls, when the copies and calls pair one to one:
    a few tens of microseconds where the clocks agree."""
    copies = sorted(e for s, e, k, n in zip(trace.start, trace.end, trace.kinds, trace.names)
                    if k == "memcpy" and ("DtoH" in n or "Device -> Pageable" in n
                                          or "Device -> Pinned" in n) and lo <= s <= hi + 1.0)
    ends = [c[4] for c in calls if lo <= c[2] <= hi]
    if not copies or len(copies) < len(ends):
        return None
    return float(np.median(np.asarray(ends) - np.asarray(copies[:len(ends)])))
