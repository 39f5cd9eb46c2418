"""The arithmetic of latencies and rates, over every request of the window.

A request is due in the window when its due time is before the window's
end. It fails when it is never served, or when any of its scores is not
finite; a failed request counts in every tail with the latency it had
reached when the loop gave up, so it misses every limit.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Outcome:
    attempted: int  # requests due in the window
    failed: int  # of them, never served or served non-finite scores
    unserved: int
    nonfinite: int
    latency_s: np.ndarray  # [attempted], failed ones at the loop's give-up time
    completed: np.ndarray  # [attempted] bool: served whole and finite within the window
    completed_cands: int  # their candidates


def finite_requests(scores: np.ndarray, offsets: np.ndarray, first: int, end: int) -> np.ndarray:
    """Whether every score of each request first..end-1 is finite."""
    bad = ~np.isfinite(scores[offsets[first]:offsets[end]])
    counts = np.add.reduceat(bad.astype(np.int64), offsets[first:end] - offsets[first]) \
        if end > first else np.zeros(0, np.int64)
    return counts == 0


def outcome(due: np.ndarray, done: np.ndarray, scores: np.ndarray, offsets: np.ndarray,
            first: int, seconds: float, gave_up: float) -> Outcome:
    """Requests from `first` on whose due time is before `seconds`."""
    window_due = due[first:]
    end = first + int(np.sum(np.isfinite(window_due) & (window_due < seconds)))
    d, t = due[first:end], done[first:end]
    served = np.isfinite(t)
    finite = np.zeros(end - first, bool)
    finite[served] = finite_requests(scores, offsets, first, end)[served]
    ok = served & finite
    latency = np.where(served, t - d, gave_up - d)
    completed = ok & (t <= seconds)
    return Outcome(
        attempted=end - first, failed=int(np.sum(~ok)), unserved=int(np.sum(~served)),
        nonfinite=int(np.sum(served & ~finite)), latency_s=latency, completed=completed,
        completed_cands=int(np.sum(np.diff(offsets[first:end + 1])[completed])),
    )


def percentile(values: np.ndarray, q: float) -> float:
    """The q-th percentile, interpolated linearly between order statistics."""
    return float(np.percentile(values, q)) if len(values) else float("nan")
