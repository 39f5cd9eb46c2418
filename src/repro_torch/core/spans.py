"""Host spans inside the serving path, recorded while torch's profiler records.

`models/recsys/api.serve` opens the root span of a call, `serve`, and the
layers below it open theirs:

  span            where                                        items
  serve           `api.serve` (of: the call's path, `eager`,   rows in the batch
                  `capture` or `replay`: `models/recsys/serve_graph`)
  lookup          `embedding.field_lookup` (of: the field)     ids looked up
  interaction     `taobao_ssa.encode_history`,                 rows x history positions
                  `din.target_attention`
  encoder_block   each block of `taobao_ssa.encode_history`    rows
  mlp             `rec_layers.mlp_apply` (of: its name,         rows
                  `attn` or `tower`)

A span keeps its name, what it is of, the call it belongs to (every span
of one serve call shares the call's number), its parent, its start and end
on `time.perf_counter_ns()` and a counter of the items it handled. One
thread serves; a span opened outside a serve call records nothing.

**The switch is torch's profiler.** The root reads once a call whether the
profiler is recording; a span costs one global read and returns a shared
no-op context unless a recorded call is running. A serve call that finds
the profiler turned on since the call before starts a new recording, so a
profiled window is one recording. An operator records a window and lays
the spans beside the device's activity so:

    import json
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import spans

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for batch in batches:
            api.serve(params, batch, cfg)
    prof.export_chrome_trace("device.json")
    with open("device.json") as f:
        doc = json.load(f)
    host = spans.recording().to_chrome_trace(doc.get("baseTimeNanoseconds", 0))
    doc["traceEvents"] += host["traceEvents"]
    with open("serve.json", "w") as f:
        json.dump(doc, f)

and opens `serve.json` in Perfetto: the spans are stamped on the wall
clock, as the profiler stamps device activity, on a track of their own.

A recording keeps at most `LIMIT` spans and counts those it drops. While
the profiler records, a span appends its row to a flat array of integers
(no object for the collector to track); the rows go into the recording's
`core.serving.metrics.TraceBuffer` when it is read.
"""
from __future__ import annotations

import math
import os
import time
from array import array
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.autograd.profiler as _profiler

from repro_torch.core.serving.metrics import TraceBuffer

# Spans a recording keeps: 8x what a 30 s window of DIN's 3,200-row calls
# makes (~14,000 calls of 9 spans).
LIMIT = 1 << 20
COLUMNS = (("name", np.int32), ("call", np.int64), ("parent", np.int64),
           ("t0_ns", np.int64), ("t1_ns", np.int64), ("items", np.int64))
WIDTH = len(COLUMNS)
TID = 0  # the exported spans' track: no host thread of the profiler's has id 0
_clock = time.perf_counter_ns


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


class Recording:
    """The spans of the serve calls made while the profiler recorded, one
    row a span in the order they opened (so by start): `column(name)` of
    `COLUMNS`; `names[i]` is the (name, of) pair that name id i interns;
    `parent` is the parent's row, -1 for a root."""

    def __init__(self):
        self.limit = LIMIT
        self.names: List[Tuple[str, str]] = []
        self._ids: Dict[Tuple[str, str], int] = {}
        self.calls = 0  # serve calls begun
        self.dropped = 0  # spans not kept: the recording was full
        self.offset_ns = clock_offset_ns()  # wall clock less perf_counter
        self._buf = TraceBuffer(COLUMNS)
        self._n = 0  # spans kept
        self._rows = array("q")  # the rows from the buffer's length on, flat
        self._stack: List[int] = []  # rows of the spans open, innermost last

    def __len__(self) -> int:
        return self._n

    def column(self, name: str) -> np.ndarray:
        if self._stack:
            raise RuntimeError("a serve call is being recorded")
        rows = self._rows
        for k in range(0, len(rows), WIDTH):
            self._buf.append(*rows[k:k + WIDTH])
        del rows[:]
        return self._buf.column(name)

    def _open(self, name: str, of: str, items: int) -> None:
        n, stack = self._n, self._stack
        if n >= self.limit:
            self.dropped += 1
            stack.append(-1)
            return
        key = (name, of)
        i = self._ids.get(key)
        if i is None:
            i = self._ids[key] = len(self.names)
            self.names.append(key)
        self._rows.extend((i, self.calls - 1, stack[-1] if stack else -1, _clock(), 0, items))
        stack.append(n)
        self._n = n + 1

    def _relabel_root(self, of: str) -> None:
        row = self._stack[0]
        if row < 0:
            return
        key = ("serve", of)
        i = self._ids.get(key)
        if i is None:
            i = self._ids[key] = len(self.names)
            self.names.append(key)
        self._rows[WIDTH * (row - self._n) + len(self._rows)] = i

    def __enter__(self) -> None:
        return None

    def __exit__(self, a, b, c) -> None:
        t1 = _clock()
        stack = self._stack
        row = stack.pop()
        if row >= 0:
            self._rows[WIDTH * (row - self._n) + len(self._rows) + 4] = t1
        if not stack:
            global _active
            _active = None

    def to_chrome_trace(self, base_ns: int = 0) -> Dict:
        """Chrome trace events: one complete ("X") event a span, in
        microseconds of the wall clock less `base_ns` (a profiler trace's
        `baseTimeNanoseconds`, to lay them beside it), with the call, the
        items and what the span is of as arguments; `tools/check_trace`
        accepts it."""
        pid = os.getpid()
        events = [{"ph": "M", "name": "process_name", "pid": pid, "tid": TID,
                   "args": {"name": f"python {pid}"}},
                  {"ph": "M", "name": "thread_name", "pid": pid, "tid": TID,
                   "args": {"name": "serve spans"}}]
        name, call = self.column("name"), self.column("call")
        t0, t1, items = self.column("t0_ns"), self.column("t1_ns"), self.column("items")
        shift = self.offset_ns - base_ns
        for k in range(len(t0)):  # in order of start
            what, of = self.names[name[k]]
            args = {"call": int(call[k]), "items": int(items[k])}
            if of:
                args["of"] = of
            events.append({"ph": "X", "name": f"{what} {of}" if of else what, "cat": "serve",
                           "pid": pid, "tid": TID, "ts": (int(t0[k]) + shift) / 1e3,
                           "dur": (int(t1[k]) - int(t0[k])) / 1e3, "args": args})
        return {"traceEvents": events, "displayTimeUnit": "ms", "baseTimeNanoseconds": base_ns}


class _Off:
    """The shared context of a span that records nothing."""
    __slots__ = ()

    def __enter__(self) -> None:
        return None

    def __exit__(self, a, b, c) -> None:
        return None


_OFF = _Off()
_active: Optional[Recording] = None  # the recording of the serve call running
_last: Optional[Recording] = None
_was_on = False  # whether the profiler recorded at the serve call before


def recording() -> Optional[Recording]:
    """The newest recording, or None where no serve call was recorded."""
    return _last


def serve(batch: Dict):
    """The root span of a serve call: records the call, and the spans its
    layers open, where torch's profiler is recording; items: the rows of
    the batch (the first dimension of its first entry). What it is of is
    the way the call goes, once `serve_path` has told it."""
    global _active, _last, _was_on
    on = _profiler._is_profiler_enabled
    if not on or _active is not None:
        _was_on = on
        return _OFF
    if not _was_on:
        _last = Recording()
    _was_on = True
    _active = _last
    _active.calls += 1
    _active._open("serve", "", next(iter(batch.values())).shape[0])
    return _active


def serve_path(path: str) -> None:
    """Record `path` (`eager`, `capture` or `replay`) as what the root span
    of the serve call being recorded is of. A replay runs none of the
    layers' code, so opens no span below the root. The root opens before
    the path is chosen, so that the choice lies inside it and the span
    starts as soon after the call's entry in every call."""
    if _active is not None:
        _active._relabel_root(path)


def span(name: str, t, dims: Optional[int] = 1, of: str = ""):
    """A span of the serve call being recorded, or the shared no-op; items:
    the product of the first `dims` sizes of the tensor `t` (all of them
    where `dims` is None)."""
    if _active is None:
        return _OFF
    shape = t.shape
    _active._open(name, of, shape[0] if dims == 1 else
                  t.numel() if dims is None else math.prod(shape[:dims]))
    return _active
