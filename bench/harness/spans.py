"""The program's own host spans inside `api.serve`, laid on the window.

While torch's profiler records, the program records a tree of spans in
each serve call (`repro_torch.core.spans`: `serve`, its `lookup`s, the
`interaction` with its `encoder_block`s or `mlp` `attn`, the `mlp`
`tower`), on `time.perf_counter_ns`. The server stamps each call on
`time.perf_counter` too, from the window's start: the first N `serve`
spans of the recording pair in order with the window's N calls, each pair
of the same rows, and the median of (span start - t2) over the pairs puts
the spans on the window's seconds. Each idle gap of the device in the
window goes to the innermost program span open at its middle, the rule of
`trace.idle_gaps`, and so to a layer:

  lookup        `lookup`
  interaction   `interaction`, `encoder_block`, `mlp` `attn`
  tower         `mlp` `tower`
  serve         `serve` itself: what lies between the layers

Nothing is read (None) where the program records no spans (a program
without `repro_torch.core.spans`, or an untraced run), where it dropped
any, where the pairing fails (too few `serve` spans, rows that differ, a
span outside its call's [t2, t3] by more than `SPREAD_S`), or where the
offsets spread (first to third quartile) by more than `SPREAD_S`.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from harness.runner import c_rows
from harness.trace import clip

SPREAD_S = 50e-6
LAYERS = ("lookup", "interaction", "tower", "serve")


def layer_of(name: str, of: str) -> Optional[str]:
    if name in ("lookup", "serve"):
        return name
    if name in ("interaction", "encoder_block") or (name, of) == ("mlp", "attn"):
        return "interaction"
    if (name, of) == ("mlp", "tower"):
        return "tower"
    return None


def recording():
    """The program's newest recording, or None."""
    try:
        from repro_torch.core import spans
    except ImportError:
        return None
    return spans.recording()


def idle_by_layer(run) -> Optional[Dict[str, float]]:
    """Seconds of the window with nothing on the device, by the layer of
    the program's innermost span at each gap's middle (LAYERS); read once
    a run."""
    if "program_spans" not in run.cache:
        run.cache["program_spans"] = split(run, recording())
    return run.cache["program_spans"]


def idle_share(run, layer: str) -> Optional[float]:
    """`layer`'s idle seconds as a share of the window, in %."""
    by_layer = idle_by_layer(run)
    return None if by_layer is None else by_layer[layer] / run.seconds * 100.0


def split(run, rec) -> Optional[Dict[str, float]]:
    busy = run.busy()
    if busy is None or rec is None or rec.dropped or not run.calls or not rec.names:
        return None
    name = rec.column("name")
    layer_names = [layer_of(*k) for k in rec.names]
    layers = np.asarray([LAYERS.index(x) if x else -1 for x in layer_names])[name]
    roots = np.flatnonzero(np.asarray([k[0] == "serve" for k in rec.names])[name])
    n = len(run.calls)
    if len(roots) < n:
        return None
    roots = roots[:n]
    if not np.array_equal(rec.column("items")[roots], [c_rows(run.req, c) for c in run.calls]):
        return None
    t0_ns, t1_ns = rec.column("t0_ns"), rec.column("t1_ns")
    base = t0_ns[roots[0]]
    t2 = np.asarray([c[2] for c in run.calls])
    t3 = np.asarray([c[3] for c in run.calls])
    d = (t0_ns[roots] - base) / 1e9 - t2
    q1, q3 = np.percentile(d, [25, 75])
    if q3 - q1 > SPREAD_S:
        return None
    offset = float(np.median(d))
    s0 = (t0_ns - base) / 1e9 - offset
    s1 = (t1_ns - base) / 1e9 - offset
    if np.any(s0[roots] < t2 - SPREAD_S) or np.any(s1[roots] > t3 + SPREAD_S):
        return None
    edges = np.concatenate([[0.0], busy.ravel(), [run.seconds]]).reshape(-1, 2)
    gaps = clip(edges, 0.0, run.seconds)
    mid = gaps.mean(axis=1)
    # rows open in order of start, and spans nest: the innermost span open
    # at a time is the latest to start before it, or its nearest ancestor
    # still open
    k = np.searchsorted(s0, mid, side="right") - 1
    parent = rec.column("parent")
    while True:
        ended = (k >= 0) & (s1[np.maximum(k, 0)] < mid)
        if not ended.any():
            break
        k[ended] = parent[k[ended]]
    out = dict.fromkeys(LAYERS, 0.0)
    lengths = gaps[:, 1] - gaps[:, 0]
    for i, layer in enumerate(LAYERS):
        out[layer] = float(np.sum(lengths[(k >= 0) & (layers[np.maximum(k, 0)] == i)]))
    return out
