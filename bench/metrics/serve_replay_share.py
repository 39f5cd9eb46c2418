"""serve_replay_share: the share, in %, of the window's calls whose serve
call replayed a captured CUDA graph of itself
(`repro_torch.models.recsys.serve_graph`), from the path the program's
root `serve` span records (what it is `of`: `eager`, `capture` or
`replay`). The first N `serve` spans of the recording pair in order with
the window's N calls, each of its call's rows, as `harness.spans` pairs
them. Nothing is read (None) where the program records no spans, where it
dropped any, where the pairing fails, or where a root span records no
path (a program without the graph path)."""
from typing import Optional

import numpy as np

from harness import spans
from harness.runner import c_rows

PATHS = ("eager", "capture", "replay")


def share(run, rec) -> Optional[float]:
    if rec is None or rec.dropped or not run.calls or not rec.names:
        return None
    name = rec.column("name")
    roots = np.flatnonzero(np.asarray([k[0] == "serve" for k in rec.names])[name])
    n = len(run.calls)
    if len(roots) < n:
        return None
    roots = roots[:n]
    if not np.array_equal(rec.column("items")[roots], [c_rows(run.req, c) for c in run.calls]):
        return None
    paths = [rec.names[i][1] for i in name[roots]]
    if any(p not in PATHS for p in paths):
        return None
    return 100.0 * paths.count("replay") / n


def read(run):
    return share(run, spans.recording())
