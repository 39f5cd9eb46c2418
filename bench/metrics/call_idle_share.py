"""call_idle_share: the share, in %, of the serve calls' wall time (from
entering `api.serve` to the scores on the host) in which nothing ran on
the device, over the calls that began in the window; from the device
trace."""
import numpy as np

from harness.trace import overlap, union


def read(run):
    busy = run.busy()
    if busy is None or not run.calls:
        return None
    spans = np.asarray([(c[2], c[4]) for c in run.calls], float)
    wall = float(np.sum(spans[:, 1] - spans[:, 0]))
    if wall <= 0:
        return None
    return (1.0 - overlap(busy, union(spans)) / wall) * 100.0
