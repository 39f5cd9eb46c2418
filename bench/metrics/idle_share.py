"""idle_share: the share, in %, of the traced window in which nothing ran
on the device (no kernel, copy or set)."""
import numpy as np


def read(run):
    busy = run.busy()
    if busy is None:
        return None
    return (1.0 - float(np.sum(busy[:, 1] - busy[:, 0])) / run.seconds) * 100.0
