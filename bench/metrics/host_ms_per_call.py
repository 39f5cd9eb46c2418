"""host_ms_per_call: the mean host time, in ms, from entering
`api.serve` to its return (before the scores are waited for), over the
calls that began in the window."""
import numpy as np


def read(run):
    if not run.calls:
        return None
    return float(np.mean([c[3] - c[2] for c in run.calls])) * 1e3
