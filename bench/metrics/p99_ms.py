"""p99_ms: the 99th percentile of request latency, in ms, from each
request's due time to its scores on the host, over every request due in
the window; a failed request counts with the latency it had reached when
the loop gave up."""
from harness.stats import percentile


def read(run):
    if not run.outcome.attempted:
        return None
    return percentile(run.outcome.latency_s, 99) * 1e3
