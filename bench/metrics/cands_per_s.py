"""cands_per_s: candidates of the requests served whole, with finite
scores, within the window, over the window's seconds."""


def read(run):
    return run.outcome.completed_cands / run.seconds
