"""setup_s: seconds from the start of the harness's process to the
window's start: imports, the kernels' build or load, the weights, the
requests and the warm-up."""


def read(run):
    return run.setup_s
