"""serve_mfu: the dot flops that the window's completed requests need
(the configuration's `dot_flops`: work that a request's candidates share
counted once) over the window's seconds times the card's f32 peak outside
the tensor cores (67 TFLOP/s: TF32 is off), in %. Read in the traced
run, whose device line names the card."""
from harness.work import F32_FLOPS


def read(run):
    if run.device_trace is None:
        return None
    idx = run.first + run.outcome.completed.nonzero()[0]
    flops = run.reference.dot_flops(run.cell.model, run.req.hist_len_host[idx],
                                    run.req.ncand[idx])
    return flops / (run.seconds * F32_FLOPS) * 100.0
