"""embedding_bag_roofline: the bytes that the lookups of the window's
calls need (`harness.work.lookup_bytes`) at the card's HBM rate, over the
device time of the kernels named `embedding_bag` that began in the
window, in %. Nothing is read where no such kernel ran."""
from harness.work import HBM_BYTES_PER_S, lookup_bytes


def read(run):
    tr = run.device_trace
    if tr is None or not run.calls:
        return None
    inside = (tr.start >= 0.0) & (tr.start < run.seconds)
    seconds = float(sum(e - s for s, e, n, ok in zip(tr.start, tr.end, tr.names, inside)
                        if ok and "embedding_bag" in n))
    if seconds <= 0:
        return None
    need = lookup_bytes(run.cell.model, run.req, run.calls)["total"]
    return need / HBM_BYTES_PER_S / seconds * 100.0
