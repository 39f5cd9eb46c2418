"""lookup_idle_share: the share, in %, of the traced window in which
nothing ran on the device while the host's innermost span of the program
was a `lookup` (`models/recsys/embedding.field_lookup`, one a field: the
ids' gather through the `kernels/embedding_bag` wrapper); from the device
trace and the program's spans (`harness.spans`). Nothing is read where the
program records no spans."""
from harness import spans


def read(run):
    return spans.idle_share(run, "lookup")
