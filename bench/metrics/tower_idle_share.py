"""tower_idle_share: the share, in %, of the traced window in which
nothing ran on the device while the host's innermost span of the program
was the tower (`mlp` `tower`, `models/recsys/rec_layers.mlp_apply`); from
the device trace and the program's spans (`harness.spans`). Nothing is
read where the program records no spans."""
from harness import spans


def read(run):
    return spans.idle_share(run, "tower")
