"""interaction_idle_share: the share, in %, of the traced window in which
nothing ran on the device while the host's innermost span of the program
was the history's interaction (`interaction`: taobao_ssa's
`encode_history`, with its `encoder_block`s, or DIN's
`target_attention`, with its `mlp` `attn`); from the device trace and the
program's spans (`harness.spans`). Nothing is read where the program
records no spans."""
from harness import spans


def read(run):
    return spans.idle_share(run, "interaction")
