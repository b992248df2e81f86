"""lbs_useful_share: the share of the rows that B1-B5 compute that are
live: the sorted domain's rows at or after the exact dead/live boundary
over its rows from the first live 1024-row block on (where the kernels
start), summed over the profiled steps, %."""

from hosbench import span_readers

LAYER = "hand-written kernels B1-B5: ops/cuda/, csrc/"
MOVES = "train_rays_per_s"


def read(ctx):
    return span_readers.useful_share(ctx)
