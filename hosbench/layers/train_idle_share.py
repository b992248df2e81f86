"""train_idle_share: the share of the profiled steps' wall
time in which no kernel ran on the card."""

from hosbench import readers

LAYER = "device"
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.idle_share(ctx)
