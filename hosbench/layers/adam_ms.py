"""adam_ms: device ms a step of Adam's multi-tensor
kernels."""

from hosbench import readers

LAYER = "optimizer: torch.optim.Adam"
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "adam")
