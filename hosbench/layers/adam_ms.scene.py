"""adam_ms.scene: `adam_ms` in a stage-1 scene cell, where it moves
scene_rays_per_s."""

from hosbench import readers

LAYER = "optimizer: torch.optim.Adam"
MOVES = "scene_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "adam")
