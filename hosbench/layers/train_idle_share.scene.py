"""train_idle_share.scene: `train_idle_share` in a stage-1 scene cell, where it moves
scene_rays_per_s."""

from hosbench import readers

LAYER = "device"
MOVES = "scene_rays_per_s"


def read(ctx):
    return readers.idle_share(ctx)
