"""train_mfu.scene: `train_mfu` in a stage-1 scene cell, where it moves
scene_rays_per_s."""

from hosbench import readers

LAYER = "step: train/stage3.py, train/stage1.py"
MOVES = "scene_rays_per_s"


def read(ctx):
    return readers.mfu(ctx)
