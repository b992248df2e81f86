"""gemm_ms.scene: `gemm_ms` in a stage-1 scene cell, where it moves
scene_rays_per_s."""

from hosbench import readers

LAYER = ("GEMMs: every cuBLAS matrix product (the scene MLPs, most of it; "
         "the human heads, the pose refiner)")
MOVES = "scene_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "gemm")
