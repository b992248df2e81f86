"""glue_ms.scene: `glue_ms` in a stage-1 scene cell, where it moves
scene_rays_per_s."""

from hosbench import readers

LAYER = ("glue: every library kernel, copy and memset that is not a GEMM, "
         "convolution, Adam's or NCCL's (sampling, compositing, losses, "
         "LPIPS's and the decoder's elementwise)")
MOVES = "scene_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "glue")
