"""glue_ms: device ms a step of the glue: every library kernel, copy
and memset that is not a GEMM, a convolution, Adam's or NCCL's, and not
opened by a hand-written kernel (the scene's and the human field's
sampling and compositing, the losses, the elementwise work of LPIPS, the
decoder and the pose refiner)."""

from hosbench import readers

LAYER = ("glue: every library kernel, copy and memset that is not a GEMM, "
         "convolution, Adam's or NCCL's (sampling, compositing, losses, "
         "LPIPS's and the decoder's elementwise)")
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "glue")
