"""gemm_ms: device ms a step of the library GEMMs: every cuBLAS matrix
product, which is the scene's MLPs for the most part and the human
field's heads and pose refiner for the rest."""

from hosbench import readers

LAYER = ("GEMMs: every cuBLAS matrix product (the scene MLPs, most of it; "
         "the human heads, the pose refiner)")
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "gemm")
