"""train_mfu: the step's share of the card's dense bf16 peak
(989 TFLOP/s, H100 SXM): the benchmark's analytic model FLOPs of the
profiled steps over their wall time (`hosbench/counts.py`)."""

from hosbench import readers

LAYER = "step: train/stage3.py, train/stage1.py"
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.mfu(ctx)
