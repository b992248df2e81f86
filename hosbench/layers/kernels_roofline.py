"""kernels_roofline: the hand-written kernels B1-B5 against their
roofline: for each kernel the least time the card could take for the
step's needed work (the larger of its operations at their peak and its
bytes at 3.35 TB/s; `hosbench/counts.py`), summed over the kernels and
the profiled steps, over their device time."""

from hosbench import readers

LAYER = "hand-written kernels B1-B5: ops/cuda/, csrc/"
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.kernels_roofline(ctx)
