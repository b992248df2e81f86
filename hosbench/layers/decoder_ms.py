"""decoder_ms: device ms a composed.p8 step of the bf16 convolutions:
the human field's weight-volume decoder, forward and backward, on
cuDNN."""

from hosbench import readers

LAYER = ("bf16 convolutions: the weight-volume decoder's conv3d on cuDNN "
         "(models/human_components.py)")
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "conv_bf16")
