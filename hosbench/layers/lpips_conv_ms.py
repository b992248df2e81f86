"""lpips_conv_ms: device ms a composed.p8 step of the f32 convolutions:
LPIPS's VGG16 over the predicted and the target patches, forward, and
backward to the prediction, on cuDNN."""

from hosbench import readers

LAYER = "f32 convolutions: LPIPS's VGG16 on cuDNN (models/lpips.py)"
MOVES = "train_rays_per_s"


def read(ctx):
    return readers.group_ms(ctx, "conv_f32")
