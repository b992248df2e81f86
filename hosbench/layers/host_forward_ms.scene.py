"""host_forward_ms.scene: `host_forward_ms` in a stage-1 scene cell, where
it moves scene_rays_per_s."""

from hosbench import span_readers

LAYER = "host: the step's Python and dispatch (utils/spans.py)"
MOVES = "scene_rays_per_s"


def read(ctx):
    return span_readers.host_ms(ctx, "forward")
