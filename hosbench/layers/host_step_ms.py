"""host_step_ms: the host's wall time of the `step` span, ms a step."""

from hosbench import span_readers

LAYER = "host: the step's Python and dispatch (utils/spans.py)"
MOVES = "train_rays_per_s"


def read(ctx):
    return span_readers.host_ms(ctx, "step")
