"""host_wait_ms: the host's time asleep in a step: the `step` span's wall
minus the process's CPU time in it (every thread), floored at 0, ms a
step. A sync, the allocator, the GIL or a full launch queue."""

from hosbench import span_readers

LAYER = "host: the step's Python and dispatch (utils/spans.py)"
MOVES = "train_rays_per_s"


def read(ctx):
    return span_readers.wait_ms(ctx)
