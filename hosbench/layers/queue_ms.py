"""queue_ms: how far the card runs behind the host when a step exits: the
card's end of the step's work (a CUDA event at the `step` span's exit,
mapped onto the host's clock) minus the host's exit, ms. Near 0 the card
is starved."""

from hosbench import span_readers

LAYER = "host: the step's Python and dispatch (utils/spans.py)"
MOVES = "train_rays_per_s"


def read(ctx):
    return span_readers.queue_ms(ctx)
