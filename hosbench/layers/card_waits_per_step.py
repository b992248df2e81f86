"""card_waits_per_step: the host's waits for the card a step: the
synchronising calls that `torch.cuda.set_sync_debug_mode` reports and
the caching allocator's cudaMalloc and cudaFree calls."""

from hosbench import span_readers

LAYER = "host: the step's Python and dispatch (utils/spans.py)"
MOVES = "train_rays_per_s"


def read(ctx):
    return span_readers.card_waits(ctx)
