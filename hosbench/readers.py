"""What the per-layer metrics read from a profiled span of steps
(`harness.layer_metrics` builds the context: the span's wall and busy
seconds, device seconds by kernel group and by B kernel, and the
benchmark's own counts of each profiled step). Each metric's file under
`hosbench/layers/` names its layer and the end-to-end metric it moves and
calls one of these; a reader with nothing to read returns None."""

from __future__ import annotations

from hosbench.counts import BF16_PEAK, roofline_s

LBS = ("B1", "B4", "B5f", "B5b")     # f32 operations on the CUDA cores


def mfu(ctx):
    """The whole step's share (%) of the card's dense bf16 peak: the
    analytic model FLOPs of the profiled steps over their wall time (per
    card)."""
    if not ctx["counts"] or ctx["busy_s"] <= 0 or ctx["span_s"] <= 0:
        return None
    flops = sum(c["model_flops"] for c in ctx["counts"])
    return 100.0 * flops / ctx["world"] / ctx["span_s"] / BF16_PEAK


def idle_share(ctx):
    """The share (%) of the profiled steps' wall time in which no kernel
    ran on the card."""
    if ctx["busy_s"] <= 0 or ctx["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx["busy_s"] / ctx["span_s"])


def group_ms(ctx, group: str):
    """Device ms a step of one kernel group (`hosbench/trace.py`)."""
    return ctx["per_step_ms"](group)


def kernels_roofline(ctx):
    """B1-B5 against their roofline (%): each kernel's least time for the
    step's needed work, summed over the kernels and the profiled steps,
    over their device time."""
    device = sum(ctx["b_kernels"].values())
    if device <= 0 or not ctx["counts"]:
        return None
    least = 0.0
    for c in ctx["counts"]:
        for name, (ops, nbytes) in c["kernels"].items():
            least += (roofline_s(f32_ops=ops, nbytes=nbytes) if name in LBS
                      else roofline_s(bf16_ops=ops, nbytes=nbytes))
    return 100.0 * least / ctx["world"] / device
