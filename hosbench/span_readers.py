"""What the host-side per-layer metrics read: the spans the port records
inside its training step while the profiler runs
(`hosnerf_tpu_torch/utils/spans.py`; `records()`, read after the profiled
span of steps). Each reader finds the top-level `step` spans of the span
and returns None unless there are exactly `ctx["steps"]` complete ones,
or when the port has no spans (a checkout before them); each value a step
is the total over the profiled steps over their number."""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

MS = 1e-6      # ns -> ms


def steps_of(ctx) -> Optional[Tuple[List[Dict], List[Dict]]]:
    """(every record, the profiled steps' `step` records), or None."""
    try:
        from hosnerf_tpu_torch.utils import spans
    except ImportError:
        return None
    recs = spans.records()
    steps = [r for r in recs if r["name"] == "step" and r["parent"] is None
             and r.get("t1") is not None]
    if len(steps) != ctx["steps"] or not steps:
        return None
    return recs, steps


def host_ms(ctx, name: str):
    """Host wall ms a step of the spans named `name` in the profiled
    steps."""
    got = steps_of(ctx)
    if got is None:
        return None
    recs, steps = got
    ids = {r["step"] for r in steps}
    walls = [r["t1"] - r["t0"] for r in recs
             if r["name"] == name and r["step"] in ids
             and r.get("t1") is not None]
    if not walls:
        return None
    return MS * sum(walls) / len(steps)


def wait_ms(ctx):
    """Host ms a step asleep: each step's wall minus the process's CPU
    time in it, floored at 0."""
    got = steps_of(ctx)
    if got is None:
        return None
    steps = got[1]
    return MS * sum(max(0, (r["t1"] - r["t0"]) - (r["cpu1"] - r["cpu0"]))
                    for r in steps) / len(steps)


def queue_ms(ctx):
    """How far the card runs behind the host when a step exits: the card's
    end of the step's work minus the host's exit, ms, mean over the steps
    (None without a card)."""
    got = steps_of(ctx)
    if got is None or any("device_ns" not in r for r in got[1]):
        return None
    steps = got[1]
    return MS * sum(r["device_ns"] - r["t1"] for r in steps) / len(steps)


def card_waits(ctx):
    """The host's waits for the card a step: synchronising calls and the
    caching allocator's cudaMalloc and cudaFree calls (None without a
    card)."""
    got = steps_of(ctx)
    keys = ("syncs", "device_allocs", "device_frees")
    if got is None or any(r.get(k) is None for r in got[1] for k in keys):
        return None
    steps = got[1]
    return sum(r[k] for r in steps for k in keys) / len(steps)


def useful_share(ctx):
    """Live rows over computed rows of the sorted domain (%), summed over
    the profiled steps (None where no step took the sorted path)."""
    got = steps_of(ctx)
    if got is None:
        return None
    steps = got[1]
    computed = sum(r.get("computed_rows", 0) for r in steps)
    if computed <= 0:
        return None
    return 100.0 * sum(r.get("live_rows", 0) for r in steps) / computed
