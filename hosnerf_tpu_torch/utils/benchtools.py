"""Device timing helpers (counterpart of `hosnerf_tpu/utils/benchtools.py`).

On a CUDA device a call returns once its work is queued. `timeit_chain`
issues the timed calls back to back and waits for the device once, at
the end (`torch.cuda.synchronize`), so the seconds per call include the
device work and not one host wait per call. `force_value` reads one value
to the host, which waits for whatever produced it.
"""

from __future__ import annotations

import time
from typing import Callable, Sequence

import torch


def _first_tensor(out):
    if isinstance(out, torch.Tensor):
        return out
    if isinstance(out, dict):
        out = list(out.values())
    if isinstance(out, (list, tuple)):
        for v in out:
            t = _first_tensor(v)
            if t is not None:
                return t
    return None


def force_value(out) -> float:
    """One value of the first tensor in `out` (a tensor, or a dict, list
    or tuple holding tensors) read to the host."""
    t = _first_tensor(out)
    if t is None:
        raise ValueError("force_value: no tensor in the output")
    return float(t.detach().reshape(-1)[0])


def _synchronize() -> None:
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def timeit_chain(fn: Callable, args_list: Sequence[tuple], iters: int = 8,
                 warmup: int = 2) -> float:
    """Seconds per call of `fn`: `warmup` calls (then waited for), then
    `iters` calls issued back to back on args_list[warmup:warmup + iters]
    and one device synchronisation at the end."""
    assert len(args_list) >= warmup + iters
    for i in range(warmup):
        fn(*args_list[i])
    _synchronize()
    t0 = time.perf_counter()
    for i in range(warmup, warmup + iters):
        fn(*args_list[i])
    _synchronize()
    return (time.perf_counter() - t0) / iters
