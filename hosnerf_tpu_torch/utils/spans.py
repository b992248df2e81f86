"""Spans and counters inside the training step, recorded exactly while a
`torch.profiler` session records in the process (the loop's
`profile_steps`, a benchmark's traced run, an operator's own profiler):

    with spans.span("forward"):
        ...
    recs = spans.records()      # after the session: one dict per span

When no profiler records, `span` is one check and an empty context, and
nothing is kept or allocated. When one does, a span opens a profiler range
of its name (torch's `_RecordFunctionFast`, the low-overhead form of
`record_function`, where torch has it; the profiler's trace shows it beside
the kernels it launched) and keeps a record:

  * `name`; `parent`, the index of the innermost span open on the same
    thread (on autograd's device thread, which has none, the open
    `backward` span); `step`, the iteration that the train step received,
    inherited from the parent when not given; `thread`;
  * `t0`, `t1`: host `time.perf_counter_ns()` at start and end; on the
    top-level spans also `cpu0`, `cpu1`: the process's CPU time
    (`time.process_time_ns()`, every thread) at start and end (read there
    alone: a host whose process clock ticks in 10 ms, as some H100 hosts
    do, reads nothing in a shorter span, and a reading costs
    microseconds);
  * `launches`: {kernel wrapper: launches in the span}, from the wrappers'
    `.launches` counts (`kernel_wrappers()`);
  * `syncs`: the synchronising calls that `torch.cuda.set_sync_debug_mode`
    reports in the span (the mode is set to warn for the session and
    restored when it stops; None without a card), and where there were
    any, `sync_sites`: the Python lines that made them, on the innermost
    span open (autograd's backward reports its own when it returns);
  * on the top-level spans, `device_allocs` and `device_frees`: the
    caching allocator's cudaMalloc and cudaFree calls
    (`num_device_alloc`, `num_device_free`; read there alone, as one
    reading costs tens of microseconds);
  * on the top-level spans, `device_ns`: when the card finished the work
    issued up to the span's end, on the host's clock (a CUDA event
    recorded at exit; `records()` synchronises once, records one event on
    the idle card beside a host reading, and maps every event by their
    difference);
  * on the top-level `step` spans, `live_rows` and `computed_rows` of the
    sorted domain in that step (`count_rows`), summed on the card without a
    host read and read once by `records()`.

A new session clears the records of the last one.
"""

from __future__ import annotations

import functools
import operator
import threading
import time
import warnings
from typing import Callable, Dict, List, Optional

import torch
from torch.autograd import profiler as _prof

SYNC_MESSAGE = "called a synchronizing CUDA operation"
# a range in the profiler's trace: record_function costs ~24 us to enter
# and as much to exit inside a composed training step (an H100's host),
# the fast form a few
_RANGE = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or _prof.record_function)
_LAUNCHES = operator.attrgetter("launches")


def kernel_wrappers() -> Dict[str, Callable]:
    """{name: wrapper} of the hand-written kernels' wrappers
    (`ops/cuda/lbs.py`, `ops/cuda/mlp.py`); each adds one to its
    `.launches` where it launches its kernel (the plain versions on CPU
    tensors count nothing)."""
    from hosnerf_tpu_torch.ops.cuda import lbs, mlp
    return {name: f for mod in (lbs, mlp) for name, f in vars(mod).items()
            if callable(f) and hasattr(f, "launches")
            and not name.startswith("_")}


class _Session:
    """What the current (or last) profiler session recorded."""

    def __init__(self):
        self.generation = 0     # profiler starts seen by the hook
        self.seen = -1          # the generation these records belong to
        self.records: List[Dict] = []
        self.events: Dict[int, torch.cuda.Event] = {}
        self.rows: Dict[object, torch.Tensor] = {}
        self.backward: Optional[int] = None   # the open `backward` span
        self.wrappers: List = []
        self.names: List[str] = []
        self.device = None      # the card's index, None without one
        self.syncs = 0
        self.restore = None     # (sync debug mode, showwarning, filter)
        self.final: Optional[List[Dict]] = None


_S = _Session()
_LOCAL = threading.local()


def _stack() -> List[int]:
    """This thread's open spans (indices into the records), this
    session's."""
    if getattr(_LOCAL, "seen", None) != _S.seen:
        _LOCAL.stack, _LOCAL.seen = [], _S.seen
    return _LOCAL.stack


def _open() -> Optional[int]:
    """The innermost span open on this thread; on autograd's device
    thread, which opens none of its own, the open `backward` span."""
    stack = _stack()
    return stack[-1] if stack else _S.backward


def _showwarning(message, category, filename, lineno, file=None,
                 line=None):
    if SYNC_MESSAGE in str(message):
        _S.syncs += 1
        i = _open()
        if i is not None:
            _S.records[i].setdefault("sync_sites", []).append(
                f"{filename}:{lineno}")
    else:
        _S.restore[1](message, category, filename, lineno, file, line)


def _begin() -> None:
    """A new session (its start, or its first span where the profiler's
    starts cannot be followed): clear the last session's records and set
    up the counters."""
    _S.seen = _S.generation
    _S.records, _S.events, _S.rows = [], {}, {}
    _S.backward, _S.final, _S.syncs = None, None, 0
    wrappers = kernel_wrappers()
    _S.names, _S.wrappers = list(wrappers), list(wrappers.values())
    _S.device = (torch.cuda.current_device()
                 if torch.cuda.is_available() and torch.cuda.is_initialized()
                 else None)
    if _S.device is not None and _S.restore is None:
        mode = torch.cuda.get_sync_debug_mode()
        if mode == 0:
            with warnings.catch_warnings():     # "a prototype feature"
                warnings.simplefilter("ignore")
                torch.cuda.set_sync_debug_mode(1)
        warnings.filterwarnings("always", message=".*" + SYNC_MESSAGE)
        _S.restore = (mode, warnings.showwarning, warnings.filters[0])
        warnings.showwarning = _showwarning


def _end() -> None:
    """The session stopped: restore the sync debug mode and the warnings."""
    if _S.restore is None:
        return
    mode, show, flt = _S.restore
    if warnings.showwarning is _showwarning:
        warnings.showwarning = show
    _S.restore = None
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        torch.cuda.set_sync_debug_mode(mode)
    if flt in warnings.filters:
        warnings.filters.remove(flt)
        warnings._filters_mutated()     # as warnings.filterwarnings does


def _install_hooks() -> None:
    """Follow the profiler's starts and stops (torch.autograd.profiler's
    `_run_on_profiler_start` / `_run_on_profiler_stop`, which every
    session calls), so that a new session clears the records even when no
    span ran between two sessions, and the sync debug mode is restored as
    soon as recording stops."""
    start = getattr(_prof, "_run_on_profiler_start", None)
    stop = getattr(_prof, "_run_on_profiler_stop", None)
    if start is None or stop is None or getattr(start, "_spans", False):
        return

    def on_start():
        start()
        _S.generation += 1
        _begin()

    def on_stop():
        stop()
        _end()

    on_start._spans = True
    _prof._run_on_profiler_start = on_start
    _prof._run_on_profiler_stop = on_stop


_install_hooks()


def _counters(top: bool):
    """(launch counts, the card-wait counts or None)."""
    launches = tuple(map(_LAUNCHES, _S.wrappers))
    if _S.device is None:
        return launches, None
    if not top:
        return launches, (_S.syncs,)
    m = torch.cuda.memory_stats_as_nested_dict(_S.device)
    return launches, (_S.syncs, m["num_device_alloc"], m["num_device_free"])


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "step", "index", "seen", "rec", "rf", "c0")

    def __init__(self, name: str, step):
        self.name, self.step = name, step

    def __enter__(self):
        if _S.seen != _S.generation:
            _begin()
        parent = _open()
        step = self.step
        if step is None and parent is not None:
            step = _S.records[parent]["step"]
        self.index, self.seen = len(_S.records), _S.seen
        self.rec = {"name": self.name, "parent": parent, "step": step,
                    "thread": threading.get_ident()}
        _S.records.append(self.rec)
        _stack().append(self.index)
        if self.name == "backward":
            _S.backward = self.index
        self.rf = _RANGE(self.name)
        self.rf.__enter__()
        self.c0 = _counters(parent is None)
        if parent is None:
            self.rec["cpu0"] = time.process_time_ns()
        self.rec["t0"] = time.perf_counter_ns()
        return self.rec

    def __exit__(self, *exc):
        rec = self.rec
        rec["t1"] = time.perf_counter_ns()
        if "cpu0" in rec:
            rec["cpu1"] = time.process_time_ns()
        (l0, w0), (l1, w1) = self.c0, _counters(rec["parent"] is None)
        rec["launches"] = ({n: b - a for n, a, b in zip(_S.names, l0, l1)
                            if b != a} if l1 != l0 else {})
        rec["syncs"] = None if w0 is None else w1[0] - w0[0]
        if w0 is not None and len(w0) == 3:
            rec["device_allocs"] = w1[1] - w0[1]
            rec["device_frees"] = w1[2] - w0[2]
        same = self.seen == _S.seen
        if same and rec["parent"] is None and _S.device is not None:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record(torch.cuda.current_stream(_S.device))
            _S.events[self.index] = ev
        stack = _stack()
        if stack and stack[-1] == self.index:
            stack.pop()
        if same and _S.backward == self.index:
            _S.backward = None
        self.rf.__exit__(*exc)
        return False


def span(name: str, step=None):
    """A span of the step named `name` (`step`: the train step's
    iteration; the parent's when None): a context that records while a
    profiler session records and is empty otherwise."""
    if not _prof._is_profiler_enabled:
        return _OFF
    return _Span(name, step)


def spanned(name: str):
    """Decorator: the function runs inside `span(name)` (an autograd
    Function's forward or backward: the kernel entries' spans)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not _prof._is_profiler_enabled:
                return fn(*args, **kwargs)
            with _Span(name, None):
                return fn(*args, **kwargs)
        return run
    return wrap


def count_rows(domain, tile: int) -> None:
    """Add the sorted domain's live and computed rows
    (`BPDomain.row_counts(tile)`) to this step's accumulators on the card,
    while a profiler session records."""
    if not _prof._is_profiler_enabled:
        return
    parent = _open()
    step = _S.records[parent]["step"] if parent is not None else None
    rows = torch.stack(domain.row_counts(tile))
    if step in _S.rows:
        _S.rows[step] += rows
    else:
        _S.rows[step] = rows


def records() -> List[Dict]:
    """The records of the current or last session (see the module's
    doc), with the top-level spans' `device_ns` and the steps' rows; read
    from the card once a session (one synchronisation)."""
    if _S.final is not None:
        return _S.final
    recs = [dict(r) for r in _S.records]
    if _S.events:
        torch.cuda.synchronize(_S.device)
        ref = torch.cuda.Event(enable_timing=True)
        ref.record(torch.cuda.current_stream(_S.device))
        host = time.perf_counter_ns()
        ref.synchronize()
        for i, ev in _S.events.items():
            recs[i]["device_ns"] = host - int(ev.elapsed_time(ref) * 1e6)
    if _S.rows:
        keys = list(_S.rows)
        counts = torch.stack([_S.rows[k] for k in keys]).tolist()
        by_step = dict(zip(keys, counts))
        for r in recs:
            if r["name"] == "step" and r["parent"] is None \
                    and r["step"] in by_step:
                r["live_rows"], r["computed_rows"] = by_step[r["step"]]
    if not _prof._is_profiler_enabled:
        _S.final = recs
    return recs
