"""What the host did during the measured window, read from the process's
own counters: the main thread's CPU time and its time runnable but
waiting for a core (`/proc/thread-self/schedstat`), the process's
context switches, the machine's steal time (`/proc/stat`), Python's
garbage collections, and the spread of the host's time per step call.
Printed on standard error beside each run (`hosbench: host ...`); no
metric reads it. Both cells are host-paced, so this is where a slow run
shows why."""

from __future__ import annotations

import gc
import os
import resource
import threading
import time
from typing import Dict, List


def _schedstat():
    """(on-CPU s, waiting-to-run s) of the calling thread, or None."""
    try:
        with open("/proc/thread-self/schedstat") as f:
            run_ns, wait_ns = f.read().split()[:2]
        return int(run_ns) * 1e-9, int(wait_ns) * 1e-9
    except (OSError, ValueError):
        return None


def _steal():
    """(steal ticks, all ticks) of the machine, or None."""
    try:
        with open("/proc/stat") as f:
            cpu = [int(v) for v in f.readline().split()[1:]]
        return cpu[7], sum(cpu[:8])
    except (OSError, ValueError, IndexError):
        return None


class Meter:
    """Counters over a span: `start()`, `step()` after each step call
    returns, `stop()` -> a dict of the span's readings."""

    def __init__(self):
        self.gc_s = 0.0
        self.gc_n = [0, 0, 0]
        self._gc_t0 = None
        self.marks: List[float] = []

    def _gc_cb(self, phase, info):
        if phase == "start":
            self._gc_t0 = time.perf_counter()
        elif self._gc_t0 is not None:
            self.gc_s += time.perf_counter() - self._gc_t0
            self.gc_n[info["generation"]] += 1
            self._gc_t0 = None

    def start(self):
        self.sched0, self.steal0 = _schedstat(), _steal()
        self.ru0 = resource.getrusage(resource.RUSAGE_SELF)
        self.cpu0 = time.thread_time()
        gc.callbacks.append(self._gc_cb)
        self.marks = [time.perf_counter()]

    def step(self):
        self.marks.append(time.perf_counter())

    def stop(self) -> Dict:
        gc.callbacks.remove(self._gc_cb)
        sched, steal = _schedstat(), _steal()
        ru = resource.getrusage(resource.RUSAGE_SELF)
        d = sorted(b - a for a, b in zip(self.marks, self.marks[1:]))
        out = {"main_cpu_s": time.thread_time() - self.cpu0,
               "proc_cpu_s": (ru.ru_utime + ru.ru_stime
                              - self.ru0.ru_utime - self.ru0.ru_stime),
               "vol_switches": ru.ru_nvcsw - self.ru0.ru_nvcsw,
               "invol_switches": ru.ru_nivcsw - self.ru0.ru_nivcsw,
               "gc_s": self.gc_s, "gc_collections": list(self.gc_n),
               "threads": threading.active_count(),
               "os_threads": len(os.listdir("/proc/self/task"))
               if os.path.isdir("/proc/self/task") else None,
               "cores": len(os.sched_getaffinity(0)),
               "load": os.getloadavg()[0]}
        if d:
            out["step_call_ms"] = [1e3 * d[len(d) // 4], 1e3 * d[len(d) // 2],
                                   1e3 * d[3 * len(d) // 4], 1e3 * d[-1]]
        if sched and self.sched0:
            out["main_wait_s"] = sched[1] - self.sched0[1]
        if steal and self.steal0 and steal[1] > self.steal0[1]:
            out["steal_share"] = ((steal[0] - self.steal0[0])
                                  / (steal[1] - self.steal0[1]))
        return out
