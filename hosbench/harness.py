"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line. Everything a cell needs is found by
name: its entry in `BENCHMARK.json`, its configuration
(`hosbench/configs/<config>.json` and `<config>.py`), its traffic mix
(`hosbench/traffic/<mix>.json`) and its per-layer metrics
(`hosbench/layers/<metric>.py`).

Set-up builds the port's training state on weights made from the seed,
the pool of batches, and runs the first three steps through the window's
own step call on pool batches 0-2 (they are the warm-up too), reading
after the first the gradient Adam received (its first moment / 0.1) and
after the third each parameter's change; one more step warms the
allocator. The window then issues steps back to back over the pool, each
with its own jitter generator, and ends in `torch.cuda.synchronize()`.
With `--trace 1` a span of steps in the middle of the window runs under
`torch.profiler`. After the window the peak memory is read, the program's
state freed, and the reference trains its own f32 copy of the same
weights on the same three batches and jitter; `correct` holds when each
compared number is within its limit (`hosbench/check.py`).
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import sys
import time
from typing import Dict, List

import torch

from hosbench import check, counts, host, pool, trace
from hosbench import weights as W

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "hosnerf_tpu")
GIB = 2 ** 30
N_CHECKED = 3            # steps the reference follows
TRACE_STEPS = 4          # steps under the profiler (--trace 1)


def load_module(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A workload of BENCHMARK.json with its configuration and mix."""

    def __init__(self, workload: str, small: bool = False):
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        wl = [w for w in self.bench["workloads"] if w["name"] == workload]
        if not wl:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.workload = wl[0]
        self.name = workload
        self.small = small
        cname = self.workload["config"]
        with open(os.path.join(HERE, "configs", f"{cname}.json")) as f:
            self.conf = json.load(f)
        self.mod = load_module(os.path.join(HERE, "configs", f"{cname}.py"),
                               "hosbench_config_" + cname.replace("-", "_"))
        self.mix = pool.load_mix(self.workload["traffic"])
        if small:
            self.mix.update(self.mix.get("small", {}))
        self.s = self.mod.settings(self.conf, small)
        self.world = (self.mix.get("ranks", 1) if small
                      else self.workload["chips"])

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"]
                if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        reported = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if (self.name in m["workloads"] if "workloads" in m
                    else m["moves"] in reported)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's
    (compared whole: `hosnerf_tpu_torch` is not `hosnerf_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def adam_grads(prog) -> Dict[str, torch.Tensor]:
    """The first step's gradient per parameter as Adam received it: its
    first moment after one step over (1 - beta1), copied to the host."""
    out = {}
    for name, p in prog.named_params():
        st = prog.opt.state.get(p, {})
        if "exp_avg" in st:
            out[name] = (st["exp_avg"].float() / 0.1).to("cpu", copy=True)
    return out


def change_norms(prog, p0) -> Dict[str, float]:
    with torch.no_grad():
        return {name: float(torch.linalg.vector_norm(p.float() - p0[name]))
                for name, p in prog.named_params()}


def run(cell: Cell, seed: int, seconds: float, traced: bool, device,
        rank: int = 0, world: int = 1, t_start: float = None,
        control: str = None) -> Dict:
    """One run on this rank; rank 0 returns the result record (others
    return None). `control`: test and calibration use only ('fp8' puts
    the reference's fp8 readings in the program's place)."""
    t_start = time.perf_counter() if t_start is None else t_start
    marks = [("start", time.perf_counter() - t_start)]

    def mark(what):
        sync(device)
        marks.append((what, time.perf_counter() - t_start))

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    mark("card")
    mod, s, mix = cell.mod, cell.s, cell.mix
    specs = mod.weight_specs(s)
    params = W.make(specs, seed, device)
    mark("weights")
    prog = mod.Program(s, mix, params, device)
    del params
    mark("program")
    made = mod.batches(s, mix, seed)
    frames = pool.to_device(made, device)
    mark("pool")
    if world > 1:
        from hosnerf_tpu_torch.parallel import mesh
        feed = [mesh.shard_batch(b, rank, world, keys=mesh.RAY_KEYS)
                for b in frames]
    else:
        feed = frames
    n_pool = len(feed)

    def step(i):
        return prog.step(feed[i % n_pool], i, mod.generator(seed, i, device))

    # set-up: the compared steps 0-2 are the warm-up
    losses = []
    for i in range(N_CHECKED):
        out = step(i)
        losses.append(out["loss"])
        if i == 0:
            grads = adam_grads(prog)
            terms = {k: float(v) for k, v in out.items() if v.numel() == 1}
            mark("step 0")
    p0 = W.make(specs, seed, device)
    readings = {"losses": [float(x) for x in losses], "terms": terms,
                "grad_norms": {k: float(torch.linalg.vector_norm(g))
                               for k, g in grads.items()},
                "change_norms": change_norms(prog, p0)}
    del p0
    t0 = time.perf_counter()
    step(N_CHECKED)
    sync(device)
    warm_step = time.perf_counter() - t0
    n_steps = None
    if world > 1:
        import torch.distributed as dist
        est = torch.tensor([warm_step], dtype=torch.float64,
                           device=device if cuda else "cpu")
        dist.broadcast(est, 0)
        n_steps = max(TRACE_STEPS + 2, int(math.ceil(seconds / float(est))))
    setup_s = time.perf_counter() - t_start
    note(rank, f"set-up {setup_s:.2f} s (the last warm-up step "
               f"{warm_step:.3f} s; at " + ", ".join(
                   f"{w} {t:.2f}" for w, t in marks) + ")")

    # the measured window
    window_losses, first = [], N_CHECKED + 1
    i, prof_info = first, None
    meter = host.Meter()
    meter.start()
    t_w = time.perf_counter()
    while True:
        if traced and prof_info is None and (
                (n_steps is not None and i - first >= n_steps // 2)
                or (n_steps is None and time.perf_counter() - t_w
                    >= seconds / 2)):
            prof_info = profile_span(step, i, TRACE_STEPS, device)
            i += TRACE_STEPS
            continue
        window_losses.append(step(i)["loss"])
        meter.step()
        i += 1
        if n_steps is not None:
            if i - first >= n_steps:
                break
        elif (time.perf_counter() - t_w >= seconds
              and (prof_info is not None or not traced)):
            break
    sync(device)
    window_s = time.perf_counter() - t_w
    steps_run = i - first
    host_use = meter.stop()
    finite = bool(torch.isfinite(torch.stack(window_losses)).all())
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0

    # what the process loaded by the window's close
    found = forbidden_modules()

    first_grads = grads if rank == 0 else None
    mine = {"readings": readings, "peak": peak, "finite": finite,
            "prof": prof_info, "setup_s": setup_s, "window_s": window_s,
            "steps": steps_run}
    if world > 1:
        import torch.distributed as dist
        everyone = [None] * world
        dist.all_gather_object(everyone, mine)
    else:
        everyone = [mine]
    del prog, feed, step
    if rank != 0:
        return None
    if cuda:
        torch.cuda.empty_cache()

    note(rank, f"window {window_s:.3f} s, {steps_run} steps")
    note(rank, "host in the window " + json.dumps(host_use))

    # the reference, after the window, on rank 0
    t_ref = time.perf_counter()
    params = W.make(specs, seed, device)
    ref = mod.reference(s, mix, params, frames[:N_CHECKED], seed, device,
                        "f32")
    ctrl = (mod.reference(s, mix, params, frames[:N_CHECKED], seed, device,
                          control) if control else None)
    note(rank, f"reference {time.perf_counter() - t_ref:.2f} s")
    shapes = counts.shapes_of(specs)
    step_counts = []
    if traced and prof_info is not None:
        step_counts = [mod.step_counts(s, mix, shapes,
                                       frames[j % len(frames)], seed, j,
                                       device)
                       for j in prof_info["steps"]]
    del params, frames
    worst = None
    for rank_i, r in enumerate(everyone):
        prog_readings = dict(ctrl if control else r["readings"])
        if rank_i == 0:
            prog_readings["grads"] = (ctrl["grads"] if control
                                      else first_grads)
        g = check.gaps(prog_readings, ref)
        if worst is None:
            worst = g
        else:
            for k in check.NUMBERS:
                if g[k] == g[k]:          # nan: not read on this rank
                    worst[k] = max(worst[k], g[k])
    limits = cell.conf["small_limits" if cell.small else "limits"]
    compared = {k: {"value": worst[k], "limit": v}
                for k, v in limits.items()}
    finite = all(r["finite"] for r in everyone)
    correct = (finite and all(v["value"] <= v["limit"]
                              for v in compared.values())
               and not found)
    return {"everyone": everyone, "compared": compared, "worst": worst,
            "correct": correct, "found": found, "step_counts": step_counts,
            "ref": ref, "ctrl": ctrl, "first_grads": first_grads}


def note(rank: int, text: str) -> None:
    if rank == 0:
        print(f"hosbench: {text}", file=sys.stderr, flush=True)


def profile_span(step, first: int, n: int, device) -> Dict:
    """Steps first .. first + n - 1 under torch.profiler, synchronised
    before and after: their wall time and the trace's summary."""
    from torch.profiler import ProfilerActivity, profile
    acts = ([ProfilerActivity.CUDA] if device.type == "cuda"
            else [ProfilerActivity.CPU])
    sync(device)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for j in range(first, first + n):
            step(j)
        sync(device)
        span = time.perf_counter() - t0
    info = trace.summarize(trace.device_events(prof))
    info.update(span_s=span, steps=list(range(first, first + n)))
    return info


def layer_metrics(cell: Cell, res: Dict, world: int) -> Dict:
    """The cell's per-layer metrics from rank 0's profiled span."""
    info = res["everyone"][0]["prof"]
    if info is None:
        return {}
    n = len(info["steps"])
    ctx = {"steps": n, "span_s": info["span_s"], "busy_s": info["busy_s"],
           "groups": info["groups"], "b_kernels": info["b_kernels"],
           "counts": res["step_counts"], "world": world,
           "per_step_ms": (lambda g: 1e3 * info["groups"][g] / n
                           if info["groups"][g] > 0 else None)}
    out = {}
    for m in cell.per_layer():
        reader = load_module(os.path.join(HERE, "layers", f"{m['name']}.py"),
                             "hosbench_layer_" + m["name"].replace(".", "_"))
        v = reader.read(ctx)
        if v is not None:
            out[m["name"]] = {"value": v, "unit": m["unit"]}
    return out


def result_line(cell: Cell, res: Dict, traced: bool, device, world: int
                ) -> Dict:
    everyone = res["everyone"]
    r0 = everyone[0]
    metrics = {}
    if not traced:
        for m in cell.end_to_end():
            n = m["name"]
            if n == "setup_s":
                v = r0["setup_s"]
            elif n == "peak_mem_gib":
                v = max(r["peak"] for r in everyone) / GIB
            elif n.endswith("rays_per_s"):
                v = r0["steps"] * cell_rays(cell) / r0["window_s"]
            else:
                raise SystemExit(f"no end-to-end metric {n!r} here")
            metrics[n] = {"value": v, "unit": m["unit"]}
    else:
        metrics = layer_metrics(cell, res, world)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": world,
           "memory_peak_bytes": max(r["peak"] for r in everyone)}
    out = {"correct": res["correct"],
           "attempted": r0["steps"] + N_CHECKED + 1,
           "failed": 0 if res["correct"] else 1,
           "metrics": metrics, "device": dev}
    if traced and r0["prof"] is not None:
        profs = [r["prof"] for r in everyone if r["prof"] is not None]
        dev["busy_s"] = sum(p["busy_s"] for p in profs) / len(profs)
        dev["window_s"] = r0["prof"]["span_s"]
        out["breakdown"] = {"device_ops": r0["prof"]["device_ops"],
                            "idle_gaps": r0["prof"]["idle_gaps"]}
    out["checks"] = {k: v for k, v in res["compared"].items()}
    return out


def cell_rays(cell: Cell) -> int:
    if cell.mix["kind"] == "composed":
        return cell.mix["n_patches"] * cell.mix["patch_size"] ** 2
    return cell.mix["n_rays"]
