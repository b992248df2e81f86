"""The training loop for the three stages (counterpart of
`hosnerf_tpu/train/loop.py`): one Python loop around a stage's
`train_step(batch, step, generator)`, with

  * step-time / rays-per-sec counters, JSONL, stdout and TensorBoard
    metric logging, and an optional torch.profiler trace,
  * best/last checkpoints of the full train state (models, optimizer,
    update count, step, the loop generator), so --resume_training
    continues the LR schedules, Adam's moments and the jitter draws,
  * host-side batch prefetch in one worker thread (sampling or loading,
    then `to_device`),
  * the in-training progress eval at steps {100, 300, 1000, 2500} and
    every `progress_every`, with the empty-render trap,
  * a NaN check that halts with context.

The port's models hold their weights, so the loop carries no params: the
step updates them in place and the checkpoints read them from `models`.
The JAX loop's per-step key split becomes a CPU `torch.Generator` that
the loop owns and hands to every step.

Under a process group (`parallel/`) every rank runs this loop on its
share of the same global batch (checked on the first step), with the same
generator state; rank 0 alone writes the logs, TensorBoard events,
profile and checkpoints, and the ranks wait for each checkpoint to be
written.
"""

from __future__ import annotations

import json
import os
import queue
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from hosnerf_tpu_torch.parallel import distributed, mesh
from hosnerf_tpu_torch.train import checkpoints as ckpt_lib
from hosnerf_tpu_torch.utils.tb_writer import TBWriter

# the reference's early-feedback steps (2nd model.py:600-601)
PROGRESS_STEPS = (100, 300, 1000, 2500)


def set_reproducible() -> None:
    """The library settings under which the same state, batch and
    generator give the same bits on one card: cuDNN takes deterministic
    algorithms and no benchmark search, cuBLAS a fixed workspace
    (CUBLAS_WORKSPACE_CONFIG, read when its handle is made: call this
    before the first product on the card). The port's own kernels sum in
    fixed orders already. Called where a run starts (cli/run.py,
    chip_smoke.py), not at import."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False


class MetricLogger:
    """JSONL + stdout + TensorBoard metric logging with
    step-time/rays-per-sec counters, every `log_every` steps."""

    def __init__(self, logdir: str, log_every: int = 100):
        os.makedirs(logdir, exist_ok=True)
        self.path = os.path.join(logdir, "metrics.jsonl")
        self.log_every = log_every
        self._f = open(self.path, "a")
        self._tb = TBWriter(logdir)
        self._t_last = time.perf_counter()
        self._step_last = 0

    def log(self, step: int, metrics: Dict[str, Any],
            rays_per_step: Optional[int] = None,
            lr: Optional[float] = None):
        """`lr` mirrors the reference's LearningRateMonitor."""
        if step % self.log_every:
            return
        if lr is not None:
            metrics = {**metrics, "lr": lr}
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        now = time.perf_counter()   # after the values reached the host
        dt = now - self._t_last
        n = max(step - self._step_last, 1)
        rec["sec_per_step"] = dt / n
        if rays_per_step:
            rec["rays_per_sec"] = rays_per_step * n / dt
        self._t_last = now
        self._step_last = step
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()
        for k, v in rec.items():
            if k != "step":
                self._tb.add_scalar(f"train/{k}", v, step)
        self._tb.flush()
        print(f"[step {step}] " + " ".join(
            f"{k}={v:.5g}" for k, v in rec.items() if k != "step"),
            flush=True)

    def close(self):
        self._f.close()
        self._tb.close()


class _Silent:
    """The logger of a rank other than 0: logs nothing."""

    def log(self, *args, **kwargs):
        pass

    def close(self):
        pass


def check_finite(step: int, loss) -> None:
    if not np.isfinite(float(loss)):
        raise FloatingPointError(
            f"non-finite loss at step {step}: {float(loss)} - halting")


class EmptyRenderError(RuntimeError):
    """Raised when an in-training progress render produces only background
    (the reference's 'Produce empty images.' trap, 2nd model.py:545-560)."""


class BatchPrefetcher:
    """Host-side prefetch thread: overlaps `sample_fn()` (decode, patch
    sampling, pinning and the host-to-device copy) with the running device
    step. Depth-`depth` queue; an exception in the worker is raised in the
    consumer."""

    def __init__(self, sample_fn: Callable[[], Any], depth: int = 2):
        self._fn = sample_fn
        self._q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        self._stop = threading.Event()
        self._t = threading.Thread(target=self._work, daemon=True)
        self._t.start()

    def _work(self):
        while not self._stop.is_set():
            try:
                item = (True, self._fn())
            except BaseException as e:  # handed to the consumer, raised there
                item = (False, e)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if not item[0]:
                return

    def get(self):
        ok, item = self._q.get()
        if not ok:
            self.close()
            raise item
        return item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._t.join(timeout=2.0)


def _start_profile():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.start()
    return prof


def run_training(
        *, num_steps: int, sample_batch: Callable[[], Dict[str, Any]],
        step_fn: Callable, models: Dict[str, torch.nn.Module],
        optimizer: Optional[torch.optim.Optimizer], logdir: str,
        rays_per_step: Optional[int] = None, log_every: int = 100,
        checkpoint_every: int = 2000,
        val_fn: Optional[Callable[[int], float]] = None,
        val_every: int = 50_000,
        generator: Optional[torch.Generator] = None,
        profile_steps: Optional[tuple] = None,
        lr_schedule: Optional[Callable[[int], float]] = None,
        start_step: int = 0,
        progress_fn: Optional[Callable[[int], Dict]] = None,
        progress_every: int = 0,
        abort_on_empty: bool = True,
        prefetch: int = 2) -> torch.Generator:
    """Run steps [start_step, num_steps): step_fn(batch, step, generator)
    -> aux (a dict with 'loss'), updating `models` in place.

    sample_batch() -> a device batch (run in the prefetch thread unless
    prefetch=0). The checkpoints hold `models`, `optimizer` and the
    generator (a CPU one; seeded 0 when None), saved as 'last' every
    `checkpoint_every` steps and at the end, and as 'best' when
    val_fn(step) (every `val_every` steps) beats the best so far; the
    saved step is the next one to run. progress_fn(step) -> dict (may
    hold 'is_empty_img') runs at PROGRESS_STEPS and every
    `progress_every`. profile_steps=(a, b) traces steps a..b with
    torch.profiler into <logdir>/profile/trace.json. Under a process
    group every rank calls this (val_fn and progress_fn render on every
    rank) and rank 0 writes. Returns the generator."""
    gen = generator if generator is not None else torch.Generator()
    if generator is None:
        gen.manual_seed(0)
    primary = distributed.is_primary()
    logger = MetricLogger(logdir, log_every) if primary else _Silent()
    ckptr = ckpt_lib.BestLastCheckpointer(os.path.join(logdir, "ckpt"))

    def train_state(next_step):
        return ckpt_lib.pack_train_state(models, optimizer, next_step, gen)

    def save_last(next_step):
        if primary:
            ckptr.save_last(train_state(next_step))
        distributed.barrier()

    def save_best(next_step, monitored):
        if primary:
            ckptr.maybe_save_best(train_state(next_step), monitored)
        distributed.barrier()

    fetcher = (BatchPrefetcher(sample_batch, prefetch) if prefetch
               else None)
    prof = None
    try:
        for step in range(start_step, num_steps):
            if primary and profile_steps and step == profile_steps[0]:
                prof = _start_profile()
            batch = fetcher.get() if fetcher else sample_batch()
            if step == start_step:
                mesh.check_same_batch(batch)
            aux = step_fn(batch, step, gen)
            if prof is not None and step == profile_steps[1]:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                prof.stop()
                os.makedirs(os.path.join(logdir, "profile"), exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(logdir, "profile", "trace.json"))
                prof = None

            logger.log(step, aux, rays_per_step,
                       lr=(float(lr_schedule(step)) if lr_schedule
                           and step % log_every == 0 else None))
            if step % 500 == 0:
                check_finite(step, aux["loss"])
            if checkpoint_every and step and step % checkpoint_every == 0:
                save_last(step + 1)
            if val_fn is not None and step and step % val_every == 0:
                save_best(step + 1, val_fn(step))
            if progress_fn is not None and step and (
                    step in PROGRESS_STEPS
                    or (progress_every and step % progress_every == 0)):
                prog = progress_fn(step)
                if prog and primary:
                    print(f"[progress {step}] " + " ".join(
                        f"{k}={v}" for k, v in prog.items()
                        if v is not None), flush=True)
                if prog and prog.get("is_empty_img"):
                    msg = (f"progress render at step {step} produced only "
                           "background (reference: 'Produce empty "
                           "images.')")
                    if abort_on_empty:
                        raise EmptyRenderError(msg)
                    if primary:
                        print("WARNING: " + msg, flush=True)
    finally:
        if fetcher:
            fetcher.close()
        if prof is not None:
            prof.stop()

    save_last(num_steps)
    logger.close()
    return gen
