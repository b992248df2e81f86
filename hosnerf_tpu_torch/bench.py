"""Stage-3 training throughput, rays/s on one card (counterpart of the JAX
repo's root `bench.py`, the same cell and the same line).

    python -m hosnerf_tpu_torch.bench                        # the card
    python -m hosnerf_tpu_torch.bench --device cpu --small   # test-only

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...extras}

The cell (`bench.py:171-174`): `Stage3Config(n_patches=2,
compute_dtype="bf16")` on `composed_batch(2, 32, grid_size=32)`, 2,048
rays, weights from seed 0, the step of `make_train_step` without an LPIPS
term (the loss's lpips is 0, as with bench.py's None LPIPS parameters).

Protocol: WARMUP steps, then ITERS steps issued back to back and one
`torch.cuda.synchronize()` at the end (`utils/benchtools.py::
timeit_chain`); step i runs at iteration 100 + i with its own CPU
generator (`tools/common.py::jitter`), so every step has its own inputs.
No value is read to the host inside the window; the losses are read after
it and must be finite. bench.py's two relay devices are not needed here:
its parameter probe keeps XLA from removing a backward whose outputs
nobody reads, and eager PyTorch runs every op; its `0 * prev_loss` fold
orders steps a relay could acknowledge before running them, and one CUDA
stream already runs the steps in order. The port's step updates the
parameters in place, as training does; bench.py's chain reuses the first
parameters (its new parameters are dropped). The work per step is the
same.

FLOPs: `torch.utils.flop_counter.FlopCounterMode` over one more step,
outside the timed window, counts the library work (the scene's
`nn.Linear`s, the weight-volume decoder's convolutions, the small pose
products): the counterpart of XLA's cost analysis. The hand-written
kernels are launched through ctypes and are invisible to it, as Pallas
was to XLA, so `kernel_flops_per_step` adds their work analytically. On
the CPU the plain kernel versions run as library ops and are counted too:
the CPU's count is not the card's. Where the counter fails, the
full-analytic `analytic_flops_per_step` is used, and `flops_source` says
which. The run fails, rather than reporting, when the implied rate
exceeds 1.05 x the H100 SXM's dense bf16 peak (989 TFLOP/s, data sheet).

The 8-patch point (`bench.py:244-315`): `Stage3Config(n_patches=8,
compute_dtype="bf16", remat="none", scene_remat="none",
human_remat="none")`, 2 + 8 steps, after the 2-patch state is freed;
`torch.cuda.max_memory_allocated` over its build and steps in GiB, with a
tripwire of its own. Unlike bench.py, its failure fails the run.

Each point's kernel launches (every wrapper's count set to 0 before its
build, read after its counted step) go to stderr as `bench: <n>-patch
point: <steps> steps, launches {...}`: on the card they show that the
step ran the hand-written kernels.

`--small` (test-only): tiny widths (`tools/common.py::SMALL`), 1 + 2
steps a point, the 8-patch point at patches of 8 x 8.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import sys
import time
import traceback
from typing import Callable, Dict, List, Optional

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card
from hosnerf_tpu_torch.utils.benchtools import timeit_chain

# --- baseline derivation, carried verbatim from bench.py (two anchors).
# Anchor A: the reference's full stage-3 step measured on one CPU core at
# these shapes (bench_ref_cpu.py AB_STAGE=full AB_PATCH=32), scaled by a
# 500-2000x CPU -> GPU uplift bracket. Anchor B: the reference's analytic
# 5.231 TFLOP a step (tools/ref_flops.py) in torch f32 at an A100's 19.5
# TFLOP/s f32 peak caps it. vs_baseline divides by the geometric midpoint
# of their intersection.
REF_FULL_CPU_SEC = 242.39
OURS_FULL_CPU_SEC = 351.31
GPU_UPLIFT_BRACKET = (500.0, 2000.0)
REF_STEP_FLOPS = 5.231e12
A100_F32_PEAK = 19.5e12

N_PATCHES = 2  # the reference production batch per rank
RAYS = N_PATCHES * 32 * 32
WARMUP = 3
ITERS = 20
WARMUP_8, ITERS_8 = 2, 8

# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), for the
# tripwire and MFU; the run refuses a rate above TRIPWIRE x this
BF16_PEAK_TFLOPS = 989.0
TRIPWIRE = 1.05

# live-suffix fraction of the liveness-sorted human path, carried
# verbatim from bench.py (the trunks and the forward LBS run on the rows
# past the dead prefix; the card's sorted domain reads 0.4525 at this
# cell, tools/fg_density_study.py)
LIVE_FRACTION = 0.46
# (sample, bone) pairs inside a bone's support: the inverse-LBS kernels'
# data-dependent work (tools/fg_density_study.py "pair density (true)" at
# 2 patches of this cell on an H100)
PAIR_DENSITY = 0.2370
# f32 operations of the LBS kernels (as chip_smoke.py counts them for
# their bounds): B1 / B4 per live (sample, bone) pair (affine 18, taps 24,
# xy weights 4, z column 16, blend 8; the backward adds the derivative
# taps, the dvol products and the affine's adjoint); B5 forward / backward
# per (computed sample, bone) at K = 2 transform sets (z columns 16,
# weight 4, blend 2 x 12K; the backward adds dw 2 x 12K, dvol/U 32, dfz 6)
OPS_B1_PAIR, OPS_B4_PAIR = 75, 250
OPS_B5F_BONE, OPS_B5B_BONE = 68, 166

COUNTED = "flop_counter+kernels_analytic"
ANALYTIC = "analytic"
GIB = 2 ** 30


class SuperPeak(RuntimeError):
    """A step time implying more than TRIPWIRE x the card's peak: a
    measurement artifact, not a result."""


def trunk_flops(cfg) -> float:
    """The fused embed + trunk kernels (B2 forward, B3 recompute, rows and
    dW: ~4x the forward products) over the live share of the samples:
    bench.py's `mlps` term (exact layer dims incl. skip concats;
    CanonicalMLP 8x256 over N samples, NonRigidMLP 6x128 over 3N)."""
    n = cfg.n_patches * cfg.patch_size ** 2 * cfg.n_samples
    cnl_mac = 127 * 256 + 6 * 256 * 256 + 383 * 256 + 256 * 4
    nr_mac = 111 * 128 + 4 * 128 * 128 + 164 * 128 + 128 * 3
    return 4 * 2.0 * LIVE_FRACTION * (n * cnl_mac + 3 * n * nr_mac)


def kernel_flops_terms(cfg) -> Dict[str, float]:
    """{'trunks', 'inverse_lbs', 'forward_lbs'}: per-step operations of the
    hand-written kernels, which the flop counter cannot see. The LBS terms
    count the taps and blends the Hopper kernels compute (B1 + B4 on the
    live pairs, B5 forward + backward on the live rows), not bench.py's
    one-hot [1, G^2] @ [G^2, G] products, which only the TPU technique
    does."""
    n = cfg.n_patches * cfg.patch_size ** 2 * cfg.n_samples
    b = cfg.total_bones
    return {
        "trunks": trunk_flops(cfg),
        "inverse_lbs": (OPS_B1_PAIR + OPS_B4_PAIR) * PAIR_DENSITY * n * b,
        "forward_lbs": (OPS_B5F_BONE + OPS_B5B_BONE) * LIVE_FRACTION * n * b,
    }


def kernel_flops_per_step(cfg) -> float:
    return sum(kernel_flops_terms(cfg).values())


def scene_flops_per_step(cfg) -> float:
    """bench.py's analytic scene stack: proposal 2 x 64 samples a ray
    (4 x 256), NeRF 32 (8 x 1024), forward + 2x backward (no remat at the
    2-patch point), dominant products only."""
    rays = cfg.n_patches * cfg.patch_size ** 2
    prop = 2 * rays * 64 * (4 * 256 * 256 + 2 * 256 * 80) * 2
    nerf = rays * 32 * (8 * 1024 * 1024 + 2 * 1024 * 80) * 2
    return 3.0 * (prop + nerf)


def analytic_flops_per_step(cfg) -> float:
    """Full-analytic fallback: the scene stack and the kernels."""
    return scene_flops_per_step(cfg) + kernel_flops_per_step(cfg)


def counted_flops(fn: Callable[[], object]) -> Optional[float]:
    """FLOPs of the library ops fn() runs, forward and backward
    (FlopCounterMode); None where the counter fails or sees none."""
    from torch.utils.flop_counter import FlopCounterMode
    try:
        with FlopCounterMode(display=False) as counter:
            fn()
        return float(counter.get_total_flops()) or None
    except Exception:  # the analytic count stands in, named
        traceback.print_exc(file=sys.stderr)
        print("bench: flop counter failed; analytic count used",
              file=sys.stderr, flush=True)
        return None


def implied_tflops(flops: float, sec_per_step: float) -> float:
    """TFLOP/s that `flops` a step in `sec_per_step` imply; SuperPeak above
    TRIPWIRE x BF16_PEAK_TFLOPS."""
    implied = flops / sec_per_step / 1e12
    if not implied <= BF16_PEAK_TFLOPS * TRIPWIRE:
        raise SuperPeak(
            f"implied {implied:.0f} TFLOP/s exceeds {TRIPWIRE} x the card's "
            f"peak {BF16_PEAK_TFLOPS} TFLOP/s: a measurement artifact, "
            "refusing to report")
    return implied


def baseline_basis(rays_per_sec: float):
    """(vs_baseline, baseline_basis) of bench.py for `rays_per_sec`."""
    # anchor A: CPU-measured step scaled by the uplift bracket
    a_lo, a_hi = [RAYS / (REF_FULL_CPU_SEC / u) for u in GPU_UPLIFT_BRACKET]
    # anchor B: FLOPs ceiling (100% MFU on A100 f32)
    b_cap = RAYS / (REF_STEP_FLOPS / A100_F32_PEAK)
    ref_lo, ref_hi = a_lo, min(a_hi, b_cap)
    ref_mid = (ref_lo * ref_hi) ** 0.5
    return round(float(rays_per_sec / ref_mid), 3), {
        "anchor_a": ("bench_ref_cpu.py AB_STAGE=full AB_PATCH=32 — "
                     "the reference's COMPLETE stage-3 step at "
                     "identical 2048-ray shapes on this host CPU, "
                     "2026-08-19, scaled by a 500-2000x CPU->GPU "
                     "uplift bracket"),
        "ref_full_step_cpu_sec": REF_FULL_CPU_SEC,
        "ours_full_step_cpu_sec": OURS_FULL_CPU_SEC,
        "gpu_uplift_bracket": list(GPU_UPLIFT_BRACKET),
        "anchor_b": ("tools/ref_flops.py — the reference's analytic "
                     "5.23 TFLOP/step in torch f32 (no AMP, TF32 "
                     "matmul off) cannot beat 268 ms/step even at "
                     "100% MFU on an A100's 19.5 TFLOPS f32 peak"),
        "ref_step_flops": REF_STEP_FLOPS,
        "ref_rays_s_flops_ceiling": round(b_cap, 1),
        "ref_gpu_rays_per_sec_bracket": [round(ref_lo, 1), round(ref_hi, 1)],
        "ref_gpu_rays_per_sec_mid_geo": round(ref_mid, 1),
        "vs_baseline_bracket": [round(float(rays_per_sec / ref_hi), 3),
                                round(float(rays_per_sec / ref_lo), 3)],
    }


def point_config(n_patches: int, small: bool = False):
    """The 2-patch cell or the 8-patch point (remat 'none' everywhere);
    `small`: the test-only widths, and patches of 8 x 8 at 8 patches."""
    if n_patches == N_PATCHES:
        return common.stage3_config(n_patches, small=small)
    return common.split_config(n_patches, ("none", "none"),
                               8 if small else 32, small)


def kernel_wrappers() -> Dict[str, Callable]:
    """{name: wrapper} of the hand-written kernels' wrappers
    (`ops/cuda/`); each adds one to its `.launches` where it launches its
    kernel (the plain versions on CPU tensors count nothing)."""
    from hosnerf_tpu_torch.ops.cuda import lbs, mlp
    return {name: f for mod in (lbs, mlp) for name, f in vars(mod).items()
            if callable(f) and hasattr(f, "launches")
            and not name.startswith("_")}


def zero_launches() -> Dict[str, Callable]:
    """kernel_wrappers() with every launch count set to 0."""
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


def report_launches(cfg, steps: int, wrappers: Dict[str, Callable]):
    """The launches since `zero_launches` to stderr: `bench: <n>-patch
    point: <steps> steps, launches {...}`."""
    launches = {k: w.launches for k, w in wrappers.items()}
    print(f"bench: {cfg.n_patches}-patch point: {steps} steps, launches "
          f"{json.dumps(launches)}", file=sys.stderr, flush=True)


def run_point(cfg, device, warmup: int, iters: int):
    """Build the step of `cfg` (weights from seed 0) and time it: (seconds
    per step, every step's losses, a function running one more step). The
    build's and the warm-up's wall times (the first step builds the
    kernels where no build is cached) go to stderr."""
    t0 = time.perf_counter()
    step, batch, _ = common.stage3_step(cfg, device)
    out: List[Dict[str, torch.Tensor]] = []

    def one(i):
        out.append(step(batch, 100.0 + i, common.jitter(i)))

    t1 = time.perf_counter()
    sec = timeit_chain(one, [(i,) for i in range(warmup + iters)], iters,
                       warmup)
    chain = time.perf_counter() - t1
    print(f"bench: {cfg.n_patches}-patch point: build {t1 - t0:.2f} s, "
          f"{warmup} warm-up steps {chain - sec * iters:.2f} s, {iters} "
          f"timed steps {sec * iters:.2f} s", file=sys.stderr, flush=True)
    losses = [{k: float(v) for k, v in ls.items()} for ls in out]
    for i, ls in enumerate(losses):
        if not all(math.isfinite(v) for v in ls.values()):
            raise RuntimeError(f"bench: non-finite losses at step {i} of "
                               f"{cfg.n_patches} patches: {ls}")
    n = warmup + iters
    return sec, losses, lambda: step(batch, 100.0 + n, common.jitter(n))


def point_flops(cfg, extra_step):
    """(FLOPs a step, their source, the counted part or None)."""
    t0 = time.perf_counter()
    counted = counted_flops(extra_step)
    print(f"bench: {cfg.n_patches}-patch point: the counted step "
          f"{time.perf_counter() - t0:.2f} s", file=sys.stderr, flush=True)
    if counted:
        return counted + kernel_flops_per_step(cfg), COUNTED, counted
    return analytic_flops_per_step(cfg), ANALYTIC, None


def run(device, small: bool = False) -> dict:
    """Both points; the JSON record (keys as bench.py's line, the XLA and
    Pallas counts renamed `model_tflops_counted` / `model_tflops_kernels`,
    `device` added). The losses of every step go to stderr."""
    warmup, iters = (1, 2) if small else (WARMUP, ITERS)
    cfg = point_config(N_PATCHES, small)
    wrappers = zero_launches()
    sec_per_step, losses, extra = run_point(cfg, device, warmup, iters)
    print(f"bench: {N_PATCHES}-patch losses "
          f"{json.dumps([ls['loss'] for ls in losses])}", file=sys.stderr,
          flush=True)
    flops, flops_src, counted = point_flops(cfg, extra)
    report_launches(cfg, warmup + iters + 1, wrappers)
    kernel_flops = kernel_flops_per_step(cfg)
    implied = implied_tflops(flops, sec_per_step)
    del extra
    gc.collect()

    # the 8-patch point, on a card freed of the 2-patch state
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    warmup8, iters8 = (1, 2) if small else (WARMUP_8, ITERS_8)
    cfg8 = point_config(8, small)
    wrappers = zero_launches()
    big_sec, losses8, extra8 = run_point(cfg8, device, warmup8, iters8)
    hbm8 = torch.cuda.max_memory_allocated(device) / GIB if cuda else None
    print(f"bench: 8-patch losses "
          f"{json.dumps([ls['loss'] for ls in losses8])}", file=sys.stderr,
          flush=True)
    implied_tflops(point_flops(cfg8, extra8)[0], big_sec)
    report_launches(cfg8, warmup8 + iters8 + 1, wrappers)
    big_rays = cfg8.n_patches * cfg8.patch_size ** 2

    # the step runs on one card: rays/s per card is rays/s
    rays_per_sec = cfg.n_patches * cfg.patch_size ** 2 / sec_per_step
    vs_baseline, basis = baseline_basis(rays_per_sec)
    return {
        "metric": "stage3_train_rays_per_sec_per_chip",
        "value": round(float(rays_per_sec), 1),
        "unit": "rays/s/chip",
        "vs_baseline": vs_baseline,
        "sec_per_step": round(sec_per_step, 5),
        "model_tflops_per_step": round(flops / 1e12, 4),
        "flops_source": flops_src,
        "model_tflops_counted": (round(counted / 1e12, 4) if counted
                                 else None),
        "model_tflops_kernels": round(kernel_flops / 1e12, 4),
        "implied_tflops": round(implied, 2),
        "mfu_vs_bf16_peak": round(implied / BF16_PEAK_TFLOPS, 4),
        "baseline_basis": basis,
        "sec_per_step_8patch": round(big_sec, 5),
        "rays_per_sec_8patch": round(big_rays / big_sec, 1),
        "hbm_peak_gb_8patch": round(hbm8, 2) if cuda else None,
        "device": common.device_record(device),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--small", action="store_true",
                    help="test-only: tiny widths (tools/common.py::SMALL), "
                         "1 + 2 steps a point")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(json.dumps(run(device, args.small)), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
