"""The two routes to f32-grade products on an H100's tensor cores, side by
side: bf16x3 (six bf16 products per f32 product) and 3xTF32 (three TF32
products), the choice behind the f32 ("highest") trunk kernels
(csrc/trunk_common.cuh). Needs a CUDA device.

    python -m hosnerf_tpu_torch.tools.f32_route_ab

For each route, csrc/f32_route_ab.cu multiplies a resident [64 x 64] f32 A
tile by a [64 x 128] B tile in one warpgroup per CTA: once, for the error
against a float64 product (max error over the reference's largest entry,
and beside it the same of torch.matmul in f32 with TF32 off); then `reps`
times in two CTAs per SM, for the rate of f32-grade products (CUDA events,
mean of 5 launches after a warm-up) against the 165 TFLOP/s both routes
reach at the card's peak (989 TFLOP/s bf16 / 6, 495 TF32 / 3). Prints one
line per route and the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import subprocess

import numpy as np
import torch

from hosnerf_tpu_torch.ops.cuda import _build
from hosnerf_tpu_torch.utils import card

ROUTES = ("bf16x3", "3xTF32")
M, N, K = 64, 128, 64
PEAK = 989e12 / 6     # f32-grade products per second at the peak


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("f32_route_ab")
    p, i = ctypes.c_void_p, ctypes.c_int
    _build.declare(lib, "hosnerf_f32_route_ab", [i, p, p, p, i, i, p])
    return lib


def run(route: int, a, b, ctas: int, reps: int) -> torch.Tensor:
    """[ctas, 64, 128]: each CTA's accumulator after `reps` products of a
    [64, 64] by b^T ([128, 64] rows of K)."""
    out = torch.empty(ctas, M, N, device=a.device)
    lib = _lib()
    rc = lib.hosnerf_f32_route_ab(route, a.data_ptr(), b.data_ptr(),
                                  out.data_ptr(), ctas, reps,
                                  torch.cuda.current_stream().cuda_stream)
    _build.check(rc, lib, f"f32 route {ROUTES[route]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=4000)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    card.configure()
    if not torch.cuda.is_available():
        raise SystemExit("f32_route_ab: needs a CUDA device")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(args.seed)
    a64 = rng.normal(0, 1, (M, K))
    b64 = rng.normal(0, 1, (N, K))
    a = torch.tensor(a64, dtype=torch.float32, device=dev)
    b = torch.tensor(b64, dtype=torch.float32, device=dev)
    exact = a.double().cpu().numpy() @ b.double().cpu().numpy().T
    scale = np.abs(exact).max()
    cublas = float(np.abs((a @ b.T).double().cpu().numpy() - exact).max())
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ctas = 2 * sms
    for route, name in enumerate(ROUTES):
        got = run(route, a, b, 1, 1)[0].double().cpu().numpy()
        err = float(np.abs(got - exact).max())
        run(route, a, b, ctas, args.reps)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(5):
            run(route, a, b, ctas, args.reps)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / 5
        flops = 2.0 * M * N * K * ctas * args.reps
        rate = flops / ms / 1e9
        print(f"route {name}: max err over scale {err / scale:.3e} (cuBLAS "
              f"f32 {cublas / scale:.3e}); {ctas} CTAs x {args.reps} reps "
              f"{ms:.4f} ms, {rate:.1f} TFLOP/s of f32-grade products, "
              f"{rate * 1e12 / PEAK:.3f} of {PEAK / 1e12:.1f}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
