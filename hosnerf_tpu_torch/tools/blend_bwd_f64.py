"""B5's backward (csrc/lbs_forward.cu, `ops/cuda/lbs.py::shared_blend_bwd`)
and its plain version, each against the same contract evaluated in f64.
Needs a CUDA device.

    python -m hosnerf_tpu_torch.tools.blend_bwd_f64

The contract rounds to bf16 at fixed points (the tap weights, the blend
weights, gw = bf16(dL/dw), gw * hz). Where the kernel and the plain
version compute a value fed to one of them in different orders, a value
within an f32 ulp of a bf16 midpoint rounds apart on the two sides; dw,
a matmul in the plain version, was such a value until both sides computed
it exactly. `shared_blend_bwd_plain(..., dtype=torch.float64)` computes
every product and sum in f64 and rounds each of those values once: the
oracle that says which side's order moves a rounding. On the edge cases of
`tests/test_torch_cuda.py::test_shared_tap_kernels_edge_cases` (the same
generator, `tap_case`), prints per output (dpts, dvol, drmat) the relative
L2 and max/scale distance of the kernel and of the f32 plain version to
the f64 value, and of the two to each other.
"""

from __future__ import annotations

import argparse
import subprocess

import torch

from hosnerf_tpu_torch.ops.cuda import lbs as clbs
from hosnerf_tpu_torch.utils import card

# name: (rows, bones B, transform sets K, where the samples lie, k0[, G =
# 32]): "mixed": in, partly off and off the grid; "hot": every sample in
# one voxel (one brick split over many CTAs); "off": every sample off the
# grid; "faces": coordinates on the grid's faces (0 and G - 1). G = 96 has
# more bricks than the binning's shared histogram holds. The card tests'
# edge cases (tests/test_torch_cuda.py).
TAP_CASES = {
    "n1": (1, 26, 2, "mixed", 0),
    "n511": (511, 26, 2, "mixed", 0),
    "n513_live": (513, 26, 2, "mixed", 1),
    "n513_clamped": (513, 26, 2, "mixed", 10 ** 6),
    "n262143": (262_143, 26, 2, "mixed", 0),
    "n262143_live": (262_143, 26, 2, "mixed", 100),
    "hot": (20_000, 26, 2, "hot", 0),
    "off": (4_000, 26, 2, "off", 0),
    "faces": (4_000, 26, 2, "faces", 0),
    "B1_K1": (3_000, 1, 1, "mixed", 0),
    "B32_K1": (3_000, 32, 1, "mixed", 1),
    "B32_K2": (3_000, 32, 2, "mixed", 0),
    "G96": (2_000, 2, 2, "mixed", 0, 96),
}


def tap_case(dev, n, B, K, kind, G=32, seed=0):
    """(pts, vol_all, rmat, gout, gw) of one edge case, drawn on `dev`."""
    gen = torch.Generator(dev).manual_seed(seed)
    vol_all = torch.rand(G * G, B * G, device=dev, generator=gen)
    u = torch.rand(n, 3, device=dev, generator=gen)
    if kind == "hot":
        pts = 13.25 + 0.5 * u
    elif kind == "off":
        pts = -3.0 - 40.0 * u
        pts[::2] += G + 44.0
    else:
        pts = -1.5 + (G + 2.0) * u
        if kind == "faces":
            pts[0::3, 0] = G - 1
            pts[1::3, 1] = 0.0
            pts[2::3, 2] = G - 1
            pts[::5] = G - 1
    rmat = torch.randn(B, 12 * K, device=dev, generator=gen) * 0.1
    gout = torch.randn(n, 3 * K + 1, device=dev, generator=gen)
    gw = torch.randn(n, B, device=dev, generator=gen)
    gout[::3] = 0.0                        # gradient rows that are zero
    gw[::3] = 0.0
    return pts.contiguous(), vol_all, rmat, gout, gw


def distance(got, ref):
    """(relative L2, max error over the reference's largest entry) of
    `got` to `ref`, in f64."""
    got, ref = got.double(), ref.double()
    l2 = float(torch.linalg.norm(got - ref)
               / (torch.linalg.norm(ref) + 1e-300))
    scale = float(ref.abs().max()) + 1e-300
    return l2, float((got - ref).abs().max()) / scale


def case_distances(dev, case, prec):
    """{output: {'kernel', 'plain', 'kernel_plain'}: (rel L2, max/scale)}
    for one edge case: the kernel and the f32 plain version against the
    f64 contract, and against each other."""
    n, B, K, kind, k0, *G = TAP_CASES[case]
    pts, vol_all, rmat, gout, _ = tap_case(dev, n, B, K, kind, *G)
    k0_t = torch.tensor([k0], device=dev, dtype=torch.int32)
    ker = clbs.shared_blend_bwd(pts, vol_all, rmat, k0_t, gout, prec)
    plain = clbs.shared_blend_bwd_plain(pts, vol_all, rmat, k0_t, gout,
                                        prec)
    f64 = clbs.shared_blend_bwd_plain(pts, vol_all, rmat, k0_t, gout, prec,
                                      dtype=torch.float64)
    return {what: {"kernel": distance(a, c), "plain": distance(b, c),
                   "kernel_plain": distance(a, b)}
            for what, a, b, c in zip(("dpts", "dvol", "drmat"), ker, plain,
                                     f64)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cases", nargs="*", default=sorted(TAP_CASES))
    ap.add_argument("--precisions", nargs="*", default=["bf16", "highest"])
    args = ap.parse_args(argv)
    card.configure()
    if not torch.cuda.is_available():
        print("blend_bwd_f64: needs a CUDA device")
        return 2
    dev = torch.device("cuda")
    for prec in args.precisions:
        for case in args.cases:
            for what, d in case_distances(dev, case, prec).items():
                print(f"{case} {prec} {what}: rel L2 to f64 kernel "
                      f"{d['kernel'][0]:.4e} plain {d['plain'][0]:.4e} "
                      f"(kernel to plain {d['kernel_plain'][0]:.4e}); "
                      f"max/scale kernel {d['kernel'][1]:.4e} plain "
                      f"{d['plain'][1]:.4e}", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
