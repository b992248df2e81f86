"""Analytic model-FLOP count of the stage-3 training step at the
reference's production shapes (counterpart of `tools/ref_flops.py`, the
same count).

    python -m hosnerf_tpu_torch.tools.ref_flops [--device cpu]

It counts matmul and convolution multiply-adds (2 FLOP each) and the
backward as twice the forward (activations kept, no recomputation). The
inverse LBS, sorting and compositing are gathers and elementwise work,
left out. Shapes: 2 patches x 32^2 rays, 128 human samples per ray;
proposal sampling 64 + 64 and NeRF 32 samples; proposal MLP 4 x 256, NeRF
MLP 8 x 1024; 64-d state embeddings; 504-d IPE features (icosahedron-2
basis, max_deg 12): the cell of the repo's `bench.py`.

`step_flops()` returns the (forward, forward + backward) count. Like every
tool it names the card it runs beside (the count itself needs none) and,
without a card, raises unless given `--device cpu`.
`vol_decoder()` is the weight-volume decoder's forward count, which
this package's `bench_deconv` divides by its time. The A100 lines of `main`
restate the JAX script's lines: the reference's own GPU, which trains in
f32 with TF32 products off, at its data-sheet 19.5 TFLOP/s of f32 (a
datasheet rate, not a measurement) and four model-FLOP utilisations.
"""

from __future__ import annotations

import argparse
from typing import Tuple

RAYS = 2048
S_HUM = 128
S_PROP, S_NERF = 64, 32
IPE = 504
STATE = 64
DIRENC = 27  # 3 * (1 + 2 * 4)
A100_F32 = 19.5e12   # the A100 data sheet's f32 rate
MFUS = (1.0, 0.6, 0.35, 0.15)


def linear(n, din, dout):
    return 2.0 * n * din * dout


def scene_mlp(n_samples, depth, width, skip_every=4, rgb=True):
    din = IPE + STATE
    f = linear(n_samples, din, width)
    cur = width
    for i in range(1, depth):
        if i % skip_every == 0:
            cur = width + din
        f += linear(n_samples, cur, width)
        cur = width
    f += linear(n_samples, width, 1)                   # density head
    if rgb:
        f += linear(n_samples, width, 256)             # bottleneck
        f += linear(n_samples, 256 + DIRENC, 128)      # views_linear
        f += linear(n_samples, 128, 3)                 # rgb
    return f


def human_mlps(n_inv, n_fwd_streams):
    # canonical: input 127, 8 x 256, skip concat before linear_5
    n = n_inv
    f = linear(n, 127, 256) + 3 * linear(n, 256, 256)
    f += linear(n, 127 + 256, 256) + 2 * linear(n, 256, 256)
    f += linear(n, 256, 4)
    # non-rigid (the inverse leg and the forward legs): input 111, 6 x 128,
    # skip concat [h, embed] before linear_4
    for n_nr in (n_inv, n_fwd_streams):
        f += linear(n_nr, 111, 128) + 3 * linear(n_nr, 128, 128)
        f += linear(n_nr, 128 + 36, 128) + linear(n_nr, 128, 128)
        f += linear(n_nr, 128, 3)
    # pose decoder (per frame: 75 -> 4 x 256 -> two heads)
    f += 2 * (linear(1, 75, 256) + 2 * linear(1, 256, 256)
              + 2 * linear(1, 256, 256) + 2 * linear(1, 256, 75))
    return f


def vol_decoder():
    # Linear 256 -> 1024, transposed convs 1 -> 2 -> 4 -> 8 -> 16 -> 32
    # with channels 1024 -> 512 -> 512 -> 256 -> 256 -> 27, k=4 s=2 p=1
    # (8 taps per output voxel)
    f = linear(1, 256, 1024)
    chans = [(1024, 512, 2), (512, 512, 4), (512, 256, 8),
             (256, 256, 16), (256, 27, 32)]
    for cin, cout, out_res in chans:
        f += 2.0 * (out_res ** 3) * cout * 8 * cin
    return f


def lpips_vgg(n_imgs, res):
    # VGG16 convs at 224^2 ~ 15.35 GFLOP; conv FLOPs scale with area
    return n_imgs * 15.35e9 * (res / 224.0) ** 2


def step_flops() -> Tuple[float, float]:
    """(forward, forward + backward) model FLOP of one stage-3 step."""
    n_hum = RAYS * S_HUM
    fwd = (2 * scene_mlp(RAYS * S_PROP, 4, 256, rgb=False)
           + scene_mlp(RAYS * S_NERF, 8, 1024, rgb=True)
           + human_mlps(n_hum, 2 * n_hum)
           + vol_decoder()
           + lpips_vgg(4, 32))  # prediction and target x 2 patches
    return fwd, 3.0 * fwd


def main(argv=None) -> int:
    from hosnerf_tpu_torch.models.layers import resolve_device
    from hosnerf_tpu_torch.tools import common
    from hosnerf_tpu_torch.utils import card
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    print(f"device: {common.device_record(resolve_device(args.device))}",
          flush=True)
    fwd, total = step_flops()
    print(f"reference stage-3 step (2048 rays): fwd {fwd/1e12:.3f} TFLOP, "
          f"fwd+bwd {total/1e12:.3f} TFLOP")
    print("  (A100 lines: the data sheet's f32 rate, not a measurement)")
    for mfu in MFUS:
        t = total / (A100_F32 * mfu)
        print(f"  A100 f32 @ MFU {mfu:4.0%}: {t*1e3:7.1f} ms/step -> "
              f"{RAYS/t:7.0f} rays/s/GPU")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
