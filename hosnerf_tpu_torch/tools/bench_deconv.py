"""The weight-volume decoder's transposed convolutions in their two forms,
forward + backward in bf16 (counterpart of `tools/bench_deconv.py`):
'phase', eight products [N^3, 8 cin] @ [8 cin, cout] per layer (the JAX
package's `ConvTranspose3dTorch`), and 'conv', cuDNN's transposed
convolution (`models/human_components.py`).

    python -m hosnerf_tpu_torch.tools.bench_deconv [--device cpu]

`MotionWeightVolumeDecoder(256, 32, 26, bf16, deconv_impl)` (weights from
seed 0) on priors U(0.01, 1) [27, 32, 32, 32] from numpy's seed 0; the
loss is the mean of the softmax volume, its gradients taken for every
weight. Each form is a chain of calls issued back to back with one
synchronisation at the end (`tools/common.py::chain_ms`), the priors
moved by 1e-6 of a distinct draw per call. Prints the ms of each and its
rate, the forward + backward model FLOP of `tools/ref_flops.py::
vol_decoder` (three times the forward, the count of volume 32) over that
time.
"""

from __future__ import annotations

import argparse
from typing import List, Tuple

import numpy as np
import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.tools import ref_flops
from hosnerf_tpu_torch.utils import card

ITERS, WARMUP = 20, 3
IMPLS = ("phase", "conv")


def bench(device, volume: int = 32, iters: int = ITERS, warmup: int = WARMUP
          ) -> List[Tuple[str, float]]:
    """[(form, ms per forward + backward)]."""
    from hosnerf_tpu_torch.models.human_components import (
        MotionWeightVolumeDecoder)
    priors = torch.as_tensor(np.random.default_rng(0).uniform(
        0.01, 1.0, (27, volume, volume, volume)).astype(np.float32),
        device=device)
    rows = []
    for impl in IMPLS:
        dec = MotionWeightVolumeDecoder(
            256, volume, 26, torch.bfloat16, impl,
            generator=torch.Generator().manual_seed(0), device=device)

        def call(i):
            dec.zero_grad(set_to_none=True)
            pr = priors + 1e-6 * torch.rand(
                (1,), generator=common.jitter(i)).to(device)
            dec(pr).mean().backward()

        rows.append((impl, common.chain_ms(call, iters, warmup)))
        del dec
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--volume", type=int, default=32,
                    help="test-only: a smaller volume (no rate printed)")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(f"device: {common.device_record(device)}", flush=True)
    flops = 3.0 * ref_flops.vol_decoder()
    for impl, ms in bench(device, args.volume, args.iters, args.warmup):
        rate = (f" {flops / ms / 1e9:8.3f} TFLOP/s" if args.volume == 32
                else "")
        print(f"{f'vol_decoder fwd+bwd [{impl}]':34s} {ms:9.2f} ms{rate}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
