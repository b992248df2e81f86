"""Device memory of the 8-patch stage-3 step under each remat split
(counterpart of `tools/memcheck_8patch.py`).

The JAX tool compiles the step ahead of time and prints XLA's memory
analysis of it (arguments, outputs, temporaries) without running it;
PyTorch has no such analysis. Here the peak of
`torch.cuda.max_memory_allocated` over one step, after one warm step, is
the number: the tensors the allocator held at the step's highest point
(weights, Adam's moments, the batch and the activations kept for the
backward). It needs a CUDA card and raises on the CPU.

    python -m hosnerf_tpu_torch.tools.memcheck_8patch [--n_patches 8] \\
        [--splits none:heavy ...]

Per `scene_remat:human_remat` split (default: the JAX bench's 8-patch
config, the NeRF MLP dense, the canonical MLP dense, both dense),
`Stage3Config(n_patches, compute_dtype="bf16", remat="none",
scene_remat=..., human_remat=...)` on `composed_batch(n_patches, 32,
grid_size=32)`. Prints the peak in GiB and whether the step's loss is
finite; exits 1 where one is not.
"""

from __future__ import annotations

import argparse
import math

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

GIB = 1024 ** 3


def peak_split(step, batch, device):
    """(peak bytes allocated over one step after a warm one, its loss)."""
    common.require_card(device, "memcheck_8patch (max_memory_allocated)")
    step(batch, 100.0, common.jitter(0))
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    loss = float(step(batch, 101.0, common.jitter(1))["loss"])
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device), loss


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=8)
    ap.add_argument("--splits", nargs="*", type=common.split_arg,
                    default=list(common.SPLITS),
                    help="scene_remat:human_remat (none|heavy|all)")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    common.require_card(device, "memcheck_8patch (max_memory_allocated)")
    print(f"device: {common.device_record(device)}", flush=True)
    ok = True
    for split in args.splits:
        cfg = common.split_config(args.n_patches, split)
        step, batch, _ = common.stage3_step(cfg, device)
        peak, loss = peak_split(step, batch, device)
        flag = "" if math.isfinite(loss) else "  ** NON-FINITE LOSS **"
        print(f"scene={split[0]:5s} human={split[1]:5s}  peak "
              f"{peak / GIB:6.2f} GiB ({peak} bytes)  loss {loss:.6f}{flag}",
              flush=True)
        ok = ok and math.isfinite(loss)
        del step, batch
        torch.cuda.empty_cache()
    print("done", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
