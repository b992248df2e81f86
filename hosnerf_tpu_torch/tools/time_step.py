"""ms per stage-3 step at a patch count and remat split, by host clock
(counterpart of `tools/time_step.py`): quick operating-point sweeps
without profile_step's component harnesses.

    python -m hosnerf_tpu_torch.tools.time_step [--n_patches 8] \\
        [--splits none:heavy ...] [--device cpu]

Per `scene_remat:human_remat` split (default: the four of
memcheck_8patch), `Stage3Config(n_patches, compute_dtype="bf16",
remat="none", scene_remat=..., human_remat=...)` on
`composed_batch(n_patches, 32, grid_size=32)`: 2 steps, then 10 issued
back to back and one synchronisation at the end
(`utils/benchtools.py::timeit_chain`), a distinct jitter draw per step.
Prints ms/step, rays/s and whether the last loss is finite; exits 1 where
one is not.
"""

from __future__ import annotations

import argparse
import math

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

ITERS, WARMUP = 10, 2


def time_split(step, batch, iters: int = ITERS, warmup: int = WARMUP):
    """(ms/step, the last step's loss) of `iters` steps after `warmup`."""
    losses = []

    def one(i):
        losses.append(step(batch, 100.0 + i, common.jitter(i))["loss"])

    ms = common.chain_ms(one, iters, warmup)
    return ms, float(losses[-1])


def split_line(n_patches: int, split, ms: float, loss: float,
               rays: int) -> str:
    flag = "" if math.isfinite(loss) else "  ** NON-FINITE LOSS **"
    return (f"n_patches={n_patches} split={split[0]}:{split[1]}  "
            f"{ms:8.2f} ms/step  {rays / ms * 1e3:9.1f} rays/s  loss "
            f"{loss:.6f}{flag}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=8)
    ap.add_argument("--splits", nargs="*", type=common.split_arg,
                    default=list(common.SPLITS),
                    help="scene_remat:human_remat (none|heavy|all)")
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--small", action="store_true",
                    help="test-only: tiny widths (tools/common.py::SMALL)")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    print(f"device: {common.device_record(device)}", flush=True)
    ok = True
    for split in args.splits:
        cfg = common.split_config(args.n_patches, split, args.patch_size,
                                  args.small)
        step, batch, _ = common.stage3_step(cfg, device)
        ms, loss = time_split(step, batch, args.iters, args.warmup)
        print(split_line(args.n_patches, split, ms, loss,
                         cfg.n_patches * cfg.patch_size ** 2), flush=True)
        ok = ok and math.isfinite(loss)
        del step, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
