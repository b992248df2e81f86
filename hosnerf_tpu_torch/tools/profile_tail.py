"""The stage-3 step's tail (counterpart of `tools/profile_tail.py`): the
loss's forward + backward without the optimizer, the optimizer's update
alone, and the loss's forward alone, to place the rest between the
models' forward + backward and the full step.

    python -m hosnerf_tpu_torch.tools.profile_tail [--n_patches 2] \\
        [--device cpu]

Each timed as a chain of calls issued back to back with one
synchronisation at the end (`utils/benchtools.py::timeit_chain`), a
distinct jitter draw per call. The optimizer alone: Adam with the seven
lr groups of the stage-3 step on gradients set once to 1e-6 of the
parameters. `Stage3Config(n_patches, compute_dtype="bf16", remat=...)`
on `composed_batch(n_patches, 32, grid_size=32)`; remat 'heavy' from 8
patches on, as in the JAX tool.
"""

from __future__ import annotations

import argparse

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

ITERS, WARMUP = 10, 2
ITER = 100.0


def tail(cfg, device, iters: int = ITERS, warmup: int = WARMUP):
    """[(name, ms per call)] of the tail's pieces."""
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.train import stage2, stage3
    _, batch, (scene, human, opt) = common.stage3_step(cfg, device)
    grad_fn = stage3.make_grad_fn(cfg, scene, human)
    loss_fn = stage3.make_loss_fn(cfg, scene, human)
    rows = [("loss fwd+bwd (no optimizer)", common.chain_ms(
        lambda i: grad_fn(batch, ITER, common.jitter(i)), iters, warmup))]
    with torch.no_grad():
        for m in (scene, human):
            for p in m.parameters():
                p.grad = p * 1e-6 + 1e-8
    rows.append(("optimizer update alone", common.chain_ms(
        lambda i: stage2.apply_updates(cfg, opt), iters, warmup)))
    s_idx = state_index(batch["time"], None)

    @torch.no_grad()
    def fwd(i):
        return loss_fn(batch, ITER, s_idx, common.jitter(i))

    rows.append(("loss forward only", common.chain_ms(fwd, iters, warmup)))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--remat", default=None,
                    help="none|heavy|all (default heavy from 8 patches)")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--small", action="store_true",
                    help="test-only: tiny widths (tools/common.py::SMALL)")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    remat = args.remat or ("heavy" if args.n_patches >= 8 else "none")
    cfg = common.stage3_config(args.n_patches, args.patch_size, args.small,
                               remat=remat)
    print(f"device: {common.device_record(device)}", flush=True)
    print(f"n_patches={cfg.n_patches} remat={remat}", flush=True)
    for name, ms in tail(cfg, device, args.iters, args.warmup):
        print(f"{name:34s} {ms:9.2f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
