"""Per-stage training-step throughput at the reference's production sizes
(counterpart of the repo's root `bench_all.py`; a table, not the one-line
benchmark).

    python -m hosnerf_tpu_torch.tools.bench_all [1 2 3] [--device cpu]

Stage 1: `Stage1Config(max_steps=500_000, near=0.5, far=1e6)` on 4,096
`synthetic.scene_ray_batch` rays (64 + 64 + 32 samples a ray). Stage 2:
`Stage2Config()` on `human_batch(2, 32, grid_size=32)` (2,048 rays x 128
samples). Stage 3: `Stage3Config()` on `composed_batch(2, 32,
grid_size=32)`. Stages 2 and 3 keep their configs' default compute dtype
(f32 trunks) and, as the root script, no LPIPS term. Weights from seed 0;
step i at iteration 1000 + i with its own jitter generator. Timed by
`utils/benchtools.py::timeit_chain`: 2 steps and a synchronisation, then
10 steps back to back and one synchronisation. One JSON line a stage:
stage, rays, sec_per_step, rays_per_sec, total_incl_compile (the wall
time of the stage's build, warm-up and timed steps), and the device (the
card's name and `nvidia-smi` name and power limit).
"""

from __future__ import annotations

import argparse
import json
import time

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card
from hosnerf_tpu_torch.utils.benchtools import timeit_chain

ITERS, WARMUP = 10, 2
# test-only (`--small`): tiny widths and batches
SMALL1 = dict(nerf_netwidth=32, prop_netwidth=16, num_prop_samples=8,
              num_nerf_samples=4)
SMALL2 = dict(n_patches=1, patch_size=8, n_samples=8, cnl_mlp_width=32,
              nr_mlp_width=16, mweight_volume_size=8)


def _timed(step, batch, gen_device, rays, stage, iters, warmup):
    args = [(batch, 1000 + i, torch.Generator(gen_device).manual_seed(i))
            for i in range(warmup + iters)]
    dt = timeit_chain(step, args, iters, warmup)
    return {"stage": stage, "rays": rays, "sec_per_step": dt,
            "rays_per_sec": rays / dt}


def stage1(device, small: bool = False, iters: int = ITERS,
           warmup: int = WARMUP) -> dict:
    from hosnerf_tpu_torch.data import batches, synthetic
    from hosnerf_tpu_torch.train import stage1 as s1
    cfg = s1.Stage1Config(max_steps=500_000, near=0.5, far=1e6,
                          **(SMALL1 if small else {}))
    rays = 64 if small else 4096
    batch = batches.to_device(synthetic.scene_ray_batch(rays), device)
    model, opt = s1.init_state(cfg, seed=0, device=device)
    return _timed(s1.make_train_step(cfg, model, opt), batch, device, rays,
                  1, iters, warmup)


def stage2(device, small: bool = False, iters: int = ITERS,
           warmup: int = WARMUP) -> dict:
    from hosnerf_tpu_torch.data import batches, synthetic
    from hosnerf_tpu_torch.train import stage2 as s2
    cfg = s2.Stage2Config(**(SMALL2 if small else {}))
    batch = batches.to_device(synthetic.human_batch(
        cfg.n_patches, cfg.patch_size, grid_size=cfg.mweight_volume_size),
        device)
    model, opt = s2.init_state(cfg, seed=0, device=device)
    return _timed(s2.make_train_step(cfg, model, opt), batch, device,
                  cfg.n_patches * cfg.patch_size ** 2, 2, iters, warmup)


def stage3(device, small: bool = False, iters: int = ITERS,
           warmup: int = WARMUP) -> dict:
    from hosnerf_tpu_torch.train import stage3 as s3
    cfg = (common.stage3_config(1, 8, True, compute_dtype=None) if small
           else s3.Stage3Config())
    batch = common.stage3_batch(cfg, device)
    scene, human, opt = s3.init_state(cfg, seed=0, device=device)
    # the stage-3 step's jitter generator is a CPU one
    return _timed(s3.make_train_step(cfg, scene, human, opt), batch, "cpu",
                  cfg.n_patches * cfg.patch_size ** 2, 3, iters, warmup)


STAGES = {"1": stage1, "2": stage2, "3": stage3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*", default=sorted(STAGES),
                    help="stages to run, of 1 2 3 (all by default)")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--small", action="store_true",
                    help="test-only: tiny widths and batches")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    unknown = set(args.stages) - set(STAGES)
    if unknown:
        ap.error(f"unknown stages {sorted(unknown)} (of 1 2 3)")
    device = resolve_device(args.device)
    record = common.device_record(device)
    for w in args.stages:
        t0 = time.perf_counter()
        res = STAGES[w](device, args.small, args.iters, args.warmup)
        res["total_incl_compile"] = time.perf_counter() - t0
        res["device"] = record
        print(json.dumps(res), flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
