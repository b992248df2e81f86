"""Long-horizon convergence probe at production widths (counterpart of
`tools/convergence_probe.py`).

Trains stage 1 (the scene) and stage 2 (the human field) for `--steps`
steps (default 5,000) on the synthetic mini capture
(`write_mini_dataset(n_frames=20, res=48)`, seed 0) through the port's
loaders, at production widths with bf16 trunks (stage 2 on the
hand-written kernels' sorted path), a fresh batch every step and the
frames cycled as in real training. Logs the loss (and PSNR) every
LOG_EVERY steps and on the last, asserts that every logged value is
finite and keeps the JAX probe's end checks (stage 1: the last three
PSNRs' mean more than 3 dB above the first three's; stage 2: the last
three losses' mean below 0.7 of the first three's), and writes
`probe_<stage>.json` in the JAX files' schema, with the card's name and
power limit beside `wall_secs`.

    python -m hosnerf_tpu_torch.tools.convergence_probe \\
        [--steps 5000] [--stage stage1|stage2|both] [--out DIR] \\
        [--against tools/convergence] [--device cpu] [--seed 0]

`--against DIR` reads the JAX package's `probe_stage{1,2}.json` there and
prints, per window of WINDOWS that both curves cover, the port's value
beside JAX's: the mean logged PSNR for stage 1, -10 log10 of the mean
logged mse for stage 2. It exits 1 where the port falls more than BAND_DB
below JAX in any such window. These are quality numbers; the JAX files'
`wall_secs` are TPU times and are not compared.

Stage 1 runs no hand-written kernel, as in the JAX package.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.utils import card

LOG_EVERY = 50
# the windows [lo, hi) of steps compared with the JAX curves, and the band:
# the port fails where it falls more than BAND_DB below JAX in one of them
WINDOWS = ((500, 1000), (1000, 2000), (4000, 5000))
BAND_DB = 3.0
STAGES = ("stage1", "stage2")
# the JAX probe's sizes: capture, stage-1 rays per step, stage-2 patches
MINI_FRAMES, MINI_RES = 20, 48
STAGE1_RAYS = 4096
STAGE2_PATCHES, STAGE2_PATCH_SIZE, VOLUME = 2, 32, 32
NEAR, FAR = 0.2, 30.0

CONFIG_NOTE = {
    "stage1": "production widths (8x1024 nerf, 3x(64,64,32) samples), "
              "bf16, 4096 rays/step",
    "stage2": "production widths (8x256 cnl, 6x128 nr, G=32, S=128, "
              "2x32^2 patches), bf16, hand-written kernels (sorted path)"}


def write_capture(root: str) -> str:
    """The probe's capture, `root`/mini (20 frames of 48 x 48, seed 0)."""
    from hosnerf_tpu_torch.data import synthetic
    path = os.path.join(root, "mini")
    synthetic.write_mini_dataset(path, n_frames=MINI_FRAMES, res=MINI_RES)
    return path


def _finite(*vals) -> bool:
    return all(math.isfinite(v) for v in vals)


def _logged(i: int, steps: int, log_every: int) -> bool:
    return i % log_every == 0 or i == steps - 1


def run_stage1(path: str, steps: int, device, seed: int = 0, *,
               rays: int = STAGE1_RAYS, log_every: int = LOG_EVERY,
               **fields) -> dict:
    """Stage 1 for `steps` steps as the JAX probe runs it:
    `Stage1Config(max_steps=steps, near=0.2, far=30.0, num_states=2,
    compute_dtype="bf16")` (`fields` on top: test-only widths) on
    `ScenePipeline(batch_size=rays)` batches, a fresh one every step, the
    step index passed as the step, the jitter from one CPU generator seeded
    seed + 1 and the weights from `seed`. Returns the probe record
    (unrounded curve)."""
    from hosnerf_tpu_torch.data import batches, scene_loader, scene_pipeline
    from hosnerf_tpu_torch.data.human_dataset import HumanDataset
    from hosnerf_tpu_torch.train import stage1
    scene = scene_loader.load_nerf_360_v2(
        os.path.dirname(path), os.path.basename(path), factor=1, near=NEAR,
        far=FAR)
    pipe = scene_pipeline.ScenePipeline(scene, batch_size=rays)
    transitions = HumanDataset(path, mode="train",
                               mweight_volume_size=VOLUME).transitions
    cfg = stage1.Stage1Config(**{**dict(
        max_steps=steps, near=NEAR, far=FAR, num_states=2,
        compute_dtype="bf16"), **fields})
    model, opt = stage1.init_state(cfg, seed=seed, device=device)
    step = stage1.make_train_step(cfg, model, opt, transitions)
    gen = torch.Generator().manual_seed(seed + 1)
    log = []
    t0 = time.time()
    for i in range(steps):
        aux = step(batches.to_device(pipe.sample_train_batch(), device), i,
                   gen)
        if _logged(i, steps, log_every):
            loss, psnr = float(aux["loss"]), float(aux["psnr"])
            assert _finite(loss, psnr), ("stage1", i, loss, psnr)
            log.append({"step": i, "loss": loss, "psnr": psnr})
            print(f"[stage1] {i:5d} loss {loss:.4f} psnr {psnr:.2f}",
                  flush=True)
    secs = time.time() - t0
    first = float(np.mean([e["psnr"] for e in log[:3]]))
    last = float(np.mean([e["psnr"] for e in log[-3:]]))
    if len(log) >= 6:
        assert last > first + 3.0, ("stage1: psnr did not improve", first,
                                    last)
    return {"stage": "stage1", "steps": steps, "log_every": log_every,
            "curve": log, "wall_secs": secs, "psnr_first3_mean": first,
            "psnr_last3_mean": last, "config": CONFIG_NOTE["stage1"]}


def run_stage2(path: str, steps: int, device, seed: int = 0, *,
               n_patches: int = STAGE2_PATCHES,
               patch_size: int = STAGE2_PATCH_SIZE,
               log_every: int = LOG_EVERY, **fields) -> dict:
    """Stage 2 for `steps` steps as the JAX probe runs it:
    `Stage2Config(compute_dtype="bf16")` (`fields` on top: test-only
    widths) on `HumanDataset(n_patches=2, patch_size=32,
    mweight_volume_size=32)` item `i % len(ds)` at step i, iter_val i, no
    LPIPS term (the JAX probe gives its step none), the jitter from one CPU
    generator seeded seed + 2 and the weights from `seed`. Returns the
    probe record (unrounded curve)."""
    from hosnerf_tpu_torch.data import batches
    from hosnerf_tpu_torch.data.human_dataset import HumanDataset
    from hosnerf_tpu_torch.train import stage2
    cfg = stage2.Stage2Config(**{**dict(
        compute_dtype="bf16", n_patches=n_patches, patch_size=patch_size),
        **fields})
    ds = HumanDataset(path, mode="train", n_patches=n_patches,
                      patch_size=patch_size,
                      mweight_volume_size=cfg.mweight_volume_size)
    model, opt = stage2.init_state(cfg, seed=seed, device=device)
    # Stage2Config's one state: JAX's gather clamps the capture's state 1
    # to row 0, so every item takes state 0 there; the port indexes
    # strictly, so it is given no transitions (state 0 everywhere)
    trans = ds.transitions if cfg.num_states > 1 else None
    step = stage2.make_train_step(cfg, model, opt, trans)
    gen = torch.Generator().manual_seed(seed + 2)
    log = []
    t0 = time.time()
    for i in range(steps):
        aux = step(batches.to_device(ds[i % len(ds)], device), i, gen)
        if _logged(i, steps, log_every):
            loss, mse = float(aux["loss"]), float(aux["mse"])
            psnr = -10.0 * math.log10(max(mse, 1e-10))
            assert _finite(loss, mse), ("stage2", i, loss, mse)
            log.append({"step": i, "loss": loss, "mse": mse, "psnr": psnr})
            print(f"[stage2] {i:5d} loss {loss:.4f} mse {mse:.5f} "
                  f"psnr {psnr:.2f}", flush=True)
    secs = time.time() - t0
    first = float(np.mean([e["loss"] for e in log[:3]]))
    last = float(np.mean([e["loss"] for e in log[-3:]]))
    if len(log) >= 6:
        assert last < first * 0.7, ("stage2: loss did not improve", first,
                                    last)
    return {"stage": "stage2", "steps": steps, "log_every": log_every,
            "curve": log, "wall_secs": secs, "loss_first3_mean": first,
            "loss_last3_mean": last, "config": CONFIG_NOTE["stage2"]}


def window_value(stage: str, curve: Sequence[dict], lo: int,
                 hi: int) -> Optional[float]:
    """The curve's value in steps [lo, hi), or None where the curve does
    not cover the window (no logged step in it, or the run ended before
    its last step): stage 1 the mean logged PSNR, stage 2 -10 log10 of the
    mean logged mse (dB)."""
    inside = [e for e in curve if lo <= e["step"] < hi]
    if not inside or max(e["step"] for e in curve) < hi - 1:
        return None
    if stage == "stage1":
        return float(np.mean([e["psnr"] for e in inside]))
    return float(-10.0 * np.log10(np.mean([e["mse"] for e in inside])))


def compare(stage: str, port_curve: Sequence[dict],
            jax_curve: Sequence[dict]) -> Tuple[List[tuple], bool]:
    """([(window, port dB, JAX dB, port - JAX, ok)] over the windows both
    curves cover, all ok): ok where the port is at most BAND_DB below."""
    rows = []
    for lo, hi in WINDOWS:
        p = window_value(stage, port_curve, lo, hi)
        j = window_value(stage, jax_curve, lo, hi)
        if p is None or j is None:
            continue
        rows.append(((lo, hi), p, j, p - j, p >= j - BAND_DB))
    return rows, all(r[-1] for r in rows)


def load_curve(directory: str, stage: str) -> List[dict]:
    with open(os.path.join(directory, f"probe_{stage}.json")) as f:
        return json.load(f)["curve"]


def print_table(stage: str, rows) -> None:
    what = ("mean logged PSNR" if stage == "stage1"
            else "-10 log10(mean logged mse)")
    print(f"[{stage}] {what} (dB) by window, the port beside JAX "
          f"(band {BAND_DB} dB):", flush=True)
    print("| window | port | JAX | port - JAX | within band |")
    print("| --- | --- | --- | --- | --- |")
    for (lo, hi), p, j, d, ok in rows:
        print(f"| [{lo}, {hi}) | {p:.2f} | {j:.2f} | {d:+.2f} | "
              f"{'yes' if ok else 'NO'} |", flush=True)


def _rounded(rec: dict) -> dict:
    """The record as the JAX files hold it: the curve's loss to 5
    decimals, mse to 6, PSNR to 3."""
    digits = {"loss": 5, "mse": 6, "psnr": 3}
    curve = [{k: (round(v, digits[k]) if k in digits else v)
              for k, v in e.items()} for e in rec["curve"]]
    out = {k: (round(v, 5) if isinstance(v, float) else v)
           for k, v in rec.items()}
    out["curve"] = curve
    out["wall_secs"] = round(rec["wall_secs"], 1)
    return out


def emit(out_dir: str, rec: dict) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"probe_{rec['stage']}.json")
    with open(path, "w") as f:
        json.dump(_rounded(rec), f, indent=1)
    print(f"[{rec['stage']}] wrote {path}", flush=True)
    return path


RUNNERS: Dict[str, Callable[..., dict]] = {"stage1": run_stage1,
                                           "stage2": run_stage2}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=5000)
    ap.add_argument("--stage", choices=STAGES + ("both",), default="both")
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "convergence"))
    ap.add_argument("--against", default=None,
                    help="directory of the JAX package's probe_stage*.json")
    ap.add_argument("--seed", type=int, default=0)
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    record = common.device_record(device)
    stages = STAGES if args.stage == "both" else (args.stage,)
    ok = True
    with tempfile.TemporaryDirectory(prefix="probe_") as root:
        path = write_capture(root)
        for stage in stages:
            rec = RUNNERS[stage](path, args.steps, device, args.seed)
            rec["device"] = record
            emit(args.out, rec)
            if args.against:
                rows, good = compare(stage, rec["curve"],
                                     load_curve(args.against, stage))
                print_table(stage, rows)
                ok = ok and good
    print(f"device: {record}", flush=True)
    print("convergence probe: " + ("OK" if ok else "FAIL (more than "
                                   f"{BAND_DB} dB below JAX)"), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
