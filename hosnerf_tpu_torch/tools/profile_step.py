"""Component timing of the stage-3 train step (counterpart of
`tools/profile_step.py`).

    python -m hosnerf_tpu_torch.tools.profile_step [--n_patches 2] \\
        [--device cpu]

Splits the step into: a no-op dispatch (one tiny kernel per call), the
scene's forward + backward, the human field's forward + backward, the
inverse LBS's forward + backward on the step's own samples (the human
field's `sample_inputs`, its `lbs_impl`), and the full step, each timed
as a chain of calls issued back to back with one synchronisation at the
end (`utils/benchtools.py::timeit_chain`), a distinct jitter draw per
call. The JAX tool's lax.scan of K steps in one dispatch becomes K steps
issued back to back with one synchronisation (the full step's time),
against K steps each followed by a synchronisation: the difference is
the host's share per step that the device does not hide. On the card
one more step runs under torch.profiler: its device time by group of
kernel names (`tools/common.py::device_groups`, as chip_smoke.py groups
a stage-3 step) and the device's idle share of the step.

`Stage3Config(n_patches, compute_dtype="bf16", remat=...)` on
`composed_batch(n_patches, 32, grid_size=32)`; remat 'heavy' from 8
patches on, as in the JAX tool.
"""

from __future__ import annotations

import argparse
import time

import torch

from hosnerf_tpu_torch.models.layers import resolve_device
from hosnerf_tpu_torch.tools import common
from hosnerf_tpu_torch.tools.time_step import time_split
from hosnerf_tpu_torch.utils import card

ITERS, WARMUP, K = 10, 2, 10
ITER = 100.0


def _line(name: str, ms: float, unit: str = "ms/call") -> str:
    return f"{name:28s} {ms:9.2f} {unit}"


def components(cfg, device, iters: int = ITERS, warmup: int = WARMUP,
               k: int = K):
    """([(name, ms)] of the step's components, the full step's (ms/step
    of `k` issued back to back, of `k` each followed by a
    synchronisation, the last loss), (the step, its batch))."""
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.ops import lbs as lbs_ops
    step, batch, (scene, human, _) = common.stage3_step(cfg, device)
    s_idx = state_index(batch["time"], None)
    rows = []

    x = {"v": torch.zeros((), device=device)}

    def noop(i):
        x["v"] = x["v"] + 1.0

    rows.append(("dispatch noop", common.chain_ms(noop, 2 * iters, warmup)))

    bb = {"rays_o": batch["rays_o_bkg"], "rays_d": batch["rays_d_bkg"],
          "viewdirs": batch["viewdirs_bkg"], "radii": batch["radii"]}

    def scene_fb(i):
        scene.zero_grad(set_to_none=True)
        _, hist = scene(bb, 1.0, True, s_idx, cfg.near_bkg, cfg.far_bkg,
                        generator=common.jitter(i))
        (hist[-1]["rgb"].mean() + hist[-1]["density"].mean()).backward()

    rows.append(("scene fwd+bwd", common.chain_ms(scene_fb, iters, warmup)))

    def human_fb(i):
        human.zero_grad(set_to_none=True)
        out = human(batch, ITER, s_idx, is_train=True, perturb=1.0,
                    generator=common.jitter(i))
        (out["rgb"].mean() + out["human_density"].mean()
         + out["deform_pts_final"].mean()).backward()

    rows.append(("human fwd+bwd", common.chain_ms(human_fb, iters, warmup)))

    with torch.no_grad():
        si = human.sample_inputs(batch, ITER)
    vol0 = si["vol"].detach()

    def inverse_fb(i):
        pts = (si["pts_flat"] + 1e-6 * i).requires_grad_(True)
        vol = vol0.clone().requires_grad_(True)
        xs, m = lbs_ops.inverse_warp(
            pts, si["m_sR"], si["m_T"], vol, batch["cnl_bbox_min_xyz"],
            batch["cnl_bbox_scale_xyz"], impl=human.lbs_impl,
            pg_impl=human.pg_impl, pg_sort=human.pg_sort)
        (xs.mean() + m.mean()).backward()

    rows.append(("inverse LBS fwd+bwd",
                 common.chain_ms(inverse_fb, iters, warmup)))
    human.zero_grad(set_to_none=True)
    scene.zero_grad(set_to_none=True)

    back_ms, loss = time_split(step, batch, k, warmup)

    def each(i):
        step(batch, ITER + i, common.jitter(i))
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    each_ms = common.chain_ms(each, k, warmup)
    return rows, (back_ms, each_ms, loss), (step, batch)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n_patches", type=int, default=2)
    ap.add_argument("--patch_size", type=int, default=32)
    ap.add_argument("--lbs_impl", default="auto")
    ap.add_argument("--remat", default=None,
                    help="none|heavy|all (default heavy from 8 patches)")
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--warmup", type=int, default=WARMUP)
    ap.add_argument("--k", type=int, default=K)
    ap.add_argument("--small", action="store_true",
                    help="test-only: tiny widths (tools/common.py::SMALL)")
    common.add_device_args(ap)
    args = ap.parse_args(argv)
    card.configure()
    device = resolve_device(args.device)
    remat = args.remat or ("heavy" if args.n_patches >= 8 else "none")
    cfg = common.stage3_config(args.n_patches, args.patch_size, args.small,
                               lbs_impl=args.lbs_impl, remat=remat)
    rays = cfg.n_patches * cfg.patch_size ** 2
    print(f"device: {common.device_record(device)}", flush=True)
    print(f"n_patches={cfg.n_patches} rays={rays} lbs_impl={cfg.lbs_impl} "
          f"remat={remat}", flush=True)
    rows, (back, each, loss), (step, batch) = components(
        cfg, device, args.iters, args.warmup, args.k)
    for name, ms in rows:
        print(_line(name, ms), flush=True)
    print(_line(f"full step ({args.k} back to back)", back, "ms/step"))
    print(_line(f"full step ({args.k}, each synced)", each, "ms/step"))
    print(_line("host share per step", each - back, "ms"), flush=True)
    if device.type == "cuda":
        t0 = time.perf_counter()
        busy, groups, glue = common.profile_groups(
            lambda: step(batch, ITER, common.jitter(0)), device)
        wall = (time.perf_counter() - t0) * 1e3
        print(f"profiled step: device busy {busy:.3f} ms, idle share "
              f"{1 - busy / back:.3f} of {back:.2f} ms/step "
              f"({wall:.2f} ms profiled wall)", flush=True)
        for g, ms in groups.items():
            print(f"  {g:40s} {ms:9.3f} ms  {ms / busy:.3f}", flush=True)
        print("  largest glue kernels: " + "; ".join(
            f"{ms:.3f} {name[:60]}" for ms, name in glue[:5]), flush=True)
    return 0 if torch.isfinite(torch.tensor(loss)) else 1


if __name__ == "__main__":
    raise SystemExit(main())
