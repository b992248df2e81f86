"""Two checkouts of the repository on one card, timed by their own
`chip_smoke.py` functions: the cost of a change against its parent.

    python -m hosnerf_tpu_torch.tools.ab_compare <checkout A> <checkout B> \\
        [--what kernels cell diag]

Each checkout runs in its own Python process (its own package and
kernels, built from its sources), in the order A, B, B, A, so that drift
on the card shows. Lines are tagged `[A1]`, `[B1]`, `[B2]`, `[A2]`.

  kernels  the LBS backwards at the training step's inputs: B4 at the
           inputs' k0, B5 at k0 = 0 and the inputs' k0, row 7, both
           precisions; entry ms by CUDA events (`chip_smoke.time_ms`, 20
           calls) and device ms by kernel name (`chip_smoke.device_ms`);
  cell     chip_smoke's kernel checks of the backwards (B3 with its
           launches timed apart, B4, B5, row 7), then bench.py's stage-3
           cell (`chip_smoke.stage3_phase`) and its profile by group
           (device busy ms);
  diag     one step of stage 1, stage 2 (sorted, dense) and the stage-3
           cell under torch.use_deterministic_algorithms(True,
           warn_only=True): the ops that warn (no deterministic form), and
           the atomic-backed ops the profiler names.

A checkout whose package has `train/loop.py::set_reproducible` runs under
it (the change); one without runs as it stands (the parent). Card only.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import warnings

# device ms by kernel name: B4's and B5's backward launches
SPLIT_B4 = (("bwd", ("inv_bwd_kernel",)), ("fold", ("inv_fold_kernel",)),
            ("max", ("inv_gmax_kernel",)), ("memset", ("Memset",)))
SPLIT_B5 = (("count", ("bin_count_kernel",)), ("colscan", ("bin_colscan",)),
            ("scan", ("bin_scan_kernel",)),
            ("scatter", ("bin_scatter_kernel",)),
            ("taps", ("tap_bwd_kernel",)), ("finish", ("tap_finish_kernel",)),
            ("memset", ("Memset",)))
# op names (profiler keys) whose CUDA backward may add with atomics
ATOMIC_OPS = ("index_put", "index_add", "scatter", "put_", "grid_sampler",
              "embedding", "upsample", "bincount", "histc", "index_copy",
              "gather", "index_select", "max_pool", "avg_pool", "adaptive",
              "interp", "repeat_interleave", "masked_scatter", "conv")


def _setup(root: str):
    sys.path.insert(0, os.path.abspath(root))
    import torch
    import chip_smoke as cs
    from hosnerf_tpu_torch.ops.cuda import _build
    from hosnerf_tpu_torch.train import loop
    if hasattr(loop, "set_reproducible"):
        loop.set_reproducible()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    return torch, cs


def _inputs(torch, cs, device):
    from hosnerf_tpu_torch.models.human import HumanObjectField
    model = HumanObjectField(mweight_volume_size=32, compute_dtype="bf16",
                             seed=0, device=device).eval()
    with torch.no_grad():
        ti = cs.train_kernel_inputs(torch, model, cs.train_batch(torch,
                                                                 device))
    return model, ti


def run_kernels(torch, cs, device, tag):
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    _, ti = _inputs(torch, cs, device)
    pts_s, rg, tg, vol_qz = ti["pts_s"], ti["rg"], ti["tg"], ti["vol_qz"]
    pts_g, vol_all, rmat = ti["pts_g"], ti["vol_all"], ti["rmat"]
    n, B = pts_s.shape[0], rmat.shape[0]

    def seeded(seed, *shape):
        return torch.randn(*shape, device=device,
                           generator=torch.Generator(device).manual_seed(seed))

    def line(what, fn, parts):
        ms = cs.time_ms(torch, fn, 20)
        split = cs.device_ms(torch, fn, parts, 10)
        print(f"[{tag}] {what} entry {ms:.4f} " + " ".join(
            f"{k}={v:.4f}" for k, v in split.items()), flush=True)

    gacc, gout, gw = seeded(5, n, 4), seeded(6, n, 7), seeded(13, n, B)
    live = int(ti["dom"].k0_for(clbs.INV_TILE))
    with torch.no_grad():
        for prec in ("bf16", "highest"):
            k0 = torch.tensor([live], dtype=torch.int32, device=device)
            line(f"B4 {prec} k0={live}", lambda: clbs.inverse_core_bwd(
                pts_s, rg, tg, vol_qz, gacc, prec, k0=k0), SPLIT_B4)
        for prec in ("bf16", "highest"):
            for k0v in (0, max(1, int(ti["dom"].k0_for(clbs.TILE_SH)))):
                k0 = torch.tensor([k0v], dtype=torch.int32, device=device)
                line(f"B5 {prec} k0={k0v}", lambda: clbs.shared_blend_bwd(
                    pts_g, vol_all, rmat, k0, gout, prec), SPLIT_B5)
        for prec in ("bf16", "highest"):
            line(f"row7 {prec}", lambda: clbs.shared_core_bwd(
                pts_g, vol_all, gw, prec), SPLIT_B5)


def run_cell(torch, cs, device, tag):
    from hosnerf_tpu_torch.models import lpips
    model, ti = _inputs(torch, cs, device)
    res = {}
    with torch.no_grad():
        cs.check_inverse_bwd(torch, model, ti, res, cs.ITERS)
        cs.check_blend(torch, ti, res, cs.ITERS)
        cs.check_shared_core(torch, ti, res, cs.ITERS)
        cs.check_mlp_bwd(torch, model, ti, res, cs.ITERS)
        cs.b3_launch_split(torch, ti, res)
    del model, ti
    torch.cuda.empty_cache()
    lp = lpips.load_weights(lpips.LPIPS(device=device)).requires_grad_(False)
    _, _, _, ms, one_step = cs.stage3_phase(
        torch, device, torch.cuda.get_device_name(0), lp)
    cs.profile_groups(torch, "one stage-3 step", one_step, ms)


def run_diag(torch, cs, device, tag):
    from torch.profiler import ProfilerActivity, profile

    from hosnerf_tpu_torch.data import synthetic
    from hosnerf_tpu_torch.data.batches import to_device
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.train import stage1, stage2, stage3
    lp = lpips.load_weights(lpips.LPIPS(device=device)).requires_grad_(False)
    hb = cs.train_batch(torch, device)
    cb = to_device(synthetic.composed_batch(2, 32, grid_size=32), device)
    sb = to_device(synthetic.scene_ray_batch(4096, time=0.7), device)

    def human(sparse):
        cfg = stage2.Stage2Config(compute_dtype="bf16", sparse=sparse)
        m, o = stage2.init_state(cfg, seed=0, device=device)
        step = stage2.make_train_step(cfg, m, o, lpips_apply=lp)
        return lambda: step(hb, cs.TRAIN_ITER, torch.Generator().manual_seed(3))

    def cell():
        cfg = stage3.Stage3Config(n_patches=2, compute_dtype="bf16")
        sc, hu, o = stage3.init_state(cfg, seed=0, device=device)
        step = stage3.make_train_step(cfg, sc, hu, o, lpips_apply=lp)
        return lambda: step(cb, cs.TRAIN_ITER, torch.Generator().manual_seed(3))

    def scene():
        cfg = stage1.Stage1Config(num_states=2, compute_dtype="bf16")
        m, o = stage1.init_state(cfg, seed=0, device=device)
        step = stage1.make_train_step(cfg, m, o, [0.5])
        return lambda: step(sb, 5, torch.Generator().manual_seed(3))

    for name, make in (("stage2 sorted", lambda: human(True)),
                       ("stage2 dense", lambda: human(False)),
                       ("stage3", cell), ("stage1", scene)):
        fn = make()
        fn()
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                fn()
                torch.cuda.synchronize()
            finally:
                torch.use_deterministic_algorithms(False)
        msgs = sorted({str(w.message).split(".")[0][:200] for w in caught})
        print(f"[{tag}] {name}: {len(msgs)} ops without a deterministic "
              f"form" + "".join(f"; {m}" for m in msgs), flush=True)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            fn()
            torch.cuda.synchronize()
        ops = sorted({e.key for e in prof.key_averages()
                      if any(k in e.key for k in ATOMIC_OPS)})
        print(f"[{tag}] {name}: ops of interest {ops}", flush=True)


MODES = {"kernels": run_kernels, "cell": run_cell, "diag": run_diag}


def worker(root: str, what: str, tag: str) -> None:
    torch, cs = _setup(root)
    MODES[what](torch, cs, torch.device("cuda", 0), tag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("a", help="checkout A (e.g. the parent)")
    ap.add_argument("b", help="checkout B (e.g. the change)")
    ap.add_argument("--what", nargs="+", default=["kernels", "cell"],
                    choices=sorted(MODES))
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(*args.worker)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("ab_compare: no CUDA device", file=sys.stderr)
        return 2
    from hosnerf_tpu_torch.tools import common
    print(common.card_line(), flush=True)
    rc = 0
    for what in args.what:
        for root, tag in ((args.a, "A1"), (args.b, "B1"), (args.b, "B2"),
                          (args.a, "A2")):
            # this file as a script: the worker imports the package (and
            # chip_smoke.py) of `root`, not of the checkout running this
            r = subprocess.run(
                [sys.executable, os.path.abspath(__file__), args.a, args.b,
                 "--worker", root, what, tag],
                capture_output=True, text=True)
            print(f"===== {what} {tag} ({root}) rc={r.returncode}", flush=True)
            print("\n".join(ln for ln in r.stdout.splitlines()
                            if not ln.startswith("[step")), flush=True)
            if r.returncode:
                print(r.stderr[-3000:], flush=True)
                rc = 1
    return rc


if __name__ == "__main__":
    sys.exit(main())
