#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hosnerf_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run:
  build     every CUDA source under hosnerf_tpu_torch/csrc, one nvcc each,
            all started together; ptxas's report per kernel (registers,
            stack, spills, serialised-wgmma notes) printed;
  kernels   each hand-written kernel against its plain PyTorch version on
            the card, both precisions, outputs NaN-poisoned first: the
            render kernels (inverse LBS B1, embed+trunk B2) at the render
            path's shapes (1,048,576 samples per 8192-ray chunk), the
            training kernels (trunk backward B3, inverse-LBS backward B4,
            forward LBS B5 forward and backward) at the training step's
            (262,144 samples: 2 patches of 32 x 32 rays, 128 samples each),
            the block-skipping kernels (B1-B5) at k0 = 0, at the batch's
            own live k0 and at the all-dead clamp; B1 also at the training
            inputs; B1/B4 report their entry time, their kernels' device
            time (profiler) and the corner image's; B1/B4, B5 and row 7
            beside a library route (bmm + grid_sample f32 + blend for the
            inverse LBS, grid_sample f32 for row 7, for B5 followed by the
            K-set blend), held to the f32 plain version first; B2, B3 and row 8 also report
            TFLOP/s and their share of the bound, and B3's three launches
            (recompute, rows, dW) are timed apart under torch.profiler; the four inverse-LBS cores
            (rows 6, 9, 10, 11: B1/B4 on the training points in each core's
            row order), the all-bone weights (row 7) on the training step's
            canonical points, the trunk-only MLP (row 8) at
            tools/bench_mlp.py's two layouts and 262,144 rows, and the
            pair-grid prototype (row 12) at its own shapes; rows 7, 8 and
            12 then once more through their user entry points
            (`ops/lbs.py::bone_weights`, `ops/cuda/mlp.py::fused_trunk`
            with its backward, `tools/proto_pairgrid.py`), launches counted
            around each;
  render    3 frames of 128 x 128 rays through the port's render entry point
            (`eval/renderers.py`: render_human_image + make_render_fn) with
            the full-width stage-2 model (random weights from seed 0, bf16
            trunks), the render kernels' launch counts read around that run,
            the image checked, and one chunk held against the dense plain
            path;
  profile   one more frame under torch.profiler: device and host time by
            operator, the LBS kernels' device time, and the device's idle
            share;
  train     the stage-2 training step (`train/stage2.py`: init_state +
            make_train_step, LPIPS on the patches with the random backbone)
            at full width on one fixed synthetic batch at iter 60,000: one
            warm-up step, then TRAIN_STEPS timed steps with all six kernels'
            launch counts read around them; the loss finite at every step
            and lower afterwards than at the first step;
  profile   one more training step under torch.profiler; then one
            more step with B5's backward inputs captured, and that
            backward timed on the step's own gradient beside a random one;
  dense     the same training step on the dense per-sample path
            (`sparse=False`: the Morton-order inverse core, the trunks and
            the forward LBS on every sample): one warm-up and DENSE_STEPS
            timed steps, launches read around them; one step with
            lbs_impl='pallas_dense' (the ray-order core); one render chunk
            through the dense path with each inverse core against the
            sorted path on the same weights;
  profile   one dense training step under torch.profiler;
  gradcheck one step's gradients, the kernel path on the card against the
            same path through the kernels' plain versions on the CPU (f32
            trunks, same weights), parameter by parameter
            (`train/gradcheck.py`), the sorted and the dense path, each
            on the training batch.

Stdout ends with the card's name and power limit, one JSON line of kernel
results and one JSON status line. The render kernels' entries report the
render path (their launches there, their times at its shapes), the training
kernels' entries the training step, the inverse cores the dense step and
the dense render chunks, rows 7, 8 and 12 their entry points' runs.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

RAYS = 128 * 128           # one frame
CHUNK = 8192               # rays per chunk (renderers.render_human_image)
FRAMES = 3
ITER = 10 ** 7             # the render path's iter_val
TRAIN_ITER = 60_000        # non-rigid condition and full hann band on
TRAIN_STEPS = 10
# kernel launches per training step: the sorted path runs the inverse LBS
# once, the trunks four times (non-rigid, canonical, and the forward
# non-rigid MLP on both deform streams) and the forward LBS once
PER_STEP = {"inverse_core_pg_s": 1, "fused_embed_trunk": 4,
            "shared_blend_fwd": 1, "inverse_core_bwd": 1,
            "fused_embed_trunk_bwd": 4, "shared_blend_bwd": 1}
DENSE_STEPS = 3
# per dense training step: the Morton-order inverse core and B4 once, the
# trunks three times (non-rigid, canonical, and one forward non-rigid call
# over both deform streams), the forward LBS once; lbs_impl='pallas_dense'
# takes the ray-order core and, as the JAX package dispatches it, the
# gather forward LBS
PER_DENSE_STEP = {"inverse_core_pg": 1, "inverse_core_bwd": 1,
                  "fused_embed_trunk": 3, "fused_embed_trunk_bwd": 3,
                  "shared_blend_fwd": 1, "shared_blend_bwd": 1}
PER_PALLAS_DENSE_STEP = {"inverse_core": 1, "inverse_core_bwd": 1,
                         "fused_embed_trunk": 3, "fused_embed_trunk_bwd": 3}

# Tolerances, kernel vs its plain version on the same inputs:
# inverse LBS does the same arithmetic in the same order with
# round-to-nearest intrinsics on both sides -> 1e-6 of the output scale.
TOL_LBS = 1e-6
# embed+trunk, f32: summation order only -> 1e-5 of the scale. bf16: one
# flipped bf16 rounding of an activation moves an output by about a bf16
# ulp of the activations -> 1e-2 of the scale, and at most 5% of the
# entries beyond 1e-3 of it.
TOL_MLP = {"highest": 1e-5, "bf16": 1e-2}
# Backward kernels, (relative L2, max error over the output's scale). The
# sums over samples (dvol, drg, drmat, dW, broadcast daux) come in atomic
# order: 1e-4 for the LBS backwards (B4, B5) and the forward LBS (1e-5).
# In bf16 the LBS backwards round a gradient factor (gw hz in B4, gw =
# bf16(dw) in B5) that kernel and plain version sum in another f32 order;
# where it lands on a rounding boundary the two round apart by one bf16
# ulp (2^-7 relative) of that term -> max 1e-2 of the scale (H100, B5 at
# the training shapes: 3.7e-4), L2 unchanged.
# Trunk backward (B3), (relative L2, threshold over the scale, share of
# entries allowed beyond it): highest sums in another f32 order, and among
# the ~2e8-5e8 pre-activations of a call some sit within f32 noise of 0
# and flip their ReLU mask, which moves that row's gradients by up to
# their own size (H100, non-rigid daux: one entry at 2.3% of the scale,
# L2 2.2e-4), so no max bound holds; bf16 adds flipped bf16 roundings of
# activations and of gc (2^-9), which the fourier PE multiplies by up to
# 2^9 in dx (tests/test_torch_cuda.py at 3,000 rows, H100: 1e-2 L2, 7e-2
# max on dx). So B3 is held to its L2 and to at most 0.1% of entries off
# by more than 1% (highest) or 10% (bf16) of the scale.
TOL_BWD = {"lbs_highest": (1e-4, 1e-4), "lbs_bf16": (1e-4, 1e-2),
           "blend_fwd": (1e-5, 1e-5),
           "mlp_highest": (2e-3, 1e-2, 1e-3), "mlp_bf16": (2e-2, 1e-1, 1e-3)}
# Render chunk, sorted kernel path vs dense plain path (gather LBS in f32,
# module MLPs with cuBLAS bf16). With random weights the subject is faint
# (alpha up to a few 1e-2), so alpha and the darkening 1 - rgb are compared
# relative to their own maxima, which must show a rendered subject
# (alpha max >= MIN_ALPHA). The kernel path samples the weight volume with
# bf16 taps (2^-9 relative) and its trunks sum in another order, which the
# fourier PE (frequencies up to 2^9) amplifies at single samples: the same
# comparison on the CPU at full width differs by <= 0.9% of the maximum
# -> max 5%, mean 0.2% of the maximum.
TOL_RENDER_MAX, TOL_RENDER_MEAN, MIN_ALPHA = 5e-2, 2e-3, 1e-2
# Training gradients, the kernel path on the card vs the same sorted path
# on the plain versions on the CPU (f32 trunks, bf16 LBS taps on both
# sides, same weights and batch): relative L2 per parameter with a nonzero
# gradient, and the loss relative to the plain one. The two differ by the
# kernels' summation order and the bf16 tap roundings it flips: H100 at
# the training batch, worst 2.5e-3 (pose decoder's dstR/dstT heads), the
# loss equal to 8 digits -> 1e-2. A kernel wired wrongly moves gradients
# by far more (B4 without its dTg term: see PERF.md).
TOL_GRAD = 1e-2
TOL_GRAD_LOSS = 1e-4
ITERS = 10                 # timed launches per kernel measurement
# B5 backward on one training step's own inputs (capture_blend_bwd); B1
# and B4: kernel device time (profiler), the corner image's, the entry at
# k0 = 0, the live pairs and the k0 timed
EXTRA_KEYS = ("step_grad_ms", "step_random_grad_ms", "step_rows",
              "device_ms", "image_ms", "k0_zero_ms", "live_pairs", "k0")

# H100 SXM peaks (NVIDIA data sheet), for the bounds: HBM bytes/s, dense
# bf16 tensor-core FLOP/s, f32 FLOP/s outside the tensor cores.
HBM_BPS, BF16_FLOPS, F32_FLOPS = 3.35e12, 989e12, 67e12
# f32 operations each kernel does, counted from its arithmetic: per live
# (sample, bone) pair for the inverse LBS (affine 18, taps 24, xy weights
# 4, z column 16, blend 8; the backward adds the derivative taps, dvol
# products and the affine's adjoint), per (computed sample, bone) for the
# forward LBS (z columns 16, weight 4, blend 2 x 12K; the backward adds
# dw 2 x 12K, dvol/U 32, dfz 6).
OPS_B1_PAIR, OPS_B4_PAIR = 75, 250
OPS_B5F_BONE, OPS_B5B_BONE = 68, 166
# the all-bone weights (row 7): per sample its taps and xy weights (28);
# per (sample, bone) z columns 16 and the weight 4; the backward adds per
# (sample, bone) the gradient rounding 2, dvol/U 32 and dfz 6, and per
# sample dfx/dfy (16)
OPS_W_SAMPLE, OPS_W_FWD = 28, 20
OPS_W_SAMPLE_BWD, OPS_W_BWD = 16, 40


class SmokeFailure(Exception):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def time_ms(torch, fn, iters: int) -> float:
    """Mean device time of fn over `iters` launches after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0):
    """(least ms the card could take, 'bytes' or 'operations')."""
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (f32_ops / F32_FLOPS + bf16_ops / BF16_FLOPS) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rate(res, flops: float) -> str:
    """Adds the achieved rate (TFLOP/s, from the algorithm's matmul
    operations over the kernel time) and the share of the bound
    (bound_ms / ms) to a kernel's result; returns them for its line."""
    res["flops"] = flops
    res["tflops"] = flops / res["ms"] / 1e9
    res["bound_share"] = res["bound_ms"] / res["ms"]
    return (f" tflops={res['tflops']:.1f} "
            f"bound_share={res['bound_share']:.3f}")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def poison(torch, device, *out_bytes: int):
    """Empty the allocator cache, then fill and free NaN blocks: four of
    each output's size and a few small ones for the wrapper's scratch, so
    the caching allocator (best fit) hands each output NaN-filled memory,
    the state a missed write would leave behind. Callers free the previous
    round's tensors first, so that no partly used segment keeps a free
    block that fits an output better. Returns the poisoned address
    ranges, adjacent ones merged (freed neighbours coalesce), for
    `landed`."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    sizes = [nb for nb in out_bytes for _ in range(4)] + [4 << 20] * 4
    blocks = [torch.full((-(-nb // 4),), float("nan"), device=device)
              for nb in sizes]
    ranges = []
    for a, b in sorted((t.data_ptr(), t.data_ptr() + 4 * t.numel())
                       for t in blocks):
        if ranges and a <= ranges[-1][1]:
            ranges[-1] = (ranges[-1][0], max(ranges[-1][1], b))
        else:
            ranges.append((a, b))
    return ranges


def landed(t, ranges) -> bool:
    """Whether tensor t was allocated inside poisoned memory."""
    lo = t.data_ptr()
    hi = lo + t.numel() * t.element_size()
    return any(a <= lo and hi <= b for a, b in ranges)


def close(torch, got, ref, tols, what: str):
    """Relative L2 within tols[0], and the error over the reference's
    scale within tols[1]: everywhere, or, with a third entry, outside at
    most that share of the entries. Returns (max abs error, that error
    over the scale)."""
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite entries")
    scale = float(ref.abs().max()) + 1e-30
    diff = (got - ref).abs()
    err = float(diff.max())
    l2 = float(torch.linalg.norm(got - ref) / (torch.linalg.norm(ref)
                                                + 1e-30))
    share = float((diff > tols[1] * scale).float().mean())
    allowed = tols[2] if len(tols) > 2 else 0.0
    check(l2 <= tols[0] and share <= allowed,
          f"{what}: rel L2 {l2:.3e} (tol {tols[0]}), max err {err:.3e} of "
          f"scale {scale:.3e}, {share:.2e} of entries beyond {tols[1]} of "
          f"it (allowed {allowed})")
    return err, err / scale


def worst(errs):
    """(max abs error, max error over scale) over several outputs."""
    errs = list(errs)
    return max(e for e, _ in errs), max(r for _, r in errs)


def frame_item(seed: int, G: int):
    from hosnerf_tpu_torch.data import synthetic
    item = synthetic.human_batch(RAYS // 64, 8, seed=seed, grid_size=G)
    item.update(img_height=128, img_width=128)
    return item


def chunk_batch(torch, item, device, start: int = 0):
    from hosnerf_tpu_torch.eval import renderers
    keys = renderers.HUMAN_SHARED_KEYS + renderers.HUMAN_RAY_KEYS
    b = {k: torch.as_tensor(item[k], device=device) for k in keys}
    for k in renderers.HUMAN_RAY_KEYS:
        b[k] = b[k][start:start + CHUNK]
    return b


def sorted_inputs(torch, model, batch, iter_val=ITER):
    """The sorted-domain inputs of the inverse LBS for one batch, as
    models/human.py::_samples_sorted builds them."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    si = model.sample_inputs(batch, iter_val)
    s_, o_, rg, tg, vol_qz = clbs.grid_tables(
        si["m_sR"], si["m_T"], si["vol"], batch["cnl_bbox_min_xyz"],
        batch["cnl_bbox_scale_xyz"])
    dom = clbs.bp_prepare(si["pts_flat"], rg, tg, model.mweight_volume_size,
                          model.total_bones)
    return si, dom, dom.sort_rows(si["pts_flat"].float()), rg, tg, vol_qz, \
        s_, o_


def live_pairs(pts_s, rg, tg, G: int) -> int:
    """(sample, bone) pairs inside a bone's support: the inverse-LBS
    kernels' data-dependent work."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    return sum(int(clbs._sample_support(p, rg, tg, G).sum())
               for p in pts_s.split(1 << 18))


def trunk_specs(torch, model, si, n_pad):
    """Both trunk specs with the model's weights: {name: (keywords, aux,
    alpha, layers, out)}."""
    state = torch.stack(list(model.human_stateembeds))[0].contiguous()
    return {
        "nonrigid": (dict(kind="hannw", multires=model.nr_multires,
                          aux_mode="stream", aux_first=True,
                          skip_before=model.nr_skips[0],
                          skip_source="embed"),
                     si["cond"].expand(n_pad, si["cond"].shape[-1]),
                     si["alpha"],
                     *model._fused_params(model.non_rigid_mlp,
                                          model.nr_mlp_depth)),
        "canonical": (dict(kind="fourier", multires=model.cnl_multires,
                           aux_mode="broadcast", aux_first=False,
                           skip_before=5, skip_source="full_input"),
                      state, None,
                      *model._fused_params(model.cnl_mlp,
                                           model.cnl_mlp_depth)),
    }


def trunk_flops(layers, out, rows: int) -> float:
    """Matmul FLOPs of one trunk forward over `rows` rows."""
    macs = sum(int(w.shape[0]) * int(w.shape[1]) for w, _ in layers)
    return 2.0 * rows * (macs + int(out[0].numel()))


# ---------------------------------------------------------------------------
# kernels phase: render shapes (B1, B2)
# ---------------------------------------------------------------------------

INV_PARTS = (("image", ("inv_image_kernel",)), ("fwd", ("inv_fwd_kernel",)),
             ("bwd", ("inv_bwd_kernel", "inv_fold_kernel")),
             ("memset", ("Memset",)))


def device_ms(torch, fn, parts, reps=5):
    """{part: device ms per call of fn} from torch.profiler's kernel
    records (mean of `reps` calls after one warm-up); `parts` maps each
    part to substrings of its kernels' names."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {part: sum(e.self_device_time_total for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and any(k in e.key for k in kernels)) / 1e3 / reps
            for part, kernels in parts}


def inverse_k0_cases(dom, n: int):
    """(k0, first computed row) for the inverse kernels: 0, the sorted
    domain's own k0 and the all-dead clamp."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    return [(k0, clbs.first_live_row(k0, n, clbs.INV_TILE))
            for k0 in (0, int(dom.k0_for(clbs.INV_TILE)), 10 ** 6)]


def check_inverse_fwd(torch, pts_s, rg, tg, vol_qz, dom, results, key,
                      iters, what):
    """B1 vs its plain version at k0 = 0, the domain's own k0 and the
    all-dead clamp, both precisions, on NaN-poisoned outputs: every row at
    or after the clamped k0 * INV_TILE equal to the plain version (TOL_LBS
    of the scale; in practice bit for bit), the rows below it exactly 0.
    Timed at the domain's k0 (what the sorted path runs) and at 0: the
    entry by CUDA events, its kernels by the profiler; the bf16 line also
    times the library route (held to the f32 plain version within the
    render tolerances first)."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    n, dev = pts_s.shape[0], pts_s.device
    G = vol_qz.shape[-1]
    dead = int(dom.n_dead_groups) * clbs.SORT_GROUP
    pairs = live_pairs(pts_s, rg, tg, G)
    cases = inverse_k0_cases(dom, n)
    live_k0, first = cases[1]
    for prec in ("bf16", "highest"):
        ref = clbs.inverse_core_plain(pts_s, rg, tg, vol_qz, prec)
        scale = float(ref.abs().max())
        err = 0.0
        for k0, lo in cases:
            k0_t = torch.tensor([k0], dtype=torch.int32, device=dev)
            ranges = poison(torch, dev, ref.numel() * 4)
            got = clbs.inverse_core_pg_s(pts_s, rg, tg, vol_qz, prec,
                                         k0_blocks=k0_t)
            torch.cuda.synchronize()
            check(landed(got, ranges), f"inverse LBS {what} {prec} k0={k0}: "
                  "output missed the poison")
            check(bool(torch.isfinite(got).all()), f"inverse LBS {what} "
                  f"{prec} k0={k0}: non-finite output (unwritten rows?)")
            check(lo == 0 or not bool(got[:lo].any()), f"inverse LBS {what} "
                  f"{prec} k0={k0}: rows below k0 not exactly 0")
            e = float((got[lo:] - ref[lo:]).abs().max())
            check(e <= TOL_LBS * scale, f"inverse LBS {what} {prec} k0={k0}:"
                  f" max err {e} > {TOL_LBS} x {scale}")
            check(lo > dead or bool(torch.equal(got[:lo], ref[:lo])),
                  f"inverse LBS {what} {prec} k0={k0}: dead rows differ")
            err = max(err, e)
            del got
        k0_t = torch.tensor([live_k0], dtype=torch.int32, device=dev)
        ms = time_ms(torch, lambda: clbs.inverse_core_pg_s(
            pts_s, rg, tg, vol_qz, prec, k0_blocks=k0_t), iters)
        ms0 = time_ms(torch, lambda: clbs.inverse_core_pg_s(
            pts_s, rg, tg, vol_qz, prec), iters)
        parts = device_ms(torch, lambda: clbs.inverse_core_pg_s(
            pts_s, rg, tg, vol_qz, prec, k0_blocks=k0_t), INV_PARTS)
        plain_ms = time_ms(torch, lambda: clbs.inverse_core_plain(
            pts_s, rg, tg, vol_qz, prec), max(1, iters // 5))
        vol_b = vol_qz.numel() * (2 if prec == "bf16" else 4)
        bms, by = bound(nbytes(pts_s[first:], rg, tg, ref) + vol_b,
                        f32_ops=OPS_B1_PAIR * pairs)
        res = dict(err=err, rel=err / scale, ms=ms, k0_zero_ms=ms0,
                   device_ms=parts["fwd"], image_ms=parts["image"],
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   live_pairs=pairs, k0=live_k0)
        line = (f"kernel inverse_core_pg_s {prec} ({what}): n={n} "
                f"dead_rows={dead} k0={live_k0} live_pairs={pairs} "
                f"max_abs_err={err:.3e} scale={scale:.3e} entry ms={ms:.4f} "
                f"(k0=0 {ms0:.4f}) device ms={parts['fwd']:.4f} image "
                f"ms={parts['image']:.4f} plain_ms={plain_ms:.4f} "
                f"bound_ms={bms:.5f} ({by}) share {bms / ms:.3f} of the "
                f"entry, {bms / parts['fwd']:.3f} of the kernel")
        print(line, flush=True)
        results[(key, prec)] = res
        del ref
    # last: its temporaries would otherwise share segments with the
    # outputs that `poison` has to reach
    lib_ms, _ = time_library_inverse(torch, pts_s, rg, tg, vol_qz, None,
                                     iters)
    results[(key, "bf16")]["library_ms"] = lib_ms
    print(f"kernel inverse_core_pg_s ({what}): library route (bmm + "
          f"grid_sample f32 + blend) ms={lib_ms:.4f}", flush=True)


def time_library_inverse(torch, pts, rg, tg, vol_qz, gacc, iters):
    """The library route (`library_inverse`) held to the f32 plain version
    within the render tolerances (max and mean error over the scale), then
    timed forward and, given gacc, through its autograd backward: (fwd ms,
    bwd ms or None)."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    fn, vol5 = library_inverse(torch, vol_qz)
    ref = clbs.inverse_core_plain(pts, rg, tg, vol_qz, "highest")
    diff = (fn(pts, rg, tg) - ref).abs()
    scale = float(ref.abs().max())
    check(float(diff.max()) <= TOL_RENDER_MAX * scale
          and float(diff.mean()) <= TOL_RENDER_MEAN * scale,
          f"library inverse LBS vs plain f32: max {float(diff.max()):.3e}, "
          f"mean {float(diff.mean()):.3e} of scale {scale:.3e}")
    del diff, ref
    fwd = time_ms(torch, lambda: fn(pts, rg, tg), iters)
    if gacc is None:
        return fwd, None
    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_()
                  for t in (pts, rg, tg, vol5)]
        y = fn(*leaves)
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            y, leaves, gacc, retain_graph=True), iters)
    return fwd, bwd


def check_lbs(torch, model, batch, results, iters):
    """B1 at the render shapes (one 8192-ray chunk, sorted); returns the
    sorted inputs and the skeleton points for the trunk checks."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    si, dom, pts_s, rg, tg, vol_qz, s_, o_ = sorted_inputs(torch, model,
                                                           batch)
    check_inverse_fwd(torch, pts_s, rg, tg, vol_qz, dom, results, "lbs",
                      iters, "render chunk")
    acc = clbs.inverse_core_pg_s(pts_s, rg, tg, vol_qz, "bf16")
    x_skel_s, _ = clbs.world_from_grid(acc, s_, o_)
    return si, dom, x_skel_s.contiguous()


def check_mlp(torch, model, si, dom, x_skel_s, results, iters):
    """Both trunk specs at the render shapes with the model's weights:
    k0 = 0, the chunk's own dead-prefix k0 (at least 1), and the all-dead
    clamp; rows below the clamped k0 * 1024 are not compared. The library
    route, the module MLPs on cuBLAS bf16, is timed beside the bf16 kernel."""
    from hosnerf_tpu_torch.models import embedders
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    n_pad = x_skel_s.shape[0]
    n_blocks = -(-n_pad // cmlp.MLP_TILE)
    live_k0 = max(1, int(dom.k0_for(cmlp.MLP_TILE)))
    specs = trunk_specs(torch, model, si, n_pad)
    library = {
        "nonrigid": lambda: model.non_rigid_mlp(
            embedders.hannw_fourier_embed(x_skel_s, model.nr_multires,
                                          si["alpha"]), x_skel_s,
            specs["nonrigid"][1]),
        "canonical": lambda: model.cnl_mlp(torch.cat([
            embedders.fourier_embed(x_skel_s, model.cnl_multires),
            specs["canonical"][1].expand(n_pad, -1)], -1)),
    }
    for name, (kw, aux, alpha, layers, out) in specs.items():
        espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], aux.shape[-1],
                               kw["aux_mode"], kw["aux_first"])
        for prec in ("bf16", "highest"):
            ref = cmlp.fused_embed_trunk_plain(
                x_skel_s, aux, alpha, layers, out, espec=espec,
                skip_before=kw["skip_before"],
                skip_source=kw["skip_source"], precision=prec)
            scale = float(ref.abs().max())
            for k0 in (0, live_k0, 10 ** 6):
                k0_t = torch.tensor([k0], dtype=torch.int32,
                                    device=x_skel_s.device)
                ranges = poison(torch, x_skel_s.device, ref.numel() * 4)
                got = cmlp.fused_embed_trunk(x_skel_s, aux, alpha, layers,
                                             out, precision=prec,
                                             k0_blocks=k0_t, **kw)
                torch.cuda.synchronize()
                check(landed(got, ranges),
                      f"{name} {prec} k0={k0}: output missed the poison")
                first = min(k0, n_blocks - 1) * cmlp.MLP_TILE
                check(bool(torch.isnan(got[:first]).all()),
                      f"{name} {prec} k0={k0}: rows below k0 were written")
                g, r = got[first:], ref[first:]
                check(bool(torch.isfinite(g).all()),
                      f"{name} {prec} k0={k0}: non-finite live rows")
                e = (g - r).abs()
                err = float(e.max())
                frac = float((e > 1e-3 * scale).float().mean())
                check(err <= TOL_MLP[prec] * scale and frac <= 0.05,
                      f"{name} {prec} k0={k0}: max err {err} (scale "
                      f"{scale}), {frac:.4f} of entries beyond 1e-3")
                line = (f"kernel fused_embed_trunk {name} {prec} k0={k0} "
                        f"rows={n_pad - first} max_abs_err={err:.3e} "
                        f"scale={scale:.3e} beyond_1e-3={frac:.4f}")
                if k0 in (0, live_k0):
                    ms = time_ms(torch, lambda: cmlp.fused_embed_trunk(
                        x_skel_s, aux, alpha, layers, out, precision=prec,
                        k0_blocks=k0_t, **kw), iters)
                    line += f" ms={ms:.4f}"
                    if k0 == 0:
                        plain_ms = time_ms(
                            torch, lambda: cmlp.fused_embed_trunk_plain(
                                x_skel_s, aux, alpha, layers, out,
                                espec=espec, skip_before=kw["skip_before"],
                                skip_source=kw["skip_source"],
                                precision=prec), max(1, iters // 5))
                        line += f" plain_ms={plain_ms:.4f}"
                        res = dict(err=err, rel=err / scale, ms=ms,
                                   plain_ms=plain_ms)
                        flops = trunk_flops(layers, out, n_pad)
                        if prec == "bf16":
                            res["library_ms"] = time_ms(
                                torch, library[name], iters)
                            line += f" library_ms={res['library_ms']:.4f}"
                        res["bound_ms"], res["bound_by"] = bound(
                            nbytes(x_skel_s, got, *[t for p in layers
                                                    for t in p], *out)
                            + (nbytes(aux) if kw["aux_mode"] == "broadcast"
                               else aux.shape[-1] * 4),
                            **({"bf16_ops": flops} if prec == "bf16"
                               else {"f32_ops": flops}))
                        line += (f" bound_ms={res['bound_ms']:.5f} "
                                 f"({res['bound_by']})") + rate(res, flops)
                        results[(name, prec)] = res
                print(line, flush=True)
                del got, g, r, e


# ---------------------------------------------------------------------------
# kernels phase: training shapes (B3, B4, B5)
# ---------------------------------------------------------------------------

def train_batch(torch, device, n_patches=2, patch_size=32, G=32):
    from hosnerf_tpu_torch.data import synthetic
    nb = synthetic.human_batch(n_patches, patch_size, grid_size=G)
    return {k: torch.as_tensor(v, device=device) for k, v in nb.items()}


def train_kernel_inputs(torch, model, batch):
    """The training kernels' inputs at one step's shapes, as
    models/human.py::_samples_sorted builds them (every row computed, so
    the rows below any k0 are finite)."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    si, dom, pts_s, rg, tg, vol_qz, s_, o_ = sorted_inputs(
        torch, model, batch, TRAIN_ITER)
    n_pad = pts_s.shape[0]
    acc = clbs.inverse_core_pg_s(pts_s, rg, tg, vol_qz, "bf16")
    x_skel_s, _ = clbs.world_from_grid(acc, s_, o_)
    x_skel_s = x_skel_s.contiguous()
    specs = trunk_specs(torch, model, si, n_pad)
    kw, aux, alpha, layers, out = specs["nonrigid"]
    cnl_pts_s = (x_skel_s + cmlp.fused_embed_trunk(
        x_skel_s, aux, alpha, layers, out, precision="bf16", **kw)
                 ).contiguous()
    p_sR, p_T, _ = model._prev_transforms(batch, TRAIN_ITER)
    s, o, vol_all, rmat = clbs.blend_tables(
        torch.stack([si["m_sR_fwd"], p_sR]), torch.stack([si["m_T_fwd"],
                                                          p_T]),
        si["vol"], batch["cnl_bbox_min_xyz"], batch["cnl_bbox_scale_xyz"])
    pts_g = (cnl_pts_s * s[None] + o[None]).contiguous()
    return dict(si=si, dom=dom, pts_s=pts_s, rg=rg, tg=tg, vol_qz=vol_qz,
                x_skel_s=x_skel_s, cnl_pts_s=cnl_pts_s, specs=specs,
                pts_g=pts_g, vol_all=vol_all, rmat=rmat.contiguous(),
                n_pad=n_pad)


def check_inverse_bwd(torch, model, ti, results, iters):
    """B1 at the training inputs (`check_inverse_fwd`), then B4 vs its
    plain version at k0 = 0, the domain's own k0 and the all-dead clamp,
    both precisions: NaN-poisoned dpts, its rows below the clamped k0 *
    INV_TILE exactly 0, every output within TOL_BWD of the plain version
    on the rows from there on. Timed as B1, with the library route's
    autograd backward."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    pts_s, rg, tg, vol_qz = ti["pts_s"], ti["rg"], ti["tg"], ti["vol_qz"]
    dom = ti["dom"]
    check_inverse_fwd(torch, pts_s, rg, tg, vol_qz, dom, results,
                      "lbs_train", iters, "training inputs")
    n, dev = pts_s.shape[0], pts_s.device
    dead = int(dom.n_dead_groups) * clbs.SORT_GROUP
    gacc = torch.randn(n, 4, device=dev,
                       generator=torch.Generator(dev).manual_seed(5))
    pairs = live_pairs(pts_s, rg, tg, model.mweight_volume_size)
    cases = inverse_k0_cases(dom, n)
    live_k0, first = cases[1]
    for prec in ("bf16", "highest"):
        err, rel = 0.0, 0.0
        for k0, lo in cases:
            k0_t = torch.tensor([k0], dtype=torch.int32, device=dev)
            ref = clbs.inverse_core_bwd_plain(pts_s[lo:], rg, tg, vol_qz,
                                              gacc[lo:], prec)
            ranges = poison(torch, dev, n * 12)
            got = clbs.inverse_core_bwd(pts_s, rg, tg, vol_qz, gacc, prec,
                                        k0=k0_t)
            torch.cuda.synchronize()
            check(landed(got[0], ranges), f"inverse LBS bwd {prec} k0={k0}: "
                  "dpts missed the poison")
            check(lo == 0 or not bool(got[0][:lo].any()), f"inverse LBS bwd "
                  f"{prec} k0={k0}: dpts rows below k0 not exactly 0")
            check(dead == 0 or not bool(got[0][:dead].any()), f"inverse LBS "
                  f"bwd {prec} k0={k0}: dead rows of dpts not exactly 0")
            e, r = worst(close(torch, a, b, TOL_BWD[f"lbs_{prec}"],
                               f"inverse LBS bwd {prec} k0={k0} {name}")
                         for name, a, b in zip(
                             ("dpts", "drg", "dtg", "dvol"),
                             (got[0][lo:],) + tuple(got[1:]), ref))
            err, rel = max(err, e), max(rel, r)
            del got, ref
        k0_t = torch.tensor([live_k0], dtype=torch.int32, device=dev)
        ms = time_ms(torch, lambda: clbs.inverse_core_bwd(
            pts_s, rg, tg, vol_qz, gacc, prec, k0=k0_t), iters)
        ms0 = time_ms(torch, lambda: clbs.inverse_core_bwd(
            pts_s, rg, tg, vol_qz, gacc, prec), iters)
        parts = device_ms(torch, lambda: clbs.inverse_core_bwd(
            pts_s, rg, tg, vol_qz, gacc, prec, k0=k0_t), INV_PARTS)
        plain_ms = time_ms(torch, lambda: clbs.inverse_core_bwd_plain(
            pts_s, rg, tg, vol_qz, gacc, prec), 1)
        got = clbs.inverse_core_bwd(pts_s, rg, tg, vol_qz, gacc, prec,
                                    k0=k0_t)
        vol_b = vol_qz.numel() * (2 if prec == "bf16" else 4)
        bms, by = bound(nbytes(pts_s[first:], rg, tg, gacc[first:], *got)
                        + vol_b, f32_ops=OPS_B4_PAIR * pairs)
        kernel_ms = parts["bwd"] + parts["memset"]
        res = dict(err=err, rel=rel, ms=ms, k0_zero_ms=ms0,
                   device_ms=kernel_ms, image_ms=parts["image"],
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   live_pairs=pairs, k0=live_k0)
        line = (f"kernel inverse_core_bwd {prec}: n={n} dead_rows={dead} "
                f"k0={live_k0} live_pairs={pairs} max_abs_err={err:.3e} "
                f"max_err_over_scale={rel:.3e} entry ms={ms:.4f} (k0=0 "
                f"{ms0:.4f}) device ms={kernel_ms:.4f} (kernel and fold "
                f"{parts['bwd']:.4f}, memset {parts['memset']:.4f}; image "
                f"{parts['image']:.4f} when not kept from the forward) "
                f"plain_ms={plain_ms:.4f} bound_ms={bms:.5f} ({by}) share "
                f"{bms / ms:.3f} of the entry, {bms / kernel_ms:.3f} of the "
                "kernels")
        print(line, flush=True)
        results[("lbs_bwd", prec)] = res
        del got
    _, lib_ms = time_library_inverse(torch, pts_s, rg, tg, vol_qz, gacc,
                                     iters)
    results[("lbs_bwd", "bf16")]["library_ms"] = lib_ms
    print(f"kernel inverse_core_bwd: library route (autograd of bmm + "
          f"grid_sample f32 + blend) ms={lib_ms:.4f}", flush=True)


def check_blend(torch, ti, results, iters):
    """B5 forward and backward vs their plain versions at k0 = 0, the
    batch's live k0 (512-row blocks) and the all-dead clamp: forward rows
    below the clamped k0 * 512 left unwritten (NaN), backward dpts rows
    there exactly 0."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    pts_g, vol_all, rmat = ti["pts_g"], ti["vol_all"], ti["rmat"]
    dev = pts_g.device
    n = pts_g.shape[0]
    B = rmat.shape[0]
    gout = torch.randn(n, 7, device=dev,
                       generator=torch.Generator(dev).manual_seed(6))
    live_k0 = max(1, int(ti["dom"].k0_for(clbs.TILE_SH)))
    for prec in ("bf16", "highest"):
        ref_f = clbs.shared_blend_plain(pts_g, vol_all, rmat, prec)
        for k0 in (0, live_k0, 10 ** 6):
            k0_t = torch.tensor([k0], dtype=torch.int32, device=dev)
            first = clbs.first_live_row(k0, n, clbs.TILE_SH)
            ranges = poison(torch, dev, ref_f.numel() * 4)
            got = clbs.shared_blend_fwd(pts_g, vol_all, rmat, k0_t, prec)
            torch.cuda.synchronize()
            check(landed(got, ranges), f"forward LBS {prec} k0={k0}: output "
                  "missed the poison")
            check(bool(torch.isnan(got[:first]).all()),
                  f"forward LBS {prec} k0={k0}: rows below k0 were written")
            err_f, rel_f = close(torch, got[first:], ref_f[first:],
                                 TOL_BWD["blend_fwd"],
                                 f"forward LBS {prec} k0={k0}")
            ref_b = clbs.shared_blend_bwd_plain(pts_g, vol_all, rmat, k0,
                                                gout, prec)
            ranges = poison(torch, dev, n * 12)
            got_b = clbs.shared_blend_bwd(pts_g, vol_all, rmat, k0_t, gout,
                                          prec)
            torch.cuda.synchronize()
            check(landed(got_b[0], ranges), f"forward LBS bwd {prec} "
                  f"k0={k0}: dpts missed the poison")
            check(first == 0 or float(got_b[0][:first].abs().max()) == 0.0,
                  f"forward LBS bwd {prec} k0={k0}: dpts rows below k0 not 0")
            err_b, rel_b = worst(
                close(torch, a, b, TOL_BWD[f"lbs_{prec}"],
                      f"forward LBS bwd {prec} k0={k0} {name}")
                for name, a, b in zip(("dpts", "dvol", "drmat"), got_b,
                                      ref_b))
            line = (f"kernel shared_blend {prec} k0={k0} rows={n - first} "
                    f"fwd max_abs_err={err_f:.3e} (over scale {rel_f:.3e}) "
                    f"bwd max_abs_err={err_b:.3e} (over scale {rel_b:.3e})")
            if k0 in (0, live_k0):
                ms_f = time_ms(torch, lambda: clbs.shared_blend_fwd(
                    pts_g, vol_all, rmat, k0_t, prec), iters)
                ms_b = time_ms(torch, lambda: clbs.shared_blend_bwd(
                    pts_g, vol_all, rmat, k0_t, gout, prec), iters)
                line += f" fwd ms={ms_f:.4f} bwd ms={ms_b:.4f}"
                if k0 == 0:
                    pf = time_ms(torch, lambda: clbs.shared_blend_plain(
                        pts_g, vol_all, rmat, prec), 1)
                    pb = time_ms(torch, lambda: clbs.shared_blend_bwd_plain(
                        pts_g, vol_all, rmat, k0, gout, prec), 1)
                    vol_b = vol_all.numel() * (2 if prec == "bf16" else 4)
                    bf = bound(nbytes(pts_g, rmat, got) + vol_b,
                               f32_ops=OPS_B5F_BONE * B * n)
                    bb = bound(nbytes(pts_g, rmat, gout, *got_b) + vol_b,
                               f32_ops=OPS_B5B_BONE * B * n)
                    line += (f" fwd plain_ms={pf:.4f} bwd plain_ms={pb:.4f} "
                             f"fwd bound_ms={bf[0]:.5f} ({bf[1]}) bwd "
                             f"bound_ms={bb[0]:.5f} ({bb[1]})")
                    results[("blend_fwd", prec)] = dict(
                        err=err_f, rel=rel_f, ms=ms_f, plain_ms=pf,
                        bound_ms=bf[0], bound_by=bf[1])
                    results[("blend_bwd", prec)] = dict(
                        err=err_b, rel=rel_b, ms=ms_b, plain_ms=pb,
                        bound_ms=bb[0], bound_by=bb[1])
                    if prec == "bf16":
                        lib_err, lf, lb = time_library_blend(
                            torch, pts_g, vol_all, rmat, gout, iters)
                        results[("blend_fwd", prec)]["library_ms"] = lf
                        results[("blend_bwd", prec)]["library_ms"] = lb
                        line += (f" library (grid_sample f32 + blend, max "
                                 f"err vs plain f32 {lib_err:.3e}) fwd ms="
                                 f"{lf:.4f} bwd ms={lb:.4f}")
            print(line, flush=True)
            del got, got_b, ref_b


def library_blend(torch, pts_g, vol_all, rmat):
    """B5's function on PyTorch calls (its library yardstick): the all-bone
    weights by grid_sample as in `library_weights`, then A = w rmat and the
    K-set blend of the grid point. Returns (fn(pts_g, vol5, rmat) ->
    [N, 3K + 1], vol5)."""
    _, _, vol5 = library_weights(torch, pts_g, vol_all)
    G = vol5.shape[-1]
    K = rmat.shape[1] // 12

    def fn(p, v, rm):
        grid = (p / (G - 1) * 2.0 - 1.0)[None, None, None]
        w = torch.nn.functional.grid_sample(
            v, grid, mode="bilinear", padding_mode="zeros",
            align_corners=True)[0, :, 0, 0].T
        A = (w @ rm).reshape(-1, K, 3, 4)
        acc = (A[..., :3] * p[:, None, None, :]).sum(-1) + A[..., 3]
        return torch.cat([acc.reshape(-1, 3 * K), w.sum(1, keepdim=True)],
                         1)

    return fn, vol5


def time_library_blend(torch, pts_g, vol_all, rmat, gout, iters):
    """The library route of B5 held to the f32 plain version, then timed
    forward and through its autograd backward on gout: (max error, fwd ms,
    bwd ms)."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    fn, vol5 = library_blend(torch, pts_g, vol_all, rmat)
    err, _ = close(torch, fn(pts_g, vol5, rmat), clbs.shared_blend_plain(
        pts_g, vol_all, rmat, "highest"), TOL_BWD["blend_fwd"],
        "grid_sample + blend vs B5 plain f32")
    fwd = time_ms(torch, lambda: fn(pts_g, vol5, rmat), iters)
    with torch.enable_grad():
        leaves = [t.detach().clone().requires_grad_()
                  for t in (pts_g, vol5, rmat)]
        y = fn(*leaves)
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            y, leaves, gout, retain_graph=True), iters)
    return err, fwd, bwd


def capture_blend_bwd(torch, one_step, results, iters):
    """One more training step with B5's backward inputs captured (the
    autograd backward's call of `ops/cuda/lbs.py::_blend_bwd`), then that
    backward timed on the step's own gradient and on a random gradient of
    the same shape at the same k0."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    orig, seen = clbs._blend_bwd, []

    def record(*args):
        seen.append(args)
        return orig(*args)

    clbs._blend_bwd = record
    try:
        one_step()
    finally:
        clbs._blend_bwd = orig
    torch.cuda.synchronize()
    check(len(seen) == 1, f"train step: {len(seen)} B5 backward calls "
          "captured, expected 1")
    pts_g, img, rmat, k0_t, gout, B, G, K, prec = seen[0]
    n = pts_g.shape[0]
    first = clbs.first_live_row(int(k0_t), n, clbs.TILE_SH)
    zero = int((gout[first:] == 0).all(1).sum())
    rnd = torch.randn(gout.shape, device=gout.device,
                      generator=torch.Generator(gout.device).manual_seed(7))
    ms_step = time_ms(torch, lambda: orig(*seen[0]), iters)
    ms_rnd = time_ms(torch, lambda: orig(pts_g, img, rmat, k0_t, rnd, B, G,
                                         K, prec), iters)
    print(f"kernel shared_blend_bwd on one training step's inputs ({prec}): "
          f"n={n} k0={int(k0_t)} rows={n - first} zero gradient rows={zero}"
          f" ms={ms_step:.4f}; random gradient at the same k0 ms="
          f"{ms_rnd:.4f}", flush=True)
    results[("blend_bwd", "bf16")].update(
        step_grad_ms=ms_step, step_random_grad_ms=ms_rnd,
        step_rows=n - first)


def check_mlp_bwd(torch, model, ti, results, iters):
    """B3 vs its plain version for both trunk specs at the training shapes
    (the canonical trunk on the non-rigid output, as in the step), both
    precisions, k0 = 0 / live / all-dead: dx and stream-daux rows below
    the clamped k0 * 1024 exactly 0. The library route, autograd through
    the module MLPs on cuBLAS bf16, is timed beside the bf16 kernel."""
    from hosnerf_tpu_torch.models import embedders
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    n = ti["n_pad"]
    dev = ti["pts_s"].device
    live_k0 = max(1, int(ti["dom"].k0_for(cmlp.MLP_TILE)))
    n_blocks = -(-n // cmlp.MLP_TILE)
    xs = {"nonrigid": ti["x_skel_s"], "canonical": ti["cnl_pts_s"]}
    for name, (kw, aux, alpha, layers, out) in ti["specs"].items():
        x = xs[name]
        espec = cmlp.EmbedSpec(kw["kind"], kw["multires"], aux.shape[-1],
                               kw["aux_mode"], kw["aux_first"])
        gout = torch.randn(n, out[0].shape[0], device=dev,
                           generator=torch.Generator(dev).manual_seed(7))
        stream = kw["aux_mode"] == "stream"
        for prec in ("bf16", "highest"):
            tols = TOL_BWD[f"mlp_{prec}"]
            for k0 in (0, live_k0, 10 ** 6):
                first = min(k0, n_blocks - 1) * cmlp.MLP_TILE
                k0_t = torch.tensor([k0], dtype=torch.int32, device=dev)
                ref = cmlp.fused_embed_trunk_bwd_plain(
                    x, aux, alpha, layers, out, gout, espec=espec,
                    skip_before=kw["skip_before"],
                    skip_source=kw["skip_source"], precision=prec,
                    k0_blocks=k0)
                ranges = poison(torch, dev, *([ref[0].numel() * 4]
                                              + [ref[1].numel() * 4] * stream))
                got = cmlp.fused_embed_trunk_bwd(
                    x, aux, alpha, layers, out, gout, precision=prec,
                    k0_blocks=k0_t, **kw)
                torch.cuda.synchronize()
                check(landed(got[0], ranges), f"trunk bwd {name} {prec} "
                      f"k0={k0}: dx missed the poison")
                check(not stream or landed(got[1], ranges),
                      f"trunk bwd {name} {prec} k0={k0}: daux missed the "
                      "poison")
                flat_g = [got[0], got[1]] + [t for p in got[2] for t in p] \
                    + list(got[3])
                flat_r = [ref[0], ref[1]] + [t for p in ref[2] for t in p] \
                    + list(ref[3])
                err, rel = worst(
                    close(torch, a, b, tols,
                          f"trunk bwd {name} {prec} k0={k0} out {i}")
                    for i, (a, b) in enumerate(zip(flat_g, flat_r)))
                check(first == 0 or float(got[0][:first].abs().max()) == 0,
                      f"trunk bwd {name} {prec} k0={k0}: dx rows below k0")
                check(not (stream and first)
                      or float(got[1][:first].abs().max()) == 0.0,
                      f"trunk bwd {name} {prec} k0={k0}: daux rows below k0")
                del ref
                line = (f"kernel fused_embed_trunk_bwd {name} {prec} "
                        f"k0={k0} rows={n - first} max_abs_err={err:.3e} "
                        f"max_err_over_scale={rel:.3e}")
                if k0 in (0, live_k0):
                    ms = time_ms(torch, lambda: cmlp.fused_embed_trunk_bwd(
                        x, aux, alpha, layers, out, gout, precision=prec,
                        k0_blocks=k0_t, **kw), iters)
                    line += f" ms={ms:.4f}"
                if k0 == 0:
                    plain_ms = time_ms(
                        torch, lambda: cmlp.fused_embed_trunk_bwd_plain(
                            x, aux, alpha, layers, out, gout, espec=espec,
                            skip_before=kw["skip_before"],
                            skip_source=kw["skip_source"], precision=prec,
                            k0_blocks=0), 1)
                    line += f" plain_ms={plain_ms:.4f}"
                    res = dict(err=err, rel=rel, ms=ms, plain_ms=plain_ms)
                    # recompute + input gradients + dW: three trunk passes
                    flops = 3.0 * trunk_flops(layers, out, n)
                    params = [t for p in layers for t in p] + list(out)
                    io = nbytes(x, gout, got[0], got[1], *params, *got[3],
                                *[t for p in got[2] for t in p]) + (
                        nbytes(aux) if not stream else aux.shape[-1] * 4)
                    res["bound_ms"], res["bound_by"] = bound(
                        io, **({"bf16_ops": flops} if prec == "bf16"
                               else {"f32_ops": flops}))
                    line += (f" bound_ms={res['bound_ms']:.5f} "
                             f"({res['bound_by']})") + rate(res, flops)
                    if prec == "bf16":
                        res["library_ms"] = library_trunk_bwd_ms(
                            torch, model, name, x, aux, alpha, gout, iters)
                        line += f" library_ms={res['library_ms']:.4f}"
                    results[(name + "_bwd", prec)] = res
                print(line, flush=True)
                del got, flat_g, flat_r
        del gout


B3_LAUNCHES = (("recompute", "embed_trunk_bf16"), ("rows", "rows_bwd_bf16"),
               ("dw", "dw_bf16"))


def b3_launch_split(torch, ti, results, reps=3):
    """B3's three launches timed apart at the training shapes (bf16, k0 =
    0): one C call launches them back to back, so their device times are
    read from torch.profiler (CUPTI kernel records), mean of `reps` calls
    after the timed ones above."""
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    xs = {"nonrigid": ti["x_skel_s"], "canonical": ti["cnl_pts_s"]}
    for name, (kw, aux, alpha, layers, out) in ti["specs"].items():
        x = xs[name]
        gout = torch.randn(x.shape[0], out[0].shape[0], device=x.device,
                           generator=torch.Generator(x.device).manual_seed(7))
        split = device_ms(torch, lambda: cmlp.fused_embed_trunk_bwd(
            x, aux, alpha, layers, out, gout, k0_blocks=0, **kw),
            [(part, (kernel,)) for part, kernel in B3_LAUNCHES], reps)
        check(all(v > 0 for v in split.values()),
              f"trunk bwd {name}: the profiler saw no B3 launch ({split})")
        res = results[(name + "_bwd", "bf16")]
        res["launch_ms"] = split
        print(f"kernel fused_embed_trunk_bwd {name} bf16 launches: "
              + " ".join(f"{k}_ms={v:.4f}" for k, v in split.items())
              + f" (sum {sum(split.values()):.4f}; events {res['ms']:.4f})",
              flush=True)


def library_trunk_bwd_ms(torch, model, name, x, aux, alpha, gout,
                         iters) -> float:
    """The module path's backward (the model's nn.Module MLPs, cuBLAS bf16
    layers, through autograd: what mlp_impl='flax' trains with), timed
    over torch.autograd.grad alone."""
    from hosnerf_tpu_torch.models import embedders
    with torch.enable_grad():
        xg = x.detach().clone().requires_grad_()
        ag = aux.detach().clone().requires_grad_()
        if name == "nonrigid":
            mod = model.non_rigid_mlp
            y = mod(embedders.hannw_fourier_embed(xg, model.nr_multires,
                                                  alpha), xg, ag)["offsets"]
        else:
            mod = model.cnl_mlp
            y = mod(torch.cat([embedders.fourier_embed(xg,
                                                       model.cnl_multires),
                               ag.expand(xg.shape[0], -1)], -1))
        inputs = [xg, ag] + list(mod.parameters())
        return time_ms(torch, lambda: torch.autograd.grad(
            y, inputs, gout, retain_graph=True), iters)


# ---------------------------------------------------------------------------
# kernels phase: the dense slice (rows 6-12)
# ---------------------------------------------------------------------------

INVERSE_CORES = ("inverse_core", "inverse_core_pg", "inverse_core_pgw",
                 "inverse_core_bp")


def check_inverse_cores(torch, model, ti, results, iters):
    """Rows 6, 9, 10, 11: B1 and B4 on the training step's points in each
    core's row order (as given; Morton; signature + Morton; signature).
    Forward: bit-identical across the orders (one per-sample computation)
    and within TOL_LBS of the plain version; backward within B4's
    tolerances of the plain backward; outputs NaN-poisoned. Each core is
    timed whole (sort, B1, unsort) and its kernels alone on its order
    (k0 = 0, as the dense path runs them), beside the library route."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    rg, tg, vol_qz = ti["rg"], ti["tg"], ti["vol_qz"]
    pts = ti["si"]["pts_flat"].float().contiguous()
    G = model.mweight_volume_size
    n, dev = pts.shape[0], pts.device
    pts_p = clbs._pad_points(pts)
    n_pad = pts_p.shape[0]
    gacc = torch.randn(n_pad, 4, device=dev,
                       generator=torch.Generator(dev).manual_seed(12))
    pairs = live_pairs(pts, rg, tg, G)
    orders = {"inverse_core": None, "inverse_core_pg": clbs._morton_order,
              "inverse_core_pgw": clbs._sig_morton_order,
              "inverse_core_bp": clbs._support_order}
    for prec in ("bf16", "highest"):
        ref = clbs.inverse_core_plain(pts_p, rg, tg, vol_qz, prec)
        dref = clbs.inverse_core_bwd_plain(pts_p, rg, tg, vol_qz, gacc, prec)
        plain_f = time_ms(torch, lambda: clbs.inverse_core_plain(
            pts_p, rg, tg, vol_qz, prec), 1)
        plain_b = time_ms(torch, lambda: clbs.inverse_core_bwd_plain(
            pts_p, rg, tg, vol_qz, gacc, prec), 1)
        scale = float(ref.abs().max())
        vol_b = vol_qz.numel() * (2 if prec == "bf16" else 4)
        ray_order = None
        for name, order in orders.items():
            entry = getattr(clbs, name)
            perm = (torch.arange(n_pad, device=dev) if order is None else
                    clbs._row_perms(order(pts_p, rg, tg, G, n))[0])
            x, g = pts_p[perm].contiguous(), gacc[perm].contiguous()
            ranges = poison(torch, dev, n_pad * 16)
            got = clbs.inverse_core_fwd(x, rg, tg, vol_qz, prec, entry)
            torch.cuda.synchronize()
            check(landed(got, ranges), f"{name} {prec}: output missed the "
                  "poison")
            check(bool(torch.isfinite(got).all()),
                  f"{name} {prec}: non-finite output (unwritten rows?)")
            err = float((got - ref[perm]).abs().max())
            check(err <= TOL_LBS * scale, f"{name} {prec}: max err {err} > "
                  f"{TOL_LBS} x {scale}")
            if ray_order is None:
                ray_order = got
            check(bool(torch.equal(got, ray_order[perm])),
                  f"{name} {prec}: differs from the ray-order result")
            ranges = poison(torch, dev, n_pad * 12)
            dgot = clbs.inverse_core_bwd(x, rg, tg, vol_qz, g, prec)
            torch.cuda.synchronize()
            check(landed(dgot[0], ranges), f"{name} bwd {prec}: dpts missed "
                  "the poison")
            err_b, rel_b = worst(close(torch, a, b, TOL_BWD[f"lbs_{prec}"],
                                       f"{name} bwd {prec} {what}")
                                 for what, a, b in zip(
                                     ("dpts", "drg", "dtg", "dvol"), dgot,
                                     (dref[0][perm],) + tuple(dref[1:])))
            ms_f = time_ms(torch, lambda: clbs.inverse_core_fwd(
                x, rg, tg, vol_qz, prec, entry), iters)
            ms_b = time_ms(torch, lambda: clbs.inverse_core_bwd(
                x, rg, tg, vol_qz, g, prec), iters)
            ms_entry = time_ms(torch, lambda: entry(pts, rg, tg, vol_qz,
                                                    prec), iters)
            bf = bound(nbytes(x, rg, tg, got) + vol_b,
                       f32_ops=OPS_B1_PAIR * pairs)
            bb = bound(nbytes(x, rg, tg, g, *dgot) + vol_b,
                       f32_ops=OPS_B4_PAIR * pairs)
            print(f"kernel {name} {prec}: rows={n_pad} live_pairs={pairs} "
                  f"fwd max_abs_err={err:.3e} (over scale "
                  f"{err / scale:.3e}) bwd max_abs_err={err_b:.3e} (over "
                  f"scale {rel_b:.3e}) B1 ms={ms_f:.4f} B4 ms={ms_b:.4f} "
                  f"core (sort + B1 + unsort) ms={ms_entry:.4f} plain fwd "
                  f"ms={plain_f:.4f} bwd ms={plain_b:.4f} bound fwd "
                  f"{bf[0]:.5f} ({bf[1]}) bwd {bb[0]:.5f} ({bb[1]})",
                  flush=True)
            results[(name, prec)] = dict(err=err, rel=err / scale, ms=ms_f,
                                         plain_ms=plain_f, bound_ms=bf[0],
                                         bound_by=bf[1], core_ms=ms_entry)
            results[(name + "_bwd", prec)] = dict(
                err=err_b, rel=rel_b, ms=ms_b, plain_ms=plain_b,
                bound_ms=bb[0], bound_by=bb[1])
            del got, dgot, x, g
        del ref, dref, ray_order
    # the library route computes the same function in any row order
    lib_f, lib_b = time_library_inverse(torch, pts_p, rg, tg, vol_qz, gacc,
                                        iters)
    for name in orders:
        results[(name, "bf16")]["library_ms"] = lib_f
        results[(name + "_bwd", "bf16")]["library_ms"] = lib_b
    print(f"inverse cores: library route fwd ms={lib_f:.4f} bwd "
          f"ms={lib_b:.4f}", flush=True)


def library_inverse(torch, vol_qz):
    """The inverse LBS on PyTorch calls (the library yardstick of rows 1,
    4, 6 and 9-11): the bone affines as one bmm, grid_sample over the
    volume as a batch of B one-channel f32 volumes ([B, 1, G, G, G] with
    vol[b, x, y, z], so the grid's coordinates are (z, y, x), mapped to
    [-1, 1] with align_corners=True, zeros padding), then the blend.
    Returns (fn(pts, rg, tg, vol5) -> acc [n, 4], vol5); its autograd
    backward is B4's library route."""
    B, _, G = vol_qz.shape
    vol5 = vol_qz.float().reshape(B, 1, G, G, G).contiguous()

    def fn(pts, rg, tg, v=vol5):
        f = torch.baddbmm(tg[:, :, None], rg.reshape(B, 3, 3),
                          pts.T.expand(B, 3, -1))            # [B, 3, n]
        grid = (f.flip(1) / (G - 1) * 2.0 - 1.0).transpose(1, 2)
        w = torch.nn.functional.grid_sample(
            v, grid[:, None, None], mode="bilinear", padding_mode="zeros",
            align_corners=True)[:, 0, 0, 0]                   # [B, n]
        return torch.cat([(w[:, None] * f).sum(0).T, w.sum(0)[:, None]], 1)

    return fn, vol5


def library_weights(torch, pts_g, vol_all):
    """The all-bone weights as one PyTorch call (the library yardstick of
    row 7): grid_sample of the f32 [1, B, G, G, G] volume (vol[b, z, y, x])
    at the [1, 1, 1, N, 3] points (x, y, z) mapped to [-1, 1] with
    align_corners=True, zeros padding. Returns (fn(grid) -> w [N, B],
    grid)."""
    QQ, BG = vol_all.shape
    G = int(round(QQ ** 0.5))
    B = BG // G
    vol5 = vol_all.float().reshape(G, G, B, G).permute(2, 3, 0, 1)[None]
    grid = (pts_g / (G - 1) * 2.0 - 1.0)[None, None, None]

    def fn(gr, v=vol5):
        return torch.nn.functional.grid_sample(
            v, gr, mode="bilinear", padding_mode="zeros",
            align_corners=True)[0, :, 0, 0].T

    return fn, grid.contiguous(), vol5.contiguous()


def check_shared_core(torch, ti, results, iters):
    """Row 7 forward and backward vs their plain versions on the training
    step's canonical points (grid coordinates) and its decoded volume, both
    precisions, outputs NaN-poisoned; the library call (grid_sample) held
    to the f32 plain version before its time is quoted."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    pts_g, vol_all = ti["pts_g"], ti["vol_all"]
    n, dev = pts_g.shape[0], pts_g.device
    B = vol_all.shape[1] // int(round(vol_all.shape[0] ** 0.5))
    gw = torch.randn(n, B, device=dev,
                     generator=torch.Generator(dev).manual_seed(13))
    for prec in ("bf16", "highest"):
        ref = clbs.shared_core_plain(pts_g, vol_all, prec)
        ranges = poison(torch, dev, ref.numel() * 4)
        got = clbs.shared_core_fwd(pts_g, vol_all, prec)
        torch.cuda.synchronize()
        check(landed(got, ranges), f"weights {prec}: output missed the "
              "poison")
        err_f, rel_f = close(torch, got, ref, TOL_BWD["blend_fwd"],
                             f"weights {prec}")
        del ref
        dref = clbs.shared_core_bwd_plain(pts_g, vol_all, gw, prec)
        ranges = poison(torch, dev, n * 12)
        dgot = clbs.shared_core_bwd(pts_g, vol_all, gw, prec)
        torch.cuda.synchronize()
        check(landed(dgot[0], ranges), f"weights bwd {prec}: dpts missed "
              "the poison")
        err_b, rel_b = worst(close(torch, a, b, TOL_BWD[f"lbs_{prec}"],
                                   f"weights bwd {prec} {what}")
                             for what, a, b in zip(("dpts", "dvol"), dgot,
                                                   dref))
        ms_f = time_ms(torch, lambda: clbs.shared_core_fwd(
            pts_g, vol_all, prec), iters)
        ms_b = time_ms(torch, lambda: clbs.shared_core_bwd(
            pts_g, vol_all, gw, prec), iters)
        pf = time_ms(torch, lambda: clbs.shared_core_plain(
            pts_g, vol_all, prec), 1)
        pb = time_ms(torch, lambda: clbs.shared_core_bwd_plain(
            pts_g, vol_all, gw, prec), 1)
        vol_b = vol_all.numel() * (2 if prec == "bf16" else 4)
        bf = bound(nbytes(pts_g, got) + vol_b,
                   f32_ops=(OPS_W_SAMPLE + OPS_W_FWD * B) * n)
        bb = bound(nbytes(pts_g, gw, *dgot) + vol_b,
                   f32_ops=(OPS_W_SAMPLE + OPS_W_SAMPLE_BWD
                            + (OPS_W_FWD + OPS_W_BWD) * B) * n)
        res_f = dict(err=err_f, rel=rel_f, ms=ms_f, plain_ms=pf,
                     bound_ms=bf[0], bound_by=bf[1])
        res_b = dict(err=err_b, rel=rel_b, ms=ms_b, plain_ms=pb,
                     bound_ms=bb[0], bound_by=bb[1])
        line = (f"kernel shared_core {prec}: n={n} fwd max_abs_err="
                f"{err_f:.3e} (over scale {rel_f:.3e}) bwd max_abs_err="
                f"{err_b:.3e} (over scale {rel_b:.3e}) fwd ms={ms_f:.4f} "
                f"bwd ms={ms_b:.4f} fwd plain_ms={pf:.4f} bwd plain_ms="
                f"{pb:.4f} fwd bound_ms={bf[0]:.5f} ({bf[1]}) bwd bound_ms="
                f"{bb[0]:.5f} ({bb[1]})")
        if prec == "bf16":
            lib_fn, grid, vol5 = library_weights(torch, pts_g, vol_all)
            lib_err, _ = close(torch, lib_fn(grid), clbs.shared_core_plain(
                pts_g, vol_all, "highest"), TOL_BWD["blend_fwd"],
                "grid_sample vs row 7 plain f32")
            res_f["library_ms"] = time_ms(torch, lambda: lib_fn(grid), iters)
            with torch.enable_grad():
                gr = grid.detach().clone().requires_grad_()
                vr = vol5.detach().clone().requires_grad_()
                y = lib_fn(gr, vr)
                res_b["library_ms"] = time_ms(torch, lambda: torch.autograd
                                              .grad(y, (gr, vr), gw,
                                                    retain_graph=True),
                                              iters)
            line += (f" library (grid_sample f32, max err vs plain f32 "
                     f"{lib_err:.3e}) fwd ms={res_f['library_ms']:.4f} bwd "
                     f"ms={res_b['library_ms']:.4f}")
            del lib_fn, grid, vol5, y, gr, vr
        print(line, flush=True)
        results[("weights_fwd", prec)] = res_f
        results[("weights_bwd", prec)] = res_b
        del got, dgot, dref


# tools/bench_mlp.py's two production layouts: (din, width, depth, skip
# keywords, dout)
TRUNK_LAYOUTS = {
    "canonical": (127, 256, 8, dict(skip_before=5, skip_order="input_first",
                                    skip_off=0, skip_width=127), 4),
    "nonrigid": (111, 128, 6, dict(skip_before=4, skip_order="h_first",
                                   skip_off=75, skip_width=36), 3),
}
BENCH_ROWS = 262_144


def trunk_weights(torch, name, device, seed=0):
    """Random bench_mlp-style weights ([dout, din], N(0, 1/din)) for a
    layout, and x ~ N(0, 1) [BENCH_ROWS, din]."""
    din, width, depth, kw, dout = TRUNK_LAYOUTS[name]
    gen = torch.Generator(device).manual_seed(seed)
    layers, prev = [], din
    for i in range(depth):
        k = prev + (kw["skip_width"] if i == kw["skip_before"] else 0)
        layers.append((torch.randn(width, k, device=device, generator=gen)
                       / k ** 0.5,
                       torch.randn(width, device=device, generator=gen)
                       * 0.01))
        prev = width
    out = (torch.randn(dout, width, device=device, generator=gen) * 0.05,
           torch.zeros(dout, device=device))
    x = torch.randn(BENCH_ROWS, din, device=device, generator=gen)
    return x, layers, out, kw


def check_trunk(torch, model, results, iters):
    """Row 8 forward and backward vs their plain versions at
    tools/bench_mlp.py's two layouts and 262,144 rows (bf16; f32 too for
    the canonical one), outputs NaN-poisoned, tolerances of B2 and B3; the
    library route (the model's module MLP of the same layout, cuBLAS
    bf16, and its autograd backward) timed beside bf16."""
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    dev = next(model.parameters()).device
    for name in TRUNK_LAYOUTS:
        x, layers, out, kw = trunk_weights(torch, name, dev)
        spec = cmlp.TrunkSpec(x.shape[1], **kw)
        gout = torch.randn(BENCH_ROWS, out[0].shape[0], device=dev,
                           generator=torch.Generator(dev).manual_seed(14))
        params = [t for p in layers for t in p] + list(out)
        flops = trunk_flops(layers, out, BENCH_ROWS)
        for prec in ("bf16", "highest") if name == "canonical" else ("bf16",):
            ref = cmlp.fused_trunk_plain(x, layers, out, spec=spec,
                                         precision=prec)
            ranges = poison(torch, dev, ref.numel() * 4)
            got = cmlp.trunk_fwd(x, layers, out, spec=spec, precision=prec)
            torch.cuda.synchronize()
            check(landed(got, ranges), f"trunk {name} {prec}: output missed "
                  "the poison")
            check(bool(torch.isfinite(got).all()),
                  f"trunk {name} {prec}: non-finite output")
            scale = float(ref.abs().max())
            e = (got - ref).abs()
            err_f = float(e.max())
            frac = float((e > 1e-3 * scale).float().mean())
            check(err_f <= TOL_MLP[prec] * scale and frac <= 0.05,
                  f"trunk {name} {prec}: max err {err_f} (scale {scale}), "
                  f"{frac:.4f} of entries beyond 1e-3")
            del e
            dref = cmlp.fused_trunk_bwd_plain(x, layers, out, gout,
                                              spec=spec, precision=prec)
            ranges = poison(torch, dev, x.numel() * 4)
            dgot = cmlp.trunk_bwd(x, layers, out, gout, spec=spec,
                                  precision=prec)
            torch.cuda.synchronize()
            check(landed(dgot[0], ranges), f"trunk bwd {name} {prec}: dx "
                  "missed the poison")
            flat_g = [dgot[0]] + [t for p in dgot[1] for t in p] \
                + list(dgot[2])
            flat_r = [dref[0]] + [t for p in dref[1] for t in p] \
                + list(dref[2])
            err_b, rel_b = worst(close(torch, a, b, TOL_BWD[f"mlp_{prec}"],
                                       f"trunk bwd {name} {prec} out {i}")
                                 for i, (a, b) in enumerate(zip(flat_g,
                                                                flat_r)))
            ms_f = time_ms(torch, lambda: cmlp.trunk_fwd(
                x, layers, out, spec=spec, precision=prec), iters)
            ms_b = time_ms(torch, lambda: cmlp.trunk_bwd(
                x, layers, out, gout, spec=spec, precision=prec), iters)
            pf = time_ms(torch, lambda: cmlp.fused_trunk_plain(
                x, layers, out, spec=spec, precision=prec), 2)
            pb = time_ms(torch, lambda: cmlp.fused_trunk_bwd_plain(
                x, layers, out, gout, spec=spec, precision=prec), 1)
            ops = {"bf16_ops" if prec == "bf16" else "f32_ops": flops}
            bf = bound(nbytes(x, got, *params), **ops)
            bb = bound(nbytes(x, gout, *flat_g, *params),
                       **{k: 3 * v for k, v in ops.items()})
            res_f = dict(err=err_f, rel=err_f / scale, ms=ms_f, plain_ms=pf,
                         bound_ms=bf[0], bound_by=bf[1])
            res_b = dict(err=err_b, rel=rel_b, ms=ms_b, plain_ms=pb,
                         bound_ms=bb[0], bound_by=bb[1])
            rates = (" fwd" + rate(res_f, flops) + " bwd"
                     + rate(res_b, 3 * flops))
            line = (f"kernel fused_trunk {name} {prec}: rows={BENCH_ROWS} "
                    f"fwd max_abs_err={err_f:.3e} (over scale "
                    f"{err_f / scale:.3e}, beyond_1e-3={frac:.4f}) bwd "
                    f"max_abs_err={err_b:.3e} (over scale {rel_b:.3e}) fwd "
                    f"ms={ms_f:.4f} bwd ms={ms_b:.4f} fwd plain_ms={pf:.4f} "
                    f"bwd plain_ms={pb:.4f} fwd bound_ms={bf[0]:.5f} "
                    f"({bf[1]}) bwd bound_ms={bb[0]:.5f} ({bb[1]})" + rates)
            if prec == "bf16":
                res_f["library_ms"], res_b["library_ms"] = \
                    library_trunk_ms(torch, model, name, x, gout, iters)
                line += (f" library fwd ms={res_f['library_ms']:.4f} bwd "
                         f"ms={res_b['library_ms']:.4f}")
            print(line, flush=True)
            results[("trunk_" + name, prec)] = res_f
            results[("trunk_" + name + "_bwd", prec)] = res_b
            del got, dgot, ref, dref, flat_g, flat_r
        del x, gout, layers, out, params


def library_trunk_ms(torch, model, name, x, gout, iters):
    """(forward ms, backward ms) of the model's module MLP with the same
    layout as a trunk-only MLP (CanonicalMLP on [N, 127]; NonRigidMLP on
    [cond 75 | embed 36], which it concatenates itself): cuBLAS bf16
    layers, the backward through torch.autograd.grad."""
    def run(xx):
        if name == "canonical":
            return model.cnl_mlp(xx)
        return model.non_rigid_mlp(xx[:, 75:], xx[:, :3],
                                   xx[:, :75])["offsets"]

    with torch.no_grad():
        fwd = time_ms(torch, lambda: run(x), iters)
    mod = model.cnl_mlp if name == "canonical" else model.non_rigid_mlp
    with torch.enable_grad():
        xg = x.detach().clone().requires_grad_()
        y = run(xg)
        inputs = [xg] + list(mod.parameters())
        bwd = time_ms(torch, lambda: torch.autograd.grad(
            y, inputs, gout, retain_graph=True), iters)
    return fwd, bwd


def check_proto(torch, device, results, iters):
    """Row 12 at the prototype's shapes, full length and cut to 2 steps
    (the count a device tensor): against its plain version and the JAX
    script's numpy reference (out 1e-5 of the scale, dvol exactly), rows
    of tiles no counted step visits still NaN (unwritten)."""
    from hosnerf_tpu_torch.tools import proto_pairgrid as pp
    pts, vol, ptile, pbone = pp.case()
    args = [torch.from_numpy(a).to(device) for a in (ptile, pbone, pts,
                                                      vol)]
    rows_all = pp.N_TILES * pp.T
    for n_pairs, tiles in ((7, pp.N_TILES), (2, 1)):
        count = torch.tensor([n_pairs], dtype=torch.int32, device=device)
        plain, plain_dvol = pp.run_plain(n_pairs, *args, pp.N_TILES)
        ref, ref_dvol = pp.reference(pts, vol, n_pairs)
        ranges = poison(torch, device, rows_all * pp.G * 4)
        out, dvol = pp.run(count, *args, pp.N_TILES)
        torch.cuda.synchronize()
        check(landed(out, ranges), "proto_pairgrid: output missed the poison")
        rows = tiles * pp.T
        err, rel = close(torch, out[:rows], plain[:rows], (1e-5, 1e-5),
                         f"proto_pairgrid n={n_pairs} vs plain")
        close(torch, out[:rows].cpu(), torch.from_numpy(ref[:rows]),
              (1e-5, 1e-5), f"proto_pairgrid n={n_pairs} vs reference")
        check(bool(torch.isnan(out[rows:]).all()),
              f"proto_pairgrid n={n_pairs}: unvisited tiles were written")
        check(bool(torch.equal(dvol.cpu(), torch.from_numpy(ref_dvol)))
              and bool(torch.equal(dvol, plain_dvol)),
              f"proto_pairgrid n={n_pairs}: dvol")
        if n_pairs == 7:
            ms = time_ms(torch, lambda: pp.run(count, *args, pp.N_TILES),
                         iters)
            pms = time_ms(torch, lambda: pp.run_plain(7, *args, pp.N_TILES),
                          1)
            bms, by = bound(nbytes(*args, out, dvol))
            results[("proto", "f32")] = dict(err=err, rel=rel, ms=ms,
                                             plain_ms=pms, bound_ms=bms,
                                             bound_by=by)
            print(f"kernel proto_pairgrid: n_pairs=7 max_abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} "
                  f"({by}); n_pairs=2 unvisited rows unwritten", flush=True)


def entry_point_runs(torch, ti, batch, device):
    """Rows 7, 8 and 12 through their user entry points, every launch
    count zeroed just before and read just after: the all-bone weights of
    the step's canonical points through `ops/lbs.py::bone_weights`
    (impl='pallas') and their backward; the canonical trunk-only MLP
    through `fused_trunk` and its backward; `tools/proto_pairgrid.py`'s
    main. Returns the counts."""
    from hosnerf_tpu_torch.ops import lbs as lbs_ops
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    from hosnerf_tpu_torch.tools import proto_pairgrid as pp
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    with torch.enable_grad():
        pts = ti["cnl_pts_s"].detach().clone().requires_grad_()
        vol = ti["si"]["vol"].detach().clone().requires_grad_()
        w = lbs_ops.bone_weights(pts, vol, batch["cnl_bbox_min_xyz"],
                                 batch["cnl_bbox_scale_xyz"], impl="pallas")
        w.square().sum().backward()
        check(bool(torch.isfinite(pts.grad).all())
              and bool(torch.isfinite(vol.grad).all()),
              "bone_weights: non-finite gradients")
        x, layers, out, kw = trunk_weights(torch, "canonical", device, 1)
        x.requires_grad_()
        cmlp.fused_trunk(x, layers, out, **kw).square().sum().backward()
        check(bool(torch.isfinite(x.grad).all()),
              "fused_trunk: non-finite gradient")
    pp.main()
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    expect = {"shared_core_fwd": 1, "shared_core_bwd": 1, "fused_trunk": 1,
              "fused_trunk_bwd": 1, "proto_pairgrid": 2}
    print("phase entry points: launches "
          + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    check(launches == {k: expect.get(k, 0) for k in launches},
          f"entry points: launches {launches}, expected {expect}")
    return launches


def check_dense_render(torch, model, batch):
    """One render chunk through the dense path with each inverse core (the
    pair-grid cores 'quad', 'win', 'bp' and 'pallas_dense') against the
    sorted path on the same weights: the inverse LBS is per-sample the
    same computation in any row order, so rgb and alpha are held to the
    render check's tolerances relative to their maxima. Returns each
    core's launches over these chunks."""
    state = torch.zeros((), dtype=torch.int32)
    ref = model(batch, ITER, state)
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    model.sparse = False
    for lbs_impl, pg_impl in (("auto", "quad"), ("auto", "win"),
                              ("auto", "bp"), ("pallas_dense", "quad")):
        model.lbs_impl, model.pg_impl = lbs_impl, pg_impl
        out = model(batch, ITER, state)
        for name in ("alpha", "rgb"):
            got, r = out[name], ref[name]
            if name == "rgb":
                got, r = 1.0 - got, 1.0 - r
            scale = float(r.abs().max())
            diff = (got - r).abs()
            rmax, rmean = float(diff.max()) / scale, float(diff.mean()) / scale
            print(f"dense render chunk ({lbs_impl}, {pg_impl}) vs sorted: "
                  f"{name} max abs diff {float(diff.max()):.3e}, {rmax:.3e} "
                  f"(max) {rmean:.3e} (mean) of its maximum {scale:.4e}",
                  flush=True)
            check(rmax <= TOL_RENDER_MAX and rmean <= TOL_RENDER_MEAN,
                  f"dense render chunk ({lbs_impl}, {pg_impl}) {name} "
                  "disagrees with the sorted path")
    model.sparse, model.lbs_impl, model.pg_impl = True, "auto", "quad"
    launches = {k: wrappers[k].launches for k in INVERSE_CORES}
    check(launches == dict.fromkeys(INVERSE_CORES, 1),
          f"dense render chunks: inverse-core launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# render phase
# ---------------------------------------------------------------------------

def render_frames(torch, model, items, device):
    from hosnerf_tpu_torch.eval import renderers
    render_fn = renderers.make_render_fn(model)
    return [renderers.render_human_image(render_fn, it, device, CHUNK)
            for it in items]


def check_render_chunk(torch, model, batch):
    """One chunk through the sorted kernel path and the dense plain path
    on the card; alpha and 1 - rgb compared relative to their maxima."""
    state = torch.zeros((), dtype=torch.int32)
    out_s = model(batch, ITER, state)
    model.lbs_impl, model.mlp_impl = "gather", "flax"
    out_d = model(batch, ITER, state)
    model.lbs_impl, model.mlp_impl = "auto", "auto"
    amax = float(out_d["alpha"].max())
    check(amax >= MIN_ALPHA, f"render chunk shows no subject: alpha max "
          f"{amax} < {MIN_ALPHA}")
    for name, got, ref in (("alpha", out_s["alpha"], out_d["alpha"]),
                           ("1-rgb", 1.0 - out_s["rgb"], 1.0 - out_d["rgb"])):
        scale = float(ref.abs().max())
        diff = (got - ref).abs()
        rmax, rmean = float(diff.max()) / scale, float(diff.mean()) / scale
        print(f"render chunk vs dense plain path: {name} max {scale:.4e}, "
              f"error max {rmax:.3e} mean {rmean:.3e} of it (tolerance "
              f"{TOL_RENDER_MAX}, {TOL_RENDER_MEAN})", flush=True)
        check(rmax <= TOL_RENDER_MAX and rmean <= TOL_RENDER_MEAN,
              f"render chunk {name} disagrees with the dense plain path")


LBS_PROFILE_PARTS = {
    "shared-tap LBS": (
        ("image", ("build_image_kernel",)),
        ("blend_fwd", ("shared_blend_fwd_kernel",)),
        ("tap_bwd", ("bin_count_kernel", "bin_scan_kernel",
                     "bin_scatter_kernel", "tap_bwd_kernel"))),
    # B1 and B4 (csrc/lbs_inverse.cu); B4's memset is not told apart from
    # the step's others
    "inverse LBS": INV_PARTS[:3],
}


def profile(torch, what: str, fn, ref_ms: float):
    """fn under torch.profiler: device and host time by operator, the
    LBS kernels' device time, and the device's idle share, of
    the profiled wall time and of `ref_ms`, the same work's unprofiled
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.time() - t0) * 1e3
    events = prof.key_averages()
    # device rows only: an operator's row repeats its kernels' time
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation) / 1e3
    for key in ("self_device_time_total", "self_cpu_time_total"):
        print(events.table(sort_by=key, row_limit=14,
                           max_name_column_width=60))
    # the LBS kernels, often below the tables' rows: B5's backward is its
    # binning passes plus tap_bwd_kernel, B4 its kernel and fold
    for group, parts in LBS_PROFILE_PARTS.items():
        lbs_ms = {part: sum(e.self_device_time_total for e in events
                            if e.device_type == DeviceType.CUDA
                            and any(k in e.key for k in kernels)) / 1e3
                  for part, kernels in parts}
        print(f"phase profile: {what}, {group} device ms: "
              + " ".join(f"{part} {ms:.4f}" for part, ms in lbs_ms.items()),
              flush=True)
    print(f"phase profile: {what}, device busy {busy_ms:.2f} ms; idle share "
          f"{1 - busy_ms / wall_ms:.3f} of {wall_ms:.2f} ms profiled wall, "
          f"{1 - busy_ms / ref_ms:.3f} of {ref_ms:.2f} ms unprofiled",
          flush=True)


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def launch_counts():
    """{name: wrapper} of every kernel wrapper; each counts its launches."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    from hosnerf_tpu_torch.tools import proto_pairgrid as pp
    return {"inverse_core_pg_s": clbs.inverse_core_pg_s,
            "fused_embed_trunk": cmlp.fused_embed_trunk,
            "shared_blend_fwd": clbs.shared_blend_fwd,
            "inverse_core_bwd": clbs.inverse_core_bwd,
            "fused_embed_trunk_bwd": cmlp.fused_embed_trunk_bwd,
            "shared_blend_bwd": clbs.shared_blend_bwd,
            **{name: getattr(clbs, name) for name in INVERSE_CORES},
            "shared_core_fwd": clbs.shared_core_fwd,
            "shared_core_bwd": clbs.shared_core_bwd,
            "fused_trunk": cmlp.fused_trunk,
            "fused_trunk_bwd": cmlp.fused_trunk_bwd,
            "proto_pairgrid": pp.run}


def train_phase(torch, device, kind, lp, cfg=None, steps=TRAIN_STEPS,
                per_step=None, label="train"):
    """The training step through init_state + make_train_step on one fixed
    batch (`cfg`: the full-width bf16 config unless given): warm-up,
    `steps` timed steps with every kernel's launches counted and held to
    `per_step` (PER_STEP unless given; any kernel not named there must not
    launch), the loss checked. Returns (launches, ms/step, a function
    running one more step)."""
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.train import stage2
    cfg = cfg or stage2.Stage2Config(compute_dtype="bf16")
    per_step = PER_STEP if per_step is None else per_step
    model, opt = stage2.init_state(cfg, seed=0, device=device)
    step = stage2.make_train_step(cfg, model, opt, lpips_apply=lp)
    batch = train_batch(torch, device, cfg.n_patches, cfg.patch_size,
                        cfg.mweight_volume_size)
    rays = cfg.n_patches * cfg.patch_size ** 2

    def jitter():
        return torch.Generator(device).manual_seed(11)

    first = step(batch, TRAIN_ITER, jitter())
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v)) for v in first.values()),
          f"train warm-up step: non-finite losses {first}")
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    losses = []
    t0 = time.time()
    for _ in range(steps):
        losses.append(step(batch, TRAIN_ITER, jitter()))
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    ms = dt * 1e3 / steps
    print(f"phase {label}: {steps} steps of {rays} rays x "
          f"{cfg.n_samples} samples, {ms:.2f} ms/step, "
          f"{rays * steps / dt:.0f} rays/s on {kind}; launches "
          + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    for k, n in launches.items():
        per = per_step.get(k, 0)
        check(n == per * steps, f"{label}: {k} launched {n} times in "
              f"{steps} steps (expected {per} per step)")
    for i, ls in enumerate(losses):
        check(all(bool(torch.isfinite(v)) for v in ls.values()),
              f"{label} step {i}: non-finite losses {ls}")
    with torch.no_grad():
        after, _ = stage2.make_loss_fn(cfg, model, lp)(
            batch, TRAIN_ITER, state_index(batch["time"], None), jitter())
    l0, l1 = float(first["loss"]), float(after)
    parts = " ".join(f"{k}={float(v):.6f}" for k, v in first.items())
    timed = " ".join(f"{float(x['loss']):.6f}" for x in losses)
    print(f"{label} losses: first {parts}; per timed step {timed}; after "
          f"{l1:.6f}", flush=True)
    check(l1 < l0, f"{label}: loss did not drop on a fixed batch ({l0} -> "
          f"{l1})")
    return launches, ms, lambda: step(batch, TRAIN_ITER, jitter())


def gradcheck_phase(torch, device, n_patches=2, patch_size=32, dense=False):
    """One step's gradients, the card's kernel path vs the same path (the
    sorted one, or the dense one) on the kernels' plain versions on the
    CPU, held to TOL_GRAD and TOL_GRAD_LOSS."""
    import math

    from hosnerf_tpu_torch.train import gradcheck
    what = "dense" if dense else "sorted"
    print(f"gradcheck ({what} path): kernel path on the card vs plain "
          f"versions on the CPU ({n_patches} patches of {patch_size}x"
          f"{patch_size} rays)", flush=True)
    t0 = time.time()
    res = gradcheck.compare_step_grads(device, n_patches, patch_size,
                                       dense=dense)
    worst_rel, _ = gradcheck.report(res, TOL_GRAD)
    print(f"phase gradcheck ({what}): {time.time() - t0:.1f} s", flush=True)
    check(all(math.isfinite(v) for pair in res["params"].values()
              for v in pair) and all(map(math.isfinite, res["loss"])),
          "gradcheck: non-finite loss or gradients")
    check(not res["missing"],
          f"gradcheck: gradient on one side only: {res['missing']}")
    k_loss, p_loss = res["loss"]
    check(abs(k_loss - p_loss) <= TOL_GRAD_LOSS * abs(p_loss),
          f"gradcheck: loss {k_loss} vs plain {p_loss}")
    check(worst_rel <= TOL_GRAD,
          f"gradcheck: worst rel L2 {worst_rel:.3e} (tol {TOL_GRAD})")


# ---------------------------------------------------------------------------

def kernel_name(mangled: str) -> str:
    """A kernel's innermost name and integer template arguments from its
    mangled name (enough to tell the trunk kernels apart)."""
    import re
    rest, names = re.sub(r"^_ZN?", "", mangled), []
    while rest[:1].isdigit():
        d = re.match(r"\d+", rest).group(0)
        names.append(rest[len(d):len(d) + int(d)])
        rest = rest[len(d) + int(d):]
    args = re.match(r"I((?:L[ib]\d+E)+)E", rest)
    tmpl = ""
    if args:
        tmpl = "<" + ",".join(re.findall(r"L[ib](\d+)E", args.group(1))) + ">"
    return (names[-1] if names else mangled[:60]) + tmpl


def ptxas_report(log: str):
    """One line per kernel from nvcc's -Xptxas -v output: its name with
    template arguments, registers, stack and spills; then each note that
    ptxas serialised wgmma products (C7520) or ignored setmaxnreg, with
    the kernel it names."""
    import re
    lines, name, frame = [], None, ""
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", ln)
        f = re.search(r"function '(\w+)'", ln)
        if m:
            name = kernel_name(m.group(1))
        elif "stack frame" in ln:
            frame = ln.strip()
        elif "Used" in ln and name:
            lines.append(f"{name}: {ln.split(':', 1)[-1].strip()}; {frame}")
        elif "C7520" in ln or "C7508" in ln or "setmaxnreg" in ln:
            lines.append(re.sub(r"function '\w+'", "function "
                                + (kernel_name(f.group(1)) if f else "?"),
                                ln.split(":", 1)[-1].strip()))
    return lines


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import hosnerf_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: not run from a checkout of the repository: {e}",
              file=sys.stderr)
        return 2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run(torch, np)


def run(torch, np) -> int:
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.models.human import HumanObjectField
    from hosnerf_tpu_torch.ops.cuda import _build
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp

    device = torch.device("cuda", 0)
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{kind}", flush=True)

    t0 = time.time()
    reports = _build.build_all()
    print(f"phase build: {time.time() - t0:.1f} s "
          f"({', '.join(reports) or 'cached'})", flush=True)
    for name, log in reports.items():
        for ln in ptxas_report(log):
            print(f"  ptxas {name}: {ln}")

    G = 32
    model = HumanObjectField(mweight_volume_size=G, compute_dtype="bf16",
                             seed=0, device=device).eval()
    items = [frame_item(seed, G) for seed in range(FRAMES)]
    batch = chunk_batch(torch, items[0], device)

    t0 = time.time()
    results = {}
    with torch.no_grad():
        si, dom, x_skel_s = check_lbs(torch, model, batch, results, ITERS)
        check_mlp(torch, model, si, dom, x_skel_s, results, ITERS)
        del si, dom, x_skel_s
        ti = train_kernel_inputs(torch, model, train_batch(torch, device))
        check_inverse_bwd(torch, model, ti, results, ITERS)
        check_blend(torch, ti, results, ITERS)
        check_mlp_bwd(torch, model, ti, results, ITERS)
        b3_launch_split(torch, ti, results)
        check_inverse_cores(torch, model, ti, results, ITERS)
        check_shared_core(torch, ti, results, ITERS)
        check_trunk(torch, model, results, ITERS)
        check_proto(torch, device, results, ITERS)
    torch.cuda.empty_cache()
    entry_launches = entry_point_runs(torch, ti, train_batch(torch, device),
                                      device)
    del ti
    torch.cuda.empty_cache()
    print(f"phase kernels: {time.time() - t0:.1f} s", flush=True)

    # ---- the render path: warm up once, then count and time 3 frames ----
    render_frames(torch, model, items[:1], device)
    torch.cuda.synchronize()
    clbs.inverse_core_pg_s.launches = 0
    cmlp.fused_embed_trunk.launches = 0
    t0 = time.time()
    images = render_frames(torch, model, items, device)
    torch.cuda.synchronize()
    dt = time.time() - t0
    render_launches = {"lbs": clbs.inverse_core_pg_s.launches,
                       "mlp": cmlp.fused_embed_trunk.launches}
    chunks = FRAMES * (-(-RAYS // CHUNK))
    print(f"phase render: {FRAMES} frames of 128x128, {chunks} chunks, "
          f"{dt * 1e3 / FRAMES:.2f} ms/frame, {FRAMES * RAYS / dt:.0f} "
          f"rays/s on {kind}; launches inverse_core_pg_s="
          f"{render_launches['lbs']} fused_embed_trunk="
          f"{render_launches['mlp']}", flush=True)
    check(render_launches["lbs"] == chunks
          and render_launches["mlp"] == 2 * chunks,
          f"kernel launches during the render: {render_launches} for "
          f"{chunks} chunks (expected 1 inverse-LBS and 2 trunk launches "
          "each)")
    for img in images:
        check(img.shape == (128, 128, 3), f"image shape {img.shape}")
        check(bool(np.isfinite(img).all()), "non-finite rgb")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0 + 1e-6,
              f"rgb outside [0, 1]: {img.min()} .. {img.max()}")
    live = []
    with torch.no_grad():
        for it in items:
            for s in range(0, RAYS, CHUNK):
                _, d, *_ = sorted_inputs(torch, model,
                                         chunk_batch(torch, it, device, s))
                live.append(1.0 - int(d.n_dead_groups) * clbs.SORT_GROUP
                            / d.n_pad)
        print(f"render live fraction per chunk: "
              f"{' '.join(f'{v:.4f}' for v in live)}; image mean "
              f"{float(np.mean(images)):.4f}", flush=True)
        check_render_chunk(torch, model, batch)
        render_cores = check_dense_render(torch, model, batch)

    from hosnerf_tpu_torch.eval import renderers
    render_fn = renderers.make_render_fn(model)
    profile(torch, "one 128x128 frame", lambda: renderers.render_human_image(
        render_fn, items[0], device, CHUNK), dt * 1e3 / FRAMES)
    del model, render_fn
    torch.cuda.empty_cache()

    # ---- the training step ----
    lp = lpips.load_weights(lpips.LPIPS(device=device)).requires_grad_(False)
    train_launches, step_ms, one_step = train_phase(torch, device, kind, lp)
    profile(torch, "one training step", one_step, step_ms)
    capture_blend_bwd(torch, one_step, results, ITERS)
    del one_step
    torch.cuda.empty_cache()

    # ---- the dense per-sample path ----
    from hosnerf_tpu_torch.train import stage2
    dense_launches, dense_ms, one_step = train_phase(
        torch, device, kind, lp, stage2.Stage2Config(
            sparse=False, compute_dtype="bf16"), DENSE_STEPS,
        PER_DENSE_STEP, "dense")
    profile(torch, "one dense training step", one_step, dense_ms)
    del one_step
    torch.cuda.empty_cache()
    pd_launches, _, _ = train_phase(
        torch, device, kind, lp, stage2.Stage2Config(
            sparse=False, lbs_impl="pallas_dense", compute_dtype="bf16"), 1,
        PER_PALLAS_DENSE_STEP, "dense pallas_dense")
    torch.cuda.empty_cache()

    gradcheck_phase(torch, device)
    gradcheck_phase(torch, device, dense=True)

    def entry(name, source, replaces, n, parts):
        lib = [results[p].get("library_ms") for p in parts]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": n,
                "max_abs_err": max(results[p]["err"] for p in parts),
                "max_err_over_scale": max(results[p]["rel"] for p in parts),
                "ms": sum(results[p]["ms"] for p in parts),
                "plain_ms": sum(results[p]["plain_ms"] for p in parts),
                "bound_ms": sum(results[p]["bound_ms"] for p in parts),
                "bound_by": max((results[p]["bound_ms"], results[p]["bound_by"])
                                for p in parts)[1],
                "library_ms": None if None in lib else sum(lib),
                **{k: results[parts[0]][k] for k in EXTRA_KEYS
                   if k in results[parts[0]]},
                **rates(parts)}

    def rates(parts):
        """The B2/B3/row 8 entries: TFLOP/s and bound share over the
        parts, and B3's time per launch (recompute, rows, dW)."""
        if any("flops" not in results[p] for p in parts):
            return {}
        ms = sum(results[p]["ms"] for p in parts)
        out = {"tflops": sum(results[p]["flops"] for p in parts) / ms / 1e9,
               "bound_share": sum(results[p]["bound_ms"] for p in parts)
               / ms}
        split = {p[0]: results[p]["launch_ms"] for p in parts
                 if "launch_ms" in results[p]}
        if split:
            out["launch_ms"] = split
        return out

    trunks = [("nonrigid", "bf16"), ("canonical", "bf16")]
    kernels = [
        entry("inverse_core_pg_s", "hosnerf_tpu_torch/csrc/lbs_inverse.cu",
              "hosnerf_tpu/ops/pallas/lbs.py:1013", render_launches["lbs"],
              [("lbs", "bf16")]),
        entry("fused_embed_trunk", "hosnerf_tpu_torch/csrc/embed_trunk.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:560", render_launches["mlp"],
              trunks),
        entry("fused_embed_trunk_bwd",
              "hosnerf_tpu_torch/csrc/embed_trunk_bwd.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:600",
              train_launches["fused_embed_trunk_bwd"],
              [(n + "_bwd", p) for n, p in trunks]),
        entry("inverse_core_bwd", "hosnerf_tpu_torch/csrc/lbs_inverse.cu",
              "hosnerf_tpu/ops/pallas/lbs.py:1130",
              train_launches["inverse_core_bwd"], [("lbs_bwd", "bf16")]),
        entry("shared_blend_fwd", "hosnerf_tpu_torch/csrc/lbs_forward.cu",
              "hosnerf_tpu/ops/pallas/lbs.py:1922",
              train_launches["shared_blend_fwd"], [("blend_fwd", "bf16")]),
        entry("shared_blend_bwd", "hosnerf_tpu_torch/csrc/lbs_forward.cu",
              "hosnerf_tpu/ops/pallas/lbs.py:1966",
              train_launches["shared_blend_bwd"], [("blend_bwd", "bf16")]),
    ]
    # rows 6, 9, 10, 11: B1 + B4 in each core's row order; launches on the
    # dense training step (rows 9 and 6) or the dense render chunks
    core_rows = {"inverse_core": ("hosnerf_tpu/ops/pallas/lbs.py:490",
                                  pd_launches["inverse_core"]),
                 "inverse_core_pg": ("hosnerf_tpu/ops/pallas/lbs.py:1077",
                                     dense_launches["inverse_core_pg"]),
                 "inverse_core_pgw": ("hosnerf_tpu/ops/pallas/lbs.py:1502",
                                      render_cores["inverse_core_pgw"]),
                 "inverse_core_bp": ("hosnerf_tpu/ops/pallas/lbs.py:2487",
                                     render_cores["inverse_core_bp"])}
    kernels += [entry(name, "hosnerf_tpu_torch/csrc/lbs_inverse.cu", where,
                      n, [(name, "bf16"), (name + "_bwd", "bf16")])
                for name, (where, n) in core_rows.items()]
    trunk_parts = [("trunk_canonical", "bf16"), ("trunk_nonrigid", "bf16")]
    kernels += [
        entry("shared_core_fwd", "hosnerf_tpu_torch/csrc/lbs_forward.cu",
              "hosnerf_tpu/ops/pallas/lbs.py:1694",
              entry_launches["shared_core_fwd"], [("weights_fwd", "bf16")]),
        entry("shared_core_bwd", "hosnerf_tpu_torch/csrc/lbs_forward.cu",
              "hosnerf_tpu/ops/pallas/lbs.py:1725",
              entry_launches["shared_core_bwd"], [("weights_bwd", "bf16")]),
        entry("fused_trunk", "hosnerf_tpu_torch/csrc/embed_trunk.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:242",
              entry_launches["fused_trunk"], trunk_parts),
        entry("fused_trunk_bwd", "hosnerf_tpu_torch/csrc/embed_trunk_bwd.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:268",
              entry_launches["fused_trunk_bwd"],
              [(n + "_bwd", p) for n, p in trunk_parts]),
        entry("proto_pairgrid", "hosnerf_tpu_torch/csrc/proto_pairgrid.cu",
              "tools/proto_pairgrid.py:60",
              entry_launches["proto_pairgrid"], [("proto", "f32")]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
