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
            K-set blend), held to the f32 plain version first; B2, B3 and
            row 8 beside the module MLPs (cuBLAS bf16, or f32 with TF32 off
            for the f32 kernels) and their autograd backward; B2, B3 and
            row 8 also report TFLOP/s and their share of the bound (f32:
            of the tensor-core bound and of the FMA one), B2's kernel time
            beside its entry's, and B3's four launches (recompute, rows,
            dW, the slots' sums) are timed apart under torch.profiler, as
            are B5's backward launches (binning, taps, the fixed-point
            finish); the four inverse-LBS
            cores (rows 6, 9, 10, 11: B1/B4 on the training points in each
            core's row order), the all-bone weights (row 7) on the training
            step's canonical points, the trunk-only MLP (row 8) at
            tools/bench_mlp.py's two layouts and 262,144 rows, and the
            pair-grid prototype (row 12) at its own shapes; rows 7, 8 and
            12 then once more through their user entry points
            (`ops/lbs.py::bone_weights`, `ops/cuda/mlp.py::fused_trunk`
            with its backward in both precisions, `tools/proto_pairgrid.py`),
            launches counted around each;
  repro     the same inputs give the same bits (under the card settings
            of `utils/card.py::configure`, set where this script starts,
            as every entry point of the port sets them): each backward
            kernel (B3 non-rigid and canonical, B4,
            B5 with K = 2 and K = 1, row 7; both precisions) called
            REPRO_CALLS times on the training inputs at k0 = 0 and at the
            inputs' live k0, every output equal to the first call's; the
            stage-2 step (sorted and dense), bench.py's stage-3 config and
            the stage-1 step, REPRO_STEPS steps each through
            `train/loop.py::run_training` from one state and loop
            generator, run twice, every parameter, Adam moment and step
            count equal; stages 2 (sorted) and 3 also cut after REPRO_CUT
            steps, checkpointed, restored into models built from another
            seed and run on, equal to the straight run; grad_parity at 8
            patches twice, the same worst value; one composed render
            chunk twice, equal. Each check prints how many tensors differ
            and the largest difference; the phase fails after all of them
            if any differs;
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
  train f32 the same step at Stage2Config's default compute_dtype (None:
            f32 "highest" trunks, B2/B3 on their bf16x3 kernels): one
            warm-up and F32_STEPS timed steps, launches and loss checked,
            then one step under torch.profiler (device busy time and the
            trunk kernels' share of it);
  dense     the same training step on the dense per-sample path
            (`sparse=False`: the quad inverse core in its default 'sig'
            order, row 1 over bp_prepare's sorted domain, as the JAX
            package's default; the trunks and the forward LBS on every
            sample): one warm-up and DENSE_STEPS timed steps, launches read
            around them; the same with pg_sort='morton' (row 9, the JAX
            package's legacy order); one step with lbs_impl='pallas_dense'
            (the ray-order core); one render chunk through the dense path
            with each inverse core (the quad core in both orders) against
            the sorted path on the same weights;
  profile   one dense training step under torch.profiler;
  stage3    the stage-3 composed training step (`train/stage3.py`:
            init_state + make_train_step, the scene's proposal sampler and
            8 x 1024 NeRF MLP beside the human field on its sorted kernel
            path, LPIPS with the random backbone) at bench.py's production
            config, Stage3Config(n_patches=2, compute_dtype="bf16"), on
            composed_batch(2, 32) at iter 60,000, one jitter seed (not
            bench.py's cell, which has no LPIPS term, runs at iteration
            100 + i and draws per step: phase bench): one warm-up step, then
            STAGE3_STEPS timed steps with the kernels' launches counted
            around them (B1-B5 as in the stage-2 step), the loss finite and
            falling, the peak device memory (reset before the warm-up), and
            the scene's forward and backward timed alone for its share;
  profile   one more stage-3 step under torch.profiler, device time by
            group (kernel records by name);
  render stage3  2 composed 128 x 128 frames through render_human_image +
            make_composed_render_fn (B1/B2 launches counted), rgb checked,
            one frame profiled by group, one chunk held against the dense
            plain path of the human field;
  data      the host pipeline: a 16-frame 512 x 512 mini capture written by
            the port's `write_mini_dataset` (PNG by `data/imgproc.py`) into
            a temporary directory, its PNGs then re-encoded with Average
            and Paeth rows as an adaptive encoder writes photographs (the
            decode must give the same pixels), loaded by
            `scene_loader.load_nerf_360_v2` (which writes
            cameras_scaleworld.pkl) and by `HumanDataset` (train mode, and
            with scaled-world background rays); the ms per PNG decode in
            both encodings, the scene load's seconds, the ms per 4,096-ray
            `ScenePipeline.sample_train_batch` with the image's rays built
            (as in a capture with more train images than the 8-image ray
            cache) and from the cache, per HumanDataset train item and per
            `to_device`, with shape and finiteness checks;
  stage1    the stage-1 trainer (`train/stage1.py`: init_state +
            make_train_step, clipped Adam on warmup_log_lerp) configured
            as the JAX CLI configures it from configs/Backpack.gin, read by
            the port's ginlite (from the file: 4,096 rays, single_image
            sampler, grad_max_norm 0.001, near, far; the CLI's defaults,
            which the file does not set: NeRF MLP 8x1024, proposal MLPs
            256, 64/64/32 samples; two states from the capture's
            transition), bf16 trunks as in the stage-3 cell: one warm-up
            and STAGE1_STEPS timed steps, each on a fresh pipeline batch
            with its image's rays built, moved by to_device (ms/step and
            rays/s with and without the batches' host time, peak device
            memory), every loss finite, a fixed batch's loss lower after
            the steps than before, one
            profiled step (device busy ms, idle share, device time by
            group; the batch's host work inside it), and make_eval_step
            on one 4,096-ray eval chunk (rgb finite, within the colour
            padding of [0, 1]);
  stage2 data  the stage-2 step configured as the JAX CLI configures it
            from configs/default.yaml, read by the port's yamlcfg (from the
            file: 2 patches of 32, 128 samples; the CLI's defaults: G = 32,
            CanonicalMLP 256, NonRigidMLP 128; bf16 trunks) on fresh
            HumanDataset items: one warm-up and STAGE2_DATA_STEPS timed
            steps, B1-B5 launches held to PER_STEP, losses finite;
  stage3 data  Stage3Config(n_patches=2, compute_dtype="bf16") with the
            capture's two states, its scene warm-started from the stage-1
            phase's weights, on HumanDataset(use_scaleworld=True) items (the
            background rays from the loader): one warm-up and
            STAGE3_DATA_STEPS timed steps, launches as in stage 3, losses
            finite;
  cli       the port's command line (`cli/run.py::main`, in-process) on
            the data phase's capture at the production widths (stage 1
            from configs/Backpack.gin, stages 2 and 3 from
            configs/default.yaml; the CLI's defaults for the rest): per
            stage a training run with prefetch 2 (the scene's val_fn once
            at step CLI_VAL, the human's progress eval once at CLI_DUMP
            and steps CLI_PROFILE traced), a --resume_training run to more
            steps with prefetch 0, and --run_mode eval (results.json;
            freeview_frames 0 and 4 tpose views at 256: no video, the card
            machine has no encoder); stage 3 warm-started from the two
            stages' ckpt/last.pt. Checked: every restored train state
            equals the saved file bit for bit, every loss in
            metrics.jsonl finite (the first resumed one too), B1-B5
            launched per step as in phase train, best.pt and the
            progress eval written, every PSNR/SSIM/LPIPS of the
            results files finite; torch's default library settings
            (TF32 convolutions, cuDNN free to choose) are put back before
            each command, and `utils/card.py::settings()` after it must
            equal what `configure()` returns: the CLI sets them itself.
            Printed: each stage's ms/step with and without prefetch
            (metrics.jsonl's sec_per_step) beside the data phases' numbers, the prefetched stage-2 step's device
            idle share, ms per 512 x 512 eval frame (human, composed);
  ddp       data parallelism (`parallel/`, `entry.dryrun_multidevice`
            size "cell"): DDP_RANKS processes on the one card over gloo
            (NCCL refuses two ranks on one device) take bench.py's stage-3
            cell, Stage3Config(n_patches=2, compute_dtype="bf16") on
            composed_batch(2, 32, grid_size=32), each rank its 1,024 of
            the 2,048 rays: the sharded gradient step against the one-rank
            step with the same weights, batch and generator (loss within
            TOL_GRAD_LOSS, every parameter's gradient within rel L2
            TOL_GRAD), every rank's parameters equal after the update,
            then 1 + 3 sharded steps with B1-B5 launched per rank as
            PER_STEP and ms/step by utils/benchtools, and one sharded
            composed-render chunk against the one-rank chunk (the render
            tolerances); then one NCCL world-size-1 initialize and
            all-reduce on the card, and one human render chunk with
            lbs_impl="xla" (the one-hot LBS form) against the gather form
            on CUDA tensors; the phase's wall time;
  gradcheck one step's gradients, the kernel path on the card against the
            same path through the kernels' plain versions on the CPU (f32
            trunks, same weights), parameter by parameter
            (`train/gradcheck.py`), the sorted and the dense path of the
            stage-2 step and the stage-3 step (without its LPIPS term, see
            train/gradcheck.py), each on the training batch;
  tools     the port's chip tools (hosnerf_tpu_torch/tools/) through
            their entry points: the convergence probe's loop
            (`tools/convergence_probe.py`) for PROBE_STEPS steps of stage 1
            and of stage 2 on the probe's 20-frame 48 x 48 capture, each
            held to the JAX package's committed curve in the [500, 1000)
            window (at most BAND_DB below it), B1-B5 launched per stage-2
            step as PER_STEP; the probe's first stage-2 step at seeds
            FIRST_SEEDS (`tools/seed_sweep.py`), the share of supported
            samples with density > 0 and the accumulated alpha before and
            after it printed, the seeds it kills equal to the CPU's
            DEAD_SEEDS; the parity runbook (a subprocess driving the
            CLI, RUNBOOK_STEPS steps per stage at the production sizes on
            that capture), every metric of its PARITY_RUN.md finite;
            grad_parity (sorted vs dense stage-3 gradients on the card)
            at PARITY_PATCHES, within its TOL and finite, then at 8
            patches PARITY_FRESH more times as fresh `python -m` processes
            (the tool's own card settings, no setup of this script), the
            worst values equal bit for bit; the 8-patch
            stage-3 step under the four remat splits (time_step's ms/step,
            memcheck's peak device memory, the losses finite);
            profile_step's components at 2 patches and one profiled step
            by group; fg_density_study's live fractions; each sub-phase's
            wall time;
  bench tools  the JAX repo's remaining chip tools, ported: ref_flops'
            count; bench_mlp (row 8 vs the module MLPs), bench_lbs (rows
            1 and 4 through inverse_warp, row 7), bench_deconv (the
            weight-volume decoder's phase and conv forms, ms and TFLOP/s)
            and bench_lbs_pg (rows 6 and 1 on production-shaped points)
            at production sizes with BENCH_ITERS calls each, their kernels'
            launches read around each; the decoder's phase form against
            its conv form on the card (values and gradients, DECONV_TOL)
            and against itself on the CPU (PHASE_CARD_VS_CPU);
            the pair densities of bench_lbs_pg, pg_density_study and
            pg_window_study at 2 patches on the card against the same
            counts on the CPU; bench_all's three stages (one JSON line
            each);
  bench     the port's bench script, `python -m hosnerf_tpu_torch.bench`
            (the JAX repo's bench.py: its stage-3 cell without LPIPS, 3 +
            20 steps at iteration 100 + i, then its 8-patch point), in a
            fresh process: exit 0, its last line one JSON object with
            `value` and `sec_per_step_8patch` finite and positive, the
            implied rate at most TRIPWIRE x 989 TFLOP/s, 0 < MFU <=
            TRIPWIRE and the counted FLOP source; each point's kernel
            launches (the bench's own counts, set to 0 before the point
            and read after its counted step) held to PER_STEP a step;
            printed with the phase's wall time.

Stdout ends with the card's name and power limit, one JSON line of kernel
results and one JSON status line. The render kernels' entries report the
render path (their launches there, their times at its shapes), the training
kernels' entries the training step, the f32 trunk kernels' entries (`_f32`)
the f32 training step, the inverse cores the dense step and the dense
render chunks, rows 7, 8 and 12 their entry points' runs.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

RAYS = 128 * 128           # one frame
CHUNK = 8192               # rays per chunk (renderers.render_human_image)
FRAMES = 3
ITER = 10 ** 7             # the render path's iter_val
TRAIN_ITER = 60_000        # non-rigid condition and full hann band on
TRAIN_STEPS = 10
F32_STEPS = 3
# kernel launches per training step: the sorted path runs the inverse LBS
# once, the trunks four times (non-rigid, canonical, and the forward
# non-rigid MLP on both deform streams) and the forward LBS once
PER_STEP = {"inverse_core_pg_s": 1, "fused_embed_trunk": 4,
            "shared_blend_fwd": 1, "inverse_core_bwd": 1,
            "fused_embed_trunk_bwd": 4, "shared_blend_bwd": 1}
DENSE_STEPS = 3
# the stage-3 step (bench.py's config) launches the human field's kernels as
# the stage-2 step does; its render frames 1 B1 and 2 B2 launches a chunk
STAGE3_STEPS = 5
STAGE3_FRAMES = 2
# the data-fed phases: a 16-frame 512 x 512 mini capture on disk, stage 1
# at configs/Backpack.gin's sizes, stages 2 and 3 on HumanDataset items
DATA_FRAMES, DATA_RES = 16, 512
STAGE1_STEPS = 5
STAGE2_DATA_STEPS = 5
STAGE3_DATA_STEPS = 3
# phase ddp: ranks on the one card, and the worker's time limit (s)
DDP_RANKS, DDP_TIMEOUT = 2, 300
REPO = os.path.dirname(os.path.abspath(__file__))
# per dense training step: the quad inverse core once (in its default
# 'sig' order row 1 over the sorted domain, with pg_sort='morton' row 9)
# and B4 once, the trunks three times (non-rigid, canonical, and one
# forward non-rigid call over both deform streams), the forward LBS once;
# lbs_impl='pallas_dense' takes the ray-order core and, as the JAX package
# dispatches it, the gather forward LBS
PER_DENSE_STEP = {"inverse_core_pg_s": 1, "inverse_core_bwd": 1,
                  "fused_embed_trunk": 3, "fused_embed_trunk_bwd": 3,
                  "shared_blend_fwd": 1, "shared_blend_bwd": 1}
PER_DENSE_MORTON_STEP = {**{k: v for k, v in PER_DENSE_STEP.items()
                            if k != "inverse_core_pg_s"},
                         "inverse_core_pg": 1}
PER_PALLAS_DENSE_STEP = {"inverse_core": 1, "inverse_core_bwd": 1,
                         "fused_embed_trunk": 3, "fused_embed_trunk_bwd": 3}

# Tolerances, kernel vs its plain version on the same inputs:
# inverse LBS does the same arithmetic in the same order with
# round-to-nearest intrinsics on both sides -> 1e-6 of the output scale.
TOL_LBS = 1e-6
# embed+trunk, f32 (bf16x3 products, each weight chunk's sum added with
# rounding): summation order only -> 1e-5 of the scale. bf16: one
# flipped bf16 rounding of an activation moves an output by about a bf16
# ulp of the activations -> 1e-2 of the scale, and at most 5% of the
# entries beyond 1e-3 of it.
TOL_MLP = {"highest": 1e-5, "bf16": 1e-2}
# Backward kernels, (relative L2, max error over the output's scale). The
# sums over samples (dvol, drg, drmat, dW, broadcast daux) come in fixed
# orders that differ from the plain versions' (per-CTA slots summed in
# slot order; dvol in fixed point, each share rounded to 2^-e): 1e-4 for
# the LBS backwards (B4, B5) and the forward LBS (1e-5).
# In bf16 B4 rounds a gradient factor (gw hz) that kernel and plain
# version sum in another f32 order; where it lands on a rounding boundary
# the two round apart by one bf16 ulp (2^-7 relative) of that term -> max
# 1e-2 of the scale, L2 unchanged. (B5's gw = bf16(dw) took the same
# flips, 3.7e-4 of the scale at the training shapes, until both sides
# computed dw exactly and rounded it once.)
# Trunk backward (B3), (relative L2, threshold over the scale, share of
# entries allowed beyond it): highest sums in another (fixed) f32 order
# than the plain version, and among the ~2e8-5e8 pre-activations of a
# call some sit within f32 noise of 0 and flip their ReLU mask, which
# moves that row's gradients by up to
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
# phase repro: calls of each backward kernel; steps of each training run,
# and the step a resumed run is cut at
REPRO_CALLS = 5
REPRO_STEPS, REPRO_CUT = 4, 2
# its configurations: the stage-2 step (sorted, and dense with sparse=False),
# bench.py's stage-3 config, stage 1 at the CLI's default widths with two
# states on REPRO_RAYS rays; grad_parity's (a CPU rehearsal makes them small)
REPRO_HUMAN = dict(compute_dtype="bf16")
REPRO_STAGE3 = dict(n_patches=2, compute_dtype="bf16")
REPRO_SCENE = dict(num_states=2, compute_dtype="bf16")
REPRO_RAYS = 4096
REPRO_PARITY = dict(n_patches=8)
# B5 backward on one training step's own inputs (capture_blend_bwd); B1
# and B4: kernel device time (profiler), the corner image's, the entry at
# k0 = 0, the live pairs and the k0 timed; row 12: its kernel's device
# time and its output's zero fill's
EXTRA_KEYS = ("step_grad_ms", "step_random_grad_ms", "step_rows",
              "device_ms", "image_ms", "k0_zero_ms", "live_pairs", "k0",
              "fill_ms")

# H100 SXM peaks (NVIDIA data sheet), for the bounds: HBM bytes/s, f32
# FLOP/s outside the tensor cores; the dense bf16 tensor-core rate is
# hosnerf_tpu_torch/bench.py's BF16_PEAK_TFLOPS, and f32-grade products on
# the tensor cores (the f32 trunks' bound) take six bf16 products per f32
# product (bf16x3; three TF32 ones at 495 TFLOP/s give the same), their
# share of the FMA bound (F32_FLOPS) printed beside it. The LBS kernels'
# f32 operations per live pair (B1, B4) and per (computed sample, bone)
# (B5) are bench.py's OPS_* too.
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
F32_TC_PER_BF16 = 6
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


def bound(nbytes: float, f32_ops: float = 0.0, bf16_ops: float = 0.0,
          f32_tc_ops: float = 0.0):
    """(least ms the card could take, 'bytes' or 'operations')."""
    from hosnerf_tpu_torch.bench import BF16_PEAK_TFLOPS
    bf16_flops = BF16_PEAK_TFLOPS * 1e12
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = (f32_ops / F32_FLOPS + bf16_ops / bf16_flops
             + f32_tc_ops * F32_TC_PER_BF16 / bf16_flops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def trunk_bound(res, io_bytes: float, flops: float, prec: str) -> str:
    """Sets a trunk kernel's bound: its matmul operations on the tensor
    cores (bf16, or f32-grade at 1 / F32_TC_PER_BF16 of that rate) against
    its bytes; for f32 also the FMA bound (F32_FLOPS) as `fma_bound_ms`. Returns the line
    fragment with the rate and the shares (after `res["ms"]` is set)."""
    ops = "bf16_ops" if prec == "bf16" else "f32_tc_ops"
    res["bound_ms"], res["bound_by"] = bound(io_bytes, **{ops: flops})
    line = f" bound_ms={res['bound_ms']:.5f} ({res['bound_by']})" + rate(
        res, flops)
    if prec != "bf16":
        res["fma_bound_ms"] = bound(io_bytes, f32_ops=flops)[0]
        res["fma_bound_share"] = res["fma_bound_ms"] / res["ms"]
        line += (f" fma_bound_ms={res['fma_bound_ms']:.5f} "
                 f"fma_bound_share={res['fma_bound_share']:.3f}")
    return line


class f32_modules:
    """The model's module MLPs in f32 (compute_dtype None) inside the
    block: the f32 kernels' library route (cuBLAS f32, TF32 off)."""

    def __init__(self, model, on: bool = True):
        self.mods = [model.cnl_mlp, model.non_rigid_mlp] if on else []

    def __enter__(self):
        self.saved = [m.compute_dtype for m in self.mods]
        for m in self.mods:
            m.compute_dtype = None

    def __exit__(self, *exc):
        for m, d in zip(self.mods, self.saved):
            m.compute_dtype = d


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
             ("max", ("inv_gmax_kernel",)), ("memset", ("Memset",)),
             ("fold", ("inv_fold_kernel",)))


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
    from hosnerf_tpu_torch import bench
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
                        f32_ops=bench.OPS_B1_PAIR * pairs)
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
    route, the module MLPs on cuBLAS bf16 (f32 for the f32 kernel), is timed
    beside each kernel, and the kernel's device time (profiler) beside its
    entry's."""
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
                        with f32_modules(model, prec != "bf16"):
                            res["library_ms"] = time_ms(
                                torch, library[name], iters)
                        line += f" library_ms={res['library_ms']:.4f}"
                        line += trunk_bound(
                            res, nbytes(x_skel_s, got, *[t for p in layers
                                                         for t in p], *out)
                            + (nbytes(aux) if kw["aux_mode"] == "broadcast"
                               else aux.shape[-1] * 4), flops, prec)
                        kern = TRUNK_KERNELS[prec][0]
                        dev_ms = device_ms(
                            torch, lambda: cmlp.fused_embed_trunk(
                                x_skel_s, aux, alpha, layers, out,
                                precision=prec, k0_blocks=k0_t, **kw),
                            [("kernel", (kern,))], 3)["kernel"]
                        check(dev_ms > 0, f"{name} {prec}: the profiler saw "
                              f"no {kern} launch")
                        res["launch_ms"] = {"kernel": dev_ms}
                        line += (f" kernel device ms={dev_ms:.4f} (entry "
                                 f"less kernel {ms - dev_ms:.4f})")
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
    from hosnerf_tpu_torch import bench
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
                        + vol_b, f32_ops=bench.OPS_B4_PAIR * pairs)
        kernel_ms = parts["bwd"] + parts["max"] + parts["memset"]
        res = dict(err=err, rel=rel, ms=ms, k0_zero_ms=ms0,
                   device_ms=kernel_ms, image_ms=parts["image"],
                   plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                   live_pairs=pairs, k0=live_k0)
        line = (f"kernel inverse_core_bwd {prec}: n={n} dead_rows={dead} "
                f"k0={live_k0} live_pairs={pairs} max_abs_err={err:.3e} "
                f"max_err_over_scale={rel:.3e} entry ms={ms:.4f} (k0=0 "
                f"{ms0:.4f}) device ms={kernel_ms:.4f} (kernel and fold "
                f"{parts['bwd']:.4f}, the fold alone {parts['fold']:.4f}, the "
                f"gradient's max {parts['max']:.4f}, "
                f"memset {parts['memset']:.4f}; image "
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


# B5's backward launches by kernel name (device_ms): the three binning
# passes, the per-brick kernel, the fixed-point finish, the memsets
BLEND_PARTS = (("binning", ("bin_count_kernel", "bin_scan_kernel",
                            "bin_scatter_kernel")),
               ("taps", ("tap_bwd_kernel",)),
               ("finish", ("tap_finish_kernel",)), ("memset", ("Memset",)))


def check_blend(torch, ti, results, iters):
    """B5 forward and backward vs their plain versions at k0 = 0, the
    batch's live k0 (512-row blocks) and the all-dead clamp: forward rows
    below the clamped k0 * 512 left unwritten (NaN), backward dpts rows
    there exactly 0."""
    from hosnerf_tpu_torch import bench
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
                if k0 == live_k0 and prec == "bf16":
                    split = device_ms(torch, lambda: clbs.shared_blend_bwd(
                        pts_g, vol_all, rmat, k0_t, gout, prec), BLEND_PARTS)
                    line += " bwd device ms " + " ".join(
                        f"{k}={v:.4f}" for k, v in split.items())
                if k0 == 0:
                    pf = time_ms(torch, lambda: clbs.shared_blend_plain(
                        pts_g, vol_all, rmat, prec), 1)
                    pb = time_ms(torch, lambda: clbs.shared_blend_bwd_plain(
                        pts_g, vol_all, rmat, k0, gout, prec), 1)
                    vol_b = vol_all.numel() * (2 if prec == "bf16" else 4)
                    bf = bound(nbytes(pts_g, rmat, got) + vol_b,
                               f32_ops=bench.OPS_B5F_BONE * B * n)
                    bb = bound(nbytes(pts_g, rmat, gout, *got_b) + vol_b,
                               f32_ops=bench.OPS_B5B_BONE * B * n)
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
    the module MLPs on cuBLAS bf16 (f32 for the f32 kernels), is timed
    beside each kernel."""
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
                    line += trunk_bound(res, io, flops, prec)
                    with f32_modules(model, prec != "bf16"):
                        res["library_ms"] = library_trunk_bwd_ms(
                            torch, model, name, x, aux, alpha, gout, iters)
                    line += f" library_ms={res['library_ms']:.4f}"
                    results[(name + "_bwd", prec)] = res
                print(line, flush=True)
                del got, flat_g, flat_r
        del gout


# the trunk kernels by precision: the forward (B2, and B3's recompute),
# B3's rows and dW launches and the launch that sums their slots in order
TRUNK_KERNELS = {"bf16": ("embed_trunk_bf16", "rows_bwd_bf16", "dw_bf16",
                          "slot_sums"),
                 "highest": ("embed_trunk_x3", "rows_bwd_x3", "dw_x3",
                             "slot_sums")}


def b3_launch_split(torch, ti, results, reps=3):
    """B3's four launches timed apart at the training shapes (both
    precisions, k0 = 0): one C call launches them back to back, so their
    device times are read from torch.profiler (CUPTI kernel records), mean
    of `reps` calls after the timed ones above."""
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    xs = {"nonrigid": ti["x_skel_s"], "canonical": ti["cnl_pts_s"]}
    for name, (kw, aux, alpha, layers, out) in ti["specs"].items():
        x = xs[name]
        gout = torch.randn(x.shape[0], out[0].shape[0], device=x.device,
                           generator=torch.Generator(x.device).manual_seed(7))
        for prec, kernels in TRUNK_KERNELS.items():
            split = device_ms(torch, lambda: cmlp.fused_embed_trunk_bwd(
                x, aux, alpha, layers, out, gout, precision=prec,
                k0_blocks=0, **kw),
                [(part, (kernel,)) for part, kernel in
                 zip(("recompute", "rows", "dw", "sums"), kernels)], reps)
            check(all(v > 0 for v in split.values()),
                  f"trunk bwd {name} {prec}: the profiler saw no B3 launch "
                  f"({split})")
            res = results[(name + "_bwd", prec)]
            res["launch_ms"] = split
            print(f"kernel fused_embed_trunk_bwd {name} {prec} launches: "
                  + " ".join(f"{k}_ms={v:.4f}" for k, v in split.items())
                  + f" (sum {sum(split.values()):.4f}; events "
                  f"{res['ms']:.4f}; entry less kernels "
                  f"{res['ms'] - sum(split.values()):.4f})", flush=True)


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
    from hosnerf_tpu_torch import bench
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
            # the quad core's Morton route is row 9 (pg_sort='morton')
            kw = {"pg_sort": "morton"} if name == "inverse_core_pg" else {}
            ms_entry = time_ms(torch, lambda: entry(pts, rg, tg, vol_qz,
                                                    prec, **kw), iters)
            bf = bound(nbytes(x, rg, tg, got) + vol_b,
                       f32_ops=bench.OPS_B1_PAIR * pairs)
            bb = bound(nbytes(x, rg, tg, g, *dgot) + vol_b,
                       f32_ops=bench.OPS_B4_PAIR * pairs)
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
        # the quad core's default route: bp_prepare's sorted domain, row 1
        # at its k0, unsorted; the same values as every order
        sig = clbs.inverse_core_pg(pts, rg, tg, vol_qz, prec)
        check(bool(torch.equal(sig, ray_order[:n])),
              f"quad core 'sig' {prec}: differs from the ray-order result")
        ms_sig = time_ms(torch, lambda: clbs.inverse_core_pg(
            pts, rg, tg, vol_qz, prec), iters)
        print(f"quad core pg_sort='sig' {prec} (bp_prepare + B1 at k0 + "
              f"unsort) ms={ms_sig:.4f}; pg_sort='morton' (row 9) ms="
              f"{results[('inverse_core_pg', prec)]['core_ms']:.4f}",
              flush=True)
        del ref, dref, ray_order, sig
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
    library route (the model's module MLP of the same layout, cuBLAS bf16
    or f32, and its autograd backward) timed beside each."""
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
            res_f = dict(err=err_f, rel=err_f / scale, ms=ms_f, plain_ms=pf)
            res_b = dict(err=err_b, rel=rel_b, ms=ms_b, plain_ms=pb)
            rates = (" fwd" + trunk_bound(res_f, nbytes(x, got, *params),
                                          flops, prec)
                     + " bwd" + trunk_bound(
                         res_b, nbytes(x, gout, *flat_g, *params), 3 * flops,
                         prec))
            line = (f"kernel fused_trunk {name} {prec}: rows={BENCH_ROWS} "
                    f"fwd max_abs_err={err_f:.3e} (over scale "
                    f"{err_f / scale:.3e}, beyond_1e-3={frac:.4f}) bwd "
                    f"max_abs_err={err_b:.3e} (over scale {rel_b:.3e}) fwd "
                    f"ms={ms_f:.4f} bwd ms={ms_b:.4f} fwd plain_ms={pf:.4f} "
                    f"bwd plain_ms={pb:.4f}" + rates)
            with f32_modules(model, prec != "bf16"):
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
            # the entry's time split: the kernel's and dvol's zero fill's
            # device time (profiler records), the rest host-side entry
            # work between launches (checks, allocation, the ctypes call)
            dev = device_ms(torch, lambda: pp.run(count, *args, pp.N_TILES),
                            (("kernel", ("pairgrid_kernel",)),
                             ("fill", ("fill", "Memset", "elementwise"))),
                            reps=iters)
            results[("proto", "f32")] = dict(
                err=err, rel=rel, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, device_ms=dev["kernel"], fill_ms=dev["fill"])
            print(f"kernel proto_pairgrid: n_pairs=7 max_abs_err={err:.3e} "
                  f"ms={ms:.4f} plain_ms={pms:.4f} bound_ms={bms:.6f} "
                  f"({by}); n_pairs=2 unvisited rows unwritten; entry "
                  f"split: kernel device {dev['kernel']:.4f} ms, zero fill "
                  f"{dev['fill']:.4f} ms, entry overhead "
                  f"{ms - dev['kernel'] - dev['fill']:.4f} ms", flush=True)


def entry_point_runs(torch, ti, batch, device):
    """Rows 7, 8 and 12 through their user entry points, every launch
    count zeroed just before and read just after: the all-bone weights of
    the step's canonical points through `ops/lbs.py::bone_weights`
    (impl='pallas') and their backward; the canonical trunk-only MLP
    through `fused_trunk` and its backward; `tools/proto_pairgrid.py`'s
    main; then, counts zeroed again, the same trunk call with f32
    ("highest") weights and its backward. Returns (counts, f32 counts)."""
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
    for w in wrappers.values():
        w.launches = 0
    with torch.enable_grad():
        x, layers, out, kw = trunk_weights(torch, "canonical", device, 2)
        x.requires_grad_()
        cmlp.fused_trunk(x, layers, out, precision="highest",
                         **kw).square().sum().backward()
        check(bool(torch.isfinite(x.grad).all()),
              "fused_trunk f32: non-finite gradient")
    torch.cuda.synchronize()
    f32 = {k: w.launches for k, w in wrappers.items()}
    expect = {"fused_trunk": 1, "fused_trunk_bwd": 1}
    print("phase entry points (f32 trunk): launches "
          + " ".join(f"{k}={v}" for k, v in f32.items()), flush=True)
    check(f32 == {k: expect.get(k, 0) for k in f32},
          f"entry points f32: launches {f32}, expected {expect}")
    return launches, f32


def check_dense_render(torch, model, batch):
    """One render chunk through the dense path with each inverse core (the
    pair-grid cores 'quad' in both row orders, its 'sig' order running row
    1, 'win', 'bp', and 'pallas_dense') against the
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
    for lbs_impl, pg_impl, pg_sort in (
            ("auto", "quad", "sig"), ("auto", "quad", "morton"),
            ("auto", "win", "sig"), ("auto", "bp", "sig"),
            ("pallas_dense", "quad", "sig")):
        model.lbs_impl, model.pg_impl = lbs_impl, pg_impl
        model.pg_sort = pg_sort
        if pg_impl == "quad" and lbs_impl == "auto":
            pg_impl = f"quad {pg_sort}"
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
    model.pg_sort = "sig"
    cores = INVERSE_CORES + ("inverse_core_pg_s",)
    launches = {k: wrappers[k].launches for k in cores}
    check(launches == dict.fromkeys(cores, 1),
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
                     "bin_scatter_kernel", "tap_bwd_kernel")),
        ("tap_finish", ("tap_finish_kernel",))),
    # B1 and B4 (csrc/lbs_inverse.cu); B4's memset is not told apart from
    # the step's others
    "inverse LBS": INV_PARTS[:4],
    # B2 and B3's recompute, B3's rows, dW and slot-sum launches, either
    # precision
    "trunk": tuple((part, tuple(k[i] for k in TRUNK_KERNELS.values()))
                   for i, part in enumerate(("fwd", "rows", "dw", "sums"))),
}


def profile(torch, what: str, fn, ref_ms: float):
    """fn under torch.profiler: device and host time by operator, the
    LBS and trunk kernels' device time, and the device's idle share, of
    the profiled wall time and of `ref_ms`, the same work's unprofiled
    time. Returns (device busy ms, {group: {part: ms}})."""
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
    # the LBS and trunk kernels, often below the tables' rows: B5's
    # backward is its binning passes plus tap_bwd_kernel, B4 its kernel and
    # fold
    groups = {}
    for group, parts in LBS_PROFILE_PARTS.items():
        groups[group] = {part: sum(e.self_device_time_total for e in events
                                   if e.device_type == DeviceType.CUDA
                                   and any(k in e.key for k in kernels))
                         / 1e3 for part, kernels in parts}
        print(f"phase profile: {what}, {group} device ms: "
              + " ".join(f"{part} {ms:.4f}"
                         for part, ms in groups[group].items()), flush=True)
    trunk_ms = sum(groups["trunk"].values())
    print(f"phase profile: {what}, device busy {busy_ms:.2f} ms; idle share "
          f"{1 - busy_ms / wall_ms:.3f} of {wall_ms:.2f} ms profiled wall, "
          f"{1 - busy_ms / ref_ms:.3f} of {ref_ms:.2f} ms unprofiled; trunk "
          f"kernels {trunk_ms:.3f} ms, {trunk_ms / busy_ms:.3f} of the "
          "device time", flush=True)
    return busy_ms, groups


# ---------------------------------------------------------------------------
# train phase
# ---------------------------------------------------------------------------

def launch_counts():
    """{name: wrapper} of every kernel wrapper (`utils/spans.py`'s list and
    the pair-grid prototype); each counts its launches."""
    from hosnerf_tpu_torch.tools import proto_pairgrid as pp
    from hosnerf_tpu_torch.utils import spans
    return {**spans.kernel_wrappers(), "proto_pairgrid": pp.run}


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


def gradcheck_phase(torch, device, n_patches=2, patch_size=32, dense=False,
                    stage3=False):
    """One step's gradients, the card's kernel path vs the same path (the
    sorted one, or the dense one; of the stage-3 step with `stage3`) on
    the kernels' plain versions on the CPU, held to TOL_GRAD and
    TOL_GRAD_LOSS."""
    import math

    from hosnerf_tpu_torch.train import gradcheck
    what = ("stage-3 step, " if stage3 else "") + ("dense" if dense
                                                   else "sorted")
    print(f"gradcheck ({what} path): kernel path on the card vs plain "
          f"versions on the CPU ({n_patches} patches of {patch_size}x"
          f"{patch_size} rays)", flush=True)
    t0 = time.time()
    res = gradcheck.compare_step_grads(device, n_patches, patch_size,
                                       dense=dense, stage3_step=stage3)
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
# stage 3: the composed step and the composed render
# ---------------------------------------------------------------------------

def composed_item(seed: int, G: int):
    """A 128 x 128 frame item (frame_item's rays) with the background ray
    keys and the smpl -> scaled-world transform that composed_batch
    adds."""
    from hosnerf_tpu_torch.data import synthetic
    item = synthetic.composed_batch(RAYS // 64, 8, seed=seed, grid_size=G)
    item.update(img_height=128, img_width=RAYS // 128)
    return item


def scene_alone_ms(torch, cfg, scene, batch, reps=3):
    """Host-clock ms of the scene's forward and backward alone on the
    step's rays (its loss: the last level's rgb and density against a
    fixed random cotangent), mean of `reps` after a warm-up."""
    bb = {"rays_o": batch["rays_o_bkg"], "rays_d": batch["rays_d_bkg"],
          "viewdirs": batch["viewdirs_bkg"], "radii": batch["radii"]}
    gen = torch.Generator(batch["rays_o"].device).manual_seed(5)

    def once():
        _, hist = scene(bb, 1.0, True, 0, cfg.near_bkg, cfg.far_bkg,
                        generator=gen)
        out = torch.cat([hist[-1]["rgb"], hist[-1]["density"][..., None]],
                        -1)
        (out * 1e-3).sum().backward()

    once()
    torch.cuda.synchronize()
    t0 = time.time()
    for _ in range(reps):
        once()
    torch.cuda.synchronize()
    scene.zero_grad(set_to_none=True)
    return (time.time() - t0) * 1e3 / reps


def stage3_phase(torch, device, kind, lp, cfg=None, steps=STAGE3_STEPS):
    """bench.py's stage-3 config (`cfg` unless given; with LPIPS, at
    TRAIN_ITER and one jitter seed, unlike bench.py) through init_state +
    make_train_step on one fixed composed batch: warm-up, `steps` timed
    steps with every kernel's launches counted and held to PER_STEP, the
    loss checked, peak device memory, the scene's share. Returns (cfg,
    scene, human, ms/step, a function running one more step)."""
    from hosnerf_tpu_torch.data import synthetic
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.train import stage3
    cfg = cfg or stage3.Stage3Config(n_patches=2, compute_dtype="bf16")
    scene, human, opt = stage3.init_state(cfg, seed=0, device=device)
    step = stage3.make_train_step(cfg, scene, human, opt, lpips_apply=lp)
    nb = synthetic.composed_batch(cfg.n_patches, cfg.patch_size,
                                  grid_size=cfg.mweight_volume_size)
    batch = {k: torch.as_tensor(v, device=device) for k, v in nb.items()}
    rays = cfg.n_patches * cfg.patch_size ** 2

    def jitter():
        return torch.Generator().manual_seed(11)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = step(batch, TRAIN_ITER, jitter())
    torch.cuda.synchronize()
    check(all(bool(torch.isfinite(v)) for v in first.values()),
          f"stage3 warm-up step: non-finite losses {first}")
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
    peak = torch.cuda.max_memory_allocated()
    ms = dt * 1e3 / steps
    print(f"phase stage3: {steps} steps of {rays} rays x (human "
          f"{cfg.n_samples}, scene {cfg.num_prop_samples}/"
          f"{cfg.num_prop_samples}/{cfg.num_nerf_samples}) samples, "
          f"nerf MLP 8x{cfg.nerf_netwidth}, {ms:.2f} ms/step, "
          f"{rays * steps / dt:.0f} rays/s, peak device memory "
          f"{peak / 2 ** 30:.3f} GiB ({peak} bytes) on {kind}; launches "
          + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    for k, n in launches.items():
        per = PER_STEP.get(k, 0)
        check(n == per * steps, f"stage3: {k} launched {n} times in "
              f"{steps} steps (expected {per} per step)")
    for i, ls in enumerate(losses):
        check(all(bool(torch.isfinite(v)) for v in ls.values()),
              f"stage3 step {i}: non-finite losses {ls}")
    with torch.no_grad():
        after, _ = stage3.make_loss_fn(cfg, scene, human, lp)(
            batch, TRAIN_ITER, state_index(batch["time"], None), jitter())
    l0, l1 = float(first["loss"]), float(after)
    parts = " ".join(f"{k}={float(v):.6f}" for k, v in first.items())
    timed = " ".join(f"{float(x['loss']):.6f}" for x in losses)
    print(f"stage3 losses: first {parts}; per timed step {timed}; after "
          f"{l1:.6f}", flush=True)
    check(l1 < l0, f"stage3: loss did not drop on a fixed batch ({l0} -> "
          f"{l1})")
    s_ms = scene_alone_ms(torch, cfg, scene, batch)
    print(f"phase stage3: the scene's forward + backward alone {s_ms:.2f} "
          f"ms, {s_ms / ms:.3f} of the step", flush=True)
    return cfg, scene, human, ms, lambda: step(batch, TRAIN_ITER, jitter())


def profile_groups(torch, what: str, fn, ref_ms: float):
    """fn under torch.profiler (the `profile` helper), then once more with
    the device only: its device time by group of kernel names
    (`hosnerf_tpu_torch/tools/common.py::device_groups`) and the glue
    group's largest kernels."""
    from hosnerf_tpu_torch.tools import common
    busy, _ = profile(torch, what, fn, ref_ms)
    total, groups, glue = common.profile_groups(fn, torch.device("cuda"))
    print(f"phase profile: {what}, device ms by group: "
          + "; ".join(f"{g} {ms:.3f} ({ms / total:.3f})"
                      for g, ms in groups.items())
          + f"; sum {total:.3f} (busy in the first profile {busy:.3f})",
          flush=True)
    print(f"phase profile: {what}, largest glue kernels: "
          + "; ".join(f"{ms:.3f} {name[:70]}" for ms, name in glue[:8]),
          flush=True)


def stage3_render_phase(torch, device, kind, cfg, scene, human):
    """STAGE3_FRAMES composed 128 x 128 frames through the render entry
    points, launches counted and the images checked; then one chunk on the
    kernel path against the human field's dense plain path."""
    import numpy as np

    from hosnerf_tpu_torch.eval import renderers
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    items = [composed_item(seed, cfg.mweight_volume_size)
             for seed in range(STAGE3_FRAMES)]
    render_fn = renderers.make_composed_render_fn(cfg, scene, human)
    extra = ("newsmpl_to_scale_world",)

    def frames(its):
        return [renderers.render_human_image(render_fn, it, device, CHUNK,
                                             extra_keys=extra) for it in its]

    frames(items[:1])
    torch.cuda.synchronize()
    clbs.inverse_core_pg_s.launches = 0
    cmlp.fused_embed_trunk.launches = 0
    t0 = time.time()
    images = frames(items)
    torch.cuda.synchronize()
    dt = time.time() - t0
    n_lbs = clbs.inverse_core_pg_s.launches
    n_mlp = cmlp.fused_embed_trunk.launches
    chunks = STAGE3_FRAMES * (-(-RAYS // CHUNK))
    print(f"phase render stage3: {STAGE3_FRAMES} composed frames of "
          f"128x128, {chunks} chunks, {dt * 1e3 / STAGE3_FRAMES:.2f} "
          f"ms/frame, {STAGE3_FRAMES * RAYS / dt:.0f} rays/s on {kind}; "
          f"launches inverse_core_pg_s={n_lbs} fused_embed_trunk={n_mlp}",
          flush=True)
    check(n_lbs == chunks and n_mlp == 2 * chunks,
          f"kernel launches during the composed render: {n_lbs}, {n_mlp} "
          f"for {chunks} chunks (expected 1 and 2 each)")
    for img in images:
        check(img.shape == (128, 128, 3), f"image shape {img.shape}")
        check(bool(np.isfinite(img).all()), "composed: non-finite rgb")
        check(float(img.min()) >= 0.0 and float(img.max()) <= 1.0 + 1e-6,
              f"composed rgb outside [0, 1]: {img.min()} .. {img.max()}")
    print(f"render stage3 image mean {float(np.mean(images)):.4f}",
          flush=True)
    profile_groups(torch, "one composed 128x128 frame",
                   lambda: frames(items[:1]), dt * 1e3 / STAGE3_FRAMES)

    # one chunk: the kernel path vs the human field's dense plain path
    # (the scene runs the same code on both sides)
    item = items[0]
    keys = (renderers.HUMAN_SHARED_KEYS + renderers.HUMAN_RAY_KEYS
            + renderers.BKG_RAY_KEYS + extra)
    b = {k: torch.as_tensor(item[k], device=device) for k in keys}
    for k in renderers.HUMAN_RAY_KEYS + renderers.BKG_RAY_KEYS:
        b[k] = b[k][:CHUNK]
    composed_chunk_check(torch, cfg, scene, human, b)


def composed_chunk_check(torch, cfg, scene, human, b):
    """The composed chunk `b` on the kernel path against the human field's
    dense plain path, twice: with the scene as configured (the random scene
    hides most of the human: the human field's own alpha and colour are
    held there), and with the scene's near plane behind the human's far
    plane, so that the human stands in front and its weights in the
    composite are real (their sum per ray is held). Each placement must
    show the human (maxima >= MIN_ALPHA, foreground rays); everything is
    held over the foreground rays (idx_fg of the dense plain path), where
    the human field takes part."""
    import dataclasses

    from hosnerf_tpu_torch.train import stage3
    state = torch.zeros((), dtype=torch.int32)
    behind = dataclasses.replace(cfg, near_bkg=float(b["far"].max()) + 0.1)
    for where, c in (("scene as configured", cfg),
                     ("scene behind the human", behind)):
        with torch.no_grad():
            comp_s, hum_s = stage3.composed_forward(c, scene, human, b, ITER,
                                                    state)
            human.lbs_impl, human.mlp_impl = "gather", "flax"
            comp_d, hum_d = stage3.composed_forward(c, scene, human, b, ITER,
                                                    state)
            human.lbs_impl, human.mlp_impl = cfg.lbs_impl, cfg.mlp_impl
        hw_s, hw_d = (x["human_weights"].sum(-1) for x in (comp_s, comp_d))
        n_fg = int(comp_d["idx_fg"].sum())
        shown = {"human alpha": float(hum_d["alpha"].max()),
                 "human weight sum": float(hw_d.max())}
        print(f"composed chunk, {where}: {n_fg} of {hw_d.shape[0]} rays in "
              f"the foreground; dense plain path maxima: "
              + ", ".join(f"{k} {v:.4e}" for k, v in shown.items()),
              flush=True)
        held = "human alpha" if c is cfg else "human weight sum"
        check(n_fg > 0 and shown[held] >= MIN_ALPHA,
              f"composed chunk, {where}: no human shows ({n_fg} foreground "
              f"rays, {held} max {shown[held]} < {MIN_ALPHA})")
        pairs = [("rgb", comp_s["rgb"], comp_d["rgb"])]
        pairs += ([("human alpha", hum_s["alpha"], hum_d["alpha"]),
                   ("human 1-rgb", 1.0 - hum_s["rgb"], 1.0 - hum_d["rgb"])]
                  if c is cfg else [("human weight sum", hw_s, hw_d)])
        fg = comp_d["idx_fg"]
        for name, got, ref in pairs:
            got, ref = got[fg], ref[fg]
            scale = float(ref.abs().max())
            diff = (got - ref).abs()
            rmax = float(diff.max()) / scale
            rmean = float(diff.mean()) / scale
            print(f"composed chunk vs dense plain path, {where}, foreground "
                  f"rays: {name} max {scale:.4e}, error max {rmax:.3e} mean "
                  f"{rmean:.3e} of it "
                  f"(tolerance {TOL_RENDER_MAX}, {TOL_RENDER_MEAN})",
                  flush=True)
            check(rmax <= TOL_RENDER_MAX and rmean <= TOL_RENDER_MEAN,
                  f"composed chunk, {where}: {name} disagrees with the "
                  "dense plain path")


# ---------------------------------------------------------------------------
# phase repro: the same inputs give the same bits
# ---------------------------------------------------------------------------

def repro_report(what: str, diffs, fails: list) -> None:
    """Print how many tensors of `what` differ between its repeats and the
    largest difference ([(path, largest |a - b|)], as
    checkpoints.state_diff returns it); a difference goes into `fails`."""
    big = max((d for _, d in diffs), default=0.0)
    names = ", ".join(p for p, _ in diffs[:4]) + (", ..." if len(diffs) > 4
                                                   else "")
    print(f"phase repro: {what}: {len(diffs)} tensors differ, largest "
          f"difference {big:.3e}" + (f" ({names})" if diffs else ""),
          flush=True)
    if diffs:
        fails.append(f"{what}: {len(diffs)} tensors differ (largest "
                     f"{big:.3e})")


def repro_calls(what: str, fn, fails: list, calls: int = REPRO_CALLS):
    """`fn()` called `calls` times; every output held to the first's bits
    (the largest difference per tensor over the repeats reported)."""
    from hosnerf_tpu_torch.train.checkpoints import state_diff
    first = fn()
    worst_of = {}
    for _ in range(calls - 1):
        for path, d in state_diff(first, fn()):
            worst_of[path] = max(worst_of.get(path, 0.0), d)
    repro_report(what, sorted(worst_of.items()), fails)


def repro_kernels(torch, ti, fails: list) -> None:
    """Each backward kernel REPRO_CALLS times on the training inputs, at
    k0 = 0 and at the inputs' live k0 (row 7 takes no k0), both
    precisions: B3 (non-rigid and canonical), B4, B5 with K = 2 (the
    step's) and K = 1, row 7."""
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp
    dom, n = ti["dom"], ti["n_pad"]
    dev = ti["pts_s"].device

    def seeded(seed, *shape):
        return torch.randn(*shape, device=dev,
                           generator=torch.Generator(dev).manual_seed(seed))

    def k0s(tile):
        return [(k0, torch.tensor([k0], dtype=torch.int32, device=dev))
                for k0 in (0, max(1, int(dom.k0_for(tile))))]

    xs = {"nonrigid": ti["x_skel_s"], "canonical": ti["cnl_pts_s"]}
    for name, (kw, aux, alpha, layers, out) in ti["specs"].items():
        gout = seeded(7, n, out[0].shape[0])
        for prec in ("bf16", "highest"):
            for k0, k0_t in k0s(cmlp.MLP_TILE):
                repro_calls(f"B3 {name} {prec} k0={k0}",
                            lambda: cmlp.fused_embed_trunk_bwd(
                                xs[name], aux, alpha, layers, out, gout,
                                precision=prec, k0_blocks=k0_t, **kw), fails)
    pts_s, rg, tg, vol_qz = ti["pts_s"], ti["rg"], ti["tg"], ti["vol_qz"]
    gacc = seeded(5, n, 4)
    for prec in ("bf16", "highest"):
        for k0, k0_t in k0s(clbs.INV_TILE):
            repro_calls(f"B4 {prec} k0={k0}", lambda: clbs.inverse_core_bwd(
                pts_s, rg, tg, vol_qz, gacc, prec, k0=k0_t), fails)
    pts_g, vol_all, rmat = ti["pts_g"], ti["vol_all"], ti["rmat"]
    for K in (2, 1):
        rm = rmat[:, :12 * K].contiguous()
        gout = seeded(6, n, 3 * K + 1)
        for prec in ("bf16", "highest"):
            for k0, k0_t in k0s(clbs.TILE_SH):
                repro_calls(f"B5 K={K} {prec} k0={k0}",
                            lambda: clbs.shared_blend_bwd(
                                pts_g, vol_all, rm, k0_t, gout, prec), fails)
    gw = seeded(13, n, rmat.shape[0])
    for prec in ("bf16", "highest"):
        repro_calls(f"row 7 {prec}", lambda: clbs.shared_core_bwd(
            pts_g, vol_all, gw, prec), fails)


def repro_training(torch, build, batch, root: str, tag: str, fails: list,
                   resume: bool, iter0: int = 0) -> None:
    """REPRO_STEPS steps of `build(seed)` -> (models, opt, step_fn) through
    train/loop.py::run_training from seed 0 and one loop generator, run
    twice: every parameter, Adam moment and step count, opt.updates and
    the generator equal. With `resume`, also REPRO_CUT steps, checkpoint,
    restore into models built from seed 1, the rest: equal to the
    straight run, as tests/test_torch_loop.py::test_resume_is_bit_exact
    holds on the CPU. Step i runs at iteration iter0 + i."""
    from hosnerf_tpu_torch.train import checkpoints as ck
    from hosnerf_tpu_torch.train import loop
    from hosnerf_tpu_torch.train.checkpoints import state_diff

    def run(models, opt, step, logdir, num, start=0, gen=None):
        gen = loop.run_training(
            num_steps=num, start_step=start, sample_batch=lambda: batch,
            step_fn=lambda b, i, g: step(b, iter0 + i, g), models=models,
            optimizer=opt, logdir=logdir, log_every=REPRO_STEPS,
            checkpoint_every=0, prefetch=0,
            generator=gen or torch.Generator().manual_seed(5))
        torch.cuda.synchronize()
        return gen

    straight = []
    for r in range(2):
        models, opt, step = build(0)
        gen = run(models, opt, step, os.path.join(root, f"{tag}_{r}"),
                  REPRO_STEPS)
        straight.append(ck.pack_train_state(models, opt, REPRO_STEPS, gen))
        del models, opt, step
    repro_report(f"{tag}: {REPRO_STEPS} steps run twice",
                 state_diff(*straight), fails)
    if resume:
        cut = os.path.join(root, f"{tag}_cut")
        models, opt, step = build(0)
        run(models, opt, step, cut, REPRO_CUT)
        del models, opt, step
        models, opt, step = build(1)
        gen = torch.Generator().manual_seed(99)
        start = ck.restore_train_state(os.path.join(cut, "ckpt"), "last",
                                       models, opt, gen)
        check(start == REPRO_CUT, f"{tag}: resumed at step {start}")
        gen = run(models, opt, step, cut, REPRO_STEPS, start, gen)
        repro_report(f"{tag}: {REPRO_CUT} steps, checkpoint, restore into "
                     f"seed-1 models, {REPRO_STEPS - REPRO_CUT} more vs "
                     f"{REPRO_STEPS} straight",
                     state_diff(ck.pack_train_state(models, opt, REPRO_STEPS,
                                                    gen), straight[0]),
                     fails)
    del straight
    torch.cuda.empty_cache()


def repro_phase(torch, device, ti, fails=None) -> None:
    """Phase repro (module docstring): every check prints the count of
    tensors that differ between repeats and the largest difference; the
    phase fails after all have run if any differs."""
    import dataclasses

    from hosnerf_tpu_torch.data import synthetic
    from hosnerf_tpu_torch.data.batches import to_device
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.models.state import state_index
    from hosnerf_tpu_torch.tools import grad_parity
    from hosnerf_tpu_torch.train import stage1, stage2, stage3
    t0 = time.time()
    fails = [] if fails is None else fails
    with torch.no_grad():
        repro_kernels(torch, ti, fails)
    print(f"phase repro: kernels {time.time() - t0:.1f} s", flush=True)
    lp = lpips.load_weights(lpips.LPIPS(device=device)).requires_grad_(False)

    def human_build(cfg):
        def build(seed):
            model, opt = stage2.init_state(cfg, seed=seed, device=device)
            return ({"human": model}, opt,
                    stage2.make_train_step(cfg, model, opt, lpips_apply=lp))
        return build

    def stage3_build(seed):
        scene, human, opt = stage3.init_state(cfg3, seed=seed, device=device)
        return ({"scene": scene, "human": human}, opt,
                stage3.make_train_step(cfg3, scene, human, opt,
                                       lpips_apply=lp))

    def stage1_build(seed):
        model, opt = stage1.init_state(cfg1, seed=seed, device=device)
        return ({"scene": model}, opt,
                stage1.make_train_step(cfg1, model, opt, [0.5]))

    cfg2 = stage2.Stage2Config(**REPRO_HUMAN)
    cfg3 = stage3.Stage3Config(**REPRO_STAGE3)
    cfg1 = stage1.Stage1Config(**REPRO_SCENE)
    hb = train_batch(torch, device, cfg2.n_patches, cfg2.patch_size,
                     cfg2.mweight_volume_size)
    cb = to_device(synthetic.composed_batch(
        cfg3.n_patches, cfg3.patch_size,
        grid_size=cfg3.mweight_volume_size), device)
    sb = to_device(synthetic.scene_ray_batch(REPRO_RAYS, time=0.7), device)
    with tempfile.TemporaryDirectory() as root:
        t1 = time.time()
        repro_training(torch, human_build(cfg2), hb, root, "stage 2 sorted",
                       fails, True, TRAIN_ITER)
        repro_training(torch, human_build(dataclasses.replace(
            cfg2, sparse=False)), hb, root, "stage 2 dense", fails, False,
            TRAIN_ITER)
        repro_training(torch, stage3_build, cb, root, "stage 3 cell", fails,
                       True, TRAIN_ITER)
        repro_training(torch, stage1_build, sb, root, "stage 1", fails,
                       False)
        print(f"phase repro: steps {time.time() - t1:.1f} s", flush=True)
    del lp
    torch.cuda.empty_cache()

    t1 = time.time()
    worst = []
    for _ in range(2):
        rels, bad = grad_parity.run(device=device, **REPRO_PARITY)
        check(not bad and bool(rels), f"repro: grad_parity at 8 patches: "
              f"{bad}")
        worst.append(rels[0])
        torch.cuda.empty_cache()
    print(f"phase repro: grad_parity at 8 patches, worst rel max-diff "
          f"{worst[0][0]:.6e} ({worst[0][1]}) then {worst[1][0]:.6e} "
          f"({worst[1][1]}) ({time.time() - t1:.1f} s)", flush=True)
    if worst[0] != worst[1]:
        fails.append(f"grad_parity at 8 patches: worst {worst[0]} then "
                     f"{worst[1]}")

    # the stage-3 batch's 2,048 rays: one chunk of the composed render
    scene, human, _ = stage3.init_state(cfg3, seed=0, device=device)
    state = state_index(cb["time"], None)

    def chunk():
        out = stage3.composed_forward(cfg3, scene, human, cb, ITER, state)
        return [{k: v for k, v in o.items() if torch.is_tensor(v)}
                for o in out]

    with torch.no_grad():
        repro_calls("one composed render chunk", chunk, fails, 2)
    del scene, human
    torch.cuda.empty_cache()
    print(f"phase repro: {time.time() - t0:.1f} s", flush=True)
    check(not fails, "repro: " + "; ".join(fails))


# ---------------------------------------------------------------------------
# the host data pipeline and the three trainers it feeds
# ---------------------------------------------------------------------------

def mean_ms(fn, reps: int) -> float:
    """Host-clock ms per call of fn over `reps` calls."""
    t0 = time.time()
    for _ in range(reps):
        fn()
    return (time.time() - t0) * 1e3 / reps


def write_png_avg_paeth(path, img):
    """`img` (uint8 [H, W] gray or [H, W, 3] BGR) as a PNG whose rows
    alternate filters 3 (Average) and 4 (Paeth), the filters an adaptive
    encoder (libpng, so cv2.imwrite) picks for most rows of a photograph.
    One such row sends imgproc's reader down its anti-diagonal sweep."""
    import struct
    import zlib

    import numpy as np

    from hosnerf_tpu_torch.data import imgproc
    px = img[..., None] if img.ndim == 2 else img[..., ::-1]   # RGB
    h, w, bpp = px.shape
    x = px.reshape(h, w * bpp).astype(np.int32)
    left = np.pad(x, ((0, 0), (bpp, 0)))[:, :-bpp]
    up = np.pad(x, ((1, 0), (0, 0)))[:-1]
    upleft = np.pad(up, ((0, 0), (bpp, 0)))[:, :-bpp]
    paeth = imgproc._paeth(left, up, upleft)
    kind = np.where(np.arange(h) % 2 == 0, 3, 4)[:, None]
    filt = (x - np.where(kind == 3, (left + up) >> 1, paeth)) & 255
    rows = np.concatenate([kind, filt], 1).astype(np.uint8)
    hdr = struct.pack(">IIBBBBB", w, h, 8, 0 if bpp == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(imgproc.PNG_SIGNATURE + imgproc._chunk(b"IHDR", hdr)
                + imgproc._chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + imgproc._chunk(b"IEND", b""))


def data_phase(torch, device, root, frames=DATA_FRAMES, res=DATA_RES):
    """Write a mini capture with the port's writer, re-encode its PNGs with
    Average and Paeth rows as a real capture's are, load it with the scene
    loader (which writes cameras_scaleworld.pkl) and HumanDataset (train
    mode, and with scaled-world background rays), and time the per-batch
    host costs a training loop pays: a PNG decode (both encodings), the
    scene load, a ScenePipeline batch of LitData.batch_size rays (with the
    image's rays built, as on nearly every batch of a capture with more
    train images than the pipeline's 8-image ray cache, and from that
    cache), a HumanDataset item and to_device. Returns the capture's
    objects."""
    import json

    import numpy as np

    from hosnerf_tpu_torch.config import ginlite
    from hosnerf_tpu_torch.data import (batches, human_dataset, imgproc,
                                        scene_loader, scene_pipeline,
                                        synthetic)
    gin = ginlite.parse_config_files_and_bindings(
        [os.path.join(REPO, "configs", "Backpack.gin")], warn_unknown=False)
    rays = int(gin["LitData.batch_size"])
    path = os.path.join(root, "cap")
    t0 = time.time()
    synthetic.write_mini_dataset(path, n_frames=frames, res=res,
                                 n_transitions=1, seed=0)
    write_s = time.time() - t0
    png_ms = {}
    for d, shape in (("images", (res, res, 3)), ("masks", (res, res))):
        files = [os.path.join(path, d, f)
                 for f in sorted(os.listdir(os.path.join(path, d)))]
        t0 = time.time()
        decoded = [imgproc.imread_png(f) for f in files]
        png_ms[d, 0] = (time.time() - t0) * 1e3 / len(files)
        check(len(files) == frames
              and all(x.shape == shape for x in decoded),
              f"data: decoded {d}: {len(files)} of {decoded[0].shape}")
        for f, x in zip(files, decoded):
            write_png_avg_paeth(f, x)
        t0 = time.time()
        again = [imgproc.imread_png(f) for f in files]
        png_ms[d, 34] = (time.time() - t0) * 1e3 / len(files)
        check(all(np.array_equal(a, b) for a, b in zip(again, decoded)),
              f"data: {d} re-encoded with Average/Paeth rows decode to "
              "other pixels")
    t0 = time.time()
    scene = scene_loader.load_nerf_360_v2(
        root, "cap", near=gin.get("LitDataNeRF360V2.near", 0.1),
        far=gin.get("LitDataNeRF360V2.far", 1e6))
    load_s = time.time() - t0
    check(scene.images.shape == (frames, res, res, 3)
          and os.path.exists(os.path.join(path, "cameras_scaleworld.pkl")),
          f"data: scene images {scene.images.shape}, scaled-world cameras")
    with open(os.path.join(path, "transitions_times.json")) as f:
        transitions = np.array([v["time"] for v in json.load(f).values()],
                               np.float32)
    pipe = scene_pipeline.ScenePipeline(
        scene, rays, seed=0,
        batch_sampler=str(gin.get("LitData.batch_sampler", "single_image")))
    def uncached():
        pipe._ray_cache.clear()
        return pipe.sample_train_batch()

    batch_ms = mean_ms(uncached, 10)
    nb = pipe.sample_train_batch()
    cached_ms = mean_ms(pipe.sample_train_batch, 20)
    check(nb["rays_o"].shape == (rays, 3) and nb["target"].shape == (rays, 3)
          and all(np.isfinite(v).all() for v in nb.values()),
          "data: ScenePipeline batch")
    ds = human_dataset.HumanDataset(path, mode="train", seed=0)
    ds3 = human_dataset.HumanDataset(path, mode="train", seed=0,
                                     use_scaleworld=True)
    item_ms = mean_ms(lambda: ds[0], 4)
    item3_ms = mean_ms(lambda: ds3[0], 4)
    item = ds3[1]
    check(item["rays_o_bkg"].shape == item["rays_o"].shape == (2048, 3)
          and all(np.isfinite(v).all() for v in item.values()
                  if isinstance(v, np.ndarray)),
          "data: HumanDataset item with scaled-world rays")
    torch.cuda.synchronize()
    to_dev_ms = mean_ms(lambda: batches.to_device(nb, device), 10)
    item_dev_ms = mean_ms(lambda: batches.to_device(item, device), 10)
    torch.cuda.synchronize()
    print(f"phase data: wrote a {frames}-frame {res}x{res} capture in "
          f"{write_s:.2f} s; PNG decode per {res}x{res} RGB image "
          f"{png_ms['images', 34]:.2f} ms with Average/Paeth rows (as "
          f"captures are written; {png_ms['images', 0]:.2f} ms with row "
          f"filter 0), per gray mask {png_ms['masks', 34]:.2f} ms "
          f"({png_ms['masks', 0]:.2f} ms), {frames} each; the capture "
          f"re-encoded with Average/Paeth rows for what follows; scene "
          f"load {load_s:.2f} s; ScenePipeline.sample_train_batch "
          f"{batch_ms:.2f} ms per {rays} rays ({pipe.batch_sampler}, the "
          f"image's rays built: a capture with more train images than the "
          f"8-image ray cache; {cached_ms:.2f} ms from the cache); "
          f"HumanDataset train item {item_ms:.2f} ms ({ds.n_patches} "
          f"patches of {ds.patch_size}x{ds.patch_size}), with scaled-world "
          f"rays {item3_ms:.2f} ms; to_device {to_dev_ms:.3f} ms (stage-1 "
          f"batch), {item_dev_ms:.3f} ms (human item); transitions "
          f"{transitions.tolist()}", flush=True)
    return {"gin": gin, "scene": scene, "pipe": pipe, "ds": ds, "ds3": ds3,
            "transitions": transitions}


def fed_steps(torch, steps: int, next_batch, run_step):
    """`steps` steps, each on a fresh batch from next_batch() (host work:
    sampling or loading, then to_device), after a synchronisation and up
    to one. Returns (wall s, host s spent in next_batch, outputs)."""
    torch.cuda.synchronize()
    t0, host, outs = time.time(), 0.0, []
    for i in range(steps):
        tb = time.time()
        batch = next_batch()
        host += time.time() - tb
        outs.append(run_step(batch, i))
    torch.cuda.synchronize()
    return time.time() - t0, host, outs


def stage1_phase(torch, device, kind, cap, cfg=None, steps=STAGE1_STEPS):
    """The stage-1 trainer (`train/stage1.py`) configured as the JAX CLI
    configures it from configs/Backpack.gin, read by the port's ginlite:
    from the file the rays per batch, sampler, near, far, max_steps and
    grad_max_norm; the MLP widths and sample counts, which the file does
    not set, are the CLI's defaults (NeRF 1024, proposal 256, 64 and 32
    samples). bf16 trunks: one warm-up step, then `steps` timed steps on
    fresh pipeline batches, each with the image's rays built (the ray
    cache cleared, as a capture with more than 8 train images misses it),
    one profiled step, the loss on a fixed batch before and after, and the
    eval step on one chunk. Returns (the model, (ms/step with the
    batches' host time, without))."""
    from hosnerf_tpu_torch.data import batches
    from hosnerf_tpu_torch.models.scene import RGB_PADDING
    from hosnerf_tpu_torch.train import stage1
    gin, pipe, trans = cap["gin"], cap["pipe"], cap["transitions"]
    cfg = cfg or stage1.Stage1Config(
        max_steps=int(gin.get("run.max_steps", 500_000)),
        near=float(gin.get("LitDataNeRF360V2.near", 0.1)),
        far=float(gin.get("LitDataNeRF360V2.far", 1e6)),
        grad_max_norm=float(gin.get("run.grad_max_norm", 0.001)),
        num_states=len(trans) + 1,
        nerf_netwidth=int(gin.get("NeRFMLP.netwidth", 1024)),
        prop_netwidth=int(gin.get("PropMLP.netwidth", 256)),
        num_prop_samples=int(gin.get("MipNeRF360.num_prop_samples", 64)),
        num_nerf_samples=int(gin.get("MipNeRF360.num_nerf_samples", 32)),
        compute_dtype="bf16")
    rays = pipe.batch_size
    model, opt = stage1.init_state(cfg, seed=0, device=device)
    step = stage1.make_train_step(cfg, model, opt, trans)
    loss_fn = stage1.make_loss_fn(cfg, model, trans)
    gen = torch.Generator(device).manual_seed(7)
    fixed = batches.to_device(pipe.sample_train_batch(), device)

    def next_batch():
        pipe._ray_cache.clear()
        return batches.to_device(pipe.sample_train_batch(), device)

    with torch.no_grad():
        before = float(loss_fn(fixed, 0)[0])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = step(next_batch(), 0, gen)
    wall, host, outs = fed_steps(torch, steps, next_batch,
                                 lambda b, i: step(b, i + 1, gen))
    peak = torch.cuda.max_memory_allocated()
    for i, aux in enumerate([first] + outs):
        check(all(bool(torch.isfinite(v)) for v in aux.values()),
              f"stage1 step {i}: non-finite losses {aux}")
    with torch.no_grad():
        after = float(loss_fn(fixed, 0)[0])
    ms, fed_ms = wall * 1e3 / steps, (wall - host) * 1e3 / steps
    print(f"phase stage1: {steps} steps of {rays} rays x "
          f"{cfg.num_prop_samples}/{cfg.num_prop_samples}/"
          f"{cfg.num_nerf_samples} samples, NeRF MLP 8x{cfg.nerf_netwidth}, "
          f"proposal MLPs 4x{cfg.prop_netwidth}, {cfg.num_levels} levels, "
          f"{cfg.num_states} states, grad_max_norm {cfg.grad_max_norm}, "
          f"compute_dtype bf16 (as the stage-3 cell), sampler "
          f"{pipe.batch_sampler} (Backpack.gin; widths and samples the "
          f"CLI's defaults), each batch's image rays built: {ms:.2f} "
          f"ms/step, {rays * steps / wall:.0f} rays/s on {kind}; without "
          f"the batches' host time ({host * 1e3:.2f} ms in all) "
          f"{fed_ms:.2f} ms/step, "
          f"{rays * steps / (wall - host):.0f} rays/s; peak device memory "
          f"{peak / 2 ** 30:.3f} GiB ({peak} bytes)", flush=True)
    print("stage1 losses: " + " ".join(f"{float(a['loss']):.6f}"
                                       for a in [first] + outs)
          + f"; fixed batch before {before:.6f} after {after:.6f}",
          flush=True)
    check(after < before, f"stage1: the fixed batch's loss did not drop "
          f"({before} -> {after})")
    profile_groups(torch, "one stage-1 step",
                   lambda: step(next_batch(), steps + 1, gen), ms)

    i = int(pipe.scene.i_split[2][0])
    chunk = batches.to_device(next(pipe.eval_image_batches(i, rays)),
                              device)
    rgb = stage1.make_eval_step(cfg, model, trans)(chunk)
    torch.cuda.synchronize()
    lo, hi = float(rgb.min()), float(rgb.max())
    print(f"stage1 eval chunk of image {i}: {tuple(rgb.shape)} rgb in "
          f"[{lo:.4f}, {hi:.4f}]", flush=True)
    check(rgb.shape == (rays, 3) and bool(torch.isfinite(rgb).all())
          and lo >= -RGB_PADDING and hi <= 1.0 + RGB_PADDING,
          f"stage1 eval: rgb {tuple(rgb.shape)} in [{lo}, {hi}] (the MLP's "
          f"colour padding {RGB_PADDING} allows that much outside [0, 1])")
    return model, (ms, fed_ms)


def stage2_data_step(torch, device, lp, cap, cfg=None):
    """The stage-2 step configured as the JAX CLI configures it from
    configs/default.yaml, read by the port's yamlcfg: the patches (2 of
    32) and samples (128) from the file; G = 32, CanonicalMLP 256 and
    NonRigidMLP 128, which the file does not set, are the CLI's defaults.
    bf16 trunks, the capture's states: (cfg, step, dataset, jitter
    generator factory)."""
    from hosnerf_tpu_torch.config import yamlcfg
    from hosnerf_tpu_torch.train import stage2
    trans = cap["transitions"]
    y = yamlcfg.load_yaml(os.path.join(REPO, "configs", "default.yaml"))
    cfg = cfg or stage2.Stage2Config(
        num_states=len(trans) + 1,
        n_patches=int(y.get("patch", {}).get("N_patches", 2)),
        patch_size=int(y.get("patch", {}).get("size", 32)),
        n_samples=int(y.get("N_samples", 128)),
        cnl_mlp_width=int(y.get("canonical_mlp", {}).get("mlp_width", 256)),
        nr_mlp_width=int(y.get("non_rigid_motion_mlp", {}).get("mlp_width",
                                                               128)),
        mweight_volume_size=int(y.get("mweight_volume", {}).get(
            "volume_size", 32)),
        compute_dtype="bf16")
    model, opt = stage2.init_state(cfg, seed=0, device=device)
    step = stage2.make_train_step(cfg, model, opt, trans, lp)
    return cfg, step, cap["ds"], lambda: torch.Generator(device).manual_seed(
        11)


def stage3_data_step(torch, device, lp, cap, scene_sd=None, cfg=None):
    """The stage-3 cell's step, Stage3Config(n_patches=2,
    compute_dtype="bf16") with the capture's states, its scene
    warm-started from `scene_sd`: (cfg, step, scaled-world dataset, CPU
    jitter generator factory)."""
    from hosnerf_tpu_torch.train import stage3
    trans = cap["transitions"]
    cfg = cfg or stage3.Stage3Config(n_patches=2, compute_dtype="bf16",
                                     num_states=len(trans) + 1)
    scene, human, opt = stage3.init_state(cfg, seed=0, device=device)
    if scene_sd is not None:
        scene.load_state_dict(scene_sd, strict=True)
    step = stage3.make_train_step(cfg, scene, human, opt, trans, lp)
    return cfg, step, cap["ds3"], lambda: torch.Generator().manual_seed(11)


def data_train_phase(torch, device, kind, label, built, steps, note=""):
    """A stage-2 or stage-3 step (`built`: cfg, step, dataset, jitter) on
    HumanDataset train items moved by to_device: one warm-up step, then
    `steps` timed steps on fresh items with B1-B5's launches counted and
    held to PER_STEP, every loss finite. Returns (ms/step with the items'
    host time, without)."""
    from hosnerf_tpu_torch.data import batches
    cfg, step, ds, jitter = built
    check(ds.n_patches == cfg.n_patches and ds.patch_size == cfg.patch_size,
          f"{label}: items of {ds.n_patches} patches of {ds.patch_size}, "
          f"config {cfg.n_patches} of {cfg.patch_size}")
    rays = cfg.n_patches * cfg.patch_size ** 2
    order = iter(range(1, 10 ** 6))

    def next_batch():
        return batches.to_device(ds[next(order) % len(ds)], device)

    first = step(next_batch(), TRAIN_ITER, jitter())
    torch.cuda.synchronize()
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    wall, host, outs = fed_steps(
        torch, steps, next_batch, lambda b, i: step(b, TRAIN_ITER, jitter()))
    launches = {k: w.launches for k, w in wrappers.items()}
    ms, fed_ms = wall * 1e3 / steps, (wall - host) * 1e3 / steps
    print(f"phase {label}: {steps} steps of {rays} rays x {cfg.n_samples} "
          f"samples on fresh HumanDataset items{note}, bf16 trunks: "
          f"{ms:.2f} ms/step, {rays * steps / wall:.0f} rays/s on {kind}; "
          f"without the items' host time ({host * 1e3:.2f} ms in all) "
          f"{fed_ms:.2f} ms/step; launches "
          + " ".join(f"{k}={v}" for k, v in launches.items()), flush=True)
    for k, n in launches.items():
        per = PER_STEP.get(k, 0)
        check(n == per * steps, f"{label}: {k} launched {n} times in "
              f"{steps} steps (expected {per} per step)")
    for i, ls in enumerate([first] + outs):
        check(all(bool(torch.isfinite(v)) for v in ls.values()),
              f"{label} step {i}: non-finite losses {ls}")
    print(f"{label} losses: " + " ".join(f"{float(x['loss']):.6f}"
                                         for x in [first] + outs),
          flush=True)
    return ms, fed_ms


# ---------------------------------------------------------------------------
# the command line: train, checkpoint, resume and evaluate all three stages
# ---------------------------------------------------------------------------

# steps of each stage's first run (prefetch 2) and of its resumed run
# (prefetch 0); progress.dump_interval of the stage-2 run; val_every of
# the stage-1 run; metrics.jsonl every CLI_LOG_EVERY steps; the profiled
# steps of the prefetched stage-2 run
CLI_STEPS = {"scene": (30, 45), "human": (30, 45), "hosnerf": (20, 30)}
CLI_DUMP, CLI_VAL, CLI_LOG_EVERY = 25, 20, 5
CLI_PROFILE = (10, 12)


class cli_hooks:
    """Inside the block: every `loop.run_training` call of the CLI takes
    `overrides` (log_every, prefetch, val_every, profile_steps);
    `restore_train_state` packs what it restored and holds it to the file
    it read, bit for bit (models, Adam's state, opt.updates, the
    generator); `render_human_image` is timed per image (synchronised by
    its copy to the host) into `render_ms`, by image size."""

    def __init__(self, torch):
        from hosnerf_tpu_torch.eval import renderers
        from hosnerf_tpu_torch.train import checkpoints as ck
        from hosnerf_tpu_torch.train import loop
        self.torch, self.loop, self.ck, self.rend = torch, loop, ck, renderers
        self.overrides, self.restored, self.render_ms = {}, [], {}

    def __enter__(self):
        self.saved = (self.loop.run_training, self.ck.restore_train_state,
                      self.rend.render_human_image)
        run_training, restore, render = self.saved

        def run_training_hook(**kw):
            return run_training(**{**kw, **self.overrides})

        def restore_hook(ckpt_dir, name, models, optimizer=None,
                         generator=None):
            step = restore(ckpt_dir, name, models, optimizer, generator)
            state = self.ck.pack_train_state(models, optimizer, step,
                                             generator)
            self.restored.append((name, not self.ck.state_diff(
                state, self.ck.restore_checkpoint(ckpt_dir, name))))
            return step

        def render_hook(render_fn, item, device, *a, **kw):
            t0 = time.time()
            img = render(render_fn, item, device, *a, **kw)
            self.render_ms.setdefault(img.shape[:2], []).append(
                (time.time() - t0) * 1e3)
            return img

        self.loop.run_training = run_training_hook
        self.ck.restore_train_state = restore_hook
        self.rend.render_human_image = render_hook
        return self

    def __exit__(self, *exc):
        (self.loop.run_training, self.ck.restore_train_state,
         self.rend.render_human_image) = self.saved


def metrics_records(logdir: str):
    with open(os.path.join(logdir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def cli_ms_per_step(records, lo: int, hi: int, evals=(),
                    profiled=()) -> float:
    """Mean ms/step of the logged intervals of the run over steps
    [lo, hi): the record of step r covers steps r - CLI_LOG_EVERY + 1 ..
    r and what ran after the log of step r - CLI_LOG_EVERY. Left out: the
    run's first record (start-up and its first step), those holding an
    eval (run after the log of a step in `evals`) or a profiled step."""
    L = CLI_LOG_EVERY
    recs = [r for r in records if lo < r["step"] < hi
            and not any(r["step"] - L <= k < r["step"] for k in evals)
            and not any(r["step"] - L < k <= r["step"] for k in profiled)]
    check(recs, f"no timed interval in steps {lo}..{hi}")
    return 1e3 * sum(r["sec_per_step"] for r in recs) / len(recs)


def trace_busy_ms(path: str) -> float:
    """Device time (kernels, copies, fills) in a chrome trace, ms."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(e.get("dur", 0) for e in events
               if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
               ) / 1e3


def finite_results(path: str, what: str):
    """The results*.json at `path`, every psnr/ssim/lpips entry a finite
    number."""
    import math
    with open(path) as f:
        res = json.load(f)
    vals = []
    for entry in res:   # stage 1: a dict by split per metric
        if set(entry) & {"train", "val", "test"}:
            vals += list(entry.values())
        vals += [entry[k] for k in ("psnr", "ssim", "lpips") if k in entry]
    check(vals and all(isinstance(v, (int, float)) and math.isfinite(v)
                       for v in vals), f"{what}: results {res}")
    return res


def torch_defaults(torch) -> None:
    """torch's own library defaults (TF32 convolutions, cuDNN free to pick
    non-deterministic algorithms): phase cli puts them back before each
    command, so that the CLI is checked under the settings it sets itself
    and not under this script's."""
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = False
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False


def cli_phase(torch, kind, root, fed, extra_args=(), yaml_extra=""):
    """The port's CLI in-process (`cli.run.main`) on the data phase's
    capture (<root>/cap, 16 frames of 512 x 512, Average/Paeth PNGs) at
    the production widths: stage 1 from configs/Backpack.gin, stages 2
    and 3 from configs/default.yaml, both with the CLI's defaults for
    what the files do not set. Scene: train (val once), resume with
    prefetch 0, eval; human: train (a progress eval once, steps profiled),
    resume with prefetch 0, eval; hosnerf: train from the two stages'
    last.pt, resume with prefetch 0, eval; torch's defaults put back
    before each command (`torch_defaults`), the card settings read after
    it held to `configure()`'s. `fed`: the data phases'
    {stage: (ms/step with the items, without)}. A CPU rehearsal adds
    `extra_args` to every command (--device cpu, --ginb size bindings)
    and `yaml_extra` to the two yaml files (smaller sizes)."""
    import math

    from hosnerf_tpu_torch.cli import run as cli
    from hosnerf_tpu_torch.utils import card
    t_phase = time.time()
    expected = card.configure()
    logbase = os.path.join(root, "logs")
    gin = os.path.join(REPO, "configs", "Backpack.gin")
    default_yaml = os.path.join(REPO, "configs", "default.yaml")
    render_block = ("render:\n  freeview_frames: 0\n  tpose_views: 4\n"
                    "  tpose_resolution: 256\n")
    for name, dump in (("human", CLI_DUMP), ("hosnerf", 10 ** 6)):
        with open(os.path.join(root, f"{name}.yaml"), "w") as f:
            f.write(f"basedir: '{root}'\nprogress:\n  dump_interval: "
                    f"{dump}\n" + render_block + yaml_extra)
    common = ["--scene_name", "cap", "--logbase", logbase]
    args = {
        "scene": ["--stage", "scene", "--ginc", gin, "--ginb",
                  f'run.datadir = "{root}"'] + common,
        "human": ["--stage", "human", "--cfg",
                  os.path.join(root, "human.yaml"), "--default_cfg",
                  default_yaml] + common,
        "hosnerf": ["--stage", "hosnerf", "--ginc", gin, "--ginb",
                    f'run.datadir = "{root}"', "--cfg",
                    os.path.join(root, "hosnerf.yaml"), "--default_cfg",
                    default_yaml] + common}
    wrappers = launch_counts()
    hooks = cli_hooks(torch)
    times, launches = {}, {}

    def main(stage, *extra, overrides=None):
        hooks.overrides = {"log_every": CLI_LOG_EVERY, **(overrides or {})}
        for w in wrappers.values():
            w.launches = 0
        torch_defaults(torch)
        t0 = time.time()
        cli.main(args[stage] + list(extra) + list(extra_args))
        torch.cuda.synchronize()
        got = card.settings()
        check(got == expected, f"cli {stage} {' '.join(extra)}: the card "
              f"settings after the command {got}, configure() gives "
              f"{expected}")
        return time.time() - t0, {k: w.launches for k, w in
                                  wrappers.items()}

    with hooks:
        for stage in ("scene", "human", "hosnerf"):
            first, second = CLI_STEPS[stage]
            extra = []
            if stage == "hosnerf":
                extra = ["--bkgd_path", os.path.join(
                    logbase, "scene_cap", "ckpt", "last.pt"),
                    "--human_path", os.path.join(
                        logbase, "human_cap", "ckpt", "last.pt")]
            over = {"prefetch": 2}
            if stage == "scene":
                over["val_every"] = CLI_VAL
            if stage == "human":
                over["profile_steps"] = CLI_PROFILE
            times[stage, "train"], launches[stage, "train"] = main(
                stage, "--run_mode", "train", "--max_steps", str(first),
                *extra, overrides=over)
            n_restored = len(hooks.restored)
            times[stage, "resume"], launches[stage, "resume"] = main(
                stage, "--run_mode", "train", "--max_steps", str(second),
                "--resume_training", "true", overrides={"prefetch": 0})
            check(len(hooks.restored) == n_restored + 1
                  and hooks.restored[-1][1],
                  f"cli {stage}: the restored train state differs from "
                  "the saved one")
            hooks.render_ms.clear()
            times[stage, "eval"], launches[stage, "eval"] = main(
                stage, "--run_mode", "eval")
            times[stage, "frames"] = dict(hooks.render_ms)

    logdir = {s: os.path.join(logbase, f"{s}_cap") for s in CLI_STEPS}
    ms = {}
    for stage, (first, second) in CLI_STEPS.items():
        recs = metrics_records(logdir[stage])
        check(all(math.isfinite(r["loss"]) for r in recs),
              f"cli {stage}: a non-finite loss in metrics.jsonl")
        resumed = [r for r in recs if r["step"] == first]
        check(resumed and math.isfinite(resumed[0]["loss"]),
              f"cli {stage}: the first resumed step's loss")
        evals = {"scene": (CLI_VAL,), "human": (CLI_DUMP,)}.get(stage, ())
        profiled = (range(CLI_PROFILE[0], CLI_PROFILE[1] + 1)
                    if stage == "human" else ())
        ms[stage] = (cli_ms_per_step(recs, 0, first, evals, profiled),
                     cli_ms_per_step(recs, first, second))
        state = hooks.ck.restore_checkpoint(
            os.path.join(logdir[stage], "ckpt"), "last")
        check(state["step"] == second and state["updates"] == second,
              f"cli {stage}: last.pt at step {state['step']}, "
              f"{state['updates']} updates (expected {second})")
    for stage in ("human", "hosnerf"):
        first, second = CLI_STEPS[stage]
        got = launches[stage, "resume"]
        for k, per in PER_STEP.items():
            check(got[k] == per * (second - first),
                  f"cli {stage} resumed run: {k} launched {got[k]} times in "
                  f"{second - first} steps (expected {per} per step)")
        got = launches[stage, "train"]
        for k in ("inverse_core_bwd", "fused_embed_trunk_bwd",
                  "shared_blend_fwd", "shared_blend_bwd"):
            check(got[k] == PER_STEP[k] * first,
                  f"cli {stage} first run: {k} launched {got[k]} times in "
                  f"{first} steps")
    check(os.path.exists(os.path.join(logdir["scene"], "ckpt", "best.pt")),
          "cli scene: val_fn saved no best.pt")
    check(os.path.exists(os.path.join(
        logdir["human"], f"results_prog_{CLI_DUMP:06d}.json")),
        "cli human: no progress eval")
    finite_results(os.path.join(logdir["scene"], "results.json"),
                   "cli scene eval")
    finite_results(os.path.join(logdir["human"],
                                f"results_prog_{CLI_DUMP:06d}.json"),
                   "cli human progress eval")
    for stage in ("human", "hosnerf"):
        res = finite_results(os.path.join(logdir[stage], "results.json"),
                             f"cli {stage} eval")
        check(len(res) == 2 and all(e["lpips"] is not None for e in res),
              f"cli {stage} eval: {res}")
    busy = trace_busy_ms(os.path.join(logdir["human"], "profile",
                                      "trace.json"))
    busy_step = busy / (CLI_PROFILE[1] - CLI_PROFILE[0] + 1)

    print(f"phase cli: the port's CLI in-process on the {DATA_FRAMES}-frame "
          f"{DATA_RES}x{DATA_RES} capture, {kind}; ms/step from "
          f"metrics.jsonl's sec_per_step (every {CLI_LOG_EVERY} steps, the "
          "first interval and those holding an eval left out):", flush=True)
    for stage, label in (("scene", "stage 1"), ("human", "stage 2"),
                         ("hosnerf", "stage 3")):
        first, second = CLI_STEPS[stage]
        note = ""
        if stage in fed:
            note = (f"; the data phase's fed steps {fed[stage][0]:.2f} "
                    f"ms/step with the items, {fed[stage][1]:.2f} without")
        print(f"phase cli: {label} ({stage}) {ms[stage][0]:.2f} ms/step "
              f"with prefetch 2 (steps 0-{first - 1}), {ms[stage][1]:.2f} "
              f"with prefetch 0 (resumed, steps {first}-{second - 1})"
              f"{note}; runs {times[stage, 'train']:.1f} s + "
              f"{times[stage, 'resume']:.1f} s, eval "
              f"{times[stage, 'eval']:.1f} s", flush=True)
    print(f"phase cli: prefetched stage-2 steps {CLI_PROFILE[0]}-"
          f"{CLI_PROFILE[1]} profiled: device busy {busy_step:.2f} ms/step, "
          f"idle share {1 - busy_step / ms['human'][0]:.3f} of the "
          f"prefetched {ms['human'][0]:.2f} ms/step", flush=True)
    for stage in ("human", "hosnerf"):
        frames = times[stage, "frames"]
        full = frames.get((DATA_RES, DATA_RES), [])
        check(full, f"cli {stage} eval: no {DATA_RES}x{DATA_RES} frame")
        print(f"phase cli: {stage} eval render {sum(full) / len(full):.2f} "
              f"ms per {DATA_RES}x{DATA_RES} frame ({len(full)} frames, "
              "render_human_image by host clock, the image on the host); "
              + ", ".join(f"{len(v)} frames of {h}x{w} at "
                          f"{sum(v) / len(v):.2f} ms"
                          for (h, w), v in frames.items()
                          if (h, w) != (DATA_RES, DATA_RES)), flush=True)
    print(f"phase cli: the card settings after each of the 9 commands "
          f"(torch's defaults put back before each) equal configure()'s: "
          f"{json.dumps(expected, sort_keys=True)}", flush=True)
    print("phase cli: restored train states equal the saved ones bit for "
          f"bit ({len(hooks.restored)} resumes: models, Adam exp_avg/"
          "exp_avg_sq/step, opt.updates, generator); B1-B5 launched in "
          "the resumed runs: "
          + "; ".join(f"{s} " + " ".join(f"{k}={launches[s, 'resume'][k]}"
                                         for k in PER_STEP)
                      for s in ("human", "hosnerf"))
          + "; no video written: freeview_frames 0 and 4 tpose views (the "
          "card machine has no video encoder, neither imageio nor cv2); "
          f"phase wall {time.time() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# data parallelism: ranks over gloo on the one card, NCCL at world size 1
# ---------------------------------------------------------------------------

def ddp_phase(torch, device, kind, card, ranks=DDP_RANKS, cfg=None,
              worker_device="cuda:0"):
    """Phase ddp (module docstring). `cfg`: Stage3Config field overrides
    for the workers (a CPU rehearsal: worker_device='cpu', PER_STEP
    zeroed)."""
    import torch.distributed as dist

    from hosnerf_tpu_torch import entry
    from hosnerf_tpu_torch.parallel import distributed
    t0 = time.time()
    reps = entry.dryrun_multidevice(
        ranks, backend="gloo", device=worker_device, size="cell",
        timeout=DDP_TIMEOUT, tol_loss=TOL_GRAD_LOSS, tol_grad=TOL_GRAD,
        tol_render=[TOL_RENDER_MAX, TOL_RENDER_MEAN], cfg=cfg or {})
    for r, rep in enumerate(reps):
        c, rd = rep["check"], rep["render"]
        print(f"phase ddp rank {r}: sharded vs one-rank stage-3 step loss "
              f"{c['loss_n']:.6f} vs {c['loss_1']:.6f} (|delta| "
              f"{c['loss_delta']:.3e}, tolerance {TOL_GRAD_LOSS}), worst "
              f"gradient rel L2 {c['max_grad_rel']:.3e} ({c['worst_param']}"
              f", tolerance {TOL_GRAD}), parameters equal on every rank "
              f"{c['params_equal']}; {rep['rays_per_rank']} rays per rank, "
              f"{rep['ms_per_step']:.2f} ms/step over 3 steps "
              f"(utils/benchtools.timeit_chain; the gradient all-reduce of "
              f"{rep['grad_numel']} values alone {rep['allreduce_ms']:.2f} "
              f"ms) on {kind} ({card}), "
              f"{ranks} ranks over gloo on one card; launches "
              + " ".join(f"{k}={v}" for k, v in rep["launches"].items())
              + f"; render chunk of {rd['rays']} rays error max "
              f"{rd['max_err']:.3e} mean {rd['mean_err']:.3e}", flush=True)
        check(c["params_equal"], f"ddp rank {r}: parameters differ")
        check(all(math.isfinite(v) for v in rep["losses"]),
              f"ddp rank {r}: non-finite losses {rep['losses']}")
        for k, n in rep["launches"].items():
            check(n == PER_STEP.get(k, 0) * 3, f"ddp rank {r}: {k} "
                  f"launched {n} times in 3 steps (expected "
                  f"{PER_STEP.get(k, 0)} per step)")

    # NCCL at world size 1: init and one all-reduce on the card
    if device.type == "cuda":
        with tempfile.TemporaryDirectory() as tmp:
            distributed.initialize(f"file://{tmp}/init", 1, 0,
                                   backend="nccl", device=device)
            try:
                x = torch.arange(1 << 20, device=device, dtype=torch.float32)
                dist.all_reduce(x)
                torch.cuda.synchronize()
                ok = (dist.get_backend() == "nccl" and bool(torch.equal(
                    x, torch.arange(1 << 20, device=device,
                                    dtype=torch.float32))))
            finally:
                distributed.shutdown()
        print(f"phase ddp: NCCL world-size-1 initialize + all-reduce of "
              f"{1 << 20} f32 on {device}: {'ok' if ok else 'WRONG'}",
              flush=True)
        check(ok, "NCCL world-size-1 all-reduce")

    xla_chunk_check(torch, device)
    print(f"phase ddp: {time.time() - t0:.1f} s wall on {kind} ({card})",
          flush=True)
    return reps


def xla_chunk_check(torch, device, G=32):
    """One human render chunk with lbs_impl='xla' (the one-hot LBS form)
    against the gather form, same model and tensors on `device`."""
    from hosnerf_tpu_torch.models.human import HumanObjectField
    from hosnerf_tpu_torch.models.state import state_index
    model = HumanObjectField(mweight_volume_size=G, compute_dtype="bf16",
                             lbs_impl="xla", seed=0, device=device).eval()
    b = chunk_batch(torch, frame_item(0, G), device)
    state = state_index(torch.tensor(0.5), None)
    with torch.no_grad():
        t0 = time.time()
        x = model(b, ITER, state)
        torch.cuda.synchronize() if device.type == "cuda" else None
        t_x = time.time() - t0
        model.lbs_impl = "gather"
        g = model(b, ITER, state)
    err = {k: float((x[k] - g[k]).abs().max())
           / max(float(g[k].abs().max()), 1e-30) for k in ("rgb", "alpha")}
    print(f"human render chunk of {b['rays_o'].shape[0]} rays, lbs_impl "
          f"'xla' (one-hot, {t_x * 1e3:.1f} ms) vs 'gather': error max "
          + " ".join(f"{k} {v:.3e}" for k, v in err.items())
          + f" of the largest value (tolerance {TOL_RENDER_MAX})",
          flush=True)
    check(all(v <= TOL_RENDER_MAX for v in err.values()),
          f"xla LBS render chunk disagrees with the gather form: {err}")
    del model


# ---------------------------------------------------------------------------
# the port's chip tools (hosnerf_tpu_torch/tools/)
# ---------------------------------------------------------------------------

# the convergence probe's steps per stage, held to the JAX curves' first
# window; grad_parity's patch counts; the 8-patch operating point; the
# runbook's budget per stage and its render block (the card machine has
# no video encoder: no freeview frames, 4 tpose views)
PROBE_STEPS = 1000
# the probe's stage 2 at seeds FIRST_SEEDS, one step each: the seeds whose
# field is dead after that step (no supported density above 0; 8 and 11
# are dead before it), as the CPU's plain path gives them (`python -m
# hosnerf_tpu_torch.tools.seed_sweep first --device cpu`, the module path
# alike; PERF.md); a forward without jitter before and after each step
# launches B1 once and B2 twice
FIRST_SEEDS = range(16)
DEAD_SEEDS = (2, 4, 6, 7, 8, 10, 11)
PER_FIELD_READ = {"inverse_core_pg_s": 1, "fused_embed_trunk": 2}
PARITY_PATCHES = (2, 8)
PARITY_FRESH = 2     # fresh-process runs at PARITY_PATCHES[-1]
# grad_parity's two passes each run row 1 and B4 once: the sorted path, and
# the dense path's quad core in its default 'sig' order
PARITY_INVERSE = {"inverse_core_pg_s": 2, "inverse_core_bwd": 2,
                  "inverse_core_pg": 0}
POINT_PATCHES = 8
RUNBOOK_STEPS = 5
RUNBOOK_YAML = ("progress:\n  dump_interval: 1000000\nrender:\n"
                "  freeview_frames: 0\n  tpose_views: 4\n"
                "  tpose_resolution: 256\n")


def probe_subphase(torch, device, path):
    """The convergence probe's loop at PROBE_STEPS steps per stage on the
    probe's capture, each stage held to the JAX curve's [500, 1000)
    window (at most BAND_DB below it), B1-B5 launched per stage-2 step as
    PER_STEP and none in stage 1."""
    from hosnerf_tpu_torch.tools import convergence_probe as cp
    jax_dir = os.path.join(REPO, "tools", "convergence")
    wrappers = launch_counts()
    for stage in cp.STAGES:
        for w in wrappers.values():
            w.launches = 0
        t0 = time.time()
        rec = cp.RUNNERS[stage](path, PROBE_STEPS, device)
        torch.cuda.synchronize()
        dt = time.time() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
        rows, ok = cp.compare(stage, rec["curve"],
                              cp.load_curve(jax_dir, stage))
        cp.print_table(stage, rows)
        print(f"phase tools: probe {stage}, {PROBE_STEPS} steps in "
              f"{dt:.1f} s ({dt * 1e3 / PROBE_STEPS:.2f} ms/step with the "
              f"batches); launches "
              + " ".join(f"{k}={v}" for k, v in launches.items()),
              flush=True)
        check(bool(rows) and rows[0][0] == cp.WINDOWS[0] and ok,
              f"probe {stage}: more than {cp.BAND_DB} dB below the JAX "
              f"curve: {rows}")
        per = PER_STEP if stage == "stage2" else {}
        for k, n in launches.items():
            check(n == per.get(k, 0) * PROBE_STEPS, f"probe {stage}: {k} "
                  f"launched {n} times in {PROBE_STEPS} steps (expected "
                  f"{per.get(k, 0)} per step)")


def first_step_subphase(torch, device, path):
    """The probe's first stage-2 step at each of FIRST_SEEDS on the kernel
    path (`tools/seed_sweep.py`): the share of supported samples with
    density > 0 and the accumulated alpha before and after it; the seeds
    whose field it kills equal DEAD_SEEDS; B1-B5 launched per seed as one
    step and two reads of the field."""
    from hosnerf_tpu_torch.tools import seed_sweep
    wrappers = launch_counts()
    for w in wrappers.values():
        w.launches = 0
    recs = seed_sweep.first_steps(FIRST_SEEDS, device, capture=path)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items() if w.launches}
    dead = seed_sweep.dead_seeds(recs)
    print(f"phase tools: first steps, seeds {list(FIRST_SEEDS)}: dead at "
          f"step 0 {dead} (the CPU's plain path: {list(DEAD_SEEDS)}); "
          "launches " + " ".join(f"{k}={v}" for k, v in launches.items()),
          flush=True)
    check(all(math.isfinite(r["loss"]) for r in recs),
          "first steps: a loss is not finite")
    check(tuple(dead) == DEAD_SEEDS, f"first steps: the card's dead seeds "
          f"{dead} differ from the CPU's {list(DEAD_SEEDS)}")
    n = len(FIRST_SEEDS)
    want = {k: n * (PER_STEP.get(k, 0) + 2 * PER_FIELD_READ.get(k, 0))
            for k in set(PER_STEP) | set(PER_FIELD_READ)}
    check(launches == want, f"first steps: launches {launches}, expected "
          f"{want}")


def runbook_subphase(torch, root):
    """The parity runbook (a subprocess, as a user runs it) at
    RUNBOOK_STEPS steps per stage on the probe's capture <root>/mini, at
    the production sizes of configs/Backpack.gin and default.yaml: every
    stage's metrics in PARITY_RUN.md finite."""
    import math
    with open(os.path.join(REPO, "configs", "default.yaml")) as f:
        yaml = f.read()
    cfg = os.path.join(root, "runbook.yaml")
    with open(cfg, "w") as f:
        f.write(yaml + "\n" + RUNBOOK_YAML)
    logbase = os.path.join(root, "parity")
    res = subprocess.run(
        [sys.executable, "-m", "hosnerf_tpu_torch.tools.parity_runbook",
         "--datadir", root, "--scene", "mini", "--logbase", logbase,
         "--cfg", cfg] + [a for i in (1, 2, 3)
                          for a in (f"--steps{i}", str(RUNBOOK_STEPS))],
        cwd=REPO, capture_output=True, text=True, timeout=900)
    log = os.path.join(logbase, "runbook.log")
    if res.returncode != 0 and os.path.exists(log):
        with open(log) as f:
            print(f.read()[-4000:], file=sys.stderr)
    check(res.returncode == 0, f"parity runbook exited {res.returncode}: "
          f"{res.stderr[-2000:]}")
    with open(os.path.join(logbase, "PARITY_RUN.md")) as f:
        report = f.read()
    rows = [ln.split("|")[1:-1] for ln in report.splitlines()
            if ln.startswith("| ") and not ln.startswith("| stage")]
    print(report, flush=True)
    vals = [(r[0].strip(), r[2].strip(), float(r[3])) for r in rows]
    check({v[0] for v in vals} == {"scene", "human", "hosnerf"}
          and all(math.isfinite(v[2]) for v in vals),
          f"PARITY_RUN.md: a stage without metrics or a non-finite one: "
          f"{vals}")


def fresh_grad_parity(n_patches: int) -> tuple:
    """(worst rel max-diff, its parameter) of `python -m
    hosnerf_tpu_torch.tools.grad_parity --n_patches n` run as a fresh
    process: the tool sets the card's settings itself (this script's
    CUBLAS_WORKSPACE_CONFIG is not passed on)."""
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    res = subprocess.run(
        [sys.executable, "-m", "hosnerf_tpu_torch.tools.grad_parity",
         "--n_patches", str(n_patches)], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=600)
    check(res.returncode == 0, f"grad_parity --n_patches {n_patches} as a "
          f"fresh process exited {res.returncode}: {res.stdout[-2000:]}"
          f"{res.stderr[-2000:]}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("worst rel diff exact:")]
    check(len(line) == 1, f"grad_parity: no exact worst value in "
          f"{res.stdout[-2000:]}")
    value, name = line[0].split(":", 1)[1].split()
    return float(value), name


def tools_phase(torch, device, kind):
    """Phase tools (module docstring): the port's chip tools through their
    entry points, each sub-phase's wall time printed."""
    import math

    from hosnerf_tpu_torch.tools import common
    from hosnerf_tpu_torch.tools import convergence_probe as cp
    from hosnerf_tpu_torch.tools import (fg_density_study, grad_parity,
                                         memcheck_8patch, profile_step,
                                         time_step)
    t_phase = time.time()

    def done(what, t0):
        print(f"phase tools: {what} {time.time() - t0:.1f} s", flush=True)
        torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory() as root:
        path = cp.write_capture(root)
        t0 = time.time()
        probe_subphase(torch, device, path)
        done("convergence probe", t0)
        t0 = time.time()
        first_step_subphase(torch, device, path)
        done("first steps", t0)
        t0 = time.time()
        runbook_subphase(torch, root)
        done("parity runbook", t0)

    wrappers = launch_counts()
    worst = {}
    for n in PARITY_PATCHES:
        t0 = time.time()
        for w in wrappers.values():
            w.launches = 0
        rels, bad = grad_parity.run(n, device)
        inv = {k: wrappers[k].launches for k in PARITY_INVERSE}
        print(f"phase tools: grad_parity at {n} patches, sorted vs dense "
              f"stage-3 gradients, worst rel max-diff: "
              f"{grad_parity.top(rels)} (tolerance {grad_parity.TOL}); "
              f"problems {bad}; inverse-LBS launches {inv}", flush=True)
        check(not bad and bool(rels) and rels[0][0] <= grad_parity.TOL,
              f"grad_parity at {n} patches: {bad or rels[:1]}")
        worst[n] = rels[0]
        check(inv == PARITY_INVERSE, f"grad_parity at {n} patches: "
              f"inverse-LBS launches {inv}, expected {PARITY_INVERSE}")
        done(f"grad_parity {n}", t0)

    t0 = time.time()
    n = PARITY_PATCHES[-1]
    fresh = [fresh_grad_parity(n) for _ in range(PARITY_FRESH)]
    print(f"phase tools: grad_parity at {n} patches, worst rel max-diff in "
          f"this process {worst[n][0]!r} ({worst[n][1]}); as fresh "
          "processes " + ", ".join(f"{v!r} ({p})" for v, p in fresh),
          flush=True)
    check(all(f == worst[n] for f in fresh), f"grad_parity at {n} patches: "
          f"fresh processes {fresh} against this process's {worst[n]}")
    done(f"grad_parity {n} fresh processes", t0)

    for split in common.SPLITS:
        t0 = time.time()
        cfg = common.split_config(POINT_PATCHES, split)
        step, batch, _ = common.stage3_step(cfg, device)
        peak, loss0 = memcheck_8patch.peak_split(step, batch, device)
        for w in wrappers.values():
            w.launches = 0
        ms, loss = time_step.time_split(step, batch)
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        rays = cfg.n_patches * cfg.patch_size ** 2
        line = time_step.split_line(POINT_PATCHES, split, ms, loss, rays)
        print(f"phase tools: 8-patch point {line}  peak "
              f"{peak / 2 ** 30:.3f} GiB ({peak} bytes)  memcheck "
              f"loss {loss0:.6f} on {kind}; launches "
              + " ".join(f"{k}={v}" for k, v in launches.items()),
              flush=True)
        check(math.isfinite(loss) and math.isfinite(loss0),
              f"8-patch step {split}: non-finite loss {loss0}, {loss}")
        del step, batch
        done(f"8-patch point {split[0]}:{split[1]}", t0)

    t0 = time.time()
    cfg = common.stage3_config(2, remat="none")
    rows, (back, each, loss), (step, batch) = profile_step.components(
        cfg, device)
    busy, groups, glue = common.profile_groups(
        lambda: step(batch, 100.0, common.jitter(0)), device)
    print("phase tools: profile_step at 2 patches: "
          + "; ".join(f"{n} {ms:.2f} ms" for n, ms in rows)
          + f"; {profile_step.K} steps back to back {back:.2f} ms/step, "
          f"each synchronised {each:.2f}, host share {each - back:.2f} ms; "
          f"profiled step busy {busy:.3f} ms (idle share "
          f"{1 - busy / back:.3f}): "
          + "; ".join(f"{g} {ms:.3f}" for g, ms in groups.items()),
          flush=True)
    check(math.isfinite(loss), f"profile_step: non-finite loss {loss}")
    del step, batch
    done("profile_step", t0)

    t0 = time.time()
    fg = fg_density_study.study(2, device)
    print("phase tools: fg_density_study at 2 patches: "
          + "; ".join(f"{k} {v:.4f}" for k, v in fg.items()), flush=True)
    done("fg_density_study", t0)
    print(f"phase tools: {time.time() - t_phase:.1f} s", flush=True)


# ---------------------------------------------------------------------------
# phase bench tools: the JAX repo's remaining chip tools, ported
# ---------------------------------------------------------------------------

BENCH_ITERS, BENCH_WARMUP = 3, 1
BENCH_PATCHES = 2
# the decoder's phase form against its conv form, with the bounds of
# tests/test_torch_modules.py::PHASE_VS_CONV: (values' max error over their
# maximum, every parameter gradient's relative L2). f32: summation order
# only (products of K = 8 cin = 8,192 terms: the max error per gradient
# reaches ~6e-6 of its scale, H100, printed beside). bf16: each form's
# gradients sit 5-6% (rel L2) from the f32 ones on the CPU at volume 16,
# single entries up to 38% of the scale
DECONV_TOL = {"f32": (1e-5, 1e-5), "bf16": (1e-2, 1e-1)}
# the phase form on the card against itself on the CPU, with the bounds of
# tests/test_torch_modules.py::DECODER_TOL for the phase form against the
# JAX decoder: ((values: rtol, atol over the output's max), (gradients: max
# error and relative L2 over each gradient's scale)). Both devices multiply
# the same bf16-rounded operands in f32 (TF32 off), so a layer given the
# same input and cotangent differs in summation order only, and in bf16 by
# a value that lands within f32 noise of a rounding boundary (2^-8
# relative). bf16 is held layer by layer: through five layers such flips
# cascade, so that on the CPU alone an embedding moved by 1e-6 relative
# moves the whole bf16 decoder's values by 2.5e-3 of their maximum and its
# gradients by 4.8e-2 relative L2 (H100 host, PERF.md)
PHASE_CARD_VS_CPU = {"f32": ((1e-5, 1e-6), (1e-5, 1e-5)),
                     "bf16": ((1e-5, 1e-6), (2 ** -8, 1e-3))}
DECONV_VOLUME = 32
# the kernels each timed tool must launch (and the inverse cores it must
# not), read around its run
BENCH_LAUNCHES = {
    "bench_mlp": (("fused_trunk", "fused_trunk_bwd"), ()),
    "bench_lbs": (("inverse_core_pg_s", "inverse_core_bwd",
                   "shared_core_fwd", "shared_core_bwd"),
                  ("inverse_core_pg",)),
    "bench_lbs_pg": (("inverse_core", "inverse_core_pg_s",
                      "inverse_core_bwd"), ("inverse_core_pg",)),
}


def _decoder(torch, device, cdt, impl):
    """The production decoder (volume DECONV_VOLUME, 26 bones, weights
    from seed 0) in form `impl`."""
    from hosnerf_tpu_torch.models.human_components import (
        MotionWeightVolumeDecoder)
    return MotionWeightVolumeDecoder(
        256, DECONV_VOLUME, 26, cdt, impl,
        generator=torch.Generator().manual_seed(0), device=device)


def _decoder_run(torch, device, priors, cot, cdt, impl):
    """(output, {name: gradient}) of `_decoder` on `device` for one
    cotangent."""
    dec = _decoder(torch, device, cdt, impl)
    out = dec(priors.to(device))
    out.backward(cot.to(device))
    return out.detach(), {n: p.grad for n, p in dec.named_parameters()}


def _phase_layer_runs(torch, dec, cdt, device, seed=7):
    """Each transposed convolution of a production decoder in its phase
    form, on its own: the layer's input as the decoder's forward gives it
    on the card, one random cotangent, the layer run on `device`. Returns
    [(output, {input, weight, bias gradient})] per layer."""
    import copy

    import torch.nn.functional as F

    from hosnerf_tpu_torch.models.human_components import (
        _phase_conv_transpose)
    d = dec.decoder
    gen = torch.Generator().manual_seed(seed)
    runs = []
    with torch.no_grad():
        h = F.leaky_relu(d.block_mlp(dec.const_embedding[None]), 0.2)
        h = h.reshape(1, 1, 1, 1, 1024)
    for mod in d.block_conv:
        if not isinstance(mod, torch.nn.ConvTranspose3d):
            with torch.no_grad():
                h = mod(h)
            continue
        conv = copy.deepcopy(mod).to(device)
        x = h.detach().to(device).requires_grad_()
        y = _phase_conv_transpose(x, conv, cdt)
        y.backward(torch.randn(y.shape, generator=gen).to(device))
        runs.append((y.detach().cpu(), {"input": x.grad.cpu(),
                                        "weight": conv.weight.grad.cpu(),
                                        "bias": conv.bias.grad.cpu()}))
        with torch.no_grad():
            h = _phase_conv_transpose(h, mod, cdt)
    return runs


def deconv_check(torch, np, device):
    """The weight-volume decoder's phase form at production size (volume
    DECONV_VOLUME = 32, 26 bones, weights from seed 0, priors U(0.01, 1)
    from numpy's seed 0), f32 and bf16: the output and every parameter
    gradient for one random cotangent against the conv form on the card
    (DECONV_TOL); each transposed convolution alone, on the same input
    and cotangent, against the same layer on the CPU (PHASE_CARD_VS_CPU),
    and in f32 the whole decoder against itself on the CPU."""
    V = DECONV_VOLUME
    priors = torch.as_tensor(np.random.default_rng(0).uniform(
        0.01, 1.0, (27, V, V, V)).astype(np.float32), device=device)
    cot = torch.randn(priors.shape, device=device,
                      generator=torch.Generator(device).manual_seed(5))
    cpu = torch.device("cpu")
    for label, cdt in (("f32", None), ("bf16", torch.bfloat16)):
        oc, gc = _decoder_run(torch, device, priors, cot, cdt, "conv")
        op, gp = _decoder_run(torch, device, priors, cot, cdt, "phase")
        vtol, gtol = DECONV_TOL[label]
        verr = float((op - oc).abs().max()) / float(oc.abs().max())
        gmax = max(float((gp[n] - g).abs().max()) / float(g.abs().max())
                   for n, g in gc.items())
        gl2 = max(float(torch.linalg.vector_norm(gp[n] - g))
                  / float(torch.linalg.vector_norm(g)) for n, g in gc.items())
        print(f"decoder phase vs conv {label}: values max err {verr:.3e} "
              f"of their maximum; gradients worst max err {gmax:.3e} of "
              f"the scale, worst rel L2 {gl2:.3e} (tolerance values "
              f"{vtol}, gradients {gtol} rel L2)", flush=True)
        check(verr <= vtol, f"decoder phase vs conv {label}: values")
        check(gl2 <= gtol, f"decoder phase vs conv {label}: gradients")
        del oc, gc
        (rtol, atol), (ctmax, ctl2) = PHASE_CARD_VS_CPU[label]
        pairs = []
        if cdt is None:
            oh, gh = _decoder_run(torch, cpu, priors.cpu(), cot.cpu(), cdt,
                                  "phase")
            pairs.append(("whole decoder", (op.cpu(), {
                n: g.cpu() for n, g in gp.items()}), (oh, gh)))
        del op, gp
        dec = _decoder(torch, device, cdt, "phase")
        for i, (a, b) in enumerate(zip(
                _phase_layer_runs(torch, dec, cdt, device),
                _phase_layer_runs(torch, dec, cdt, cpu))):
            pairs.append((f"layer {i}", a, b))
        del dec
        worst = [0.0, 0.0, 0.0]
        for what, (o, g), (oh, gh) in pairs:
            vex = float(((o - oh).abs() - rtol * oh.abs()).max()) / float(
                oh.abs().max())
            cmax = max(float((g[n] - r).abs().max()) / float(r.abs().max())
                       for n, r in gh.items())
            cl2 = max(float(torch.linalg.vector_norm(g[n] - r))
                      / float(torch.linalg.vector_norm(r))
                      for n, r in gh.items())
            worst = [max(w, v) for w, v in zip(worst, (vex, cmax, cl2))]
            check(vex <= atol and cmax <= ctmax and cl2 <= ctl2,
                  f"decoder phase card vs CPU {label} {what}: values "
                  f"{vex:.3e}, gradients max {cmax:.3e}, rel L2 {cl2:.3e}")
        print(f"decoder phase card vs CPU {label} ("
              + ", ".join(w for w, _, _ in pairs) + "): values worst max "
              f"(err - {rtol} |ref|) {worst[0]:.3e} of their maximum; "
              f"gradients worst max err {worst[1]:.3e} of the scale, worst "
              f"rel L2 {worst[2]:.3e} (tolerance values rtol {rtol} atol "
              f"{atol}, gradients max {ctmax:.3e} and rel L2 {ctl2})",
              flush=True)


def density_checks(torch, device):
    """The pair densities of bench_lbs_pg, pg_density_study and
    pg_window_study at BENCH_PATCHES patches on the card against the same
    counts on the CPU (within 1e-3 absolute)."""
    from hosnerf_tpu_torch.tools import bench_lbs_pg
    from hosnerf_tpu_torch.tools import pair_count as pc
    from hosnerf_tpu_torch.tools import pg_density_study as dens
    from hosnerf_tpu_torch.tools import pg_window_study as win
    cpu = torch.device("cpu")
    runs = []
    for dev in (device, cpu):
        pts, rg, tg, _ = pc.production_points(BENCH_PATCHES, dev)
        runs.append((
            {t: p / c for t, (p, c) in bench_lbs_pg.densities(
                pts, rg, tg).items()},
            dens.study(BENCH_PATCHES, dev), win.study(BENCH_PATCHES, dev)))
    (bc, dc, wc), (bh, dh, wh) = runs
    gaps = {f"bench_lbs_pg tile {t}": abs(bc[t] - bh[t]) for t in bc}
    gaps.update({f"pg_density_study {k[0]}+{k[1]}": abs(
        dc[k][0] - dh[k][0]) / dh[k][1] for k in dc if isinstance(k, tuple)})
    gaps["pg_density_study true"] = abs(dc["true density"]
                                        - dh["true density"])
    for name in win.ORDERS:
        gaps[f"pg_window_study {name}"] = abs(wc[name]["density"]
                                              - wh[name]["density"])
        for W in win.WINDOWS:
            gaps[f"pg_window_study {name} W={W}"] = max(
                abs(a - b) for a, b in zip(wc[name][W], wh[name][W]))
    print("pair densities on the card ("
          + "; ".join(f"tile {t}: {v:.4f}" for t, v in bc.items()) + "; "
          + "; ".join(f"{k[0]}+{k[1]} {v[0] / v[1]:.4f}" for k, v in
                      dc.items() if isinstance(k, tuple))
          + f"; true {dc['true density']:.4f}; "
          + "; ".join(f"window {n} {wc[n]['density']:.4f}"
                      for n in win.ORDERS)
          + f") vs the CPU: largest gap {max(gaps.values()):.3e} "
          f"({max(gaps, key=gaps.get)})", flush=True)
    check(max(gaps.values()) <= 1e-3,
          f"pair densities, card vs CPU: {gaps}")


def bench_tools_phase(torch, device, kind):
    """Phase bench tools (module docstring)."""
    import numpy as np

    from hosnerf_tpu_torch.tools import (bench_all, bench_deconv, bench_lbs,
                                         bench_lbs_pg, bench_mlp, ref_flops)
    t_phase = time.time()
    fwd, total = ref_flops.step_flops()
    print(f"phase bench tools: ref_flops stage-3 step fwd {fwd:.6e} FLOP, "
          f"fwd+bwd {total:.6e}; decoder fwd {ref_flops.vol_decoder():.6e}",
          flush=True)
    wrappers = launch_counts()
    quick = dict(iters=BENCH_ITERS, warmup=BENCH_WARMUP)
    runs = (("bench_mlp", lambda: bench_mlp.bench(device, **quick)),
            ("bench_lbs", lambda: bench_lbs.bench(device, **quick)),
            ("bench_lbs_pg", lambda: bench_lbs_pg.bench(
                device, BENCH_PATCHES, **quick)[3]),
            ("bench_deconv", lambda: bench_deconv.bench(device, **quick)))
    for name, run in runs:
        t0 = time.time()
        for w in wrappers.values():
            w.launches = 0
        rows = run()
        torch.cuda.synchronize()
        launches = {k: w.launches for k, w in wrappers.items() if w.launches}
        dflops = 3.0 * ref_flops.vol_decoder()
        print(f"phase bench tools: {name} on {kind}: " + "; ".join(
            f"{n.strip()} {ms:.4f} ms"
            + (f" ({dflops / ms / 1e9:.3f} TFLOP/s)"
               if name == "bench_deconv" else "") for n, ms in rows)
            + f"; launches {launches}; {time.time() - t0:.1f} s",
            flush=True)
        check(all(math.isfinite(ms) and ms > 0 for _, ms in rows),
              f"{name}: times {rows}")
        need, never = BENCH_LAUNCHES.get(name, ((), ()))
        check(all(launches.get(k, 0) > 0 for k in need)
              and not any(launches.get(k, 0) for k in never),
              f"{name}: launches {launches} (needs {need}, never {never})")
        torch.cuda.empty_cache()
    t0 = time.time()
    deconv_check(torch, np, device)
    density_checks(torch, device)
    print(f"phase bench tools: decoder and density checks "
          f"{time.time() - t0:.1f} s", flush=True)
    record = bench_all.common.device_record(device)
    for stage, fn in bench_all.STAGES.items():
        t0 = time.time()
        res = fn(device)
        res["total_incl_compile"] = time.time() - t0
        res["device"] = record
        print(f"phase bench tools: bench_all {json.dumps(res)}", flush=True)
        check(math.isfinite(res["sec_per_step"]) and res["sec_per_step"] > 0,
              f"bench_all stage {stage}: {res}")
        torch.cuda.empty_cache()
    print(f"phase bench tools: {time.time() - t_phase:.1f} s", flush=True)


# phase bench: the bench script's time limit (s)
BENCH_TIMEOUT = 600


def bench_phase(kind):
    """Phase bench (module docstring): `python -m hosnerf_tpu_torch.bench`
    as a fresh process (its own card settings), its last line checked."""
    from hosnerf_tpu_torch import bench
    t0 = time.time()
    env = {k: v for k, v in os.environ.items()
           if k != "CUBLAS_WORKSPACE_CONFIG"}
    res = subprocess.run([sys.executable, "-m", "hosnerf_tpu_torch.bench"],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=BENCH_TIMEOUT)
    wall = time.time() - t0
    check(res.returncode == 0, f"bench exited {res.returncode}: "
          f"{res.stdout[-2000:]}{res.stderr[-2000:]}")
    out = json.loads(res.stdout.strip().splitlines()[-1])
    for key in ("value", "sec_per_step_8patch"):
        v = out.get(key)
        check(isinstance(v, (int, float)) and math.isfinite(v) and v > 0,
              f"bench: {key} = {v!r}")
    peak = bench.TRIPWIRE * bench.BF16_PEAK_TFLOPS
    check(out["implied_tflops"] <= peak, f"bench: implied "
          f"{out['implied_tflops']} TFLOP/s above {peak}")
    check(0 < out["mfu_vs_bf16_peak"] <= bench.TRIPWIRE,
          f"bench: mfu_vs_bf16_peak {out['mfu_vs_bf16_peak']}")
    check(out["flops_source"] == bench.COUNTED, f"bench: flops_source "
          f"{out['flops_source']!r}, not the counted one")
    print(f"phase bench: {json.dumps(out)}", flush=True)
    points = {}
    for ln in res.stderr.splitlines():
        m = re.match(r"bench: (\d+)-patch point: (\d+) steps, launches "
                     r"(\{.*\})$", ln)
        if m:
            points[int(m[1])] = (int(m[2]), json.loads(m[3]))
    check(sorted(points) == [2, 8], f"bench: launch lines for "
          f"{sorted(points)} patches, not 2 and 8")
    wanted = set(launch_counts()) - {"proto_pairgrid"}
    for n_patches, (steps, launches) in points.items():
        check(wanted <= set(launches), f"bench: {n_patches}-patch point "
              f"reports no count for {sorted(wanted - set(launches))}")
        for k, n in launches.items():
            per = PER_STEP.get(k, 0)
            check(n == per * steps, f"bench: {n_patches}-patch point: {k} "
                  f"launched {n} times in {steps} steps (expected {per} "
                  "per step)")
    for ln in res.stderr.splitlines():
        if ln.startswith("bench: ") and "losses" not in ln:
            print(f"phase {ln}", flush=True)
    print(f"phase bench: {wall:.1f} s wall on {kind}", flush=True)


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

    from hosnerf_tpu_torch.utils import card
    card.configure()
    return run(torch, np)


def run(torch, np) -> int:
    from hosnerf_tpu_torch.models import lpips
    from hosnerf_tpu_torch.models.human import HumanObjectField
    from hosnerf_tpu_torch.ops.cuda import _build
    from hosnerf_tpu_torch.ops.cuda import lbs as clbs
    from hosnerf_tpu_torch.ops.cuda import mlp as cmlp

    t_start = time.time()
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
    print(f"f32 trunk route: {cmlp.f32_route()} (six bf16 wgmma products "
          "per f32 product)", flush=True)

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
    entry_launches, entry_f32 = entry_point_runs(
        torch, ti, train_batch(torch, device), device)
    torch.cuda.empty_cache()
    print(f"phase kernels: {time.time() - t0:.1f} s", flush=True)
    repro_phase(torch, device, ti)
    del ti
    torch.cuda.empty_cache()

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

    # ---- the training step at the default compute_dtype (f32 trunks) ----
    from hosnerf_tpu_torch.train import stage2
    f32_launches, f32_ms, one_step = train_phase(
        torch, device, kind, lp, stage2.Stage2Config(), F32_STEPS, PER_STEP,
        "train f32")
    profile(torch, "one f32 training step", one_step, f32_ms)
    del one_step
    torch.cuda.empty_cache()

    # ---- the dense per-sample path ----
    dense_launches, dense_ms, one_step = train_phase(
        torch, device, kind, lp, stage2.Stage2Config(
            sparse=False, compute_dtype="bf16"), DENSE_STEPS,
        PER_DENSE_STEP, "dense")
    profile(torch, "one dense training step", one_step, dense_ms)
    del one_step
    torch.cuda.empty_cache()
    morton_launches, _, _ = train_phase(
        torch, device, kind, lp, stage2.Stage2Config(
            sparse=False, pg_sort="morton", compute_dtype="bf16"),
        DENSE_STEPS, PER_DENSE_MORTON_STEP, "dense morton")
    torch.cuda.empty_cache()
    pd_launches, _, _ = train_phase(
        torch, device, kind, lp, stage2.Stage2Config(
            sparse=False, lbs_impl="pallas_dense", compute_dtype="bf16"), 1,
        PER_PALLAS_DENSE_STEP, "dense pallas_dense")
    torch.cuda.empty_cache()

    # ---- stage 3: the composed step (bench.py's config) and render ----
    cfg3, scene3, human3, s3_ms, one_step = stage3_phase(torch, device,
                                                         kind, lp)
    profile_groups(torch, "one stage-3 step", one_step, s3_ms)
    del one_step
    torch.cuda.empty_cache()
    stage3_render_phase(torch, device, kind, cfg3, scene3, human3)
    del scene3, human3
    torch.cuda.empty_cache()

    # ---- the host data pipeline and the three trainers it feeds ----
    with tempfile.TemporaryDirectory() as root:
        cap = data_phase(torch, device, root)
        fed = {}
        scene1, fed["scene"] = stage1_phase(torch, device, kind, cap)
        scene_sd = scene1.state_dict()
        del scene1
        torch.cuda.empty_cache()
        fed["human"] = data_train_phase(
            torch, device, kind, "stage2 data",
            stage2_data_step(torch, device, lp, cap), STAGE2_DATA_STEPS)
        torch.cuda.empty_cache()
        fed["hosnerf"] = data_train_phase(
            torch, device, kind, "stage3 data",
            stage3_data_step(torch, device, lp, cap, scene_sd),
            STAGE3_DATA_STEPS, " (scaled-world background rays, the scene "
            "warm-started from the stage-1 phase)")
        del cap, scene_sd
        torch.cuda.empty_cache()
        cli_phase(torch, kind, root, fed)
        torch.cuda.empty_cache()

    ddp_phase(torch, device, kind, card)
    torch.cuda.empty_cache()

    gradcheck_phase(torch, device)
    gradcheck_phase(torch, device, dense=True)
    gradcheck_phase(torch, device, stage3=True)
    torch.cuda.empty_cache()

    tools_phase(torch, device, kind)
    torch.cuda.empty_cache()
    bench_tools_phase(torch, device, kind)
    torch.cuda.empty_cache()
    bench_phase(kind)

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
        parts (f32: also the FMA bound's share), and the kernel device
        times (B2's kernel; B3's recompute, rows, dW, slot sums)."""
        if any("flops" not in results[p] for p in parts):
            return {}
        ms = sum(results[p]["ms"] for p in parts)
        out = {"tflops": sum(results[p]["flops"] for p in parts) / ms / 1e9,
               "bound_share": sum(results[p]["bound_ms"] for p in parts)
               / ms}
        if all("fma_bound_ms" in results[p] for p in parts):
            out["fma_bound_share"] = sum(results[p]["fma_bound_ms"]
                                         for p in parts) / ms
        split = {p[0]: results[p]["launch_ms"] for p in parts
                 if "launch_ms" in results[p]}
        if split:
            out["launch_ms"] = split
        return out

    trunks = [("nonrigid", "bf16"), ("canonical", "bf16")]
    trunks_f32 = [(n, "highest") for n, _ in trunks]
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
        # the f32 ("highest") kernels: launches on the f32 training step
        entry("fused_embed_trunk_f32", "hosnerf_tpu_torch/csrc/embed_trunk.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:560",
              f32_launches["fused_embed_trunk"], trunks_f32),
        entry("fused_embed_trunk_bwd_f32",
              "hosnerf_tpu_torch/csrc/embed_trunk_bwd.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:600",
              f32_launches["fused_embed_trunk_bwd"],
              [(n + "_bwd", p) for n, p in trunks_f32]),
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
    # dense training steps (row 9: pg_sort='morton'; row 6: pallas_dense)
    # or the dense render chunks
    core_rows = {"inverse_core": ("hosnerf_tpu/ops/pallas/lbs.py:490",
                                  pd_launches["inverse_core"]),
                 "inverse_core_pg": ("hosnerf_tpu/ops/pallas/lbs.py:1077",
                                     morton_launches["inverse_core_pg"]),
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
        entry("fused_trunk_f32", "hosnerf_tpu_torch/csrc/embed_trunk.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:242", entry_f32["fused_trunk"],
              [("trunk_canonical", "highest")]),
        entry("fused_trunk_bwd_f32",
              "hosnerf_tpu_torch/csrc/embed_trunk_bwd.cu",
              "hosnerf_tpu/ops/pallas/mlp.py:268",
              entry_f32["fused_trunk_bwd"],
              [("trunk_canonical_bwd", "highest")]),
        entry("proto_pairgrid", "hosnerf_tpu_torch/csrc/proto_pairgrid.cu",
              "tools/proto_pairgrid.py:60",
              entry_launches["proto_pairgrid"], [("proto", "f32")]),
    ]
    print(f"chip_smoke wall: {time.time() - t_start:.1f} s", flush=True)
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
