"""What the port's chip tools share: the device they run on, the card's
name and power limit, host-clock chains ended by one synchronisation, and
the stage-3 configurations the stage-3 tools build.

Every tool runs on the card unless `--device cpu` is passed; without a
card and without `--device cpu` it raises (`models/layers.py::
resolve_device`): nothing falls back to the CPU.
"""

from __future__ import annotations

import argparse
import subprocess
from typing import Callable, Dict

import torch

from hosnerf_tpu_torch.utils import card
from hosnerf_tpu_torch.utils.benchtools import timeit_chain

# the stage-3 tools' test-only widths (`--small`): the JAX package's
# multichip dry run's tiny configuration, as tests/test_torch_stage3.py
# runs it
SMALL = dict(n_samples=8, cnl_mlp_width=32, nr_mlp_width=16,
             mweight_volume_size=8, num_prop_samples=8, num_nerf_samples=4,
             nerf_netwidth=32, prop_netwidth=16, near_bkg=0.5, far_bkg=20.0)


def add_device_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the CPU; the card otherwise "
                         "(models/layers.py::resolve_device)")


def require_card(device: torch.device, what: str) -> None:
    """Raise unless `device` is a CUDA card: `what` measures only there."""
    if device.type != "cuda":
        raise RuntimeError(f"{what} needs a CUDA card (device {device}); it "
                           "has no CPU counterpart")


def card_line() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line: the card's name and power limit."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def device_record(device: torch.device) -> Dict[str, object]:
    """What ran a measurement: the card's name and its nvidia-smi line
    (name, power limit), or the CPU; and the library settings it ran
    under (`utils/card.py::settings`)."""
    if device.type == "cuda":
        return {"kind": torch.cuda.get_device_name(device),
                "nvidia_smi": card_line(), "settings": card.settings()}
    return {"kind": "cpu", "settings": card.settings()}


def chain_ms(fn: Callable[[int], object], iters: int, warmup: int) -> float:
    """Host-clock ms per call of fn(i) by `utils/benchtools.py::
    timeit_chain`: `warmup` calls and a synchronisation, then `iters`
    calls issued back to back and one synchronisation at the end."""
    return 1e3 * timeit_chain(fn, [(i,) for i in range(warmup + iters)],
                              iters, warmup)


# the (scene_remat, human_remat) splits of the 8-patch operating point: the
# JAX bench's 8-patch config, the NeRF MLP dense, the canonical MLP dense,
# both dense
SPLITS = (("heavy", "heavy"), ("none", "heavy"), ("heavy", "none"),
          ("none", "none"))


def split_arg(text: str):
    """'scene_remat:human_remat' -> (scene_remat, human_remat)."""
    scene, human = text.split(":")
    return scene, human


def stage3_config(n_patches: int, patch_size: int = 32, small: bool = False,
                  **fields):
    """Stage3Config(n_patches, compute_dtype='bf16') as the JAX tools
    build it, patches of `patch_size` (`fields` on top); `small`: the
    test-only widths."""
    from hosnerf_tpu_torch.train import stage3
    return stage3.Stage3Config(**{
        "n_patches": n_patches, "patch_size": patch_size,
        "compute_dtype": "bf16", **(SMALL if small else {}), **fields})


def stage3_batch(cfg, device: torch.device,
                 seed: int = 0) -> Dict[str, torch.Tensor]:
    """`composed_batch(n_patches, patch_size, grid_size=G)` of `cfg` on
    `device`."""
    from hosnerf_tpu_torch.data import synthetic
    nb = synthetic.composed_batch(cfg.n_patches, cfg.patch_size, seed=seed,
                                  grid_size=cfg.mweight_volume_size)
    return {k: torch.as_tensor(v, device=device) for k, v in nb.items()}


def stage3_step(cfg, device):
    """(train_step, batch, (scene, human, opt)): the stage-3 step of `cfg`
    through init_state + make_train_step (weights from seed 0, no LPIPS
    term, as the JAX tools build it) and its `stage3_batch`."""
    from hosnerf_tpu_torch.train import stage3
    scene, human, opt = stage3.init_state(cfg, seed=0, device=device)
    return (stage3.make_train_step(cfg, scene, human, opt),
            stage3_batch(cfg, device), (scene, human, opt))


def split_config(n_patches: int, split, patch_size: int = 32,
                 small: bool = False):
    """`stage3_config` with remat 'none' and the (scene, human) split."""
    return stage3_config(n_patches, patch_size, small, remat="none",
                         scene_remat=split[0], human_remat=split[1])


def jitter(i: int) -> torch.Generator:
    """The CPU generator of timed call i (a distinct draw per call)."""
    return torch.Generator().manual_seed(1000 + i)


# device-time groups of a profiled stage-3 step or composed frame, by
# kernel name (lower case): the human field's hand-written kernels (B1/B4
# csrc/lbs_inverse.cu, B5 csrc/lbs_forward.cu, B2/B3 either precision)
# first, then Adam's multi-tensor kernels, convolutions (cuDNN / implicit
# GEMM: bf16 ones are the human's weight-volume decoder, f32 ones LPIPS),
# the remaining GEMMs (the scene's MLPs, with the small human pose-decoder
# and head products), and everything else (sampling, sorting, compositing,
# elementwise glue)
HUMAN_KERNELS = ("build_image_kernel", "shared_blend_fwd_kernel",
                 "bin_count_kernel", "bin_scan_kernel", "bin_scatter_kernel",
                 "tap_bwd_kernel", "tap_finish_kernel", "inv_image_kernel",
                 "inv_fwd_kernel", "inv_gmax_kernel", "inv_bwd_kernel",
                 "inv_fold_kernel", "embed_trunk_bf16", "rows_bwd_bf16",
                 "dw_bf16", "embed_trunk_x3", "rows_bwd_x3", "dw_x3",
                 "slot_sums")
CONV_KEYS = ("conv", "implicit", "cudnn", "dgrad", "wgrad", "fprop")
GEMM_KEYS = ("gemm", "nvjet", "cutlass", "xmma", "sm90_")
GLUE = "sampling, compositing, glue"
GROUPS = ("human kernels (B1-B5)", "Adam", "convolutions bf16 (decoder)",
          "convolutions f32 (LPIPS)", "GEMMs (scene MLPs, small human heads)",
          GLUE)


def device_groups(events):
    """({group: device ms}, [(ms, kernel) of the glue group, largest
    first]) of a profiler's `key_averages()` kernel records."""
    from torch.autograd import DeviceType
    groups = dict.fromkeys(GROUPS, 0.0)
    glue = []
    for e in events:
        if e.device_type != DeviceType.CUDA or e.is_user_annotation:
            continue
        name, ms = e.key.lower(), e.self_device_time_total / 1e3
        if any(k.lower() in name for k in HUMAN_KERNELS):
            g = GROUPS[0]
        elif "multi_tensor_apply" in name or "adam" in name:
            g = GROUPS[1]
        elif any(k in name for k in CONV_KEYS):
            g = (GROUPS[2] if "bf16" in name or "bfloat16" in name
                 else GROUPS[3])
        elif any(k in name for k in GEMM_KEYS):
            g = GROUPS[4]
        else:
            g = GLUE
            glue.append((ms, e.key))
        groups[g] += ms
    return groups, sorted(glue, reverse=True)


def profile_groups(fn, device):
    """fn() once under torch.profiler (the card's kernels): (busy device
    ms, {group: ms}, glue kernels) by `device_groups`. Needs the card."""
    from torch.profiler import ProfilerActivity, profile
    require_card(device, "the kernel-level profile")
    torch.cuda.synchronize(device)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    groups, glue = device_groups(prof.key_averages())
    return sum(groups.values()), groups, glue
