"""hosnerf-backpack: the stage-3 composed model (scene + human-object field
trained together on composed patches) through the port's
`train/stage3.py::init_state` / `make_train_step`, LPIPS on; its counts
and its reference hooks."""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

from hosbench import counts as C
from hosbench import pool, specs
from hosbench import weights as W
from hosbench.reference import human as ref_human
from hosbench.reference import train as ref_train


def settings(conf: Dict, small: bool = False) -> Dict:
    s = dict(conf["sizes"])
    if small:
        s.update(conf["small"])
    return s


def weight_specs(s: Dict):
    return (specs.scene_specs("scene", s) + specs.human_specs("human", s)
            + specs.lpips_specs("lpips"))


def batches(s: Dict, mix: Dict, seed: int):
    return pool.frames(mix, seed, grid_size=s["mweight_volume_size"],
                       total_bones=s["total_bones"])


def generator(seed: int, i: int, device):
    """The step's CPU generator (the stage-3 step seeds its device
    generators from it)."""
    return pool.step_generator(seed, i)


def stage3_config(s: Dict, mix: Dict):
    from hosnerf_tpu_torch.train import stage3
    keys = ("n_samples", "num_states", "total_bones", "cnl_mlp_width",
            "nr_mlp_width", "mweight_volume_size", "num_prop_samples",
            "num_nerf_samples", "nerf_netwidth", "prop_netwidth", "near_bkg",
            "far_bkg", "compute_dtype", "remat", "w_lpips", "w_mse", "w_flow",
            "w_cycle")
    return stage3.Stage3Config(n_patches=mix["n_patches"],
                               patch_size=mix["patch_size"],
                               **{k: s[k] for k in keys},
                               **{k: s[k] for k in ("lbs_impl", "mlp_impl")
                                  if k in s})


class Program:
    """The port's stage-3 state and step, on the benchmark's weights."""

    def __init__(self, s: Dict, mix: Dict, params, device):
        from hosnerf_tpu_torch.models.lpips import LPIPS
        from hosnerf_tpu_torch.train import stage3
        self.cfg = stage3_config(s, mix)
        self.iteration = s["iteration"]
        self.scene, self.human, self.opt = stage3.init_state(
            self.cfg, seed=0, device=device)
        W.load(self.scene, W.sub(params, "scene"))
        W.load(self.human, W.sub(params, "human"))
        self.lpips = LPIPS(device=device)
        W.load(self.lpips, W.sub(params, "lpips"))
        self.lpips.requires_grad_(False)
        self.train_step = stage3.make_train_step(
            self.cfg, self.scene, self.human, self.opt,
            lpips_apply=self.lpips)
        self.rays = mix["n_patches"] * mix["patch_size"] ** 2

    def step(self, batch, i: int, gen):
        return self.train_step(batch, self.iteration + i, gen)

    def named_params(self):
        return ([("scene." + k, p) for k, p in self.scene.named_parameters()]
                + [("human." + k, p)
                   for k, p in self.human.named_parameters()])


def reference(s: Dict, mix: Dict, params, frames, seed: int, device,
              prec) -> Dict:
    """The reference's readings of steps 0-2 on the same weights, frames
    and jitter."""
    from hosbench.reference.precision import Precision
    P = {k: v for k, v in params.items() if not k.startswith("lpips.")}
    lp = {k: v.float() for k, v in W.sub(params, "lpips").items()}
    cfg = dict(s, n_patches=mix["n_patches"], patch_size=mix["patch_size"])
    lr = s["lr"]

    def lr_of(name: str, i: int) -> float:
        if name.startswith("scene."):
            group = "bkgd"
        else:
            top = name.split(".")[1]
            group = top if top in lr else "base"
        return ref_train.exp_decay(i, lr[group], s["lrate_decay"])

    def loss_of(P, i):
        return ref_train.stage3_loss(P, lp, frames[i], s["iteration"] + i,
                                     generator(seed, i, device), cfg,
                                     Precision(prec))

    return ref_train.run_steps(P, loss_of, lr_of)


def step_counts(s: Dict, mix: Dict, shapes, batch, seed: int, i: int,
                device) -> Dict:
    """The model FLOPs and the kernels' work of step i on `batch` (the
    whole global batch)."""
    gen = generator(seed, i, device)
    seeds = torch.randint(2 ** 62, (2,), generator=gen).tolist()
    hgen = torch.Generator(device).manual_seed(seeds[1])
    R = batch["rays_o"].shape[0]
    S, G, B = s["n_samples"], s["mweight_volume_size"], s["total_bones"]
    u = torch.rand((R, S), generator=hgen, device=device)
    m_sR, m_T, _, _ = ref_human.motion_bases(batch["dst_Rs"],
                                             batch["dst_Ts"],
                                             batch["cnl_gtfms"])
    live, pairs = C.support(batch, u, m_sR, m_T, G)
    cnl, nr = C.trunk_macs(shapes)
    kern = {**C.lbs_kernels(live, pairs, B, G),
            **C.trunk_kernels(shapes, live)}
    flops = (C.scene_flops(shapes, R, s["num_prop_samples"],
                           s["num_nerf_samples"], prop_trained=False)
             + 6.0 * (cnl * live + nr * 3 * live)
             + 6.0 * C.decoder_macs(shapes, "human.mweight_vol_decoder.decoder")
             + 12.0 * C.macs(shapes, "human.pose_decoder.")
             + 2.0 * 3 * mix["n_patches"]
             * C.vgg_macs(shapes, "lpips", mix["patch_size"])
             + sum(k[0] for n, k in kern.items() if n.startswith("B")
                   and n not in ("B2", "B3")))
    return {"model_flops": flops, "live": live, "pairs": pairs,
            "kernels": kern}


@contextlib.contextmanager
def fault(name: str):
    """A fault planted in the port's timed path (for the checks that must
    fail): 'frozen' the update left out; 'half' the patch losses taken
    over the first half of the patches; 'noreduce' the gradient
    exchange between ranks left out. Backward faults of the hand-written
    kernels (the kernel path, on the card): 'b4_dvol' and 'b5_dvol' the
    weight volume's gradient from inverse LBS (B4) or forward LBS (B5)
    scaled by 1.3; 'b3_dw' the fourth trunk layer's weight gradient
    dropped in every fused trunk's backward (B3)."""
    from hosnerf_tpu_torch.ops.cuda import lbs, mlp
    from hosnerf_tpu_torch.parallel import mesh
    from hosnerf_tpu_torch.train import stage2, stage3
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "frozen":
        patch(stage2, "apply_updates", lambda cfg, opt: None)
    elif name == "half":
        orig = stage3.image_losses

        def half(pred, target, lpips_apply=None):
            n = pred.shape[0] // 2
            return orig(pred[:n], target[:n], lpips_apply)
        patch(stage3, "image_losses", half)
    elif name == "noreduce":
        patch(mesh.RayShard, "reduce_grads", lambda self, params: None)
    elif name == "b4_dvol":
        inv_bwd = lbs._inv_bwd

        def b4(*a, **k):
            dpts, drg, dtg, dvol = inv_bwd(*a, **k)
            return dpts, drg, dtg, dvol * 1.3
        patch(lbs, "_inv_bwd", b4)
    elif name == "b5_dvol":
        blend_bwd = lbs._blend_bwd

        def b5(*a, **k):
            dpts, dvol, drmat = blend_bwd(*a, **k)
            return dpts, dvol * 1.3, drmat
        patch(lbs, "_blend_bwd", b5)
    elif name == "b3_dw":
        trunk_bwd = mlp.embed_trunk_bwd

        def b3(*a, **k):
            dx, daux, dlayers, dout = trunk_bwd(*a, **k)
            dw, db = dlayers[3]
            dlayers = list(dlayers)
            dlayers[3] = (torch.zeros_like(dw), db)
            return dx, daux, dlayers, dout
        patch(mlp, "embed_trunk_bwd", b3)
    elif name != "none":
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
