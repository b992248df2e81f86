"""The reference's training steps: stage 3's composed step and stage 1's
scene step in plain PyTorch f32 (TF32 off), with Adam written out, and
the readings the benchmark compares with the program's: each step's
loss, the first step's gradient per parameter as Adam receives it, and
each parameter's change over the first three steps.

The schedules (`exp_decay`, `warmup_log_lerp`), the state index, the
clip and Adam are copies of the port's `train/schedules.py`,
`models/state.py`, `train/stage1.py::clip_by_global_norm` and
torch.optim.Adam's arithmetic."""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from hosbench.reference import compose as comp_mod
from hosbench.reference import scene as scene_mod
from hosbench.reference.human import human_forward
from hosbench.reference.precision import F32, Precision

F = np.float32
BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8


def exp_decay(step, base_lr: float, lrate_decay: int = 500) -> float:
    return float(F(base_lr) * F(0.1) ** (F(step) / F(lrate_decay * 1000.0)))


def warmup_log_lerp(step, max_steps, lr_init, lr_final, delay_steps=512,
                    delay_mult=0.01) -> float:
    step = F(step)
    delay = F(delay_mult) + F(1.0 - delay_mult) * np.sin(
        F(0.5 * np.pi) * np.clip(step / F(delay_steps), F(0), F(1)))
    t = np.clip(step / F(max_steps), F(0), F(1))
    return float(F(delay) * np.exp(np.log(F(lr_init)) * (F(1) - t)
                                   + np.log(F(lr_final)) * t))


def state_index(time, transitions):
    time = torch.as_tensor(time)
    if transitions is None or len(transitions) == 0:
        return torch.zeros(time.shape, dtype=torch.int32, device=time.device)
    tr = torch.as_tensor(transitions, dtype=torch.float32, device=time.device)
    first = (time >= tr[0] - 1e-5).to(torch.int32)
    rest = torch.sum((time[..., None] > tr[1:] + 1e-5).to(torch.int32), -1)
    return (first + first * rest).to(torch.int32)


def clip_by_global_norm(grads: List[torch.Tensor], max_norm: float):
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in grads]))
    if float(norm) < max_norm:
        return grads
    return [g / norm * max_norm for g in grads]


class Adam:
    """torch.optim.Adam's update (betas 0.9 / 0.999, eps 1e-8) on a dict
    of tensors; a parameter without a gradient keeps no state and does not
    move."""

    def __init__(self):
        self.m: Dict[str, torch.Tensor] = {}
        self.v: Dict[str, torch.Tensor] = {}
        self.t: Dict[str, int] = {}

    def step(self, params, grads: Dict[str, torch.Tensor],
             lr_of: Callable[[str], float]):
        with torch.no_grad():
            for k, g in grads.items():
                if k not in self.m:
                    self.m[k] = torch.zeros_like(g)
                    self.v[k] = torch.zeros_like(g)
                    self.t[k] = 0
                self.t[k] += 1
                t = self.t[k]
                self.m[k].mul_(BETA1).add_(g, alpha=1 - BETA1)
                self.v[k].mul_(BETA2).addcmul_(g, g, value=1 - BETA2)
                bc1, bc2 = 1 - BETA1 ** t, 1 - BETA2 ** t
                denom = (self.v[k].sqrt() / math.sqrt(bc2)).add_(ADAM_EPS)
                params[k].addcdiv_(self.m[k], denom, value=-lr_of(k) / bc1)


def split_generator(generator: torch.Generator, device):
    """The stage-3 step's two device generators (scene, human), seeded
    from the step's CPU generator as the port's step seeds them."""
    seeds = torch.randint(2 ** 62, (2,), generator=generator).tolist()
    return tuple(torch.Generator(device).manual_seed(s) for s in seeds)


def sub(params, prefix):
    p = prefix + "."
    return {k[len(p):]: v for k, v in params.items() if k.startswith(p)}


def stage3_loss(P, lp, batch, iter_val, generator, cfg: dict,
                prec: Precision = F32) -> Dict[str, torch.Tensor]:
    """The composed step's losses ('loss' the weighted total)."""
    dev = batch["rays_o"].device
    scene_gen, human_gen = split_generator(generator, dev)
    s_idx = state_index(batch["time"], None)
    bkg = {"rays_o": batch["rays_o_bkg"], "rays_d": batch["rays_d_bkg"],
           "viewdirs": batch["viewdirs_bkg"], "radii": batch["radii"]}
    _, hist = scene_mod.scene_forward(
        sub(P, "scene"), bkg, 1.0, s_idx, cfg["near_bkg"], cfg["far_bkg"],
        scene_gen, num_states=cfg["num_states"],
        num_prop_samples=cfg["num_prop_samples"],
        num_nerf_samples=cfg["num_nerf_samples"], opaque_background=True,
        prec=prec)
    human = human_forward(sub(P, "human"), batch, iter_val, s_idx, human_gen,
                          n_samples=cfg["n_samples"],
                          num_states=cfg["num_states"], prec=prec)
    comp = comp_mod.compose(hist[-1], human, batch)
    pred = comp_mod.unpack_patches(comp["rgb"], batch["patch_masks"],
                                   batch["bgcolor"], cfg["n_patches"],
                                   cfg["patch_size"])
    target = batch["target_patches"]
    gate = (batch["time"] > 0.005).float()
    losses = {
        "mse": torch.mean((pred - target) ** 2),
        "lpips": torch.mean(comp_mod.lpips(lp, pred * 2.0 - 1.0,
                                           target * 2.0 - 1.0)),
        "cycle": comp_mod.cycle_loss(human["observe_pts"],
                                     human["deform_pts_final"],
                                     human["cycle_mask"]),
        "flow": gate * comp_mod.flow_loss(
            batch["ray_grid"], batch["newsmpl_to_camera_prev"],
            batch["intrinsics_prev"], comp["human_weights"],
            human["deform_pts_prev_final"])}
    losses["loss"] = sum(cfg[f"w_{k}"] * losses[k]
                         for k in ("lpips", "mse", "flow", "cycle"))
    losses["image"] = cfg["w_lpips"] * losses["lpips"] + \
        cfg["w_mse"] * losses["mse"]
    return losses


def stage1_loss(P, batch, step, generator, cfg: dict,
                prec: Precision = F32) -> Dict[str, torch.Tensor]:
    """The scene step's losses ('loss' the objective)."""
    frac = float(np.clip(F(step) / F(cfg["max_steps"]), F(0), F(1)))
    s_idx = state_index(batch["times"], cfg.get("transitions"))
    rend, hist = scene_mod.scene_forward(
        P, batch, frac, s_idx, cfg["near"], cfg["far"], generator,
        num_states=cfg["num_states"],
        num_prop_samples=cfg["num_prop_samples"],
        num_nerf_samples=cfg["num_nerf_samples"], prec=prec)
    mse = torch.mean((rend[-1]["rgb"] - batch["target"]) ** 2)
    loss = (torch.sqrt(mse + cfg["charb_padding"] ** 2)
            + scene_mod.interlevel_loss(hist)
            + scene_mod.distortion_loss(hist) * cfg["distortion_loss_mult"])
    return {"mse": mse, "loss": loss}


def run_steps(P0: Dict[str, torch.Tensor], loss_of: Callable,
              lr_of: Callable[[str, int], float], n_steps: int = 3,
              clip: float = 0.0) -> dict:
    """Train f32 copies of P0 for n_steps (loss_of(P, i) -> losses of
    step i): {'losses': [n], 'terms' step 0's loss terms, 'grad_norms':
    {name: |g|} of step 0 as Adam receives it, 'grads' those gradients
    (on the host), 'change_norms': {name: |P_n - P0|}}; where the losses
    name an 'image' part, also 'other_share': {name: |g - g_image| / |g|}
    of step 0, the share of each gradient that the other terms carry."""
    P = {k: v.detach().float().clone().requires_grad_(True)
         for k, v in P0.items()}
    opt = Adam()
    losses, grad_norms, out = [], {}, {}
    for i in range(n_steps):
        ls = loss_of(P, i)
        names = list(P)
        if i == 0:
            out["terms"] = {k: float(v.detach()) for k, v in ls.items()
                            if v.numel() == 1}
        if i == 0 and "image" in ls:
            gi = torch.autograd.grad(ls["image"], [P[k] for k in names],
                                     retain_graph=True, allow_unused=True)
            gi = dict(zip(names, gi))
        grads = torch.autograd.grad(ls["loss"], [P[k] for k in names],
                                    allow_unused=True)
        g = {k: t for k, t in zip(names, grads) if t is not None}
        if clip > 0:
            g = dict(zip(g, clip_by_global_norm(list(g.values()), clip)))
        if i == 0:
            grad_norms = {k: float(torch.linalg.vector_norm(t))
                          for k, t in g.items()}
            first = {k: t.detach().to("cpu", copy=True) for k, t in g.items()}
            if "image" in ls:
                out["other_share"] = {
                    k: float(torch.linalg.vector_norm(
                        t - (gi[k] if gi[k] is not None else 0.0))
                        / max(grad_norms[k], 1e-30)) for k, t in g.items()}
                del gi
        opt.step(P, g, lambda k: lr_of(k, i))
        losses.append(float(ls["loss"].detach()))
        del ls, grads, g
    change = {k: float(torch.linalg.vector_norm(P[k].detach() - P0[k].float()))
              for k in P}
    return {"losses": losses, "grad_norms": grad_norms,
            "change_norms": change, "grads": first, **out}
