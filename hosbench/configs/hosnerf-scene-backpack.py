"""hosnerf-scene-backpack: the stage-1 state-conditional mip-NeRF 360 scene
through the port's `train/stage1.py::init_state` / `make_train_step`;
its counts and its reference hooks."""

from __future__ import annotations

import contextlib
from typing import Dict

from hosbench import counts as C
from hosbench import pool, specs
from hosbench import weights as W
from hosbench.reference import train as ref_train


def settings(conf: Dict, small: bool = False) -> Dict:
    s = dict(conf["sizes"])
    if small:
        s.update(conf["small"])
    return s


def weight_specs(s: Dict):
    return specs.scene_specs("scene", s)


def batches(s: Dict, mix: Dict, seed: int):
    return pool.frames(mix, seed)


def generator(seed: int, i: int, device):
    """The step's generator, on the device (the scene step draws its
    jitter from it)."""
    return pool.step_generator(seed, i, device)


def stage1_config(s: Dict):
    from hosnerf_tpu_torch.train import stage1
    keys = ("max_steps", "lr_init", "lr_final", "lr_delay_steps",
            "lr_delay_mult", "charb_padding", "distortion_loss_mult",
            "grad_max_norm", "near", "far", "num_states",
            "num_prop_samples", "num_nerf_samples", "nerf_netwidth",
            "prop_netwidth", "remat", "compute_dtype")
    return stage1.Stage1Config(**{k: s[k] for k in keys})


class Program:
    """The port's stage-1 state and step, on the benchmark's weights."""

    def __init__(self, s: Dict, mix: Dict, params, device):
        from hosnerf_tpu_torch.train import stage1
        self.cfg = stage1_config(s)
        self.iteration = s["iteration"]
        self.model, self.opt = stage1.init_state(self.cfg, seed=0,
                                                 device=device)
        W.load(self.model, W.sub(params, "scene"))
        self.train_step = stage1.make_train_step(self.cfg, self.model,
                                                 self.opt, s["transitions"])
        self.rays = mix["n_rays"]

    def step(self, batch, i: int, gen):
        return self.train_step(batch, self.iteration + i, gen)

    def named_params(self):
        return [("scene." + k, p) for k, p in self.model.named_parameters()]


def reference(s: Dict, mix: Dict, params, frames, seed: int, device,
              prec) -> Dict:
    from hosbench.reference.precision import Precision
    P = dict(params)

    def lr_of(name: str, i: int) -> float:
        return ref_train.warmup_log_lerp(i, s["max_steps"], s["lr_init"],
                                         s["lr_final"], s["lr_delay_steps"],
                                         s["lr_delay_mult"])

    def loss_of(P, i):
        return ref_train.stage1_loss(W.sub(P, "scene"), frames[i],
                                     s["iteration"] + i,
                                     generator(seed, i, device), s,
                                     Precision(prec))

    return ref_train.run_steps(P, loss_of, lr_of, clip=s["grad_max_norm"])


def step_counts(s: Dict, mix: Dict, shapes, batch, seed: int, i: int,
                device) -> Dict:
    R = batch["rays_o"].shape[0]
    return {"model_flops": C.scene_flops(
        shapes, R, s["num_prop_samples"], s["num_nerf_samples"],
        prop_trained=True), "kernels": {}}


@contextlib.contextmanager
def fault(name: str):
    """'frozen' the update left out; 'half' the data term taken over the
    first half of the rays."""
    from hosnerf_tpu_torch.parallel import mesh
    from hosnerf_tpu_torch.train import stage1
    saved = []

    def patch(obj, attr, value):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, value)

    if name == "frozen":
        patch(stage1, "apply_updates", lambda cfg, model, opt: None)
    elif name == "half":
        orig = stage1.compute_losses

        def half(cfg, renderings, ray_history, target, shard=mesh.ONE):
            n = target.shape[0] // 2
            last = dict(renderings[-1], rgb=renderings[-1]["rgb"][:n])
            return orig(cfg, renderings[:-1] + [last], ray_history,
                        target[:n], shard)
        patch(stage1, "compute_losses", half)
    elif name != "none":
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for obj, attr, value in reversed(saved):
            setattr(obj, attr, value)
