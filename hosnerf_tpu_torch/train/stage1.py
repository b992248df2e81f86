"""Stage-1 training of the state-conditional mip-NeRF 360 background scene
(counterpart of `hosnerf_tpu/train/stage1.py`).

Losses: charbonnier(data) * data_loss_mult + interlevel *
interlevel_loss_mult + distortion * distortion_loss_mult, on the last
level's colour. The optimizer is optax's chain(clip_by_global_norm,
adam(warmup_log_lerp)) written out: the gradients scaled by max_norm /
global norm only where the norm reaches max_norm (no epsilon), then one
Adam update at the schedule's rate for the count of updates made so far.

On a batch split over ranks (`parallel/mesh.py`) the charbonnier term
takes the global mse (each rank's mean over its rays / world, summed over
the ranks), the proposal and distortion terms are this rank's means /
world (their sum over the ranks is the global mean), and the gradients
are summed over the ranks before the clip and Adam.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Union

import numpy as np
import torch

from hosnerf_tpu_torch.models import scene
from hosnerf_tpu_torch.models.state import state_indexer
from hosnerf_tpu_torch.parallel import mesh
from hosnerf_tpu_torch.train.schedules import warmup_log_lerp
from hosnerf_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class Stage1Config:
    max_steps: int = 500_000
    lr_init: float = 2.0e-3
    lr_final: float = 2.0e-5
    lr_delay_steps: int = 512
    lr_delay_mult: float = 0.01
    data_loss_mult: float = 1.0
    interlevel_loss_mult: float = 1.0
    distortion_loss_mult: float = 0.01
    charb_padding: float = 0.001
    grad_max_norm: float = 0.001
    near: float = 0.5
    far: float = 1e6
    num_states: int = 1
    num_prop_samples: int = 64
    num_nerf_samples: int = 32
    num_levels: int = 3
    nerf_netwidth: int = 1024
    prop_netwidth: int = 256
    # rays per scene-MLP call (None: one call)
    mlp_chunk: Optional[int] = None
    # False / 'none' | 'heavy' (the 8 x nerf_netwidth NeRF MLP) | True / 'all'
    remat: Union[bool, str] = False
    # trunk computation dtype: 'bf16' or None (f32)
    compute_dtype: Optional[str] = None


def make_model(cfg: Stage1Config, *, seed: int = 0,
               device=None) -> scene.SceneField:
    """The scene field, on the card unless `device` says otherwise."""
    return scene.SceneField(
        num_states=cfg.num_states, num_prop_samples=cfg.num_prop_samples,
        num_nerf_samples=cfg.num_nerf_samples, num_levels=cfg.num_levels,
        nerf_netwidth=cfg.nerf_netwidth, prop_netwidth=cfg.prop_netwidth,
        mlp_chunk=cfg.mlp_chunk, remat=cfg.remat,
        compute_dtype=cfg.compute_dtype, seed=seed, device=device)


def learning_rate(cfg: Stage1Config, count: int) -> float:
    return warmup_log_lerp(count, cfg.max_steps, cfg.lr_init, cfg.lr_final,
                           cfg.lr_delay_steps, cfg.lr_delay_mult)


def make_optimizer(cfg: Stage1Config,
                   model: scene.SceneField) -> torch.optim.Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8) over every parameter;
    `opt.updates` counts the updates made. `apply_updates` clips and
    steps it."""
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate(cfg, 0),
                           betas=(0.9, 0.999), eps=1e-8)
    opt.updates = 0
    return opt


def clip_by_global_norm(grads, max_norm: float) -> None:
    """optax.clip_by_global_norm in place: where the global L2 norm g of
    `grads` reaches max_norm, each gradient becomes (t / g) * max_norm;
    below it they stay as they are. Decided on the device (no host
    synchronisation): the other branch divides and multiplies by 1."""
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    keep = norm < max_norm
    div = torch.where(keep, torch.ones_like(norm), norm)
    mul = torch.where(keep, torch.ones_like(norm),
                      torch.full_like(norm, max_norm))
    torch._foreach_div_(grads, div)
    torch._foreach_mul_(grads, mul)


def apply_updates(cfg: Stage1Config, model: torch.nn.Module,
                  opt: torch.optim.Adam) -> None:
    """One optimizer update from the parameters' gradients: a parameter
    without one takes a zero gradient (optax updates every leaf), the
    gradients are clipped to cfg.grad_max_norm (none at 0), and Adam
    steps at the schedule's rate for `opt.updates`, which then counts
    this update."""
    params = list(model.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if cfg.grad_max_norm > 0:
        clip_by_global_norm([p.grad for p in params], cfg.grad_max_norm)
    for g in opt.param_groups:
        g["lr"] = learning_rate(cfg, opt.updates)
    opt.step()
    opt.updates += 1


def compute_losses(cfg: Stage1Config, renderings, ray_history, target,
                   shard: mesh.RayShard = mesh.ONE):
    """(loss, {'mse', 'psnr'}) of the last level's rgb against `target`.
    On this rank's share of a split batch, `loss` is this rank's share of
    the objective (summed over the ranks: the global loss; its gradient
    summed over the ranks: the global gradient) and mse, psnr are the
    global ones."""
    rgb = renderings[-1]["rgb"]
    mse = torch.mean((rgb - target) ** 2)
    if shard.world > 1:
        mse = shard.total(mse / shard.world)
    loss = torch.sqrt(mse + cfg.charb_padding ** 2) * cfg.data_loss_mult
    loss = loss + scene.interlevel_loss(ray_history) * cfg.interlevel_loss_mult
    loss = loss + scene.distortion_loss(ray_history) * cfg.distortion_loss_mult
    if shard.world > 1:
        loss = loss / shard.world
    psnr = -10.0 * torch.log(mse) / math.log(10.0)
    return loss, {"mse": mse, "psnr": psnr}


def train_fraction(cfg: Stage1Config, step: int) -> float:
    """clip(step / max_steps, 0, 1) in float32, the proposal annealing's
    progress."""
    return float(np.clip(np.float32(step) / np.float32(cfg.max_steps),
                         np.float32(0), np.float32(1)))


def make_loss_fn(cfg: Stage1Config, model: scene.SceneField,
                 transitions=None):
    """loss_fn(batch, step, generator=None) -> (loss, aux): the scene at
    train_fraction(step), randomized with the generator's jitter when one
    is given (on a rank's share of a batch: the whole batch's draws, this
    rank's rows), each ray's state from its `times`."""
    state_of = state_indexer(transitions)

    def loss_fn(batch: Dict[str, torch.Tensor], step: int,
                generator: Optional[torch.Generator] = None):
        shard = mesh.shard_of(batch)
        s_idx = state_of(batch["times"])
        with shard.draws(), spans.span("scene"):
            renderings, ray_history = model(
                batch, train_fraction(cfg, step), True, s_idx, cfg.near,
                cfg.far, generator=generator)
        with spans.span("loss.image"):
            return compute_losses(cfg, renderings, ray_history,
                                  batch["target"], shard)

    return loss_fn


def make_grad_fn(cfg: Stage1Config, model: scene.SceneField,
                 transitions=None):
    """grad_fn(batch, step, generator=None) -> aux ('loss', 'mse', 'psnr',
    detached; the global values on a split batch): one forward and
    backward, the gradients summed over the ranks of a split batch and
    left in the parameters' .grad."""
    loss_fn = make_loss_fn(cfg, model, transitions)

    def grad_fn(batch: Dict[str, torch.Tensor], step: int,
                generator: Optional[torch.Generator] = None):
        shard = mesh.shard_of(batch)
        model.zero_grad(set_to_none=True)
        with spans.span("forward", step):
            loss, aux = loss_fn(batch, step, generator)
        with spans.span("backward", step):
            loss.backward()
            shard.reduce_grads(model.parameters())
        aux = {k: v.detach() for k, v in aux.items()}
        aux["loss"] = shard.sum(loss.detach())
        return aux

    return grad_fn


def make_train_step(cfg: Stage1Config, model: scene.SceneField,
                    opt: torch.optim.Adam, transitions=None):
    """train_step(batch, step, generator=None) -> aux ('loss', 'mse',
    'psnr', detached): `make_grad_fn`'s forward (randomized with the
    generator's jitter when one is given) and backward, then
    `apply_updates`. The model's parameters change in place."""
    grad_fn = make_grad_fn(cfg, model, transitions)

    def train_step(batch: Dict[str, torch.Tensor], step: int,
                   generator: Optional[torch.Generator] = None):
        with spans.span("step", step):
            aux = grad_fn(batch, step, generator)
            with spans.span("optimizer"):
                apply_updates(cfg, model, opt)
        return aux

    return train_step


def make_eval_step(cfg: Stage1Config, model: scene.SceneField,
                   transitions=None):
    """eval_step(batch, train_frac=1.0) -> the last level's rgb [R, 3],
    deterministic, without autograd, at the state of the batch's first
    ray."""
    state_of = state_indexer(transitions)

    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor], train_frac: float = 1.0):
        s_idx = state_of(batch["times"][0])
        renderings, _ = model(batch, train_frac, False, s_idx, cfg.near,
                              cfg.far)
        return renderings[-1]["rgb"]

    return eval_step


def init_state(cfg: Stage1Config, *, seed: int = 0, device=None):
    """(model, opt): the scene field built from `seed` on the card (or on
    `device`), and its optimizer."""
    model = make_model(cfg, seed=seed, device=device)
    return model, make_optimizer(cfg, model)
