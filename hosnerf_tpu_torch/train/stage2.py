"""Stage-2 training of the dynamic human-object model (counterpart of
`hosnerf_tpu/train/stage2.py`).

Patch losses: lpips * 1.0 + mse * 0.2 + flow * 0.01 + cycle * 0.01, on
dense patches (a `where(patch_mask, rendered, bgcolor)` select), the flow
term gated by `time > 0.005`. One Adam with a parameter group per module
label; each group's learning rate follows the same exponential decay,
set from the count of updates made so far before each update (optax
evaluates its schedule at the pre-increment count).

`sparse=False` trains on the dense per-sample path (the JAX package's
HOSNERF_SPARSE=0), `pg_impl` and `pg_sort` pick its inverse-LBS core and
the quad core's row order (the JAX package's HOSNERF_PG_IMPL and
HOSNERF_PG_SORT), and `mlp_chunk` / `remat` reshape its module MLPs
(`models/human.py::_module_mlp`) as the JAX config's keys do.

On a batch whose rays are split over ranks (`parallel/mesh.py`), as the
JAX package splits them: every rank draws the whole batch's jitter and
keeps its rows, the rendered colour is gathered (differentiably) for the
patches, whose mse and LPIPS every rank computes alike; the flow and
cycle terms are this rank's numerators over denominators summed over the
ranks. The patch terms enter the backward / world, the ray terms as they
are, and the gradients are summed over the ranks once: the one-rank
gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from hosnerf_tpu_torch.models.human import HumanObjectField
from hosnerf_tpu_torch.models.state import state_indexer
from hosnerf_tpu_torch.parallel import mesh
from hosnerf_tpu_torch.train.schedules import exp_decay
from hosnerf_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    maxiter: int = 400_000
    lr: float = 0.0006667
    lr_human_stateembeds: float = 0.0006667
    lr_mweight_vol_decoder: float = 0.00006667
    lr_pose_decoder: float = 0.00006667
    lr_non_rigid_mlp: float = 0.00006667
    lr_non_rigid_forward_mlp: float = 0.00006667
    lrate_decay: int = 500
    w_lpips: float = 1.0
    w_mse: float = 0.2
    w_flow: float = 0.01
    w_cycle: float = 0.01
    n_patches: int = 2
    patch_size: int = 32
    n_samples: int = 128
    num_states: int = 1
    total_bones: int = 26
    perturb: float = 1.0
    cnl_mlp_width: int = 256
    nr_mlp_width: int = 128
    mweight_volume_size: int = 32
    lbs_impl: str = "auto"
    mlp_impl: str = "auto"
    pg_sort: str = "sig"
    compute_dtype: Optional[str] = None
    mlp_chunk: Optional[int] = None
    remat: Union[bool, str] = False
    sparse: bool = True
    pg_impl: str = "quad"


def make_model(cfg: Stage2Config, *, seed: int = 0,
               device=None) -> HumanObjectField:
    """The stage-2 field, on the card unless `device` says otherwise."""
    return HumanObjectField(
        total_bones=cfg.total_bones, n_samples=cfg.n_samples,
        num_states=cfg.num_states, cnl_mlp_width=cfg.cnl_mlp_width,
        nr_mlp_width=cfg.nr_mlp_width,
        mweight_volume_size=cfg.mweight_volume_size, lbs_impl=cfg.lbs_impl,
        mlp_impl=cfg.mlp_impl, compute_dtype=cfg.compute_dtype,
        sparse=cfg.sparse, pg_impl=cfg.pg_impl, remat=cfg.remat,
        mlp_chunk=cfg.mlp_chunk, pg_sort=cfg.pg_sort, seed=seed,
        device=device)


# --------------------------------------------------------------------------
# optimizer: per-module lr groups, all with the same exp decay
# --------------------------------------------------------------------------

GROUP_OF_MODULE = {
    "human_stateembeds": "human_stateembeds",
    "mweight_vol_decoder": "mweight_vol_decoder",
    "pose_decoder": "pose_decoder",
    "non_rigid_mlp": "non_rigid_mlp",
    "non_rigid_forward_mlp": "non_rigid_forward_mlp",
}
GROUPS = ("base",) + tuple(GROUP_OF_MODULE.values())


def group_of(param_name: str) -> str:
    """lr-group label of a parameter (its top-level module; 'base' for the
    canonical MLP)."""
    return GROUP_OF_MODULE.get(param_name.split(".")[0], "base")


def base_lr(cfg: Stage2Config, group: str) -> float:
    return cfg.lr if group == "base" else getattr(cfg, f"lr_{group}")


def make_optimizer(cfg: Stage2Config,
                   model: HumanObjectField) -> torch.optim.Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8), one param group per label,
    each with its `base_lr`; `opt.updates` counts the updates made."""
    groups = {g: [] for g in GROUPS}
    for name, p in model.named_parameters():
        groups[group_of(name)].append(p)
    opt = torch.optim.Adam(
        [{"params": ps, "group": g, "base_lr": base_lr(cfg, g),
          "lr": base_lr(cfg, g)} for g, ps in groups.items() if ps],
        betas=(0.9, 0.999), eps=1e-8)
    opt.updates = 0
    return opt


def set_learning_rates(opt: torch.optim.Optimizer, cfg: Stage2Config,
                       step: int) -> None:
    for g in opt.param_groups:
        g["lr"] = exp_decay(step, g["base_lr"], cfg.lrate_decay)


def apply_updates(cfg, opt: torch.optim.Adam) -> None:
    """One Adam update from the parameters' gradients at the learning
    rates of the update count so far, which then counts it."""
    set_learning_rates(opt, cfg, opt.updates)
    opt.step()
    opt.updates += 1


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def unpack_patches(rgb_rays, patch_masks, bgcolor, n_patches: int,
                   patch_size: int):
    """Rays (dense, patch-major) -> patch images, bg-filled outside the
    ray mask."""
    imgs = rgb_rays.reshape(n_patches, patch_size, patch_size, 3)
    return torch.where(patch_masks[..., None] > 0, imgs, bgcolor / 255.0)


def flow_loss(ray_grid, newsmpl_to_camera_prev, intrinsics_prev, weights,
              deform_pts_prev, shard: mesh.RayShard = mesh.ONE):
    """Induced-flow MAE against the target flow, weighted by the
    compositing weights and the flow-validity mask. |z| is clamped away
    from 0 so that samples with no forward-LBS support, whose positions
    are meaningless and whose weight is ~0, cannot make inf * 0 = NaN.
    On a rank's share of a split batch the mask's count is summed over
    the ranks."""
    hom = torch.cat([deform_pts_prev,
                     torch.ones_like(deform_pts_prev[..., :1])], -1)
    cam = torch.einsum("ji,rsi->rsj", newsmpl_to_camera_prev, hom)[..., :3]
    pix = torch.einsum("ji,rsi->rsj", intrinsics_prev, cam)
    z = pix[..., 2:3]
    zsafe = torch.where(torch.abs(z) < 1e-6,
                        torch.where(z < 0, -1e-6, 1e-6), z)
    pix2d = pix[..., :2] / zsafe
    grid = ray_grid[:, None, :].expand(ray_grid.shape[0], pix2d.shape[1],
                                       ray_grid.shape[-1])
    induced = pix2d - grid[..., :2]
    mask = grid[..., 4:5]
    num = torch.sum(torch.abs(induced - grid[..., 2:4]) * weights[..., None]
                    * mask)
    return num / (shard.sum(torch.sum(mask)) + 1e-8) / induced.shape[-1]


def cycle_loss(observe_pts, deform_pts, mask,
               shard: mesh.RayShard = mesh.ONE):
    """Masked mean of ||observe - deform||^2 / 2 over the fg-selected
    samples (the count summed over the ranks of a split batch)."""
    sq = torch.sum((observe_pts - deform_pts) ** 2, dim=-1) / 2.0
    return torch.sum(sq * mask) / torch.clamp(shard.sum(torch.sum(mask)),
                                              min=1.0)


REPLICATED_TERMS = ("lpips", "mse")
RAY_TERMS = ("flow", "cycle")


def shard_objective(cfg, losses: Dict[str, torch.Tensor],
                    shard: mesh.RayShard, total: torch.Tensor):
    """(objective, losses) on one rank. One rank: (total, losses) as they
    are. A split batch: the patch terms / world plus this rank's ray
    terms (the sum over the ranks is the global loss, and so is the
    gradient), and the ray terms' reported values summed over the
    ranks."""
    if shard.world == 1:
        return total, losses
    rep = sum(getattr(cfg, f"w_{k}") * losses[k] for k in REPLICATED_TERMS)
    loc = sum(getattr(cfg, f"w_{k}") * losses[k] for k in RAY_TERMS)
    losses = {**losses, **{k: shard.sum(losses[k]) for k in RAY_TERMS}}
    return rep / shard.world + loc, losses


def make_loss_fn(cfg: Stage2Config, model: HumanObjectField,
                 lpips_apply: Optional[Callable] = None):
    """loss_fn(batch, iter_val, state_idx, generator=None) -> (total,
    losses). lpips_apply: callable (pred_nhwc, tgt_nhwc in [-1, 1]) -> [N],
    or None (lpips term 0). On a rank's share of a split batch `total` is
    this rank's share of the objective (`shard_objective`) and `losses`
    hold the global terms."""

    def loss_fn(batch, iter_val, state_idx, generator=None):
        shard = mesh.shard_of(batch)
        with shard.draws():
            out = model(batch, iter_val, state_idx, is_train=True,
                        perturb=cfg.perturb, generator=generator)
        pred = unpack_patches(shard.gather(out["rgb"]), batch["patch_masks"],
                              batch["bgcolor"], cfg.n_patches,
                              cfg.patch_size)
        target = batch["target_patches"]
        losses = {"mse": torch.mean((pred - target) ** 2)}
        losses["lpips"] = (torch.mean(lpips_apply(pred * 2.0 - 1.0,
                                                  target * 2.0 - 1.0))
                           if lpips_apply is not None
                           else pred.new_zeros(()))
        losses["cycle"] = cycle_loss(out["observe_pts"],
                                     out["deform_pts_final"],
                                     out["cycle_mask"], shard)
        gate = (batch["time"] > 0.005).float()
        losses["flow"] = gate * flow_loss(
            batch["ray_grid"], batch["newsmpl_to_camera_prev"],
            batch["intrinsics_prev"], out["weights"],
            out["deform_pts_prev_final"], shard)
        total = (cfg.w_lpips * losses["lpips"] + cfg.w_mse * losses["mse"]
                 + cfg.w_flow * losses["flow"]
                 + cfg.w_cycle * losses["cycle"])
        return shard_objective(cfg, losses, shard, total)

    return loss_fn


def make_grad_fn(loss_fn: Callable, models, transitions=None):
    """grad_fn(batch, iter_val, generator=None) -> losses (detached,
    'loss' the total; global values on a split batch): one forward of
    `loss_fn` with the batch's state, backward, and the gradients of
    `models`' parameters summed over the ranks of a split batch, left in
    .grad."""
    state_of = state_indexer(transitions)

    def grad_fn(batch: Dict[str, torch.Tensor], iter_val,
                generator: Optional[torch.Generator] = None):
        shard = mesh.shard_of(batch)
        s_idx = state_of(batch["time"])
        for m in models:
            m.zero_grad(set_to_none=True)
        with spans.span("forward", iter_val):
            loss, losses = loss_fn(batch, iter_val, s_idx, generator)
        with spans.span("backward", iter_val):
            loss.backward()
            shard.reduce_grads(p for m in models for p in m.parameters())
        losses = {k: v.detach() for k, v in losses.items()}
        losses["loss"] = shard.sum(loss.detach())
        return losses

    return grad_fn


def make_train_step(cfg: Stage2Config, model: HumanObjectField,
                    opt: torch.optim.Adam, transitions=None,
                    lpips_apply: Optional[Callable] = None):
    """train_step(batch, iter_val, generator=None) -> losses (detached,
    'loss' the total): one forward with is_train=True, backward, and one
    Adam update with the learning rates of the update count so far. The
    model's parameters change in place."""
    grad_fn = make_grad_fn(make_loss_fn(cfg, model, lpips_apply), [model],
                           transitions)

    def train_step(batch: Dict[str, torch.Tensor], iter_val,
                   generator: Optional[torch.Generator] = None):
        with spans.span("step", iter_val):
            losses = grad_fn(batch, iter_val, generator)
            with spans.span("optimizer"):
                apply_updates(cfg, opt)
        return losses

    return train_step


def init_state(cfg: Stage2Config, *, seed: int = 0, device=None):
    """(model, opt): the field built from `seed` on the card (or on
    `device`), and its optimizer."""
    model = make_model(cfg, seed=seed, device=device)
    return model, make_optimizer(cfg, model)
