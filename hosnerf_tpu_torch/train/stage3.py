"""Stage-3 training: the scene and the human-object field fine-tuned
together on composed renders (counterpart of `hosnerf_tpu/train/
stage3.py`).

The step: the scene's proposal sampler at train_frac 1.0 and the human
field (is_train=True) on the same rays, their samples composed per ray
(`models/composed.py`), and the stage-2 patch losses on the composed
colour (lpips * 1.0 + mse * 0.2 + flow * 0.01 + cycle * 0.01; the flow
weighted by the composed human weights, gated by `time > 0.005`). One
Adam with seven lr groups: the human field's six stage-2 labels (the
canonical MLP's at lr_cnl_mlp) and every scene parameter at lr_bkgd, each
with the stage-2 exponential decay at the pre-increment update count.

The proposal MLPs get no gradient in this step (their samples are
detached, and no proposal loss is taken), so Adam leaves them as they
are, as optax's zero updates do.

A batch split over ranks is trained as in stage 2 (`train/stage2.py`):
the composed colour gathered for the patch terms, the flow and cycle
terms over this rank's rays with denominators summed over the ranks,
the gradients summed once. The steps reduce the gradients themselves
rather than through DistributedDataParallel: they reach the models
through `composed_forward` and the sorted path, not through `forward`
alone, and the proposal MLPs take no gradient at all (None on every
rank alike, which the reduction skips).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple, Union

import torch

from hosnerf_tpu_torch.models import composed
from hosnerf_tpu_torch.models import scene as scene_mod
from hosnerf_tpu_torch.models.human import HumanObjectField
from hosnerf_tpu_torch.parallel import mesh
from hosnerf_tpu_torch.train import stage2 as s2
from hosnerf_tpu_torch.utils import spans


@dataclasses.dataclass(frozen=True)
class Stage3Config:
    maxiter: int = 200_000
    lr_cnl_mlp: float = 0.00006667
    lr_human_stateembeds: float = 0.00006667
    lr_mweight_vol_decoder: float = 0.000006667
    lr_pose_decoder: float = 0.000006667
    lr_non_rigid_mlp: float = 0.000006667
    lr_non_rigid_forward_mlp: float = 0.000006667
    lr_bkgd: float = 0.00006667
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
    mlp_chunk: Optional[int] = None        # human module MLPs, rows
    scene_mlp_chunk: Optional[int] = None  # scene MLPs, rays
    near_bkg: float = 0.1
    far_bkg: float = 1e6
    opaque_background: bool = True
    cnl_mlp_width: int = 256
    nr_mlp_width: int = 128
    mweight_volume_size: int = 32
    lbs_impl: str = "auto"
    mlp_impl: str = "auto"
    # False / 'none' | 'heavy' (the scene's NeRF MLP, the human's canonical
    # MLP) | True / 'all'; scene_remat / human_remat override it per model
    remat: Union[bool, str] = False
    scene_remat: Union[bool, str, None] = None
    human_remat: Union[bool, str, None] = None
    num_prop_samples: int = 64
    num_nerf_samples: int = 32
    nerf_netwidth: int = 1024
    prop_netwidth: int = 256
    # trunk computation dtype of both models: 'bf16' or None (f32)
    compute_dtype: Optional[str] = None


def make_models(cfg: Stage3Config, *, seed: int = 0, device=None
                ) -> Tuple[scene_mod.SceneField, HumanObjectField]:
    """(scene, human), built from `seed` on the card unless `device`
    says otherwise."""
    human = HumanObjectField(
        total_bones=cfg.total_bones, n_samples=cfg.n_samples,
        num_states=cfg.num_states, cnl_mlp_width=cfg.cnl_mlp_width,
        nr_mlp_width=cfg.nr_mlp_width,
        mweight_volume_size=cfg.mweight_volume_size, lbs_impl=cfg.lbs_impl,
        mlp_impl=cfg.mlp_impl, compute_dtype=cfg.compute_dtype,
        remat=cfg.remat if cfg.human_remat is None else cfg.human_remat,
        mlp_chunk=cfg.mlp_chunk, seed=seed, device=device)
    scene = scene_mod.SceneField(
        num_states=cfg.num_states, num_prop_samples=cfg.num_prop_samples,
        num_nerf_samples=cfg.num_nerf_samples,
        nerf_netwidth=cfg.nerf_netwidth, prop_netwidth=cfg.prop_netwidth,
        opaque_background=cfg.opaque_background,
        mlp_chunk=cfg.scene_mlp_chunk,
        remat=cfg.remat if cfg.scene_remat is None else cfg.scene_remat,
        compute_dtype=cfg.compute_dtype, seed=seed + 1, device=device)
    return scene, human


GROUPS = s2.GROUPS + ("bkgd",)


def base_lr(cfg: Stage3Config, group: str) -> float:
    return cfg.lr_cnl_mlp if group == "base" else getattr(cfg, f"lr_{group}")


def make_optimizer(cfg: Stage3Config, scene: scene_mod.SceneField,
                   human: HumanObjectField) -> torch.optim.Adam:
    """Adam (betas 0.9 / 0.999, eps 1e-8), one param group per label:
    the human's by `stage2.group_of`, every scene parameter 'bkgd';
    `opt.updates` counts the updates made."""
    groups = {g: [] for g in GROUPS}
    for name, p in human.named_parameters():
        groups[s2.group_of(name)].append(p)
    groups["bkgd"] = list(scene.parameters())
    opt = torch.optim.Adam(
        [{"params": ps, "group": g, "base_lr": base_lr(cfg, g),
          "lr": base_lr(cfg, g)} for g, ps in groups.items() if ps],
        betas=(0.9, 0.999), eps=1e-8)
    opt.updates = 0
    return opt


def split_generator(generator: Optional[torch.Generator], device):
    """Two generators (scene, human) on `device`, seeded from `generator`;
    or (None, None). `generator` lives on the CPU, so that reading the two
    seeds never waits for the card."""
    if generator is None:
        return None, None
    if generator.device.type != "cpu":
        raise ValueError("the stage-3 step's generator must be a CPU "
                         f"generator, got one on {generator.device}")
    seeds = torch.randint(2 ** 62, (2,), generator=generator).tolist()
    return tuple(torch.Generator(device).manual_seed(s) for s in seeds)


def composed_forward(cfg: Stage3Config, scene: scene_mod.SceneField,
                     human: HumanObjectField, batch: Dict[str, torch.Tensor],
                     iter_val, state_idx,
                     generator: Optional[torch.Generator] = None,
                     is_train: bool = False):
    """Both fields on the batch's rays, composed: (comp, human_out). The
    scene runs at train_frac 1.0 with randomized sampling when is_train
    and a (CPU) generator is given; the human field jitters its samples
    then (perturb)."""
    batch_bkg = {"rays_o": batch["rays_o_bkg"], "rays_d": batch["rays_d_bkg"],
                 "viewdirs": batch["viewdirs_bkg"], "radii": batch["radii"]}
    scene_gen, human_gen = split_generator(generator,
                                           batch["rays_o"].device)
    with spans.span("scene"):
        _, ray_history = scene(batch_bkg, 1.0, is_train, state_idx,
                               cfg.near_bkg, cfg.far_bkg, generator=scene_gen)
    human_out = human(batch, iter_val, state_idx, is_train=is_train,
                      perturb=cfg.perturb if is_train else 0.0,
                      generator=human_gen)
    with spans.span("compose"):
        return composed.compose(ray_history[-1], human_out, batch), human_out


def composed_patches(cfg: Stage3Config, comp, batch,
                     shard: mesh.RayShard = mesh.ONE) -> torch.Tensor:
    """The composed colour (every rank's rays, gathered) as the batch's
    patches [P, S, S, 3]."""
    return s2.unpack_patches(shard.gather(comp["rgb"]), batch["patch_masks"],
                             batch["bgcolor"], cfg.n_patches, cfg.patch_size)


def image_losses(pred: torch.Tensor, target: torch.Tensor,
                 lpips_apply: Optional[Callable] = None
                 ) -> Dict[str, torch.Tensor]:
    """{'mse', 'lpips'} of the composed patches (0 without lpips_apply)."""
    mse = torch.mean((pred - target) ** 2)
    if lpips_apply is None:
        return {"mse": mse, "lpips": pred.new_zeros(())}
    with spans.span("loss.lpips"):
        lpips = torch.mean(lpips_apply(pred * 2.0 - 1.0, target * 2.0 - 1.0))
    return {"mse": mse, "lpips": lpips}


def human_losses(comp, human_out, batch, shard: mesh.RayShard = mesh.ONE
                 ) -> Dict[str, torch.Tensor]:
    """{'cycle', 'flow'}: the human field's cycle term, and its flow term
    weighted by the composed human weights, gated by `time > 0.005` (over
    a split batch: this rank's numerators, the global counts)."""
    gate = (batch["time"] > 0.005).float()
    return {"cycle": s2.cycle_loss(human_out["observe_pts"],
                                   human_out["deform_pts_final"],
                                   human_out["cycle_mask"], shard),
            "flow": gate * s2.flow_loss(
                batch["ray_grid"], batch["newsmpl_to_camera_prev"],
                batch["intrinsics_prev"], comp["human_weights"],
                human_out["deform_pts_prev_final"], shard)}


def weighted_total(cfg: Stage3Config, losses: Dict[str, torch.Tensor]):
    """w_lpips * lpips + w_mse * mse + w_flow * flow + w_cycle * cycle,
    over the terms present."""
    return sum(getattr(cfg, f"w_{k}") * losses[k]
               for k in ("lpips", "mse", "flow", "cycle") if k in losses)


def make_loss_fn(cfg: Stage3Config, scene: scene_mod.SceneField,
                 human: HumanObjectField,
                 lpips_apply: Optional[Callable] = None):
    """loss_fn(batch, iter_val, state_idx, generator=None) -> (total,
    losses); lpips_apply as in stage 2, the generator a CPU one. On a
    rank's share of a split batch, `total` is this rank's share of the
    objective and `losses` the global terms (`stage2.shard_objective`)."""

    def loss_fn(batch, iter_val, state_idx, generator=None):
        shard = mesh.shard_of(batch)
        with shard.draws():
            comp, human_out = composed_forward(cfg, scene, human, batch,
                                               iter_val, state_idx,
                                               generator, is_train=True)
        with spans.span("loss.image"):
            losses = image_losses(composed_patches(cfg, comp, batch, shard),
                                  batch["target_patches"], lpips_apply)
        with spans.span("loss.human"):
            losses.update(human_losses(comp, human_out, batch, shard))
        return s2.shard_objective(cfg, losses, shard,
                                  weighted_total(cfg, losses))

    return loss_fn


def make_grad_fn(cfg: Stage3Config, scene: scene_mod.SceneField,
                 human: HumanObjectField, transitions=None,
                 lpips_apply: Optional[Callable] = None):
    """grad_fn(batch, iter_val, generator=None) -> losses: the composed
    forward and backward, both models' gradients summed over the ranks of
    a split batch and left in .grad (`stage2.make_grad_fn`)."""
    return s2.make_grad_fn(make_loss_fn(cfg, scene, human, lpips_apply),
                           [scene, human], transitions)


def make_train_step(cfg: Stage3Config, scene: scene_mod.SceneField,
                    human: HumanObjectField, opt: torch.optim.Adam,
                    transitions=None, lpips_apply: Optional[Callable] = None):
    """train_step(batch, iter_val, generator=None) -> losses (detached,
    'loss' the total; the generator a CPU one): one composed forward,
    backward, and one Adam update at the learning rates of the update
    count so far. Both models' parameters change in place."""
    grad_fn = make_grad_fn(cfg, scene, human, transitions, lpips_apply)

    def train_step(batch: Dict[str, torch.Tensor], iter_val,
                   generator: Optional[torch.Generator] = None):
        with spans.span("step", iter_val):
            losses = grad_fn(batch, iter_val, generator)
            with spans.span("optimizer"):
                s2.apply_updates(cfg, opt)
        return losses

    return train_step


def init_state(cfg: Stage3Config, *, seed: int = 0, device=None):
    """(scene, human, opt): both fields built from `seed` on the card (or
    on `device`), and their optimizer."""
    scene, human = make_models(cfg, seed=seed, device=device)
    return scene, human, make_optimizer(cfg, scene, human)
