"""Stage 3's composition of the scene's and the human-object field's
samples along each ray (counterpart of `hosnerf_tpu/models/composed.py`).

Every ray is composited both ways, jointly (the merged streams) and over
the background alone, and a per-ray select keeps the joint result where
the human's foreground mask sums above FG_THRESHOLD; the human-sample
weights that the flow loss reads are zero on the other rays.
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from hosnerf_tpu_torch.core import render
from hosnerf_tpu_torch.ops import merge

FG_THRESHOLD = 5e-3


def to_homogeneous(pts: torch.Tensor) -> torch.Tensor:
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def compose(scene_last_level: Dict[str, Any], human_out: Dict[str, Any],
            batch: Dict[str, Any], sortless: bool = True
            ) -> Dict[str, torch.Tensor]:
    """scene_last_level: the scene's ray_history[-1] (rgb [R, Nb, 3],
    density [R, Nb], tdist [R, Nb + 1]); human_out: the human field's
    outputs (human_rgb [R, Nh, 3], human_density [R, Nh], newsmpl_pts
    [R, Nh, 3], pts_mask [R, Nh]); batch: rays_o_bkg, rays_d_bkg [R, 3],
    newsmpl_to_scale_world [4, 4]. sortless: `merge.sortless_composite`,
    else the sorted merge. Returns rgb [R, 3], acc, depth, human_weights
    [R, Nh] and idx_fg [R]."""
    rays_o, rays_d = batch["rays_o_bkg"], batch["rays_d_bkg"]
    sw_pts = torch.einsum("ji,rsi->rsj", batch["newsmpl_to_scale_world"],
                          to_homogeneous(human_out["newsmpl_pts"]))[..., :3]
    z_hum = merge.z_along_ray(sw_pts, rays_o, rays_d)
    pts_mask = human_out["pts_mask"]
    idx_fg = torch.sum(pts_mask, dim=-1) > FG_THRESHOLD

    z_bkg = scene_last_level["tdist"][..., :-1]
    out_bkg = torch.cat([scene_last_level["rgb"],
                         scene_last_level["density"][..., None]], dim=-1)
    out_hum = torch.cat([human_out["human_rgb"],
                         human_out["human_density"][..., None]], dim=-1)

    if sortless:
        rgb_fg, acc_fg, _, human_weights, depth_fg = \
            merge.sortless_composite(z_bkg, out_bkg, z_hum, out_hum,
                                     pts_mask, rays_d)
    else:
        merged = merge.merge_sorted_streams(z_bkg, out_bkg, z_hum, out_hum,
                                            pts_mask)
        rgb_fg, acc_fg, w_sorted, depth_fg = render.raw2outputs_joint(
            merged["out"], merged["z"], rays_d, merged["mask"])
        human_weights = merge.extract_human_weights(w_sorted, merged)

    rgb_bg, acc_bg, _, depth_bg = render.raw2outputs_joint(
        out_bkg, z_bkg, rays_d, torch.ones_like(z_bkg)[..., None])
    fg = idx_fg[:, None]
    return {
        "rgb": torch.where(fg, rgb_fg, rgb_bg),
        "acc": torch.where(idx_fg, acc_fg, acc_bg),
        "depth": torch.where(idx_fg, depth_fg, depth_bg),
        "human_weights": human_weights * fg,
        "idx_fg": idx_fg,
    }
