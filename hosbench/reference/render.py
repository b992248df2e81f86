"""Volume compositing (a frozen copy of the port's `core/render.py`): the
scene's alpha weights and background composite, the human field's masked
compositing, and stage 3's joint compositing of activated samples."""

from __future__ import annotations

import torch


def compute_alpha_weights(density, tdist, dirs,
                          opaque_background: bool = False):
    """Densities over the intervals of tdist -> (weights, alpha, trans);
    opaque_background makes the last interval opaque."""
    t_delta = tdist[..., 1:] - tdist[..., :-1]
    delta = t_delta * torch.linalg.norm(dirs[..., None, :], dim=-1)
    density_delta = density * delta
    if opaque_background:
        density_delta = torch.cat(
            [density_delta[..., :-1],
             torch.full_like(density_delta[..., -1:], 1e10)], dim=-1)
    alpha = 1.0 - torch.exp(-density_delta)
    trans = torch.exp(-torch.cat(
        [torch.zeros_like(density_delta[..., :1]),
         torch.cumsum(density_delta[..., :-1], dim=-1)], dim=-1))
    return alpha * trans, alpha, trans


def volumetric_rendering(rgbs, weights, bg_rgbs):
    """Composite per-sample rgbs with weights over a background colour (a
    number or an rgb triple): {'rgb', 'acc'}."""
    acc = torch.sum(weights, dim=-1)
    bg_w = torch.clamp(1.0 - acc[..., None], min=0.0)
    rgb = torch.sum(weights[..., None] * rgbs, dim=-2) + bg_w * bg_rgbs
    return {"rgb": rgb, "acc": acc}


def raw2outputs(raw, raw_mask, z_vals, rays_d, bgcolor,
                rgb_activation=torch.sigmoid, density_activation=torch.relu):
    """HumanNeRF-style compositing of raw (rgb, sigma) masked by the
    foreground likelihood. raw [..., S, 4]; raw_mask [..., S, 1];
    z_vals [..., S]; bgcolor an rgb triple in [0, 255].
    Returns (rgb_map, acc_map, weights, depth_map)."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = rgb_activation(raw[..., :3])
    alpha = 1.0 - torch.exp(-density_activation(raw[..., 3]) * dists)
    alpha = alpha * raw_mask[..., 0]

    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    rgb_map = rgb_map + (1.0 - acc_map[..., None]) * bgcolor / 255.0
    return rgb_map, acc_map, weights, depth_map


def raw2outputs_joint(raw, z_vals, rays_d, pts_mask=None, bgcolor=None):
    """Stage 3's joint compositing of activated (rgb, sigma) samples: as
    `raw2outputs` without the activations, the mask [..., S, 1] optional,
    the background added only when bgcolor (0-255) is given."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.full_like(dists[..., :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rays_d[..., None, :], dim=-1)

    rgb = raw[..., :3]
    alpha = 1.0 - torch.exp(-raw[..., 3] * dists)
    if pts_mask is not None:
        alpha = alpha * pts_mask[..., 0]

    trans = torch.cumprod(
        torch.cat([torch.ones_like(alpha[..., :1]), 1.0 - alpha + 1e-10],
                  dim=-1), dim=-1)[..., :-1]
    weights = alpha * trans
    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * z_vals, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    if bgcolor is not None:
        rgb_map = rgb_map + (1.0 - acc_map[..., None]) * bgcolor / 255.0
    return rgb_map, acc_map, weights, depth_map
