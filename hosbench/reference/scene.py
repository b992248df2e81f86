"""The state-conditional mip-NeRF 360 scene in plain PyTorch, on a dict of
parameters named as the port's `SceneField.state_dict()` (a functional
copy of the port's `models/scene.py` at the benchmark's settings: no
noise, no remat, no chunks). Trunk products in the reference's
precision; heads, sampling and compositing in f32."""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from hosbench.reference import geopoly, render, stepfun
from hosbench.reference import rays as ray_math
from hosbench.reference.precision import F32, Precision

MIN_DEG, MAX_DEG, DEG_VIEW, SKIP = 0, 12, 4, 4
DENSITY_BIAS, RGB_PADDING = -1.0, 0.001


def pos_basis(device) -> torch.Tensor:
    return torch.from_numpy(geopoly.generate_basis("icosahedron", 2)).to(
        device)


def _trunk(p, prefix: str, depth: int, x, prec: Precision):
    inputs = x
    for idx in range(depth):
        x = torch.relu(prec.linear(x, p[f"{prefix}.{idx}.weight"],
                                   p[f"{prefix}.{idx}.bias"]))
        if idx % SKIP == 0 and idx > 0:
            x = torch.cat([x, inputs], dim=-1)
    return x


def _head(p, name, x):
    return F.linear(x, p[f"{name}.weight"], p[f"{name}.bias"])


def mip_mlp(p: Dict[str, torch.Tensor], means, variances, viewdirs,
            state_idx, depth: int, num_states: int, disable_rgb: bool,
            prec: Precision = F32):
    """(density [R, S], rgb [R, S, 3]) of one level's MLP."""
    x = ray_math.integrated_pos_enc(means, variances, MIN_DEG, MAX_DEG)
    embed = torch.stack([p[f"bkgd_stateembeds.{k}"]
                         for k in range(num_states)])[
        torch.as_tensor(state_idx, device=x.device).long()]
    while embed.ndim < x.ndim:
        embed = embed[..., None, :]
    embed = embed.expand(x.shape[:-1] + embed.shape[-1:])
    x = _trunk(p, "pts_linear", depth, torch.cat([x, embed], -1), prec)
    density = F.softplus(_head(p, "density_layer", x)[..., 0]
                         + DENSITY_BIAS)
    if disable_rgb:
        return density, density.new_zeros(density.shape + (3,))
    bottleneck = _head(p, "bottleneck_layer", x)
    dir_enc = ray_math.pos_enc(viewdirs, 0, DEG_VIEW, True)
    dir_enc = dir_enc[..., None, :].expand(bottleneck.shape[:-1]
                                           + dir_enc.shape[-1:])
    x = _trunk(p, "views_linear", 1, torch.cat([bottleneck, dir_enc], -1),
               prec)
    rgb = torch.sigmoid(_head(p, "rgb_layer", x))
    return density, rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING


def scene_forward(p: Dict[str, torch.Tensor], batch, train_frac: float,
                  state_idx, near: float, far: float, generator, *,
                  num_states: int, num_prop_samples: int = 64,
                  num_nerf_samples: int = 32, num_levels: int = 3,
                  prop_depth: int = 4, nerf_depth: int = 8,
                  opaque_background: bool = False, basis=None,
                  prec: Precision = F32
                  ) -> Tuple[List[dict], List[dict]]:
    """(renderings, ray_history) of the proposal sampler, randomized by
    `generator` (the port's defaults: anneal slope 10, dilation 0.5 /
    0.0025, single jitter, cone rays, white background)."""
    rays_o = batch["rays_o"]
    bsz, dtype, device = rays_o.shape[0], rays_o.dtype, rays_o.device
    basis = pos_basis(device) if basis is None else basis
    _, s_to_t = ray_math.construct_ray_warps(near, far)
    init_s_near, init_s_far = 0.0, 1.0
    sdist = torch.cat([torch.full((bsz, 1), init_s_near, dtype=dtype,
                                  device=device),
                       torch.full((bsz, 1), init_s_far, dtype=dtype,
                                  device=device)], -1)
    weights = torch.ones((bsz, 1), dtype=dtype, device=device)
    prod_num_samples = 1
    ray_history, renderings = [], []
    for i_level in range(num_levels):
        is_prop = i_level < num_levels - 1
        num_samples = num_prop_samples if is_prop else num_nerf_samples
        dilation = 0.0025 + 0.5 * (init_s_far - init_s_near) / \
            prod_num_samples
        prod_num_samples *= num_samples
        if i_level > 0:
            sdist, weights = stepfun.max_dilate_weights(
                sdist, weights, dilation, domain=(init_s_near, init_s_far),
                renormalize=True)
            sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]
        anneal = (10.0 * train_frac) / (9.0 * train_frac + 1)
        logits_resample = torch.where(sdist[..., 1:] > sdist[..., :-1],
                                      anneal * torch.log(weights + 0.0),
                                      -math.inf)
        sdist = stepfun.sample_intervals(
            generator, True, sdist, logits_resample, num_samples,
            single_jitter=True, domain=(init_s_near, init_s_far))
        sdist = sdist.detach()
        tdist = s_to_t(sdist)
        means, variances = ray_math.contracted_lifted_gaussians(
            rays_o, batch["rays_d"], batch["radii"], tdist, basis, "cone")
        density, rgb = mip_mlp(
            {k[len(f"mlps.{i_level}."):]: v for k, v in p.items()
             if k.startswith(f"mlps.{i_level}.")},
            means, variances, batch["viewdirs"], state_idx,
            prop_depth if is_prop else nerf_depth, num_states, is_prop, prec)
        weights = render.compute_alpha_weights(
            density, tdist, batch["rays_d"],
            opaque_background=opaque_background)[0]
        renderings.append(render.volumetric_rendering(rgb, weights, 1.0))
        ray_history.append({"rgb": rgb, "density": density, "sdist": sdist,
                            "tdist": tdist, "weights": weights})
    return renderings, ray_history


def interlevel_loss(ray_history) -> torch.Tensor:
    c = ray_history[-1]["sdist"].detach()
    w = ray_history[-1]["weights"].detach()
    loss = 0.0
    for rr in ray_history[:-1]:
        loss = loss + torch.mean(stepfun.lossfun_outer(c, w, rr["sdist"],
                                                       rr["weights"]))
    return loss


def distortion_loss(ray_history) -> torch.Tensor:
    return torch.mean(stepfun.lossfun_distortion(
        ray_history[-1]["sdist"], ray_history[-1]["weights"]))
