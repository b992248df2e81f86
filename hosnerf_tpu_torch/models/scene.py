"""The state-conditional mip-NeRF 360 scene model (counterpart of
`hosnerf_tpu/models/scene.py`): `MipMLP` and the proposal sampler
`SceneField` with its two losses.

Module and parameter names follow the reference checkpoint keys that
`hosnerf_tpu/train/checkpoints.py::export_scene_params` emits (without its
prefix), so a converted JAX state_dict loads with `strict=True`:

  mlps.{i}.pts_linear.{j}, .density_layer, .bottleneck_layer, .rgb_layer,
  .views_linear.{j}, .bkgd_stateembeds.{k}

(levels 0 .. num_levels - 2 are the density-only proposal MLPs; they have
no bottleneck, view or rgb layers). The trunks are plain `nn.Linear`
products, in bf16 when `compute_dtype` says so; the heads, the sampling and
the compositing stay f32. Every random draw (the sampling jitter, the
optional density and bottleneck noise, a random background) comes from an
explicit `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from hosnerf_tpu_torch.core import geopoly, render, stepfun
from hosnerf_tpu_torch.core import rays as ray_math
from hosnerf_tpu_torch.models.human_components import linear_cdt
from hosnerf_tpu_torch.models.layers import (normal_, resolve_compute_dtype,
                                             resolve_device, resolve_remat,
                                             uniform_)
from hosnerf_tpu_torch.models.state import state_rows
from hosnerf_tpu_torch.parallel import mesh

# MipMLP's fixed architecture (the JAX module's defaults; no config sets
# them): IPE degrees 0-11 over the icosahedron-2 basis, a 64-d state
# embedding, skips every 4 layers, a 256-d bottleneck, one 128-wide view
# layer on PE(viewdir) of degree 4, density bias -1, rgb padding 0.001
BASIS_SHAPE, BASIS_SUBDIVISION = "icosahedron", 2
MIN_DEG, MAX_DEG, DEG_VIEW = 0, 12, 4
STATE_EMBEDDING_SIZE, SKIP = 64, 4
BOTTLENECK_WIDTH, VIEW_DEPTH, VIEW_WIDTH = 256, 1, 128
DENSITY_BIAS, RGB_PADDING = -1.0, 0.001


def _torch_linear(din: int, dout: int, gen: torch.Generator,
                  device) -> nn.Linear:
    """nn.Linear with the JAX package's TorchLinear init: kaiming-uniform
    weights (gain sqrt(2): U(+-sqrt(6 / din))), U(+-1 / sqrt(din)) bias."""
    lin = nn.Linear(din, dout, device=device)
    uniform_(lin.weight, math.sqrt(6.0 / din), gen)
    uniform_(lin.bias, 1.0 / math.sqrt(din), gen)
    return lin


def _skip_stack(depth: int, din: int, width: int, gen: torch.Generator,
                device) -> Tuple[nn.ModuleList, int]:
    """`depth` ReLU layers where the output of layer idx (idx % SKIP == 0,
    idx > 0) is concatenated with the stack's input. Returns the layers and
    the width of the stack's output."""
    layers, w = [], din
    for idx in range(depth):
        layers.append(_torch_linear(w, width, gen, device))
        w = width + din if idx % SKIP == 0 and idx > 0 else width
    return nn.ModuleList(layers), w


class MipMLP(nn.Module):
    """The scene MLP on lifted gaussians (`core/rays.py::
    contracted_lifted_gaussians`): a density trunk of netdepth x netwidth
    with input-concat skips, its input the integrated positional encoding
    and the state's 64-d embedding; then (unless disable_rgb) a
    bottleneck, the view branch and rgb."""

    def __init__(self, num_states: int = 1, netdepth: int = 8,
                 netwidth: int = 256, disable_rgb: bool = False,
                 compute_dtype=None, density_noise: float = 0.0,
                 bottleneck_noise: float = 0.0, *,
                 generator: torch.Generator, device=None):
        super().__init__()
        device = resolve_device(device)
        self.disable_rgb = disable_rgb
        self.compute_dtype = resolve_compute_dtype(compute_dtype)
        self.density_noise = density_noise
        self.bottleneck_noise = bottleneck_noise
        gen = generator
        n_basis = geopoly.generate_basis(BASIS_SHAPE,
                                         BASIS_SUBDIVISION).shape[1]
        din = 2 * n_basis * (MAX_DEG - MIN_DEG) + STATE_EMBEDDING_SIZE
        self.pts_linear, w = _skip_stack(netdepth, din, netwidth, gen,
                                         device)
        self.density_layer = _torch_linear(w, 1, gen, device)
        if not disable_rgb:
            self.bottleneck_layer = _torch_linear(w, BOTTLENECK_WIDTH, gen,
                                                  device)
            self.views_linear, wv = _skip_stack(
                VIEW_DEPTH, BOTTLENECK_WIDTH + 3 + 6 * DEG_VIEW, VIEW_WIDTH,
                gen, device)
            self.rgb_layer = _torch_linear(wv, 3, gen, device)
        self.bkgd_stateembeds = nn.ParameterList([
            nn.Parameter(normal_(torch.empty(STATE_EMBEDDING_SIZE,
                                             device=device), 1.0, gen))
            for _ in range(num_states)])

    def _trunk(self, layers: nn.ModuleList, x: torch.Tensor) -> torch.Tensor:
        cdt = self.compute_dtype
        if cdt is not None:
            x = x.to(cdt)
        inputs = x
        for idx, lin in enumerate(layers):
            x = torch.relu(linear_cdt(x, lin, cdt))
            if idx % SKIP == 0 and idx > 0:
                x = torch.cat([x, inputs], dim=-1)
        return x.float()

    def forward(self, lifted_means, lifted_vars, viewdirs, state_idx,
                noise: Optional[Sequence[torch.Tensor]] = None
                ) -> Dict[str, torch.Tensor]:
        """lifted_means, lifted_vars [R, S, m]; viewdirs [R, 3]; state_idx
        0-d or per ray [R]. noise: the uniform draws of the density noise
        [R, S] and the bottleneck noise [R, S, 256], added scaled by
        density_noise / bottleneck_noise; None adds none."""
        x = ray_math.integrated_pos_enc(lifted_means, lifted_vars, MIN_DEG,
                                        MAX_DEG)
        embed = state_rows(self.bkgd_stateembeds, state_idx)
        while embed.ndim < x.ndim:
            embed = embed[..., None, :]
        embed = embed.expand(x.shape[:-1] + embed.shape[-1:])
        x = self._trunk(self.pts_linear, torch.cat([x, embed], dim=-1))
        raw_density = self.density_layer(x)[..., 0]
        if noise is not None and self.density_noise > 0.0:
            raw_density = raw_density + self.density_noise * noise[0]
        density = F.softplus(raw_density + DENSITY_BIAS)
        if self.disable_rgb:
            return {"density": density,
                    "rgb": density.new_zeros(density.shape + (3,))}

        bottleneck = self.bottleneck_layer(x)
        if noise is not None and self.bottleneck_noise > 0.0:
            bottleneck = bottleneck + self.bottleneck_noise * noise[1]
        dir_enc = ray_math.pos_enc(viewdirs, 0, DEG_VIEW, True)
        dir_enc = dir_enc[..., None, :].expand(bottleneck.shape[:-1]
                                               + dir_enc.shape[-1:])
        x = self._trunk(self.views_linear,
                        torch.cat([bottleneck, dir_enc], dim=-1))
        rgb = torch.sigmoid(self.rgb_layer(x))
        rgb = rgb * (1.0 + 2.0 * RGB_PADDING) - RGB_PADDING
        return {"density": density, "rgb": rgb}


class SceneField(nn.Module):
    """The hierarchical proposal sampler and its MLPs: num_levels - 1
    density-only proposal MLPs (prop_netdepth x prop_netwidth) and one
    NeRF MLP (nerf_netdepth x nerf_netwidth).

    remat: False / 'none' keeps every MLP's activations for the backward;
    'heavy' recomputes the NeRF MLP's in the backward
    (`torch.utils.checkpoint`); True / 'all' every MLP's. mlp_chunk: rays
    per MLP call (the batch padded to a multiple of it); None is one call.
    Neither changes values, gradients or parameter names."""

    def __init__(self, num_states: int = 1, num_prop_samples: int = 64,
                 num_nerf_samples: int = 32, num_levels: int = 3,
                 bg_intensity_range: Tuple[float, float] = (1.0, 1.0),
                 anneal_slope: float = 10.0, stop_level_grad: bool = True,
                 ray_shape: str = "cone", disable_integration: bool = False,
                 single_jitter: bool = True,
                 dilation_multiplier: float = 0.5,
                 dilation_bias: float = 0.0025,
                 near_anneal_rate: Optional[float] = None,
                 near_anneal_init: float = 0.95,
                 resample_padding: float = 0.0,
                 opaque_background: bool = False, prop_netdepth: int = 4,
                 prop_netwidth: int = 256, nerf_netdepth: int = 8,
                 nerf_netwidth: int = 1024, remat: Union[bool, str] = True,
                 mlp_chunk: Optional[int] = None, compute_dtype=None, *,
                 seed: int = 0, device=None):
        super().__init__()
        device = resolve_device(device)
        self.num_prop_samples = num_prop_samples
        self.num_nerf_samples = num_nerf_samples
        self.num_levels = num_levels
        self.bg_intensity_range = tuple(bg_intensity_range)
        self.anneal_slope = anneal_slope
        self.stop_level_grad = stop_level_grad
        self.ray_shape = ray_shape
        self.disable_integration = disable_integration
        self.single_jitter = single_jitter
        self.dilation_multiplier = dilation_multiplier
        self.dilation_bias = dilation_bias
        self.near_anneal_rate = near_anneal_rate
        self.near_anneal_init = near_anneal_init
        self.resample_padding = resample_padding
        self.opaque_background = opaque_background
        self.remat = resolve_remat(remat)
        self.mlp_chunk = mlp_chunk
        cdt = resolve_compute_dtype(compute_dtype)
        gen = torch.Generator().manual_seed(seed)
        mlps = [MipMLP(num_states, prop_netdepth, prop_netwidth,
                       disable_rgb=True, compute_dtype=cdt, generator=gen,
                       device=device)
                for _ in range(num_levels - 1)]
        mlps.append(MipMLP(num_states, nerf_netdepth, nerf_netwidth,
                           compute_dtype=cdt, generator=gen, device=device))
        self.mlps = nn.ModuleList(mlps)
        self.register_buffer("pos_basis", torch.from_numpy(
            geopoly.generate_basis(BASIS_SHAPE, BASIS_SUBDIVISION)
        ).to(device), persistent=False)

    def _remat(self, i_level: int) -> bool:
        return self.remat == "all" or (self.remat == "heavy"
                                       and i_level == self.num_levels - 1)

    def _noise(self, mlp: MipMLP, shape, generator, device):
        """The uniform draws of the MLP's density and bottleneck noise for
        samples of `shape` [R, S], or None where it adds no noise."""
        if mlp.density_noise <= 0.0 and (mlp.disable_rgb
                                         or mlp.bottleneck_noise <= 0.0):
            return None
        u = [mesh.rand_rows(shape, generator).to(device)]
        if not mlp.disable_rgb:
            u.append(mesh.rand_rows(shape + (BOTTLENECK_WIDTH,),
                                    generator).to(device))
        return u

    def _apply_mlp(self, i_level: int, lifted, viewdirs, state_idx, noise):
        """MLP i_level over `mlp_chunk`-ray slices of the batch (one call
        when mlp_chunk is unset), recomputed in the backward as `remat`
        says."""
        mlp = self.mlps[i_level]
        fn = ((lambda *a: checkpoint(mlp, *a, use_reentrant=False))
              if self._remat(i_level) else mlp)
        means, covs = lifted
        if not self.mlp_chunk:
            return fn(means, covs, viewdirs, state_idx, noise)
        n, c = means.shape[0], self.mlp_chunk
        pad = (-n) % c

        def padr(a):
            return (torch.cat([a, a.new_zeros((pad,) + a.shape[1:])])
                    if pad else a)

        state_idx = torch.as_tensor(state_idx, device=means.device)
        per_ray = state_idx.ndim >= 1
        args = [padr(means), padr(covs), padr(viewdirs)]
        sidx = padr(state_idx) if per_ray else state_idx
        noise = None if noise is None else [padr(u) for u in noise]
        outs = []
        for s in range(0, n + pad, c):
            outs.append(fn(*(a[s:s + c] for a in args),
                           sidx[s:s + c] if per_ray else sidx,
                           None if noise is None
                           else [u[s:s + c] for u in noise]))
        return {k: torch.cat([o[k] for o in outs])[:n] for k in outs[0]}

    def forward(self, batch: Dict[str, Any], train_frac: float,
                randomized: bool, state_idx, near, far,
                generator: Optional[torch.Generator] = None
                ) -> Tuple[List[Dict[str, torch.Tensor]],
                           List[Dict[str, torch.Tensor]]]:
        """batch: rays_o, rays_d, viewdirs [R, 3], radii [R, 1]. Returns
        (renderings, ray_history), one entry per level; ray_history[-1]
        holds the raw per-sample rgb [R, S, 3], density [R, S] and tdist
        [R, S + 1] that stage 3 composes. Sampling is randomized when
        `randomized` and a generator is given."""
        rays_o = batch["rays_o"]
        bsz, dtype, device = rays_o.shape[0], rays_o.dtype, rays_o.device
        randomized = randomized and generator is not None

        _, s_to_t = ray_math.construct_ray_warps(near, far)
        if self.near_anneal_rate is None:
            init_s_near = 0.0
        else:
            init_s_near = min(max(1.0 - train_frac / self.near_anneal_rate,
                                  0.0), 1.0)
        init_s_far = 1.0
        sdist = torch.cat([torch.full((bsz, 1), init_s_near, dtype=dtype,
                                      device=device),
                           torch.full((bsz, 1), init_s_far, dtype=dtype,
                                      device=device)], dim=-1)
        weights = torch.ones((bsz, 1), dtype=dtype, device=device)
        prod_num_samples = 1
        ray_history: List[Dict[str, torch.Tensor]] = []
        renderings: List[Dict[str, torch.Tensor]] = []

        for i_level in range(self.num_levels):
            is_prop = i_level < self.num_levels - 1
            num_samples = (self.num_prop_samples if is_prop
                           else self.num_nerf_samples)
            dilation = (self.dilation_bias + self.dilation_multiplier
                        * (init_s_far - init_s_near) / prod_num_samples)
            prod_num_samples *= num_samples
            if i_level > 0 and (self.dilation_bias > 0
                                or self.dilation_multiplier > 0):
                sdist, weights = stepfun.max_dilate_weights(
                    sdist, weights, dilation,
                    domain=(init_s_near, init_s_far), renormalize=True)
                sdist, weights = sdist[..., 1:-1], weights[..., 1:-1]

            if self.anneal_slope > 0:
                s = self.anneal_slope
                anneal = (s * train_frac) / ((s - 1) * train_frac + 1)
            else:
                anneal = 1.0
            logits_resample = torch.where(
                sdist[..., 1:] > sdist[..., :-1],
                anneal * torch.log(weights + self.resample_padding),
                -math.inf)
            sdist = stepfun.sample_intervals(
                generator, randomized, sdist, logits_resample, num_samples,
                single_jitter=self.single_jitter,
                domain=(init_s_near, init_s_far))
            if self.stop_level_grad:
                sdist = sdist.detach()
            tdist = s_to_t(sdist)

            lifted = ray_math.contracted_lifted_gaussians(
                rays_o, batch["rays_d"], batch["radii"], tdist,
                self.pos_basis, self.ray_shape)
            if self.disable_integration:
                lifted = (lifted[0], torch.zeros_like(lifted[1]))
            noise = (self._noise(self.mlps[i_level], tdist[..., 1:].shape,
                                 generator, device)
                     if randomized else None)
            ray_results = self._apply_mlp(i_level, lifted, batch["viewdirs"],
                                          state_idx, noise)
            weights = render.compute_alpha_weights(
                ray_results["density"], tdist, batch["rays_d"],
                opaque_background=self.opaque_background)[0]

            lo, hi = self.bg_intensity_range
            if lo == hi:
                bg_rgbs = lo
            elif not randomized:
                bg_rgbs = (lo + hi) / 2.0
            else:
                bg_rgbs = (torch.rand((3,), generator=generator,
                                      device=generator.device).to(device)
                           * (hi - lo) + lo)
            renderings.append(render.volumetric_rendering(
                ray_results["rgb"], weights, bg_rgbs))
            ray_history.append(dict(ray_results, sdist=sdist, tdist=tdist,
                                    weights=weights))
        return renderings, ray_history


def interlevel_loss(ray_history) -> torch.Tensor:
    """Proposal supervision: each proposal level's weights bound the
    (detached) last level's."""
    c = ray_history[-1]["sdist"].detach()
    w = ray_history[-1]["weights"].detach()
    loss = 0.0
    for ray_results in ray_history[:-1]:
        loss = loss + torch.mean(stepfun.lossfun_outer(
            c, w, ray_results["sdist"], ray_results["weights"]))
    return loss


def distortion_loss(ray_history) -> torch.Tensor:
    c = ray_history[-1]["sdist"]
    w = ray_history[-1]["weights"]
    return torch.mean(stepfun.lossfun_distortion(c, w))
