"""Stage 3's composite and losses, and LPIPS, in plain PyTorch (functional
copies of the port's `models/composed.py`, `ops/merge.py::
sortless_composite` and `z_along_ray`, `train/stage2.py`'s patch, flow
and cycle losses, and `models/lpips.py` on a dict of its weights)."""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from hosbench.reference import render

FG_THRESHOLD = 5e-3


def z_along_ray(points, rays_o, rays_d, thresh: float = 1e-5):
    ratio = (points - rays_o[:, None, :]) / (rays_d[:, None, :] + 1e-10)
    valid = (torch.abs(rays_d) > thresh).to(points.dtype)
    denom = torch.sum(valid, -1)
    all_bad = denom == 0
    w = torch.where(all_bad[:, None], torch.ones_like(valid), valid)
    denom = torch.where(all_bad, 3.0, denom)
    return torch.einsum("rsc,rc->rs", ratio, w) / denom[:, None]


def sortless_composite(z_bkg, out_bkg, z_hum, out_hum, mask_hum, rays_d):
    norm = torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    inf = 1e10

    def stream_dists(z_own, z_other, ties_after: bool):
        next_own = torch.cat([z_own[..., 1:],
                              torch.full_like(z_own[..., :1], inf)], -1)
        ahead = (z_other[..., None, :] >= z_own[..., :, None] if ties_after
                 else z_other[..., None, :] > z_own[..., :, None])
        next_other = torch.amin(torch.where(ahead, z_other[..., None, :],
                                            inf), -1)
        return torch.clamp(torch.minimum(next_own, next_other) - z_own,
                           max=inf)

    alpha_b = 1.0 - torch.exp(-out_bkg[..., 3]
                              * stream_dists(z_bkg, z_hum, True) * norm)
    alpha_h = (1.0 - torch.exp(-out_hum[..., 3]
                               * stream_dists(z_hum, z_bkg, False) * norm)
               ) * mask_hum
    log_b = torch.log(torch.clamp(1.0 - alpha_b, min=1e-10))
    log_h = torch.log(torch.clamp(1.0 - alpha_h, min=1e-10))

    def excl(x):
        c = torch.cumsum(x, -1)
        return torch.cat([torch.zeros_like(c[..., :1]), c[..., :-1]], -1)

    cross_b = torch.einsum("rij,rj->ri", (z_hum[..., None, :]
                                          < z_bkg[..., :, None]).float(),
                           log_h)
    cross_h = torch.einsum("rij,rj->ri", (z_bkg[..., None, :]
                                          <= z_hum[..., :, None]).float(),
                           log_b)
    w_b = alpha_b * torch.exp(excl(log_b) + cross_b)
    w_h = alpha_h * torch.exp(excl(log_h) + cross_h)
    rgb = (torch.einsum("ri,ric->rc", w_b, out_bkg[..., :3])
           + torch.einsum("ri,ric->rc", w_h, out_hum[..., :3]))
    return rgb, w_h


def compose(last, human, batch) -> Dict[str, torch.Tensor]:
    """{'rgb' [R, 3], 'human_weights' [R, Nh]} of the scene's last level
    and the human field's samples."""
    rays_o, rays_d = batch["rays_o_bkg"], batch["rays_d_bkg"]
    pts = human["newsmpl_pts"]
    sw = torch.einsum("ji,rsi->rsj", batch["newsmpl_to_scale_world"],
                      torch.cat([pts, torch.ones_like(pts[..., :1])], -1)
                      )[..., :3]
    z_hum = z_along_ray(sw, rays_o, rays_d)
    idx_fg = torch.sum(human["pts_mask"], -1) > FG_THRESHOLD
    z_bkg = last["tdist"][..., :-1]
    out_bkg = torch.cat([last["rgb"], last["density"][..., None]], -1)
    out_hum = torch.cat([human["human_rgb"],
                         human["human_density"][..., None]], -1)
    rgb_fg, w_h = sortless_composite(z_bkg, out_bkg, z_hum, out_hum,
                                     human["pts_mask"], rays_d)
    rgb_bg = render.raw2outputs_joint(out_bkg, z_bkg, rays_d,
                                      torch.ones_like(z_bkg)[..., None])[0]
    fg = idx_fg[:, None]
    return {"rgb": torch.where(fg, rgb_fg, rgb_bg),
            "human_weights": w_h * fg}


def unpack_patches(rgb, patch_masks, bgcolor, n_patches, size):
    imgs = rgb.reshape(n_patches, size, size, 3)
    return torch.where(patch_masks[..., None] > 0, imgs, bgcolor / 255.0)


def flow_loss(ray_grid, to_cam_prev, intr_prev, weights, deform_prev):
    hom = torch.cat([deform_prev, torch.ones_like(deform_prev[..., :1])], -1)
    cam = torch.einsum("ji,rsi->rsj", to_cam_prev, hom)[..., :3]
    pix = torch.einsum("ji,rsi->rsj", intr_prev, cam)
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
    return num / (torch.sum(mask) + 1e-8) / induced.shape[-1]


def cycle_loss(observe, deform, mask):
    sq = torch.sum((observe - deform) ** 2, -1) / 2.0
    return torch.sum(sq * mask) / torch.clamp(torch.sum(mask), min=1.0)


# --- LPIPS (VGG16 taps + lin heads) -------------------------------------------------

VGG_PLAN = [64, 64, "T", "M", 128, 128, "T", "M", 256, 256, 256, "T", "M",
            512, 512, 512, "T", "M", 512, 512, 512, "T"]
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def lpips(w: Dict[str, torch.Tensor], x, y):
    """[N] for NHWC inputs in [-1, 1]; f32 convolutions."""
    shift = torch.tensor(SHIFT, device=x.device).reshape(1, 3, 1, 1)
    scale = torch.tensor(SCALE, device=x.device).reshape(1, 3, 1, 1)

    def features(h):
        taps, j = [], 0
        for item in VGG_PLAN:
            if item == "M":
                h = F.max_pool2d(h, 2, 2)
            elif item == "T":
                taps.append(h)
            else:
                h = torch.relu(F.conv2d(h, w[f"vgg.conv_{j}.weight"],
                                        w[f"vgg.conv_{j}.bias"], padding=1))
                j += 1
        return taps

    fx = features((x.permute(0, 3, 1, 2) - shift) / scale)
    fy = features((y.permute(0, 3, 1, 2) - shift) / scale)
    total = 0.0
    for i, (a, b) in enumerate(zip(fx, fy)):
        a = a / torch.clamp(torch.linalg.norm(a, dim=1, keepdim=True),
                            min=1e-10)
        b = b / torch.clamp(torch.linalg.norm(b, dim=1, keepdim=True),
                            min=1e-10)
        total = total + torch.einsum("nchw,c->nhw", (a - b) ** 2,
                                     w[f"lin_{i}"]).mean(dim=(1, 2))
    return total
